// Low-sweep and high-sweep kernels: one sweep of the sweeps engine (22-26
// qubits, the grid planner's fallback).
//
// Replace tpu_qsim/kernels/sweeps.py::_build_low_sweep (the pallas_call at
// sweeps.py:292) and ::_build_high_sweep (the pallas_call at sweeps.py:370);
// their body, emit_ops, is ops.cuh here.
//
// A sweep's block is larger than any on-chip memory of one CTA or cluster.
// A low sweep holds state bits [0, n - 5) of each of the 32 parts (the top 5
// bits): 2^17-2^21 slots, 1-16 MB of float32 planes at 22-26 qubits. A high
// sweep holds bits [0, 16) plus 4 active top bits of each step (the mid bits
// and the fifth top bit): 2^20 slots, 8 MB. The TPU kernels kept such a block
// in VMEM. One CTA's 227 KB cannot hold it, nor a 16-CTA cluster's 3.6 MB;
// the H100's 50 MB L2 can. So the block stays in device memory, addressed
// through ops.cuh's GlobalSlots, and one persistent cooperative launch runs
// the whole sweep:
//   - the grid is split into groups of 2^group_bits CTAs; group g walks the
//     units (the parts of a low sweep, the steps of a high sweep) g,
//     g + groups, ..., so `groups` units are in flight at once;
//   - for each unit the group applies the sweep's ops in order, each op as
//     one pass over the unit's slots, CTA r of the group taking part r of
//     the op's items (ops.cuh's Part), with a barrier of the group's CTAs
//     between two ops;
//   - the barrier is a counter in device memory per group, zeroed by the
//     launcher, under the cooperative launch's guarantee that every CTA of
//     the grid is resident at once (no -rdc, no grid.sync()).
// A unit is touched once per op, but while its group works on it it stays in
// L2 (at most 50 MB in flight), so device memory sees about one read and one
// write of the state per sweep.
//
// The op table is build_op_table's over the sweep's BlockLayout: low, blk =
// n - 5 and no active bits, the 5 top bits inactive; high, blk = 16 and the
// 4 active top bits, the mid bits and the other top bit inactive. Unit u's
// share of the global index deposits the bits of u at the inactive bits, as
// the grid sweep's CTA index does, and EXT codes read it (ops.cuh's bit_of),
// which replaces the TPU kernels' per-part and per-step ext scalars. One
// template serves both sweeps (GlobalSlots<false> for the low sweep, whose
// slot l is cta_g + l; GlobalSlots<true> for the high one), each built for
// cores of up to NARROW_CORE and of up to MAX_CORE qubits, as the other
// kernels are. Only the wide instance has dynamic shared memory: the scratch
// in which ops.cuh's tiled op stages a tile of the unit's groups and streams
// the core, for cores of TILE_CORE qubits and more.
//
// Bound on this card: device-memory bytes, 16 B per amplitude per sweep
// (both planes read and written once; 0.32 ms at 26 qubits and 3.35 TB/s).
// The design pays above that one L2 pass over the unit and one barrier per
// op; fusing runs of block-local ops into shared-memory passes is what a
// later kernel can cut.

#include <cuda_runtime.h>

#include "ops.cuh"

namespace {

using namespace qsim;

constexpr int MAX_ACTIVE = 4;  // the high sweep's active top bits

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Barrier of the `members` CTAs of one group. The counter only grows: the
// k-th barrier waits for k * members arrivals. A barrier that has not
// completed after 2^36 cycles (about 40 s) traps, so a fault shows as a
// failed launch and not as a hung card.
__device__ __forceinline__ void group_sync(unsigned* counter, unsigned members,
                                           unsigned& target) {
  __syncthreads();
  target += members;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const long long start = clock64();
    while (load_acquire(counter) < target) {
      if (clock64() - start > (1LL << 36)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// The wide instance takes at most WIDE_THREADS threads, so that ptxas may
// give the tiled op 128 registers a thread (4 groups a thread).
constexpr int WIDE_THREADS = 512;

template <bool HIGH, int MAXM>
__global__ void __launch_bounds__(MAXM > NARROW_CORE ? WIDE_THREADS : 1024)
sweep_kernel(float* __restrict__ re, float* __restrict__ im,
             const int* __restrict__ table, const float2* __restrict__ coef,
             unsigned* __restrict__ barriers, int group_bits) {
  __shared__ unsigned hi_off[1 << MAX_ACTIVE];
  extern __shared__ float4 dyn_smem[];
  float2* scratch = reinterpret_cast<float2*>(dyn_smem);
  check_core_width<MAXM>(table);
  const int n_ops = table[0], blk = table[1], a = table[2];
  const int n_inact = table[3];
  const int kbits = blk + a;
  const int* inact = table + 32;
  if constexpr (HIGH) {
    for (unsigned h = threadIdx.x; h < (1u << a); h += blockDim.x) {
      unsigned o = 0;
      for (int j = 0; j < a; ++j)
        if ((h >> j) & 1u) o |= 1u << table[16 + j];
      hi_off[h] = o;
    }
    __syncthreads();
  }

  const unsigned members = 1u << group_bits;
  const unsigned group = blockIdx.x >> group_bits;
  const unsigned n_groups = gridDim.x >> group_bits;
  const Part part{group_bits, blockIdx.x & (members - 1u)};
  unsigned* counter = barriers + group;
  unsigned target = 0;
  const unsigned units = 1u << n_inact;
  for (unsigned u = group; u < units; u += n_groups) {
    unsigned cta_g = 0;
    for (int b = 0; b < n_inact; ++b)
      if ((u >> b) & 1u) cta_g |= 1u << inact[b];
    const GlobalSlots<HIGH> slots{re, im, cta_g, blk, hi_off};
    // units are disjoint: the next unit's first op needs no barrier
    for (int o = 0; o < n_ops; ++o) {
      if (o > 0) group_sync(counter, members, target);
      apply_op<MAXM>(slots, table + SWEEP_HEADER + o * OP_HEADER, coef, kbits,
                     cta_g, part, scratch);
    }
  }
}

template <int MAXM>
size_t smem_bytes(int threads) {
  return MAXM > NARROW_CORE ? tile_scratch_bytes(threads) : 0;
}

template <bool HIGH, int MAXM>
int launch(float* state, long long dim, const int* table, const float* coef,
           unsigned* barriers, int groups, int group_bits, int threads,
           cudaStream_t stream) {
  float* re = state;
  float* im = state + dim;
  const float2* c = reinterpret_cast<const float2*>(coef);
  void* args[] = {&re, &im, &table, &c, &barriers, &group_bits};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)sweep_kernel<HIGH, MAXM>, dim3((unsigned)groups << group_bits),
      dim3(threads), args, smem_bytes<MAXM>(threads), stream);
}

template <bool HIGH>
int launch_core(float* state, long long dim, const int* table,
                const float* coef, unsigned* barriers, int groups,
                int group_bits, int threads, int max_core,
                cudaStream_t stream) {
  return max_core <= NARROW_CORE
             ? launch<HIGH, NARROW_CORE>(state, dim, table, coef, barriers,
                                         groups, group_bits, threads, stream)
             : launch<HIGH, MAX_CORE>(state, dim, table, coef, barriers,
                                      groups, group_bits, threads, stream);
}

template <bool HIGH, int MAXM>
cudaError_t resident(int threads, int sms, int* ctas) {
  int per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<HIGH, MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<MAXM>(1024));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep_kernel<HIGH, MAXM>, threads, smem_bytes<MAXM>(threads));
  *ctas = per_sm * sms;
  return err;
}

}  // namespace

// Allow the wide instance its tile scratch, and report in *ctas how many
// CTAs every instance of the kernel can keep resident at once on the
// current device (the most a cooperative launch takes), the narrow ones at
// `threads` threads and the wide ones at up to WIDE_THREADS (so a narrow
// launch takes as many CTAs as before the wide instance had its own bound).
// Returns a cudaError_t (0 on success).
extern "C" int sweep_prepare(int threads, int* ctas) {
  *ctas = 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the wide instances at the most threads they take
  const int wide = threads < WIDE_THREADS ? threads : WIDE_THREADS;
  int c[4] = {0, 0, 0, 0};
  if (err == cudaSuccess) err = resident<false, NARROW_CORE>(threads, sms, &c[0]);
  if (err == cudaSuccess) err = resident<false, MAX_CORE>(wide, sms, &c[1]);
  if (err == cudaSuccess) err = resident<true, NARROW_CORE>(threads, sms, &c[2]);
  if (err == cudaSuccess) err = resident<true, MAX_CORE>(wide, sms, &c[3]);
  if (err == cudaSuccess) {
    *ctas = c[0];
    for (int i = 1; i < 4; ++i)
      if (c[i] < *ctas) *ctas = c[i];
  }
  return (int)err;
}

// Launch one sweep (`high` 0: a low sweep) on `stream`, in place on the
// (2, dim) float32 planes `state`. `table` and `coef` are device copies of
// build_op_table's output over the sweep's BlockLayout of `kbits` kernel
// bits, `max_core` its widest dense core, `barriers` `groups` words of device
// memory (zeroed here). The grid is `groups` groups of 2^group_bits CTAs of
// `threads` threads, at most sweep_prepare's count. Returns the cudaError_t
// of the launch (0 on success); the launch does not synchronize.
extern "C" int sweep_launch(int high, float* state, long long dim,
                            const int* table, const float* coef, int kbits,
                            unsigned* barriers, int groups, int group_bits,
                            int threads, int max_core, void* stream) {
  // every CTA of a group takes an equal share of each narrow op's items: a
  // core of m <= NARROW_CORE qubits has 2^(kbits - m) groups of slots (the
  // tiled op gives its tiles to the group's CTAs in turn, any count)
  const int narrow = max_core < NARROW_CORE ? max_core : NARROW_CORE;
  if (max_core > MAX_CORE || threads < 32 || threads > 1024 ||
      (max_core > NARROW_CORE && threads > WIDE_THREADS) ||
      threads % 32 != 0 || !threads_fit_core(threads, max_core) || groups < 1 ||
      group_bits < 0 || group_bits > kbits - (narrow > 0 ? narrow : 0) ||
      ((long long)groups << group_bits) > (1LL << 20))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(barriers, 0, sizeof(unsigned) * groups, s);
  if (err != cudaSuccess) return (int)err;
  const int launched =
      high ? launch_core<true>(state, dim, table, coef, barriers, groups,
                               group_bits, threads, max_core, s)
           : launch_core<false>(state, dim, table, coef, barriers, groups,
                                group_bits, threads, max_core, s);
  if (launched != 0) return launched;
  return (int)cudaGetLastError();
}

extern "C" const char* sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
