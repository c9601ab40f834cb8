// Grid-sweep kernel: one full-state sweep of a planned gate list.
//
// Replaces tpu_qsim/kernels/gridsweeps.py::_build_grid_sweep (the
// pallas_call at gridsweeps.py:566) and its body,
// tpu_qsim/kernels/fused_circuit.py::emit_ops.
//
// State: float32 planes re[2^n], im[2^n] (one (2, 2^n) tensor). A sweep holds
// block bits [0, blk) plus a <= a_max "active" high bits; each CTA owns one
// assignment of the remaining (inactive) high bits, deposited from
// blockIdx.x, and applies the sweep's ops to its 2^k amplitudes (k = blk + a)
// in place. Blocks are disjoint, so in-place is safe (the JAX kernel aliases
// input and output).
//
// Each block runs block_program.cuh's register program, which sweep.cu
// shares: 16 amplitudes a thread in registers, block bits 0-4 the lanes,
// diagonals and 1-qubit cores in registers, remaps and wider cores through
// the block in shared memory. The host (gridsweeps.py::register_table)
// chooses the register bits of each run of ops and writes the remaps into
// the op table.
//
// The gate list arrives as device data (one compile serves every circuit):
// an int32 table written by tpu_qsim_torch/kernels/fused_circuit.py
// ::build_op_table and float32 (re, im) coefficients composed on the host in
// complex128. A qubit code < EXT names a bit of the block-local index; EXT + p
// names state bit p outside the block, read from the CTA's share of the
// global index. That replaces the TPU kernel's ext scalars and relabeling.
// The kernel is built for cores of up to NARROW_CORE and of up to MAX_CORE
// qubits; a sweep whose cores are all narrow launches the narrow instance,
// so the wide cores' code and scratch cost it nothing.
//
// Bound on this card: device-memory bytes. A sweep must read and write both
// planes once (16 B per amplitude); diagonals and 1-qubit cores cost their
// flops in registers, a remap one pass over shared memory.

#include <cuda_runtime.h>

#include "block_program.cuh"

namespace {

using namespace qsim;

constexpr int MAX_THREADS = 512;     // a 13-bit block (gridsweeps.py's largest)

__device__ __forceinline__ unsigned step_bits(unsigned step, int n_inact,
                                              const int* inact) {
  unsigned g = 0;
  for (int b = 0; b < n_inact; ++b)
    if ((step >> b) & 1u) g |= 1u << inact[b];
  return g;
}

// Persistent CTAs: CTA c takes the steps (assignments of the inactive bits)
// c, c + gridDim.x, ...; while it runs one step's ops, the next step's block
// streams into the second buffer (pr, pi) with cp.async, so loads overlap
// the ops; the last store goes from registers straight to device memory.
// `stamp_at(j, steps, n_ops, g)` gives the CTA's step j (its share g of the
// global index) a block_program.cuh stamp: NoStamp, which compiles to
// nothing, but in the measurement build.
template <int MAXM, class StampAt>
__device__ __forceinline__ void sweep(float* __restrict__ re, float* __restrict__ im,
                                      const int* __restrict__ table,
                                      const float2* __restrict__ coef, const StampAt& stamp_at) {
  QSIM_DYNAMIC_SHARED(float4, smem4);
  check_core_width<MAXM>(table);
  if (table[HEADER_REG_BITS] != R) __trap();
  const BlockShape shape(table);
  const int blk = shape.blk, a = shape.a;
  const int n_inact = table[3];
  const unsigned size = shape.size;
  const unsigned steps = 1u << n_inact;
  const int* active = table + 16;
  const int* inact = table + 32;
  float* sr = reinterpret_cast<float*>(smem4);  // the block, for remaps and
  float* si = sr + size;                         // shared-memory ops
  float* pr = si + size;                         // the next step's block
  float* pi = pr + size;
  // the tiled op's scratch: a block's worth, so a wide core's tile is the
  // whole block
  const TileScratch<4> scratch{reinterpret_cast<float2*>(pi + size), size};

  unsigned step = blockIdx.x;
  if (step < steps)
    prefetch_block(pr, pi, re, im, size, blk, a, active,
                   step_bits(step, n_inact, inact));
  for (unsigned j = 0; step < steps; step += gridDim.x, ++j) {
    const auto stamp = stamp_at(j, steps, shape.n_ops, step_bits(step, n_inact, inact));
    stamp(0);
    run_block_in_place<MAXM, true>(re, im, table, shape, coef, step_bits(step, n_inact, inact),
                                   sr, si, scratch, [&](Regs& x) {
      cp_async_wait<0>();
      __syncthreads();  // the step's block is in (pr, pi); (sr, si) is free
      x.load(pr, pi);
      stamp(1);
      __syncthreads();  // every thread has its values: prefetch the next
      if (step + gridDim.x < steps)
        prefetch_block(pr, pi, re, im, size, blk, a, active,
                       step_bits(step + gridDim.x, n_inact, inact));
    }, stamp);
  }
}

struct Unstamped {
  __device__ __forceinline__ NoStamp operator()(unsigned, unsigned, int, unsigned) const {
    return {};
  }
};

// The narrow instance runs at 64 registers, so that two CTAs of
// MAX_THREADS fit an SM where shared memory allows (128 registers were 10%
// slower at 28 qubits on the H100); the wide one at 128, which the tiled op
// needs (at 64 it spilled and took 1.8x the time).
template <int MAXM>
__global__ void __launch_bounds__(MAX_THREADS, MAXM <= NARROW_CORE ? 2 : 1)
grid_sweep_kernel(float* __restrict__ re, float* __restrict__ im,
                  const int* __restrict__ table,
                  const float2* __restrict__ coef) {
  sweep<MAXM>(re, im, table, coef, Unstamped());
}

#ifdef QSIM_STAMPS
// The measurement build (kernels/floor.py --stamps, kernels/sass_census.py
// --classes), which no main path builds or launches: the same sweep with
//  - StampRows: thread 0 of CTAs below `ctas` writes clock64() at the op
//    boundaries (block_program.cuh's slots) of `steps` of its steps,
//    spread evenly over its run, then at a tiled op's own boundaries
//    (ops.cuh's TileStamp slots, 4 + n_ops to 9 + n_ops; the last tiled
//    op's), and the step's share of the global index after them: a row of
//    n_ops + 11 values a step at at[(cta * steps + j) * (n_ops + 11)];
//  - Marks (compiled, never launched): a pmevent where the op loop and each
//    op class's code start, for the SASS census.
constexpr int STAMP_EXTRA = 11;  // a row's slots past the ops
struct TileClock {
  static constexpr bool ON = true;
  long long* at;  // null: not stamped
  __device__ __forceinline__ void operator()(int i) const {
    if (at) at[i] = clock64();
  }
};
struct ClockStamp {
  long long* row;  // null: not stamped
  int n_ops;
  __device__ __forceinline__ void operator()(int slot) const {
    if (row) row[slot] = clock64();
  }
  template <int ID>
  __device__ __forceinline__ void mark() const {}
  __device__ __forceinline__ TileClock tile() const {
    return {row ? row + n_ops + 4 : nullptr};
  }
};
struct StampRows {
  long long* at;
  int ctas, steps;
  __device__ __forceinline__ ClockStamp operator()(unsigned j, unsigned n_steps, int n_ops,
                                                   unsigned g) const {
    const unsigned every = n_steps / gridDim.x / (steps > 0 ? steps : 1);
    const unsigned stride = every > 0 ? every : 1;
    if (threadIdx.x != 0 || (int)blockIdx.x >= ctas || j % stride != 0 ||
        (int)(j / stride) >= steps)
      return {nullptr, n_ops};
    long long* row = at + ((long long)blockIdx.x * steps + j / stride) * (n_ops + STAMP_EXTRA);
    row[n_ops + STAMP_EXTRA - 1] = g;
    return {row, n_ops};
  }
};
struct MarkStamp {
  __device__ __forceinline__ void operator()(int) const {}
  template <int ID>
  __device__ __forceinline__ void mark() const {
    pm_marker<ID>();
  }
  __device__ __forceinline__ NoTileStamp tile() const { return {}; }
};
struct Marks {
  __device__ __forceinline__ MarkStamp operator()(unsigned, unsigned, int, unsigned) const {
    return {};
  }
};

template <int MAXM, class StampAt>
__global__ void __launch_bounds__(MAX_THREADS, MAXM <= NARROW_CORE ? 2 : 1)
grid_sweep_stamp_kernel(float* __restrict__ re, float* __restrict__ im,
                        const int* __restrict__ table, const float2* __restrict__ coef,
                        const StampAt stamp_at) {
  sweep<MAXM>(re, im, table, coef, stamp_at);
}
template __global__ void grid_sweep_stamp_kernel<NARROW_CORE, Marks>(float*, float*, const int*,
                                                                     const float2*, const Marks);
template __global__ void grid_sweep_stamp_kernel<MAX_CORE, Marks>(float*, float*, const int*,
                                                                  const float2*, const Marks);
#endif

// The dynamic shared memory of an instance: the block and its prefetch, and
// the wide instance's tile scratch.
template <int MAXM>
size_t block_smem(int kbits) {
  size_t smem = (size_t)4 * sizeof(float) << kbits;
  if (MAXM > NARROW_CORE) smem += tile_scratch_bytes(1u << kbits);
  return smem;
}

// Launch `kernel` on as many CTAs as the card keeps resident at `smem`
// bytes each (at most `steps`).
template <class... StampAt>
int launch(void (*kernel)(float*, float*, const int*, const float2*, StampAt...), float* state,
           long long dim, const int* table, const float* coef, long long steps, int threads,
           size_t smem, cudaStream_t stream, StampAt... stamp_at) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(steps < resident ? steps : resident);
  return (int)launch_kernel(kernel, grid, threads, smem, stream, state, state + dim, table,
                            reinterpret_cast<const float2*>(coef), stamp_at...);
}

bool valid_launch(int kbits, int max_core, int* threads) {
  *threads = kbits >= LANE_BITS + R ? 1 << (kbits - R) : 0;
  return max_core <= MAX_CORE && *threads >= 32 && *threads <= MAX_THREADS &&
         threads_fit_core(*threads, max_core);
}

#ifdef QSIM_STAMPS
// The stamp instance at `one_per_sm` (0 or 1): a CTA takes the most shared
// memory a CTA may have (less its static shared memory), so that one fits
// an SM.
template <int MAXM>
int stamp_launch(float* state, long long dim, const int* table, const float* coef, int kbits,
                 long long steps, int threads, cudaStream_t stream, StampRows rows,
                 int one_per_sm) {
  size_t smem = block_smem<MAXM>(kbits);
  if (one_per_sm) {
    int dev = 0, most = 0;
    cudaFuncAttributes attr;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, grid_sweep_stamp_kernel<MAXM, StampRows>);
    if (err != cudaSuccess) return (int)err;
    const size_t room = (size_t)most - attr.sharedSizeBytes;
    if (room > smem) smem = room;
  }
  return launch(grid_sweep_stamp_kernel<MAXM, StampRows>, state, dim, table, coef, steps,
                threads, smem, stream, rows);
}
#endif

}  // namespace

// Launch one sweep on `stream`. `state` is the (2, dim) float32 planes,
// `table` and `coef` device copies of gridsweeps.py::register_table's output
// for a block of 2^kbits slots, `max_core` the table's widest dense core.
// A CTA has 2^(kbits - R) threads: one warp (a 9-bit block) to MAX_THREADS
// (13 bits). The grid is as many CTAs as the card keeps resident (at most
// `steps`). Returns the cudaError_t of the launch (0 on success); the launch
// does not synchronize.
extern "C" int grid_sweep_launch(float* state, long long dim,
                                 const int* table, const float* coef,
                                 int kbits, long long steps, int max_core,
                                 void* stream) {
  int threads = 0;
  if (!valid_launch(kbits, max_core, &threads)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return max_core <= NARROW_CORE
             ? launch(grid_sweep_kernel<NARROW_CORE>, state, dim, table, coef, steps, threads,
                      block_smem<NARROW_CORE>(kbits), s)
             : launch(grid_sweep_kernel<MAX_CORE>, state, dim, table, coef, steps, threads,
                      block_smem<MAX_CORE>(kbits), s);
}

#ifdef QSIM_STAMPS
// The stamp instance (kernels/floor.py --stamps): grid_sweep_launch's sweep,
// with clock64() rows of `stamp_steps` steps (spread over each CTA's run) of
// CTAs below `stamp_ctas` written to `stamps` (int64, zeroed by the caller),
// at as many CTAs an SM as fit, or with `one_per_sm` one.
extern "C" int grid_sweep_stamp_launch(float* state, long long dim, const int* table,
                                       const float* coef, int kbits, long long steps,
                                       int max_core, long long* stamps, int stamp_ctas,
                                       int stamp_steps, int one_per_sm, void* stream) {
  int threads = 0;
  if (!valid_launch(kbits, max_core, &threads) || stamp_ctas < 0 || stamp_steps < 0 ||
      (one_per_sm != 0 && one_per_sm != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const StampRows rows{stamps, stamp_ctas, stamp_steps};
  return max_core <= NARROW_CORE
             ? stamp_launch<NARROW_CORE>(state, dim, table, coef, kbits, steps, threads, s, rows,
                                         one_per_sm)
             : stamp_launch<MAX_CORE>(state, dim, table, coef, kbits, steps, threads, s, rows,
                                      one_per_sm);
}
#endif

extern "C" const char* grid_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
