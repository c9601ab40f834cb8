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
// the H100's 50 MB L2 can. So the block (here: the unit, a part of a low
// sweep or a step of a high one) stays in device memory, and one persistent
// cooperative launch runs the whole sweep:
//   - the grid is split into groups of 2^group_bits CTAs; group g walks the
//     units g, g + groups, ..., so `groups` units are in flight at once;
//   - the host (sweeps.py::plan_stages) cuts the sweep's ops into stages.
//     A tile stage is a run of ops whose moving bits, with state bits 0-4,
//     fit in the tile bits (2^T slots, T = 13 by default): it is a grid-sweep
//     register table (gridsweeps.py::register_table) over the tile's bits,
//     and the unit is 2^(unit bits - T) tiles. CTA r of the group takes
//     tiles r, r + members, ... and runs each through block_program.cuh's
//     register program, the program the grid sweep runs on its blocks: the
//     tile goes from device memory (mostly L2) into registers, through the
//     stage's ops in registers and shared memory, and back. A unit stage is
//     one dense core of TILE_CORE qubits or more: ops.cuh's tiled op over the
//     whole unit through GlobalSlots, its tiles dealt to the group's CTAs in
//     turn;
//   - a barrier of the group's CTAs comes between two stages, and only there.
//     It is a counter in device memory per group, zeroed by the launcher,
//     under the cooperative launch's guarantee that every CTA of the grid is
//     resident at once (no -rdc, no grid.sync()).
// A unit is touched once per stage. Only where the units in flight fit in the
// L2 does it stay there between stages: at 26 qubits 8 units of 16 MB do not,
// and a launch of three stages streamed the state three times on the H100
// (fewer units in flight ran slower). The host (sweeps.py::plan_launches)
// launches a sweep's stages apart where their instances differ, which on the
// H100 ran faster also where the units fit in L2 (22-24 qubits): each run of
// tile stages on the instance for narrow cores (two CTAs an SM), each unit
// stage alone on the wide instance (one CTA an SM, the tiled op's 128
// registers a thread), and a unit stage of 10 or 11 qubits not here at all
// but through dense_pass.cu; device memory sees a read and a write of the
// state per launch. A launch may still hold several stages (the
// whole-circuit route's, a run of tile stages).
//
// The sweep's table (sweeps.py::sweep_table) starts with the unit's layout as
// build_op_table writes it (low, blk = n - 5 and no active bits, the 5 top
// bits inactive; high, blk = 16 and the 4 active top bits, the mid bits and
// the other top bit inactive), then a descriptor per stage, then the stages'
// own tables. Unit u's share of the global index deposits the bits of u at
// the inactive bits, as the grid sweep's CTA index does; a tile's share adds
// the tile index deposited at the unit's bits outside the tile. EXT codes
// read that share (ops.cuh's bit_of), which replaces the TPU kernels'
// per-part and per-step ext scalars. One template serves both sweeps
// (GlobalSlots<false> for the low sweep's unit stages, whose slot l is
// cta_g + l; GlobalSlots<true> for the high one's), each built for cores of
// up to NARROW_CORE (tile stages only) and of up to MAX_CORE qubits, as the
// other kernels are.
//
// The same kernel runs the whole-circuit route (10-18 qubits, the port of
// tpu_qsim/kernels/fused_circuit.py::build_pallas_run_gates, the pallas_call
// at fused_circuit.py:1552, which holds the whole state in VMEM): the whole
// state is one unit of a low sweep with no part bits, kernels/fused_circuit.py
// ::WholeCircuitProgram cuts the circuit into stages as a sweep's, and one
// group of CTAs, each holding one tile at a time, runs them in one launch,
// the 2-8 MB state in L2 between stages. At 10-12 qubits a unit stage's
// tiled op may need more threads than the tile has (2^k <= 4 x threads,
// tiles of 2^T <= 2^n slots): the low wide instance built with SPARE then
// runs the tile stages on the tile's threads while the other warps wait at
// the barriers. (Instances built for at most 512 threads, so that ptxas
// gives the narrow register program 128 registers instead of 64 and 1.2 KB
// of spills, ran the route no faster on the H100.)
//
// Bound on this card: device-memory bytes, 16 B per amplitude per launch
// (both planes read and written once; 0.32 ms at 26 qubits and 3.35 TB/s),
// or the flops of a wide core. The design pays above that one pass over the
// unit and one barrier per stage, not per op (the design before this one
// paid them per op: 59 L2 passes for random_circuit(26, 100), now 5).

#include <cuda_runtime.h>

#include "block_program.cuh"
#include "grid_sync.cuh"

namespace {

using namespace qsim;

constexpr int MAX_ACTIVE = 4;  // the high sweep's active top bits

// The wide instance takes at most WIDE_THREADS threads, so that ptxas may
// give the tiled op 128 registers a thread (warp tiles of 4 m-tiles).
constexpr int WIDE_THREADS = 512;
constexpr int MAX_THREADS = 1024;  // a tile of 2^14 slots
// The sweep table's header word: T, the tile bits; after the header, a
// descriptor per stage: kind, offset of its table (int32 words from the
// sweep table's start), offset of its coefficients (float2), the unit's bits
// outside the tile (a state-bit mask) and their count.
constexpr int HEADER_TILE_BITS = 5;
constexpr int STAGE_WORDS = 8;
constexpr int STAGE_TILE = 0;  // STAGE_UNIT (1): one wide core over the unit

template <bool HIGH, int MAXM, bool SPARE = false>
__global__ void __launch_bounds__(MAXM > NARROW_CORE ? WIDE_THREADS : MAX_THREADS)
sweep_kernel(float* __restrict__ re, float* __restrict__ im,
             const int* __restrict__ table, const float2* __restrict__ coef,
             unsigned* __restrict__ barriers, int group_bits) {
  QSIM_SHARED(unsigned, hi_off, [1 << MAX_ACTIVE]);
  QSIM_DYNAMIC_SHARED(float4, dyn_smem);
  check_core_width<MAXM>(table);
  const int n_stages = table[0], blk = table[1], a = table[2];
  const int n_inact = table[3];
  const int kbits = blk + a;
  const int tile_bits = table[HEADER_TILE_BITS];
  if (SPARE ? (1u << tile_bits) > blockDim.x << R
            : (1u << tile_bits) != blockDim.x << R)
    __trap();
  const int* inact = table + 32;
  const int* stages = table + SWEEP_HEADER;
  // a tile stage's block (remaps, shared-memory ops) and, in the wide
  // instance, the next tile; a unit stage's tiled op scratch, used at other
  // times
  float* sr = reinterpret_cast<float*>(dyn_smem);
  float* si = sr + (1u << tile_bits);
  const TileScratch<4> scratch{reinterpret_cast<float2*>(dyn_smem), 32u * blockDim.x};
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
    unsigned unit_g = 0;
    for (int b = 0; b < n_inact; ++b)
      if ((u >> b) & 1u) unit_g |= 1u << inact[b];
    // units are disjoint: the next unit's first stage needs no barrier
    for (int s = 0; s < n_stages; ++s) {
      if (s > 0) group_sync(counter, members, target);
      const int* st = stages + s * STAGE_WORDS;
      const int* sub = table + st[1];
      const float2* sc = coef + st[2];
      if (st[0] == STAGE_TILE) {
        const BlockShape shape(sub);
        if (sub[HEADER_REG_BITS] != R || shape.kbits != tile_bits) __trap();
        const unsigned outside = (unsigned)st[3];
        const unsigned n_tiles = 1u << st[4];
        if constexpr (MAXM > NARROW_CORE) {
          // one CTA an SM: the next tile streams into (pr, pi) while this
          // one runs, as the grid sweep's next block does
          float* pr = si + shape.size;
          float* pi = pr + shape.size;
          unsigned t = part.index;
          __syncthreads();  // the last stage's reads of shared memory are done
          if (t < n_tiles)
            prefetch_block(pr, pi, re, im, shape.size, shape.blk, shape.a,
                           sub + 16, unit_g | deposit_bits(t, outside));
          for (; t < n_tiles; t += members) {
            run_block_in_place<NARROW_CORE, false, SPARE>(
                re, im, sub, shape, sc, unit_g | deposit_bits(t, outside), sr,
                si, scratch, [&](Regs& x) {
                  cp_async_wait<0>();
                  __syncthreads();  // the tile is in (pr, pi); (sr, si) is free
                  if (!SPARE || threadIdx.x < (shape.size >> R)) x.load(pr, pi);
                  __syncthreads();
                  if (t + members < n_tiles)
                    prefetch_block(pr, pi, re, im, shape.size, shape.blk,
                                   shape.a, sub + 16,
                                   unit_g | deposit_bits(t + members, outside));
                });
          }
        } else {
          for (unsigned t = part.index; t < n_tiles; t += members) {
            const unsigned tile_g = unit_g | deposit_bits(t, outside);
            __syncthreads();  // the last tile's reads of (sr, si) are done
            run_block_in_place<NARROW_CORE, false>(
                re, im, sub, shape, sc, tile_g, sr, si, scratch, [&](Regs& x) {
                  x.load_global(re, im, shape.blk, shape.a, sub + 16, tile_g);
                });
          }
        }
      } else if constexpr (MAXM > NARROW_CORE) {
        __syncthreads();  // the scratch aliases the last tile's (sr, si)
        const GlobalSlots<HIGH> slots{re, im, unit_g, blk, hi_off};
        apply_op<MAXM>(slots, sub + SWEEP_HEADER, sc, kbits, unit_g, part,
                       scratch);
      }
    }
  }
}

// Dynamic shared memory of a CTA of `threads` threads: the tile (2^T slots of
// both planes, 2^T = 16 x threads); in the wide instance also the next
// tile's, the same bytes as the tiled op's scratch of 32 x threads float2.
template <int MAXM>
size_t smem_bytes(int threads) {
  const size_t tile = (size_t)2 * sizeof(float) * ((size_t)threads << R);
  if (MAXM <= NARROW_CORE) return tile;
  const size_t tiled = tile_scratch_bytes(32u * threads);
  return 2 * tile > tiled ? 2 * tile : tiled;
}

template <bool HIGH, int MAXM, bool SPARE = false>
int launch(float* state, long long dim, const int* table, const float* coef,
           unsigned* barriers, int groups, int group_bits, int threads,
           cudaStream_t stream) {
  return (int)launch_cooperative(sweep_kernel<HIGH, MAXM, SPARE>,
                                 dim3((unsigned)groups << group_bits), dim3(threads),
                                 smem_bytes<MAXM>(threads), stream, state, state + dim, table,
                                 reinterpret_cast<const float2*>(coef), barriers, group_bits);
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

template <bool HIGH, int MAXM, bool SPARE = false>
cudaError_t resident(int threads, int sms, int* ctas) {
  int per_sm = 0;
  // the most any launch of the instance asks for, whatever its threads
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<HIGH, MAXM, SPARE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<MAXM>(MAXM > NARROW_CORE ? WIDE_THREADS : MAX_THREADS));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sweep_kernel<HIGH, MAXM, SPARE>, threads,
        smem_bytes<MAXM>(threads));
  *ctas = per_sm * sms;
  return err;
}

bool valid_threads(int threads, bool wide) {
  return threads >= 32 && threads <= (wide ? WIDE_THREADS : MAX_THREADS) &&
         (threads & (threads - 1)) == 0;
}

}  // namespace

// Allow the instance for narrow cores (`wide` 0: tile stages only) or for
// wide ones (unit stages too) its shared memory at `threads` threads, and
// report in *ctas how many CTAs of it the current device keeps resident at
// once (the most a cooperative launch takes; the low and the high sweep's
// instances alike, or with `spare` the low wide instance whose CTAs may have
// more threads than a tile). Each instance is counted at its own threads and
// shared memory, so a narrow launch is not cut to the wide instance's
// residency. Returns a cudaError_t (0 on success).
extern "C" int sweep_prepare(int threads, int wide, int spare, int* ctas) {
  *ctas = 0;
  if (!valid_threads(threads, wide != 0 || spare != 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (spare) {
    if (err == cudaSuccess) err = resident<false, MAX_CORE, true>(threads, sms, ctas);
    return (int)err;
  }
  int lo = 0, hi = 0;
  if (err == cudaSuccess)
    err = wide ? resident<false, MAX_CORE>(threads, sms, &lo)
               : resident<false, NARROW_CORE>(threads, sms, &lo);
  if (err == cudaSuccess)
    err = wide ? resident<true, MAX_CORE>(threads, sms, &hi)
               : resident<true, NARROW_CORE>(threads, sms, &hi);
  if (err == cudaSuccess) *ctas = lo < hi ? lo : hi;
  return (int)err;
}

// Launch one sweep (`high` 0: a low sweep) on `stream`, in place on the
// (2, dim) float32 planes `state`. `table` and `coef` are device copies of
// sweeps.py::sweep_table's output for a unit of `kbits` bits, `max_core` its
// widest dense core, `barriers` `groups` words of device memory (zeroed
// here). The grid is `groups` groups of 2^group_bits CTAs of `threads`
// threads (16 x threads slots a tile: the table's tile bits; with `spare`, a
// low sweep with a wide core, at least that many), at most sweep_prepare's
// count for the instance. Returns the cudaError_t of the launch (0 on
// success); the launch does not synchronize.
extern "C" int sweep_launch(int high, float* state, long long dim,
                            const int* table, const float* coef, int kbits,
                            unsigned* barriers, int groups, int group_bits,
                            int threads, int max_core, int spare, void* stream) {
  if (max_core > MAX_CORE || !valid_threads(threads, max_core > NARROW_CORE) ||
      (!spare && (threads << R) > (1 << kbits)) ||
      (spare && (high || max_core <= NARROW_CORE)) ||
      !threads_fit_core(threads, max_core) || groups < 1 || group_bits < 0 ||
      group_bits > kbits || ((long long)groups << group_bits) > (1LL << 20))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(barriers, 0, sizeof(unsigned) * groups, s);
  if (err != cudaSuccess) return (int)err;
  const int launched =
      spare ? launch<false, MAX_CORE, true>(state, dim, table, coef, barriers,
                                            groups, group_bits, threads, s)
      : high ? launch_core<true>(state, dim, table, coef, barriers, groups,
                                 group_bits, threads, max_core, s)
             : launch_core<false>(state, dim, table, coef, barriers, groups,
                                  group_bits, threads, max_core, s);
  if (launched != 0) return launched;
  return (int)cudaGetLastError();
}

extern "C" const char* sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
