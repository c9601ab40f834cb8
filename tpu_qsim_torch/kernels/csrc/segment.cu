// Segment and scatter-segment kernels: one segment of a segmented plan.
//
// Replace tpu_qsim/kernels/segmented.py::_build_segment_kernel (the
// pallas_call at segmented.py:162) and ::_build_scatter_segment_kernel (the
// pallas_call at segmented.py:307); their body, emit_ops, is ops.cuh here.
//
// The segment planner (tpu_qsim_torch/schedule.py::plan_segments) keeps the
// gates of a segment on the low L physical bits and relabels the state
// between segments (new bit i = old bit src[i]). The CTA for block b holds
// the 2^L slots whose new index is (b << L) | l:
//   1. gather: slot l comes from old index sum_i bit_i(new index) << src[i]
//      (or from the new index itself when the segment has no relabeling);
//   2. the segment's ops run on shared memory (ops.cuh, one CTA barrier
//      between ops; as in grid_sweep.cu, an instance for cores of up to
//      NARROW_CORE qubits and one for MAX_CORE, whose tiled op has its
//      scratch after the lookup tables; the planner keeps bits [0, swap_min)
//      of a block's at most 14 bits in place, swap_min 7 unless a wider gate
//      needs the room and never below 5, so cores of up to 9 qubits reach
//      this kernel);
//   3. store: to the new index, or, in the scatter segment, to the index the
//      restore-to-canonical relabeling gives it, sum_j bit_j(x) << dst[j]
//      with dst the inverse of the plan's restore.
// An index map is linear in the bits, so each CTA builds two lookup tables
// per map in shared memory (bits 0-7 and 8-13 of l) and adds its own block's
// share once; the tables take any map of the bits, with no bit fixed. A
// relabeled segment writes another buffer: one block's sources are other
// blocks' destinations (the JAX kernel drops its in/out alias for the same
// reason). The planner keeps at least bits 0..4 in place, so a warp's 32
// consecutive slots are 32 consecutive float32 values of a plane, one 128 B
// line, in every gather and scatter.
//
// The TPU kernels gathered in chunks of >= 8 rows (GATHER_SWAP_MIN, the
// staged relocations of stage_min) and ran any other relabeling as a
// separate permute; on this card every relabeling folds into the gather and
// the restore into the last segment's scatter.
//
// Bound on this card: device-memory bytes, 16 B per amplitude per segment
// (each segment reads and writes both planes once); a segment's ops run on
// shared memory, so the design's cost above the bound is the ops' passes
// and barriers, and the per-slot index arithmetic of the maps.

#include <cuda_runtime.h>

#include "ops.cuh"

namespace {

using namespace qsim;

constexpr int MAX_LOCAL_BITS = 14;
constexpr int MAP_WORDS = 32;  // maps: src[0..n) then dst at [MAP_WORDS, MAP_WORDS + n)
constexpr int LUT_LO = 256;    // bits 0-7 of l
constexpr int LUT_HI = 1 << (MAX_LOCAL_BITS - 8);
constexpr size_t LUT_BYTES = 2 * (LUT_LO + LUT_HI) * sizeof(unsigned);

// Dynamic shared memory of one CTA: the block's planes, the lookup tables,
// and in the wide instance the tiled op's scratch.
template <int MAXM>
size_t smem_bytes(int local_bits, int threads) {
  const size_t base = (2 * sizeof(float) << local_bits) + LUT_BYTES;
  return MAXM > NARROW_CORE ? base + tile_scratch_bytes(threads) : base;
}

// The map's share of bits [from, from + count) of x, where `bits` holds the
// destination bit of each source bit.
__device__ __forceinline__ unsigned map_bits(const int* bits, unsigned x,
                                             int from, int count) {
  unsigned y = 0;
  for (int i = 0; i < count; ++i)
    if ((x >> i) & 1u) y |= 1u << bits[from + i];
  return y;
}

// lo[k] / hi[k]: the map of k placed at bits 0-7 / 8-13 of a block-local
// index; returns the map of the CTA's block bits (b << L).
__device__ unsigned build_lut(const int* bits, int n, int lb, unsigned b,
                              unsigned* lo, unsigned* hi) {
  const int nlo = lb < 8 ? lb : 8;
  const int nhi = lb > 8 ? lb - 8 : 0;
  for (int k = threadIdx.x; k < LUT_LO; k += blockDim.x)
    lo[k] = map_bits(bits, (unsigned)k & ((1u << nlo) - 1u), 0, nlo);
  for (int k = threadIdx.x; k < LUT_HI; k += blockDim.x)
    hi[k] = map_bits(bits, (unsigned)k & ((1u << nhi) - 1u), 8, nhi);
  return map_bits(bits, b, lb, n - lb);
}

template <bool SCATTER, int MAXM>
__global__ void __launch_bounds__(1024)
segment_kernel(const float* in_re, const float* in_im, float* out_re,
               float* out_im, const int* __restrict__ table,
               const float2* __restrict__ coef, const int* __restrict__ maps,
               int n, int gather) {
  extern __shared__ float smem[];
  check_core_width<MAXM>(table);
  const int n_ops = table[0], lb = table[1];
  const unsigned size = 1u << lb;
  float* sr = smem;
  float* si = smem + size;
  unsigned* g_lo = reinterpret_cast<unsigned*>(si + size);
  unsigned* g_hi = g_lo + LUT_LO;
  unsigned* s_lo = g_hi + LUT_HI;
  unsigned* s_hi = s_lo + LUT_LO;
  float2* scratch = reinterpret_cast<float2*>(s_hi + LUT_HI);
  const unsigned b = blockIdx.x;
  const unsigned block_base = b << lb;

  unsigned g_block = block_base, s_block = block_base;
  if (gather) g_block = build_lut(maps, n, lb, b, g_lo, g_hi);
  if (SCATTER) s_block = build_lut(maps + MAP_WORDS, n, lb, b, s_lo, s_hi);
  __syncthreads();

#pragma unroll 4
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    const unsigned g = gather ? g_block | g_lo[l & 255u] | g_hi[l >> 8] : block_base | l;
    sr[l] = __ldcs(in_re + g);
    si[l] = __ldcs(in_im + g);
  }
  __syncthreads();

  const BlockSlots slots{sr, si};
  for (int o = 0; o < n_ops; ++o) {
    apply_op<MAXM>(slots, table + SWEEP_HEADER + o * OP_HEADER, coef, lb, 0u,
                   Part{0, 0u}, scratch);
    __syncthreads();
  }

#pragma unroll 4
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    const unsigned d = SCATTER ? s_block | s_lo[l & 255u] | s_hi[l >> 8] : block_base | l;
    __stcs(out_re + d, sr[l]);
    __stcs(out_im + d, si[l]);
  }
}

template <bool SCATTER, int MAXM>
int launch(const float* in, float* out, long long dim, int n,
           const int* table, const float* coef, const int* maps, int gather,
           int local_bits, int threads, void* stream) {
  const size_t smem = smem_bytes<MAXM>(local_bits, threads);
  segment_kernel<SCATTER, MAXM><<<(unsigned)(dim >> local_bits), threads,
                                  smem, (cudaStream_t)stream>>>(
      in, in + dim, out, out + dim, table,
      reinterpret_cast<const float2*>(coef), maps, n, gather);
  return (int)cudaGetLastError();
}

template <bool SCATTER>
int launch_checked(const float* in, float* out, long long dim, int n,
                   const int* table, const float* coef, const int* maps,
                   int gather, int local_bits, int threads, int max_core,
                   void* stream) {
  if (local_bits < 1 || local_bits > MAX_LOCAL_BITS || local_bits >= n ||
      n > MAP_WORDS || threads < 32 || threads > 1024 || max_core > MAX_CORE ||
      !threads_fit_core(threads, max_core))
    return (int)cudaErrorInvalidValue;
  return max_core <= NARROW_CORE
             ? launch<SCATTER, NARROW_CORE>(in, out, dim, n, table, coef, maps,
                                            gather, local_bits, threads, stream)
             : launch<SCATTER, MAX_CORE>(in, out, dim, n, table, coef, maps,
                                         gather, local_bits, threads, stream);
}

template <bool SCATTER, int MAXM>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(segment_kernel<SCATTER, MAXM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<MAXM>(MAX_LOCAL_BITS, 1024));
}

}  // namespace

// Allow every instance of the kernel the most dynamic shared memory a block
// asks for, on the current device. Call once per device before the first
// launch. Returns a cudaError_t (0 on success).
extern "C" int segment_prepare() {
  cudaError_t err = allow_smem<false, NARROW_CORE>();
  if (err == cudaSuccess) err = allow_smem<false, MAX_CORE>();
  if (err == cudaSuccess) err = allow_smem<true, NARROW_CORE>();
  if (err == cudaSuccess) err = allow_smem<true, MAX_CORE>();
  return (int)err;
}

// Launch one segment on `stream`: `in` and `out` are (2, dim) float32 planes
// (the same tensor when the segment has no relabeling), `table` and `coef`
// device copies of build_op_table's output over BlockLayout(L, L, ()),
// `maps` the int32 gather map (src) at [0, n) and scatter map (dst) at
// [32, 32 + n), `max_core` the table's widest dense core. Returns the
// cudaError_t of the launch (0 on success); the launch does not synchronize.
extern "C" int segment_launch(const float* in, float* out, long long dim,
                              int n, const int* table, const float* coef,
                              const int* maps, int gather, int local_bits,
                              int threads, int max_core, void* stream) {
  return launch_checked<false>(in, out, dim, n, table, coef, maps, gather,
                               local_bits, threads, max_core, stream);
}

// The last segment, storing through the scatter map (out != in).
extern "C" int scatter_segment_launch(const float* in, float* out,
                                      long long dim, int n, const int* table,
                                      const float* coef, const int* maps,
                                      int gather, int local_bits, int threads,
                                      int max_core, void* stream) {
  return launch_checked<true>(in, out, dim, n, table, coef, maps, gather,
                              local_bits, threads, max_core, stream);
}

extern "C" const char* segment_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
