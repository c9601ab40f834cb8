// Segment and scatter-segment kernels: a run of segments of a segmented plan
// in one launch.
//
// Replace tpu_qsim/kernels/segmented.py::_build_segment_kernel (the
// pallas_call at segmented.py:162) and ::_build_scatter_segment_kernel (the
// pallas_call at segmented.py:307); their body, emit_ops, is
// block_program.cuh's register program here.
//
// The segment planner (tpu_qsim_torch/schedule.py::plan_segments) keeps the
// gates of a segment on the low L physical bits and relabels the state
// between segments (new bit i = old bit src[i]). A block is the 2^L slots
// whose new index is (b << L) | l. For each block of a segment a CTA
//   1. gathers: slot l comes from old index sum_i bit_i(new index) << src[i]
//      (the identity when the segment has no relabeling), straight into the
//      registers of the register program, 16 slots a thread;
//   2. runs the segment's register table (gridsweeps.py::register_table over
//      the block's L bits): diagonals, 1-qubit cores and X swaps in
//      registers with no barrier, a remap through shared memory with two,
//      a core of 2+ qubits in shared memory with one (the tiled op for 5+,
//      in the wide instance, its scratch after the block);
//   3. stores: to the new index, or, in the scatter segment, to the index the
//      restore-to-canonical relabeling gives it, sum_j bit_j(x) << dst[j]
//      with dst the inverse of the plan's restore.
// An index map is linear in the bits, so the host (segmented.py) writes
// each map once per segment as four 256-word tables of an index's bytes; a
// thread looks up its first slot's index and its register bits' once per
// block and ORs the rest. The planner keeps at least bits 0..4 in place, so
// a warp's 32 consecutive slots are 32 consecutive float32 values of a
// plane, one 128 B line, in every gather and scatter. A relabeled segment
// writes the other of two buffers: one block's sources are other blocks'
// destinations (the JAX kernel drops its in/out alias for the same reason).
//
// One launch runs the segments [first, last) of the plan's table: a
// persistent cooperative grid of as many CTAs as the card keeps resident
// (at most the block count), each taking blocks b, b + gridDim.x, ...; the
// CTAs meet at a barrier on a device counter (grid_sync.cuh) between two
// segments, and the state stays in L2 between them where it fits (8 MB of
// both buffers at 19 qubits). Loads go through L2 only (another CTA wrote
// the slots in the previous segment).
//
// The TPU kernels gathered in chunks of >= 8 rows (GATHER_SWAP_MIN, the
// staged relocations of stage_min) and ran any other relabeling as a
// separate permute; on this card every relabeling folds into the gather and
// the restore into the last segment's scatter.
//
// Bound on this card: device-memory bytes, 16 B per amplitude per segment
// (each segment reads and writes both planes once). The design's cost above
// it is the register program's latency per op (a CTA of 2^(L-4) threads),
// the remaps' and shared-memory ops' barriers, and one barrier per segment.

#include <cuda_runtime.h>

#include "block_program.cuh"
#include "grid_sync.cuh"

namespace {

using namespace qsim;

constexpr int MIN_LOCAL_BITS = LANE_BITS + R;  // one warp
constexpr int MAX_LOCAL_BITS = 14;
constexpr int MAX_THREADS = 1 << (MAX_LOCAL_BITS - R);
// The run table: a header (segments, n, L), a descriptor per segment, then
// each segment's register table and index maps (segmented.py::run_table).
constexpr int RUN_HEADER = 16;
constexpr int SEG_WORDS = 8;  // flags, table, coefficients, gather map, store map
constexpr int F_RELABEL = 1;  // the segment writes the other buffer

// The index map of x: one 256-word table for each of its four bytes.
__device__ __forceinline__ unsigned map_index(const unsigned* t, unsigned x) {
  return __ldg(t + (x & 255u)) | __ldg(t + 256 + ((x >> 8) & 255u)) |
         __ldg(t + 512 + ((x >> 16) & 255u)) | __ldg(t + 768 + (x >> 24));
}

// The map of a block-local slot (l < 2^16): its two low bytes.
__device__ __forceinline__ unsigned map_local(const unsigned* t, unsigned l) {
  return __ldg(t + (l & 255u)) | __ldg(t + 256 + (l >> 8));
}

// run_block's last store through the segment's store map: slot l of block b
// goes to map(b << L) | map(l).
struct MapStore {
  const unsigned* t;
  unsigned base;
  __device__ __forceinline__ unsigned bits(unsigned l) const { return map_local(t, l); }
  __device__ __forceinline__ unsigned at(unsigned l) const { return base | map_local(t, l); }
};

// The tiled op's scratch (float2): a block's worth, at most 2^13 (64 KB
// beside a 2^14-slot block's 128 KB).
constexpr unsigned TILE_CAP = 1u << 13;
__host__ __device__ constexpr unsigned tile_cap(int local_bits) {
  return (1u << local_bits) < TILE_CAP ? 1u << local_bits : TILE_CAP;
}

// Dynamic shared memory of one CTA: the block's planes, and in the wide
// instance the tiled op's scratch.
template <int MAXM>
size_t smem_bytes(int local_bits) {
  const size_t block = (size_t)2 * sizeof(float) << local_bits;
  return MAXM > NARROW_CORE ? block + tile_scratch_bytes(tile_cap(local_bits)) : block;
}

template <int MAXM>
__global__ void __launch_bounds__(MAX_THREADS)
segment_kernel(float* a, float* b, long long dim, const int* __restrict__ table,
               const float2* __restrict__ coef, unsigned* __restrict__ barrier,
               int first, int last) {
  QSIM_DYNAMIC_SHARED(float4, smem4);
  const int lb = table[2];
  if ((blockDim.x << R) != (1u << lb)) __trap();
  const unsigned size = 1u << lb;
  const unsigned blocks = (unsigned)(dim >> lb);
  float* sr = reinterpret_cast<float*>(smem4);  // the block, for remaps and
  float* si = sr + size;                         // shared-memory ops
  // the tiled op's warp tiles: 2 m-tiles, in the 64 registers that 1024
  // threads leave a thread
  const TileScratch<2> scratch{reinterpret_cast<float2*>(si + size), tile_cap(lb)};
  float* cur = a;
  float* other = b;
  unsigned target = 0;
  for (int s = first; s < last; ++s) {
    if (s > first) group_sync(barrier, gridDim.x, target);
    const int* d = table + RUN_HEADER + s * SEG_WORDS;
    const int* sub = table + d[1];
    check_core_width<MAXM>(sub);
    if (sub[HEADER_REG_BITS] != R || sub[1] != lb || sub[2] != 0) __trap();
    const BlockShape shape(sub);
    const float2* sc = coef + d[2];
    const unsigned* gather = reinterpret_cast<const unsigned*>(table + d[3]);
    const unsigned* scatter = reinterpret_cast<const unsigned*>(table + d[4]);
    const float* in_re = cur;
    const float* in_im = cur + dim;
    float* out = d[0] & F_RELABEL ? other : cur;
    for (unsigned blk = blockIdx.x; blk < blocks; blk += gridDim.x) {
      __syncthreads();  // the last block's reads of (sr, si) are done
      const unsigned g_base = map_index(gather, blk << lb);
      run_block<MAXM, false>(
          out, out + dim, sub, shape, sc, 0u, sr, si, scratch,
          [&](Regs& x) {
            unsigned gm[R];
#pragma unroll
            for (int r = 0; r < R; ++r) gm[r] = map_local(gather, x.rm[r]);
            const unsigned gt = g_base | map_local(gather, x.tbase);
#pragma unroll
            for (int v = 0; v < (1 << R); ++v) {
              const unsigned g = gt | reg_off(v, gm);
              x.r[v] = __ldcg(in_re + g);
              x.i[v] = __ldcg(in_im + g);
            }
          },
          MapStore{scatter, map_index(scatter, blk << lb)});
    }
    if (d[0] & F_RELABEL) {
      float* t = cur;
      cur = other;
      other = t;
    }
  }
}

template <int MAXM>
cudaError_t resident(int local_bits, int sms, int* ctas) {
  int per_sm = 0;
  // the most any launch of the instance asks for
  cudaError_t err = cudaFuncSetAttribute(
      segment_kernel<MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<MAXM>(MAX_LOCAL_BITS));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, segment_kernel<MAXM>, 1 << (local_bits - R),
        smem_bytes<MAXM>(local_bits));
  *ctas = per_sm * sms;
  return err;
}

template <int MAXM>
int launch(float* a, float* b, long long dim, const int* table,
           const float* coef, unsigned* barrier, int first, int last,
           int local_bits, int ctas, cudaStream_t stream) {
  return (int)launch_cooperative(segment_kernel<MAXM>, dim3((unsigned)ctas),
                                 dim3(1u << (local_bits - R)), smem_bytes<MAXM>(local_bits),
                                 stream, a, b, dim, table, reinterpret_cast<const float2*>(coef),
                                 barrier, first, last);
}

bool valid_local_bits(int local_bits) {
  return local_bits >= MIN_LOCAL_BITS && local_bits <= MAX_LOCAL_BITS;
}

}  // namespace

// Allow the instance for cores of up to 4 qubits (`wide` 0) or of up to 11
// its shared memory, and report in *ctas how many of its CTAs for blocks of
// 2^local_bits slots (2^(local_bits - 4) threads) the current device keeps
// resident at once: the most one cooperative launch takes. Returns a
// cudaError_t (0 on success).
extern "C" int segment_prepare(int local_bits, int wide, int* ctas) {
  *ctas = 0;
  if (!valid_local_bits(local_bits)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = wide ? resident<MAX_CORE>(local_bits, sms, ctas)
               : resident<NARROW_CORE>(local_bits, sms, ctas);
  return (int)err;
}

// Launch the segments [first, last) of a run table on `stream`: `a` holds
// the input as (2, dim) float32 planes, `b` is the second buffer (a
// relabeled segment writes the other of the two; the result lies in `a`
// after an even number of them, else in `b`). `table` and `coef` are
// device copies of segmented.py::run_table's output for blocks of
// 2^local_bits slots, `max_core` the widest dense core of the range,
// `barrier` one word of device memory (zeroed here), `ctas` at most
// segment_prepare's count and the block count. Returns the cudaError_t of
// the launch (0 on success); the launch does not synchronize.
extern "C" int segment_launch(float* a, float* b, long long dim,
                              const int* table, const float* coef,
                              unsigned* barrier, int first, int last,
                              int local_bits, int ctas, int max_core,
                              void* stream) {
  if (!valid_local_bits(local_bits) || (1LL << local_bits) >= dim ||
      first < 0 || last <= first || ctas < 1 ||
      (long long)ctas > (dim >> local_bits) || max_core > MAX_CORE ||
      !threads_fit_core(1 << (local_bits - R), max_core))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(barrier, 0, sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const int launched =
      max_core <= NARROW_CORE
          ? launch<NARROW_CORE>(a, b, dim, table, coef, barrier, first, last,
                                local_bits, ctas, s)
          : launch<MAX_CORE>(a, b, dim, table, coef, barrier, first, last,
                             local_bits, ctas, s);
  if (launched != 0) return launched;
  return (int)cudaGetLastError();
}

extern "C" const char* segment_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
