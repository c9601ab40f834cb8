// Rotation-chain probe: the float32 rate the card delivers inside the grid
// sweep's block shape.
//
// Replaces benchmarks/benchmark_floor.py::run_vpu (the pallas_call at
// benchmark_floor.py:359), the arithmetic half of the JAX package's floor
// certificate: each amplitude of the (2, 2^n) float32 planes is rotated K
// times in place, (r, i) <- (r c_j - i s_j, r s_j + i c_j) with a different
// angle at each step j. The slope of time against K is the rate the card
// delivers; tpu_qsim_torch/kernels/floor.py times it.
//
// Blocks and threads are the grid sweep's (grid_sweep.cu, block_program.cuh):
// a CTA holds block bits [0, blk) plus the `a` active high bits, one
// assignment of the other (inactive) high bits, deposited from blockIdx.x;
// 2^(blk + a - R) threads, each with 2^R = 16 amplitudes in registers: block
// bits 0-4 are the lane, the next R bits index the thread's values, the rest
// the warp. So a warp's load of one value is 128 contiguous bytes of a plane,
// as in the grid sweep's first load and last store.
//
// The chain cannot be folded: the K (cos, sin) pairs are device data, copied
// into shared memory by each CTA, and K is a launch argument. Each step is
// 2 FMUL + 2 FFMA per amplitude (6 flops), written with __fmul_rn and fmaf so
// the count does not depend on contraction; the build has no fast-math.
// floor.py::sass_counts reads it back from the SASS.
//
// Bound on this card: float32 issue from K ~ 40 on (4 instructions per
// amplitude per step, at 128 a clock an SM, against 16 bytes of device
// memory traffic per amplitude in all); below, bytes. No tensor cores and
// no TMA: it is a probe of the float32 pipe.

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

using qsim::launch_kernel;

constexpr int LANE_BITS = 5;
constexpr int R = 4;                   // 2^R amplitudes a thread
constexpr int MAX_THREADS = 512;       // a 13-bit block, as grid_sweep.cu
constexpr int MAX_ACTIVE = 8;
constexpr int MAX_INACT = 32;
constexpr int MAX_STEPS = 4096;        // 32 KB of (cos, sin) in shared memory

// Which state bits a CTA holds (floor.py::chain_layout, a BlockLayout).
struct Layout {
  int blk, a, n_inact;
  int active[MAX_ACTIVE];
  int inact[MAX_INACT];
};

// Global amplitude index of block-local slot l (block_program.cuh's
// global_index without the CTA's share).
__device__ __forceinline__ unsigned global_index(unsigned l, const Layout& lay) {
  unsigned g = l & ((1u << lay.blk) - 1u);
  const unsigned hi = l >> lay.blk;
#pragma unroll
  for (int j = 0; j < MAX_ACTIVE; ++j)
    if (j < lay.a && ((hi >> j) & 1u)) g |= 1u << lay.active[j];
  return g;
}

__global__ void __launch_bounds__(MAX_THREADS)
rotation_chain_kernel(float* __restrict__ re, float* __restrict__ im,
                      const float2* __restrict__ cs, int k, Layout lay) {
  QSIM_DYNAMIC_SHARED(float2, s_cs);
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_cs[j] = cs[j];

  unsigned cta_g = 0;  // the CTA's share of the global index
#pragma unroll
  for (int b = 0; b < MAX_INACT; ++b)
    if (b < lay.n_inact && ((blockIdx.x >> b) & 1u)) cta_g |= 1u << lay.inact[b];
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  // value v is block slot lane | v << LANE_BITS | warp << (LANE_BITS + R);
  // the map to the global index is linear in the slot's bits
  const unsigned gt = cta_g | global_index(lane | warp << (LANE_BITS + R), lay);
  unsigned gm[R];
#pragma unroll
  for (int b = 0; b < R; ++b) gm[b] = global_index(1u << (LANE_BITS + b), lay);

  float xr[1 << R], xi[1 << R];
#pragma unroll
  for (int v = 0; v < (1 << R); ++v) {
    unsigned g = gt;
#pragma unroll
    for (int b = 0; b < R; ++b)
      if ((v >> b) & 1) g |= gm[b];
    xr[v] = re[g];
    xi[v] = im[g];
  }
  __syncthreads();  // the (cos, sin) table is in shared memory

#pragma unroll 4
  for (int j = 0; j < k; ++j) {
    const float2 w = s_cs[j];
#pragma unroll
    for (int v = 0; v < (1 << R); ++v) {
      const float r = xr[v], i = xi[v];
      xr[v] = fmaf(r, w.x, -__fmul_rn(i, w.y));
      xi[v] = fmaf(r, w.y, __fmul_rn(i, w.x));
    }
  }

#pragma unroll
  for (int v = 0; v < (1 << R); ++v) {
    unsigned g = gt;
#pragma unroll
    for (int b = 0; b < R; ++b)
      if ((v >> b) & 1) g |= gm[b];
    re[g] = xr[v];
    im[g] = xi[v];
  }
}

}  // namespace

// Rotate every amplitude of `state` ((2, dim) float32 planes) k times in
// place on `stream`. `cs` is a device array of k (cos, sin) float32 pairs;
// a CTA holds block bits [0, blk) and the high bits set in `active_mask`
// (at most MAX_ACTIVE, each in [blk, n)), so 2^(blk + a - R) threads of
// 16 amplitudes: one warp to MAX_THREADS. One CTA per assignment of the
// other high bits. Returns the cudaError_t of the launch (0 on success);
// the launch does not synchronize.
extern "C" int rotation_chain_launch(float* state, long long dim,
                                     const float* cs, int k, int blk,
                                     unsigned active_mask, void* stream) {
  if (dim < 2 || (dim & (dim - 1)) || k < 0 || k > MAX_STEPS) return (int)cudaErrorInvalidValue;
  int n = 0;
  while ((1ll << n) < dim) ++n;
  if (n > 32 || blk < LANE_BITS || blk > n) return (int)cudaErrorInvalidValue;
  Layout lay{};
  lay.blk = blk;
  for (int p = blk; p < n; ++p) {
    if ((active_mask >> p) & 1u) {
      if (lay.a == MAX_ACTIVE) return (int)cudaErrorInvalidValue;
      lay.active[lay.a++] = p;
    } else {
      lay.inact[lay.n_inact++] = p;
    }
  }
  if (active_mask & ((1ull << blk) - 1ull) || (n < 32 && (active_mask >> n)))
    return (int)cudaErrorInvalidValue;
  const int kbits = blk + lay.a;
  if (kbits < LANE_BITS + R || kbits - R > 9 || lay.n_inact > 30)
    return (int)cudaErrorInvalidValue;
  const int threads = 1 << (kbits - R);
  const unsigned grid = 1u << lay.n_inact;
  return (int)launch_kernel(rotation_chain_kernel, grid, threads, (size_t)k * sizeof(float2),
                            (cudaStream_t)stream, state, state + dim,
                            reinterpret_cast<const float2*>(cs), k, lay);
}

extern "C" const char* rotation_chain_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
