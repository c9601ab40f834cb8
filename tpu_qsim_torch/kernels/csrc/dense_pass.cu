// Dense pass: one gate whose dense core is too wide for the op table's
// tiled op (12 qubits and more), applied to the whole state in one launch.
//
// Replaces, for such cores, tpu_qsim/kernels/fused_circuit.py
// ::_emit_gate_generic (fused_circuit.py:569-621, reached from emit_ops
// inside every TPU kernel of tpu_qsim), which has no width limit there: the
// TPU kernel multiplies the core into its VMEM block. Here a core of 2^k x
// 2^k complex64 coefficients is 128 MB or more at k = 12, so an op inside a
// block kernel would reread it from device memory for every block; instead
// the route's kernels stop before the gate, this pass runs, and they go on
// after it (kernels/dispatch.py's split).
//
// The pass is Y = U X out of place, from the (2, 2^n) float32 planes `in`
// to `out`:
//   - U is the core with its index bits in ascending state-bit order (bit j
//     of a row or column index is the j-th lowest target bit; the host,
//     kernels/dense_pass.py, permutes the gate's matrix so), stored
//     column-major as float2, as build_op_table stores wide cores;
//   - column g of X holds the 2^k amplitudes of group g: the slots whose
//     bits outside the targets and controls are those of g (deposited at
//     the free bits) and whose control bits hold the control values. Groups
//     whose controls fail are copied from `in` to `out` unchanged, by CTAs
//     of their own after the product's;
//   - it is a plain tiled complex GEMM. A CTA owns a tile of BM rows x BN
//     groups (fewer groups when the state has fewer), each of its 256
//     threads RM rows x RN groups, strided so that a warp's shared-memory
//     reads broadcast or fall on consecutive words. U streams through shared
//     memory in chunks of BK columns (each column's BM rows are one
//     contiguous run of U), X's chunk is gathered from the state in the
//     order of slot indices (consecutive threads on consecutive slots
//     wherever the targets lie), and the next chunk's loads are issued into
//     registers before the current chunk is multiplied. Four chained FMAs
//     per complex product (ops.cuh's cmac). The output tile goes through
//     shared memory and out in slot order too.
// Two instances: BM = BN = 64 (4 x 4 a thread, BK = 16) for 64 groups and
// more, where the flops bound it; and BM = 32, BN = 16 (1 x 2 a thread,
// BK = 64) for fewer, where U's bytes bound it and more CTAs, each with more
// of U in flight, stream it.
//
// Bound on this card: the larger of U's bytes plus 16 B per amplitude (the
// state read and written once) over 3.35 TB/s and 8 flops per complex
// multiply-add, 8 x 2^(n + k), over 67 TFLOP/s: at n = 16, k = 12 U's
// 128 MB set it (0.04 ms); at n = 22 the flops (2.05 ms).

#include <cuda_runtime.h>

#include "ops.cuh"

namespace {

using namespace qsim;

constexpr int THREADS = 256;

struct Pass {
  const float* re;  // in
  const float* im;
  float* ore;  // out
  float* oim;
  const float2* u;        // 2^k x 2^k, column-major, ascending index bits
  unsigned tmask;         // the target bits
  unsigned cmask, cval;   // the control bits and their values
  unsigned free;          // the other bits of the state: the group bits
  int k;
  unsigned groups;        // 2^popcount(free)
  unsigned dim;           // 2^n
  unsigned gemm_ctas;     // CTAs of the product; the rest copy
};

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// The lowest `count` set bits of mask.
__device__ __forceinline__ unsigned low_bits(unsigned mask, int count) {
  unsigned out = 0;
  for (int i = 0; i < count; ++i) {
    out |= mask & (0u - mask);
    mask &= mask - 1u;
  }
  return out;
}

template <int TX, int RN, int RM, int BK>
__global__ void __launch_bounds__(THREADS) dense_pass_kernel(const Pass p) {
  constexpr int TY = THREADS / TX;
  constexpr int BN = TX * RN;  // groups of a tile
  constexpr int BM = TY * RM;  // rows of a tile
  constexpr int UE = BK * BM / THREADS;  // U elements a thread loads a chunk
  constexpr int XE = (BK * BN + THREADS - 1) / THREADS;
  constexpr int YE = (BM * BN + THREADS - 1) / THREADS;
  constexpr int LOG2BK = ilog2(BK);
  constexpr int LOG2BM = ilog2(BM);
  constexpr int SMEM = BK * (BM + BN) > BM * BN ? BK * (BM + BN) : BM * BN;
  static_assert(UE * THREADS == BK * BM, "U chunk split evenly");
  static_assert((1 << LOG2BK) == BK && (1 << LOG2BM) == BM, "tile sizes");
  __shared__ float2 smem[SMEM];
  float2* us = smem;            // [BK][BM]
  float2* xs = smem + BK * BM;  // [BK][BN]
  float2* ys = smem;            // [BM][BN], after the last chunk

  const unsigned t = threadIdx.x;
  if (blockIdx.x >= p.gemm_ctas) {  // copy the groups whose controls fail
    const unsigned stride = (gridDim.x - p.gemm_ctas) * THREADS;
    for (unsigned l = (blockIdx.x - p.gemm_ctas) * THREADS + t; l < p.dim;
         l += stride)
      if ((l & p.cmask) != p.cval) {
        p.ore[l] = __ldg(p.re + l);
        p.oim[l] = __ldg(p.im + l);
      }
    return;
  }
  const unsigned D = 1u << p.k;
  const unsigned row_tiles = D / BM;
  const unsigned r0 = (blockIdx.x % row_tiles) * BM;
  const unsigned g0 = (blockIdx.x / row_tiles) * BN;
  const int log2g = __popc(p.free);
  const int log2tg = min(log2g, __ffs(BN) - 1);  // this tile's groups
  const unsigned tg = 1u << log2tg;
  const unsigned gbase = deposit_bits(g0, p.free) | p.cval;
  // X's chunk: BK columns (the lowest LOG2BK target bits vary) x tg groups
  // (the lowest log2tg free bits), element e at the e-th slot in order
  const unsigned tlow = low_bits(p.tmask, LOG2BK), flow = low_bits(p.free, log2tg);
  const unsigned xmask = tlow | flow;
  const unsigned thigh = p.tmask & ~tlow;
  const unsigned xcount = BK << log2tg;
  unsigned xl[XE], xo[XE];  // slot bits in the chunk; smem offset c * BN + g
#pragma unroll
  for (int i = 0; i < XE; ++i) {
    const unsigned l = deposit_bits(t + i * THREADS, xmask);
    xl[i] = l;
    xo[i] = extract_bits(l, tlow) * BN + extract_bits(l, flow);
  }
  const float2* u = p.u + r0;
  const unsigned chunks = D / BK;

  float2 un[UE], xn[XE];  // the next chunk, in flight in registers
  auto fetch = [&](unsigned chunk) {
#pragma unroll
    for (int i = 0; i < UE; ++i) {
      const unsigned e = t + i * THREADS;  // column e / BM, row e % BM
      un[i] = __ldg(u + (size_t)(chunk * BK + e / BM) * D + e % BM);
    }
    const unsigned hi = gbase | deposit_bits(chunk, thigh);
#pragma unroll
    for (int i = 0; i < XE; ++i)
      if (t + i * THREADS < xcount) {
        const unsigned l = hi | xl[i];
        xn[i] = make_float2(__ldg(p.re + l), __ldg(p.im + l));
      }
  };

  const unsigned tx = t % TX, ty = t / TX;
  float ar[RM][RN], ai[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) ar[i][j] = ai[i][j] = 0.f;

  fetch(0);
  for (unsigned chunk = 0; chunk < chunks; ++chunk) {
#pragma unroll
    for (int i = 0; i < UE; ++i) us[t + i * THREADS] = un[i];
#pragma unroll
    for (int i = 0; i < XE; ++i)
      if (t + i * THREADS < xcount) xs[xo[i]] = xn[i];
    __syncthreads();
    if (chunk + 1 < chunks) fetch(chunk + 1);
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float2 w[RM], x[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) w[i] = us[c * BM + ty + i * TY];
#pragma unroll
      for (int j = 0; j < RN; ++j) x[j] = xs[c * BN + tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) cmac(ar[i][j], ai[i][j], w[i], x[j].x, x[j].y);
    }
    __syncthreads();  // the chunk's readers are done before it is overwritten
  }

#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j)
      ys[(ty + i * TY) * BN + tx + j * TX] = make_float2(ar[i][j], ai[i][j]);
  __syncthreads();
  // the output tile: BM rows (the lowest LOG2BM target bits) x tg groups
  const unsigned rlow = low_bits(p.tmask, LOG2BM);
  const unsigned ymask = rlow | flow;
  const unsigned yhi = gbase | deposit_bits(r0, p.tmask);
  const unsigned ycount = BM << log2tg;
#pragma unroll
  for (int i = 0; i < YE; ++i) {
    const unsigned e = t + i * THREADS;
    if (e < ycount) {
      const unsigned l = deposit_bits(e, ymask);
      const float2 y = ys[extract_bits(l, rlow) * BN + extract_bits(l, flow)];
      p.ore[yhi | l] = y.x;
      p.oim[yhi | l] = y.y;
    }
  }
}

template <int TX, int RN, int RM, int BK>
int launch(Pass p, cudaStream_t stream) {
  constexpr int BM = THREADS / TX * RM, BN = TX * RN;
  const unsigned row_tiles = (1u << p.k) / BM;
  const unsigned group_tiles = p.groups > (unsigned)BN ? p.groups / BN : 1u;
  p.gemm_ctas = row_tiles * group_tiles;
  unsigned copy_ctas = 0;
  if (p.cmask) {
    copy_ctas = p.dim / THREADS;
    if (copy_ctas > 1024) copy_ctas = 1024;
  }
  dense_pass_kernel<TX, RN, RM, BK><<<p.gemm_ctas + copy_ctas, THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the pass on `stream`: out = the gate applied to `state`, both
// (2, dim) float32 planes on the device, distinct. `u` is the device copy of
// the 2^k x 2^k core (float2, column-major, index bit j the j-th lowest bit
// of `tmask`), `cmask`/`cval` the control bits and values (disjoint from
// the targets). Returns the cudaError_t of the launch (0 on success); the
// launch does not synchronize and allocates nothing.
extern "C" int dense_pass_launch(const float* state, float* out, long long dim,
                                 const float* u, int k, unsigned tmask,
                                 unsigned cmask, unsigned cval, void* stream) {
  if (dim < 2 || dim > (1LL << 30) || (dim & (dim - 1)) || state == out ||
      k < 6 || __builtin_popcount(tmask) != k || (tmask & cmask) ||
      (cval & ~cmask) || ((tmask | cmask) & ~(unsigned)(dim - 1)))
    return (int)cudaErrorInvalidValue;
  Pass p{};
  p.re = state;
  p.im = state + dim;
  p.ore = out;
  p.oim = out + dim;
  p.u = reinterpret_cast<const float2*>(u);
  p.tmask = tmask;
  p.cmask = cmask;
  p.cval = cval;
  p.free = (unsigned)(dim - 1) & ~(tmask | cmask);
  p.k = k;
  p.groups = 1u << __builtin_popcount(p.free);
  p.dim = (unsigned)dim;
  const cudaStream_t s = (cudaStream_t)stream;
  return p.groups >= 64 ? launch<16, 4, 4, 16>(p, s) : launch<8, 2, 1, 64>(p, s);
}

extern "C" const char* dense_pass_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
