// Grid-sweep kernel: one full-state sweep of a planned gate list.
//
// Replaces tpu_qsim/kernels/gridsweeps.py::_build_grid_sweep (the
// pallas_call at gridsweeps.py:566) and its body,
// tpu_qsim/kernels/fused_circuit.py::emit_ops.
//
// State: float32 planes re[2^n], im[2^n] (one (2, 2^n) tensor). A sweep holds
// block bits [0, blk) plus a <= a_max "active" high bits; each CTA owns one
// assignment of the remaining (inactive) high bits, deposited from
// blockIdx.x. The CTA loads its 2^k amplitudes (k = blk + a) of both planes
// into dynamic shared memory, applies every op of the sweep in order with a
// __syncthreads() between ops, and writes the block back in place. Blocks are
// disjoint, so in-place is safe (the JAX kernel aliases input and output).
//
// The gate list arrives as device data (one compile serves every circuit):
// an int32 table written by tpu_qsim_torch/kernels/fused_circuit.py
// ::build_op_table and float32 (re, im) coefficients composed on the host in
// complex128. A qubit code < EXT names a bit of the block-local index; EXT + p
// names state bit p outside the block, read from the CTA's share of the
// global index. That replaces the TPU kernel's ext scalars and relabeling.
//
// Bound on this card: device-memory bytes. A sweep must read and write both
// planes once (16 B per amplitude); the ops run on shared memory. The design
// keeps every op of a sweep out of device memory; the per-op shared-memory
// passes and barriers are the cost a later kernel can cut.

#include <cuda_runtime.h>

namespace {

constexpr int SWEEP_HEADER = 64;
constexpr int OP_HEADER = 32;
constexpr int EXT = 32;
constexpr int KIND_DIAG = 0;

__device__ __forceinline__ unsigned bit_of(int code, unsigned l,
                                           unsigned cta_g) {
  return code < EXT ? (l >> code) & 1u : (cta_g >> (code - EXT)) & 1u;
}

// Global amplitude index of block-local slot l.
__device__ __forceinline__ unsigned global_index(unsigned l, int blk, int a,
                                                 const int* active,
                                                 unsigned cta_g) {
  unsigned g = cta_g | (l & ((1u << blk) - 1u));
  const unsigned hi = l >> blk;
  for (int j = 0; j < a; ++j)
    if ((hi >> j) & 1u) g |= 1u << active[j];
  return g;
}

// Diagonal op: one thread per amplitude, d[bits of the op's qubits]. Ops
// on one or two qubits (rz, cz, cp, crz) keep their diagonal in registers.
__device__ void apply_diag(float* sr, float* si, const int* op,
                           const float2* coef, unsigned size,
                           unsigned cta_g) {
  const int m = op[1];
  const float2* d = coef + op[2];
  if (m <= 2) {
    const int q0 = op[8], q1 = m == 2 ? op[9] : 0;
    const float2 w0 = d[0], w1 = d[1];
    const float2 w2 = m == 2 ? d[2] : w0, w3 = m == 2 ? d[3] : w1;
    for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
      unsigned idx = bit_of(q0, l, cta_g);
      if (m == 2) idx = (idx << 1) | bit_of(q1, l, cta_g);
      const float2 c = idx == 0 ? w0 : idx == 1 ? w1 : idx == 2 ? w2 : w3;
      const float r = sr[l], im = si[l];
      sr[l] = c.x * r - c.y * im;
      si[l] = c.x * im + c.y * r;
    }
    return;
  }
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    unsigned idx = 0;
    for (int i = 0; i < m; ++i) idx = (idx << 1) | bit_of(op[8 + i], l, cta_g);
    const float2 w = d[idx];
    const float r = sr[l], im = si[l];
    sr[l] = w.x * r - w.y * im;
    si[l] = w.x * im + w.y * r;
  }
}

// Dense op on M block-local qubits, under local controls: one thread per
// group of 2^M amplitudes, gathered to registers and multiplied by the
// row-major 2^M x 2^M core.
template <int M>
__device__ void apply_dense(float* sr, float* si, const int* op,
                            const float2* coef, int kbits) {
  constexpr int D = 1 << M;
  const unsigned lmask = op[3], lval = op[4];
  unsigned offs[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    unsigned o = 0;
    for (int i = 0; i < M; ++i)
      if ((j >> (M - 1 - i)) & 1) o |= 1u << op[8 + i];
    offs[j] = o;
  }
  int pos[M];
  for (int i = 0; i < M; ++i) pos[i] = op[24 + i];
  // 1- and 2-qubit cores (4 and 16 coefficients) live in registers; wider
  // cores are read through the cache
  constexpr int NW = M <= 2 ? D * D : 1;
  float2 w[NW];
  const float2* u = coef + op[2];
  if constexpr (M <= 2) {
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = u[j];
  }
  const unsigned groups = 1u << (kbits - M);
  for (unsigned gi = threadIdx.x; gi < groups; gi += blockDim.x) {
    unsigned base = gi;
    for (int i = 0; i < M; ++i) {  // insert a 0 at each target, ascending
      const unsigned low = base & ((1u << pos[i]) - 1u);
      base = ((base >> pos[i]) << (pos[i] + 1)) | low;
    }
    if ((base & lmask) != lval) continue;
    float xr[D], xi[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xr[j] = sr[base | offs[j]];
      xi[j] = si[base | offs[j]];
    }
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float2 c2;
        if constexpr (M <= 2) c2 = w[r * D + c];
        else c2 = u[r * D + c];
        ar += c2.x * xr[c] - c2.y * xi[c];
        ai += c2.x * xi[c] + c2.y * xr[c];
      }
      sr[base | offs[r]] = ar;
      si[base | offs[r]] = ai;
    }
  }
}

__global__ void __launch_bounds__(1024)
grid_sweep_kernel(float* __restrict__ re, float* __restrict__ im,
                  const int* __restrict__ table,
                  const float2* __restrict__ coef) {
  extern __shared__ float smem[];
  const int n_ops = table[0], blk = table[1], a = table[2];
  const int n_inact = table[3];
  const int kbits = blk + a;
  const unsigned size = 1u << kbits;
  const int* active = table + 16;
  float* sr = smem;
  float* si = smem + size;

  unsigned cta_g = 0;
  for (int b = 0; b < n_inact; ++b)
    if ((blockIdx.x >> b) & 1u) cta_g |= 1u << table[32 + b];

  // unrolled so each thread keeps several independent loads in flight
#pragma unroll 4
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    const unsigned g = global_index(l, blk, a, active, cta_g);
    sr[l] = __ldcs(re + g);
    si[l] = __ldcs(im + g);
  }
  __syncthreads();

  for (int o = 0; o < n_ops; ++o) {
    const int* op = table + SWEEP_HEADER + o * OP_HEADER;
    // out-of-block controls are uniform over the CTA
    if ((cta_g & (unsigned)op[5]) == (unsigned)op[6]) {
      if (op[0] == KIND_DIAG) {
        apply_diag(sr, si, op, coef, size, cta_g);
      } else {
        switch (op[1]) {
          case 1: apply_dense<1>(sr, si, op, coef, kbits); break;
          case 2: apply_dense<2>(sr, si, op, coef, kbits); break;
          case 3: apply_dense<3>(sr, si, op, coef, kbits); break;
          case 4: apply_dense<4>(sr, si, op, coef, kbits); break;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll 4
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    const unsigned g = global_index(l, blk, a, active, cta_g);
    __stcs(re + g, sr[l]);
    __stcs(im + g, si[l]);
  }
}

}  // namespace

// Launch one sweep on `stream`. `state` is the (2, dim) float32 planes,
// `table` and `coef` device copies of build_op_table's output. Returns the
// cudaError_t of the launch (0 on success); the launch does not synchronize.
extern "C" int grid_sweep_launch(float* state, long long dim,
                                 const int* table, const float* coef,
                                 int kbits, long long steps, int threads,
                                 void* stream) {
  const size_t smem = (size_t)2 * sizeof(float) << kbits;
  cudaError_t err = cudaFuncSetAttribute(
      grid_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  grid_sweep_kernel<<<(unsigned)steps, threads, smem,
                      (cudaStream_t)stream>>>(
      state, state + dim, table, reinterpret_cast<const float2*>(coef));
  return (int)cudaGetLastError();
}

extern "C" const char* grid_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
