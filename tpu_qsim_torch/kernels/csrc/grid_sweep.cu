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
// The op semantics (apply_op: diagonal ops and dense cores of up to 8
// qubits) live in ops.cuh, shared with the whole-circuit, segment and sweep
// kernels. The kernel is built twice, for cores of up to NARROW_CORE and of
// up to MAX_CORE qubits; a sweep whose cores are all narrow launches the
// first, so the wide cores' code costs it nothing.
//
// Bound on this card: device-memory bytes. A sweep must read and write both
// planes once (16 B per amplitude); the ops run on shared memory. The design
// keeps every op of a sweep out of device memory; the per-op shared-memory
// passes and barriers are the cost a later kernel can cut.

#include <cuda_runtime.h>

#include "ops.cuh"

namespace {

using namespace qsim;

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

template <int MAXM>
__global__ void __launch_bounds__(1024)
grid_sweep_kernel(float* __restrict__ re, float* __restrict__ im,
                  const int* __restrict__ table,
                  const float2* __restrict__ coef) {
  extern __shared__ float smem[];
  check_core_width<MAXM>(table);
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

  const BlockSlots slots{sr, si};
  for (int o = 0; o < n_ops; ++o) {
    apply_op<MAXM>(slots, table + SWEEP_HEADER + o * OP_HEADER, coef, kbits,
                   cta_g, Part{0, 0u});
    __syncthreads();
  }

#pragma unroll 4
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    const unsigned g = global_index(l, blk, a, active, cta_g);
    __stcs(re + g, sr[l]);
    __stcs(im + g, si[l]);
  }
}

template <int MAXM>
int launch(float* state, long long dim, const int* table, const float* coef,
           int kbits, long long steps, int threads, cudaStream_t stream) {
  const size_t smem = (size_t)2 * sizeof(float) << kbits;
  cudaError_t err = cudaFuncSetAttribute(
      grid_sweep_kernel<MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  grid_sweep_kernel<MAXM><<<(unsigned)steps, threads, smem, stream>>>(
      state, state + dim, table, reinterpret_cast<const float2*>(coef));
  return (int)cudaGetLastError();
}

}  // namespace

// Launch one sweep on `stream`. `state` is the (2, dim) float32 planes,
// `table` and `coef` device copies of build_op_table's output, `max_core`
// the table's widest dense core. Returns the cudaError_t of the launch (0 on
// success); the launch does not synchronize.
extern "C" int grid_sweep_launch(float* state, long long dim,
                                 const int* table, const float* coef,
                                 int kbits, long long steps, int threads,
                                 int max_core, void* stream) {
  if (max_core > MAX_CORE || !threads_fit_core(threads, max_core))
    return (int)cudaErrorInvalidValue;
  return max_core <= NARROW_CORE
             ? launch<NARROW_CORE>(state, dim, table, coef, kbits, steps,
                                   threads, (cudaStream_t)stream)
             : launch<MAX_CORE>(state, dim, table, coef, kbits, steps,
                                threads, (cudaStream_t)stream);
}

extern "C" const char* grid_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
