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
// The narrow instance runs at 64 registers, so that two CTAs of
// MAX_THREADS fit an SM where shared memory allows (128 registers were 10%
// slower at 28 qubits on the H100); the wide one at 128, which the tiled op
// needs (at 64 it spilled and took 1.8x the time).
template <int MAXM>
__global__ void __launch_bounds__(MAX_THREADS, MAXM <= NARROW_CORE ? 2 : 1)
grid_sweep_kernel(float* __restrict__ re, float* __restrict__ im,
                  const int* __restrict__ table,
                  const float2* __restrict__ coef) {
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
  for (; step < steps; step += gridDim.x) {
    run_block<MAXM, true>(re, im, table, shape, coef, step_bits(step, n_inact, inact),
                          sr, si, scratch, [&](Regs& x) {
      cp_async_wait<0>();
      __syncthreads();  // the step's block is in (pr, pi); (sr, si) is free
      x.load(pr, pi);
      __syncthreads();  // every thread has its values: prefetch the next
      if (step + gridDim.x < steps)
        prefetch_block(pr, pi, re, im, size, blk, a, active,
                       step_bits(step + gridDim.x, n_inact, inact));
    });
  }
}

template <int MAXM>
int launch(float* state, long long dim, const int* table, const float* coef,
           int kbits, long long steps, int threads, cudaStream_t stream) {
  size_t smem = (size_t)4 * sizeof(float) << kbits;  // block and prefetch
  if (MAXM > NARROW_CORE) smem += tile_scratch_bytes(1u << kbits);
  cudaError_t err = cudaFuncSetAttribute(
      grid_sweep_kernel<MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_sweep_kernel<MAXM>, threads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long resident = (long long)per_sm * sms;
  const unsigned grid = (unsigned)(steps < resident ? steps : resident);
  return (int)launch_kernel(grid_sweep_kernel<MAXM>, grid, threads, smem, stream, state,
                            state + dim, table, reinterpret_cast<const float2*>(coef));
}

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
  const int threads = kbits >= LANE_BITS + R ? 1 << (kbits - R) : 0;
  if (max_core > MAX_CORE || threads < 32 || threads > MAX_THREADS ||
      !threads_fit_core(threads, max_core))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  return max_core <= NARROW_CORE
             ? launch<NARROW_CORE>(state, dim, table, coef, kbits, steps,
                                   threads, s)
             : launch<MAX_CORE>(state, dim, table, coef, kbits, steps, threads,
                                s);
}

extern "C" const char* grid_sweep_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
