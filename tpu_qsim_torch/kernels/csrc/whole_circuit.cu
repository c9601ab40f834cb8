// Whole-circuit kernel: one launch applies a whole circuit to a state that
// stays on chip, read from device memory once and written once.
//
// Replaces tpu_qsim/kernels/fused_circuit.py::build_pallas_run_gates (the
// pallas_call at fused_circuit.py:1552, wrapper build_pallas_run), which
// holds the whole state in VMEM; its body, emit_ops, is ops.cuh here.
//
// Design: one thread-block cluster of 2^c CTAs holds the state in their
// distributed shared memory. CTA r holds slots [r * 2^L, (r + 1) * 2^L) of
// both float32 planes, L = n - c <= 14 (2 x 4 B x 2^14 = 128 KB of dynamic
// shared memory). Every op is shared by the whole cluster: CTA r takes the
// r-th part of the op's work items (ops.cuh's Part). An op that moves no bit
// >= L (every diagonal op, every dense core on low bits) then touches only
// CTA r's own slots and runs on its shared memory directly; an op with a
// target >= L reads and writes the other CTAs' slots through
// cluster.map_shared_rank. A cluster barrier comes before and after each
// such op and before the store; between two local ops a CTA barrier is
// enough. At 18 qubits this is c = 4: 16 CTAs of 128 KB, a non-portable
// cluster size, launched with cudaLaunchKernelEx; whole_circuit_prepare
// asks cudaOccupancyMaxActiveClusters whether the card can place the
// geometry, and the wrapper raises when it cannot. On the H100 it places 7
// such clusters at once, so the cluster design was taken over the fallback
// of a persistent cooperative grid with the state in L2 and a grid-wide
// barrier per op (PERF.md has the geometry chosen for each size).
//
// The op table is build_op_table over BlockLayout(n, n, ()): every state bit
// is a block bit, so no op carries an out-of-block code. As in grid_sweep.cu,
// the kernel is built for cores of up to NARROW_CORE and of up to MAX_CORE
// qubits, and a circuit with no wide core launches the first. A core of
// TILE_CORE qubits or more (ops.cuh's tiled product) always runs through the
// cluster's slots, its tiles taken by the CTAs in turn, with the tile
// scratch after the CTA's planes in the wide instance's shared memory.
//
// Bound on this card: a run must move 16 B per amplitude (both planes read
// and written once: 1.25 us at 18 qubits and 3.35 TB/s) and do the
// arithmetic its gates need (fused_circuit.py::min_flops: ~250 flops per
// amplitude for random_circuit(18, 100), 0.98 us at 67 TFLOP/s; its CNOTs
// and CZs need none), so device-memory bytes set the bound.
// The design is far from it: it runs on at most 16 of the card's 132 SMs,
// with one pass over the slots and one barrier per op. What it buys over
// the torch engine is one launch and no device-memory pass per gate group.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "ops.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace qsim;

constexpr int MAX_LOCAL_BITS = 14;
constexpr int MAX_CLUSTER_BITS = 4;  // 16 CTAs, the non-portable maximum

// Dynamic shared memory of one CTA: its slice of both planes, and in the wide
// instance the tiled op's scratch.
template <int MAXM>
size_t smem_bytes(int n, int cluster_bits, int threads) {
  const size_t planes = (size_t)2 * sizeof(float) << (n - cluster_bits);
  return MAXM > NARROW_CORE ? planes + tile_scratch_bytes(threads) : planes;
}

template <int MAXM>
__global__ void __launch_bounds__(1024)
whole_circuit_kernel(float* __restrict__ re, float* __restrict__ im,
                     const int* __restrict__ table,
                     const float2* __restrict__ coef, int cluster_bits) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  check_core_width<MAXM>(table);
  const int n_ops = table[0], n = table[1];
  const int lb = n - cluster_bits;
  const unsigned size = 1u << lb;
  float* sr = smem;
  float* si = smem + size;
  const size_t off = (size_t)rank << lb;

#pragma unroll 4
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    sr[l] = __ldcs(re + off + l);
    si[l] = __ldcs(im + off + l);
  }

  float2* scratch = reinterpret_cast<float2*>(si + size);
  const LocalSlots local{sr, si, size - 1u};
  const ClusterSlots remote{sr, si, lb};
  const Part part{cluster_bits, rank};
  bool prev_remote = false;
  for (int o = 0; o < n_ops; ++o) {
    const int* op = table + SWEEP_HEADER + o * OP_HEADER;
    const bool moves_remote = op_moves_from<MAXM>(op, lb);
    if (moves_remote || prev_remote) cluster.sync();
    else __syncthreads();
    if (moves_remote) apply_op<MAXM>(remote, op, coef, n, 0u, part, scratch);
    else apply_op<MAXM>(local, op, coef, n, 0u, part, scratch);
    prev_remote = moves_remote;
  }
  // no CTA leaves while another may still read its shared memory
  if (prev_remote) cluster.sync();
  else __syncthreads();

#pragma unroll 4
  for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
    __stcs(re + off + l, sr[l]);
    __stcs(im + off + l, si[l]);
  }
}

template <int MAXM>
cudaLaunchConfig_t launch_config(int n, int cluster_bits, int threads,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1u << cluster_bits, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<MAXM>(n, cluster_bits, threads);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << cluster_bits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Set one instance's attributes and report in *clusters how many clusters
// of the geometry the card holds at once.
template <int MAXM>
cudaError_t prepare(int n, int cluster_bits, int threads, int* clusters) {
  // the most any geometry asks for, so that preparing one geometry does not
  // lower another's
  cudaError_t err = cudaFuncSetAttribute(
      whole_circuit_kernel<MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<MAXM>(MAX_LOCAL_BITS, 0, 1024));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(whole_circuit_kernel<MAXM>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      launch_config<MAXM>(n, cluster_bits, threads, 0, &attr);
  return cudaOccupancyMaxActiveClusters(
      clusters, (const void*)whole_circuit_kernel<MAXM>, &cfg);
}

}  // namespace

// Error code of a geometry the kernel does not take (outside the CUDA range).
constexpr int WHOLE_CIRCUIT_BAD_GEOMETRY = 10001;

// Set the kernel's attributes and report in *clusters how many clusters of
// this geometry the card can hold at once, the fewer of the two instances
// (0: it cannot place one). Returns a cudaError_t, or
// WHOLE_CIRCUIT_BAD_GEOMETRY.
extern "C" int whole_circuit_prepare(int n, int cluster_bits, int threads,
                                     int* clusters) {
  *clusters = 0;
  if (cluster_bits < 0 || cluster_bits > MAX_CLUSTER_BITS ||
      n - cluster_bits > MAX_LOCAL_BITS || n - cluster_bits < 6 ||
      threads < 32 || threads > 1024)
    return WHOLE_CIRCUIT_BAD_GEOMETRY;
  int narrow = 0, wide = 0;
  cudaError_t err = prepare<NARROW_CORE>(n, cluster_bits, threads, &narrow);
  if (err == cudaSuccess)
    err = prepare<MAX_CORE>(n, cluster_bits, threads, &wide);
  *clusters = narrow < wide ? narrow : wide;
  return (int)err;
}

// Launch the whole circuit on `stream`, in place on the (2, 2^n) float32
// planes `state`. `table` and `coef` are device copies of build_op_table's
// output, `max_core` the table's widest dense core. Call
// whole_circuit_prepare for the geometry first. Returns the cudaError_t of
// the launch (0 on success); the launch does not synchronize.
extern "C" int whole_circuit_launch(float* state, int n, const int* table,
                                    const float* coef, int cluster_bits,
                                    int threads, int max_core, void* stream) {
  if (max_core > MAX_CORE || max_core > n || !threads_fit_core(threads, max_core))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  float* im = state + ((size_t)1 << n);
  const float2* c = reinterpret_cast<const float2*>(coef);
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (max_core <= NARROW_CORE) {
    cudaLaunchConfig_t cfg =
        launch_config<NARROW_CORE>(n, cluster_bits, threads, s, &attr);
    err = cudaLaunchKernelEx(&cfg, whole_circuit_kernel<NARROW_CORE>, state, im,
                             table, c, cluster_bits);
  } else {
    cudaLaunchConfig_t cfg =
        launch_config<MAX_CORE>(n, cluster_bits, threads, s, &attr);
    err = cudaLaunchKernelEx(&cfg, whole_circuit_kernel<MAX_CORE>, state, im,
                             table, c, cluster_bits);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" const char* whole_circuit_error_string(int err) {
  if (err == WHOLE_CIRCUIT_BAD_GEOMETRY)
    return "geometry outside 0 <= c <= 4, 6 <= n - c <= 14, 32 <= threads <= 1024";
  return cudaGetErrorString((cudaError_t)err);
}
