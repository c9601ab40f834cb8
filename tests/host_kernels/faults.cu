// Test-only kernels, each with one fault a switch turns on, for the host
// harness's own tests (tests/test_torch_host_harness.py): the harness must
// report each fault and pass each kernel with its fault off. They go
// through the port's ptx.cuh, as the port's kernels do.

#include <cuda_runtime.h>

#include "ptx.cuh"

namespace {

using namespace qsim;

constexpr int THREADS = 32;

// each thread's element through shared memory at t + over: with over = 1
// the last thread writes one float past the launch's dynamic bytes
__global__ void shared_write(float* state, int over) {
  QSIM_DYNAMIC_SHARED(float, s);
  s[threadIdx.x + over] = state[threadIdx.x];
  __syncthreads();
  state[threadIdx.x] = s[threadIdx.x];
}

// one element written at (2 dim - 1 + over) of the (2, dim) planes
__global__ void global_write(float* state, long long dim, int over) {
  if (threadIdx.x == 0) state[2 * dim - 1 + over] = 0.f;
}

// each thread's element copied into shared memory with cp.async and back,
// read before (early = 1) or after the cp.async.wait_group
__global__ void async_copy(float* state, int early) {
  QSIM_DYNAMIC_SHARED(float, s);
  const unsigned t = threadIdx.x;
  cp_async4(s + t, state + t);
  cp_async_commit();
  float v = early ? s[t] : 0.f;
  cp_async_wait<0>();
  if (!early) v = s[t];
  state[t] = v;
}

// 1u << bits: bits = 32 shifts past the width
__global__ void shift(float* state, int bits) {
  state[threadIdx.x] = (float)((1u << bits) >> 31);
}

}  // namespace

// kind 0: shared_write, 1: global_write, 2: async_copy, 3: shift, with
// `arg` the kernel's switch; one CTA of 32 threads on the (2, dim) planes
extern "C" int host_fault_launch(int kind, float* state, long long dim, int arg) {
  const size_t smem = THREADS * sizeof(float);
  switch (kind) {
    case 0: return (int)launch_kernel(shared_write, 1, THREADS, smem, nullptr, state, arg);
    case 1: return (int)launch_kernel(global_write, 1, THREADS, 0, nullptr, state, dim, arg);
    case 2: return (int)launch_kernel(async_copy, 1, THREADS, smem, nullptr, state, arg);
    case 3: return (int)launch_kernel(shift, 1, THREADS, 0, nullptr, state, arg);
  }
  return (int)cudaErrorInvalidValue;
}
