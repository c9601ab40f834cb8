// Test-only kernels, each with one fault a switch turns on, for the host
// harness's own tests (tests/test_torch_host_harness.py): the harness must
// report each fault and pass each kernel with its fault off. They go
// through the port's ptx.cuh, as the port's kernels do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "grid_sync.cuh"
#include "ptx.cuh"

namespace {

using namespace qsim;

constexpr int THREADS = 32;
constexpr int GROUP = 128;                   // a warpgroup
constexpr int RING_ITEMS = 4, RING_SLOTS = 2;  // ring's items of 32 floats, its slots

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

// D = A B by one warpgroup's wgmma m64nNk8 (N = 64 or 128): B (8 x N, row
// k) the first plane's first 8 N elements, A[r][k] = 1 where r % 8 == k (so
// row r of D is row r % 8 of B), D (64 x N, row-major) into the second
// plane (dim >= 64 N). `fault` 1 reads D before its wgmma.wait_group, 2
// stores into B while the product is in flight, 3 leaves out
// fence.proxy.async, 4 leaves out wgmma.fence.
template <int N>
__global__ void wgmma_product(float* state, long long dim, int fault) {
  QSIM_DYNAMIC_SHARED(float4, smem4);
  float* b = reinterpret_cast<float*>(smem4);
  const unsigned t = threadIdx.x, lane = t % 32, warp = t / 32;
  // B's element (k, n) in core matrix (k / 4, n / 8) of 8 rows of 4 TF32:
  // 16 N bytes from one core matrix to the next along K, 128 along N
  for (unsigned i = t; i < 8 * N; i += GROUP) {
    const unsigned k = i / N, n = i % N;
    b[(k / 4 * (N / 8) + n / 8) * 32 + n % 8 * 4 + k % 4] = state[i];
  }
  if (fault != 3) fence_proxy_async();
  __syncthreads();
  const unsigned base = (unsigned)__cvta_generic_to_shared(b);
  const uint64_t desc = (uint64_t)((base >> 4) & 0x3fffu) | ((uint64_t)(16 * N >> 4) << 16) |
                        ((uint64_t)(128 >> 4) << 32);
  const unsigned g = lane / 4, q = lane % 4;  // rows g (+ 8) of the warp's 16, columns q (+ 4)
  const uint32_t one = __float_as_uint(1.f);
  const uint32_t a[4] = {g == q ? one : 0u, g == q ? one : 0u, g == q + 4 ? one : 0u,
                         g == q + 4 ? one : 0u};
  float d[N / 2], early[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  if (fault != 4) wgmma_fence();
  if constexpr (N == 64) wgmma<1>(d, a, desc, 0);
  else wgmma128<1>(d, a, desc, 0);
  wgmma_commit();
  if (fault == 1)
    for (int i = 0; i < N / 2; ++i) early[i] = d[i];
  if (fault == 2 && t == 0) b[0] += 1.f;
  wgmma_wait<0>();
  for (int j = 0; j < N / 8; ++j)
    for (int v = 0; v < 4; ++v) {
      const unsigned row = warp * 16 + g + (v >> 1) * 8, col = 8 * j + 2 * q + (v & 1);
      state[dim + row * N + col] = fault == 1 ? early[4 * j + v] : d[4 * j + v];
    }
}

// A ring of RING_SLOTS slots of 32 floats through shared memory, with
// mbarriers full (32 arrivals) and empty (32): warp 1 produces item i (the
// first plane's floats [32 i, 32 i + 32)) into slot i % 2, warp 0 consumes
// it into the second plane, plus 1. `mode` 1: the consumer skips its wait
// on full for item 2 (slot 0's second lap); 2: the producer skips its wait
// on empty for item 2; 3: full counts one arrival more than are made; 4:
// the consumer arrives on a barrier never initialised; 5: a store over
// full[0]'s word.
__global__ void ring(float* state, long long dim, int mode) {
  QSIM_DYNAMIC_SHARED(float4, smem4);
  float* slots = reinterpret_cast<float*>(smem4);
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + RING_SLOTS * 32);
  uint64_t* empty = full + RING_SLOTS;
  const unsigned t = threadIdx.x, lane = t % 32;
  if (t == 0)
    for (int s = 0; s < RING_SLOTS; ++s) {
      mbar_init(full + s, mode == 3 ? 33 : 32);
      if (!(mode == 4 && s == 1)) mbar_init(empty + s, 32);
    }
  __syncthreads();
  if (mode == 5 && t == 0) full[0] = 0;
  for (unsigned i = 0; i < RING_ITEMS; ++i) {
    const unsigned s = i % RING_SLOTS, lap = i / RING_SLOTS;
    if (t >= 32) {
      if (lap > 0 && !(mode == 2 && i == 2)) mbar_wait(empty + s, (lap - 1) & 1);
      slots[s * 32 + lane] = state[i * 32 + lane];
      mbar_arrive(full + s);
    } else {
      if (!(mode == 1 && i == 2)) mbar_wait(full + s, lap & 1);
      state[dim + i * 32 + lane] = slots[s * 32 + lane] + 1.f;
      mbar_arrive(empty + s);
    }
  }
}

// Two stages on the (2, dim) planes, dim = 64, CTA b on elements [32 b,
// 32 b + 32): stage 1 doubles the first plane into the second, stage 2 sets
// the first plane to the other CTA's half of the second, plus 1. `mode` 0
// meets at a grid barrier between them, 1 skips it, 2 meets at a barrier
// that waits for a third CTA, which never comes.
__global__ void grid_stages(float* state, long long dim, unsigned* counter, int mode) {
  const unsigned i = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned other = (1 - blockIdx.x) * blockDim.x + threadIdx.x;
  state[dim + i] = 2.f * state[i];
  unsigned target = 0;
  if (mode != 1) group_sync(counter, mode == 2 ? 3u : gridDim.x, target);
  state[i] = state[dim + other] + 1.f;
}

}  // namespace

// kind 0: shared_write, 1: global_write, 2: async_copy, 3: shift, one CTA of
// 32 threads; 4-7: wgmma_product<64> with fault kind - 3, one warpgroup; 8:
// grid_stages, a cooperative launch of two CTAs of 32 threads on `counter`
// (one zeroed word); 9: ring, one CTA of 64 threads; 10-13:
// wgmma_product<128> with fault kind - 9; `arg` the kernel's switch, on the
// (2, dim) planes
extern "C" int host_fault_launch(int kind, float* state, long long dim, int arg,
                                 unsigned* counter) {
  const size_t smem = THREADS * sizeof(float);
  switch (kind) {
    case 0: return (int)launch_kernel(shared_write, 1, THREADS, smem, nullptr, state, arg);
    case 1: return (int)launch_kernel(global_write, 1, THREADS, 0, nullptr, state, dim, arg);
    case 2: return (int)launch_kernel(async_copy, 1, THREADS, smem, nullptr, state, arg);
    case 3: return (int)launch_kernel(shift, 1, THREADS, 0, nullptr, state, arg);
    case 4:
    case 5:
    case 6:
    case 7:
      return (int)launch_kernel(wgmma_product<64>, 1, GROUP, 8 * 64 * sizeof(float), nullptr, state,
                                dim, arg ? kind - 3 : 0);
    case 8:
      return (int)launch_cooperative(grid_stages, 2, THREADS, 0, nullptr, state, dim, counter, arg);
    case 9:
      return (int)launch_kernel(ring, 1, 2 * THREADS,
                                RING_SLOTS * (32 * sizeof(float) + 2 * sizeof(uint64_t)), nullptr,
                                state, dim, arg);
    case 10:
    case 11:
    case 12:
    case 13:
      return (int)launch_kernel(wgmma_product<128>, 1, GROUP, 8 * 128 * sizeof(float), nullptr,
                                state, dim, arg ? kind - 9 : 0);
  }
  return (int)cudaErrorInvalidValue;
}
