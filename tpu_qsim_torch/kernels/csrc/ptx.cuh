// Every inline-PTX wrapper of the port's kernels, the shared-memory
// declarations and the launch helpers, in one header.
//
// The kernels' sources reach the hardware only through this header and
// CUDA's own intrinsics (__syncthreads, __shfl_xor_sync, __ldg, __ldcg,
// __stcs, __trap, clock64, atomicAdd, __threadfence,
// __cvta_generic_to_shared). So the same sources also build for the host:
// with QSIM_HOST defined, this header is replaced by the host build's twin
// (<qsim_host_ptx.h>, tests/host_kernels/include/), which gives each wrapper
// and intrinsic a host meaning (a CTA's threads as fibers, warp collectives
// as 32-lane barriers, shared memory as a poisoned arena), and g++ with
// AddressSanitizer and UBSan runs the kernels on the CPU
// (tests/torch_host_harness.py). Under nvcc this header is the device code
// exactly as the kernels held it before.

#pragma once

#ifdef QSIM_HOST
#include <qsim_host_ptx.h>
#else

#include <cuda_runtime.h>
#include <stdint.h>

// A statically sized __shared__ array of a function: QSIM_SHARED(unsigned,
// tab, [32][8]) declares `__shared__ unsigned tab[32][8]`.
#define QSIM_SHARED(type, name, dims) __shared__ type name dims
// The launch's dynamic shared memory as an array of `type`.
#define QSIM_DYNAMIC_SHARED(type, name) extern __shared__ type name[]

namespace qsim {

template <class T>
struct Same {
  using type = T;
};

// Launch `kernel` on `grid` CTAs of `block` threads with `smem` bytes of
// dynamic shared memory on `stream`; returns cudaGetLastError().
template <class... P>
inline cudaError_t launch_kernel(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                                 cudaStream_t stream, typename Same<P>::type... args) {
  kernel<<<grid, block, smem, stream>>>(args...);
  return cudaGetLastError();
}

// The same as one cooperative launch (every CTA resident at once); returns
// cudaLaunchCooperativeKernel's error.
template <class... P>
inline cudaError_t launch_cooperative(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                                      cudaStream_t stream, typename Same<P>::type... args) {
  void* params[] = {&args...};
  return cudaLaunchCooperativeKernel((const void*)kernel, grid, block, params, smem, stream);
}

// cp.async: 16 bytes (cg: through L2 only), 4 bytes (ca) to the shared
// address `s` (as __cvta_generic_to_shared gives it) or to `smem`; the
// copies of a thread are committed in groups and waited for by group.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4_at(unsigned s, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  cp_async4_at((unsigned)__cvta_generic_to_shared(smem), gmem);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 16 bytes from, 8 bytes to the shared address `addr`
__device__ __forceinline__ float4 lds128(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts64(unsigned addr, float x, float y) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(x), "f"(y));
}

// d += a b: a 16 x 8 TF32 fragment (row-major), b 8 x 8 (column-major), d
// 16 x 8 float32. With g = lane / 4 and q = lane % 4: a = (a[g][q],
// a[g + 8][q], a[g][q + 4], a[g + 8][q + 4]), b = (b[q][g], b[q + 4][g]),
// d = (d[g][2q], d[g][2q + 1], d[g + 8][2q], d[g + 8][2q + 1]).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 4 tiles of 32-bit words from shared memory, as ldmatrix's four
// 8 x 8 b16 matrices: lane l gives the row address of tile l / 8, row l % 8,
// and gets word l % 4 of row l / 4 of each tile, the fragment layout of
// mma's and wgmma's TF32 A operand.
__device__ __forceinline__ void ldmatrix4(uint32_t (&d)[4], const float* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "r"(a));
}

// a word of device memory, read with acquire order at GPU scope
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

}  // namespace qsim

#endif  // QSIM_HOST
