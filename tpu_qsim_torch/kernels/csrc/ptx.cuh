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

// d (+)= scale_a a b: the m64n64k8 TF32 product of a warpgroup, a's fragment
// in registers (the warp's 16 rows, as mma's), b from shared memory through
// its descriptor, d the 64 x 64 float32 fragment (columns 8 j + 2 ft (+ 1),
// rows fg (+ 8) in d[4 j + v]); d is overwritten where scale_d is 0.
template <int SCALE_A>
__device__ __forceinline__ void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                      int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(SCALE_A));
}

// The same product at N = 128 (m64n128k8): d the 64 x 128 float32 fragment
// (columns 8 j + 2 ft (+ 1), rows fg (+ 8) in d[4 j + v], j < 16).
template <int SCALE_A>
__device__ __forceinline__ void wgmma128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, %70, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d), "n"(SCALE_A));
}

// Before a warpgroup's wgmma reads or writes registers that it touched
// since its last wait.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
// the warpgroup's wgmma issued since the last commit, as one group
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// This thread's shared-memory writes through the generic proxy, before the
// async proxy (wgmma's operands) reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Registers that an in-flight wgmma reads or writes: keep the compiler's
// own reads and writes of them (and its reuse of them) on their side of the
// wait.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_operands(uint32_t (&f)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(f[i / 4][i % 4])::"memory");
}

// An mbarrier: a 64-bit word in shared memory (8-byte aligned) whose current
// phase completes when `count` arrivals have been made on it, and the next
// phase starts. mbar_wait returns once the phase of the given parity has
// completed: a waiter of phase q passes q & 1 (a fresh barrier is in phase
// 0). An arrival releases, and a wait that returns acquires, the memory of
// the CTA's threads; shared-memory stores that wgmma reads also need a
// fence.proxy.async of the storing thread before its arrival.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(a), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(a) : "memory");
}
// A wait that has not returned after 2^36 cycles (about 40 s) traps, so a
// fault shows as a failed launch and not as a hung card. (try_wait may
// suspend the thread for a while before it answers.)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(bar);
  const long long start = clock64();
  for (;;) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1LL << 36)) __trap();
  }
}

// A performance-monitor event of id ID (0-15): the measurement build's marker
// of where an op class's code starts, found in the SASS as PMTRIG
// (kernels/sass_census.py --classes); no main path builds it.
template <int ID>
__device__ __forceinline__ void pm_marker() {
  asm volatile("pmevent %0;" ::"n"(ID) : "memory");
}

// a word of device memory, read with acquire order at GPU scope
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

}  // namespace qsim

#endif  // QSIM_HOST
