// The host twin of tpu_qsim_torch/kernels/csrc/ptx.cuh: each PTX wrapper
// with the same name and signature, its memory accesses made here (in the
// kernel's translation unit, so AddressSanitizer and UBSan check them) and
// its synchronisation in the host runtime (qsim_host.h).
//
// Where the host is looser than the card it errs toward a report:
//   - a shared address (lds128, sts64, cp.async, ldmatrix) must lie in the
//     CTA's arena and be aligned to its access, else the run traps;
//   - a cp.async reads its source at issue, fills its target with NaN bytes
//     and writes it at the cp.async.wait_group that covers its group: a read
//     before the wait sees NaN;
//   - mma truncates its TF32 inputs (the low 13 mantissa bits dropped) and
//     accumulates in float32; a warp collective with a lane that has exited,
//     or lanes at different collectives, traps;
//   - wgmma (m64n64k8 and m64n128k8, TF32) and its fence, commit and wait are warpgroup
//     collectives: the 128 threads of four consecutive warps, with the warp
//     collective's rules (a lane that has exited, lanes at different
//     collectives or with different descriptors, scales or wait counts
//     trap). The product is computed at issue as mma's is (TF32 inputs
//     truncated, float32 sums in k order; scale-a negates A, scale-d 0
//     drops the accumulators), with A from the lanes' registers in mma's
//     fragment layout (warp w of the warpgroup: rows 16 w to 16 w + 15) and
//     B read through its descriptor: start address, leading (K) and stride
//     (N) byte offsets, K-major 8 x 16-byte core matrices without swizzle;
//     a swizzle mode, a base offset or a reserved bit traps, and every
//     16-byte row must lie in the arena outside its poisoned bytes (the
//     descriptor holds addresses in 16-byte units, so an unaligned base is
//     cut to its 16 bytes before the host sees it, as on the card);
//   - the accumulators of an in-flight wgmma hold NaN from issue to the
//     wgmma.wait_group that covers its group, where the result lands: a read
//     before the wait sees NaN, and a write to them before it traps at the
//     wait. A later wgmma of the same thread on the same accumulator array
//     chains on the pending value, as the card does;
//   - B is read from the CTA's async-proxy view of shared memory: a copy of
//     the arena taken at each fence.proxy.async (of any thread of the CTA,
//     where the card makes only the fencing thread's writes visible), so a
//     store with no fence after it is not seen by the product. B's bytes
//     are read again at the covering wait, and an A fragment's registers
//     too: a store to either while the product is in flight traps;
//   - a wgmma with no wgmma.fence since the thread's last wgmma.wait_group
//     (or the kernel's start) traps, where the card needs the fence only
//     before registers touched since then;
//   - an mbarrier (init, arrive, wait on a phase's parity) must be 8-byte
//     aligned in the arena and initialised before its first arrive or
//     wait, with a count of 1 to 2^20 - 1, else the run traps; a plain
//     store over its word traps at its next use; a wait whose phase never
//     completes is a deadlock, reported with each thread's wait ("mbar").
//     An arrival releases everything the CTA wrote (the card releases the
//     arriving thread's writes), and the fibers start in thread order and
//     run until they wait, so a consumer in lower warps than its producer
//     that skips its wait reads the ring before it is filled, and a
//     producer that skips its wait refills a slot before it is read.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define QSIM_SHARED(type, name, dims)                                                   \
  static const char name##_qsim_site = 0;                                               \
  using name##_qsim_t = type dims;                                                      \
  name##_qsim_t& name = *reinterpret_cast<name##_qsim_t*>(::qsim_host::shared_static(   \
      &name##_qsim_site, sizeof(name##_qsim_t), alignof(name##_qsim_t)))
#define QSIM_DYNAMIC_SHARED(type, name) \
  type* const name = reinterpret_cast<type*>(::qsim_host::dynamic_shared())

namespace qsim {

template <class T>
struct Same {
  using type = T;
};

namespace host_detail {
template <class F>
void invoke(void* f) {
  (*static_cast<F*>(f))();
}

template <class... P>
cudaError_t launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem, bool cooperative,
                   typename Same<P>::type... args) {
  const std::tuple<P...> params(args...);
  auto body = [&]() { std::apply(kernel, params); };
  return (cudaError_t)qsim_host::launch(reinterpret_cast<const void*>(kernel), grid, block, smem,
                                        cooperative, &invoke<decltype(body)>, &body);
}
}  // namespace host_detail

template <class... P>
inline cudaError_t launch_kernel(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                                 cudaStream_t, typename Same<P>::type... args) {
  return host_detail::launch(kernel, grid, block, smem, false, args...);
}

template <class... P>
inline cudaError_t launch_cooperative(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem,
                                      cudaStream_t, typename Same<P>::type... args) {
  return host_detail::launch(kernel, grid, block, smem, true, args...);
}

inline void cp_async4_at(unsigned s, const void* gmem) {
  if (reinterpret_cast<uintptr_t>(gmem) % 4) qsim_host::trap("cp.async of 4 bytes: source not 4-byte aligned");
  const uint32_t v = *static_cast<const uint32_t*>(gmem);
  memset(qsim_host::shared_at(s, 4, 4), 0xff, 4);
  qsim_host::cp_async(s, &v, 4);
}
inline void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (reinterpret_cast<uintptr_t>(gmem) % 16) qsim_host::trap("cp.async of 16 bytes: source not 16-byte aligned");
  const uint4 v = *static_cast<const uint4*>(gmem);
  memset(qsim_host::shared_at(s, 16, 16), 0xff, 16);
  qsim_host::cp_async(s, &v, 16);
}
inline void cp_async4(void* smem, const void* gmem) {
  cp_async4_at((unsigned)__cvta_generic_to_shared(smem), gmem);
}
inline void cp_async_commit() { qsim_host::cp_async_commit(); }
template <int N>
inline void cp_async_wait() {
  qsim_host::cp_async_wait(N);
}

inline float4 lds128(unsigned addr) {
  return *reinterpret_cast<const float4*>(qsim_host::shared_at(addr, 16, 16));
}
inline void sts64(unsigned addr, float x, float y) {
  *reinterpret_cast<float2*>(qsim_host::shared_at(addr, 8, 8)) = make_float2(x, y);
}

inline void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  qsim_host::mma(d, a, b0, b1);
}

inline void ldmatrix4(uint32_t (&d)[4], const float* row) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(row);
  const uint4 v = *reinterpret_cast<const uint4*>(qsim_host::shared_at(a, 16, 16));
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
  qsim_host::ldmatrix(d, words);
}

template <int SCALE_A>
inline void wgmma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  static_assert(SCALE_A == 1 || SCALE_A == -1, "scale-a is +1 or -1");
  qsim_host::wgmma(d, 64, a, desc, scale_d, SCALE_A);
}
template <int SCALE_A>
inline void wgmma128(float (&d)[64], const uint32_t (&a)[4], uint64_t desc, int scale_d) {
  static_assert(SCALE_A == 1 || SCALE_A == -1, "scale-a is +1 or -1");
  qsim_host::wgmma(d, 128, a, desc, scale_d, SCALE_A);
}
inline void wgmma_fence() { qsim_host::wgmma_fence(); }
inline void wgmma_commit() { qsim_host::wgmma_commit(); }
template <int N>
inline void wgmma_wait() {
  qsim_host::wgmma_wait(N);
}
inline void fence_proxy_async() { qsim_host::fence_proxy_async(); }
// compiler barriers on the card
inline void fence_operands(float (&)[32]) {}
inline void fence_operands(float (&)[64]) {}
inline void fence_operands(uint32_t (&)[4][4]) {}

inline void mbar_init(uint64_t* bar, unsigned count) {
  qsim_host::mbar_init((unsigned)__cvta_generic_to_shared(bar), count);
}
inline void mbar_arrive(uint64_t* bar) { qsim_host::mbar_arrive((unsigned)__cvta_generic_to_shared(bar)); }
// blocks (a wait that never completes is a deadlock, not a spin)
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  qsim_host::mbar_wait((unsigned)__cvta_generic_to_shared(bar), parity);
}

// a measurement build's SASS marker: nothing on the host
template <int ID>
inline void pm_marker() {}

inline unsigned load_acquire(const unsigned* p) {
  const unsigned v = __atomic_load_n(p, __ATOMIC_ACQUIRE);
  qsim_host::poll(p, v);
  return v;
}

}  // namespace qsim
