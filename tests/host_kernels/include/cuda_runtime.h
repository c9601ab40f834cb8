// The host build's cuda_runtime.h: what the port's kernel sources use of
// CUDA, on the CPU. Qualifiers are empty, vector types carry CUDA's
// alignment (so UBSan reports a misaligned vector access), intrinsics call
// the host runtime (qsim_host.h), and the runtime API answers for a device
// of qsim_host::sms() multiprocessors.

#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <bit>
#include <cstddef>
#include <tuple>
#include <utility>

#include "qsim_host.h"

#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
// a __shared__ declaration goes through QSIM_SHARED / QSIM_DYNAMIC_SHARED
#define __shared__ __shared___is_declared_through_QSIM_SHARED

typedef enum cudaError {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaErrorCooperativeLaunchTooLarge = 720,
} cudaError_t;

enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
typedef struct CUstream_st* cudaStream_t;

struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned x, y, z, w;
};
struct alignas(16) int4 {
  int x, y, z, w;
};

inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return uint4{x, y, z, w};
}

inline int min(int a, int b) { return a < b ? a : b; }
inline unsigned min(unsigned a, unsigned b) { return a < b ? a : b; }

inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline unsigned __float_as_uint(float x) { return std::bit_cast<unsigned>(x); }
inline float __uint_as_float(unsigned x) { return std::bit_cast<float>(x); }
inline float __fmul_rn(float a, float b) { return a * b; }

template <class T>
inline T __ldg(const T* p) {
  return *p;
}
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
template <class T>
inline void __stcs(T* p, T v) {
  *p = v;
}

inline void __syncthreads() { qsim_host::syncthreads(); }
[[noreturn]] inline void __trap() { qsim_host::trap("__trap()"); }
inline long long clock64() { return qsim_host::clock_ns(); }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

template <class T>
inline T __shfl_xor_sync(unsigned mask, T v, int lanemask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles");
  return std::bit_cast<T>(qsim_host::shfl_xor(std::bit_cast<uint32_t>(v), lanemask, mask));
}

inline size_t __cvta_generic_to_shared(const void* p) { return qsim_host::shared_offset(p); }

// ---------------------------------------------------------------------------
// the runtime API
// ---------------------------------------------------------------------------

namespace qsim_host {
inline thread_local cudaError_t last_error = cudaSuccess;
}

inline cudaError_t cudaGetLastError() {
  const cudaError_t e = qsim_host::last_error;
  qsim_host::last_error = cudaSuccess;
  return e;
}

inline const char* cudaGetErrorString(cudaError_t e) {
  switch (e) {
    case cudaSuccess: return "no error";
    case cudaErrorInvalidValue: return "invalid argument";
    case cudaErrorInvalidConfiguration: return "invalid configuration argument";
    case cudaErrorCooperativeLaunchTooLarge: return "too many blocks in cooperative launch";
  }
  return "unknown error";
}

inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}

inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr attr, int dev) {
  if (attr != cudaDevAttrMultiProcessorCount || dev != 0) return cudaErrorInvalidValue;
  *value = qsim_host::sms();
  return cudaSuccess;
}

template <class... P>
cudaError_t cudaFuncSetAttribute(void (*kernel)(P...), cudaFuncAttribute attr, int value) {
  if (attr != cudaFuncAttributeMaxDynamicSharedMemorySize) return cudaErrorInvalidValue;
  return (cudaError_t)qsim_host::set_max_dynamic_shared(reinterpret_cast<const void*>(kernel),
                                                        value);
}

template <class... P>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* ctas, void (*kernel)(P...),
                                                          int threads, size_t smem) {
  *ctas = qsim_host::occupancy(reinterpret_cast<const void*>(kernel), threads, smem);
  return cudaSuccess;
}

inline cudaError_t cudaMemsetAsync(void* p, int value, size_t bytes, cudaStream_t) {
  memset(p, value, bytes);
  return cudaSuccess;
}
