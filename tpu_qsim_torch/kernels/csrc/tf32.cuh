// 3xTF32 on the tensor cores: float32-accurate products from TF32 mma.sync,
// shared by dense_pass.cu and ops.cuh's tiled op.
//
// TF32 keeps 10 mantissa bits, which alone misses the port's 1e-6 gate. So
// every float32 operand is split in registers into a TF32 high part (rounded
// to nearest, as cvt.rna.tf32.f32 does, in two integer operations) and the
// float32 remainder, whose bits past TF32's the tensor cores drop, and each
// real product a b is taken as al bh + ah bl + ah bh, small terms first: the
// lo.lo term and what the low part drops are below 2^-21 of the product.
//
// The tensor cores add into their accumulator with truncation: one 4096-term
// sum in a single accumulator drifted 1-2e-7 past float32 FMAs on the H100.
// So a long reduction runs in chunks, each chunk's share in fresh
// accumulators that start at zero, and the share is added to the run's
// float32 accumulator (rounded to nearest) after its chunk (add_share).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"  // mma

namespace qsim {

constexpr uint32_t SIGN_BIT = 0x80000000u;

// x as a TF32 high part (10 mantissa bits, rounded to nearest with ties
// away from zero, as cvt.rna.tf32.f32; the low 13 bits cleared) and the
// float32 remainder x - hi, exact, which the tensor cores read as TF32 by
// dropping its low 13 bits. split(-x) is (-hi, -lo): the sign bit is left
// alone.
__device__ __forceinline__ void split(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// A chunk's share (fresh accumulators) into the run's accumulators: float
// arrays of one shape (float[N], float[M][N][4], ...); with two pairs (the
// real and the imaginary part's), element by element in turn.
template <class A>
__device__ __forceinline__ void add_share(A& acc, const A& share) {
  float* a = reinterpret_cast<float*>(&acc);
  const float* s = reinterpret_cast<const float*>(&share);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(A) / sizeof(float)); ++i) a[i] += s[i];
}
template <class A>
__device__ __forceinline__ void add_share(A& acc0, const A& share0, A& acc1, const A& share1) {
  float* a0 = reinterpret_cast<float*>(&acc0);
  float* a1 = reinterpret_cast<float*>(&acc1);
  const float* s0 = reinterpret_cast<const float*>(&share0);
  const float* s1 = reinterpret_cast<const float*>(&share1);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(A) / sizeof(float)); ++i) {
    a0[i] += s0[i];
    a1[i] += s1[i];
  }
}

}  // namespace qsim
