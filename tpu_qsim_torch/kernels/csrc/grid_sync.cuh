// A barrier across the CTAs of one cooperative launch, on a counter in
// device memory: sweep.cu meets at it between the stages of a unit's
// group, segment.cu between two segments of a run.

#pragma once

#include <cuda_runtime.h>

#include "ptx.cuh"  // load_acquire

namespace qsim {

// Barrier of `members` CTAs that are resident at once (a cooperative
// launch). The counter only grows: the k-th barrier waits for k * members
// arrivals. A barrier that has not completed after 2^36 cycles (about
// 40 s) traps, so a fault shows as a failed launch and not as a hung card.
__device__ __forceinline__ void group_sync(unsigned* counter, unsigned members,
                                           unsigned& target) {
  __syncthreads();
  target += members;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    const long long start = clock64();
    while (load_acquire(counter) < target) {
      if (clock64() - start > (1LL << 36)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

}  // namespace qsim
