// The host runtime that runs the port's CUDA kernels on the CPU
// (runtime.cpp): its interface to the kernels' translation units, through
// cuda_runtime.h and qsim_host_ptx.h beside this file.
//
// A launch runs every CTA of the grid. A launch that is not cooperative runs
// its CTAs on at most four OS threads, one CTA after another on each. A
// cooperative launch (the kernels' barriers between CTAs need them resident
// together) gives each CTA an OS thread but runs one CTA at a time: a CTA
// gives way only where its threads all wait and one spins on device memory
// (load_acquire), or where it ends, to the next CTA in block order, the
// order turning back at either end. So after each grid barrier the CTAs go
// on in the reverse of the order they arrived in, and a CTA that writes what
// another reads before the next barrier does so before the read in one of
// the two orders: a missing barrier shows in every run. When every CTA's
// spin has seen the same word twice with nothing run in between, the
// launch is reported as a deadlock naming each CTA's wait. A CTA's threads
// are fibers on its OS thread, switched only where a thread waits: at
// __syncthreads, at a warp collective (__shfl_xor_sync, mma, ldmatrix: a
// 32-lane barrier around an exchange buffer), at a warpgroup collective
// (wgmma and its fence, commit and wait: a 128-lane barrier of four
// consecutive warps), at an mbarrier wait whose phase has not completed
// (the fiber runs again when the last arrival completes it) and in a spin
// on device memory. The fibers start in thread order, each running until
// it waits. An mbarrier lives in a side table of the CTA, keyed by its
// shared address; the arena's 8 bytes there hold a mark that a plain store
// overwrites, so a store over a live barrier traps at its next use. Its shared memory is
// one arena: the launch's dynamic bytes, then each static __shared__ array
// of the kernel, with poisoned bytes (AddressSanitizer) after each region,
// so an access past the launch's dynamic size or past an array is reported.
// Shared memory and the targets of cp.async start filled with NaN bytes: a
// read of bytes never written, or of a cp.async target before its
// cp.async.wait_group, carries NaN into the result. The async proxy (what
// wgmma reads) sees the arena as it was at the CTA's last
// fence.proxy.async.

#pragma once

#include <stddef.h>
#include <stdint.h>

struct uint3 {
  unsigned x, y, z;
};

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};

// the calling thread's indices; the runtime sets them at every switch
extern thread_local uint3 threadIdx;
extern thread_local uint3 blockIdx;
extern thread_local dim3 blockDim;
extern thread_local dim3 gridDim;

namespace qsim_host {

int sms();  // the device's multiprocessors: QSIM_HOST_SMS if set, else 2
constexpr int MAX_THREADS_PER_SM = 2048;
constexpr int MAX_CTAS_PER_SM = 2;            // so a launch sizes 2-4 resident CTAs
constexpr size_t SHARED_PER_CTA = 232448;     // 227 KB, static and dynamic
constexpr size_t DEFAULT_DYNAMIC_SHARED = 49152;

// Run `invoke(ctx)` once for every thread of `grid` CTAs of `block`
// threads; returns a cudaError_t (the launch's checks) after every CTA
// finished.
int launch(const void* kernel, dim3 grid, dim3 block, size_t smem, bool cooperative,
           void (*invoke)(void*), void* ctx);
int set_max_dynamic_shared(const void* kernel, int bytes);
int occupancy(const void* kernel, int threads, size_t smem);

// the current CTA's shared memory
char* dynamic_shared();
char* shared_static(const void* site, size_t bytes, size_t align);
unsigned shared_offset(const void* p);        // __cvta_generic_to_shared
char* shared_at(unsigned addr, size_t bytes, size_t align);

void syncthreads();
uint32_t shfl_xor(uint32_t v, int lanemask, unsigned mask);
void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);
// this lane's 16-byte row in, its four words of the four tiles out
void ldmatrix(uint32_t (&d)[4], const uint32_t (&row)[4]);

// wgmma m64nNk8 (TF32, N = 64 or 128): this lane's A fragment, B's
// shared-memory descriptor, scale-d (0: d is overwritten) and scale-a (+1 or
// -1). `d`, the lane's N / 2 accumulators, holds NaN from issue until the
// wgmma_wait that covers the product's group, and the result from there.
void wgmma(float* d, int n, const uint32_t (&a)[4], uint64_t desc, int scale_d, int scale_a);
void wgmma_fence();
void wgmma_commit();
void wgmma_wait(int groups_in_flight);
void fence_proxy_async();

// cp.async: `bytes` (4 or 16) already read from the source, for the shared
// address `addr`; they land there at the wait that covers their group
void cp_async(unsigned addr, const void* data, unsigned bytes);
void cp_async_commit();
void cp_async_wait(int groups_in_flight);

// mbarriers at shared addresses: init with an arrival count, arrive, and
// wait (the fiber blocks) until the phase of `parity` has completed
void mbar_init(unsigned addr, unsigned count);
void mbar_arrive(unsigned addr);
void mbar_wait(unsigned addr, unsigned parity);

void poll(const void* addr, unsigned value);  // one turn of a spin on *addr, which held value
long long clock_ns();
[[noreturn]] void trap(const char* what);

}  // namespace qsim_host
