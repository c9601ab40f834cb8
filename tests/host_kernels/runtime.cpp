// The host runtime of the port's kernels (qsim_host.h): launches, CTAs of
// fibers, barriers, warp collectives, shared-memory arenas and cp.async.

#include <pthread.h>
#include <sanitizer/asan_interface.h>
#include <sanitizer/common_interface_defs.h>
#include <sched.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>

#include <chrono>
#include <mutex>
#include <thread>
#include <unordered_map>
#include <vector>

#include "qsim_host.h"

thread_local uint3 threadIdx;
thread_local uint3 blockIdx;
thread_local dim3 blockDim;
thread_local dim3 gridDim;

// Switch stacks: save the callee-saved registers, the x87 control word and
// MXCSR on the current stack, store its pointer at *save, load `load` and
// restore the same from there. A new fiber's stack is laid out so that the
// first switch to it returns into qsim_host_fiber_start with the fiber in
// r12.
extern "C" void qsim_host_swap(void** save, void* load);
extern "C" void qsim_host_fiber_start();
asm(R"(
  .text
  .globl qsim_host_swap
  .type qsim_host_swap, @function
qsim_host_swap:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $16, %rsp
  stmxcsr 8(%rsp)
  fnstcw (%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  fldcw (%rsp)
  ldmxcsr 8(%rsp)
  addq $16, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size qsim_host_swap, .-qsim_host_swap

  .globl qsim_host_fiber_start
  .type qsim_host_fiber_start, @function
qsim_host_fiber_start:
  movq %r12, %rdi
  call qsim_host_fiber_main
  ud2
  .size qsim_host_fiber_start, .-qsim_host_fiber_start
  .section .note.GNU-stack,"",@progbits
  .text
)");

namespace qsim_host {
namespace {

constexpr size_t STACK_BYTES = 64 << 10;
constexpr size_t GUARD_BYTES = 4096;
constexpr size_t REDZONE = 64;               // poisoned bytes after each shared region
constexpr size_t STATIC_ROOM = 64 << 10;     // the arena's room for static arrays
constexpr int MAX_WORKERS = 4;               // OS threads of a launch that is not cooperative

enum class Wait { NONE, BARRIER, WARP };
enum class Collective { NONE, SHFL, MMA, LDMATRIX };

struct Copy {
  unsigned addr, bytes, group;
  uint32_t data[4];
};

struct Cta;

struct Fiber {
  void* sp = nullptr;
  char* stack = nullptr;
  unsigned tid = 0;
  bool done = false;
  Wait wait = Wait::NONE;
  void* fake_stack = nullptr;
  Cta* cta = nullptr;
  std::vector<Copy> copies;                  // cp.async in flight
  unsigned committed = 0;                    // groups committed
};

struct Slot {
  uint32_t in[10];
  uint32_t out[4];
  int param;
};

struct Warp {
  Collective kind = Collective::NONE;
  unsigned arrived = 0;
  unsigned exited = 0;
  Fiber* waiting[32];
  Slot slot[32];
};

// An OS thread's fiber stacks, reused from CTA to CTA.
struct StackPool {
  char* base = nullptr;
  size_t count = 0;
  char* get(size_t n) {
    if (n > count) {
      release();
      const size_t bytes = n * (STACK_BYTES + GUARD_BYTES);
      void* p = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
      if (p == MAP_FAILED) trap("cannot map fiber stacks");
      base = static_cast<char*>(p);
      count = n;
      for (size_t i = 0; i < n; ++i) mprotect(base + i * (STACK_BYTES + GUARD_BYTES), GUARD_BYTES, PROT_NONE);
    }
    return base;
  }
  char* stack(size_t i) const { return base + i * (STACK_BYTES + GUARD_BYTES) + GUARD_BYTES; }
  void clean(size_t n) const {
    for (size_t i = 0; i < n; ++i) __asan_unpoison_memory_region(stack(i), STACK_BYTES);
  }
  void release() {
    if (base) {
      clean(count);
      munmap(base, count * (STACK_BYTES + GUARD_BYTES));
    }
    base = nullptr;
    count = 0;
  }
  ~StackPool() { release(); }
};

thread_local StackPool stack_pool;

struct Cta {
  void (*invoke)(void*) = nullptr;
  void* ctx = nullptr;
  unsigned threads = 0;
  std::vector<Fiber> fibers;
  std::vector<Fiber*> ready;                 // a ring of runnable fibers
  size_t head = 0, count = 0;
  Fiber* current = nullptr;
  void* sched_sp = nullptr;
  const void* sched_bottom = nullptr;
  size_t sched_size = 0;
  void* sched_fake = nullptr;
  unsigned live = 0;
  unsigned bar_arrived = 0;
  bool reverse = false;                      // the order of the last barrier's release
  std::vector<Warp> warps;
  char* arena = nullptr;
  size_t arena_bytes = 0, dyn_bytes = 0, static_bytes = 0, used = 0;
  std::vector<std::pair<const void*, char*>> statics;

  void push(Fiber* f) {
    ready[(head + count) % ready.size()] = f;
    ++count;
  }
  Fiber* pop() {
    if (!count) return nullptr;
    Fiber* f = ready[head];
    head = (head + 1) % ready.size();
    --count;
    return f;
  }
};

thread_local Cta* current_cta = nullptr;

Cta& cta() {
  if (!current_cta) trap("a device intrinsic called outside a kernel");
  return *current_cta;
}

Fiber& self() { return *cta().current; }

void enter(Fiber* f) {
  current_cta->current = f;
  threadIdx = uint3{f->tid, 0, 0};
}

// From the running fiber (or the scheduler, from == nullptr) to fiber `to`
// (or the scheduler, to == nullptr); `dying`: the running fiber never runs
// again. Returns when something switches back.
void jump(Fiber* from, Fiber* to, bool dying = false) {
  Cta& c = *current_cta;
  void** save = from ? &from->sp : &c.sched_sp;
  void** fake = dying ? nullptr : from ? &from->fake_stack : &c.sched_fake;
  if (to) {
    __sanitizer_start_switch_fiber(fake, to->stack, STACK_BYTES);
    enter(to);
    qsim_host_swap(save, to->sp);
  } else {
    __sanitizer_start_switch_fiber(fake, c.sched_bottom, c.sched_size);
    c.current = nullptr;
    qsim_host_swap(save, c.sched_sp);
  }
  __sanitizer_finish_switch_fiber(from ? from->fake_stack : c.sched_fake, nullptr, nullptr);
  if (from) enter(from);
}

// The running fiber waits: the next runnable fiber runs, or the scheduler.
void block(Wait why) {
  Cta& c = cta();
  Fiber* me = c.current;
  me->wait = why;
  jump(me, c.pop());
}

void release(Fiber* f) {
  f->wait = Wait::NONE;
  current_cta->push(f);
}

void land_copies(Fiber& f, unsigned keep_groups) {
  Cta& c = *f.cta;
  size_t kept = 0;
  for (Copy& cp : f.copies) {
    if (cp.group + keep_groups < f.committed) memcpy(c.arena + cp.addr, cp.data, cp.bytes);
    else f.copies[kept++] = cp;
  }
  f.copies.resize(kept);
}

// The threads waiting at __syncthreads go on, in thread order after one
// barrier and in reverse order after the next: a thread that reads what
// another writes before the next barrier, on either side of it in thread
// order, reads it before the write in one of the two.
void release_barrier(Cta& c) {
  c.bar_arrived = 0;
  c.reverse = !c.reverse;
  for (unsigned i = 0; i < c.threads; ++i) {
    Fiber& f = c.fibers[c.reverse ? c.threads - 1 - i : i];
    if (f.wait == Wait::BARRIER) release(&f);
  }
}

[[noreturn]] void deadlock(Cta& c) {
  fprintf(stderr, "qsim_host: deadlock in CTA %u:", blockIdx.x);
  for (Fiber& f : c.fibers)
    if (!f.done)
      fprintf(stderr, " t%u:%s", f.tid, f.wait == Wait::BARRIER ? "bar" : f.wait == Wait::WARP ? "warp" : "run");
  fprintf(stderr, "\n");
  abort();
}

std::mutex attr_mutex;
std::unordered_map<const void*, int> max_dynamic;

size_t dynamic_limit(const void* kernel) {
  std::lock_guard<std::mutex> lock(attr_mutex);
  auto it = max_dynamic.find(kernel);
  return it == max_dynamic.end() ? DEFAULT_DYNAMIC_SHARED : (size_t)it->second;
}

void run_cta(void (*invoke)(void*), void* ctx, unsigned block, unsigned threads, size_t smem) {
  Cta c;
  c.invoke = invoke;
  c.ctx = ctx;
  c.threads = threads;
  blockIdx = uint3{block, 0, 0};
  // the arena: the dynamic bytes, then room for static arrays; all NaN
  // bytes, everything past the dynamic bytes poisoned until handed out
  c.dyn_bytes = smem;
  c.used = (smem + REDZONE + 127) & ~(size_t)127;
  c.arena_bytes = c.used + STATIC_ROOM;
  void* mem = nullptr;
  if (posix_memalign(&mem, 128, c.arena_bytes)) trap("cannot allocate shared memory");
  c.arena = static_cast<char*>(mem);
  memset(c.arena, 0xff, c.arena_bytes);
  __asan_poison_memory_region(c.arena + smem, c.arena_bytes - smem);

  c.fibers.resize(threads);
  c.ready.assign(threads, nullptr);
  c.warps.resize((threads + 31) / 32);
  if (threads % 32) c.warps.back().exited = 32 - threads % 32;  // lanes that do not exist
  stack_pool.get(threads);
  for (unsigned t = 0; t < threads; ++t) {
    Fiber& f = c.fibers[t];
    f.tid = t;
    f.cta = &c;
    f.stack = stack_pool.stack(t);
    // the first switch to the fiber pops these and returns into
    // qsim_host_fiber_start (qsim_host_swap's frame, 16-byte aligned after
    // the return)
    uint64_t* sp = reinterpret_cast<uint64_t*>(f.stack + STACK_BYTES - 88);
    sp[0] = 0x037f;                          // x87 control word
    sp[1] = 0x1f80;                          // MXCSR
    sp[2] = sp[3] = sp[4] = 0;               // r15, r14, r13
    sp[5] = reinterpret_cast<uint64_t>(&f);  // r12
    sp[6] = sp[7] = 0;                       // rbx, rbp
    sp[8] = reinterpret_cast<uint64_t>(&qsim_host_fiber_start);
    f.sp = sp;
    c.push(&f);
  }
  c.live = threads;
  current_cta = &c;
  while (c.live) {
    Fiber* f = c.pop();
    if (!f) deadlock(c);
    jump(nullptr, f);
  }
  current_cta = nullptr;
  stack_pool.clean(threads);
  __asan_unpoison_memory_region(c.arena, c.arena_bytes);
  free(c.arena);
}

}  // namespace

int set_max_dynamic_shared(const void* kernel, int bytes) {
  if (bytes < 0 || (size_t)bytes > SHARED_PER_CTA) return 1;  // cudaErrorInvalidValue
  std::lock_guard<std::mutex> lock(attr_mutex);
  max_dynamic[kernel] = bytes;
  return 0;
}

int occupancy(const void* kernel, int threads, size_t smem) {
  if (threads < 1 || threads > 1024 || smem > dynamic_limit(kernel)) return 0;
  int ctas = MAX_THREADS_PER_SM / threads;
  const size_t per_cta = smem + 1024;        // the card reserves 1 KB a CTA
  const int by_shared = (int)((SHARED_PER_CTA + 1024) / per_cta);
  if (by_shared < ctas) ctas = by_shared;
  return ctas < MAX_CTAS_PER_SM ? ctas : MAX_CTAS_PER_SM;
}

int launch(const void* kernel, dim3 grid, dim3 block, size_t smem, bool cooperative,
           void (*invoke)(void*), void* ctx) {
  if (grid.y != 1 || grid.z != 1 || block.y != 1 || block.z != 1 || grid.x < 1 || block.x < 1 ||
      block.x > 1024)
    return 9;                                // cudaErrorInvalidConfiguration
  if (smem > dynamic_limit(kernel)) return 1;  // cudaErrorInvalidValue
  if (cooperative && grid.x > (unsigned)(occupancy(kernel, block.x, smem) * SMS)) return 720;
  const unsigned workers = cooperative ? grid.x : grid.x < MAX_WORKERS ? grid.x : MAX_WORKERS;
  auto work = [&](unsigned first) {
    blockDim = block;
    gridDim = grid;
    for (unsigned b = first; b < grid.x; b += workers) run_cta(invoke, ctx, b, block.x, smem);
  };
  std::vector<std::thread> pool;
  for (unsigned w = 0; w < workers; ++w) pool.emplace_back(work, w);
  for (std::thread& t : pool) t.join();
  return 0;
}

char* dynamic_shared() { return cta().arena; }

char* shared_static(const void* site, size_t bytes, size_t align) {
  Cta& c = cta();
  for (auto& [s, p] : c.statics)
    if (s == site) return p;
  const size_t off = (c.used + align - 1) & ~(align - 1);
  if (off + bytes + REDZONE > c.arena_bytes) trap("static shared arrays past the arena's room");
  c.static_bytes += bytes;
  if (c.dyn_bytes + c.static_bytes > SHARED_PER_CTA)
    trap("static and dynamic shared memory past the card's 227 KB a CTA");
  char* p = c.arena + off;
  __asan_unpoison_memory_region(p, bytes);
  c.used = off + bytes + REDZONE;
  c.statics.emplace_back(site, p);
  return p;
}

unsigned shared_offset(const void* p) {
  Cta& c = cta();
  const char* q = static_cast<const char*>(p);
  if (q < c.arena || q > c.arena + c.arena_bytes) trap("__cvta_generic_to_shared of an address outside shared memory");
  return (unsigned)(q - c.arena);
}

char* shared_at(unsigned addr, size_t bytes, size_t align) {
  Cta& c = cta();
  if (addr % align) trap("a shared-memory access not aligned to its size");
  if ((size_t)addr + bytes > c.arena_bytes) trap("a shared-memory address past the CTA's shared memory");
  return c.arena + addr;
}

void syncthreads() {
  Cta& c = cta();
  Fiber* me = c.current;
  me->wait = Wait::BARRIER;
  if (++c.bar_arrived < c.live) {
    block(Wait::BARRIER);
    return;
  }
  release_barrier(c);  // the last to arrive goes on in its turn, with the others
  Fiber* next = c.pop();
  if (next != me) jump(me, next);
}

namespace {

// Arrive at a warp collective with this lane's words; the last lane to
// arrive computes every lane's result (`finish`) and the others resume.
template <class Finish>
const uint32_t* collective(Collective kind, const uint32_t* in, int n, int param, Finish finish) {
  Cta& c = cta();
  Fiber& me = *c.current;
  Warp& w = c.warps[me.tid >> 5];
  const unsigned lane = me.tid & 31u;
  if (w.exited) trap("a warp collective in a warp with a lane that has exited");
  if (w.arrived == 0) w.kind = kind;
  else if (w.kind != kind) trap("lanes of one warp at different warp collectives");
  memcpy(w.slot[lane].in, in, n * sizeof(uint32_t));
  w.slot[lane].param = param;
  w.waiting[lane] = &me;
  if (++w.arrived == 32) {
    finish(w.slot);
    w.arrived = 0;
    w.kind = Collective::NONE;
    for (unsigned l = 0; l < 32; ++l)
      if (l != lane) release(w.waiting[l]);
  } else {
    block(Wait::WARP);
  }
  return w.slot[lane].out;
}

inline float tf32(uint32_t x) {
  uint32_t t = x & 0xffffe000u;
  float f;
  memcpy(&f, &t, 4);
  return f;
}

}  // namespace

uint32_t shfl_xor(uint32_t v, int lanemask, unsigned mask) {
  if (mask != 0xffffffffu) trap("__shfl_xor_sync with a partial mask");
  return collective(Collective::SHFL, &v, 1, lanemask, [](Slot* s) {
    for (int l = 0; l < 32; ++l) s[l].out[0] = s[(l ^ s[l].param) & 31].in[0];
  })[0];
}

namespace {

// Each lane's D = C + A B from the 32 lanes' fragments (ptx.cuh's layout),
// TF32 inputs, products summed in float32.
void mma_product(Slot* s) {
  float A[16][8], B[8][8], C[16][8];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, q = l & 3;
    const uint32_t* x = s[l].in;
    A[g][q] = tf32(x[0]);
    A[g + 8][q] = tf32(x[1]);
    A[g][q + 4] = tf32(x[2]);
    A[g + 8][q + 4] = tf32(x[3]);
    B[q][g] = tf32(x[4]);
    B[q + 4][g] = tf32(x[5]);
    memcpy(&C[g][2 * q], &x[6], 8);
    memcpy(&C[g + 8][2 * q], &x[8], 8);
  }
  for (int i = 0; i < 16; ++i)     // each element summed over k in turn
    for (int k = 0; k < 8; ++k)
      for (int j = 0; j < 8; ++j) C[i][j] += A[i][k] * B[k][j];
  for (int l = 0; l < 32; ++l) {
    const int g = l >> 2, q = l & 3;
    memcpy(&s[l].out[0], &C[g][2 * q], 8);
    memcpy(&s[l].out[2], &C[g + 8][2 * q], 8);
  }
}

}  // namespace

void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  uint32_t in[10] = {a[0], a[1], a[2], a[3], b0, b1};
  memcpy(&in[6], d, 16);
  memcpy(d, collective(Collective::MMA, in, 10, 0, mma_product), 16);
}

void ldmatrix(uint32_t (&d)[4], const uint32_t (&row)[4]) {
  const uint32_t* out = collective(Collective::LDMATRIX, row, 4, 0, [](Slot* s) {
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < 4; ++i) s[l].out[i] = s[8 * i + (l >> 2)].in[l & 3];
  });
  memcpy(d, out, 16);
}

void cp_async(unsigned addr, const void* data, unsigned bytes) {
  Fiber& f = self();
  Copy cp{addr, bytes, f.committed, {0, 0, 0, 0}};
  memcpy(cp.data, data, bytes);
  f.copies.push_back(cp);
}

void cp_async_commit() { ++self().committed; }

void cp_async_wait(int groups_in_flight) { land_copies(self(), (unsigned)groups_in_flight); }

void poll() {
  Cta& c = cta();
  if (!c.count) {
    sched_yield();
    return;
  }
  Fiber* me = c.current;
  c.push(me);
  jump(me, c.pop());
}

long long clock_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

void trap(const char* what) {
  if (current_cta && current_cta->current)
    fprintf(stderr, "qsim_host: trap in CTA %u thread %u: %s\n", blockIdx.x, threadIdx.x, what);
  else
    fprintf(stderr, "qsim_host: trap: %s\n", what);
  fflush(stderr);
  abort();
}

}  // namespace qsim_host

// A fiber's life: its thread of the kernel, its cp.async copies landed (the
// card completes them at exit), then out for good.
extern "C" [[noreturn]] void qsim_host_fiber_main(qsim_host::Fiber* f) {
  using namespace qsim_host;
  Cta& c = *f->cta;
  const void* bottom = nullptr;
  size_t size = 0;
  __sanitizer_finish_switch_fiber(nullptr, &bottom, &size);
  if (!c.sched_bottom) {  // the first fiber is started by the scheduler
    c.sched_bottom = bottom;
    c.sched_size = size;
  }
  enter(f);
  c.invoke(c.ctx);
  ++f->committed;
  land_copies(*f, 0);
  f->done = true;
  --c.live;
  ++c.warps[f->tid >> 5].exited;
  if (c.warps[f->tid >> 5].arrived) trap("a lane exited while its warp waits at a collective");
  if (c.bar_arrived && c.bar_arrived == c.live) release_barrier(c);
  jump(f, c.pop(), true);
  __builtin_unreachable();
}
