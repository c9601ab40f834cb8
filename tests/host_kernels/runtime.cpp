// The host runtime of the port's kernels (qsim_host.h): launches, CTAs of
// fibers, barriers, warp and warpgroup collectives, shared-memory arenas,
// cp.async, wgmma and mbarriers.

#include <pthread.h>
#include <sanitizer/asan_interface.h>
#include <sanitizer/common_interface_defs.h>
#include <sched.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>

#include <chrono>
#include <condition_variable>
#include <mutex>
#include <string>
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

enum class Wait { NONE, BARRIER, WARP, WARPGROUP, SPIN, MBAR };
enum class Collective { NONE, SHFL, MMA, LDMATRIX, WGMMA, WGMMA_FENCE, WGMMA_COMMIT, WGMMA_WAIT };

struct Copy {
  unsigned addr, bytes, group;
  uint32_t data[4];
};

constexpr uint32_t IN_FLIGHT = 0xffffffffu;  // an in-flight wgmma's accumulators (NaN)
constexpr int MAX_N = 128;                   // the widest wgmma modelled (m64n128k8)
constexpr int MAX_ACC = MAX_N / 2;           // a lane's accumulators
constexpr uint64_t MBAR_MARK = 0x5242414d48534f51ull;  // an mbarrier's word in the arena

// An accumulator array of a thread's in-flight wgmma, and the value that
// lands in it at the wait covering `group`.
struct Accumulator {
  float* d;
  unsigned group;
  int count;
  float value[MAX_ACC];
};

struct Fiber;

// An mbarrier: its arrival count, the arrivals its phase still waits for,
// the phases completed, and the fibers waiting for the current one.
struct MBarrier {
  unsigned count = 0, pending = 0, phase = 0;
  std::vector<Fiber*> waiters;
};

// An A fragment a thread's in-flight wgmma read, as it read it.
struct Fragment {
  const uint32_t* a;
  unsigned group;
  uint32_t value[4];
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
  std::vector<Accumulator> accumulators;     // of wgmma in flight
  std::vector<Fragment> fragments;
  bool wgmma_fenced = false;                 // a wgmma.fence since the last wgmma.wait_group
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

// a lane's words at a warpgroup collective
struct GroupSlot {
  uint32_t a[4];
  float c[MAX_ACC];
  uint64_t desc;
  int scale_d, scale_a, param;
  float out[MAX_ACC];
};

// B of an in-flight wgmma: the shared address of each of its 16-byte rows
// (2 N of them), and the bytes the arena held there at issue
struct Operand {
  unsigned group, count;
  unsigned rows[2 * MAX_N];
  uint32_t words[2 * MAX_N][4];
};

struct WarpGroup {
  Collective kind = Collective::NONE;
  unsigned arrived = 0;
  unsigned warp_arrived[4] = {};
  unsigned committed = 0;                    // wgmma groups committed
  std::vector<Operand> operands;             // B of the wgmma in flight
  Fiber* waiting[128];
  GroupSlot slot[128];
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
  std::vector<WarpGroup> warpgroups;         // made at the first warpgroup collective
  char* arena = nullptr;
  size_t arena_bytes = 0, dyn_bytes = 0, static_bytes = 0, used = 0;
  std::vector<std::pair<const void*, char*>> statics;
  std::vector<std::pair<size_t, size_t>> regions;  // (offset, bytes) of the dynamic bytes and each static array
  std::vector<char> async_view;              // the arena at the last fence.proxy.async
  std::unordered_map<unsigned, MBarrier> mbarriers;  // by shared address
  // a cooperative launch: the word and value of the CTA's last spin that gave way
  const void* spin_addr = nullptr;
  unsigned spin_value = 0;
  bool spun = false;

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

const char* wait_name(Wait w) {
  switch (w) {
    case Wait::BARRIER: return "bar";
    case Wait::WARP: return "warp";
    case Wait::WARPGROUP: return "wgrp";
    case Wait::SPIN: return "spin";
    case Wait::MBAR: return "mbar";
    case Wait::NONE: break;
  }
  return "run";
}

// Each live thread's wait, threads in a row with the same wait joined:
// " t0:spin t1-255:bar".
std::string waits(const Cta& c) {
  std::string out;
  for (unsigned t = 0; t < c.threads;) {
    const Fiber& f = c.fibers[t];
    unsigned e = t + 1;
    if (!f.done) {
      while (e < c.threads && !c.fibers[e].done && c.fibers[e].wait == f.wait) ++e;
      char buf[64];
      if (e - t == 1) snprintf(buf, sizeof buf, " t%u:%s", t, wait_name(f.wait));
      else snprintf(buf, sizeof buf, " t%u-%u:%s", t, e - 1, wait_name(f.wait));
      out += buf;
    }
    t = e;
  }
  return out;
}

[[noreturn]] void deadlock(Cta& c) {
  fprintf(stderr, "qsim_host: deadlock in CTA %u:%s\n", blockIdx.x, waits(c).c_str());
  abort();
}

// A cooperative launch's turn: the one CTA that runs. It passes from a CTA
// that gives way to the next live CTA in block order, the direction turning
// at either end (0 1 2 3 2 1 0 1 ...).
struct Baton {
  std::mutex m;
  std::condition_variable cv;
  std::vector<Cta*> ctas;                    // each running CTA, for a deadlock's report
  std::vector<char> done;
  unsigned turn = 0;
  int step = 1;
  unsigned live = 0;
  unsigned stuck = 0;                        // turns given up in a row by spins that saw nothing new

  unsigned next(unsigned from) {
    const long n = (long)done.size();
    for (int pass = 0; pass < 2; ++pass) {
      for (long b = (long)from + step; b >= 0 && b < n; b += step)
        if (!done[b]) return (unsigned)b;
      step = -step;
    }
    return from;                             // the only live CTA
  }
  void wait_turn(std::unique_lock<std::mutex>& lock, unsigned b) {
    cv.wait(lock, [&] { return turn == b; });
  }
  void pass(unsigned from) {
    turn = next(from);
    cv.notify_all();
  }
};

thread_local Baton* baton = nullptr;         // the cooperative launch of this OS thread's CTA

// Every live CTA of the launch spins on a word that no CTA can change.
[[noreturn]] void grid_deadlock(Baton& bt) {
  fprintf(stderr, "qsim_host: deadlock in a cooperative launch of %zu CTAs:", bt.ctas.size());
  for (size_t b = 0; b < bt.ctas.size(); ++b) {
    const Cta* c = bt.ctas[b];
    if (bt.done[b] || !c) {
      fprintf(stderr, " CTA %zu: ended;", b);
      continue;
    }
    fprintf(stderr, " CTA %zu (word %p = %u):%s;", b, c->spin_addr, c->spin_value,
            waits(*c).c_str());
  }
  fprintf(stderr, "\n");
  fflush(stderr);
  abort();
}

// The running CTA of a cooperative launch waits on *addr (which held
// `value`) with no other thread of it able to run: the turn passes on, and
// this returns when it comes back.
void give_way(Cta& c, const void* addr, unsigned value) {
  Baton& bt = *baton;
  std::unique_lock<std::mutex> lock(bt.m);
  const bool stuck = c.spun && c.spin_addr == addr && c.spin_value == value;
  c.spun = true;
  c.spin_addr = addr;
  c.spin_value = value;
  bt.stuck = stuck ? bt.stuck + 1 : 0;
  Fiber* me = c.current;
  me->wait = Wait::SPIN;
  if (bt.stuck >= 2 * bt.live) grid_deadlock(bt);
  bt.pass(blockIdx.x);
  bt.wait_turn(lock, blockIdx.x);
  me->wait = Wait::NONE;
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
  c.regions.emplace_back(0, smem);
  current_cta = &c;
  if (baton) baton->ctas[block] = &c;
  while (c.live) {
    Fiber* f = c.pop();
    if (!f) deadlock(c);
    jump(nullptr, f);
  }
  if (baton) baton->ctas[block] = nullptr;
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

int sms() {
  static const int n = [] {
    const char* s = getenv("QSIM_HOST_SMS");
    const int v = s ? atoi(s) : 0;
    return v > 0 ? v : 2;
  }();
  return n;
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
  if (cooperative && grid.x > (unsigned)(occupancy(kernel, block.x, smem) * sms())) return 720;
  const unsigned workers = cooperative ? grid.x : grid.x < MAX_WORKERS ? grid.x : MAX_WORKERS;
  Baton bt;
  bt.ctas.assign(grid.x, nullptr);
  bt.done.assign(grid.x, 0);
  bt.live = grid.x;
  auto work = [&](unsigned first) {
    blockDim = block;
    gridDim = grid;
    if (cooperative) {                       // CTA `first`, in its turns
      baton = &bt;
      {
        std::unique_lock<std::mutex> lock(bt.m);
        bt.wait_turn(lock, first);
      }
      run_cta(invoke, ctx, first, block.x, smem);
      std::lock_guard<std::mutex> lock(bt.m);
      bt.done[first] = 1;
      --bt.live;
      bt.stuck = 0;
      bt.pass(first);
      baton = nullptr;
      return;
    }
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
  c.regions.emplace_back(off, bytes);
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
  if ((me.tid >> 7) < c.warpgroups.size() && c.warpgroups[me.tid >> 7].warp_arrived[(me.tid >> 5) & 3])
    trap("lanes of one warp at different collectives (a warp and a warpgroup collective)");
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

namespace {

// Arrive at a warpgroup collective (the 128 threads of four consecutive
// warps) with this lane's words; the last lane to arrive runs `finish` on
// the warpgroup and the others resume.
template <class Finish>
GroupSlot& group_collective(Collective kind, const GroupSlot& in, Finish finish) {
  Cta& c = cta();
  Fiber& me = *c.current;
  const unsigned wg = me.tid >> 7, lane = me.tid & 127u;
  if (4 * wg + 3 >= c.warps.size()) trap("a warpgroup collective in a warpgroup of fewer than four warps");
  for (unsigned w = 4 * wg; w < 4 * wg + 4; ++w)
    if (c.warps[w].exited) trap("a warpgroup collective in a warpgroup with a lane that has exited");
  if (c.warps[me.tid >> 5].arrived)
    trap("lanes of one warp at different collectives (a warp and a warpgroup collective)");
  if (c.warpgroups.empty()) c.warpgroups.resize(c.warps.size() / 4);
  WarpGroup& g = c.warpgroups[wg];
  if (g.arrived == 0) g.kind = kind;
  else if (g.kind != kind) trap("lanes of one warpgroup at different warpgroup collectives");
  g.slot[lane] = in;
  g.waiting[lane] = &me;
  ++g.warp_arrived[(me.tid >> 5) & 3];
  if (++g.arrived == 128) {
    finish(g);
    g.arrived = 0;
    g.kind = Collective::NONE;
    for (unsigned& a : g.warp_arrived) a = 0;
    for (unsigned l = 0; l < 128; ++l)
      if (l != lane) release(g.waiting[l]);
  } else {
    block(Wait::WARPGROUP);
  }
  return g.slot[lane];
}

WarpGroup& warpgroup() { return cta().warpgroups[self().tid >> 7]; }

// B of a wgmma m64nNk8 through its descriptor: the 16-byte rows of its
// K-major core matrices (8 rows of N, 4 TF32 of K each), the two along K
// `lbo` bytes apart, the N / 8 along N `sbo`; row (k / 4, n / 8, n % 8) is
// rows[(k / 4 * N / 8 + n / 8) * 8 + n % 8].
void operand_rows(const Cta& c, uint64_t desc, unsigned n, unsigned* rows) {
  constexpr uint64_t RESERVED = (3ull << 14) | (3ull << 30) | (7ull << 46) | (1023ull << 52);
  if (desc & RESERVED) trap("a wgmma descriptor with reserved bits set");
  const unsigned mode = (unsigned)(desc >> 62);
  if (mode) {
    static const char* const names[4] = {"", "128-byte", "64-byte", "32-byte"};
    char what[96];
    snprintf(what, sizeof what, "a wgmma descriptor of the %s swizzle mode (%u): not modelled on the host",
             names[mode], mode);
    trap(what);
  }
  if ((desc >> 49) & 7u) trap("a wgmma descriptor with a base offset, which only a swizzle mode reads");
  const unsigned start = (unsigned)(desc & 0x3fffu) << 4;
  const unsigned lbo = (unsigned)((desc >> 16) & 0x3fffu) << 4;
  const unsigned sbo = (unsigned)((desc >> 32) & 0x3fffu) << 4;
  for (unsigned i = 0; i < 2 * n; ++i) {
    const size_t addr = (size_t)start + (i / n) * lbo + ((i % n) >> 3) * sbo + (i & 7u) * 16;
    if (addr + 16 > c.arena_bytes) trap("a wgmma operand past the CTA's shared memory");
    if (__asan_region_is_poisoned(c.arena + addr, 16))
      trap("a wgmma operand in shared memory past a region (poisoned bytes)");
    rows[i] = (unsigned)addr;
  }
}

// Every lane's D = scale_d C + scale_a A B (TF32 inputs, float32 sums in k
// order), with B from the async view; B's rows and their bytes in the arena
// kept for the wait.
void wgmma_product(WarpGroup& g) {
  Cta& c = *current_cta;
  const GroupSlot& s0 = g.slot[0];
  for (const GroupSlot& s : g.slot)
    if (s.desc != s0.desc || s.scale_d != s0.scale_d || s.scale_a != s0.scale_a ||
        s.param != s0.param)
      trap("lanes of one warpgroup gave a wgmma different shapes, descriptors or scales");
  const unsigned n = (unsigned)s0.param;
  if (c.async_view.empty()) c.async_view.assign(c.arena_bytes, (char)0xff);
  Operand op;
  op.group = g.committed;
  op.count = 2 * n;
  operand_rows(c, s0.desc, n, op.rows);
  float B[8][MAX_N];
  for (unsigned i = 0; i < 2 * n; ++i) {
    memcpy(op.words[i], c.arena + op.rows[i], 16);
    uint32_t w[4];
    memcpy(w, c.async_view.data() + op.rows[i], 16);
    for (unsigned j = 0; j < 4; ++j) B[(i / n) * 4 + j][i % n] = tf32(w[j]);
  }
  g.operands.push_back(op);
  float A[64][8];
  const float sa = (float)s0.scale_a;
  for (unsigned l = 0; l < 128; ++l) {
    const unsigned r = (l >> 5) * 16 + ((l & 31u) >> 2), q = l & 3u;
    const uint32_t* a = g.slot[l].a;
    A[r][q] = sa * tf32(a[0]);
    A[r + 8][q] = sa * tf32(a[1]);
    A[r][q + 4] = sa * tf32(a[2]);
    A[r + 8][q + 4] = sa * tf32(a[3]);
  }
  for (unsigned l = 0; l < 128; ++l) {
    GroupSlot& s = g.slot[l];
    const unsigned r = (l >> 5) * 16 + ((l & 31u) >> 2), q = l & 3u;
    for (unsigned j = 0; j < n / 8; ++j)
      for (unsigned v = 0; v < 4; ++v) {
        const unsigned row = r + (v >> 1) * 8, col = 8 * j + 2 * q + (v & 1);
        float acc = s0.scale_d ? s.c[4 * j + v] : 0.f;
        for (unsigned k = 0; k < 8; ++k) acc += A[row][k] * B[k][col];
        s.out[4 * j + v] = acc;
      }
  }
}

}  // namespace

void wgmma(float* d, int n, const uint32_t (&a)[4], uint64_t desc, int scale_d, int scale_a) {
  Fiber& f = self();
  if (n != 64 && n != 128) trap("a wgmma of a shape the host does not model");
  const int count = n / 2;
  if (!f.wgmma_fenced)
    trap("a wgmma with no wgmma.fence since the thread's last wgmma.wait_group (or the kernel's start)");
  auto pending = [&f, &d]() -> Accumulator* {
    for (Accumulator& acc : f.accumulators)
      if (acc.d == d) return &acc;
    return nullptr;
  };
  GroupSlot in{};
  memcpy(in.a, a, sizeof in.a);
  const Accumulator* chained = pending();  // a product in flight on d: chain on its value
  if (chained && chained->count != count) trap("a wgmma chained on accumulators of another shape");
  memcpy(in.c, chained ? chained->value : d, count * sizeof(float));
  in.desc = desc;
  in.scale_d = scale_d;
  in.scale_a = scale_a;
  in.param = n;
  const GroupSlot& out = group_collective(Collective::WGMMA, in, wgmma_product);
  const unsigned group = warpgroup().committed;
  Accumulator* acc = pending();
  if (!acc) {
    f.accumulators.push_back(Accumulator{d, 0, count, {}});
    acc = &f.accumulators.back();
  }
  acc->group = group;
  memcpy(acc->value, out.out, count * sizeof(float));
  for (int i = 0; i < count; ++i) memcpy(d + i, &IN_FLIGHT, 4);
  Fragment frag{a, group, {a[0], a[1], a[2], a[3]}};
  f.fragments.push_back(frag);
}

void wgmma_fence() {
  group_collective(Collective::WGMMA_FENCE, GroupSlot{}, [](WarpGroup&) {});
  self().wgmma_fenced = true;
}

void wgmma_commit() {
  group_collective(Collective::WGMMA_COMMIT, GroupSlot{}, [](WarpGroup& g) { ++g.committed; });
}

void wgmma_wait(int groups_in_flight) {
  const unsigned keep = (unsigned)groups_in_flight;
  GroupSlot in{};
  in.param = groups_in_flight;
  group_collective(Collective::WGMMA_WAIT, in, [keep](WarpGroup& g) {
    for (const GroupSlot& s : g.slot)
      if (s.param != g.slot[0].param) trap("lanes of one warpgroup at wgmma.wait_group with different counts");
    const Cta& c = *current_cta;
    size_t kept = 0;
    for (Operand& op : g.operands) {
      if (op.group + keep < g.committed) {
        for (unsigned i = 0; i < op.count; ++i)
          if (memcmp(op.words[i], c.arena + op.rows[i], 16))
            trap("shared operand of an in-flight wgmma was written");
      } else {
        g.operands[kept++] = op;
      }
    }
    g.operands.resize(kept);
  });
  // this lane's products that the wait covers land
  Fiber& f = self();
  const unsigned committed = warpgroup().committed;
  size_t kept = 0;
  for (Accumulator& acc : f.accumulators) {
    if (acc.group + keep < committed) {
      for (int i = 0; i < acc.count; ++i)
        if (memcmp(acc.d + i, &IN_FLIGHT, 4)) trap("an accumulator of an in-flight wgmma was written");
      memcpy(acc.d, acc.value, acc.count * sizeof(float));
    } else {
      f.accumulators[kept++] = acc;
    }
  }
  f.accumulators.resize(kept);
  kept = 0;
  for (Fragment& frag : f.fragments) {
    if (frag.group + keep < committed) {
      if (memcmp(frag.a, frag.value, sizeof frag.value))
        trap("an A fragment register of an in-flight wgmma was written");
    } else {
      f.fragments[kept++] = frag;
    }
  }
  f.fragments.resize(kept);
  f.wgmma_fenced = false;
}

void fence_proxy_async() {
  Cta& c = cta();
  if (c.async_view.empty()) c.async_view.assign(c.arena_bytes, (char)0xff);
  for (const auto& [off, bytes] : c.regions) memcpy(c.async_view.data() + off, c.arena + off, bytes);
}

namespace {

// The live mbarrier at `addr`, its word checked.
MBarrier& mbarrier(const char* op, unsigned addr) {
  Cta& c = cta();
  auto it = c.mbarriers.find(addr);
  if (it == c.mbarriers.end()) {
    char what[128];
    snprintf(what, sizeof what, "an mbarrier %s at shared address %u, where no mbarrier.init made one", op, addr);
    trap(what);
  }
  uint64_t word;
  memcpy(&word, shared_at(addr, 8, 8), 8);
  if (word != MBAR_MARK) trap("an mbarrier's word in shared memory was overwritten by a store");
  return it->second;
}

}  // namespace

void mbar_init(unsigned addr, unsigned count) {
  Cta& c = cta();
  char* p = shared_at(addr, 8, 8);
  if (__asan_region_is_poisoned(p, 8)) trap("an mbarrier in shared memory past a region (poisoned bytes)");
  if (count < 1 || count >= (1u << 20)) trap("an mbarrier.init with a count outside 1 to 2^20 - 1");
  memcpy(p, &MBAR_MARK, 8);
  MBarrier& b = c.mbarriers[addr];
  if (!b.waiters.empty()) trap("an mbarrier.init of a barrier that threads wait on");
  b.count = b.pending = count;
  b.phase = 0;
}

void mbar_arrive(unsigned addr) {
  MBarrier& b = mbarrier("arrive", addr);
  if (--b.pending) return;
  ++b.phase;                                 // the phase completes; the next one starts
  b.pending = b.count;
  for (Fiber* f : b.waiters) release(f);
  b.waiters.clear();
}

// A waiter released by the arrival that completes the phase returns, as a
// suspended try_wait on the card wakes at that completion, whatever later
// arrivals do before it runs.
void mbar_wait(unsigned addr, unsigned parity) {
  MBarrier& b = mbarrier("wait", addr);
  if ((b.phase & 1u) != (parity & 1u)) return;  // the phase of that parity has completed
  b.waiters.push_back(cta().current);
  block(Wait::MBAR);
}

void cp_async(unsigned addr, const void* data, unsigned bytes) {
  Fiber& f = self();
  Copy cp{addr, bytes, f.committed, {0, 0, 0, 0}};
  memcpy(cp.data, data, bytes);
  f.copies.push_back(cp);
}

void cp_async_commit() { ++self().committed; }

void cp_async_wait(int groups_in_flight) { land_copies(self(), (unsigned)groups_in_flight); }

void poll(const void* addr, unsigned value) {
  Cta& c = cta();
  if (!c.count) {
    if (baton) give_way(c, addr, value);
    else sched_yield();
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
  if ((f->tid >> 7) < c.warpgroups.size() && c.warpgroups[f->tid >> 7].arrived)
    trap("a lane exited while its warpgroup waits at a collective");
  if (c.bar_arrived && c.bar_arrived == c.live) release_barrier(c);
  jump(f, c.pop(), true);
  __builtin_unreachable();
}
