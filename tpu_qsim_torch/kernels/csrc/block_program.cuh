// The register block program: how one CTA applies a register table
// (tpu_qsim_torch/kernels/gridsweeps.py::register_table) to one block of
// 2^k amplitude slots. grid_sweep.cu runs it once per step of a sweep;
// sweep.cu once per tile of a unit's tile stage; segment.cu once per block
// of a segment. One copy serves all three.
//
// Replaces the body of tpu_qsim/kernels/gridsweeps.py::_build_grid_sweep's
// kernel (emit_ops on a VMEM block).
//
// Amplitudes live in registers. Each of the CTA's 2^(k - R) threads owns
// 2^R = 16 slots of the block: block bits 0-4 are the lane index (bits 0-4
// are state bits 0-4, so a warp's 32 slots are 128 contiguous bytes of a
// plane), R "register bits" index the thread's values, and the remaining
// block bits the warp. So:
//   - the first load (the caller's) and the last store go straight between
//     memory and registers, 2^R independent accesses in flight per thread
//     and plane (the store to the block's own slots, or through the
//     caller's map);
//   - a diagonal op runs in registers whatever its qubits (each thread knows
//     its slots' bits, and out-of-block bits come from the block's share of
//     the global index);
//   - a 1-qubit dense core on a register or a lane bit runs in registers,
//     a lane target through __shfl_xor_sync, with no shared memory and no
//     barrier; block-local controls on any bit are a per-slot test, and an
//     X core (cnot, toffoli, x) is a swap of registers with no arithmetic
//     (2-qubit cores in registers, tried first, made ptxas spill 15-25 KB);
//   - a REMAP op stores the registers to shared memory, waits at one
//     barrier and loads them back with another choice of register bits;
//   - any other op (a dense core of 2 or more qubits) runs on the block in
//     shared memory (ops.cuh's apply_op, a barrier after it; cores of
//     TILE_CORE qubits and more take the tiled product, its scratch at
//     `scratch`).
// The host chooses the register bits of each run of ops, greedily from the
// next ops' targets, and writes the remaps into the op table; the program
// moves between registers and shared memory only where the table asks.
//
// A qubit code < EXT names a bit of the block-local index; EXT + p names
// state bit p outside the block, read from the block's share of the global
// index (cta_g).

#pragma once

#include <cuda_runtime.h>

#include "ops.cuh"

namespace qsim {

constexpr int LANE_BITS = 5;         // block bits 0-4 index a warp's lanes
constexpr int R = 4;                 // register bits: 2^R slots a thread
constexpr int HEADER_REG_BITS = 5;   // header word: R (checked)
constexpr int HEADER_REGS = 8;       // header words 8..8+R: the first register bits
// After the ops, an 8-word descriptor per op (gridsweeps.py::_descriptor):
// what the kernel reads of an op, in two 16-byte loads instead of a chain of
// dependent word loads. d0 = (flags, coefficient offset, control mask,
// control value), d1 = (out-of-block control mask, value, target: register
// position or lane bit, diagonal qubits m | q0 << 8 | q1 << 16).
constexpr int DESC_WORDS = 8;
constexpr int D_REG = 1, D_REMAP = 2, D_DIAG = 4, D_SWAP = 8, D_LANE = 16,
              D_WIDE_DIAG = 32;

// Global amplitude index of block-local slot l.
__device__ __forceinline__ unsigned global_index(unsigned l, int blk, int a,
                                                 const int* active,
                                                 unsigned cta_g) {
  unsigned g = cta_g | (l & ((1u << blk) - 1u));
  const unsigned hi = l >> blk;
  for (int j = 0; j < a; ++j)
    if ((hi >> j) & 1u) g |= 1u << active[j];
  return g;
}

// Offset of register value i: the OR of the register masks of its set bits.
__device__ __forceinline__ unsigned reg_off(int i, const unsigned (&rm)[R]) {
  unsigned o = 0;
#pragma unroll
  for (int b = 0; b < R; ++b)
    if ((i >> b) & 1) o |= rm[b];
  return o;
}

// A thread's amplitudes: value v is block slot tbase | reg_off(v). Every
// routine that takes a Regs is inlined with its loops unrolled, so the arrays
// stay in registers.
struct Regs {
  float r[1 << R], i[1 << R];
  unsigned rm[R];  // 1 << (block bit) of each register bit
  unsigned tbase;  // this thread's lane and warp bits
  __device__ __forceinline__ unsigned slot(int v) const {
    return tbase | reg_off(v, rm);
  }
  // take the register bits `codes` (ascending block bits >= LANE_BITS)
  __device__ __forceinline__ void set(const int* codes, unsigned lane,
                                      unsigned warp, unsigned size) {
    unsigned used = (1u << LANE_BITS) - 1u;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      rm[b] = 1u << codes[b];
      used |= rm[b];
    }
    tbase = lane | deposit_bits(warp, (size - 1u) & ~used);
  }
  __device__ __forceinline__ void store(float* sr, float* si) const {
#pragma unroll
    for (int v = 0; v < (1 << R); ++v) {
      sr[slot(v)] = r[v];
      si[slot(v)] = i[v];
    }
  }
  __device__ __forceinline__ void load(const float* sr, const float* si) {
#pragma unroll
    for (int v = 0; v < (1 << R); ++v) {
      r[v] = sr[slot(v)];
      i[v] = si[slot(v)];
    }
  }
  // global index of value 0 and of each register bit: the map is linear
  __device__ __forceinline__ unsigned global(unsigned (&gm)[R], int blk, int a,
                                             const int* active,
                                             unsigned cta_g) const {
#pragma unroll
    for (int b = 0; b < R; ++b) gm[b] = global_index(rm[b], blk, a, active, 0u);
    return global_index(tbase, blk, a, active, cta_g);
  }
  // the block's slots straight from the state's planes, through L2 only
  // (another CTA may have written them since this SM last read them)
  __device__ __forceinline__ void load_global(const float* re, const float* im,
                                              int blk, int a, const int* active,
                                              unsigned cta_g) {
    unsigned gm[R];
    const unsigned gt = global(gm, blk, a, active, cta_g);
#pragma unroll
    for (int v = 0; v < (1 << R); ++v) {
      const unsigned g = gt | reg_off(v, gm);
      r[v] = __ldcg(re + g);
      i[v] = __ldcg(im + g);
    }
  }
};

// Block-local controls of an op, as each value sees them: the lane and warp
// bits are the thread's (one test), the register bits value v's own.
struct Ctrl {
  bool thread_ok;
  unsigned vmask, vval;  // over the register positions
  __device__ __forceinline__ Ctrl(const Regs& x, unsigned lmask,
                                  unsigned lval) {
    unsigned regs = 0;
    vmask = vval = 0;
#pragma unroll
    for (int b = 0; b < R; ++b) {
      regs |= x.rm[b];
      if (lmask & x.rm[b]) vmask |= 1u << b;
      if (lval & x.rm[b]) vval |= 1u << b;
    }
    thread_ok = ((x.tbase ^ lval) & lmask & ~regs) == 0;
  }
  __device__ __forceinline__ bool ok(int v) const {
    return thread_ok && ((unsigned)v & vmask) == vval;
  }
};

// Where value v finds the bit of qubit code q: register position p
// (pmask = 1 << p), else the same for all of the thread's values (ubit).
struct QubitBit {
  unsigned pmask, ubit;
  __device__ __forceinline__ QubitBit(const Regs& x, int q, unsigned cta_g) {
    pmask = 0;
    ubit = q >= EXT ? (cta_g >> (q - EXT)) & 1u : (x.tbase >> q) & 1u;
#pragma unroll
    for (int b = 0; b < R; ++b)
      if (q < EXT && x.rm[b] == 1u << q) pmask = 1u << b;
  }
  __device__ __forceinline__ unsigned of(int v) const {
    return pmask ? ((unsigned)v & pmask ? 1u : 0u) : ubit;
  }
};

// run_block's op boundaries, for a measurement build (grid_sweep.cu's
// stamp and marked instances): NoStamp everywhere else, which compiles to
// nothing. Stamp(slot): slot 2 + o is the start of op o, 2 + n_ops the
// last store's start and 3 + n_ops its end; slots 0 and 1 are the
// caller's (the block's wait and its first load). Stamp::mark<id>() marks
// where the op loop and an op class's code start in the SASS;
// Stamp::tile() is what a tiled op stamps its own boundaries with.
struct NoStamp {
  __device__ __forceinline__ void operator()(int) const {}
  template <int ID>
  __device__ __forceinline__ void mark() const {}
  __device__ __forceinline__ NoTileStamp tile() const { return {}; }
};

__device__ __forceinline__ void cmul(float& r, float& i, float2 c) {
  const float a = r, b = i;
  r = fmaf(c.x, a, -c.y * b);
  i = fmaf(c.x, b, c.y * a);
}

// 1-qubit diagonal on register position P: no per-value selection.
template <int P>
__device__ __forceinline__ void reg_diag1(Regs& x, float2 w0, float2 w1) {
#pragma unroll
  for (int v = 0; v < (1 << R); ++v) cmul(x.r[v], x.i[v], v & (1 << P) ? w1 : w0);
}

// Diagonal op in registers: each value times d[bits of the op's qubits]. A
// 1-qubit diagonal on a lane, warp or out-of-block bit is one factor for all
// of the thread's values, on a register bit one of two by position.
__device__ __forceinline__ void reg_diag(Regs& x, const int* op, int flags,
                                         int qubits, const float2* d,
                                         unsigned cta_g) {
  if ((qubits & 0xff) == 1) {
    const QubitBit q(x, (qubits >> 8) & 0xff, cta_g);
    const float2 w0 = d[0], w1 = d[1];
    if (!q.pmask) {
      const float2 w = q.ubit ? w1 : w0;
#pragma unroll
      for (int v = 0; v < (1 << R); ++v) cmul(x.r[v], x.i[v], w);
      return;
    }
#define QSIM_CALL(P) reg_diag1<P>(x, w0, w1)
    switch (__ffs(q.pmask) - 1) {
      case 0: QSIM_CALL(0); break;
      case 1: QSIM_CALL(1); break;
      case 2: QSIM_CALL(2); break;
      case 3: QSIM_CALL(3); break;
    }
#undef QSIM_CALL
    return;
  }
  if (!(flags & D_WIDE_DIAG)) {
    const int m = qubits & 0xff;
    const QubitBit q0(x, (qubits >> 8) & 0xff, cta_g), q1(x, qubits >> 16, cta_g);
    const float2 w0 = d[0], w1 = d[1];
    const float2 w2 = m == 2 ? d[2] : w0, w3 = m == 2 ? d[3] : w1;
#pragma unroll
    for (int v = 0; v < (1 << R); ++v) {
      const unsigned idx = m == 2 ? (q0.of(v) << 1) | q1.of(v) : q0.of(v);
      const float2 c = idx == 0 ? w0 : idx == 1 ? w1 : idx == 2 ? w2 : w3;
      const float r = x.r[v], im = x.i[v];
      x.r[v] = fmaf(c.x, r, -c.y * im);
      x.i[v] = fmaf(c.x, im, c.y * r);
    }
    return;
  }
  const int m = op[1];
#pragma unroll
  for (int v = 0; v < (1 << R); ++v) {
    const unsigned l = x.slot(v);
    unsigned idx = 0;
    for (int j = 0; j < m; ++j) idx = (idx << 1) | bit_of(op[8 + j], l, cta_g);
    const float2 c = d[idx];
    const float r = x.r[v], im = x.i[v];
    x.r[v] = fmaf(c.x, r, -c.y * im);
    x.i[v] = fmaf(c.x, im, c.y * r);
  }
}

// 1-qubit core on register position P.
template <int P>
__device__ __forceinline__ void reg_dense1(Regs& x, const float2* u,
                                           const Ctrl& ctrl) {
  const float2 u0 = u[0], u1 = u[1], u2 = u[2], u3 = u[3];
#pragma unroll
  for (int v = 0; v < (1 << R); ++v) {
    if (v & (1 << P)) continue;
    const int w = v | (1 << P);
    if (!ctrl.ok(v)) continue;
    const float ar = x.r[v], ai = x.i[v], br = x.r[w], bi = x.i[w];
    float yr = 0.f, yi = 0.f, zr = 0.f, zi = 0.f;
    cmac(yr, yi, u0, ar, ai);
    cmac(yr, yi, u1, br, bi);
    cmac(zr, zi, u2, ar, ai);
    cmac(zr, zi, u3, br, bi);
    x.r[v] = yr; x.i[v] = yi; x.r[w] = zr; x.i[w] = zi;
  }
}

// 1-qubit core on lane bit b: the partner value comes from lane ^ (1 << b).
__device__ __forceinline__ void lane_dense1(Regs& x, const float2* u,
                                            const Ctrl& ctrl, unsigned lane,
                                            int b) {
  const unsigned me = (lane >> b) & 1u;
  const float2 wa = me ? u[3] : u[0];  // u[me][me]
  const float2 wb = me ? u[2] : u[1];  // u[me][1 - me]
#pragma unroll
  for (int v = 0; v < (1 << R); ++v) {
    const float pr = __shfl_xor_sync(0xffffffffu, x.r[v], 1 << b);
    const float pi = __shfl_xor_sync(0xffffffffu, x.i[v], 1 << b);
    if (!ctrl.ok(v)) continue;
    float yr = 0.f, yi = 0.f;
    cmac(yr, yi, wa, x.r[v], x.i[v]);
    cmac(yr, yi, wb, pr, pi);
    x.r[v] = yr; x.i[v] = yi;
  }
}

// X on register position P: swap the pairs whose controls pass.
template <int P>
__device__ __forceinline__ void reg_swap(Regs& x, const Ctrl& ctrl) {
#pragma unroll
  for (int v = 0; v < (1 << R); ++v) {
    if (v & (1 << P)) continue;
    const int w = v | (1 << P);
    const bool on = ctrl.ok(v);
    const float ar = x.r[v], ai = x.i[v], br = x.r[w], bi = x.i[w];
    x.r[v] = on ? br : ar; x.i[v] = on ? bi : ai;
    x.r[w] = on ? ar : br; x.i[w] = on ? ai : bi;
  }
}

// X on lane bit b: take the partner lane's value where the controls pass.
__device__ __forceinline__ void lane_swap(Regs& x, const Ctrl& ctrl, int b) {
#pragma unroll
  for (int v = 0; v < (1 << R); ++v) {
    const float pr = __shfl_xor_sync(0xffffffffu, x.r[v], 1 << b);
    const float pi = __shfl_xor_sync(0xffffffffu, x.i[v], 1 << b);
    if (!ctrl.ok(v)) continue;
    x.r[v] = pr;
    x.i[v] = pi;
  }
}

#define QSIM_POS_CASES(CALL) \
  case 0: CALL(0); break;    \
  case 1: CALL(1); break;    \
  case 2: CALL(2); break;    \
  case 3: CALL(3); break;

// The SASS markers of the op classes (Stamp::mark, the measurement build).
enum OpMark { MARK_LOOP = 0, MARK_SWAP, MARK_SWAP_LANE, MARK_DENSE1, MARK_DENSE1_LANE, MARK_DIAG };

template <class Stamp>
__device__ __forceinline__ void reg_op(Regs& x, const int4 d0,
                                       const int4 d1, const int* op,
                                       const float2* coef, unsigned lane,
                                       unsigned cta_g, const Stamp& stamp) {
  const int flags = d0.x;
  const float2* u = coef + d0.y;
  if (flags & D_DIAG) {
    stamp.template mark<MARK_DIAG>();
    reg_diag(x, op, flags, d1.w, u, cta_g);
    return;
  }
  const Ctrl ctrl(x, d0.z, d0.w);
  const int target = d1.z;
  if (flags & D_SWAP) {
    if (!(flags & D_LANE)) {
#define QSIM_CALL(P) stamp.template mark<MARK_SWAP>(); reg_swap<P>(x, ctrl)
      switch (target) { QSIM_POS_CASES(QSIM_CALL) }
#undef QSIM_CALL
    } else {
      stamp.template mark<MARK_SWAP_LANE>();
      lane_swap(x, ctrl, target);
    }
  } else if (!(flags & D_LANE)) {
#define QSIM_CALL(P) stamp.template mark<MARK_DENSE1>(); reg_dense1<P>(x, u, ctrl)
    switch (target) { QSIM_POS_CASES(QSIM_CALL) }
#undef QSIM_CALL
  } else {
    stamp.template mark<MARK_DENSE1_LANE>();
    lane_dense1(x, u, ctrl, lane, target);
  }
}

#undef QSIM_POS_CASES

// Start copying the block of 2^(blk + a) slots whose share of the global
// index is cta_g, both planes, into (pr, pi) with cp.async, 16 bytes at a
// time (blk >= 2 keeps 4 slots contiguous in the state), as one group: a
// caller's next block streams in while the current one runs.
__device__ __forceinline__ void prefetch_block(float* pr, float* pi,
                                               const float* re, const float* im,
                                               unsigned size, int blk, int a,
                                               const int* active,
                                               unsigned cta_g) {
  for (unsigned ch = threadIdx.x; ch < size / 4; ch += blockDim.x) {
    const unsigned g = global_index(ch * 4, blk, a, active, cta_g);
    cp_async16(pr + ch * 4, re + g);
    cp_async16(pi + ch * 4, im + g);
  }
  cp_async_commit();
}

// Where run_block's last store puts block slot l: at(l). The map is linear
// in l's bits, so a thread computes at() of its first slot and bits() (the
// map without the block's own share) of each register bit once. BlockStore
// is the block's own slots, in place; segment.cu stores through an index map.
struct BlockStore {
  int blk, a;
  const int* active;
  unsigned cta_g;
  __device__ __forceinline__ unsigned bits(unsigned l) const {
    return global_index(l, blk, a, active, 0u);
  }
  __device__ __forceinline__ unsigned at(unsigned l) const {
    return global_index(l, blk, a, active, cta_g);
  }
};

// A register table's header words, read once by the caller (per launch in
// the grid sweep, per stage in the sweeps) rather than per block.
struct BlockShape {
  int n_ops, blk, a, kbits;
  unsigned size;
  __device__ __forceinline__ explicit BlockShape(const int* t)
      : n_ops(t[0]), blk(t[1]), a(t[2]), kbits(t[1] + t[2]),
        size(1u << (t[1] + t[2])) {}
};

// One block through a register table: the block whose share of the global
// index is cta_g, of 2^(blk + a) slots, the CTA's 2^(blk + a - R) threads.
// `load_first(Regs&)` fills the registers for the first run of ops (its
// register bits already set): from a prefetched copy in shared memory, or
// straight from the planes. (sr, si) hold the block for remaps and
// shared-memory ops; it must be free when the program starts, and every
// thread may still read it when the program returns. The last store goes
// from registers (or shared memory, after a shared-memory op) to the planes
// at store.at(l) (BlockStore: the block's own slots, the overload below),
// as streaming stores where STREAM (the block is not read again soon).
// Cores in shared-memory ops are at most MAXM qubits wide. With SPARE the
// CTA may have more threads than the block's 2^(blk + a - R): the warps past
// them hold no values and only share the barriers and the shared-memory ops
// (load_first must skip them too).
template <int MAXM, bool STREAM, bool SPARE = false, class Scratch, class LoadFirst,
          class Store, class Stamp = NoStamp>
__device__ __forceinline__ void run_block(float* __restrict__ re,
                                          float* __restrict__ im,
                                          const int* __restrict__ table,
                                          const BlockShape& shape,
                                          const float2* __restrict__ coef,
                                          unsigned cta_g, float* sr, float* si,
                                          const Scratch& scratch,
                                          LoadFirst&& load_first,
                                          const Store& store,
                                          const Stamp& stamp = Stamp()) {
  const int n_ops = shape.n_ops;
  const int kbits = shape.kbits;
  const unsigned size = shape.size;
  const int* desc = table + SWEEP_HEADER + n_ops * OP_HEADER;
  const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
  const int* regs = table + HEADER_REGS;  // the current register bits
  const bool holds = !SPARE || threadIdx.x < (size >> R);  // values of its own
  bool first = true;
  int o = 0;
  for (;;) {
    {  // a run of register ops; the values live only inside it
      Regs x;
      x.set(regs, lane, warp, size);
      bool read_smem;  // a load from (sr, si) precedes the next store
      if (first) {
        load_first(x);
        first = false;
        read_smem = false;
      } else {
        if (holds) x.load(sr, si);  // the shared-memory run ended at a barrier
        read_smem = true;
      }
      for (; o < n_ops; ++o) {
        stamp(2 + o);
        stamp.template mark<MARK_LOOP>();
        const int* op = table + SWEEP_HEADER + o * OP_HEADER;
        const int4* dp = reinterpret_cast<const int4*>(desc + o * DESC_WORDS);
        const int4 d0 = __ldg(dp), d1 = __ldg(dp + 1);
        if (d0.x & D_REMAP) {
          if (read_smem) __syncthreads();
          if (holds) x.store(sr, si);
          __syncthreads();
          regs = op + 8;
          x.set(regs, lane, warp, size);
          if (holds) x.load(sr, si);
          read_smem = true;
          continue;
        }
        if ((cta_g & (unsigned)d1.x) != (unsigned)d1.y) continue;
        if (!(d0.x & D_REG)) break;
        if (holds) reg_op(x, d0, d1, op, coef, lane, cta_g, stamp);
      }
      if (o == n_ops) {
        if (!holds) return;
        stamp(2 + n_ops);
        unsigned gm[R];
#pragma unroll
        for (int b = 0; b < R; ++b) gm[b] = store.bits(x.rm[b]);
        const unsigned gt = store.at(x.tbase);
#pragma unroll
        for (int v = 0; v < (1 << R); ++v) {
          const unsigned g = gt | reg_off(v, gm);
          if constexpr (STREAM) {
            __stcs(re + g, x.r[v]);
            __stcs(im + g, x.i[v]);
          } else {
            re[g] = x.r[v];
            im[g] = x.i[v];
          }
        }
        stamp(3 + n_ops);
        return;
      }
      if (read_smem) __syncthreads();
      if (holds) x.store(sr, si);
      __syncthreads();
    }
    // a run of shared-memory ops
    for (; o < n_ops; ++o) {
      stamp(2 + o);
      const int* op = table + SWEEP_HEADER + o * OP_HEADER;
      const int flags = desc[o * DESC_WORDS];
      if (flags & D_REMAP) {
        regs = op + 8;
        continue;
      }
      if (flags & D_REG) break;
      apply_op<MAXM>(BlockSlots{sr, si}, op, coef, kbits, cta_g, Part{0, 0u},
                     scratch, stamp.tile());
      __syncthreads();
    }
    if (o == n_ops) {
      stamp(2 + n_ops);
#pragma unroll 4
      for (unsigned l = threadIdx.x; l < size; l += blockDim.x) {
        const unsigned g = store.at(l);
        if constexpr (STREAM) {
          __stcs(re + g, sr[l]);
          __stcs(im + g, si[l]);
        } else {
          re[g] = sr[l];
          im[g] = si[l];
        }
      }
      stamp(3 + n_ops);
      return;
    }
  }
}

// run_block storing to the block's own slots, in place.
template <int MAXM, bool STREAM, bool SPARE = false, class Scratch, class LoadFirst,
          class Stamp = NoStamp>
__device__ __forceinline__ void run_block_in_place(float* __restrict__ re,
                                                   float* __restrict__ im,
                                                   const int* __restrict__ table,
                                                   const BlockShape& shape,
                                                   const float2* __restrict__ coef,
                                                   unsigned cta_g, float* sr, float* si,
                                                   const Scratch& scratch,
                                                   LoadFirst&& load_first,
                                                   const Stamp& stamp = Stamp()) {
  run_block<MAXM, STREAM, SPARE>(re, im, table, shape, coef, cta_g, sr, si,
                                 scratch, load_first,
                                 BlockStore{shape.blk, shape.a, table + 16, cta_g}, stamp);
}

}  // namespace qsim
