// Op semantics shared by the port's kernels: how one op of the device op
// table (tpu_qsim_torch/kernels/fused_circuit.py::build_op_table) acts on a
// block of 2^kbits amplitude slots. grid_sweep.cu, segment.cu, sweep.cu and
// dense_pass.cu all include this one copy (grid_sweep.cu and sweep.cu
// through block_program.cuh, the register program they share).
//
// Replaces the op body that every TPU kernel of tpu_qsim shares,
// tpu_qsim/kernels/fused_circuit.py::emit_ops (XOR-shift gate emission,
// 128x128 lane/row/top window matmuls, lane diagonals, ext-phase scalars).
//
// Where slot l lives is the caller's choice, through a Slots type whose
// re(l) / im(l) return pointers:
//   BlockSlots   - this CTA's own shared memory holds the whole block, at l
//                  (the grid sweep, the segments, a tile of the sweeps);
//   GlobalSlots  - device memory (the sweep kernels): slot l is the state
//                  index of l under the block layout of the current part or
//                  step, see below.
// Which work items a CTA takes is a Part: an op's items are split into 2^log2
// equal contiguous parts and the CTA takes part `index`.

#pragma once

#include <cuda_runtime.h>

#include "ptx.cuh"
#include "tf32.cuh"

namespace qsim {

constexpr int SWEEP_HEADER = 64;    // int32 words before the first op
constexpr int HEADER_MAX_CORE = 4;  // header word: the table's widest dense core
constexpr int OP_HEADER = 32;       // int32 words per op
constexpr int EXT = 32;             // codes >= EXT name bits outside the block
constexpr int KIND_DIAG = 0;        // KIND_DENSE (1): a dense core
constexpr int TILE_CORE = 5;        // dense cores of this many qubits and more: apply_dense_tiled
constexpr int NARROW_CORE = 4;      // the widest core of a kernel's narrow instance

// Masking every access of a single-CTA block (a mask of size - 1 on each
// slot) cost the 28q grid sweep 3% against this type on the H100 (PERF.md).
struct BlockSlots {
  static constexpr bool GLOBAL = false;  // the slots lie in shared memory
  float* sr;
  float* si;
  __device__ float* re(unsigned l) const { return sr + l; }
  __device__ float* im(unsigned l) const { return si + l; }
};

// The sweep kernels' block: kernel bits [0, blk) are state bits [0, blk),
// kernel bit blk + j is state bit active[j] (the high sweep's active top
// bits; hi_off[h] deposits h there), and the state bits outside the block
// are cta_g, the current part's or step's share of the global index. With
// DEPOSIT false (the low sweep) the block is state bits [0, kbits), so slot
// l is cta_g + l.
template <bool DEPOSIT>
struct GlobalSlots {
  static constexpr bool GLOBAL = true;
  float* sr;  // the state's planes
  float* si;
  unsigned cta_g;
  int blk;
  const unsigned* hi_off;  // 2^a entries, in shared memory
  __device__ unsigned index(unsigned l) const {
    if constexpr (!DEPOSIT) return cta_g + l;
    return cta_g | (l & ((1u << blk) - 1u)) | hi_off[l >> blk];
  }
  __device__ float* re(unsigned l) const { return sr + index(l); }
  __device__ float* im(unsigned l) const { return si + index(l); }
};

struct Part {
  int log2;
  unsigned index;
  __device__ unsigned begin(unsigned total) const { return index * (total >> log2); }
  __device__ unsigned end(unsigned total) const { return (index + 1) * (total >> log2); }
};

// (ar, ai) += w (xr, xi) as four chained FMAs (written as a + b - c, the
// sum would cost a multiply, an FMA and an add per plane)
__device__ __forceinline__ void cmac(float& ar, float& ai, float2 w, float xr,
                                     float xi) {
  ar = fmaf(w.x, xr, fmaf(-w.y, xi, ar));
  ai = fmaf(w.x, xi, fmaf(w.y, xr, ai));
}

__device__ __forceinline__ unsigned bit_of(int code, unsigned l, unsigned cta_g) {
  return code < EXT ? (l >> code) & 1u : (cta_g >> (code - EXT)) & 1u;
}

// Diagonal op: one thread per slot, d[bits of the op's qubits]. Ops on one
// or two qubits (rz, cz, cp, crz) keep their diagonal in registers.
template <class S>
__device__ void apply_diag(const S& s, const int* op, const float2* coef,
                           int kbits, unsigned cta_g, Part part) {
  const int m = op[1];
  const float2* d = coef + op[2];
  const unsigned lo = part.begin(1u << kbits), hi = part.end(1u << kbits);
  if (m <= 2) {
    const int q0 = op[8], q1 = m == 2 ? op[9] : 0;
    const float2 w0 = d[0], w1 = d[1];
    const float2 w2 = m == 2 ? d[2] : w0, w3 = m == 2 ? d[3] : w1;
    for (unsigned l = lo + threadIdx.x; l < hi; l += blockDim.x) {
      unsigned idx = bit_of(q0, l, cta_g);
      if (m == 2) idx = (idx << 1) | bit_of(q1, l, cta_g);
      const float2 c = idx == 0 ? w0 : idx == 1 ? w1 : idx == 2 ? w2 : w3;
      float* pr = s.re(l);
      float* pi = s.im(l);
      const float r = *pr, im = *pi;
      *pr = c.x * r - c.y * im;
      *pi = c.x * im + c.y * r;
    }
    return;
  }
  for (unsigned l = lo + threadIdx.x; l < hi; l += blockDim.x) {
    unsigned idx = 0;
    for (int i = 0; i < m; ++i) idx = (idx << 1) | bit_of(op[8 + i], l, cta_g);
    const float2 w = d[idx];
    float* pr = s.re(l);
    float* pi = s.im(l);
    const float r = *pr, im = *pi;
    *pr = w.x * r - w.y * im;
    *pi = w.x * im + w.y * r;
  }
}

// Dense op on M <= NARROW_CORE block qubits, under block-local controls: one
// thread per group of 2^M slots, gathered to registers and multiplied by the
// row-major 2^M x 2^M core, fully unrolled.
template <int M, class S>
__device__ void apply_dense(const S& s, const int* op, const float2* coef,
                            int kbits, Part part) {
  constexpr int D = 1 << M;
  const unsigned lmask = op[3], lval = op[4];
  unsigned offs[D];
#pragma unroll
  for (int j = 0; j < D; ++j) {
    unsigned o = 0;
    for (int i = 0; i < M; ++i)
      if ((j >> (M - 1 - i)) & 1) o |= 1u << op[8 + i];
    offs[j] = o;
  }
  int pos[M];
  for (int i = 0; i < M; ++i) pos[i] = op[24 + i];
  // 1- and 2-qubit cores (4 and 16 coefficients) live in registers; wider
  // cores are read through the cache
  constexpr int NW = M <= 2 ? D * D : 1;
  float2 w[NW];
  const float2* u = coef + op[2];
  if constexpr (M <= 2) {
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = u[j];
  }
  const unsigned groups = 1u << (kbits - M);
  const unsigned lo = part.begin(groups), hi = part.end(groups);
  for (unsigned gi = lo + threadIdx.x; gi < hi; gi += blockDim.x) {
    unsigned base = gi;
    for (int i = 0; i < M; ++i) {  // insert a 0 at each target, ascending
      const unsigned low = base & ((1u << pos[i]) - 1u);
      base = ((base >> pos[i]) << (pos[i] + 1)) | low;
    }
    if ((base & lmask) != lval) continue;
    float xr[D], xi[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xr[j] = *s.re(base | offs[j]);
      xi[j] = *s.im(base | offs[j]);
    }
#pragma unroll
    for (int r = 0; r < D; ++r) {
      float ar = 0.f, ai = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        float2 c2;
        if constexpr (M <= 2) c2 = w[r * D + c];
        else c2 = u[r * D + c];
        ar += c2.x * xr[c] - c2.y * xi[c];
        ai += c2.x * xi[c] + c2.y * xr[c];
      }
      *s.re(base | offs[r]) = ar;
      *s.im(base | offs[r]) = ai;
    }
  }
}

// ---------------------------------------------------------------------------
// Dense op on M >= TILE_CORE block qubits: one tiled complex matrix product
// on the tensor cores.
//
// Replaces, for cores of 5-11 qubits, tpu_qsim/kernels/fused_circuit.py
// ::_emit_gate_generic (fused_circuit.py:569, reached from emit_ops), which
// multiplies the core into the VMEM block on the TPU's matrix unit.
//
// The op is Y = U X, U the 2^M x 2^M core (D = 2^M) and X the D x G matrix
// whose column g holds the amplitudes of group g (the 2^M slots that differ
// only in the targets, under the block-local controls). It runs in tiles of
// TG = min(G, cap / D) groups, as many as the scratch holds: a tile is the
// slots whose bits outside the targets and the tile's lowest free bits are
// fixed, and tiles are split over the CTAs of a Part in turn. Per tile:
//   1. the tile's X is staged from the slots into shared memory, xs[c][g],
//      in the order of slot indices, so a warp's 32 loads are consecutive
//      slots wherever the targets lie (row and group of a slot are linear in
//      its bits: a thread takes its elements in Gray-code order, one table
//      lookup and three XORs each; against a lookup per set bit this took
//      the 26q low sweep's k = 5 / 8 op from 0.54-0.57 to 0.44-0.48 / from
//      2.45-2.50 to 2.32-2.40 ms on the H100). Where the
//      slots lie in device memory (the sweeps) and each of two tiles of
//      cap / 2 takes TILE_RING_GROUPS groups or more, the tiles alternate
//      between two buffers and the next tile's X streams in with cp.async
//      while the warps multiply this one's (26q low sweep, k = 5/6/7/8:
//      0.87/1.11/1.66/2.74 ms without, 0.58/0.76/1.28/2.46 with, on the
//      H100; k = 9, tiles of 16 groups instead of 32: 4.68 against
//      4.83-5.02). One barrier a tile (two without the ring);
//   2. the warps take warp tiles of 8 MT rows x 16 groups in turn and run
//      each over all D columns with no barrier: the product in its real
//      form, on mma.sync m16n8k8 TF32 in 3xTF32 (csrc/tf32.cuh). A k8 step
//      covers 4 complex columns c0..c0+3, its 8 real columns Xr then Xi of
//      the 4; an m16 tile covers 8 complex rows, its 16 real rows Yr then Yi
//      of the 8. So lane (g, q)'s A fragment is (Ur, Ui, -Ui, Ur) of U[row
//      g][c0 + q], U's real embedding [[Ur, -Ui], [Ui, Ur]] built in
//      registers from one complex coefficient as it is loaded, and its B
//      fragment (Xr, Xi) of X[c0 + q][group g], one float2 of xs: the
//      interleaved complex tile is the B operand as it stands. U is read as
//      build_op_table stores it (column-major) from L2 through L1, never
//      stored twice: an m-tile pair's rows interleave, so a lane's two
//      coefficients are one 16-byte load, issued a k8 step ahead; a lane's
//      two n-tiles' X is one 16-byte load too. Each chunk of TILE_CHUNK k8
//      steps (32 columns) runs into fresh accumulators, each term of an
//      m-tile pair over its 4 accumulators before the next term;
//   3. each lane stores its outputs straight to their slots (xs still holds
//      X for the warps that are not done), 16 bytes a plane where a lane's
//      4 groups are adjacent slots.
// xs[c][g] sits at c TGS + (g ^ (4 (c mod 4) & (TGS - 2))), TGS = max(TG, 2):
// the swizzle keeps group pairs whole and puts the 8 lanes of a 16-byte
// load phase on 8 distinct bank quads (TG >= 16). An op with fewer than 16
// groups a tile reads duplicates of its groups into the last warp tile's
// columns past TG and never stores them. Block-local controls fix their bits
// in the group enumeration (no group is skipped).
//
// Instruction: mma.sync, which runs at every CTA size the kernels launch
// (32-1024 threads) beside the block program's shared memory. wgmma reads B
// only from shared memory, in its core-matrix layout and already split (a
// second, twice larger copy of the tile, as dense_pass.cu's large instance
// keeps, which the block kernels cannot hold beside their block), in
// 64-row warpgroup tiles that a 5- or 6-qubit core does not fill. On the
// H100 this op issues 3.1-3.2 cycles per m16n8k8 product per SM at k =
// 8-10 on the 26q low sweep, the dense pass's wgmma 2.1 for the same work.
//
// Bound on this card: 8 flops per complex multiply-add, 8 D per amplitude,
// three TF32 flops per real one over the tensor cores' 495 TFLOP/s; and
// U's re-reads, D^2 x 8 bytes per tile from L2. A kernel gives the op
// `cap` float2 of scratch (a power of two, at least 2 D and at most 32
// threads) and its warp tile: MT = 4 m-tiles where ptxas may give a thread
// 128 registers, 2 at 64 (at 128, MT = 4 took 3.00 / 10.0 ms for k = 8 /
// 10 where MT = 2 took 3.96 / 14.7). Every thread of the CTA must call it.
// It is one non-inlined function, so its registers are allocated apart from
// the surrounding kernel's; its product loop is not a function of its own
// (a call per warp tile cost 10-25%), and the tables every thread computes
// alike live in static shared memory, out of the loop's registers.
// ---------------------------------------------------------------------------
constexpr int TILE_MAX_CORE = 11;
constexpr int TILE_CHUNK = 8;       // k8 steps (32 complex columns) per share
constexpr int TILE_GROUPS = 16;     // a warp tile's groups: two n-tiles of 8
constexpr int TILE_STAGE_BITS = 5;  // elements a thread stages: cap / T <= 32
constexpr int TILE_RING_GROUPS = 16;  // the least groups a tile of a ring of two

template <int MT_>
struct TileScratch {
  static constexpr int MT = MT_;  // m-tiles (8 rows each) of a warp tile
  float2* xs;                     // 16-byte aligned
  unsigned cap;                   // float2 at xs
};

__host__ __device__ constexpr size_t tile_scratch_bytes(unsigned cap) {
  return (size_t)cap * sizeof(float2);
}

// The bits of x placed, ascending, at the set bits of mask.
__device__ __forceinline__ unsigned deposit_bits(unsigned x, unsigned mask) {
  unsigned out = 0;
  while (mask) {
    const unsigned low = mask & (0u - mask);
    if (x & 1u) out |= low;
    x >>= 1;
    mask &= mask - 1u;
  }
  return out;
}

// The bits of x at the set bits of mask, packed ascending.
__device__ __forceinline__ unsigned extract_bits(unsigned x, unsigned mask) {
  unsigned out = 0;
  for (int k = 0; mask; ++k) {
    const int p = __ffs(mask) - 1;
    mask &= mask - 1u;
    out |= ((x >> p) & 1u) << k;
  }
  return out;
}

// Row index of slot bits x under an m-qubit core (op[8] is the row's MSB).
__device__ __forceinline__ unsigned row_of(const int* op, int m, unsigned x) {
  unsigned c = 0;
  for (int i = 0; i < m; ++i) c = (c << 1) | ((x >> op[8 + i]) & 1u);
  return c;
}

// Slot bits of row index r under an m-qubit core (row_of's inverse).
__device__ __forceinline__ unsigned row_slot(const int* op, int m, unsigned r) {
  unsigned l = 0;
  for (int i = 0; i < m; ++i) l |= ((r >> (m - 1 - i)) & 1u) << op[8 + i];
  return l;
}

// The tiled op's own boundaries, for a measurement build (grid_sweep.cu's
// stamp instance): NoTileStamp everywhere else, which compiles to nothing.
// TileStamp(i) at 0: the op's entry; 1: its tables computed, before the
// first tile; 2: this thread's staging of a tile issued; 3: past the
// barrier that publishes the tile's X; 4: its warp's products and stores
// done; 5: past the tile's last barrier (without the ring).
struct NoTileStamp {
  static constexpr bool ON = false;
  __device__ __forceinline__ void operator()(int) const {}
};

template <class S, int MT, class TileStamp = NoTileStamp>
__device__ __noinline__ void apply_dense_tiled(const S& s, const int* op,
                                               const float2* coef, int kbits,
                                               Part part, TileScratch<MT> sc,
                                               TileStamp tile_stamp = {}) {
  constexpr int WR = 8 * MT, WG = TILE_GROUPS;
  constexpr int EB = TILE_STAGE_BITS;
  static_assert(MT % 2 == 0, "m-tiles in interleaved pairs");
  tile_stamp(0);
  // tables every thread computes alike (the staging's bit deltas; a lane's
  // output offsets, the same in every warp), kept out of the product loop's
  // registers
  QSIM_SHARED(uint4, stage_tab, [EB]);
  QSIM_SHARED(unsigned, lane_tab, [32][MT + 4]);
  const int m = op[1];
  const unsigned D = 1u << m;
  const unsigned T = blockDim.x, t = threadIdx.x;
  const int log2t = __ffs(T) - 1;
  unsigned tmask = 0;
  for (int i = 0; i < m; ++i) tmask |= 1u << op[8 + i];
  const unsigned lmask = op[3], lval = op[4];
  const unsigned free = ((1u << kbits) - 1u) & ~(tmask | lmask);
  const int free_bits = __popc(free);
  // slots in device memory, and room for two tiles of TILE_RING_GROUPS
  // groups or more: the next tile's X streams into the second buffer with
  // cp.async while the warps multiply this one's
  const bool ring = S::GLOBAL && (sc.cap >> (m + 1)) >= TILE_RING_GROUPS;
  const unsigned cap = ring ? sc.cap / 2 : sc.cap;
  const int log2tg = min(__ffs(cap) - 1 - m, free_bits);
  // a tile's groups, and its row stride in xs (an op with one group keeps
  // a pair, the second never loaded or stored)
  const unsigned TG = 1u << log2tg, TGS = TG > 2 ? TG : 2;
  // a tile: the lowest log2tg free bits (its groups) and the targets (its
  // rows) vary; the other free bits number the tiles
  unsigned gmask = 0, rest = free;
  for (int k = 0; k < log2tg; ++k) {
    gmask |= rest & (0u - rest);
    rest &= rest - 1u;
  }
  const unsigned pmask = tmask | gmask;
  const unsigned n_tiles = 1u << (free_bits - log2tg);
  const unsigned stride = 1u << part.log2;
  const unsigned count = D << log2tg;  // elements of a tile, at most cap
  const unsigned per_thread = (count + T - 1u) >> log2t;
  const float2* const u = coef + op[2];  // column-major: u[c * D + r]
  const unsigned xs0 = (unsigned)__cvta_generic_to_shared(sc.xs);

  // staging: element t + i T of a tile is slot dep_t ^ (the slot bits of
  // i's bits), row c_t ^ .., group g_t ^ .. (linear in the element's bits):
  // stage_tab[b] holds the slot, row and group bits that bit b flips, and a
  // thread takes its elements in Gray-code order of i, one flip each
  const unsigned dep_t = deposit_bits(t, pmask);
  const unsigned c_t = row_of(op, m, dep_t), g_t = extract_bits(dep_t, gmask);
#pragma unroll
  for (int b = 0; b < EB; ++b) {
    const unsigned dl = deposit_bits(1u << (log2t + b), pmask);
    stage_tab[b] = make_uint4(dl, row_of(op, m, dl), extract_bits(dl, gmask), 0u);
  }
  auto stage = [&](unsigned tile, unsigned xs) {
    if (t >= count) return;  // a tile of fewer elements than threads
    unsigned l = deposit_bits(tile, rest) | lval | dep_t, c = c_t, g = g_t;
#pragma unroll 4
    for (unsigned i = 0; i < per_thread; ++i) {
      if (i) {
        const uint4 d = stage_tab[__ffs(i) - 1];
        l ^= d.x;
        c ^= d.y;
        g ^= d.z;
      }
      const unsigned x = xs + 8u * (c * TGS + (g ^ ((4u * (c & 3u)) & (TGS - 2u))));
      if constexpr (S::GLOBAL) {
        if (ring) {
          cp_async4_at(x, s.re(l));
          cp_async4_at(x + 4u, s.im(l));
          continue;
        }
      }
      sts64(x, *s.re(l), *s.im(l));
    }
  };

  // the product: lane (fg, fq) in mma's fragment terms; warp tile w is rows
  // (w / NB) WR.. and groups (w % NB) WG..
  const unsigned lane = t & 31u, warp = t >> 5, warps = T >> 5;
  const unsigned fg = lane >> 2, fq = lane & 3u;
  const unsigned NB = (TG + WG - 1u) / WG;
  const unsigned n_wtiles = (D / WR) * NB;
  const unsigned steps = D / 4;                     // k8 steps
  const unsigned ustep = 2u * D, xstep = 32u * TGS;  // U float4, X bytes a step
  const unsigned swz = (4u * fq) & (TGS - 2u);      // column c = 4 step + fq
  // the lane's outputs: m-tile i's row fg of the warp tile (slot bits
  // lane_tab[i]) and groups 4 fq + q (lane_tab[MT + q]; q = 2 h + j: n-tile
  // j's column 2 fq + h); where the groups' lowest slot bits are 0 and 1,
  // the 4 groups are 4 adjacent slots
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
      lane_tab[lane][i] = row_slot(op, m, 16u * (i / 2) + 2u * fg + (i & 1));
#pragma unroll
    for (int q = 0; q < 4; ++q) lane_tab[lane][MT + q] = deposit_bits(4u * fq + q, gmask);
  }
  const bool quad = (gmask & 3u) == 3u;
  tile_stamp(1);

  unsigned b = 0;  // the tile's buffer: 0 and 1 in turn with the ring
  if (ring && part.index < n_tiles) {
    stage(part.index, xs0);
    cp_async_commit();
  }
  for (unsigned tile = part.index; tile < n_tiles; tile += stride, b ^= ring) {
    const unsigned xs = xs0 + 8u * b * cap;
    if (ring) cp_async_wait<0>();
    else stage(tile, xs);
    tile_stamp(2);
    // the tile's X is in (and lane_tab); with the ring, every warp is done
    // with the other buffer, which the next tile's copies then take
    __syncthreads();
    tile_stamp(3);
    if (ring && tile + stride < n_tiles) {
      stage(tile + stride, xs0 + 8u * (b ^ 1u) * cap);
      cp_async_commit();
    }
    const unsigned hi = deposit_bits(tile, rest) | lval;
    for (unsigned w = warp; w < n_wtiles; w += warps) {
      const unsigned rbase = (w / NB) * WR, nbase = (w % NB) * WG;
      // lane's U: rows rbase + 16 ii + 2 fg (+ 1), column 4 step + fq; its
      // X: groups nbase + 2 fg (+ 1), the same column
      const float4* const up = reinterpret_cast<const float4*>(u + fq * D + rbase + 2u * fg);
      const unsigned xa = xs + 8u * (fq * TGS + (((nbase + 2u * fg) & (TGS - 1u)) ^ swz));
      float acc[MT][2][4], sh[MT][2][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
      float4 un[MT / 2];
#pragma unroll
      for (int ii = 0; ii < MT / 2; ++ii) un[ii] = __ldg(up + 8 * ii);
      for (unsigned s0 = 0; s0 < steps; s0 += TILE_CHUNK) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) sh[i][j][v] = 0.f;
#pragma unroll
        for (int ss = 0; ss < TILE_CHUNK; ++ss) {
          const unsigned st = s0 + ss;
          const float4 xv = lds128(xa + st * xstep);
          uint32_t bh[2][2], bl[2][2];  // n-tile j: (Xr, Xi) of group 2 fg + j
          split(__float_as_uint(xv.x), bh[0][0], bl[0][0]);
          split(__float_as_uint(xv.y), bh[0][1], bl[0][1]);
          split(__float_as_uint(xv.z), bh[1][0], bl[1][0]);
          split(__float_as_uint(xv.w), bh[1][1], bl[1][1]);
#pragma unroll
          for (int ii = 0; ii < MT / 2; ++ii) {  // m-tiles 2 ii + e: rows 16 ii + 2 fg + e
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              uint32_t rh, rl, ih, il;
              split(__float_as_uint(e ? un[ii].z : un[ii].x), rh, rl);
              split(__float_as_uint(e ? un[ii].w : un[ii].y), ih, il);
              ah[e][0] = ah[e][3] = rh;
              ah[e][1] = ih;
              ah[e][2] = ih ^ SIGN_BIT;
              al[e][0] = al[e][3] = rl;
              al[e][1] = il;
              al[e][2] = il ^ SIGN_BIT;
            }
            if (st + 1u < steps)  // the next step's U, from L2 through L1
              un[ii] = __ldg(up + (st + 1u) * ustep + 8 * ii);
            // small terms first, each term over the pair's 4 accumulators
            // before the next
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int j = 0; j < 2; ++j) mma(sh[2 * ii + e][j], al[e], bh[j][0], bh[j][1]);
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int j = 0; j < 2; ++j) mma(sh[2 * ii + e][j], ah[e], bl[j][0], bl[j][1]);
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int j = 0; j < 2; ++j) mma(sh[2 * ii + e][j], ah[e], bh[j][0], bh[j][1]);
          }
        }
        add_share(acc, sh);
      }
      // m-tile i, n-tile j: acc[i][j] = (Yr, Yr, Yi, Yi) of row fg, groups
      // 2 (2 fq + h) + j for h = 0, 1
      const int valid = (int)TG - (int)(nbase + 4u * fq);
      if (valid <= 0) continue;
      const unsigned base = hi | row_slot(op, m, rbase) | deposit_bits(nbase, gmask);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned l = base | lane_tab[lane][i];
        if (quad) {
          const unsigned lq = l | lane_tab[lane][MT];
          *reinterpret_cast<float4*>(s.re(lq)) =
              make_float4(acc[i][0][0], acc[i][1][0], acc[i][0][1], acc[i][1][1]);
          *reinterpret_cast<float4*>(s.im(lq)) =
              make_float4(acc[i][0][2], acc[i][1][2], acc[i][0][3], acc[i][1][3]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (q >= valid) break;
            const unsigned lq = l | lane_tab[lane][MT + q];
            *s.re(lq) = acc[i][q & 1][q >> 1];
            *s.im(lq) = acc[i][q & 1][2 + (q >> 1)];
          }
        }
      }
    }
    tile_stamp(4);
    if (!ring) __syncthreads();  // the next tile's staging overwrites xs
    tile_stamp(5);
  }
}

// MAXM is the widest dense core a kernel instance takes: each kernel is
// built for NARROW_CORE (every core unrolls fully, and no code for a wider
// one is inlined) and for MAX_CORE, and the host launches the narrow
// instance when the table's widest core allows it. A kernel calls
// check_core_width once before its ops, so a table too wide for the
// instance traps instead of skipping ops; the ops themselves do not check.
constexpr int MAX_CORE = TILE_MAX_CORE;

// Whether a launch of `threads` threads per CTA can run a table whose widest
// core is `max_core`: the tiled op needs a power of two with 2^max_core <=
// 4 threads (each kernel's scratch, 8 threads float2 or more, then holds a
// tile of two or more groups).
inline bool threads_fit_core(int threads, int max_core) {
  if (max_core < TILE_CORE) return true;
  return max_core <= MAX_CORE && threads >= 32 && (threads & (threads - 1)) == 0 &&
         (1 << max_core) <= 4 * threads;
}

template <int MAXM>
__device__ __forceinline__ void check_core_width(const int* table) {
  if (table[HEADER_MAX_CORE] > MAXM) __trap();
}

// One op of the table. Out-of-block controls (words 5, 6) are uniform over
// the CTA and skip it whole. `scratch` is the tiled op's TileScratch (only
// the wide instance reads it), `tile_stamp` its stamps (a measurement
// build's).
template <int MAXM, class S, class Scratch, class TileStamp = NoTileStamp>
__device__ void apply_op(const S& s, const int* op, const float2* coef,
                         int kbits, unsigned cta_g, Part part,
                         const Scratch& scratch,
                         const TileStamp& tile_stamp = TileStamp()) {
  if ((cta_g & (unsigned)op[5]) != (unsigned)op[6]) return;
  if (op[0] == KIND_DIAG) {
    apply_diag(s, op, coef, kbits, cta_g, part);
    return;
  }
  switch (op[1]) {
    case 1: apply_dense<1>(s, op, coef, kbits, part); break;
    case 2: apply_dense<2>(s, op, coef, kbits, part); break;
    case 3: apply_dense<3>(s, op, coef, kbits, part); break;
    case 4: apply_dense<4>(s, op, coef, kbits, part); break;
    default:  // only the wide instance has code for these widths
      if constexpr (MAXM > NARROW_CORE)
        apply_dense_tiled(s, op, coef, kbits, part, scratch, tile_stamp);
      break;
  }
}

}  // namespace qsim
