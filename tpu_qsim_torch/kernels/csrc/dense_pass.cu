// Dense pass: one gate's dense core applied to the whole state in one
// launch: cores too wide for the op table's tiled op (12 qubits and more),
// and the 7-11-qubit cores the route cuts (kernels/dispatch.py: from 10
// qubits on every row, from 5 on the grid row from 22 qubits, and every
// gate the grid planner refuses there; a 5-6-qubit core widened to 7).
//
// Replaces, for such cores, tpu_qsim/kernels/fused_circuit.py
// ::_emit_gate_generic (fused_circuit.py:569-621, reached from emit_ops
// inside every TPU kernel of tpu_qsim), which has no width limit there: the
// TPU kernel multiplies the core into its VMEM block. Here a core of 2^k x
// 2^k complex64 coefficients is 128 MB or more at k = 12, so an op inside a
// block kernel would reread it from device memory for every block; instead
// the route's kernels stop before the gate, this pass runs, and they go on
// after it (kernels/dispatch.py's split).
//
// The pass is Y = U X out of place, from the (2, 2^n) float32 planes `in`
// to `out`:
//   - U is the core with its index bits in ascending state-bit order (bit j
//     of a row or column index is the j-th lowest target bit; the host,
//     kernels/dense_pass.py::core_operand, permutes the gate's matrix so),
//     stored as two row-major float32 planes Ur and Ui;
//   - column g of X holds the 2^k amplitudes of group g: the slots whose
//     bits outside the targets and controls are those of g (deposited at
//     the free bits) and whose control bits hold the control values. Groups
//     whose controls fail are copied from `in` to `out` unchanged, by CTAs
//     of their own after the product's (a kernel of its own after the
//     stream instance);
//   - the product runs on the tensor cores in its real form on the planes,
//     Yr = Ur Xr - Ui Xi and Yi = Ui Xr + Ur Xi, TF32 products accumulated
//     in float32 (mma.sync m16n8k8, or wgmma m64n64k8 in the large
//     instance), in 3xTF32 (csrc/tf32.cuh: every operand split in
//     registers into a TF32 high part and its remainder, three tensor-core
//     products per real one, each chunk's share in fresh accumulators): U
//     is split as it is read, never stored twice (at 16 qubits U's bytes
//     set the bound); a 4096-term sum in one accumulator drifted past the
//     1e-7 gate against float32 FMAs at 16 and 22 qubits on the H100;
//   - a CTA owns a tile of BM rows x BN groups (fewer groups when the state
//     has fewer; the columns past them are computed from whatever the
//     shared memory holds and never stored). The mma.sync instances' warps
//     are WM x WN x WK: each computes MT x NT fragments of 16 rows x 8
//     groups over its share WK of each chunk's columns (the shares summed
//     through shared memory at the end). U and X stream through a ring of STAGES chunks of BK
//     columns in dynamic shared memory, fed by cp.async: U's rows 16 bytes
//     at a time, X's chunk gathered from the state in the order of slot
//     indices (consecutive threads on consecutive slots wherever the
//     targets lie), 16 bytes at a time where the two lowest targets are
//     state bits 0 and 1, else 4. Rows of the shared tiles are BK + 4 floats
//     apart, so every fragment load of a warp falls on 32 distinct banks.
//     The output tile goes through shared memory and out in slot order too.
// Four instances. "stream" (below), persistent CTAs of 12 warps for cores
// of 7-9 qubits over many groups. Three of 8 warps: "large", 128 rows x 64
// groups, BK = 32,
// 3 stages, for states with many groups, where the tensor cores' rate bounds
// it: two warpgroups of 64 rows, each issuing wgmma m64n64k8 with U's split
// fragments in registers (-Ui by the instruction's A scale; two sets, the
// next k8 step's made while one group of 12 products runs) and X's chunk
// split once into four TF32 planes in shared memory (wgmma reads B only
// there), in the K-major layout of 8 x 16-byte core matrices (on the H100
// 1.6 ms at n = 22, k = 12, where mma.sync warps of 32 x 32 took 2.1; at
// k = 7-9 its short-lived CTAs ran at 15-36% of the bound, which the stream
// instance was made for);
// "small", 32 rows x 16 groups (mma.sync warps of 16 x 16, two on the rows,
// four on the columns of a chunk), BK = 128, 4 stages, for 16 groups or
// fewer, where U's bytes bound it and 2^k / 32 CTAs each keep 3 chunks of U
// (96 KB) in flight; "medium", 32 rows x 64 groups (mma.sync warps of 32 x
// 16, four on the groups, two on the columns), BK = 64, 4 stages, between
// them (32-64 groups at k = 12: each CTA reads its rows of U once for all
// the groups, and 2^k / 32 CTAs fill the card). All take cores of 7 qubits
// and more (a chunk of BK columns, a tile of BM rows). The host
// (kernels/dense_pass.py::pass_instance) picks one.
//
// Bound on this card: the larger of U's bytes plus 16 B per amplitude (the
// state read and written once) over 3.35 TB/s and 8 flops per complex
// multiply-add, 8 x 2^(n + k): over 67 TFLOP/s of float32 FMAs (the bound
// of any float32 design without tensor cores: 2.05 ms at n = 22, k = 12),
// and, for this design, three times as many TF32 flops over the 495 TFLOP/s
// of the tensor cores (0.83 ms at n = 22). At n = 16, k = 12 U's 128 MB set
// it (0.04 ms).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ops.cuh"
#include "ptx.cuh"
#include "tf32.cuh"

namespace {

using namespace qsim;

struct Pass {
  const float* re;  // in
  const float* im;
  float* ore;  // out
  float* oim;
  const float* ur;        // 2^k x 2^k, row-major, ascending index bits
  const float* ui;
  unsigned tmask;         // the target bits
  unsigned cmask, cval;   // the control bits and their values
  unsigned free;          // the other bits of the state: the group bits
  int k;
  unsigned groups;        // 2^popcount(free)
  unsigned dim;           // 2^n
  unsigned gemm_ctas;     // CTAs of the product; the rest copy
};

__host__ __device__ constexpr int ilog2(int x) { return x > 1 ? 1 + ilog2(x / 2) : 0; }

// The lowest `count` set bits of mask.
__device__ __forceinline__ unsigned low_bits(unsigned mask, int count) {
  unsigned out = 0;
  for (int i = 0; i < count; ++i) {
    out |= mask & (0u - mask);
    mask &= mask - 1u;
  }
  return out;
}

// A CTA's tile of the product (BM rows of U from r0, BN groups from g0, the
// group tiles of a row tile launched together, so U's rows come from device
// memory about once) and how its chunks of BK columns are loaded: U's rows
// 16 bytes at a time, X's chunk gathered in the order of slot indices
// (4 consecutive slots at once where the two lowest targets are bits 0-1).
// Shared tiles: Ur, Ui [BM][S] then Xr, Xi [BN][S] per ring slot.
template <int BM, int BN, int BK, int THREADS>
struct Tile {
  static constexpr int S = BK + 4;  // floats from one tile row to the next
  static constexpr int U_FLOATS = 2 * BM * S;
  static constexpr int STAGE = U_FLOATS + 2 * BN * S;
  static constexpr int UC = 2 * BM * BK / 4 / THREADS;            // U's 16-byte copies a thread
  static constexpr int XE = (BK * BN + THREADS - 1) / THREADS;    // X's elements a thread
  static_assert(UC * THREADS * 4 == 2 * BM * BK, "U's chunk split evenly");
  static_assert(S % 32 == 4 && S % 4 == 0, "conflict-free, 16-byte aligned rows");
  static_assert(BM <= 128 && BK <= 128, "cores of 7 qubits and more");

  const Pass p;
  unsigned D, r0, gbase, tlow, flow, thigh, xcount;
  int log2tg;
  bool quads;
  unsigned xl[XE], xo[XE];  // slot bits in the chunk; offset g * S + c in a plane

  __device__ __forceinline__ Tile(const Pass& pass, unsigned t) : p(pass) {
    D = 1u << p.k;
    log2tg = min(__popc(p.free), ilog2(BN));  // this tile's groups
    const unsigned group_tiles = 1u << (__popc(p.free) - log2tg);
    r0 = (blockIdx.x / group_tiles) * BM;
    gbase = deposit_bits((blockIdx.x % group_tiles) * BN, p.free) | p.cval;
    // X's chunk: BK columns (the lowest log2(BK) target bits vary) x
    // 2^log2tg groups (the lowest log2tg free bits), element e at the e-th
    // slot in order
    tlow = low_bits(p.tmask, ilog2(BK));
    flow = low_bits(p.free, log2tg);
    thigh = p.tmask & ~tlow;
    quads = (p.tmask & 3u) == 3u;
    xcount = (unsigned)BK << log2tg >> (quads ? 2 : 0);
#pragma unroll
    for (int i = 0; i < XE; ++i) {
      const unsigned l = deposit_bits(quads ? 4 * (t + i * THREADS) : t + i * THREADS, tlow | flow);
      xl[i] = l;
      xo[i] = extract_bits(l, flow) * S + extract_bits(l, tlow);
    }
  }

  // start the copies of chunk c into the ring slot at `us`, one cp.async group
  __device__ __forceinline__ void load(float* us, unsigned c, unsigned t) const {
    float* xs = us + U_FLOATS;
#pragma unroll
    for (int i = 0; i < UC; ++i) {  // 16 bytes of a row of Ur or Ui
      const unsigned e = t + i * THREADS;
      const unsigned plane = e / (BM * BK / 4), rest = e % (BM * BK / 4);
      const unsigned row = rest / (BK / 4), q = rest % (BK / 4);
      const float* src = (plane ? p.ui : p.ur) + (size_t)(r0 + row) * D + c * BK + 4 * q;
      cp_async16(us + plane * BM * S + row * S + 4 * q, src);
    }
    const unsigned hi = gbase | deposit_bits(c, thigh);
#pragma unroll
    for (int i = 0; i < XE; ++i) {
      if (t + i * THREADS >= xcount) break;
      const unsigned l = hi | xl[i];
      if (quads) {
        cp_async16(xs + xo[i], p.re + l);
        cp_async16(xs + BN * S + xo[i], p.im + l);
      } else {
        cp_async4(xs + xo[i], p.re + l);
        cp_async4(xs + BN * S + xo[i], p.im + l);
      }
    }
    cp_async_commit();
  }

  // the output tile ys[row * YS + g] (two planes, yi = yr + BM * YS) out in
  // slot order: BM rows (the lowest log2(BM) target bits) x the groups
  template <int YS>
  __device__ __forceinline__ void store(const float* yr, unsigned t) const {
    const unsigned rlow = low_bits(p.tmask, ilog2(BM));
    const unsigned ymask = rlow | flow;
    const unsigned yhi = gbase | deposit_bits(r0, p.tmask);
    const unsigned ycount = (unsigned)BM << log2tg;
    for (unsigned e = t; e < ycount; e += THREADS) {
      const unsigned l = deposit_bits(e, ymask);
      const unsigned y = extract_bits(l, rlow) * YS + extract_bits(l, flow);
      p.ore[yhi | l] = yr[y];
      p.oim[yhi | l] = yr[BM * YS + y];
    }
  }
};

// CTAs past the product's copy the groups whose controls fail.
__device__ __forceinline__ void copy_failing(const Pass& p, unsigned threads) {
  const unsigned stride = (gridDim.x - p.gemm_ctas) * threads;
  for (unsigned l = (blockIdx.x - p.gemm_ctas) * threads + threadIdx.x; l < p.dim; l += stride)
    if ((l & p.cmask) != p.cval) {
      p.ore[l] = __ldg(p.re + l);
      p.oim[l] = __ldg(p.im + l);
    }
}

// ---------------------------------------------------------------------------
// mma.sync instances: warps of MT x NT fragments of 16 x 8
// ---------------------------------------------------------------------------

template <int WM_, int WN_, int WK_, int MT_, int NT_, int BK_, int STAGES_>
struct Shape {
  static constexpr int WM = WM_, WN = WN_, WK = WK_, MT = MT_, NT = NT_;
  static constexpr int BK = BK_, STAGES = STAGES_;
  static constexpr int THREADS = 32 * WM * WN * WK;
  static constexpr int BM = WM * MT * 16;  // rows of a tile
  static constexpr int BN = WN * NT * 8;   // groups of a tile
  using T = Tile<BM, BN, BK, THREADS>;
  static constexpr int S = T::S;
  static constexpr int ACC = MT * NT * 4;      // accumulators per thread and plane
  static constexpr int RED = (WK - 1) * WM * WN * 2 * ACC * 32;  // the shares past the first
  static constexpr int YS = BN + 4;            // floats from one output row to the next
  static constexpr int EPI = RED + 2 * BM * YS;
  static constexpr int FLOATS = STAGES * T::STAGE > EPI ? STAGES * T::STAGE : EPI;
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
  static constexpr int KSTEPS = BK / 8 / WK;                      // k8 steps a warp a chunk
  static_assert(KSTEPS * 8 * WK == BK, "columns split evenly");
};

using Medium = Shape<1, 4, 2, 2, 2, 64, 4>;
using Small = Shape<2, 1, 4, 1, 2, 128, 4>;

template <class SH>
__global__ void __launch_bounds__(SH::THREADS, 1) dense_pass_kernel(const Pass p) {
  constexpr int BM = SH::BM, BN = SH::BN, S = SH::S;
  constexpr int STAGES = SH::STAGES, MT = SH::MT, NT = SH::NT;
  QSIM_DYNAMIC_SHARED(float4, dyn_smem);
  float* smem = reinterpret_cast<float*>(dyn_smem);
  const unsigned t = threadIdx.x;
  if (blockIdx.x >= p.gemm_ctas) {
    copy_failing(p, SH::THREADS);
    return;
  }
  const typename SH::T tile(p, t);
  const unsigned chunks = tile.D / SH::BK;

  const unsigned lane = t % 32, warp = t / 32;
  const unsigned wm = warp % SH::WM, wn = (warp / SH::WM) % SH::WN;
  const unsigned wk = warp / (SH::WM * SH::WN);
  const unsigned fg = lane / 4, ft = lane % 4;  // the fragments' groupID, thread in group
  float accr[MT][NT][4], acci[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) accr[i][j][v] = acci[i][j][v] = 0.f;
  // ldmatrix row addresses: A tile l / 8 is rows + 8 (l & 8), columns + 4
  // (l & 16); B tile l / 8 is Xr (l < 16) or Xi, columns + 4 (l & 8)
  const unsigned arow = (wm * MT * 16 + (lane & 8) + (lane & 7)) * S + (lane & 16 ? 4 : 0);
  const unsigned brow = (lane & 16 ? BN * S : 0) + (wn * NT * 8 + (lane & 7)) * S +
                        (lane & 8 ? 4 : 0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if ((unsigned)s < chunks) tile.load(smem + s * SH::T::STAGE, s, t);
    else cp_async_commit();
  }
  for (unsigned c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // chunk c is in; every warp is done with chunk c - 1's slot
    if (c + STAGES - 1 < chunks)
      tile.load(smem + (c + STAGES - 1) % STAGES * SH::T::STAGE, c + STAGES - 1, t);
    else
      cp_async_commit();
    const float* us = smem + (c % STAGES) * SH::T::STAGE;
    const float* xs = us + SH::T::U_FLOATS;
    float tr[MT][NT][4], ti[MT][NT][4];  // this chunk's share
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) tr[i][j][v] = ti[i][j][v] = 0.f;
#pragma unroll
    for (int ks = 0; ks < SH::KSTEPS; ++ks) {
      const int k0 = (wk * SH::KSTEPS + ks) * 8;
      uint32_t arh[MT][4], arl[MT][4], aih[MT][4], ail[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {  // rows fg (+ 8), columns ft (+ 4)
        uint32_t r[4], m[4];
        ldmatrix4(r, us + arow + i * 16 * S + k0);
        ldmatrix4(m, us + BM * S + arow + i * 16 * S + k0);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          split(r[v], arh[i][v], arl[i][v]);
          split(m[v], aih[i][v], ail[i][v]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // group fg, columns ft (+ 4): Xr, then Xi
        uint32_t b[4], bh[4], bl[4];
        ldmatrix4(b, xs + brow + j * 8 * S + k0);
#pragma unroll
        for (int v = 0; v < 4; ++v) split(b[v], bh[v], bl[v]);
        const uint32_t nh0 = bh[2] ^ 0x80000000u, nh1 = bh[3] ^ 0x80000000u;
        const uint32_t nl0 = bl[2] ^ 0x80000000u, nl1 = bl[3] ^ 0x80000000u;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          // Yr += Ur Xr - Ui Xi, Yi += Ui Xr + Ur Xi: small terms first
          mma(tr[i][j], arl[i], bh[0], bh[1]);
          mma(tr[i][j], arh[i], bl[0], bl[1]);
          mma(tr[i][j], ail[i], nh0, nh1);
          mma(tr[i][j], aih[i], nl0, nl1);
          mma(tr[i][j], arh[i], bh[0], bh[1]);
          mma(tr[i][j], aih[i], nh0, nh1);
          mma(ti[i][j], ail[i], bh[0], bh[1]);
          mma(ti[i][j], aih[i], bl[0], bl[1]);
          mma(ti[i][j], arl[i], bh[2], bh[3]);
          mma(ti[i][j], arh[i], bl[2], bl[3]);
          mma(ti[i][j], aih[i], bh[0], bh[1]);
          mma(ti[i][j], arh[i], bh[2], bh[3]);
        }
      }
    }
    add_share(accr, tr, acci, ti);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free

  // the WK shares of the columns: the others' accumulators via shared memory
  const unsigned wmn = warp % (SH::WM * SH::WN);
  if constexpr (SH::WK > 1) {
    float* red = smem + ((wk - 1) * SH::WM * SH::WN + wmn) * 2 * SH::ACC * 32 + lane;
    if (wk > 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int a = (i * NT + j) * 4 + v;
            red[a * 32] = accr[i][j][v];
            red[(SH::ACC + a) * 32] = acci[i][j][v];
          }
    }
    __syncthreads();
    if (wk == 0) {
#pragma unroll
      for (unsigned w = 1; w < SH::WK; ++w) {
        const float* r = smem + ((w - 1) * SH::WM * SH::WN + wmn) * 2 * SH::ACC * 32 + lane;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int a = (i * NT + j) * 4 + v;
              accr[i][j][v] += r[a * 32];
              acci[i][j][v] += r[(SH::ACC + a) * 32];
            }
      }
    }
  }
  // the output tile, ys[row][g] in two planes after the reduction's space
  float* ysr = smem + SH::RED;
  if (wk == 0) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {  // row fg (+ 8), groups 2 ft (+ 1)
          const unsigned row = wm * MT * 16 + i * 16 + fg + (v >> 1) * 8;
          const unsigned g = wn * NT * 8 + j * 8 + 2 * ft + (v & 1);
          ysr[row * SH::YS + g] = accr[i][j][v];
          ysr[BM * SH::YS + row * SH::YS + g] = acci[i][j][v];
        }
  }
  __syncthreads();
  tile.template store<SH::YS>(ysr, t);
}

// ---------------------------------------------------------------------------
// The large instance: wgmma, two warpgroups of 64 rows x 64 groups
// ---------------------------------------------------------------------------

// Descriptor of a K-major TF32 operand in shared memory without swizzle:
// 8 x 16-byte core matrices, LBO bytes apart along K and 128 along N.
template <unsigned LBO = 1024>
__device__ __forceinline__ uint64_t smem_desc(const float* base) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(base);
  return (uint64_t)((a >> 4) & 0x3fffu) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

struct Large {
  static constexpr int THREADS = 256, BM = 128, BN = 64, BK = 32, STAGES = 3;
  using T = Tile<BM, BN, BK, THREADS>;
  static constexpr int S = T::S;
  static constexpr int PART = BN * BK;   // one of X's four TF32 planes, canonical
  static constexpr int YS = BN + 4;
  static constexpr int MAIN = STAGES * T::STAGE + 4 * PART;
  static constexpr int FLOATS = MAIN > 2 * BM * YS ? MAIN : 2 * BM * YS;
  static constexpr size_t SMEM = sizeof(float) * FLOATS;
  static_assert(BN == 64 && BK % 8 == 0, "m64n64k8 products");
};

__global__ void __launch_bounds__(Large::THREADS, 1) dense_pass_wgmma(const Pass p) {
  using SH = Large;
  constexpr int BM = SH::BM, BN = SH::BN, BK = SH::BK, S = SH::S, STAGES = SH::STAGES;
  QSIM_DYNAMIC_SHARED(float4, dyn_smem);
  float* smem = reinterpret_cast<float*>(dyn_smem);
  const unsigned t = threadIdx.x;
  if (blockIdx.x >= p.gemm_ctas) {
    copy_failing(p, SH::THREADS);
    return;
  }
  const SH::T tile(p, t);
  const unsigned chunks = tile.D / BK;
  float* xt = smem + STAGES * SH::T::STAGE;  // Xr hi, Xr lo, Xi hi, Xi lo

  const unsigned lane = t % 32, warp = t / 32;
  const unsigned fg = lane / 4, ft = lane % 4;
  // A's ldmatrix rows: the warp's 16 of its warpgroup's 64
  const unsigned arow = (warp * 16 + (lane & 8) + (lane & 7)) * S + (lane & 16 ? 4 : 0);
  float accr[32], acci[32], tr[32], ti[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) accr[i] = acci[i] = tr[i] = ti[i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if ((unsigned)s < chunks) tile.load(smem + s * SH::T::STAGE, s, t);
    else cp_async_commit();
  }
  for (unsigned c = 0; c < chunks; ++c) {
    cp_async_wait<STAGES - 2>();
    // chunk c is in; every warpgroup's products of chunk c - 1 are done
    // (each waits for its own), so its slot and xt are free
    __syncthreads();
    if (c + STAGES - 1 < chunks)
      tile.load(smem + (c + STAGES - 1) % STAGES * SH::T::STAGE, c + STAGES - 1, t);
    else
      cp_async_commit();
    const float* us = smem + (c % STAGES) * SH::T::STAGE;
    {  // X's chunk into four TF32 planes, 8 x 4 core matrices (k / 4, n / 8)
      const float* xs = us + SH::T::U_FLOATS;
      for (unsigned i = t; i < 2 * BN * BK / 4; i += SH::THREADS) {
        const unsigned plane = i / (BN * BK / 4), rest = i % (BN * BK / 4);
        const unsigned n = rest % BN, kq = rest / BN;
        const float4 v = *reinterpret_cast<const float4*>(xs + plane * BN * S + n * S + 4 * kq);
        uint4 h, l;
        split(__float_as_uint(v.x), h.x, l.x);
        split(__float_as_uint(v.y), h.y, l.y);
        split(__float_as_uint(v.z), h.z, l.z);
        split(__float_as_uint(v.w), h.w, l.w);
        const unsigned o = (kq * (BN / 8) + n / 8) * 32 + (n % 8) * 4;
        *reinterpret_cast<uint4*>(xt + 2 * plane * SH::PART + o) = h;
        *reinterpret_cast<uint4*>(xt + (2 * plane + 1) * SH::PART + o) = l;
      }
      // the generic proxy's writes, before wgmma reads them
      fence_proxy_async();
      __syncthreads();
    }
    // U's fragments of k8 step ks, split: rh, rl, ih, il; two sets, so that
    // the next step's are made while the tensor cores run this one's
    uint32_t a[2][4][4];
    auto prepare = [&](int ks, uint32_t (&f)[4][4]) {
      uint32_t r[4], m[4];
      ldmatrix4(r, us + arow + ks * 8);
      ldmatrix4(m, us + BM * S + arow + ks * 8);
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        split(r[v], f[0][v], f[1][v]);
        split(m[v], f[2][v], f[3][v]);
      }
    };
    prepare(0, a[0]);
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const uint32_t(&f)[4][4] = a[ks & 1];
      const float* xk = xt + ks * 2 * (BN / 8) * 32;  // core matrices 2 ks, 2 ks + 1
      const uint64_t xrh = smem_desc(xk), xrl = smem_desc(xk + SH::PART);
      const uint64_t xih = smem_desc(xk + 2 * SH::PART), xil = smem_desc(xk + 3 * SH::PART);
      const int keep = ks > 0;  // this chunk's share starts afresh
      fence_operands(tr);
      fence_operands(ti);
      wgmma_fence();
      // Yr += Ur Xr - Ui Xi, Yi += Ui Xr + Ur Xi: small terms first
      wgmma<1>(tr, f[1], xrh, keep);
      wgmma<1>(tr, f[0], xrl, 1);
      wgmma<-1>(tr, f[3], xih, 1);
      wgmma<-1>(tr, f[2], xil, 1);
      wgmma<1>(tr, f[0], xrh, 1);
      wgmma<-1>(tr, f[2], xih, 1);
      wgmma<1>(ti, f[3], xrh, keep);
      wgmma<1>(ti, f[2], xrl, 1);
      wgmma<1>(ti, f[1], xih, 1);
      wgmma<1>(ti, f[0], xil, 1);
      wgmma<1>(ti, f[2], xrh, 1);
      wgmma<1>(ti, f[0], xih, 1);
      wgmma_commit();
      // the step before is done, and with it the other set of fragments
      wgmma_wait<1>();
      fence_operands(a[(ks + 1) & 1]);
      if (ks + 1 < BK / 8) prepare(ks + 1, a[(ks + 1) & 1]);
    }
    wgmma_wait<0>();
    fence_operands(a[(BK / 8 - 1) & 1]);
    fence_operands(tr);
    fence_operands(ti);
    add_share(accr, tr, acci, ti);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* ysr = smem;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) {  // row fg (+ 8) of the warp's 16, groups 8 j + 2 ft (+ 1)
      const unsigned row = warp * 16 + fg + (v >> 1) * 8;
      const unsigned g = j * 8 + 2 * ft + (v & 1);
      ysr[row * SH::YS + g] = accr[4 * j + v];
      ysr[BM * SH::YS + row * SH::YS + g] = acci[4 * j + v];
    }
  __syncthreads();
  tile.store<SH::YS>(ysr, t);
}

// ---------------------------------------------------------------------------
// The stream instance: persistent CTAs, U's rows on chip, one producer
// warpgroup feeding two wgmma warpgroups through an mbarrier ring
// ---------------------------------------------------------------------------

// For cores of 7-9 qubits over many groups. A CTA owns BM = 128 of U's
// rows for its life (r0 = BM (b % RT), RT = 2^k / BM row tiles) and walks
// the group tiles b / RT, b / RT + C / RT, ... (C CTAs, one an SM): the RT
// CTAs that share a group tile take it at the same step of their walks, so
// the state's tile comes from device memory once and from L2 for the
// others. A tile is BN = 128 groups (the lowest 7 free bits; all of them
// where the state has fewer), taken in stages of BK = 8 columns, one k8
// step.
//
// Warpgroups 0 and 1 consume: each multiplies its 64 rows by the 128 groups
// of a stage, wgmma m64n128k8 with U's fragments split in registers, the
// accumulators kept over the tile's 2^k / 8 stages (at most 512 terms: the
// 4096-term drift of one accumulator chain does not arise, so no
// fresh-accumulator shares), then stored from registers. Warpgroup 2
// produces: each thread copies its own cells of a stage's X (16 bytes at a
// time where the two lowest targets are bits 0-1, else 4) into its own
// slots of a ring of `depth` raw stages with cp.async, so that `depth`
// stages' loads are in flight with no registers held; when its stage has
// landed it splits the values into four TF32 planes and stores them in
// wgmma's K-major layout (4 BN floats from one 4-column half of the stage
// to the other, 4 floats from group to group) in a ring of `stages` slots:
// full[s] (128 producer arrivals, after each thread's proxy fence) and
// empty[s] (one arrival of each consumer warp, after its products). The
// producer's instructions set the pace (variants of this source measured
// on the H100, PERF.md), so it deposits a tile's bits once a tile and
// counts the chunk's bits up in place.
//
// U's rows sit in shared memory for the CTA's life where they fit (rows of
// 2^k + 4 floats a plane: 135 KB at k = 7); past that each stage carries
// its 8 columns of them (rows of 12 floats) through the raw ring too, from
// L2, U's bytes as many as X's. (A tile of 64 rows x 256 groups keeps U's
// rows on chip at k = 8 too, 133 KB; on the H100 it ran 9-14% slower than
// this one with U streamed, PERF.md.) Rows of U are 16 bytes (mod 128)
// apart in both, so the fragments' ldmatrix reads fall on distinct banks.
struct Stream {
  static constexpr int THREADS = 384;  // warpgroups 0-1 consume, 2 produces
  static constexpr int BM = 128, BN = 128, BK = 8;
  static constexpr int PLANE = BK * BN;       // floats of one of X's TF32 planes
  static constexpr int X_FLOATS = 4 * PLANE;  // Xr hi, Xr lo, Xi hi, Xi lo
  static constexpr int SU_CHUNK = BK + 4;     // a streamed chunk's row of U
  static constexpr int MAX_STAGES = 3, MAX_DEPTH = 6;
  static constexpr int CELLS = 2;             // a producer thread's (4-column half, group) cells
  static constexpr int U_UNITS = 2 * (BM / 64);  // a streamed chunk's float4s a producer thread
  static constexpr size_t SMEM_LIMIT = 232448;
  // past the rings and U: the barriers, then the epilogue's 16 group offsets
  static constexpr size_t TAIL = 2 * MAX_STAGES * 8 + 16 * 4;

  int k, stages, depth;
  bool resident;
  unsigned su, stage_floats, u_floats, units;

  // U resident where its rows fit beside two stages of each ring
  __host__ __device__ static constexpr bool fits(int k) {
    return 4 * 2 * BM * ((1 << k) + 4) + 2 * 4 * X_FLOATS + 2 * 16 * 128 * 2 * CELLS + TAIL <=
           SMEM_LIMIT;
  }
  __host__ __device__ explicit Stream(int k_) : k(k_), resident(fits(k_)) {
    su = resident ? (1u << k) + 4 : SU_CHUNK;
    u_floats = resident ? 2 * BM * su : 0;
    stage_floats = X_FLOATS + (resident ? 0 : 2 * BM * SU_CHUNK);
    // a raw stage: each producer thread's float4 units, one a cell and
    // plane, and U_UNITS of U's chunk where it streams
    units = 2 * CELLS + (resident ? 0 : U_UNITS);
    const size_t room = SMEM_LIMIT - TAIL - 4 * (size_t)u_floats;
    const size_t stage_bytes = 4 * (size_t)stage_floats, raw_bytes = 16 * 128 * (size_t)units;
    stages = room >= MAX_STAGES * stage_bytes + 2 * raw_bytes ? MAX_STAGES : 2;
    const size_t d = (room - stages * stage_bytes) / raw_bytes;
    depth = d < MAX_DEPTH ? (int)d : MAX_DEPTH;
  }
  __host__ __device__ unsigned raw_floats() const { return 4 * 128 * units; }
  __host__ __device__ size_t smem() const {
    return 4 * ((size_t)stages * stage_floats + (size_t)depth * raw_floats() + u_floats) + TAIL;
  }
};

// wait until at most n of this thread's cp.async groups are in flight
__device__ __forceinline__ void cp_async_wait_upto(unsigned n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    default: cp_async_wait<5>(); break;
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(Stream::THREADS, 1) dense_pass_stream(const Pass p) {
  using G = Stream;
  constexpr int BM = G::BM, BN = G::BN, PLANE = G::PLANE;
  QSIM_DYNAMIC_SHARED(float4, dyn_smem);
  float* smem = reinterpret_cast<float*>(dyn_smem);
  const G g(p.k);
  const unsigned t = threadIdx.x, lane = t % 32, warp = t / 32;
  const unsigned D = 1u << p.k, su = g.su, stages = (unsigned)g.stages;
  float4* raw = reinterpret_cast<float4*>(smem + stages * g.stage_floats);
  float* ures = smem + stages * g.stage_floats + g.depth * g.raw_floats();  // Ur, Ui [BM][su]
  uint64_t* full = reinterpret_cast<uint64_t*>(ures + g.u_floats);
  uint64_t* empty = full + G::MAX_STAGES;
  unsigned* gtab = reinterpret_cast<unsigned*>(empty + G::MAX_STAGES);

  const unsigned rt = D / BM, r0 = (blockIdx.x % rt) * BM;
  const unsigned first = blockIdx.x / rt, step = gridDim.x / rt;
  const int log2g = __popc(p.free), log2tg = min(log2g, ilog2(BN));
  const unsigned gt = 1u << log2tg, tiles = 1u << (log2g - log2tg);
  const unsigned flow = low_bits(p.free, log2tg), fhigh = p.free & ~flow;
  const unsigned tlow = low_bits(p.tmask, 3), thigh = p.tmask & ~tlow;
  const unsigned chunks = D / G::BK, lc = (unsigned)p.k - 3;
  const unsigned ntiles = first < tiles ? (tiles - first + step - 1) / step : 0;
  const unsigned items = ntiles * chunks;

  if (t == 0)
    for (unsigned s = 0; s < stages; ++s) {
      mbar_init(full + s, 128);
      mbar_init(empty + s, 8);
    }
  if (t < BN / 8) gtab[t] = deposit_bits(8 * t, flow);  // groups 8 t (+ 0..7)
  if constexpr (RESIDENT) {
    for (unsigned i = t; i < 2 * BM * D / 4; i += G::THREADS) {
      const unsigned plane = i / (BM * D / 4), rest = i % (BM * D / 4);
      const unsigned row = rest / (D / 4), q = rest % (D / 4);
      const float4 v = __ldg(reinterpret_cast<const float4*>((plane ? p.ui : p.ur) +
                                                             (size_t)(r0 + row) * D) + q);
      *reinterpret_cast<float4*>(ures + plane * BM * su + row * su + 4 * q) = v;
    }
  }
  __syncthreads();

  if (warp >= 8) {  // the producer: thread pt takes group pt of each stage
    const unsigned pt = t - 256, depth = (unsigned)g.depth, units = g.units;
    const bool quads = (tlow & 3u) == 3u;  // the columns' low bits are bits 0-1
    unsigned kd[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) kd[j] = deposit_bits(j, tlow);
    const unsigned nd = deposit_bits(pt, flow);
    const bool nok = pt < gt;
    const unsigned urow = pt / 2, uhalf = pt % 2;
    // this thread's unit j of raw stage r: units 2 i + z are cell i (half i
    // of the stage's columns), plane z, four columns; past them U's chunk:
    // plane z, rows urow + 64 j
    auto unit = [&](unsigned r, unsigned j) { return raw + (r * units + j) * 128 + pt; };
    // stage it's copies into raw stage r, one cp.async group (empty past
    // the last stage); called for it = 0, 1, 2, ... in turn: the tile's
    // bits are deposited once a tile, the chunk's counted up in place
    unsigned tile_it = ~0u, tile_base = 0, chunk_bits = 0;
    auto issue = [&](unsigned it, unsigned r) {
      if (it < items) {
        if ((it >> lc) != tile_it) {
          tile_it = it >> lc;
          tile_base = p.cval | deposit_bits(first + tile_it * step, fhigh);
        }
        const unsigned a = tile_base | chunk_bits | nd;
        chunk_bits = ((chunk_bits | ~thigh) + 1u) & thigh;  // the next chunk's (0 after the last)
        if (nok) {
#pragma unroll
          for (int i = 0; i < G::CELLS; ++i) {
#pragma unroll
            for (int z = 0; z < 2; ++z) {
              const float* src = z ? p.im : p.re;
              float4* dst = unit(r, 2 * i + z);
              if (quads) {
                cp_async16(dst, src + (a | kd[4 * i]));
              } else {
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  cp_async4(reinterpret_cast<float*>(dst) + j, src + (a | kd[4 * i + j]));
              }
            }
          }
        }
        if constexpr (!RESIDENT) {
          const unsigned c = it & (chunks - 1);
#pragma unroll
          for (int j = 0; j < BM / 64; ++j) {
            const size_t at = (size_t)(r0 + urow + 64 * j) * D + G::BK * c + 4 * uhalf;
            cp_async16(unit(r, 2 * G::CELLS + j), p.ur + at);
            cp_async16(unit(r, 2 * G::CELLS + BM / 64 + j), p.ui + at);
          }
        }
      }
      cp_async_commit();
    };
    for (unsigned r = 0; r < depth; ++r) issue(r, r);
    unsigned s = 0, lap = 0, r = 0;
    for (unsigned it = 0; it < items; ++it) {
      cp_async_wait_upto(depth - 1);                        // raw stage r has landed
      if (lap > 0) mbar_wait(empty + s, (lap - 1) & 1);     // the consumers are done with slot s
      float* xs = smem + s * g.stage_floats;
      if (nok) {
#pragma unroll
        for (int i = 0; i < G::CELLS; ++i) {
          const unsigned o = 4 * BN * i + 4 * pt;
#pragma unroll
          for (int z = 0; z < 2; ++z) {
            const float4 v = *unit(r, 2 * i + z);
            uint4 h, l;
            split(__float_as_uint(v.x), h.x, l.x);
            split(__float_as_uint(v.y), h.y, l.y);
            split(__float_as_uint(v.z), h.z, l.z);
            split(__float_as_uint(v.w), h.w, l.w);
            *reinterpret_cast<uint4*>(xs + 2 * z * PLANE + o) = h;
            *reinterpret_cast<uint4*>(xs + (2 * z + 1) * PLANE + o) = l;
          }
        }
      }
      if constexpr (!RESIDENT) {
        float* us = xs + G::X_FLOATS + urow * G::SU_CHUNK + 4 * uhalf;
#pragma unroll
        for (int j = 0; j < BM / 64; ++j) {
          *reinterpret_cast<float4*>(us + 64 * j * G::SU_CHUNK) = *unit(r, 2 * G::CELLS + j);
          *reinterpret_cast<float4*>(us + (BM + 64 * j) * G::SU_CHUNK) =
              *unit(r, 2 * G::CELLS + BM / 64 + j);
        }
      }
      fence_proxy_async();  // the planes, before wgmma reads them
      mbar_arrive(full + s);
      if (++s == stages) s = 0, ++lap;
      issue(it + depth, r);  // raw stage r is read: refill it
      if (++r == depth) r = 0;
    }
    cp_async_wait<0>();
    return;
  }

  // the consumers: warpgroup w's 64 rows (64 w on), all the tile's groups;
  // warp cw's 16 of them
  const unsigned w = warp / 4, cw = warp % 4, fg = lane / 4, ft = lane % 4;
  const unsigned wrow = 64 * w;
  const unsigned arow = (wrow + cw * 16 + (lane & 7) + (lane & 8)) * su + (lane & 16 ? 4 : 0);
  const unsigned rd[2] = {deposit_bits(r0 + wrow + cw * 16 + fg, p.tmask),
                          deposit_bits(r0 + wrow + cw * 16 + fg + 8, p.tmask)};
  const unsigned fd[2] = {deposit_bits(2 * ft, flow), deposit_bits(2 * ft + 1, flow)};
  const bool pairs = (flow & 1u) != 0;  // groups 2 ft and 2 ft + 1 adjacent
  float tr[64], ti[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) tr[i] = ti[i] = 0.f;
  unsigned s = 0, phase = 0;
  for (unsigned i = 0; i < ntiles; ++i) {
    for (unsigned c = 0; c < chunks; ++c) {
      mbar_wait(full + s, phase);
      const float* xs = smem + s * g.stage_floats;
      const float* ub = RESIDENT ? ures + G::BK * c : xs + G::X_FLOATS;
      uint32_t f[4][4];  // U's fragments, split: rh, rl, ih, il
      {
        uint32_t r[4], m[4];
        ldmatrix4(r, ub + arow);
        ldmatrix4(m, ub + BM * su + arow);
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          split(r[v], f[0][v], f[1][v]);
          split(m[v], f[2][v], f[3][v]);
        }
      }
      const uint64_t xrh = smem_desc<16 * BN>(xs), xrl = smem_desc<16 * BN>(xs + PLANE);
      const uint64_t xih = smem_desc<16 * BN>(xs + 2 * PLANE), xil = smem_desc<16 * BN>(xs + 3 * PLANE);
      const int keep = c > 0;  // the tile's sums start at its first stage
      fence_operands(tr);
      fence_operands(ti);
      wgmma_fence();
      // Yr += Ur Xr - Ui Xi, Yi += Ui Xr + Ur Xi: small terms first
      wgmma128<1>(tr, f[1], xrh, keep);
      wgmma128<1>(tr, f[0], xrl, 1);
      wgmma128<-1>(tr, f[3], xih, 1);
      wgmma128<-1>(tr, f[2], xil, 1);
      wgmma128<1>(tr, f[0], xrh, 1);
      wgmma128<-1>(tr, f[2], xih, 1);
      wgmma128<1>(ti, f[3], xrh, keep);
      wgmma128<1>(ti, f[2], xrl, 1);
      wgmma128<1>(ti, f[1], xih, 1);
      wgmma128<1>(ti, f[0], xil, 1);
      wgmma128<1>(ti, f[2], xrh, 1);
      wgmma128<1>(ti, f[0], xih, 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(f);
      fence_operands(tr);
      fence_operands(ti);
      if (lane == 0) mbar_arrive(empty + s);
      if (++s == stages) s = 0, phase ^= 1;
    }
    // the tile out of the registers: rows fg (+ 8), groups 8 j + 2 ft (+ 1)
    const unsigned obase = p.cval | deposit_bits(first + i * step, fhigh);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const unsigned n = 8 * j + 2 * ft;
      if (n >= gt) continue;
      const unsigned gj = gtab[j];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned a = obase | rd[h] | gj | fd[0];
        if (pairs) {
          __stcs(reinterpret_cast<float2*>(p.ore + a), make_float2(tr[4 * j + 2 * h], tr[4 * j + 2 * h + 1]));
          __stcs(reinterpret_cast<float2*>(p.oim + a), make_float2(ti[4 * j + 2 * h], ti[4 * j + 2 * h + 1]));
        } else {
          __stcs(p.ore + a, tr[4 * j + 2 * h]);
          __stcs(p.oim + a, ti[4 * j + 2 * h]);
          if (n + 1 < gt) {
            const unsigned a1 = obase | rd[h] | gj | fd[1];
            __stcs(p.ore + a1, tr[4 * j + 2 * h + 1]);
            __stcs(p.oim + a1, ti[4 * j + 2 * h + 1]);
          }
        }
      }
    }
  }
}

// The groups whose controls fail, copied from `in` to `out` (after the
// stream instance's launch: its CTAs hold every SM's shared memory).
__global__ void __launch_bounds__(256) dense_pass_copy(const Pass p) {
  const unsigned stride = gridDim.x * 256;
  if ((p.cmask & 3u) == 0) {  // four slots at once share their control bits
    for (unsigned q = blockIdx.x * 256 + threadIdx.x; q < p.dim / 4; q += stride)
      if ((4 * q & p.cmask) != p.cval) {
        reinterpret_cast<float4*>(p.ore)[q] = __ldg(reinterpret_cast<const float4*>(p.re) + q);
        reinterpret_cast<float4*>(p.oim)[q] = __ldg(reinterpret_cast<const float4*>(p.im) + q);
      }
    return;
  }
  for (unsigned l = blockIdx.x * 256 + threadIdx.x; l < p.dim; l += stride)
    if ((l & p.cmask) != p.cval) {
      p.ore[l] = __ldg(p.re + l);
      p.oim[l] = __ldg(p.im + l);
    }
}

// the shared memory past 48 KB, allowed once per device and instance (the
// CUDA call on every launch cost the host more than the 16-qubit pass
// takes)
template <class SH, class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  static unsigned long long allowed = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && (allowed >> dev & 1ull))) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < 64) allowed |= 1ull << dev;
  return err;
}

template <class SH, class K>
int launch(K kernel, Pass p, cudaStream_t stream) {
  const cudaError_t err = allow_smem<SH>(kernel, SH::SMEM);
  if (err != cudaSuccess) return (int)err;
  const unsigned row_tiles = (1u << p.k) / SH::BM;
  const unsigned group_tiles = p.groups > (unsigned)SH::BN ? p.groups / SH::BN : 1u;
  p.gemm_ctas = row_tiles * group_tiles;  // the kernel takes the group tiles minor
  unsigned copy_ctas = 0;
  if (p.cmask) {
    copy_ctas = p.dim / SH::THREADS;
    if (copy_ctas > 1024) copy_ctas = 1024;
    if (copy_ctas < 1) copy_ctas = 1;
  }
  return (int)launch_kernel(kernel, p.gemm_ctas + copy_ctas, SH::THREADS, SH::SMEM, stream, p);
}

// The device's multiprocessors, asked once per device.
int device_sms() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && sms[dev]) return sms[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) sms[dev] = n;
  return n;
}

template <bool R>
struct StreamTag {};

// The stream instance on C = RT x min(SMs / RT, group tiles) CTAs (at least
// RT, RT = 2^k / 128), then the copy of the groups whose controls fail.
int launch_stream(Pass p, cudaStream_t stream) {
  const Stream g(p.k);
  const auto kernel = g.resident ? dense_pass_stream<true> : dense_pass_stream<false>;
  cudaError_t err = g.resident ? allow_smem<StreamTag<true>>(kernel, Stream::SMEM_LIMIT)
                               : allow_smem<StreamTag<false>>(kernel, Stream::SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  const int sms = device_sms();
  if (sms < 1) return (int)cudaErrorInvalidValue;
  const unsigned rt = (1u << p.k) / Stream::BM;
  const int log2g = __builtin_popcount(p.free), log2bn = ilog2(Stream::BN);
  const unsigned tiles = 1u << (log2g - (log2g < log2bn ? log2g : log2bn));
  unsigned per_row = (unsigned)sms / rt;
  if (per_row > tiles) per_row = tiles;
  if (per_row < 1) per_row = 1;
  err = launch_kernel(kernel, rt * per_row, Stream::THREADS, g.smem(), stream, p);
  if (err != cudaSuccess || !p.cmask) return (int)err;
  unsigned copy_ctas = p.dim / 4 / 256;
  if (copy_ctas > 8u * (unsigned)sms) copy_ctas = 8u * (unsigned)sms;
  if (copy_ctas < 1) copy_ctas = 1;
  return (int)launch_kernel(dense_pass_copy, copy_ctas, 256, 0, stream, p);
}

}  // namespace

// Launch the pass on `stream`: out = the gate applied to `state`, both
// (2, dim) float32 planes on the device, distinct. `u` is the device copy of
// the 2^k x 2^k core (two row-major float32 planes, re then im, index bit j
// the j-th lowest bit of `tmask`), `cmask`/`cval` the control bits and
// values (disjoint from the targets), `instance` 0 small (32 x 16 tiles), 1
// medium (32 x 64), 2 large (128 x 64) or 3 stream (persistent, 128 x 128),
// k >= 7. Returns the cudaError_t of the
// launch (0 on success); the launch does not synchronize and allocates
// nothing.
extern "C" int dense_pass_launch(const float* state, float* out, long long dim,
                                 const float* u, int k, unsigned tmask,
                                 unsigned cmask, unsigned cval, int instance,
                                 void* stream) {
  if (dim < 2 || dim > (1LL << 30) || (dim & (dim - 1)) || state == out ||
      k < 7 || instance < 0 || instance > 3 || __builtin_popcount(tmask) != k || (tmask & cmask) ||
      (cval & ~cmask) || ((tmask | cmask) & ~(unsigned)(dim - 1)) ||
      (reinterpret_cast<uintptr_t>(u) & 15) || (reinterpret_cast<uintptr_t>(state) & 15))
    return (int)cudaErrorInvalidValue;
  Pass p{};
  p.re = state;
  p.im = state + dim;
  p.ore = out;
  p.oim = out + dim;
  p.ur = u;
  p.ui = u + ((size_t)1 << (2 * k));
  p.tmask = tmask;
  p.cmask = cmask;
  p.cval = cval;
  p.free = (unsigned)(dim - 1) & ~(tmask | cmask);
  p.k = k;
  p.groups = 1u << __builtin_popcount(p.free);
  p.dim = (unsigned)dim;
  const cudaStream_t s = (cudaStream_t)stream;
  if (instance == 3) return launch_stream(p, s);
  if (instance == 2) return launch<Large>(dense_pass_wgmma, p, s);
  return instance == 1 ? launch<Medium>(dense_pass_kernel<Medium>, p, s)
                       : launch<Small>(dense_pass_kernel<Small>, p, s);
}

extern "C" const char* dense_pass_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
