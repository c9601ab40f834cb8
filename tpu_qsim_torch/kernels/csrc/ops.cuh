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
// Dense op on M >= TILE_CORE block qubits: one tiled complex matrix product.
//
// The op is Y = U X, U the 2^M x 2^M core (D = 2^M) and X the D x G matrix
// whose column g holds the amplitudes of group g (the 2^M slots that differ
// only in the targets, under the block-local controls). Each thread owns 4
// rows of GT groups (GT = 4 for cores of 7 qubits and more at up to 512
// threads, else 2), so a CTA of T threads takes tiles of TG = 4 GT T / D
// groups (fewer if the op has fewer groups):
//   1. the tile's X is staged from the slots into shared memory, xs[c][g]
//      (its slots may be this CTA's shared memory or device memory: the op
//      reads each once). A tile is the slots whose bits
//      outside the targets and the tile's lowest free bits are fixed; its
//      elements are taken in the order of their slot indices, so a warp's
//      32 loads are consecutive slots wherever the targets lie (no bank
//      conflicts in shared memory, whole sectors in device memory). Row and
//      group of a slot are linear in its bits, so each thread derives them
//      for its 4 GT elements from a few masks;
//   2. U streams through shared memory in panels of KC = min(D, PANEL / D)
//      whole columns (build_op_table stores U column-major, so a panel is one
//      contiguous run of coefficients), double-buffered with cp.async: the
//      next panel's copy is in flight while the threads multiply the current
//      one (starting each CTA at another panel, tried, was 10% slower);
//   3. thread t accumulates rows 2 rb, 2 rb + 1, 2 rb + D/2, 2 rb + 1 + D/2
//      of groups GT gb .. GT gb + GT - 1 in float32 registers: per column
//      GT/2 float4 of X and two of U from shared memory for 4 GT complex
//      multiply-adds of four chained FMAs. A warp's lanes take 8 or more row
//      pairs and up to 4 group blocks, so their U loads are 128 consecutive
//      bytes and their X loads broadcast;
//   4. after the last panel (and the barrier that ends it, so every read of
//      the tile's slots is done) the outputs go to xs, and from there to the
//      slots in the order of step 1.
// xs[c][g] sits at c TGS + (g ^ (GT c mod TGS)), TGS = max(TG, GT): the
// swizzle keeps a group block in whole float4s and spreads a column's rows
// over the banks.
// U is read once per tile of TG groups, not once per group. Block-local
// controls fix their bits in the group enumeration (no group is skipped).
// Tiles are split over the CTAs of a Part in turn. Needs T a power of two
// with D <= 4 T and D <= PANEL, and tile_scratch_bytes(T) of shared memory
// at `scratch` (16-byte aligned); the coefficients must start 16-byte
// aligned (build_op_table pads). Every thread of the CTA must call it. It is
// one non-inlined function, so its registers are allocated apart from the
// surrounding kernel's.
// ---------------------------------------------------------------------------
constexpr int PANEL = 2048;  // float2 per U panel buffer: 16 KB
// cores of this many qubits and more take 4 groups a thread at <= 512
// threads (at 6 qubits 2 groups were faster in the grid sweep on the H100)
constexpr int TILE_GT4_CORE = 7;
constexpr int TILE_MAX_CORE = 11;  // D <= PANEL

// Groups each thread of a CTA of `threads` takes in the tiled op, for a
// core of 2^m rows (0: the most any core takes, for the scratch size).
__host__ __device__ constexpr int tile_thread_groups(int threads, int m = 0) {
  return threads <= 512 && (m == 0 || m >= TILE_GT4_CORE) ? 4 : 2;
}

__host__ __device__ constexpr size_t tile_scratch_bytes(int threads) {
  return (size_t)threads * 4 * tile_thread_groups(threads) * sizeof(float2) +
         2 * PANEL * sizeof(float2);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start the copy of `count` float2 (a multiple of 2) from src to dst, each
// thread 16 bytes at a time, as one cp.async group.
__device__ __forceinline__ void copy_panel(float2* dst, const float2* src,
                                           unsigned count) {
  for (unsigned ch = threadIdx.x; ch < count / 2; ch += blockDim.x)
    cp_async16(dst + 2 * ch, src + 2 * ch);
  cp_async_commit();
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

template <int GT, class S>
__device__ __noinline__ void apply_dense_tiled(const S& s, const int* op,
                                               const float2* coef, int kbits,
                                               Part part, float2* scratch) {
  constexpr int E = 4 * GT;             // elements of a tile per thread
  constexpr int LOG2E = GT == 4 ? 4 : 3;
  const int m = op[1];
  const unsigned D = 1u << m;
  const unsigned T = blockDim.x, t = threadIdx.x;
  const int log2t = __ffs(T) - 1;
  unsigned tmask = 0;
  for (int i = 0; i < m; ++i) tmask |= 1u << op[8 + i];
  const unsigned lmask = op[3], lval = op[4];
  const unsigned free = ((1u << kbits) - 1u) & ~(tmask | lmask);
  const int free_bits = __popc(free);
  const int log2tg = min(log2t + LOG2E - m, free_bits);
  // a tile's groups, and its row stride in xs: at least one group block (an
  // op with fewer groups computes unused ones, never loaded or stored)
  const unsigned TG = 1u << log2tg, TGS = TG > GT ? TG : GT;
  // a tile: the lowest log2tg free bits (its groups) and the targets (its
  // rows) vary; the other free bits number the tiles
  unsigned gmask = 0, rest = free;
  for (int k = 0; k < log2tg; ++k) {
    gmask |= rest & (0u - rest);
    rest &= rest - 1u;
  }
  const unsigned pmask = tmask | gmask;
  const unsigned n_tiles = 1u << (free_bits - log2tg);
  const unsigned count = D * TG;       // elements of a tile, at most E T
  const unsigned KC = D < PANEL / D ? D : PANEL / D;
  const unsigned panel = KC * D, n_panels = D / KC;
  float2* xs = scratch;                 // [D][TGS], swizzled
  float2* us = scratch + E * T;         // [2][PANEL]
  const float2* u = coef + op[2];       // column-major: u[c * D + r]
  const unsigned swz = TGS - GT;        // GT c mod TGS keeps group blocks whole

  // element t + i T of a tile: slot bits dep_t | dl[bits of i], row
  // c_t ^ dc[..], group g_t ^ dg[..] (linear in the element's bits)
  const unsigned dep_t = deposit_bits(t, pmask);
  const unsigned c_t = row_of(op, m, dep_t), g_t = extract_bits(dep_t, gmask);
  unsigned dl[LOG2E], dc[LOG2E], dg[LOG2E];
#pragma unroll
  for (int b = 0; b < LOG2E; ++b) {
    dl[b] = deposit_bits(1u << (log2t + b), pmask);
    dc[b] = row_of(op, m, dl[b]);
    dg[b] = extract_bits(dl[b], gmask);
  }

  // compute: row pair rb (rows 2 rb, 2 rb + 1 and the same + D/2), group
  // block gb (groups GT gb .. GT gb + GT - 1)
  const unsigned GB = TGS / GT, GBL = GB < 4 ? GB : 4;
  const unsigned q = D / 4;
  const bool computes = t < q * GB;
  const unsigned rb = (t / GBL) % q;
  const unsigned gb = (t / GBL / q) * GBL + t % GBL;

  for (unsigned tile = part.index; tile < n_tiles; tile += 1u << part.log2) {
    const unsigned hi = deposit_bits(tile, rest) | lval;
    copy_panel(us, u, panel);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (t + i * T >= count) break;
      unsigned l = hi | dep_t, c = c_t, g = g_t;
#pragma unroll
      for (int b = 0; b < LOG2E; ++b)
        if ((i >> b) & 1) {
          l |= dl[b];
          c ^= dc[b];
          g ^= dg[b];
        }
      xs[c * TGS + (g ^ ((GT * c) & swz))] = make_float2(*s.re(l), *s.im(l));
    }
    float ar[4][GT], ai[4][GT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < GT; ++j) ar[i][j] = ai[i][j] = 0.f;
    for (unsigned p = 0; p < n_panels; ++p) {
      if (p + 1 < n_panels) {
        copy_panel(us + ((p + 1) & 1u) * PANEL, u + (size_t)(p + 1) * panel, panel);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if (computes) {
        const float4* up = reinterpret_cast<const float4*>(us + (p & 1u) * PANEL) + rb;
#pragma unroll 4
        for (unsigned cc = 0; cc < KC; ++cc) {
          const unsigned c = p * KC + cc;
          const float4* xr = reinterpret_cast<const float4*>(
              xs + c * TGS + ((GT * gb) ^ ((GT * c) & swz)));
          float2 x[GT];
#pragma unroll
          for (int j = 0; j < GT / 2; ++j) {
            const float4 v = xr[j];
            x[2 * j] = make_float2(v.x, v.y);
            x[2 * j + 1] = make_float2(v.z, v.w);
          }
          const float4 w01 = up[cc * (D / 2)];          // rows 2 rb, 2 rb + 1
          const float4 w23 = up[cc * (D / 2) + q];      // the same + D/2
          const float2 w[4] = {make_float2(w01.x, w01.y), make_float2(w01.z, w01.w),
                               make_float2(w23.x, w23.y), make_float2(w23.z, w23.w)};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < GT; ++j) {  // four chained FMAs per product
              ar[i][j] = fmaf(w[i].x, x[j].x, fmaf(-w[i].y, x[j].y, ar[i][j]));
              ai[i][j] = fmaf(w[i].x, x[j].y, fmaf(w[i].y, x[j].x, ai[i][j]));
            }
        }
      }
      __syncthreads();
    }
    if (computes) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned r = 2 * rb + (i & 1) + (i & 2 ? D / 2 : 0u);
        float4* xw = reinterpret_cast<float4*>(
            xs + r * TGS + ((GT * gb) ^ ((GT * r) & swz)));
#pragma unroll
        for (int j = 0; j < GT / 2; ++j)
          xw[j] = make_float4(ar[i][2 * j], ai[i][2 * j], ar[i][2 * j + 1],
                              ai[i][2 * j + 1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (t + i * T >= count) break;
      unsigned l = hi | dep_t, c = c_t, g = g_t;
#pragma unroll
      for (int b = 0; b < LOG2E; ++b)
        if ((i >> b) & 1) {
          l |= dl[b];
          c ^= dc[b];
          g ^= dg[b];
        }
      const float2 y = xs[c * TGS + (g ^ ((GT * c) & swz))];
      *s.re(l) = y.x;
      *s.im(l) = y.y;
    }
    __syncthreads();  // the next tile's staging overwrites xs
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
// 4 threads (a tile of two or more groups).
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
// the CTA and skip it whole. `scratch` is the tiled op's shared memory (only
// the wide instance reads it).
template <int MAXM, class S>
__device__ void apply_op(const S& s, const int* op, const float2* coef,
                         int kbits, unsigned cta_g, Part part,
                         float2* scratch) {
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
      if constexpr (MAXM > NARROW_CORE) {
        if (tile_thread_groups(blockDim.x, op[1]) == 4)
          apply_dense_tiled<4>(s, op, coef, kbits, part, scratch);
        else
          apply_dense_tiled<2>(s, op, coef, kbits, part, scratch);
      }
      break;
  }
}

}  // namespace qsim
