// Op semantics shared by the port's kernels: how one op of the device op
// table (tpu_qsim_torch/kernels/fused_circuit.py::build_op_table) acts on a
// block of 2^kbits amplitude slots. grid_sweep.cu, whole_circuit.cu,
// segment.cu and sweep.cu all include this one copy.
//
// Replaces the op body that every TPU kernel of tpu_qsim shares,
// tpu_qsim/kernels/fused_circuit.py::emit_ops (XOR-shift gate emission,
// 128x128 lane/row/top window matmuls, lane diagonals, ext-phase scalars).
//
// Where slot l lives is the caller's choice, through a Slots type whose
// re(l) / im(l) return pointers:
//   BlockSlots   - this CTA's own shared memory holds the whole block, at l
//                  (the grid sweep, the segments);
//   LocalSlots   - this CTA's own shared memory holds the slots l with one
//                  value of l >> local_bits, at l & mask;
//   ClusterSlots - a thread-block cluster's distributed shared memory: slot l
//                  lives in CTA l >> local_bits, at l & mask there;
//   GlobalSlots  - device memory (the sweep kernels): slot l is the state
//                  index of l under the block layout of the current part or
//                  step, see below.
// Which work items a CTA takes is a Part: an op's items are split into 2^log2
// equal contiguous parts and the CTA takes part `index`. In a cluster, part
// r of an op that moves no bit >= local_bits touches only CTA r's slots, so
// the caller may run such an op through LocalSlots.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace qsim {

constexpr int SWEEP_HEADER = 64;    // int32 words before the first op
constexpr int HEADER_MAX_CORE = 4;  // header word: the table's widest dense core
constexpr int OP_HEADER = 32;       // int32 words per op
constexpr int EXT = 32;             // codes >= EXT name bits outside the block
constexpr int KIND_DIAG = 0;        // any other kind is a dense core of 1-8 qubits

// Masking every access of a single-CTA block (LocalSlots with mask size - 1)
// cost the 28q grid sweep 3% against this type on the H100 (PERF.md).
struct BlockSlots {
  float* sr;
  float* si;
  __device__ float* re(unsigned l) const { return sr + l; }
  __device__ float* im(unsigned l) const { return si + l; }
};

struct LocalSlots {
  float* sr;
  float* si;
  unsigned mask;
  __device__ float* re(unsigned l) const { return sr + (l & mask); }
  __device__ float* im(unsigned l) const { return si + (l & mask); }
};

struct ClusterSlots {
  float* sr;  // this CTA's planes; every CTA of the cluster has the same offsets
  float* si;
  int local_bits;
  __device__ float* re(unsigned l) const {
    return cooperative_groups::this_cluster().map_shared_rank(sr, l >> local_bits) +
           (l & ((1u << local_bits) - 1u));
  }
  __device__ float* im(unsigned l) const {
    return cooperative_groups::this_cluster().map_shared_rank(si, l >> local_bits) +
           (l & ((1u << local_bits) - 1u));
  }
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

__device__ __forceinline__ unsigned bit_of(int code, unsigned l, unsigned cta_g) {
  return code < EXT ? (l >> code) & 1u : (cta_g >> (code - EXT)) & 1u;
}

// True when the op moves amplitudes along a block bit >= bits (a dense core
// with a target there); diagonal ops move nothing.
__device__ __forceinline__ bool op_moves_from(const int* op, int bits) {
  return op[0] != KIND_DIAG && op[24 + op[1] - 1] >= bits;
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

// Dense op on M <= GATHER_CORE block qubits, under block-local controls: one
// thread per group of 2^M slots, gathered to registers and multiplied by the
// row-major 2^M x 2^M core. Cores of up to 4 qubits unroll fully; 5 and 6
// qubits keep their 32 or 64 amplitudes in (spilled) per-thread arrays.
template <int M, class S>
__device__ void apply_dense(const S& s, const int* op, const float2* coef,
                            int kbits, Part part) {
  constexpr int D = 1 << M;
  constexpr int UNROLL = M <= 4 ? D : 1;
  const unsigned lmask = op[3], lval = op[4];
  unsigned offs[D];
#pragma unroll (UNROLL)
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
#pragma unroll (UNROLL)
    for (int j = 0; j < D; ++j) {
      xr[j] = *s.re(base | offs[j]);
      xi[j] = *s.im(base | offs[j]);
    }
#pragma unroll (UNROLL)
    for (int r = 0; r < D; ++r) {
      float ar = 0.f, ai = 0.f;
#pragma unroll (UNROLL)
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

// Dense op on M > GATHER_CORE block qubits: 2^M amplitudes are too many for
// one thread's registers (at 5-6 qubits apply_dense's arrays already spill),
// so the 32 lanes of a warp share a group. Lane t loads and keeps the
// amplitudes j = t + 32 i of the group, i < 2^M / 32; each column is then
// broadcast from the lane holding it (__shfl_sync), and lane t sums its rows
// t + 32 i against the core, which build_op_table stores column-major for
// these widths, so a warp's coefficient loads are coalesced (read through
// L1/L2: 128 KB at 7 qubits, 512 KB at 8, too large for shared memory
// beside a block). Lane t writes back only the slots it loaded, after every
// lane has loaded, so the group's reads all come before its writes. Needs a
// block of whole warps (the launchers check); warps take the groups of the
// CTA's part in turn.
constexpr int GATHER_CORE = 6;

template <int M, class S>
__device__ void apply_dense_wide(const S& s, const int* op, const float2* coef,
                                 int kbits, Part part) {
  constexpr int D = 1 << M;
  constexpr int R = D / 32;
  const unsigned lane = threadIdx.x & 31u;
  const unsigned warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const unsigned lmask = op[3], lval = op[4];
  unsigned offs[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const unsigned j = lane + 32u * i;
    unsigned o = 0;
    for (int b = 0; b < M; ++b)
      if ((j >> (M - 1 - b)) & 1u) o |= 1u << op[8 + b];
    offs[i] = o;
  }
  int pos[M];
  for (int i = 0; i < M; ++i) pos[i] = op[24 + i];
  const float2* u = coef + op[2];  // column-major: u[c * D + r]
  const unsigned groups = 1u << (kbits - M);
  const unsigned lo = part.begin(groups), hi = part.end(groups);
  for (unsigned gi = lo + warp; gi < hi; gi += n_warps) {
    unsigned base = gi;
    for (int i = 0; i < M; ++i) {  // insert a 0 at each target, ascending
      const unsigned low = base & ((1u << pos[i]) - 1u);
      base = ((base >> pos[i]) << (pos[i] + 1)) | low;
    }
    if ((base & lmask) != lval) continue;  // the same for the whole warp
    float xr[R], xi[R], ar[R], ai[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      xr[i] = *s.re(base | offs[i]);
      xi[i] = *s.im(base | offs[i]);
      ar[i] = 0.f;
      ai[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        const float br = __shfl_sync(0xffffffffu, xr[i], src);
        const float bi = __shfl_sync(0xffffffffu, xi[i], src);
        const float2* col = u + (size_t)(32 * i + src) * D + lane;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float2 w = col[32 * r];
          ar[r] += w.x * br - w.y * bi;
          ai[r] += w.x * bi + w.y * br;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      *s.re(base | offs[r]) = ar[r];
      *s.im(base | offs[r]) = ai[r];
    }
  }
}

// MAXM is the widest dense core a kernel instance takes: each kernel is
// built for NARROW_CORE (every core unrolls fully, and no code for a wider
// one is inlined) and for MAX_CORE, and the host launches the narrow
// instance when the table's widest core allows it. A kernel calls
// check_core_width once before its ops, so a table too wide for the
// instance traps instead of skipping ops; the ops themselves do not check.
constexpr int NARROW_CORE = 4;
constexpr int MAX_CORE = 8;

// Whether a launch of `threads` threads per CTA can run a table whose widest
// core is `max_core`: cores wider than GATHER_CORE take whole warps.
inline bool threads_fit_core(int threads, int max_core) {
  return max_core <= GATHER_CORE || threads % 32 == 0;
}

template <int MAXM>
__device__ __forceinline__ void check_core_width(const int* table) {
  if (table[HEADER_MAX_CORE] > MAXM) __trap();
}

// One op of the table. Out-of-block controls (words 5, 6) are uniform over
// the CTA and skip it whole.
template <int MAXM, class S>
__device__ void apply_op(const S& s, const int* op, const float2* coef,
                         int kbits, unsigned cta_g, Part part) {
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
    case 5:
      if constexpr (MAXM >= 5) apply_dense<5>(s, op, coef, kbits, part);
      break;
    case 6:
      if constexpr (MAXM >= 6) apply_dense<6>(s, op, coef, kbits, part);
      break;
    default:  // only the wide instance has code for these widths
      if constexpr (MAXM > GATHER_CORE) {
        if (op[1] == 7) apply_dense_wide<7>(s, op, coef, kbits, part);
        else if (op[1] == 8) apply_dense_wide<8>(s, op, coef, kbits, part);
      }
      break;
  }
}

}  // namespace qsim
