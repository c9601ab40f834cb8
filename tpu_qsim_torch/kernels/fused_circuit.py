"""Planner gates and the grid-sweep kernel's device op table.

Host half of ``tpu_qsim/kernels/fused_circuit.py``: ``PGate``, ``as_pgates``,
``merge_1q_chains`` and the matrix tests the planners share, copied without
JAX. The whole-circuit kernel of that module (``build_pallas_run_gates``) is
not ported yet.

:func:`build_op_table` replaces ``materialize_ops`` for the CUDA card. The
TPU planner composed 7-qubit lane/row windows into 128x128 matmuls and
resolved out-of-block bits through per-step ``ext`` scalars; both are TPU
layout. Here a sweep's gates become a flat int32 table of ops (one header per
op) plus a float32 table of coefficients composed on the host in complex128,
which one compiled kernel (``csrc/grid_sweep.cu``) interprets for any circuit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..gates import op_matrix

_SWAP_U = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.complex128,
)


def _is_diagonal(u: np.ndarray) -> bool:
    return not np.any(u - np.diag(np.diagonal(u)))


def _controlled_split(u: np.ndarray) -> np.ndarray | None:
    """If u = block-diag(I, V) w.r.t. its MSB qubit (the library layout of
    cnot/cz/cry/crz/cp/toffoli), return V, else None."""
    d = u.shape[0] >> 1
    if (
        not np.any(u[:d, d:])
        and not np.any(u[d:, :d])
        and not np.any(u[:d, :d] - np.eye(d))
    ):
        return np.ascontiguousarray(u[d:, d:])
    return None


class PGate:
    """Planner gate: an explicit unitary + qubit tuple.

    ``classes`` carries the per-qubit commutation classes consumed by
    :func:`tpu_qsim_torch.commute.qubit_classes`.
    """

    __slots__ = ("u", "qubits", "classes")

    def __init__(self, u: np.ndarray, qubits: tuple[int, ...], classes):
        self.u = u
        self.qubits = qubits
        self.classes = classes


def matrix_classes(u: np.ndarray, qubits: tuple[int, ...]) -> tuple:
    """Conservative per-qubit commutation classes derived from a matrix
    (for gates that arrive without a library name): diagonal axes commute
    as DIAG, peeled control axes as DIAG, everything else OTHER."""
    from ..commute import DIAG, OTHER

    if _is_diagonal(u):
        return (DIAG,) * len(qubits)
    v = _controlled_split(u)
    if v is not None:
        return (DIAG,) + matrix_classes(v, qubits[1:])
    return (OTHER,) * len(qubits)


def as_pgates(gates) -> list[PGate]:
    """Normalize a gate list to planner gates: named circuit Gates pick up
    their library matrix + name-based commute classes; (matrix, qubits)
    pairs and existing PGates pass through."""
    from ..commute import qubit_classes

    out = []
    for g in gates:
        if isinstance(g, PGate):
            out.append(g)
        elif isinstance(g, tuple):
            u, qubits = g
            u = np.asarray(u, dtype=np.complex128)
            out.append(PGate(u, tuple(qubits), matrix_classes(u, qubits)))
        else:
            out.append(
                PGate(
                    op_matrix(g).astype(np.complex128),
                    g.qubits,
                    qubit_classes(g),
                )
            )
    return out


def merge_1q_chains(pgates: list[PGate]) -> list[PGate]:
    """Commute-aware same-qubit 1q-run folding.

    Under frontier scheduling, a 1q gate whose target already carries an
    emitted 1q gate with no intervening non-commuting toucher folds into
    it (u = u2 @ u1, composed in complex128 on host); exact-identity
    products (H·H, X·X) are elided outright. Every emitted gate is one pass
    over the block in shared memory, so fewer gates is a direct compute cut.

    Safety: merging places g at its partner's position; any gate that
    could forbid that must not commute with g, hence (conservative rule,
    :mod:`tpu_qsim_torch.commute`) shares g's qubit — and every toucher of a
    qubit closes that qubit's open slot below. Identity elision requires
    exact I (no global-phase freedom: amplitudes are compared literally
    against the oracle).
    """
    from ..commute import FrontierScheduler

    if sum(1 for g in pgates if len(g.qubits) == 1) < 2:
        return list(pgates)
    sched = FrontierScheduler(list(pgates))
    out: list[PGate | None] = []
    open_1q: dict[int, int] = {}        # qubit -> open slot index in out
    while not sched.done():
        ready = sched.ready()
        pick = None
        for i in ready:
            g = sched.gates[i]
            if len(g.qubits) == 1 and g.qubits[0] in open_1q:
                pick = i
                break
        if pick is not None:
            g = sched.gates[pick]
            sched.emit(pick)
            j = open_1q[g.qubits[0]]
            u = g.u @ out[j].u
            if not np.any(np.abs(u - np.eye(2)) > 1e-12):
                out[j] = None               # folded to identity: elide
                del open_1q[g.qubits[0]]
            else:
                out[j] = PGate(u, g.qubits, matrix_classes(u, g.qubits))
            continue
        i = ready[0]
        g = sched.gates[i]
        sched.emit(i)
        for qq in g.qubits:
            open_1q.pop(qq, None)
        out.append(g)
        if len(g.qubits) == 1:
            open_1q[g.qubits[0]] = len(out) - 1
    return [g for g in out if g is not None]


# ---------------------------------------------------------------------------
# Device op table (read by csrc/grid_sweep.cu; keep the two in step)
# ---------------------------------------------------------------------------

SWEEP_HEADER = 64        # int32 words before the first op
OP_HEADER = 32           # int32 words per op
KIND_DIAG = 0
KIND_DENSE = 1
# qubit code: < EXT is a bit of the block-local index; EXT + p is state bit p,
# read from the CTA's share of the global index (bits outside the block)
EXT = 32
MAX_DIAG_QUBITS = 16     # op words [8, 24)
MAX_DENSE_QUBITS = 4     # per-thread gather of 2^m amplitudes in registers
MAX_BLOCK_BITS = 14      # 2 planes x 2^14 x 4 B = 128 KB of shared memory


@dataclass(frozen=True)
class BlockLayout:
    """Which state bits one CTA holds: bits ``[0, blk_bits)`` plus the
    ascending ``active`` high bits; the rest index the grid."""

    n: int
    blk_bits: int
    active: tuple[int, ...]

    @property
    def kbits(self) -> int:
        return self.blk_bits + len(self.active)

    @property
    def inactive(self) -> tuple[int, ...]:
        return tuple(
            p for p in range(self.blk_bits, self.n) if p not in self.active
        )

    def code(self, q: int) -> int:
        """Qubit ``q`` as the kernel reads it (see ``EXT``)."""
        if q < self.blk_bits:
            return q
        if q in self.active:
            return self.blk_bits + self.active.index(q)
        return EXT + q


@dataclass(frozen=True)
class OpTable:
    """One sweep's kernel input: int32 headers and (re, im) coefficients."""

    ints: np.ndarray          # (SWEEP_HEADER + OP_HEADER * n_ops,) int32
    coef: np.ndarray          # (n_coef, 2) float32
    flops_per_amp: float      # real flops per amplitude the ops apply


def _peel_controls(u: np.ndarray, qubits: tuple[int, ...]):
    """Split block-diag(I, V) layers off the MSB qubits: (controls, core
    matrix, core qubits). The core's qubits are ``moving_qubits(u)``."""
    ctrls = []
    while len(qubits) > 1:
        v = _controlled_split(u)
        if v is None:
            break
        ctrls.append(qubits[0])
        u, qubits = v, qubits[1:]
    return ctrls, u, qubits


def build_op_table(pgates: list[PGate], layout: BlockLayout) -> OpTable:
    """Turn one sweep's gates into the kernel's device op table.

    A diagonal gate becomes one DIAG op over all its qubits (any bit, in or
    out of the block). Any other gate peels its control layers into a mask
    on the block-local index and a mask on the CTA's out-of-block bits, and
    its core becomes one DENSE op whose qubits must lie in the block (the
    planner's ``moving_qubits`` guarantee).
    """
    if layout.kbits > MAX_BLOCK_BITS:
        raise ValueError(
            f"a block of 2^{layout.kbits} amplitudes exceeds shared memory "
            f"(at most 2^{MAX_BLOCK_BITS})"
        )
    head = np.zeros(SWEEP_HEADER, dtype=np.int32)
    inact = layout.inactive
    head[0] = len(pgates)
    head[1] = layout.blk_bits
    head[2] = len(layout.active)
    head[3] = len(inact)
    head[16:16 + len(layout.active)] = layout.active
    head[32:32 + len(inact)] = inact
    ops = np.zeros((len(pgates), OP_HEADER), dtype=np.int32)
    coefs: list[np.ndarray] = []
    n_coef = 0
    flops = 0.0
    for op, g in zip(ops, pgates):
        u = np.asarray(g.u, dtype=np.complex128)
        if _is_diagonal(u):
            m = len(g.qubits)
            if m > MAX_DIAG_QUBITS:
                raise NotImplementedError(
                    f"diagonal gate on {m} qubits; the kernel takes at most "
                    f"{MAX_DIAG_QUBITS}"
                )
            op[0] = KIND_DIAG
            op[8:8 + m] = [layout.code(q) for q in g.qubits]
            c = np.diagonal(u)
            flops += 6.0
        else:
            ctrls, core, qs = _peel_controls(u, tuple(g.qubits))
            m = len(qs)
            if m > MAX_DENSE_QUBITS:
                raise NotImplementedError(
                    f"dense gate core on {m} qubits; the kernel takes at "
                    f"most {MAX_DENSE_QUBITS}"
                )
            codes = [layout.code(q) for q in qs]
            if max(codes) >= EXT:
                raise ValueError(
                    f"gate on {g.qubits} moves a qubit outside the block "
                    f"{layout.active}"
                )
            op[0] = KIND_DENSE
            for q in ctrls:
                cq = layout.code(q)
                if cq < EXT:
                    op[3] |= 1 << cq
                    op[4] |= 1 << cq
                else:
                    op[5] |= 1 << q
                    op[6] |= 1 << q
            op[8:8 + m] = codes
            op[24:24 + m] = sorted(codes)
            c = core.reshape(-1)
            # 2^m outputs per group of 2^m inputs, one complex MAC (8 flops)
            # each, on the 2^-len(ctrls) share of amplitudes the controls pass
            flops += 8.0 * (1 << m) / (1 << len(ctrls))
        op[1] = m
        op[2] = n_coef
        coefs.append(c)
        n_coef += c.size
    flat = np.concatenate(coefs) if coefs else np.zeros(1, np.complex128)
    coef = np.stack([flat.real, flat.imag], axis=1).astype(np.float32)
    return OpTable(
        np.concatenate([head, ops.reshape(-1)]), np.ascontiguousarray(coef),
        flops,
    )
