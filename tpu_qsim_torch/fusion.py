"""Gate-fusion pass: pack a gate list into k-qubit unitary groups.

The port's copy of ``tpu_qsim/fusion.py``, used by the torch engine
(:mod:`tpu_qsim_torch.apply`). Every un-fused gate streams the whole 2^n
state through device memory once; fusing m gates whose combined support fits
in k qubits turns m passes into one (2^k x 2^k) contraction.

Algorithm: greedy group packing with disjoint-support commutation. Each gate
is appended to the *latest* group that touches any of its qubits (its true
dependency) if the union still fits in ``max_fused_qubits``; otherwise it
opens a new group, or joins an independent open group with room. Group
unitaries are composed on the host in complex128 (error enters once per
group, not once per gate).

The JAX package can hand ``plan_groups`` to a C++ planner
(``tpu_qsim/native``); the port keeps only the Python planner, which that
package documents as the reference implementation with identical plans.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .circuit import Circuit, Gate
from . import gates as _gates
from .gates import op_matrix


@dataclass
class FusedGate:
    """A fused group: one dense unitary on a sorted qubit tuple.

    ``qubits`` is sorted descending so that ``qubits[0]`` (the matrix-index
    MSB) is the highest qubit — keeping the matrix convention uniform with
    single gates.
    """

    qubits: tuple[int, ...]
    matrix: np.ndarray  # (2^k, 2^k) complex128
    diagonal: bool      # True if every constituent gate was diagonal
    gate_count: int

    @property
    def diag(self) -> np.ndarray:
        return np.ascontiguousarray(np.diagonal(self.matrix))


def expand_matrix(
    u: np.ndarray, gate_qubits: tuple[int, ...], group_qubits: tuple[int, ...]
) -> np.ndarray:
    """Embed a gate matrix into the space of ``group_qubits``.

    Both matrices use the qubits[0]-is-MSB convention.
    """
    k = len(group_qubits)
    kp = len(gate_qubits)
    if kp == k and tuple(gate_qubits) == tuple(group_qubits):
        return u
    rest = [q for q in group_qubits if q not in gate_qubits]
    order = list(gate_qubits) + rest  # qubit owning each axis of `full`
    full = np.kron(u, np.eye(1 << (k - kp), dtype=np.complex128))
    perm = [order.index(q) for q in group_qubits]
    t = full.reshape((2,) * (2 * k))
    t = t.transpose(perm + [k + p for p in perm])
    return np.ascontiguousarray(t.reshape(1 << k, 1 << k))


def expand_diagonal(
    gd: np.ndarray, gate_qubits: tuple[int, ...], group_qubits: tuple[int, ...]
) -> np.ndarray:
    """Embed a diagonal gate's diagonal into the ``group_qubits`` space
    (both use the qubits[0]-is-MSB convention) without materializing dense
    matrices: out[b] = gd[bits of b at the gate's qubit positions]."""
    if tuple(gate_qubits) == tuple(group_qubits):
        return gd
    k = len(group_qubits)
    idx = np.arange(1 << k)
    b = np.zeros(1 << k, dtype=np.int64)
    for q in gate_qubits:  # MSB first
        pos = k - 1 - group_qubits.index(q)  # bit position of q in group index
        b = (b << 1) | ((idx >> pos) & 1)
    return gd[b]


class _OpenGroup:
    __slots__ = ("qubits", "gates")

    def __init__(self) -> None:
        self.qubits: set[int] = set()
        self.gates: list[Gate] = []

    def can_take(self, qubits: tuple[int, ...], max_k: int) -> bool:
        return len(self.qubits | set(qubits)) <= max_k

    def add(self, gate: Gate) -> None:
        self.qubits |= set(gate.qubits)
        self.gates.append(gate)


def plan_groups(circuit: Circuit, max_fused_qubits: int = 5) -> list[list[int]]:
    """Partition gate indices into fusable groups (order-preserving per qubit).

    Returns a list of groups, each a list of indices into ``circuit.gates``.
    Scheduling invariant: for any two gates sharing a qubit, their group
    order (and in-group order) preserves program order; gates in different
    groups with disjoint support may be reordered freely (they commute).
    """
    gates = circuit.gates
    groups: list[_OpenGroup] = []
    members: list[list[int]] = []
    # index of the latest group touching each qubit, -1 if none
    last_touch = [-1] * circuit.num_qubits

    for gi, gate in enumerate(gates):
        dep = max((last_touch[q] for q in gate.qubits), default=-1)
        placed = -1
        if dep >= 0 and groups[dep].can_take(gate.qubits, max_fused_qubits):
            placed = dep
        else:
            # Join any independent later group with room, else open a new one.
            for cand in range(max(dep + 1, 0), len(groups)):
                if groups[cand].can_take(gate.qubits, max_fused_qubits):
                    placed = cand
                    break
            if placed < 0:
                groups.append(_OpenGroup())
                members.append([])
                placed = len(groups) - 1
        groups[placed].add(gate)
        members[placed].append(gi)
        for q in gate.qubits:
            last_touch[q] = max(last_touch[q], placed)
    return members


def compose_group(gates: list[Gate], qubits: tuple[int, ...]) -> np.ndarray:
    """Product of the group's gates (program order) on ``qubits``.

    All-diagonal groups compose elementwise on the diagonals (matters for
    wide diagonal gates like mcz, where a dense matmul would be O(8^k))."""
    if all(g.name in _gates.DIAGONAL_GATES for g in gates):
        d = np.ones(1 << len(qubits), dtype=np.complex128)
        for g in gates:
            gd = np.diagonal(op_matrix(g))
            d = d * expand_diagonal(gd, g.qubits, qubits)
        return np.diag(d)
    u: np.ndarray | None = None
    for g in gates:
        gm = op_matrix(g)
        e = expand_matrix(gm, g.qubits, qubits)
        u = e.astype(np.complex128, copy=True) if u is None else e @ u
    return u


def fuse_circuit(circuit: Circuit, max_fused_qubits: int = 5) -> list[FusedGate]:
    """Full fusion pass: plan groups, compose unitaries."""
    gates = circuit.gates
    fused: list[FusedGate] = []
    for idxs in plan_groups(circuit, max_fused_qubits):
        group_gates = [gates[i] for i in idxs]
        qubits = tuple(sorted({q for g in group_gates for q in g.qubits},
                              reverse=True))
        matrix = compose_group(group_gates, qubits)
        diagonal = all(g.name in _gates.DIAGONAL_GATES for g in group_gates)
        fused.append(FusedGate(qubits, matrix, diagonal, len(group_gates)))
    return fused


def unfused_circuit(circuit: Circuit) -> list[FusedGate]:
    """Degenerate plan: one group per gate (for differential testing)."""
    out = []
    for g in circuit.gates:
        out.append(
            FusedGate(
                tuple(g.qubits),
                op_matrix(g),
                g.name in _gates.DIAGONAL_GATES,
                1,
            )
        )
    return out
