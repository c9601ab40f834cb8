"""Gate commutation analysis + dependency-DAG frontier scheduling.

A copy of ``tpu_qsim/commute.py``. The port's grid-sweep planner
(:mod:`tpu_qsim_torch.kernels.gridsweeps`) and the 1q-chain fold
(:func:`tpu_qsim_torch.kernels.fused_circuit.merge_1q_chains`) use it to pull
commuting gates forward, so gates that fit the current sweep's block-local
qubit set run before gates that would force another full-state sweep.

Soundness rule (conservative, per-qubit): two gates commute if their qubit
sets are disjoint, or if on EVERY shared qubit both act within the same
single-qubit eigenbasis class:

* ``DIAG`` — the gate is block-diagonal w.r.t. the computational (Z) basis of
  that qubit: any diagonal gate on all its qubits, a control qubit of
  cnot/cry/toffoli.
* ``FLIP`` — block-diagonal w.r.t. the X basis: ``x`` on its qubit, the
  target of cnot/toffoli.

If both gates decompose as sums of same-basis projectors on each shared
qubit tensored with operators on disjoint remainders, the products agree
termwise, so they commute. Anything else (``OTHER``) is treated as
non-commuting. The reference has no analog — its executor is strictly
sequential (reference src/Simulator.cu:28-36).
"""

from __future__ import annotations

from .circuit import Gate

DIAG = 0
FLIP = 1
OTHER = 2

# gates diagonal on every qubit they touch
_DIAGONAL_NAMES = frozenset(
    {"i", "z", "s", "sdg", "t", "tdg", "rz", "p", "cz", "crz", "cp"}
)


def qubit_classes(gate) -> tuple[int, ...]:
    """Per-qubit commutation class, aligned with ``gate.qubits``.

    Accepts either a named :class:`~tpu_qsim_torch.circuit.Gate` or any planner
    object carrying a precomputed ``classes`` tuple (the matrix-backed
    ``PGate`` of :mod:`tpu_qsim_torch.kernels.fused_circuit`)."""
    cls = getattr(gate, "classes", None)
    if cls is not None:
        return cls
    name = gate.name
    if name in _DIAGONAL_NAMES or name.startswith("mcz"):
        return (DIAG,) * len(gate.qubits)
    if name in ("x", "rx"):  # rx = exp(-i theta X/2): X-basis diagonal
        return (FLIP,)
    if name == "cnot":
        return (DIAG, FLIP)
    if name == "cry":
        return (DIAG, OTHER)
    if name == "toffoli":
        return (DIAG, DIAG, FLIP)
    from .gates import DIAGONAL_GATES

    if name in DIAGONAL_GATES:  # user-registered diagonal gates
        return (DIAG,) * len(gate.qubits)
    return (OTHER,) * len(gate.qubits)


def gates_commute(a: Gate, b: Gate) -> bool:
    shared = set(a.qubits) & set(b.qubits)
    if not shared:
        return True
    ca = qubit_classes(a)
    cb = qubit_classes(b)
    for q in shared:
        x = ca[a.qubits.index(q)]
        y = cb[b.qubits.index(q)]
        if x != y or x == OTHER:
            return False
    return True


def dependency_edges(gates: list[Gate]) -> list[list[int]]:
    """``preds[j]`` = indices i < j whose gate must run before gate j.

    Transitively-redundant edges are kept (harmless for frontier scheduling);
    O(G^2) pair tests.
    """
    preds: list[list[int]] = [[] for _ in gates]
    for j in range(len(gates)):
        for i in range(j):
            if not gates_commute(gates[i], gates[j]):
                preds[j].append(i)
    return preds


class FrontierScheduler:
    """Incremental ready-set tracker over the commutation DAG.

    ``ready()`` yields gate indices whose predecessors have all been emitted;
    planners pick whichever ready gate suits them and call ``emit(i)``.
    Always emitting the lowest ready index reproduces program order.
    """

    def __init__(self, gates: list[Gate]):
        self.gates = gates
        self._preds = dependency_edges(gates)
        self._missing = [len(p) for p in self._preds]
        self._succs: list[list[int]] = [[] for _ in gates]
        for j, ps in enumerate(self._preds):
            for i in ps:
                self._succs[i].append(j)
        self._ready = sorted(
            i for i, m in enumerate(self._missing) if m == 0
        )
        self._emitted = [False] * len(gates)

    def ready(self) -> list[int]:
        return list(self._ready)

    def done(self) -> bool:
        return not self._ready

    def emit(self, i: int) -> None:
        if self._emitted[i] or self._missing[i] != 0:
            raise ValueError(f"gate {i} is not ready")
        self._emitted[i] = True
        self._ready.remove(i)
        for j in self._succs[i]:
            self._missing[j] -= 1
            if self._missing[j] == 0 and not self._emitted[j]:
                # keep ready sorted so program order is the tiebreak
                import bisect

                bisect.insort(self._ready, j)
