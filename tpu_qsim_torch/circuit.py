"""Circuit IR: gate ops, fluent builder, factories.

Pure Python, no JAX dependency — the IR is completely decoupled from
execution, mirroring the reference's key structural property (one IR, many
interpreters; reference include/Circuit.hpp:42-144, src/Circuit.cpp:58-282).
Each simulator backend interprets the same ``Circuit.gates`` list with its own
execution strategy (torch engine, CUDA grid-sweep kernel, NumPy oracle).
A copy of ``tpu_qsim/circuit.py``: ``random_circuit`` draws the same gate
list from the same seed.

Endianness: qubit ``q`` is bit ``q`` of the flat state index (documented in
:mod:`tpu_qsim_torch.gates`).
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Iterable, Iterator

from .gates import GATE_ARITY, GATE_NAMES, PARAM_GATES

MAX_QUBITS = 30  # reference cuda_config::MAX_QUBITS parity; also keeps the
# flat int32 iota index masks of the readout path in range (2^30 < 2^31-1)


@dataclass(frozen=True)
class Gate:
    """One gate operation: name + qubit tuple + optional parameter.

    The analog of the reference's ``GateOp`` (include/Circuit.hpp:64-84), but
    name-keyed instead of enum-keyed so user-defined gates can plug in later.

    ``matrix_bytes`` optionally carries a circuit-local unitary inline (the
    row-major complex128 buffer of a (2^k, 2^k) matrix): such a gate does not
    touch the process-global registry at all — its name is a display label —
    and backends resolve it via :func:`tpu_qsim_torch.gates.op_matrix`. The payload
    participates in equality/hashing (compile caches key on ``signature()``),
    and ``bytes`` keeps the dataclass hashable.
    """

    name: str
    qubits: tuple[int, ...]
    param: float | None = None
    matrix_bytes: bytes | None = None

    def __post_init__(self) -> None:
        if len(set(self.qubits)) != len(self.qubits):
            raise ValueError(f"gate '{self.name}' qubits must be distinct: {self.qubits}")
        if self.matrix_bytes is not None:
            if self.param is not None:
                raise ValueError("inline-matrix gates take no parameter")
            dim = 1 << len(self.qubits)
            if len(self.matrix_bytes) != dim * dim * 16:
                raise ValueError(
                    f"inline matrix payload is {len(self.matrix_bytes)} bytes; "
                    f"a {len(self.qubits)}-qubit gate needs {dim * dim * 16} "
                    f"(row-major complex128)"
                )
            return
        if self.name not in GATE_NAMES:
            raise ValueError(f"unknown gate '{self.name}'")
        arity = GATE_ARITY[self.name]
        if len(self.qubits) != arity:
            raise ValueError(
                f"gate '{self.name}' acts on {arity} qubit(s), got {self.qubits}"
            )
        if self.name in PARAM_GATES:
            if self.param is None:
                raise ValueError(f"gate '{self.name}' requires a parameter")
        elif self.param is not None:
            raise ValueError(f"gate '{self.name}' takes no parameter")

    @property
    def arity(self) -> int:
        return len(self.qubits)

    @property
    def matrix(self):
        """The inline unitary as an ndarray, or None for registry gates."""
        if self.matrix_bytes is None:
            return None
        import numpy as np

        dim = 1 << len(self.qubits)
        return np.frombuffer(self.matrix_bytes, dtype=np.complex128).reshape(
            dim, dim
        )


class Circuit:
    """Fluent, validated circuit builder.

    Mirrors the reference's chaining API (include/Circuit.hpp:94-112):

    >>> c = Circuit(2).h(0).cnot(0, 1)
    """

    def __init__(self, num_qubits: int):
        if not (1 <= num_qubits <= MAX_QUBITS):
            raise ValueError(
                f"num_qubits must be in [1, {MAX_QUBITS}], got {num_qubits}"
            )
        self._num_qubits = int(num_qubits)
        self._gates: list[Gate] = []

    # -- introspection ------------------------------------------------------

    @property
    def num_qubits(self) -> int:
        return self._num_qubits

    @property
    def gates(self) -> list[Gate]:
        return list(self._gates)

    def __len__(self) -> int:
        return len(self._gates)

    def __iter__(self) -> Iterator[Gate]:
        return iter(self._gates)

    def depth(self) -> int:
        """Schedule depth: greedy per-qubit leveling.

        Same algorithm as reference ``Circuit::getDepth`` (src/Circuit.cpp:
        165-182): each gate lands at 1 + max(level of its qubits).
        """
        level = [0] * self._num_qubits
        for g in self._gates:
            new = 1 + max(level[q] for q in g.qubits)
            for q in g.qubits:
                level[q] = new
        return max(level, default=0)

    def inverse(self) -> "Circuit":
        """The adjoint circuit: gates reversed, each replaced by its inverse.

        ``c.inverse()`` after ``c`` restores any input state — the standard
        self-certification for sizes where a full oracle state is
        impractical (U-dagger U |0...0> = |0...0>). Library gates invert by
        name/parameter; registered fixed-matrix gates invert as an inline
        ``matrix_bytes`` adjoint carried by the inverse circuit itself — no
        global registration side effect. The reference has no analog (its
        circuits are forward-only, reference include/Circuit.hpp:94-122)."""
        import numpy as np

        from .gates import PARAM_GATES, gate_matrix

        self_inverse = {
            "i", "x", "y", "z", "h", "cnot", "cx", "cz", "swap",
            "toffoli", "ccx",
        }
        pairs = {"s": "sdg", "sdg": "s", "t": "tdg", "tdg": "t"}
        neg_param = {"rx", "ry", "rz", "p", "cry", "crz", "cp"}
        inv = Circuit(self._num_qubits)
        for g in reversed(self._gates):
            nm = g.name
            if g.matrix_bytes is not None:
                adj = g.matrix.conj().T
                dag = nm[: -len("__dag")] if nm.endswith("__dag") else nm + "__dag"
                inv.append(
                    Gate(
                        dag,
                        g.qubits,
                        matrix_bytes=np.ascontiguousarray(adj).tobytes(),
                    )
                )
            elif (
                nm in self_inverse
                or nm.startswith("mcz")
                or nm.startswith("mcx")
            ):
                inv.append(g)
            elif nm in pairs:
                inv.add(pairs[nm], *g.qubits)
            elif nm in neg_param:
                inv.add(nm, *g.qubits, param=-g.param)
            elif nm in PARAM_GATES:
                raise ValueError(
                    f"cannot invert registered parameterized gate '{nm}'"
                )
            else:
                adj = np.ascontiguousarray(gate_matrix(nm).conj().T)
                inv.append(
                    Gate(nm + "__dag", g.qubits, matrix_bytes=adj.tobytes())
                )
        return inv

    def __repr__(self) -> str:
        return f"Circuit(num_qubits={self._num_qubits}, gates={len(self._gates)})"

    def to_string(self) -> str:
        """Human-readable listing (analog of reference Circuit::toString,
        src/Circuit.cpp:184-228)."""
        lines = [f"Circuit({self._num_qubits} qubits, {len(self._gates)} gates, "
                 f"depth {self.depth()})"]
        for i, g in enumerate(self._gates):
            param = f", {g.param:.6g}" if g.param is not None else ""
            qubits = ", ".join(map(str, g.qubits))
            lines.append(f"  {i:4d}: {g.name}({qubits}{param})")
        return "\n".join(lines)

    # -- structural equality / hashing (used by compilation caches) ---------

    def signature(self) -> tuple:
        """Hashable full description (params included)."""
        return (self._num_qubits, tuple(self._gates))

    def structure(self) -> tuple:
        """Hashable description with parameters abstracted out — two circuits
        with the same structure can share a compiled executable that takes
        the parameter vector as a traced argument."""
        return (
            self._num_qubits,
            tuple((g.name, g.qubits, g.param is not None) for g in self._gates),
        )

    def params(self) -> list[float]:
        return [g.param for g in self._gates if g.param is not None]

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Circuit) and self.signature() == other.signature()

    def __hash__(self) -> int:
        return hash(self.signature())

    # -- building -----------------------------------------------------------

    def _check_qubit(self, q: int) -> None:
        if not (0 <= q < self._num_qubits):
            raise ValueError(
                f"qubit index {q} out of range for {self._num_qubits}-qubit circuit"
            )

    def append(self, gate: Gate) -> "Circuit":
        for q in gate.qubits:
            self._check_qubit(q)
        self._gates.append(gate)
        return self

    def add(self, name: str, *qubits: int, param: float | None = None) -> "Circuit":
        return self.append(Gate(name, tuple(qubits), param))

    def extend(self, gates: Iterable[Gate]) -> "Circuit":
        for g in gates:
            self.append(g)
        return self

    # one fluent method per gate (reference include/Circuit.hpp:94-112)
    def i(self, q: int) -> "Circuit": return self.add("i", q)
    def x(self, q: int) -> "Circuit": return self.add("x", q)
    def y(self, q: int) -> "Circuit": return self.add("y", q)
    def z(self, q: int) -> "Circuit": return self.add("z", q)
    def h(self, q: int) -> "Circuit": return self.add("h", q)
    def s(self, q: int) -> "Circuit": return self.add("s", q)
    def sdg(self, q: int) -> "Circuit": return self.add("sdg", q)
    def t(self, q: int) -> "Circuit": return self.add("t", q)
    def tdg(self, q: int) -> "Circuit": return self.add("tdg", q)

    def rx(self, q: int, theta: float) -> "Circuit": return self.add("rx", q, param=theta)
    def ry(self, q: int, theta: float) -> "Circuit": return self.add("ry", q, param=theta)
    def rz(self, q: int, theta: float) -> "Circuit": return self.add("rz", q, param=theta)
    def p(self, q: int, lam: float) -> "Circuit": return self.add("p", q, param=lam)

    def cnot(self, control: int, target: int) -> "Circuit":
        return self.add("cnot", control, target)

    cx = cnot  # alias, reference include/Circuit.hpp:106

    def cz(self, control: int, target: int) -> "Circuit":
        return self.add("cz", control, target)

    def swap(self, a: int, b: int) -> "Circuit":
        return self.add("swap", a, b)

    def cry(self, control: int, target: int, theta: float) -> "Circuit":
        return self.add("cry", control, target, param=theta)

    def crz(self, control: int, target: int, theta: float) -> "Circuit":
        return self.add("crz", control, target, param=theta)

    def cp(self, control: int, target: int, lam: float) -> "Circuit":
        return self.add("cp", control, target, param=lam)

    def toffoli(self, c1: int, c2: int, target: int) -> "Circuit":
        return self.add("toffoli", c1, c2, target)

    ccx = toffoli  # alias, reference include/Circuit.hpp:112

    def mcz(self, *qubits: int) -> "Circuit":
        """Multi-controlled Z: phase -1 iff every qubit is |1>.

        Symmetric in its qubits; applied as a single diagonal gate on every
        backend (one masked multiply), up to 10 qubits. The reference had no
        multi-controlled primitive beyond Toffoli."""
        from .gates import multi_controlled_z_name

        return self.add(multi_controlled_z_name(len(qubits)), *qubits)

    def mcx(self, *qubits: int) -> "Circuit":
        """Multi-controlled X: ``mcx(c1, ..., ck, target)``.

        k <= 2 controls use the native cnot/toffoli; beyond that it is the
        exact ancilla-free identity MCX = H(t) . MCZ(c..., t) . H(t), with
        the MCZ a single diagonal gate (so an mcx costs ~2 H passes + one
        multiply — no Barenco Toffoli ladder)."""
        if len(qubits) < 2:
            raise ValueError("mcx needs at least one control and a target")
        *controls, target = qubits
        if len(controls) == 1:
            return self.cnot(controls[0], target)
        if len(controls) == 2:
            return self.toffoli(controls[0], controls[1], target)
        return self.h(target).mcz(*controls, target).h(target)


# ---------------------------------------------------------------------------
# Factory circuits (reference src/Circuit.cpp:234-282)
# ---------------------------------------------------------------------------

def bell_circuit() -> Circuit:
    """|Phi+> = (|00> + |11>)/sqrt(2)."""
    return Circuit(2).h(0).cnot(0, 1)


def ghz_circuit(num_qubits: int) -> Circuit:
    if num_qubits < 2:
        raise ValueError("GHZ circuit requires at least 2 qubits")
    c = Circuit(num_qubits).h(0)
    for i in range(num_qubits - 1):
        c.cnot(i, i + 1)
    return c


def qft_circuit(num_qubits: int) -> Circuit:
    """Quantum Fourier transform (with final qubit-order reversal swaps).

    Beyond the reference's factory set — a standard dense-entangling workload
    whose controlled-phase ladder exercises crz/swap heavily.
    """
    import math

    c = Circuit(num_qubits)
    for target in range(num_qubits - 1, -1, -1):
        c.h(target)
        for k, control in enumerate(range(target - 1, -1, -1), start=2):
            c.cp(control, target, math.pi / (1 << (k - 1)))
    for i in range(num_qubits // 2):
        c.swap(i, num_qubits - 1 - i)
    return c


def hardware_efficient_ansatz(
    num_qubits: int, layers: int, seed: int = 0
) -> Circuit:
    """Variational ansatz: per-layer Ry/Rz on every qubit + CNOT ring.

    The standard VQE building block; pairs with the parameterized-execution
    API (StateVectorSimulator.run_parameterized)."""
    rng = random.Random(seed)
    c = Circuit(num_qubits)
    for _ in range(layers):
        for q in range(num_qubits):
            c.ry(q, rng.uniform(0, 6.283185307179586))
            c.rz(q, rng.uniform(0, 6.283185307179586))
        if num_qubits > 1:
            for q in range(num_qubits):
                c.cnot(q, (q + 1) % num_qubits)
    return c


def random_circuit(num_qubits: int, num_gates: int, seed: int = 42) -> Circuit:
    """Seeded random H/X/CNOT/Rz circuit.

    Same gate mix as reference ``createRandomCircuit`` (src/Circuit.cpp:
    252-282); the RNG stream differs (Python ``random`` vs ``std::mt19937``
    distributions) but the ensemble is the same.
    """
    rng = random.Random(seed)
    c = Circuit(num_qubits)
    for _ in range(num_gates):
        kind = rng.randrange(4)
        q1 = rng.randrange(num_qubits)
        if kind == 0:
            c.h(q1)
        elif kind == 1:
            c.x(q1)
        elif kind == 2:
            if num_qubits > 1:
                q2 = rng.randrange(num_qubits)
                while q2 == q1:
                    q2 = rng.randrange(num_qubits)
                c.cnot(q1, q2)
            else:
                c.h(q1)
        else:
            c.rz(q1, rng.uniform(0.0, 6.283185307179586))
    return c
