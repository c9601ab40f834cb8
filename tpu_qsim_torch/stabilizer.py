"""Stabilizer (Clifford) simulator: exact simulation at thousands of qubits.

A host-side copy of ``tpu_qsim/stabilizer.py``: it keeps numpy's
``default_rng``, so the same seed gives the same measurement outcomes in
both packages.

Beyond-reference capability: the reference (and every state-vector engine in
this package) is capped at MAX_QUBITS=30 by the 2^n amplitude vector
(reference include/Constants.hpp:68). Clifford circuits — H, S, Paulis,
CNOT/CZ/SWAP and Pauli measurements — admit the Aaronson–Gottesman CHP
tableau representation (arXiv:quant-ph/0406196): n-qubit states are tracked
as 2n Pauli rows (destabilizers + stabilizers) over GF(2) with a sign bit,
so memory is O(n^2) bits and every gate is an O(n) vectorized column
operation. A 1000-qubit GHZ state fits in ~0.5 MB.

This is a host-side component by design, like :mod:`tpu_qsim_torch.cpu_reference`:
the tableau updates are bitwise row/column ops on uint8 NumPy arrays —
branchy, tiny, and latency-bound, i.e. exactly what a GPU's tensor cores are NOT
for — while the API mirrors the simulator families (``run`` / ``sample`` /
``measure_qubit`` / ``expectation_pauli`` / ``reset``) so Clifford workloads
(GHZ/graph-state prep, syndrome extraction, shadow snapshots) slot into the
same harnesses.

Width note: :class:`~tpu_qsim_torch.Circuit` is capped at ``MAX_QUBITS=30`` (the
cap protects the amplitude engines; the IR shares it). For wider registers
``run()`` also accepts a :class:`CliffordCircuit` — a host-side Clifford-only
program representation capped at ``MAX_STABILIZER_QUBITS`` — so 1000-qubit
GHZ prep is one ``run(CliffordCircuit.ghz(1000))`` call, QASM-free harnesses
included. ``apply_gate`` remains available for imperative driving.

Supported gates: i x y z h s sdg cnot cz swap (the Clifford subset of
:mod:`tpu_qsim_torch.gates`). Non-Clifford gates raise ``ValueError`` naming the
offender — use a state-vector simulator for those circuits.
"""

from __future__ import annotations

import numpy as np

from .circuit import Circuit

__all__ = ["StabilizerSimulator", "CliffordCircuit", "CLIFFORD_GATES"]

CLIFFORD_GATES = frozenset(
    {"i", "x", "y", "z", "h", "s", "sdg", "cnot", "cz", "swap"}
)
_CLIFFORD_ARITY = {g: (2 if g in ("cnot", "cz", "swap") else 1)
                   for g in CLIFFORD_GATES}


def _g_sum(x1, z1, x2, z2) -> int:
    """Sum over columns of Aaronson-Gottesman g(x1,z1,x2,z2): the exponent
    of i contributed by multiplying Pauli (x1,z1) into Pauli (x2,z2)."""
    x1 = x1.astype(np.int32); z1 = z1.astype(np.int32)
    x2 = x2.astype(np.int32); z2 = z2.astype(np.int32)
    g = (
        (x1 & z1) * (z2 - x2)                   # source op is Y
        + (x1 & (1 - z1)) * z2 * (2 * x2 - 1)   # source op is X
        + ((1 - x1) & z1) * x2 * (1 - 2 * z2)   # source op is Z
    )
    return int(g.sum())

# Upper bound only to keep tableaux (2n x 2n bits) and per-shot sampling
# costs sane; far beyond any amplitude-based engine's reach.
MAX_STABILIZER_QUBITS = 4096


class _CGate:
    """One Clifford op: duck-types circuit.Gate for StabilizerSimulator.run."""

    __slots__ = ("name", "qubits", "param")

    def __init__(self, name: str, qubits: tuple[int, ...]):
        self.name = name
        self.qubits = qubits
        self.param = None

    def __repr__(self) -> str:
        return f"{self.name}{self.qubits}"


class CliffordCircuit:
    """Host-side Clifford-only circuit for registers wider than 30 qubits.

    :class:`~tpu_qsim_torch.circuit.Circuit` is capped at ``MAX_QUBITS=30`` to
    protect the 2^n amplitude engines; Clifford workloads have no such
    physics limit, so this representation carries the same fluent-builder
    surface for the Clifford gate set up to ``MAX_STABILIZER_QUBITS``
    qubits and is accepted by :meth:`StabilizerSimulator.run`. Gates are
    validated on insertion (Clifford name, arity, range, distinct qubits)
    so errors carry the offending op, not a mid-run tableau state.
    """

    def __init__(self, num_qubits: int):
        if not (1 <= num_qubits <= MAX_STABILIZER_QUBITS):
            raise ValueError(
                f"CliffordCircuit supports 1..{MAX_STABILIZER_QUBITS} "
                f"qubits, got {num_qubits}"
            )
        self.num_qubits = int(num_qubits)
        self._gates: list[_CGate] = []

    # -- construction --------------------------------------------------------

    def add(self, name: str, *qubits: int) -> "CliffordCircuit":
        if name not in CLIFFORD_GATES:
            raise ValueError(
                f"gate {name!r} is not Clifford; supported: "
                f"{sorted(CLIFFORD_GATES)}"
            )
        if len(qubits) != _CLIFFORD_ARITY[name]:
            raise ValueError(
                f"gate {name!r} takes {_CLIFFORD_ARITY[name]} qubit(s), "
                f"got {len(qubits)}"
            )
        for q in qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(
                    f"qubit index {q} out of range for "
                    f"{self.num_qubits}-qubit circuit"
                )
        if len(set(qubits)) != len(qubits):
            raise ValueError(f"gate {name!r} qubits must be distinct: {qubits}")
        self._gates.append(_CGate(name, tuple(int(q) for q in qubits)))
        return self

    def i(self, q: int) -> "CliffordCircuit": return self.add("i", q)
    def x(self, q: int) -> "CliffordCircuit": return self.add("x", q)
    def y(self, q: int) -> "CliffordCircuit": return self.add("y", q)
    def z(self, q: int) -> "CliffordCircuit": return self.add("z", q)
    def h(self, q: int) -> "CliffordCircuit": return self.add("h", q)
    def s(self, q: int) -> "CliffordCircuit": return self.add("s", q)
    def sdg(self, q: int) -> "CliffordCircuit": return self.add("sdg", q)
    def cnot(self, c: int, t: int) -> "CliffordCircuit": return self.add("cnot", c, t)
    cx = cnot
    def cz(self, c: int, t: int) -> "CliffordCircuit": return self.add("cz", c, t)
    def swap(self, a: int, b: int) -> "CliffordCircuit": return self.add("swap", a, b)

    # -- views ----------------------------------------------------------------

    @property
    def gates(self) -> list[_CGate]:
        return list(self._gates)

    @property
    def num_gates(self) -> int:
        return len(self._gates)

    def __len__(self) -> int:
        return len(self._gates)

    def __iter__(self):
        return iter(self._gates)

    def inverse(self) -> "CliffordCircuit":
        """Adjoint program: reversed order; s <-> sdg, the rest are
        self-inverse Cliffords."""
        inv = CliffordCircuit(self.num_qubits)
        flip = {"s": "sdg", "sdg": "s"}
        for g in reversed(self._gates):
            inv.add(flip.get(g.name, g.name), *g.qubits)
        return inv

    # -- interop / factories ---------------------------------------------------

    @classmethod
    def from_circuit(cls, circuit: Circuit) -> "CliffordCircuit":
        """Lift a (<= 30q) :class:`Circuit` whose gates are all Clifford;
        raises ValueError naming the first non-Clifford gate."""
        c = cls(circuit.num_qubits)
        for g in circuit.gates:
            name = "cnot" if g.name == "cx" else g.name
            if name not in CLIFFORD_GATES:
                raise ValueError(
                    f"gate {g.name!r} is not Clifford; cannot lift to "
                    "CliffordCircuit"
                )
            c.add(name, *g.qubits)
        return c

    @classmethod
    def ghz(cls, num_qubits: int) -> "CliffordCircuit":
        """H + CNOT chain: the wide-register GHZ factory
        (mirrors tpu_qsim_torch.ghz_circuit beyond the 30-qubit cap)."""
        c = cls(num_qubits)
        c.h(0)
        for q in range(1, num_qubits):
            c.cnot(q - 1, q)
        return c


class StabilizerSimulator:
    """CHP tableau simulator over uint8 bit-planes.

    Layout: ``x``/``z`` are (2n, n) bit matrices, ``r`` a (2n,) sign vector
    (0 -> +1, 1 -> -1). Rows [0, n) are destabilizers, rows [n, 2n) the
    stabilizer generators. The initial state |0...0> has destabilizer X_i
    and stabilizer Z_i per qubit.
    """

    def __init__(self, num_qubits: int, *, seed: int = 0):
        if not (1 <= num_qubits <= MAX_STABILIZER_QUBITS):
            raise ValueError(
                f"stabilizer simulator supports 1..{MAX_STABILIZER_QUBITS} "
                f"qubits, got {num_qubits}"
            )
        self.num_qubits = int(num_qubits)
        self._rng = np.random.default_rng(seed)
        self.reset()

    # -- state ---------------------------------------------------------------

    def reset(self) -> None:
        n = self.num_qubits
        self.x = np.zeros((2 * n, n), dtype=np.uint8)
        self.z = np.zeros((2 * n, n), dtype=np.uint8)
        self.r = np.zeros(2 * n, dtype=np.uint8)
        self.x[np.arange(n), np.arange(n)] = 1          # destabilizers X_i
        self.z[n + np.arange(n), np.arange(n)] = 1      # stabilizers   Z_i

    def set_seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def memory_bytes(self) -> int:
        return self.x.nbytes + self.z.nbytes + self.r.nbytes

    def copy(self) -> "StabilizerSimulator":
        """Independent copy: same tableau, its own (spawned) RNG stream so
        measurements on the copy neither advance nor correlate with the
        original's stream. (sample() overrides the scratch copy's RNG with
        its own per-call stream.)"""
        c = StabilizerSimulator.__new__(StabilizerSimulator)
        c.num_qubits = self.num_qubits
        c._rng = self._rng.spawn(1)[0]
        c.x, c.z, c.r = self.x.copy(), self.z.copy(), self.r.copy()
        return c

    # -- gates -----------------------------------------------------------------

    def apply_gate(self, name: str, *qubits: int, param: float | None = None) -> None:
        for q in qubits:
            if not (0 <= q < self.num_qubits):
                raise ValueError(
                    f"qubit index {q} out of range for "
                    f"{self.num_qubits}-qubit simulator"
                )
        if name not in CLIFFORD_GATES:
            raise ValueError(
                f"gate {name!r} is not Clifford; the stabilizer simulator "
                f"supports {sorted(CLIFFORD_GATES)} — use "
                "StateVectorSimulator for universal circuits"
            )
        x, z, r = self.x, self.z, self.r
        if name == "i":
            return
        if name == "h":
            (q,) = qubits
            r ^= x[:, q] & z[:, q]
            x[:, q], z[:, q] = z[:, q].copy(), x[:, q].copy()
        elif name == "s":
            (q,) = qubits
            r ^= x[:, q] & z[:, q]
            z[:, q] ^= x[:, q]
        elif name == "sdg":
            (q,) = qubits
            # S^dagger = Z . S: conjugate by Z first (X,Y flip sign), then S
            r ^= x[:, q]
            r ^= x[:, q] & z[:, q]
            z[:, q] ^= x[:, q]
        elif name == "x":
            (q,) = qubits
            r ^= z[:, q]
        elif name == "z":
            (q,) = qubits
            r ^= x[:, q]
        elif name == "y":
            (q,) = qubits
            r ^= x[:, q] ^ z[:, q]
        elif name == "cnot":
            c, t = qubits
            r ^= x[:, c] & z[:, t] & (x[:, t] ^ z[:, c] ^ 1)
            x[:, t] ^= x[:, c]
            z[:, c] ^= z[:, t]
        elif name == "cz":
            c, t = qubits
            # CZ = H(t) CNOT(c,t) H(t), inlined
            r ^= x[:, t] & z[:, t]
            x[:, t], z[:, t] = z[:, t].copy(), x[:, t].copy()
            r ^= x[:, c] & z[:, t] & (x[:, t] ^ z[:, c] ^ 1)
            x[:, t] ^= x[:, c]
            z[:, c] ^= z[:, t]
            r ^= x[:, t] & z[:, t]
            x[:, t], z[:, t] = z[:, t].copy(), x[:, t].copy()
        elif name == "swap":
            a, b = qubits
            x[:, [a, b]] = x[:, [b, a]]
            z[:, [a, b]] = z[:, [b, a]]
        else:  # pragma: no cover — CLIFFORD_GATES is exhaustive above
            raise AssertionError(name)

    def run(
        self, circuit: "Circuit | CliffordCircuit"
    ) -> "StabilizerSimulator":
        """Execute a :class:`~tpu_qsim_torch.Circuit` (<= 30 qubits) or a
        :class:`CliffordCircuit` (wide registers) on the tableau."""
        if circuit.num_qubits != self.num_qubits:
            raise ValueError(
                f"circuit has {circuit.num_qubits} qubits, simulator has "
                f"{self.num_qubits}"
            )
        for g in circuit.gates:
            self.apply_gate(g.name, *g.qubits, param=g.param)
        return self

    # -- phase-exact row multiplication (CHP "rowsum") -------------------------

    def _rowsum(self, h: int, i: int) -> None:
        """Row h <- (row i) . (row h), phases tracked mod 4.

        For stabilizer-row targets the result is Hermitian (phase 0 or 2);
        destabilizer-row targets may pick up +/-i against an anticommuting
        source row, but destabilizer signs are never read (they exist only
        for the X/Z-bit pairing), so the mod-4 -> sign-bit clamp is safe —
        same convention as the CHP reference implementation."""
        ph = (
            2 * (int(self.r[h]) + int(self.r[i]))
            + _g_sum(self.x[i], self.z[i], self.x[h], self.z[h])
        ) % 4
        if h >= self.num_qubits:
            assert ph in (0, 2), "stabilizer rowsum must stay Hermitian"
        self.r[h] = (ph >> 1) & 1
        self.x[h] ^= self.x[i]
        self.z[h] ^= self.z[i]

    # -- measurement -----------------------------------------------------------

    def measure_qubit(self, qubit: int, *, _forced: int | None = None) -> int:
        """Measure one qubit in Z, collapsing the tableau (CHP Section III)."""
        if not (0 <= qubit < self.num_qubits):
            raise ValueError(
                f"qubit index {qubit} out of range for "
                f"{self.num_qubits}-qubit simulator"
            )
        n = self.num_qubits
        stab = np.nonzero(self.x[n:, qubit])[0]
        if stab.size:  # random outcome
            p = int(stab[0]) + n
            for h in np.nonzero(self.x[:, qubit])[0]:
                if h != p:
                    self._rowsum(int(h), p)
            self.x[p - n] = self.x[p]
            self.z[p - n] = self.z[p]
            self.r[p - n] = self.r[p]
            outcome = (
                int(self._rng.integers(2)) if _forced is None else int(_forced)
            )
            self.x[p] = 0
            self.z[p] = 0
            self.z[p, qubit] = 1
            self.r[p] = outcome
            return outcome
        # deterministic outcome: accumulate into a scratch row
        sx = np.zeros(self.num_qubits, dtype=np.uint8)
        sz = np.zeros(self.num_qubits, dtype=np.uint8)
        phase = 0
        for i in np.nonzero(self.x[:n, qubit])[0]:
            j = int(i) + n
            phase = (
                phase + 2 * int(self.r[j]) + _g_sum(self.x[j], self.z[j], sx, sz)
            ) % 4
            sx ^= self.x[j]
            sz ^= self.z[j]
        assert phase in (0, 2)
        return int(phase // 2)

    def sample(self, shots: int, *, seed: int | None = None) -> np.ndarray:
        """Sample ``shots`` full computational-basis outcomes (as integers for
        n <= 62, else as (shots, n) bit arrays) without collapsing the state."""
        if shots < 1:
            raise ValueError("shots must be >= 1")
        rng = np.random.default_rng(seed) if seed is not None else self._rng
        wide = self.num_qubits > 62
        out_bits = np.zeros((shots, self.num_qubits), dtype=np.uint8) if wide \
            else None
        out_ints = np.zeros(shots, dtype=np.int64) if not wide else None
        for s in range(shots):
            scratch = self.copy()
            scratch._rng = rng
            val = 0
            for q in range(self.num_qubits):
                b = scratch.measure_qubit(q)
                if wide:
                    out_bits[s, q] = b
                else:
                    val |= b << q
            if not wide:
                out_ints[s] = val
        return out_bits if wide else out_ints

    def histogram(self, shots: int, *, seed: int | None = None) -> dict[int, int]:
        if self.num_qubits > 62:
            raise ValueError("histogram keys overflow beyond 62 qubits; use sample()")
        vals, counts = np.unique(self.sample(shots, seed=seed), return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}

    # -- observables -----------------------------------------------------------

    def expectation_pauli(self, pauli: str) -> float:
        """<P> for a Pauli string: exactly -1.0, 0.0, or +1.0 for a
        stabilizer state. Same convention as every other simulator family
        (base.BaseSimulator.expectation_pauli): the string reads like a ket —
        rightmost character acts on qubit 0; shorter strings are padded with
        identities on the high qubits."""
        pauli = pauli.upper()
        if len(pauli) > self.num_qubits or not set(pauli) <= set("IXYZ"):
            raise ValueError(f"invalid Pauli string {pauli!r}")
        px = np.zeros(self.num_qubits, dtype=np.uint8)
        pz = np.zeros(self.num_qubits, dtype=np.uint8)
        for i, ch in enumerate(pauli):
            q = len(pauli) - 1 - i  # rightmost char = qubit 0
            if ch == "X":
                px[q] = 1
            elif ch == "Z":
                pz[q] = 1
            elif ch == "Y":
                px[q] = pz[q] = 1
        n = self.num_qubits
        # anticommutes with any stabilizer generator -> expectation 0
        anti = ((self.x[n:] & pz[None, :]) ^ (self.z[n:] & px[None, :])).sum(1) % 2
        if anti.any():
            return 0.0
        # P is +/- a product of stabilizer generators; which ones is read off
        # the destabilizer pairing: include generator i iff P anticommutes
        # with destabilizer i. Accumulate the product's sign.
        sel = ((self.x[:n] & pz[None, :]) ^ (self.z[:n] & px[None, :])).sum(1) % 2
        sx = np.zeros(n, dtype=np.uint8)
        sz = np.zeros(n, dtype=np.uint8)
        phase = 0
        for i in np.nonzero(sel)[0]:
            j = int(i) + n
            phase = (
                phase + 2 * int(self.r[j]) + _g_sum(self.x[j], self.z[j], sx, sz)
            ) % 4
            sx ^= self.x[j]
            sz ^= self.z[j]
        if not (np.array_equal(sx, px) and np.array_equal(sz, pz)):
            # product of Y = iXZ factors differs from P by i-powers that the
            # bit compare would miss only on a logic error
            raise AssertionError("stabilizer decomposition mismatch")
        assert phase in (0, 2)
        return 1.0 if phase == 0 else -1.0

    def qubit_probability(self, qubit: int) -> float:
        """P(measuring |1> on ``qubit``): exactly 0, 1/2 or 1."""
        if not (0 <= qubit < self.num_qubits):
            raise ValueError(f"qubit index {qubit} out of range")
        e = self.expectation_pauli("Z" + "I" * qubit)  # ket order: pad low side
        return (1.0 - e) / 2.0
