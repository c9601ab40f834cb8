"""NumPy reference simulator — the correctness oracle.

The analog of the reference's ``CPUSimulator`` (reference include/Simulator.
hpp:91-112, src/Simulator.cu:195-345), deliberately implemented with the
*pair-index bit-arithmetic* algorithm rather than tensor reshapes, so that it
is structurally independent from the torch reshape-and-matmul engine and
the CUDA grid-sweep kernel it validates (a copy of ``tpu_qsim/cpu_reference.py``). Unlike the
reference's CPU oracle (which silently ignored 3-qubit gates, reference
src/Simulator.cu:214-220) this covers the full gate set.

Everything is float64/complex128 and seeded — used by the differential test
suite (the analog of test_gpu_cpu_equivalence.cu).
"""

from __future__ import annotations

import numpy as np

from .circuit import Circuit, Gate
from .gates import op_matrix


# Below this size the canonical pair-index gather path runs everywhere
# (including the whole differential test suite); at/above it, 1q/2q gates
# take the reshape-view fast path so 22-26q fidelity checks finish in
# seconds instead of minutes.
_FAST_PATH_MIN_QUBITS = 18


class CPUReferenceSimulator:
    """Dense complex128 state-vector simulator on the host."""

    def __init__(self, num_qubits: int, *, use_fast_path: bool | None = None):
        """``use_fast_path``: force (True) or forbid (False) the large-n
        reshape-view path; None = size-based default. Forbidding it keeps
        the canonical pair-index/gather algorithm — the independent
        certifying oracle — at any size (the reshape path shares its
        algorithmic family with the engine under test)."""
        if num_qubits < 1:
            raise ValueError("num_qubits must be >= 1")
        self.num_qubits = num_qubits
        self.dim = 1 << num_qubits
        self.use_fast_path = use_fast_path
        self.state = np.zeros(self.dim, dtype=np.complex128)
        self.state[0] = 1.0

    # -- state management ---------------------------------------------------

    def reset(self) -> None:
        self.state[:] = 0
        self.state[0] = 1.0

    def set_basis_state(self, index: int) -> None:
        if not (0 <= index < self.dim):
            raise ValueError(f"basis index {index} out of range")
        self.state[:] = 0
        self.state[index] = 1.0

    def set_state(self, amplitudes: np.ndarray) -> None:
        amplitudes = np.asarray(amplitudes, dtype=np.complex128)
        if amplitudes.shape != (self.dim,):
            raise ValueError(f"state must have shape ({self.dim},)")
        self.state = amplitudes.copy()

    def get_state(self) -> np.ndarray:
        return self.state.copy()

    # -- gate application (pair-index algorithm) ----------------------------

    def _pair_indices(self, target: int) -> tuple[np.ndarray, np.ndarray]:
        """Enumerate (i0, i1) index pairs differing in bit ``target``.

        Vectorized version of the bit-insertion trick in reference
        src/Gates.cu:19-25: insert a 0 bit at position ``target``.
        """
        idx = np.arange(self.dim >> 1, dtype=np.int64)
        mask = (1 << target) - 1
        i0 = (idx & mask) | ((idx & ~mask) << 1)
        return i0, i0 | (1 << target)

    def apply_matrix(self, u: np.ndarray, qubits: tuple[int, ...]) -> None:
        """Apply a k-qubit unitary to the named qubits.

        ``u`` uses the library convention: qubits[0] = matrix-index MSB.
        Implemented by explicit index gather: for every assignment of the
        non-target bits, gather the 2^k amplitudes and multiply.
        """
        k = len(qubits)
        if u.shape != (1 << k, 1 << k):
            raise ValueError("matrix shape does not match qubit count")
        fast = (
            self.use_fast_path
            if self.use_fast_path is not None
            else self.num_qubits >= _FAST_PATH_MIN_QUBITS
        )
        if fast and k <= 2:
            return self._apply_fast(np.asarray(u, dtype=np.complex128), qubits)
        targets = list(qubits)
        rest = [q for q in range(self.num_qubits) if q not in targets]

        # base indices: all assignments of non-target bits
        base = np.zeros(1 << len(rest), dtype=np.int64)
        for pos, q in enumerate(rest):
            bit = (np.arange(1 << len(rest), dtype=np.int64) >> pos) & 1
            base |= bit << q

        # offsets: all assignments of the target bits, qubits[0] = MSB of row
        offs = np.zeros(1 << k, dtype=np.int64)
        for j, q in enumerate(targets):
            bit = (np.arange(1 << k, dtype=np.int64) >> (k - 1 - j)) & 1
            offs |= bit << q

        gather = base[:, None] | offs[None, :]          # [rest, 2^k]
        amps = self.state[gather]                        # [rest, 2^k]
        self.state[gather] = amps @ u.T

    def _apply_fast(self, u: np.ndarray, qubits: tuple[int, ...]) -> None:
        """Large-n fast path: reshape-view block arithmetic instead of the
        full index-gather (which materializes an int64 index per amplitude —
        ~100x slower at 22+ qubits, where the oracle gates the on-chip
        fidelity benchmark). Differentially tested against the gather path
        (tests/test_equivalence.py)."""
        n = self.num_qubits
        if len(qubits) == 1:
            q = qubits[0]
            a, b = 1 << (n - q - 1), 1 << q
            v = self.state.reshape(a, 2, b)
            x0 = v[:, 0].copy()
            x1 = v[:, 1]
            v[:, 0] = u[0, 0] * x0 + u[0, 1] * x1
            v[:, 1] = u[1, 0] * x0 + u[1, 1] * x1
            return
        qa, qb = qubits  # qa = matrix-index MSB
        hi, lo = max(qubits), min(qubits)
        a = 1 << (n - hi - 1)
        b = 1 << (hi - lo - 1)
        c = 1 << lo
        v = self.state.reshape(a, 2, b, 2, c)
        quads = [v[:, h, :, l] for h in (0, 1) for l in (0, 1)]

        def m_of_k(kk: int) -> int:
            h, l = kk >> 1, kk & 1
            return (h << 1 | l) if qa > qb else (l << 1 | h)

        xs = [quads[kk].copy() for kk in range(4)]
        for k_out in range(4):
            mo = m_of_k(k_out)
            acc = None
            for k_in in range(4):
                cf = u[mo, m_of_k(k_in)]
                if cf == 0:
                    continue
                t = xs[k_in] if cf == 1 else cf * xs[k_in]
                acc = t if acc is None else acc + t
            quads[k_out][...] = acc if acc is not None else 0.0

    def apply_gate(self, gate: Gate) -> None:
        self.apply_matrix(op_matrix(gate), gate.qubits)

    def run(self, circuit: Circuit) -> None:
        if circuit.num_qubits != self.num_qubits:
            raise ValueError(
                f"circuit has {circuit.num_qubits} qubits, simulator has "
                f"{self.num_qubits}"
            )
        for gate in circuit:
            self.apply_gate(gate)

    # -- readout ------------------------------------------------------------

    def probabilities(self) -> np.ndarray:
        return np.abs(self.state) ** 2

    def total_probability(self) -> float:
        return float(np.sum(np.abs(self.state) ** 2))

    def qubit_probability(self, qubit: int) -> float:
        """P(qubit = 1). Qubit q <-> bit q of the index."""
        probs = self.probabilities()
        mask = ((np.arange(self.dim) >> qubit) & 1).astype(bool)
        return float(probs[mask].sum())

    def sample(self, shots: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        p = self.probabilities()
        p = p / p.sum()
        return rng.choice(self.dim, size=shots, p=p)

    def measure(self, qubit: int, seed: int = 0) -> int:
        """Measure one qubit, collapse the state, return the outcome bit."""
        rng = np.random.default_rng(seed)
        p1 = self.qubit_probability(qubit)
        outcome = int(rng.random() < p1)
        bit = ((np.arange(self.dim) >> qubit) & 1) == outcome
        p_outcome = p1 if outcome else 1.0 - p1
        if p_outcome <= 0.0:
            raise RuntimeError("measurement branch has zero probability")
        self.state = np.where(bit, self.state, 0.0) / np.sqrt(p_outcome)
        return outcome


def run_circuit(circuit: Circuit, initial_state: np.ndarray | None = None) -> np.ndarray:
    """One-shot convenience: run ``circuit`` and return the final amplitudes."""
    sim = CPUReferenceSimulator(circuit.num_qubits)
    if initial_state is not None:
        sim.set_state(initial_state)
    sim.run(circuit)
    return sim.state
