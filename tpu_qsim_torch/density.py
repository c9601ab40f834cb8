"""Exact mixed-state simulation: density matrix + Kraus channels.

The port's counterpart of ``tpu_qsim/density.py``. An n-qubit density matrix
is a planes state over 2n index bits: row qubit ``q`` lives at bit
``q + n``, column qubit ``q`` at bit ``q``. Every operation reuses the torch
engine of :mod:`tpu_qsim_torch.apply`:

* gate:    rho' = U rho U^dag  ==  apply U on row bits, conj(U) on col bits
* channel: rho' = sum_k K_k rho K_k^dag  ==  sum of (row, col) pairs

Every channel is the exact Kraus sum. A run's gate matrices and Kraus sets go
to the device once, when the circuit is planned.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from . import apply as ap
from .base import (
    BaseSimulator,
    check_insertion,
    host_complex,
    parse_pauli,
    pauli_planes,
    sample_from_probs,
)
from .circuit import Circuit
from .config import DEFAULT_CONFIG, SimConfig
from .fusion import unfused_circuit
from .noise import NoiseModel, kraus_operators

# dim^2 amplitudes: 14 qubits is 2^28, 2 GiB of float32 planes
MAX_DM_QUBITS = 14


def _row_qubits(qubits: tuple[int, ...], n: int) -> tuple[int, ...]:
    return tuple(q + n for q in qubits)


def _neg(m: torch.Tensor | None) -> torch.Tensor | None:
    return None if m is None else -m


def _apply_gate_rho(
    rho: torch.Tensor,
    ur: torch.Tensor,
    ui: torch.Tensor | None,
    qubits: tuple[int, ...],
    n: int,
    diagonal: bool,
) -> torch.Tensor:
    """rho' = U rho U^dag on the flat 2n-bit planes state."""
    apply = ap.apply_diagonal if diagonal else ap.apply_unitary
    rho = apply(rho, ur, ui, _row_qubits(qubits, n))
    return apply(rho, ur, _neg(ui), qubits)


def _kraus_terms(kraus: list[np.ndarray], rdtype, device) -> list[tuple]:
    """A Kraus set as (kind, real, imag-or-None) terms on ``device``: c I
    is ``"scale"`` by |c|^2 (K rho K^dag = |c|^2 rho), a diagonal K is
    ``"diag"`` (two broadcast multiplies), any other ``"dense"`` (two
    matmuls). The sum is the same exact Kraus sum; the first two kinds skip
    work that would multiply by zeros."""
    terms = []
    for k in kraus:
        if np.array_equal(k, k[0, 0] * np.eye(2)):
            terms.append(("scale", float(abs(k[0, 0]) ** 2), None))
            continue
        d = np.ascontiguousarray(np.diagonal(k))
        kind = "diag" if np.array_equal(k, np.diag(d)) else "dense"
        kr, ki = ap.split_matrix(d if kind == "diag" else k, rdtype)
        terms.append((kind, ap.device_matrix(kr, rdtype, device),
                       ap.device_matrix(ki, rdtype, device)))
    return terms


def _apply_kraus_channel(
    rho: torch.Tensor,
    terms: list[tuple],
    qubit: int,
    n: int,
) -> torch.Tensor:
    """Exact rho' = sum_k K_k rho K_k^dag (``terms`` from
    :func:`_kraus_terms`)."""
    acc = None
    for kind, kr, ki in terms:
        if kind == "scale":
            term = rho * kr
        else:
            apply = ap.apply_diagonal if kind == "diag" else ap.apply_unitary
            term = apply(rho, kr, ki, (qubit + n,))
            term = apply(term, kr, _neg(ki), (qubit,))
        acc = term if acc is None else acc.add_(term)
        del term
    return acc


class DensityMatrixSimulator(BaseSimulator):
    """Exact noisy simulator on rho.

    Noise semantics default to ``insertion="gate_qubits"``: after each gate,
    every channel covering each of the gate's qubits is applied to that
    qubit, with global channels resolved to all qubits. ``insertion="all"``
    instead fires every registered application after every gate, the
    trajectory simulators' default, so the two can be compared under one
    policy. ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        num_qubits: int,
        noise_model: NoiseModel | None = None,
        config: SimConfig = DEFAULT_CONFIG,
        *,
        seed: int = 0,
        insertion: str = "gate_qubits",
        device=None,
    ):
        if not (1 <= num_qubits <= MAX_DM_QUBITS):
            raise ValueError(
                f"density matrix supports 1..{MAX_DM_QUBITS} qubits, got "
                f"{num_qubits}"
            )
        check_insertion(insertion)
        super().__init__(num_qubits, config, seed=seed, device=device)
        self.noise_model = noise_model if noise_model is not None else NoiseModel()
        self.insertion = insertion
        self._run_cache: dict[Any, Callable] = {}
        # (2, 4^n) flat planes over 2n index bits = |0..0><0..0|
        self._state = ap.initial_state(2 * self.num_qubits, self._rdtype, 0, self.device)

    # -- state management ---------------------------------------------------

    def reset(self, basis_index: int = 0) -> None:
        """rho = |index><index|."""
        if not (0 <= basis_index < self.dim):
            raise ValueError(f"basis index {basis_index} out of range")
        flat = basis_index * self.dim + basis_index
        self._state = ap.initial_state(
            2 * self.num_qubits, self._rdtype, flat, self.device
        )

    def set_maximally_mixed(self) -> None:
        """rho = I / 2^n."""
        rho = torch.zeros_like(self._state)
        rho[0, :: self.dim + 1] = 1.0 / self.dim
        self._state = rho

    def init_from_pure_state(self, amplitudes: Any) -> None:
        """rho = |psi><psi| by an outer product on the device."""
        psi = np.asarray(amplitudes).reshape(-1)
        if psi.shape != (self.dim,):
            raise ValueError(f"state must have shape ({self.dim},)")
        pr, pi = ap.from_complex(psi, self._rdtype, self.device)
        rr = torch.outer(pr, pr) + torch.outer(pi, pi)
        ri = torch.outer(pi, pr) - torch.outer(pr, pi)
        self._state = torch.stack([rr.reshape(-1), ri.reshape(-1)])

    def set_matrix(self, rho: np.ndarray) -> None:
        rho = np.asarray(rho)
        if rho.shape != (self.dim, self.dim):
            raise ValueError(f"matrix must have shape ({self.dim}, {self.dim})")
        self._state = ap.from_complex(rho.reshape(-1), self._rdtype, self.device)

    def get_matrix(self) -> np.ndarray:
        """Device -> host complex rho."""
        return ap.to_complex(self._state).reshape(self.dim, self.dim)

    # the pure-state setters of BaseSimulator do not apply to rho
    def set_state(self, amplitudes: Any) -> None:
        self.init_from_pure_state(amplitudes)

    def get_state(self) -> np.ndarray:
        return self.get_matrix()

    # -- execution ----------------------------------------------------------

    def _compiled_run(self, circuit: Circuit) -> Callable:
        key = (circuit.signature(), self.noise_model.signature(), self.insertion)
        fn = self._run_cache.get(key)
        if fn is None:
            fn = self._build_run(circuit)
            self._run_cache[key] = fn
        return fn

    def _build_run(self, circuit: Circuit) -> Callable:
        n = self.num_qubits

        def dev(m):
            return ap.device_matrix(m, self._rdtype, self.device)

        kraus_sets: dict[tuple, list] = {}
        ops = []
        for g in unfused_circuit(circuit):
            ur, ui = ap.split_matrix(g.diag if g.diagonal else g.matrix, self._rdtype)
            ops.append(("gate", g.qubits, g.diagonal, dev(ur), dev(ui)))
            if self.noise_model.has_noise():
                if self.insertion == "gate_qubits":
                    apps = [
                        (ch.type, q, ch.probability)
                        for q in g.qubits
                        for ch in self.noise_model.channels_for_qubit(q)
                    ]
                else:
                    apps = self.noise_model.applications_per_gate(n)
                for ntype, q, p in apps:
                    if p == 0.0:
                        continue
                    terms = kraus_sets.get((ntype, p))
                    if terms is None:
                        terms = _kraus_terms(
                            kraus_operators(ntype, p), self._rdtype, self.device
                        )
                        kraus_sets[(ntype, p)] = terms
                    ops.append(("kraus", q, terms))

        def step(rho: torch.Tensor) -> torch.Tensor:
            for op in ops:
                if op[0] == "gate":
                    _, qubits, diagonal, ur, ui = op
                    rho = _apply_gate_rho(rho, ur, ui, qubits, n, diagonal)
                else:
                    _, q, terms = op
                    rho = _apply_kraus_channel(rho, terms, q, n)
            return rho

        return step

    def run(self, circuit: Circuit) -> "DensityMatrixSimulator":
        if circuit.num_qubits != self.num_qubits:
            raise ValueError(
                f"circuit has {circuit.num_qubits} qubits, simulator has "
                f"{self.num_qubits}"
            )
        self._state = self._compiled_run(circuit)(self._state)
        return self

    def apply_gate(self, name: str, *qubits: int, param: float | None = None) -> None:
        c = Circuit(self.num_qubits).add(name, *qubits, param=param)
        self.run(c)

    # -- readout ------------------------------------------------------------

    def _diag(self) -> torch.Tensor:
        return torch.diagonal(self._state[0].reshape(self.dim, self.dim))

    def probabilities(self) -> torch.Tensor:
        """Diagonal of rho, on the device."""
        return self._diag().clone()

    def trace(self) -> float:
        """Re tr(rho)."""
        return float(torch.sum(self._diag()))

    def purity(self) -> float:
        """tr(rho^2) = sum |rho_ij|^2 for Hermitian rho, one device
        reduction."""
        return float(torch.sum(self._state * self._state))

    def total_probability(self) -> float:
        return self.trace()

    def is_valid(self, atol: float = 1e-4) -> bool:
        """trace ~ 1 and 1/dim <= purity <= 1."""
        tr = self.trace()
        pu = self.purity()
        return (
            abs(tr - 1.0) < atol
            and pu <= 1.0 + atol
            and pu >= 1.0 / self.dim - atol
        )

    def qubit_probability(self, qubit: int) -> float:
        self._check_qubit(qubit)
        d = self._diag().reshape(1 << (self.num_qubits - qubit - 1), 2, -1)
        return float(d[:, 1].sum())

    def expectation_pauli(self, pauli: str) -> float:
        """tr(rho P) for a Pauli string (rightmost char = qubit 0): P on the
        row side of the 2n-bit planes, then Re tr."""
        ops = parse_pauli(pauli, self.num_qubits)
        if not ops:
            return self.trace()
        t = self._state
        for qubit, p in ops:
            ur, ui = pauli_planes(p, t.device, t.dtype)
            t = ap.apply_unitary(t, ur, ui, (qubit + self.num_qubits,))
        return float(torch.sum(torch.diagonal(t[0].reshape(self.dim, self.dim))))

    # -- sampling / measurement --------------------------------------------

    def sample(
        self, shots: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        if shots < 1:
            raise ValueError("shots must be >= 1")
        p = torch.clamp(self._diag(), min=0.0)
        return sample_from_probs(p, shots, self._generator(generator))

    def measure_qubit(
        self, qubit: int, generator: torch.Generator | None = None
    ) -> int:
        """Projective measurement with collapse: rho' = P rho P / p."""
        self._check_qubit(qubit)
        n = self.num_qubits
        p1 = min(max(self.qubit_probability(qubit), 0.0), 1.0)
        draw = torch.rand(
            1, generator=self._generator(generator), dtype=torch.float64,
            device=self.device,
        )
        outcome = int(draw.item() < p1)
        p_outcome = p1 if outcome else 1.0 - p1
        # row bit q+n and column bit q of the flat index
        v = self._state.reshape(2, 1 << (n - 1 - qubit), 2, 1 << (n - 1), 2, 1 << qubit)
        out = torch.zeros_like(v)
        inv = 1.0 / max(p_outcome, np.finfo(np.float64).tiny)
        out[:, :, outcome, :, outcome] = v[:, :, outcome, :, outcome] * inv
        self._state = out.reshape(2, -1)
        return outcome

    def reduced_density_matrix(self, qubits) -> np.ndarray:
        """Partial trace of rho onto ``qubits`` (2^k x 2^k, index bit j =
        qubits[j]) on the device: kept row/col axes fronted, traced row/col
        axes paired and summed; only the reduced matrix is read back."""
        qs = self._validated_subset(qubits)
        n = self.num_qubits
        k = len(qs)
        rest = [b for b in range(n) if b not in qs]

        def axes_of(bits):
            return [2 * n - 1 - b for b in bits]

        perm = (
            axes_of([q + n for q in reversed(qs)])
            + axes_of(list(reversed(qs)))
            + axes_of([b + n for b in rest])
            + axes_of(rest)
        )
        t = 1 << len(rest)

        def f(plane: torch.Tensor) -> torch.Tensor:
            v = plane.reshape((2,) * (2 * n)).permute(perm).reshape(1 << k, 1 << k, t, t)
            return torch.diagonal(v, dim1=2, dim2=3).sum(-1)

        return host_complex(f(self._state[0]), f(self._state[1]))

    def fidelity_with(self, other) -> float:
        """Fidelity of rho against ``other``.

        * a pure state ((2, 2^n) planes or a simulator holding them):
          F = <psi|rho|psi>, on the device;
        * another DensityMatrixSimulator: Uhlmann fidelity
          (tr sqrt(sqrt(rho) sigma sqrt(rho)))^2 by host eigendecompositions,
          up to 10 qubits.
        """
        nq = getattr(other, "num_qubits", None)
        if nq is not None and nq != self.num_qubits:
            # width first: raw shape tests alias across types (a 2n-qubit
            # pure state's planes look exactly like this rho)
            raise ValueError(
                f"register width mismatch: {nq} vs {self.num_qubits} qubits"
            )
        planes = getattr(other, "state_planes", other)
        shape = tuple(planes.shape)
        if shape == (2, self.dim):
            psi = self._peer_planes(planes, shape)
            ap.exact_matmuls(psi)
            mr = self._state[0].reshape(self.dim, self.dim)
            mi = self._state[1].reshape(self.dim, self.dim)
            yr = mr @ psi[0] - mi @ psi[1]
            yi = mr @ psi[1] + mi @ psi[0]
            return float(torch.sum(psi[0] * yr + psi[1] * yi))
        if shape == (2, self.dim * self.dim):
            if self.num_qubits > 10:
                raise ValueError(
                    "mixed-mixed Uhlmann fidelity is host-side "
                    "eigendecomposition work; supported to 10 qubits"
                )
            rho = self.get_matrix().astype(np.complex128)
            sig = self._peer_planes(planes, shape).cpu().numpy().astype(np.float64)
            sig = (sig[0] + 1j * sig[1]).reshape(self.dim, self.dim)
            lam, u = np.linalg.eigh(rho)
            sq = (u * np.sqrt(np.clip(lam, 0.0, None))) @ u.conj().T
            ev = np.linalg.eigvalsh(sq @ sig @ sq)
            return float(np.sqrt(np.clip(ev, 0.0, None)).sum() ** 2)
        raise ValueError(
            f"state shape mismatch: {shape} is neither a "
            f"(2, {self.dim}) pure state nor a (2, {self.dim**2}) rho"
        )
