"""Shared simulator base: state container + readout/measurement surface.

The port's counterpart of ``tpu_qsim/base.py``, on the ``(2, 2^n)`` planes of
:mod:`tpu_qsim_torch.apply`. Subclasses own circuit execution; this class
owns everything downstream of the state. The only source of randomness is a
seeded ``torch.Generator`` on the state's device (``jax.random``'s threefry
streams are not reproduced: sampled outcomes agree as distributions).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import apply as ap
from .config import DEFAULT_CONFIG, SimConfig


class BaseSimulator:
    """State container + seeded readout/measurement, shared by all backends."""

    def __init__(
        self,
        num_qubits: int,
        config: SimConfig = DEFAULT_CONFIG,
        *,
        seed: int = 0,
        device=None,
    ):
        from .circuit import MAX_QUBITS

        if not (1 <= num_qubits <= MAX_QUBITS):
            raise ValueError(
                f"num_qubits must be in [1, {MAX_QUBITS}], got {num_qubits}"
            )
        self.num_qubits = int(num_qubits)
        self.dim = 1 << self.num_qubits
        self.config = config
        self.device = ap.resolve_device(device)
        self._rdtype = config.real_dtype
        self.set_seed(seed)
        self._state = ap.initial_state(self.num_qubits, self._rdtype, 0, self.device)

    # -- generator ------------------------------------------------------------

    def set_seed(self, seed: int) -> None:
        """Re-seed the simulator's generator (the only RNG; nothing is
        unseeded)."""
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

    # -- state management ---------------------------------------------------

    def reset(self, basis_index: int = 0) -> None:
        if not (0 <= basis_index < self.dim):
            raise ValueError(f"basis index {basis_index} out of range")
        self._state = ap.initial_state(
            self.num_qubits, self._rdtype, basis_index, self.device
        )

    @property
    def state_planes(self) -> torch.Tensor:
        """Device-resident (2, 2^n) [real, imag] amplitude planes."""
        return self._state

    def get_state(self) -> np.ndarray:
        """Device -> host complex amplitudes."""
        return ap.to_complex(self._state)

    def set_state(self, amplitudes: Any) -> None:
        amplitudes = np.asarray(amplitudes)
        if amplitudes.shape != (self.dim,):
            raise ValueError(f"state must have shape ({self.dim},)")
        self._state = ap.from_complex(amplitudes, self._rdtype, self.device)

    # -- readout ------------------------------------------------------------

    def probabilities(self) -> torch.Tensor:
        return ap.probabilities(self._state)

    def get_probabilities(self) -> np.ndarray:
        return self.probabilities().cpu().numpy()

    def total_probability(self) -> float:
        return float(ap.total_probability(self._state))

    def is_normalized(self, atol: float = 1e-4) -> bool:
        return abs(self.total_probability() - 1.0) < atol

    def assert_normalized(self, atol: float = 1e-4) -> None:
        tp = self.total_probability()
        if abs(tp - 1.0) >= atol:
            raise RuntimeError(f"state not normalized: total probability {tp}")

    def qubit_probability(self, qubit: int) -> float:
        """P(qubit = 1)."""
        self._check_qubit(qubit)
        return float(ap.qubit_marginal(self._state, qubit))

    # -- sampling / measurement --------------------------------------------

    def sample(self, shots: int) -> torch.Tensor:
        """Multishot sampling without collapse, by inverse CDF on the device:
        a float64 cumulative sum of the probabilities and a binary search of
        ``shots`` uniforms from the generator. Returns int64 basis indices
        [shots] on the state's device."""
        if shots < 1:
            raise ValueError("shots must be >= 1")
        cdf = torch.cumsum(self.probabilities(), 0, dtype=torch.float64)
        u = torch.rand(
            shots, generator=self._gen, dtype=torch.float64, device=self.device
        ) * cdf[-1]
        idx = torch.searchsorted(cdf, u, right=True)
        return idx.clamp_(max=self.dim - 1)

    def histogram(self, shots: int) -> dict[int, int]:
        samples = self.sample(shots).cpu().numpy()
        vals, cnts = np.unique(samples, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, cnts)}

    def measure_qubit(self, qubit: int) -> int:
        """Measure one qubit; collapse the state; return 0 or 1."""
        self._check_qubit(qubit)
        p1 = min(max(self.qubit_probability(qubit), 0.0), 1.0)
        draw = torch.rand(
            1, generator=self._gen, dtype=torch.float64, device=self.device
        )
        outcome = int(draw.item() < p1)
        p_outcome = p1 if outcome else 1.0 - p1
        self._state = ap.collapse(self._state, qubit, outcome, p_outcome)
        return outcome

    # -- observables ---------------------------------------------------------

    def expectation_pauli(self, pauli: str) -> float:
        """<psi| P |psi> for a Pauli string, e.g. ``"ZZ"`` or ``"XIY"``.

        The string reads like a ket: the rightmost character acts on qubit 0;
        strings shorter than ``num_qubits`` are padded with identities on the
        high qubits.
        """
        from .gates import gate_matrix

        pauli = pauli.upper()
        if len(pauli) > self.num_qubits or not set(pauli) <= set("IXYZ"):
            raise ValueError(f"invalid Pauli string {pauli!r}")
        ops = [(len(pauli) - 1 - i, p) for i, p in enumerate(pauli) if p != "I"]
        if not ops:
            return 1.0
        transformed = self._state
        for qubit, p in ops:
            ur, ui = ap.split_matrix(gate_matrix(p.lower()), self._rdtype)
            transformed = ap.apply_unitary(transformed, ur, ui, (qubit,))
        re, _ = ap.inner_product(self._state, transformed)
        return float(re)

    # -- misc ---------------------------------------------------------------

    @property
    def memory_bytes(self) -> int:
        """Device bytes held by the state (planes x amplitudes x itemsize)."""
        return self._state.numel() * self._state.element_size()

    def _check_qubit(self, qubit: int) -> None:
        if not (0 <= qubit < self.num_qubits):
            raise ValueError(f"qubit index {qubit} out of range")
