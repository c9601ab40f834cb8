"""Shared simulator base: state container + readout/measurement surface.

The port's counterpart of ``tpu_qsim/base.py``, on the ``(2, 2^n)`` planes of
:mod:`tpu_qsim_torch.apply`. Subclasses own circuit execution; this class
owns everything downstream of the state. The only source of randomness is a
seeded ``torch.Generator`` on the state's device (``jax.random``'s threefry
streams are not reproduced: sampled outcomes agree as distributions).
"""

from __future__ import annotations

import functools
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
        self._state = self._initial_state(0)

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
        self._state = self._initial_state(basis_index)

    def _initial_state(self, basis_index: int) -> torch.Tensor:
        """The planes of |basis_index> this simulator holds (a sharded
        simulator holds its slice)."""
        return ap.initial_state(self.num_qubits, self._rdtype, basis_index, self.device)

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

    def _generator(self, generator: torch.Generator | None) -> torch.Generator:
        """A per-call generator (the counterpart of the JAX package's ``key=``)
        or the simulator's own; either must live on the state's device."""
        return self._gen if generator is None else generator

    def sample(
        self, shots: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """Multishot sampling without collapse, by inverse CDF on the device
        (:func:`sample_from_probs`). Returns int64 basis indices [shots] on the
        state's device."""
        if shots < 1:
            raise ValueError("shots must be >= 1")
        return sample_from_probs(self.probabilities(), shots, self._generator(generator))

    def histogram(
        self, shots: int, generator: torch.Generator | None = None
    ) -> dict[int, int]:
        return counts_to_histogram(self.sample(shots, generator).cpu().numpy())

    def measure_qubit(
        self, qubit: int, generator: torch.Generator | None = None
    ) -> int:
        """Measure one qubit; collapse the state; return 0 or 1."""
        self._check_qubit(qubit)
        p1 = min(max(self.qubit_probability(qubit), 0.0), 1.0)
        draw = torch.rand(
            1, generator=self._generator(generator), dtype=torch.float64,
            device=self.device,
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
        ops = parse_pauli(pauli, self.num_qubits)
        if not ops:
            return 1.0
        return float(pauli_expectation(self._state, ops))

    def reduced_density_matrix(self, qubits) -> np.ndarray:
        """Partial trace of the pure state onto ``qubits``: a (2^k, 2^k)
        complex matrix with index bit j = ``qubits[j]``. Computed on the
        device as rho = M M^dagger for the (2^k, 2^(n-k)) reshaped state;
        only the 2^k x 2^k result is read back."""
        qs = self._validated_subset(qubits)
        rr, ri = reduced_planes(self._state, qs)
        return host_complex(rr, ri)

    def entanglement_entropy(self, qubits) -> float:
        """Von Neumann entropy S(rho_A) in bits of the reduced state on
        ``qubits``: 0 for product states, 1 for a Bell pair's single qubit.
        Eigenvalues on the host from the device-computed reduced matrix."""
        rho = self.reduced_density_matrix(qubits)
        lam = np.clip(np.linalg.eigvalsh(rho).real, 0.0, 1.0)
        nz = lam[lam > 1e-12]
        return float(-(nz * np.log2(nz)).sum())

    def fidelity_with(self, other) -> float:
        """|<psi|phi>|^2 against another same-width pure-state simulator (or
        anything exposing (2, 2^n) ``state_planes``, or the planes themselves).
        On-device inner product; one scalar readback."""
        planes = self._peer_planes(other, (2, self.dim))
        re, im = ap.inner_product(self._state, planes)
        return float(re * re + im * im)

    def _validated_subset(self, qubits) -> tuple:
        """Shared partial-trace subset validation (pure / DM / batched)."""
        qs = tuple(int(q) for q in qubits)
        for q in qs:
            self._check_qubit(q)
        if len(set(qs)) != len(qs):
            raise ValueError("duplicate qubits in partial-trace subset")
        if not (1 <= len(qs) <= 12):
            raise ValueError(
                "reduced density matrix supports 1..12 qubits "
                f"(2^k x 2^k output), got {len(qs)}"
            )
        return qs

    def _peer_planes(self, other, want_shape: tuple) -> torch.Tensor:
        """Resolve ``other`` to planes of ``want_shape`` on this simulator's
        device. Simulator peers are checked by register width first: a raw
        shape test alone aliases across types (a 1-qubit rho's (2, 4) planes
        look exactly like a 2-qubit pure state)."""
        nq = getattr(other, "num_qubits", None)
        if nq is not None and nq != self.num_qubits:
            raise ValueError(
                f"register width mismatch: {nq} vs {self.num_qubits} qubits"
            )
        planes = getattr(other, "state_planes", other)
        if tuple(planes.shape) != want_shape:
            raise ValueError(
                f"state shape mismatch: {tuple(planes.shape)} vs {want_shape}"
            )
        if not isinstance(planes, torch.Tensor):     # e.g. a JAX simulator's
            planes = torch.tensor(np.asarray(planes))
        return planes.to(device=self._state.device, dtype=self._state.dtype)

    # -- checkpoint / resume -------------------------------------------------

    def save_state(self, path: str) -> None:
        """Checkpoint amplitudes + metadata to ``.npz``, with the JAX
        package's keys (``planes``, ``num_qubits``, ``dtype``): either package
        loads the other's files."""
        np.savez(
            path,
            planes=self._state.detach().cpu().numpy(),
            num_qubits=self.num_qubits,
            dtype=str(self._rdtype),
        )

    def load_state(self, path: str) -> None:
        """Restore a checkpoint written by :meth:`save_state` (of either
        package)."""
        data = np.load(path)
        if int(data["num_qubits"]) != self.num_qubits:
            raise ValueError(
                f"checkpoint has {int(data['num_qubits'])} qubits, simulator "
                f"has {self.num_qubits}"
            )
        planes = np.asarray(data["planes"], dtype=self._rdtype)
        if planes.shape != tuple(self._state.shape):
            raise ValueError(f"checkpoint shape {planes.shape} mismatch")
        self._state = torch.from_numpy(planes).to(self.device)

    # -- misc ---------------------------------------------------------------

    @property
    def memory_bytes(self) -> int:
        """Device bytes held by the state (planes x amplitudes x itemsize)."""
        return self._state.numel() * self._state.element_size()

    def _check_qubit(self, qubit: int) -> None:
        if not (0 <= qubit < self.num_qubits):
            raise ValueError(f"qubit index {qubit} out of range")

    def block_until_ready(self) -> "BaseSimulator":
        """Wait until the device has finished the queued work on the state."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def sync(self) -> float:
        """Force execution to completion by a scalar readback; returns the
        total probability."""
        return self.total_probability()


# ---------------------------------------------------------------------------
# Shared device helpers (the pure, batched and density-matrix simulators)
# ---------------------------------------------------------------------------

def parse_pauli(pauli: str, num_qubits: int) -> tuple:
    """Pauli string -> ((qubit, P), ...) pairs: the rightmost character acts
    on qubit 0; short strings pad with identities on high qubits."""
    pauli = pauli.upper()
    if len(pauli) > num_qubits or not set(pauli) <= set("IXYZ"):
        raise ValueError(f"invalid Pauli string {pauli!r}")
    return tuple(
        (len(pauli) - 1 - i, p) for i, p in enumerate(pauli) if p != "I"
    )


def pauli_expectation(state: torch.Tensor, ops: tuple) -> torch.Tensor:
    """Re <psi| P |psi> on the device for (2, 2^n) planes, or per state of a
    (B, 2, 2^n) batch ((B,) result). Differentiable in ``state``."""
    transformed = state
    for qubit, p in ops:
        ur, ui = pauli_planes(p, state.device, state.dtype)
        transformed = ap.apply_unitary(transformed, ur, ui, (qubit,))
    return torch.sum(state * transformed, dim=(-2, -1))


@functools.lru_cache(maxsize=None)
def pauli_planes(
    p: str, device: torch.device, dtype: torch.dtype
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(real, imag-or-None) of the Pauli matrix ``p`` on ``device``, made
    once per device and dtype."""
    from .gates import gate_matrix

    ur, ui = ap.split_matrix(gate_matrix(p.lower()), np.float64)
    return (
        torch.as_tensor(ur, dtype=dtype, device=device),
        None if ui is None else torch.as_tensor(ui, dtype=dtype, device=device),
    )


def sample_from_probs(
    probs: torch.Tensor, shots: int, gen: torch.Generator
) -> torch.Tensor:
    """Inverse-CDF sampling on the device of ``shots`` uniforms from ``gen``
    (:func:`inverse_cdf`). Returns int64 indices of shape (..., shots)."""
    u = torch.rand(
        probs.shape[:-1] + (shots,), generator=gen, dtype=torch.float64,
        device=probs.device,
    )
    return inverse_cdf(probs, u)


def inverse_cdf(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The basis indices that uniforms ``u`` (..., shots) in [0, 1) pick from
    (..., 2^n) probabilities: a float64 cumulative sum and a binary search,
    on the device."""
    cdf = torch.cumsum(probs, -1, dtype=torch.float64)
    idx = torch.searchsorted(cdf, u * cdf[..., -1:], right=True)
    return idx.clamp_(max=probs.shape[-1] - 1)


def counts_to_histogram(samples: np.ndarray) -> dict[int, int]:
    """Sample indices -> {index: count}: int64 samples, memory O(shots)
    whatever the number of qubits."""
    vals, cnts = np.unique(samples, return_counts=True)
    return dict(zip(vals.tolist(), cnts.tolist()))


def reduced_planes(state: torch.Tensor, qs: tuple) -> tuple[torch.Tensor, torch.Tensor]:
    """(re, im) of rho_A = M M^dagger on the device, M the (2^k, rest)
    reshape of the planes with the kept qubits fronted (row bit j = qs[j]).
    A (B, 2, 2^n) batch folds into M's columns and gives the ensemble
    average (1/B) sum_b M_b M_b^dagger in one matmul pair."""
    ap.exact_matmuls(state)
    lead = state.shape[:-2]
    n = ap.num_qubits_of(state)
    k = len(qs)
    nb = len(lead)
    front = [nb + n - 1 - q for q in reversed(qs)]
    rest = [nb + a for a in range(n) if nb + a not in front]
    perm = front + rest + list(range(nb))

    def m_of(plane: torch.Tensor) -> torch.Tensor:
        return plane.reshape(lead + (2,) * n).permute(perm).reshape(1 << k, -1)

    mr, mi = m_of(state.select(nb, 0)), m_of(state.select(nb, 1))
    scale = 1.0 / (lead[0] if lead else 1)
    rr = (mr @ mr.T + mi @ mi.T) * scale
    ri = (mi @ mr.T - mr @ mi.T) * scale
    return rr, ri


def host_complex(rr: torch.Tensor, ri: torch.Tensor) -> np.ndarray:
    """A small device matrix's (re, im) planes as one host complex128
    array."""
    return rr.cpu().numpy().astype(np.float64) + 1j * ri.cpu().numpy().astype(np.float64)


def check_insertion(insertion: str) -> None:
    """The two noise insertion policies (:mod:`tpu_qsim_torch.noise`)."""
    if insertion not in ("all", "gate_qubits"):
        raise ValueError(
            f"insertion must be 'all' or 'gate_qubits', got {insertion!r}"
        )
