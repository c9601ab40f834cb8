"""Monte-Carlo wavefunction (trajectory) simulation.

The port's counterpart of ``tpu_qsim/noisy.py``. ``NoisySimulator`` runs one
trajectory, ``BatchedSimulator`` a batch of them as a ``(B, 2, 2^n)`` tensor
(the JAX package's ``jax.vmap``): one Kraus branch is drawn per channel
application per trajectory and applied to the whole state, with Born-rule
branch probabilities for non-unitary Kraus sets.

Randomness: a run draws all its uniforms at once from the simulator's seeded
``torch.Generator`` on the state's device, before the first gate, and the
step maps each uniform to a branch by inverse CDF on the device. The chosen
branch is blended in by a one-hot, as the JAX package does, so a trajectory
never waits for the host. ``build_trajectory_step`` takes the uniforms as an
argument, so a caller can force a branch sequence.

Noise insertion points: after every gate, every registered channel fires
once per qubit it covers (``insertion="all"``), or only on the gate's own
qubits (``"gate_qubits"``). Gates are applied unfused (fusing across an
insertion point would change the physics). A channel on every qubit of a
circuit of 8 qubits or more (``GLOBAL_SCAN_MIN``) is one ``lax.scan`` layer
in the JAX package (``_mix_layer_scan``/``_kraus_layer_scan``, to keep its
traced program small); its body applies the channel to qubit t at step t,
so here the layer is the loop of n per-qubit applications in that order,
with one uniform each.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from . import apply as ap
from .base import (
    BaseSimulator,
    check_insertion,
    counts_to_histogram,
    host_complex,
    parse_pauli,
    pauli_expectation,
    reduced_planes,
    sample_from_probs,
)
from .circuit import Circuit
from .config import DEFAULT_CONFIG, SimConfig
from .fusion import unfused_circuit
from .noise import NoiseModel, UNITARY_MIX_TYPES, kraus_operators, unitary_mix

Step = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _onehot(u: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One-hot (..., B) of the branch that uniform ``u`` (...) picks by
    inverse CDF of ``weights`` (..., B): branch b when
    cdf[b-1] <= u * total < cdf[b], so a branch of weight 0 is never picked."""
    cdf = torch.cumsum(weights.double(), -1)
    idx = (u.unsqueeze(-1) * cdf[..., -1:] >= cdf[..., :-1]).sum(-1)
    return torch.nn.functional.one_hot(idx, weights.shape[-1])


def _apply_unitary_mix(
    state: torch.Tensor,
    u: torch.Tensor,
    probs: torch.Tensor,
    urs: torch.Tensor,
    uis: torch.Tensor | None,
    qubit: int,
) -> torch.Tensor:
    """Pauli-type channel: the branch probabilities do not depend on the
    state, so pick the branch first and apply its 2x2 unitary, blended from
    the branch table by the one-hot (one matrix application whatever the
    branch; per trajectory in a batch)."""
    onehot = _onehot(u, probs).to(state.dtype)                # (..., B)
    mr = (onehot @ urs.reshape(urs.shape[0], 4)).reshape(u.shape + (2, 2))
    mi = None
    if uis is not None:
        mi = (onehot @ uis.reshape(uis.shape[0], 4)).reshape(u.shape + (2, 2))
    return ap.apply_unitary(state, mr, mi, (qubit,))


def _apply_general_kraus(
    state: torch.Tensor,
    u: torch.Tensor,
    kraus: list[tuple[torch.Tensor, torch.Tensor | None]],
    qubit: int,
) -> torch.Tensor:
    """General channel (damping): compute every Kraus branch, pick one with
    Born probability ||K_b psi||^2, renormalize. B branch applications."""
    stacked = torch.stack(
        [ap.apply_unitary(state, kr, ki, (qubit,)) for kr, ki in kraus]
    )                                                         # (B, ..., 2, 2^n)
    norms = torch.sum(stacked * stacked, dim=(-2, -1)).movedim(0, -1)
    onehot = _onehot(u, norms).to(state.dtype)                # (..., B)
    picked = torch.sum(onehot.movedim(-1, 0)[..., None, None] * stacked, dim=0)
    norm = torch.sum(onehot * norms, dim=-1)
    scale = torch.rsqrt(torch.clamp(norm, min=torch.finfo(state.dtype).tiny))
    return picked * scale[..., None, None]


def build_trajectory_step(
    circuit: Circuit,
    noise_model: NoiseModel | None,
    rdtype: np.dtype,
    insertion: str = "all",
    device=None,
) -> tuple[Step, int]:
    """The (state, uniforms) -> state single-trajectory function and the
    number of uniforms it takes.

    ``state`` is (2, 2^n) planes, or a (B, 2, 2^n) batch; ``uniforms`` is a
    float64 tensor in [0, 1) of shape (n_draws,), or (B, n_draws), one per
    channel application in order. Gate matrices and channel tables are put on
    ``device`` once, here.
    """
    check_insertion(insertion)
    device = ap.resolve_device(device)
    n = circuit.num_qubits

    def dev(m):
        return ap.device_matrix(m, rdtype, device)

    gate_consts = []
    for g in unfused_circuit(circuit):
        ur, ui = ap.split_matrix(g.diag if g.diagonal else g.matrix, rdtype)
        gate_consts.append((g.qubits, g.diagonal, dev(ur), dev(ui)))

    # (qubit, apply(state, u)) per channel application, in registration order
    noise_apps: list[tuple[int, Callable]] = []
    if noise_model is not None and noise_model.has_noise():
        for c in noise_model.channels:
            p = c.probability
            if p == 0.0:
                continue
            if c.type in UNITARY_MIX_TYPES:
                probs, us = unitary_mix(c.type, p)
                table = (
                    torch.as_tensor(probs, device=device),
                    dev(us.real),
                    dev(us.imag) if np.any(us.imag != 0) else None,
                )

                def app(state, u, q, t=table):
                    return _apply_unitary_mix(state, u, *t, q)
            else:
                kraus = [
                    tuple(dev(m) for m in ap.split_matrix(k, rdtype))
                    for k in kraus_operators(c.type, p)
                ]

                def app(state, u, q, kraus=kraus):
                    return _apply_general_kraus(state, u, kraus, q)
            noise_apps.extend((q, app) for q in c.resolved_qubits(n))

    per_gate_apps = [
        noise_apps
        if insertion == "all"
        else [a for a in noise_apps if a[0] in qubits]
        for qubits, _, _, _ in gate_consts
    ]
    n_draws = sum(len(a) for a in per_gate_apps)

    def step(state: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
        if uniforms.shape[-1] != n_draws:
            raise ValueError(f"step takes {n_draws} uniforms, got {uniforms.shape[-1]}")
        i = 0
        for (qubits, diagonal, ur, ui), apps in zip(gate_consts, per_gate_apps):
            if diagonal:
                state = ap.apply_diagonal(state, ur, ui, qubits)
            else:
                state = ap.apply_unitary(state, ur, ui, qubits)
            for q, app in apps:
                state = app(state, uniforms[..., i], q)
                i += 1
        return state

    return step, n_draws


def collapse_batch(
    states: torch.Tensor, qubit: int, u: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Measure ``qubit`` in each state of a (B, 2, 2^n) batch with its
    uniform of ``u`` (B,) by the Born rule: (collapsed states, (B,) bool
    outcomes)."""
    b, n = states.shape[0], ap.num_qubits_of(states)
    v = states.reshape(b, 2, 1 << (n - qubit - 1), 2, 1 << qubit)
    p1 = torch.sum(v[:, :, :, 1] ** 2, dim=(1, 2, 3)).clamp(0.0, 1.0)
    outcome = u < p1
    p_out = torch.where(outcome, p1, 1.0 - p1)
    keep = torch.stack([~outcome, outcome], dim=1).to(v.dtype)
    scale = torch.rsqrt(torch.clamp(p_out, min=torch.finfo(v.dtype).tiny))
    v = v * (keep * scale[:, None])[:, None, None, :, None]
    return v.reshape(states.shape), outcome


class _TrajectoryRuns:
    """Run cache shared by the trajectory simulators: one planned step per
    (circuit, noise model, insertion)."""

    def _init_runs(self, noise_model: NoiseModel | None, insertion: str) -> None:
        check_insertion(insertion)
        self.noise_model = noise_model if noise_model is not None else NoiseModel()
        self.insertion = insertion
        self._run_cache: dict[Any, tuple[Step, int]] = {}

    def _compiled_run(self, circuit: Circuit) -> tuple[Step, int]:
        if circuit.num_qubits != self.num_qubits:
            raise ValueError(
                f"circuit has {circuit.num_qubits} qubits, simulator has "
                f"{self.num_qubits}"
            )
        key = (circuit.signature(), self.noise_model.signature(), self.insertion)
        hit = self._run_cache.get(key)
        if hit is None:
            hit = build_trajectory_step(
                circuit, self.noise_model, self._rdtype, self.insertion, self.device
            )
            self._run_cache[key] = hit
        return hit

    def _uniforms(self, shape: tuple, generator) -> torch.Tensor:
        return torch.rand(
            shape, generator=self._generator(generator), dtype=torch.float64,
            device=self.device,
        )


class NoisySimulator(_TrajectoryRuns, BaseSimulator):
    """Single-trajectory Monte-Carlo wavefunction simulator.

    ``insertion``: "all" (default; every channel after every gate) or
    "gate_qubits" (only on the gate's qubits, the density-matrix
    simulator's default). ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        num_qubits: int,
        noise_model: NoiseModel | None = None,
        config: SimConfig = DEFAULT_CONFIG,
        *,
        seed: int = 0,
        insertion: str = "all",
        device=None,
    ):
        super().__init__(num_qubits, config, seed=seed, device=device)
        self._init_runs(noise_model, insertion)

    def run(
        self, circuit: Circuit, generator: torch.Generator | None = None
    ) -> "NoisySimulator":
        """Run one stochastic trajectory from the current state."""
        step, n_draws = self._compiled_run(circuit)
        self._state = step(self._state, self._uniforms((n_draws,), generator))
        return self


class BatchedSimulator(_TrajectoryRuns, BaseSimulator):
    """Many trajectories at once: the state is a (batch, 2, 2^n) tensor and
    every gate and channel applies to the whole batch in one call, each
    trajectory with its own draws. Averaging, per-trajectory probabilities,
    sampling and histograms stay on the device.
    """

    def __init__(
        self,
        num_qubits: int,
        batch_size: int,
        noise_model: NoiseModel | None = None,
        config: SimConfig = DEFAULT_CONFIG,
        *,
        seed: int = 0,
        insertion: str = "all",
        device=None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        super().__init__(num_qubits, config, seed=seed, device=device)
        self.batch_size = int(batch_size)
        self._init_runs(noise_model, insertion)
        self._states = self._broadcast(self._state)

    def _broadcast(self, one: torch.Tensor) -> torch.Tensor:
        return one.expand((self.batch_size,) + tuple(one.shape)).contiguous()

    def reset(self, basis_index: int = 0) -> None:
        super().reset(basis_index)
        self._states = self._broadcast(self._state)

    # -- execution ----------------------------------------------------------

    def run(
        self, circuit: Circuit, generator: torch.Generator | None = None
    ) -> "BatchedSimulator":
        """Advance every trajectory through ``circuit`` with independent
        noise draws."""
        step, n_draws = self._compiled_run(circuit)
        uniforms = self._uniforms((self.batch_size, n_draws), generator)
        self._states = step(self._states, uniforms)
        return self

    # -- readout (batch-aware overrides) ------------------------------------

    @property
    def state_planes(self) -> torch.Tensor:
        return self._states

    def _all_states(self) -> torch.Tensor:
        """Every trajectory's planes, for the readouts (a sharded batch
        gathers them)."""
        return self._states

    def get_state(self) -> np.ndarray:
        """(batch, 2^n) complex trajectory amplitudes."""
        flat = self._all_states().cpu().numpy()
        return flat[:, 0] + 1j * flat[:, 1]

    def trajectory_probabilities(self) -> torch.Tensor:
        """(batch, 2^n) per-trajectory probabilities."""
        s = self._all_states()
        return s[:, 0] ** 2 + s[:, 1] ** 2

    def probabilities(self) -> torch.Tensor:
        """Batch-averaged probabilities, on the device."""
        return torch.mean(self.trajectory_probabilities(), dim=0)

    def average_probabilities(self) -> np.ndarray:
        return self.probabilities().cpu().numpy()

    def total_probability(self) -> float:
        return float(torch.mean(torch.sum(self._states * self._states, dim=(1, 2))))

    def sample(
        self, shots: int, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        """(batch, shots) samples, each trajectory from its own state."""
        if shots < 1:
            raise ValueError("shots must be >= 1")
        return sample_from_probs(
            self.trajectory_probabilities(), shots, self._generator(generator)
        )

    def histogram(
        self, shots: int, generator: torch.Generator | None = None
    ) -> dict[int, int]:
        """Aggregate histogram over all trajectories; total counts =
        batch_size * shots."""
        return counts_to_histogram(self.sample(shots, generator).cpu().numpy().ravel())

    def measure_qubit(
        self, qubit: int, generator: torch.Generator | None = None
    ) -> np.ndarray:
        """Per-trajectory projective measurement with collapse: each
        trajectory draws its own Born-rule outcome on the device and
        collapses; returns the (batch,) int32 outcomes."""
        self._check_qubit(qubit)
        u = self._uniforms((self.batch_size,), generator)
        self._states, outcome = collapse_batch(self._states, qubit, u)
        return outcome.to(torch.int32).cpu().numpy()

    def qubit_probability(self, qubit: int) -> float:
        self._check_qubit(qubit)
        p = self.probabilities().reshape(1 << (self.num_qubits - qubit - 1), 2, -1)
        return float(p[:, 1].sum())

    def reduced_density_matrix(self, qubits) -> np.ndarray:
        """Ensemble reduced density matrix: the trajectory average of the
        partial traces, i.e. the partial trace of
        rho_ens = mean_t |psi_t><psi_t| (the MCWF estimate of the channel's
        rho), in one matmul pair with the batch folded into the columns."""
        qs = self._validated_subset(qubits)
        return host_complex(*reduced_planes(self._all_states(), qs))

    def fidelity_with(self, other) -> float:
        """Mean trajectory fidelity against a pure state: the average of
        |<psi_t|phi>|^2 over the batch = <phi| rho_ens |phi>."""
        phi = self._peer_planes(other, (2, self.dim))
        s = self._all_states()
        re = torch.sum(s[:, 0] * phi[0] + s[:, 1] * phi[1], dim=1)
        im = torch.sum(s[:, 0] * phi[1] - s[:, 1] * phi[0], dim=1)
        return float(torch.mean(re * re + im * im))

    def expectation_pauli(self, pauli: str) -> float:
        """Trajectory-ensemble estimator: the mean over trajectories of
        <psi_t| P |psi_t> (converges to tr(rho P))."""
        ops = parse_pauli(pauli, self.num_qubits)
        if not ops:
            return 1.0
        return float(torch.mean(pauli_expectation(self._all_states(), ops)))

    @property
    def total_memory_bytes(self) -> int:
        """Device bytes held by the trajectory batch."""
        return self._states.numel() * self._states.element_size()

    @property
    def memory_bytes(self) -> int:
        return self.total_memory_bytes

    def set_state(self, amplitudes: Any) -> None:
        """Start every trajectory from the given pure state."""
        super().set_state(amplitudes)
        self._states = self._broadcast(self._state)

    def save_state(self, path: str) -> None:
        np.savez(
            path,
            planes=self._states.cpu().numpy(),
            num_qubits=self.num_qubits,
            batch_size=self.batch_size,
            dtype=str(self._rdtype),
        )

    def load_state(self, path: str) -> None:
        data = np.load(path)
        if int(data["num_qubits"]) != self.num_qubits:
            raise ValueError("checkpoint qubit count mismatch")
        if int(data.get("batch_size", -1)) != self.batch_size:
            raise ValueError("checkpoint batch size mismatch")
        planes = np.asarray(data["planes"], dtype=self._rdtype)
        if planes.shape != tuple(self._states.shape):
            raise ValueError("checkpoint shape mismatch")
        self._states = torch.from_numpy(planes).to(self.device)
