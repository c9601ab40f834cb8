"""Noise models: channel registry + Kraus operator tables.

A host-only copy of ``tpu_qsim/noise.py`` (the port imports nothing of the
JAX package): six single-qubit channel types, registered per-qubit,
per-qubit-list, or globally. Global channels (no qubit list) mean "every
qubit" in all simulators, and every Kraus set is exact. Kraus conventions
follow Nielsen & Chuang; every set satisfies sum_k K_k^dag K_k = I
(``tests/test_torch_noisy.py``).
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
import numpy as np

from . import gates as G


class NoiseType(enum.Enum):
    DEPOLARIZING = "depolarizing"
    AMPLITUDE_DAMPING = "amplitude_damping"
    PHASE_DAMPING = "phase_damping"
    BIT_FLIP = "bit_flip"
    PHASE_FLIP = "phase_flip"
    BIT_PHASE_FLIP = "bit_phase_flip"


# Channels whose Kraus operators are all scaled unitaries (Pauli channels):
# branch probabilities are state-independent, so trajectory sampling can pick
# the branch first and apply one unitary — no per-branch norms needed.
UNITARY_MIX_TYPES = frozenset(
    {
        NoiseType.DEPOLARIZING,
        NoiseType.BIT_FLIP,
        NoiseType.PHASE_FLIP,
        NoiseType.BIT_PHASE_FLIP,
    }
)


@dataclass(frozen=True)
class NoiseChannel:
    """One registered channel. ``qubits=()`` means "all qubits" (global)."""

    type: NoiseType
    qubits: tuple[int, ...]
    probability: float

    def __post_init__(self) -> None:
        if not (0.0 <= self.probability <= 1.0):
            raise ValueError(
                f"channel probability must be in [0, 1], got {self.probability}"
            )

    def applies_to(self, qubit: int) -> bool:
        """Reference semantics: empty qubit list = applies everywhere
        (reference include/NoiseModel.cuh:119-122)."""
        return not self.qubits or qubit in self.qubits

    def resolved_qubits(self, num_qubits: int) -> tuple[int, ...]:
        return self.qubits if self.qubits else tuple(range(num_qubits))


def kraus_operators(ntype: NoiseType, p: float) -> list[np.ndarray]:
    """Exact single-qubit Kraus set for a channel (complex128)."""
    if ntype is NoiseType.BIT_FLIP:
        return [math.sqrt(1.0 - p) * G.I2, math.sqrt(p) * G.X]
    if ntype is NoiseType.PHASE_FLIP:
        return [math.sqrt(1.0 - p) * G.I2, math.sqrt(p) * G.Z]
    if ntype is NoiseType.BIT_PHASE_FLIP:
        return [math.sqrt(1.0 - p) * G.I2, math.sqrt(p) * G.Y]
    if ntype is NoiseType.DEPOLARIZING:
        return [
            math.sqrt(1.0 - p) * G.I2,
            math.sqrt(p / 3.0) * G.X,
            math.sqrt(p / 3.0) * G.Y,
            math.sqrt(p / 3.0) * G.Z,
        ]
    if ntype is NoiseType.AMPLITUDE_DAMPING:
        k0 = np.array([[1.0, 0.0], [0.0, math.sqrt(1.0 - p)]], dtype=np.complex128)
        k1 = np.array([[0.0, math.sqrt(p)], [0.0, 0.0]], dtype=np.complex128)
        return [k0, k1]
    if ntype is NoiseType.PHASE_DAMPING:
        k0 = np.array([[1.0, 0.0], [0.0, math.sqrt(1.0 - p)]], dtype=np.complex128)
        k1 = np.array([[0.0, 0.0], [0.0, math.sqrt(p)]], dtype=np.complex128)
        return [k0, k1]
    raise ValueError(f"unknown noise type {ntype}")


def unitary_mix(ntype: NoiseType, p: float) -> tuple[np.ndarray, np.ndarray]:
    """For Pauli channels: (branch_probs [B], unitaries [B, 2, 2]).

    The trajectory sampler draws one branch per channel application and
    applies the corresponding *unitary* — the textbook MCWF unraveling,
    replacing the reference's independent per-amplitude-pair coin flips
    (src/NoiseModel.cu:185-218; SURVEY quirk #3).
    """
    if ntype is NoiseType.BIT_FLIP:
        return np.array([1.0 - p, p]), np.stack([G.I2, G.X])
    if ntype is NoiseType.PHASE_FLIP:
        return np.array([1.0 - p, p]), np.stack([G.I2, G.Z])
    if ntype is NoiseType.BIT_PHASE_FLIP:
        return np.array([1.0 - p, p]), np.stack([G.I2, G.Y])
    if ntype is NoiseType.DEPOLARIZING:
        return (
            np.array([1.0 - p, p / 3.0, p / 3.0, p / 3.0]),
            np.stack([G.I2, G.X, G.Y, G.Z]),
        )
    raise ValueError(f"{ntype} is not a unitary-mix channel")


def _norm_qubits(qubits) -> tuple[int, ...]:
    if qubits is None:
        return ()
    if isinstance(qubits, (int, np.integer)):
        return (int(qubits),)
    return tuple(int(q) for q in qubits)


class NoiseModel:
    """Container of noise channels with fluent registration.

    Mirrors the reference's overload surface (per-qubit / qubit-list /
    global; reference src/NoiseModel.cu:24-101): ``qubits=None`` registers a
    global channel applying to every qubit.

    .. warning:: **Insertion semantics differ between backends**, faithfully
       mirroring the reference's two (mutually inconsistent) conventions:

       * ``NoisySimulator``/``BatchedSimulator``: after EVERY gate, every
         channel fires once per qubit it covers — even qubits the gate never
         touched (reference src/NoiseModel.cu:573-577).
       * ``DensityMatrixSimulator``: after every gate, channels fire only on
         the GATE'S OWN qubits (reference src/DensityMatrix.cu:201-212).

       The two coincide exactly when every channel's qubit set is contained
       in every gate's qubit set (e.g. single-qubit circuits, or channels
       registered on all qubits of an all-to-all circuit) — the condition the
       MCWF-vs-DM cross-validation tests construct deliberately.
    """

    def __init__(self) -> None:
        self._channels: list[NoiseChannel] = []

    # -- registration -------------------------------------------------------

    def add(self, ntype: NoiseType, probability: float, qubits=None) -> "NoiseModel":
        self._channels.append(
            NoiseChannel(ntype, _norm_qubits(qubits), float(probability))
        )
        return self

    def add_depolarizing(self, probability: float, qubits=None) -> "NoiseModel":
        return self.add(NoiseType.DEPOLARIZING, probability, qubits)

    def add_amplitude_damping(self, probability: float, qubits=None) -> "NoiseModel":
        return self.add(NoiseType.AMPLITUDE_DAMPING, probability, qubits)

    def add_phase_damping(self, probability: float, qubits=None) -> "NoiseModel":
        return self.add(NoiseType.PHASE_DAMPING, probability, qubits)

    def add_bit_flip(self, probability: float, qubits=None) -> "NoiseModel":
        return self.add(NoiseType.BIT_FLIP, probability, qubits)

    def add_phase_flip(self, probability: float, qubits=None) -> "NoiseModel":
        return self.add(NoiseType.PHASE_FLIP, probability, qubits)

    def add_bit_phase_flip(self, probability: float, qubits=None) -> "NoiseModel":
        return self.add(NoiseType.BIT_PHASE_FLIP, probability, qubits)

    # -- queries ------------------------------------------------------------

    @property
    def channels(self) -> list[NoiseChannel]:
        return list(self._channels)

    def has_noise(self) -> bool:
        return bool(self._channels)

    def __len__(self) -> int:
        return len(self._channels)

    def channels_for_qubit(self, qubit: int) -> list[NoiseChannel]:
        return [c for c in self._channels if c.applies_to(qubit)]

    def signature(self) -> tuple:
        """Hashable description (used by compiled-program caches)."""
        return tuple((c.type.value, c.qubits, c.probability) for c in self._channels)

    def applications_per_gate(self, num_qubits: int) -> list[tuple[NoiseType, int, float]]:
        """Flat (type, qubit, p) list applied after every gate — the
        reference NoisySimulator's semantics (every registered channel fires
        on each of its qubits after each gate; src/NoiseModel.cu:573-577),
        with global channels resolved to all qubits."""
        out = []
        for c in self._channels:
            for q in c.resolved_qubits(num_qubits):
                out.append((c.type, q, c.probability))
        return out
