"""Carry a simulation across from the JAX package.

Both packages keep the same ``(2, 2^n)`` planes layout, the same circuit IR
and the same noise channels, so moving a state, a circuit or a noise model is
a copy. Nothing here imports the JAX
package: a state arrives as a numpy array and a circuit by duck typing. A
sharded JAX simulator's state crosses as its gathered amplitudes
(``jax_sim.get_state()``) through a port simulator's ``set_state``, which
keeps each rank's slice on a sharded one.
"""

from __future__ import annotations

import numpy as np
import torch

from . import apply as ap
from .circuit import Circuit, Gate
from .gates import multi_controlled_z_name
from .noise import NoiseModel, NoiseType


def state_from_jax(planes: np.ndarray, device=None) -> torch.Tensor:
    """A JAX simulator's ``(2, 2^n)`` planes (``np.asarray(sim.state_planes)``)
    as the port's state tensor on ``device`` (``None`` = the card)."""
    planes = np.asarray(planes)
    if planes.ndim != 2 or planes.shape[0] != 2:
        raise ValueError(f"expected (2, 2^n) planes, got {planes.shape}")
    dim = planes.shape[1]
    if dim < 2 or dim & (dim - 1):
        raise ValueError(f"plane length {dim} is not a power of two >= 2")
    if planes.dtype not in (np.float32, np.float64):
        raise ValueError(f"planes must be float32 or float64, got {planes.dtype}")
    return torch.tensor(planes, device=ap.resolve_device(device))


def circuit_from_jax(obj) -> Circuit:
    """A port :class:`Circuit` with the gates of ``obj``: any object with
    ``.num_qubits`` and ``.gates`` of ``(name, qubits, param)`` gates (inline
    ``matrix_bytes`` payloads carry over)."""
    c = Circuit(int(obj.num_qubits))
    for g in obj.gates:
        name, qubits = g.name, tuple(int(q) for q in g.qubits)
        payload = getattr(g, "matrix_bytes", None)
        if payload is None and name.startswith("mcz"):
            multi_controlled_z_name(len(qubits))   # registers mczK on first use
        param = None if g.param is None else float(g.param)
        c.append(Gate(name, qubits, param, payload))
    return c


def noise_model_from_jax(obj) -> NoiseModel:
    """A port :class:`NoiseModel` with the channels of ``obj``: any object
    with ``.channels`` of ``(type, qubits, probability)`` channels whose
    ``type.value`` names a :class:`NoiseType`."""
    model = NoiseModel()
    for c in obj.channels:
        model.add(NoiseType(c.type.value), float(c.probability), c.qubits or None)
    return model
