"""Engine routing for ``StateVectorSimulator.run``: one table.

| dtype   | n       | device | engine                                      |
|---------|---------|--------|---------------------------------------------|
| float32 | 20..30  | cuda   | grid-sweep program (``csrc/grid_sweep.cu``) |
| any     | any     | any    | torch engine (:mod:`tpu_qsim_torch.apply`)  |

The JAX package's tiers below 20 qubits (the whole-circuit kernel at 10-18q,
the segmented kernel at 19q) and its fallbacks when the grid planner cannot
place a circuit (the ``sweeps`` and ``segmented`` engines) are not ported
yet; ROADMAP.md queues them. Until then a circuit the grid planner refuses
raises rather than silently taking another route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..circuit import Circuit

MIN_GRID_QUBITS = 20
MAX_GRID_QUBITS = 30


def engine_for(num_qubits: int, rdtype, device: torch.device) -> str:
    """Name of the engine that runs an ``num_qubits`` circuit."""
    if (
        np.dtype(rdtype) == np.float32
        and MIN_GRID_QUBITS <= num_qubits <= MAX_GRID_QUBITS
        and torch.device(device).type == "cuda"
    ):
        return "grid_sweep"
    return "torch"


def build_grid_run(circuit: Circuit):
    """The grid-sweep program for ``circuit``; NotImplementedError when the
    planner cannot place it (the engines the JAX package falls back to are
    not ported)."""
    from .gridsweeps import GridSweepProgram

    try:
        return GridSweepProgram(circuit)
    except ValueError as e:
        raise NotImplementedError(
            f"the grid-sweep planner cannot place this circuit ({e}); the "
            "JAX package's fallback engines (sweeps, segmented) are not "
            "ported yet"
        ) from e
