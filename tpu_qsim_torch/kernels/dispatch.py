"""Engine routing for ``StateVectorSimulator.run``: one table.

| dtype   | n       | device | engine                                               |
|---------|---------|--------|------------------------------------------------------|
| float32 | 10..18  | cuda   | whole-circuit program (``csrc/whole_circuit.cu``)    |
| float32 | 19      | cuda   | segmented program (``csrc/segment.cu``)              |
| float32 | 20..30  | cuda   | grid-sweep program (``csrc/grid_sweep.cu``)          |
| float32 | 20..26  | cuda   | segmented program, when the grid planner refuses     |
| float32 | 27..30  | cuda   | torch engine, when the grid planner refuses          |
| any     | any     | any    | torch engine (:mod:`tpu_qsim_torch.apply`)           |

It follows ``tpu_qsim/kernels/dispatch.py`` row by row. Where the grid
planner refuses a circuit (a dense gate that moves more high qubits than a
sweep's active budget), the JAX package tries its ``sweeps`` engine at
22-26q and then its segmented engine up to 26q; the port has no ``sweeps``
engine yet, so it goes straight to the segmented engine, the JAX package's
final fallback there. Above 26q the JAX package takes its XLA engine, and
the port the torch engine. The route is decided when a circuit is planned
and never changes because a build or a launch failed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..circuit import Circuit
from .fused_circuit import MAX_WHOLE_CIRCUIT_QUBITS, MIN_WHOLE_CIRCUIT_QUBITS
from .segmented import MAX_SEGMENTED_QUBITS

MIN_GRID_QUBITS = 20
MAX_GRID_QUBITS = 30


def engine_for(num_qubits: int, rdtype, device: torch.device) -> str:
    """Name of the engine that runs an ``num_qubits`` circuit, before the
    grid planner has seen it."""
    if np.dtype(rdtype) != np.float32 or torch.device(device).type != "cuda":
        return "torch"
    if MIN_WHOLE_CIRCUIT_QUBITS <= num_qubits <= MAX_WHOLE_CIRCUIT_QUBITS:
        return "whole_circuit"
    if num_qubits == MAX_WHOLE_CIRCUIT_QUBITS + 1:
        return "segmented"
    if MIN_GRID_QUBITS <= num_qubits <= MAX_GRID_QUBITS:
        return "grid_sweep"
    return "torch"


def plan_run(
    circuit: Circuit, rdtype, device: torch.device,
) -> tuple[str, Callable | None]:
    """(engine, program) for ``circuit``; the program is None for the torch
    engine, which the simulator builds from its own fusion settings."""
    from .fused_circuit import WholeCircuitProgram
    from .gridsweeps import GridSweepProgram
    from .segmented import SegmentedProgram

    n = circuit.num_qubits
    engine = engine_for(n, rdtype, device)
    if engine == "whole_circuit":
        return engine, WholeCircuitProgram(circuit)
    if engine == "segmented":
        return engine, SegmentedProgram(circuit)
    if engine == "grid_sweep":
        try:
            return engine, GridSweepProgram(circuit)
        except ValueError:
            # e.g. a dense gate wider than the active budget
            if n <= MAX_SEGMENTED_QUBITS:
                return "segmented", SegmentedProgram(circuit)
            return "torch", None
    return "torch", None
