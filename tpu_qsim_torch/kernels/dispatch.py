"""Engine routing for ``StateVectorSimulator.run``: one table.

| dtype   | n       | device | engine                                               |
|---------|---------|--------|------------------------------------------------------|
| float32 | 10..18  | cuda   | whole-circuit program (``csrc/whole_circuit.cu``)    |
| float32 | 19      | cuda   | segmented program (``csrc/segment.cu``)              |
| float32 | 20..30  | cuda   | grid-sweep program (``csrc/grid_sweep.cu``)          |
| float32 | 22..26  | cuda   | sweep program (``csrc/sweep.cu``), when the grid     |
|         |         |        | planner refuses                                      |
| float32 | 20..26  | cuda   | segmented program, when the grid planner and (at     |
|         |         |        | 22-26q) the sweep planner refuse                     |
| float32 | 27..30  | cuda   | torch engine, when the grid planner refuses          |
| any     | any     | any    | torch engine (:mod:`tpu_qsim_torch.apply`)           |

It follows ``tpu_qsim/kernels/dispatch.py`` row by row. The grid planner
refuses a circuit with a dense gate that moves more high qubits than a
sweep's active budget; the JAX package then tries its ``sweeps`` engine at
22-26q, then its segmented engine up to 26q, and above 26q its XLA engine,
as the port does with its sweep, segmented and torch engines. The
segmented engine takes gates of up to 9 qubits (its 14-bit block keeps as
few as 5 low bits in place for a wide gate), so it runs circuits that the
JAX package's own segmented planner spins on (e.g. an 8-qubit gate on
qubits 14-21 of 22). Where every engine in reach refuses (at most 26
qubits), :func:`plan_run` raises a ValueError that names each refusal. The
route is decided when a circuit is planned and never changes because a
build or a launch failed.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..circuit import Circuit
from .fused_circuit import MAX_WHOLE_CIRCUIT_QUBITS, MIN_WHOLE_CIRCUIT_QUBITS
from .segmented import MAX_SEGMENTED_QUBITS
from .sweeps import MAX_SWEEP_QUBITS, MIN_SWEEP_QUBITS

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
    from .sweeps import SweepProgram

    n = circuit.num_qubits
    engine = engine_for(n, rdtype, device)
    if engine == "whole_circuit":
        return engine, WholeCircuitProgram(circuit)
    if engine == "segmented":
        return engine, SegmentedProgram(circuit)
    if engine != "grid_sweep":
        return "torch", None
    fallbacks = [("grid_sweep", GridSweepProgram)]
    if MIN_SWEEP_QUBITS <= n <= MAX_SWEEP_QUBITS:
        fallbacks.append(("sweeps", SweepProgram))
    if n <= MAX_SEGMENTED_QUBITS:
        fallbacks.append(("segmented", SegmentedProgram))
    refusals = []
    for name, program in fallbacks:
        try:
            return name, program(circuit)
        except ValueError as e:   # e.g. a dense gate wider than the block
            refusals.append(f"{name}: {e}")
    if n > MAX_SEGMENTED_QUBITS:
        return "torch", None
    raise ValueError(
        f"no engine takes this {n}-qubit circuit; " + "; ".join(refusals)
    )
