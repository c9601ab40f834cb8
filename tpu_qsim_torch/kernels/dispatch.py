"""Engine routing for ``StateVectorSimulator.run``: one table.

| dtype   | n       | device | engine                                               |
|---------|---------|--------|------------------------------------------------------|
| float32 | 10..18  | cuda   | whole-circuit program (``csrc/sweep.cu``, one unit)  |
| float32 | 19      | cuda   | segmented program (``csrc/segment.cu``)              |
| float32 | 20..30  | cuda   | grid-sweep program (``csrc/grid_sweep.cu``)          |
| float32 | 22..26  | cuda   | sweep program (``csrc/sweep.cu``), when the grid     |
|         |         |        | planner refuses                                      |
| float32 | 20..26  | cuda   | segmented program, when the grid planner and (at     |
|         |         |        | 22-26q) the sweep planner refuse                     |
| float32 | 27..30  | cuda   | torch engine, when the grid planner refuses          |
| float32 | 10..30  | cuda   | the circuit split at each dense core of 10 qubits    |
|         |         |        | or more: the rows above for the pieces, the dense    |
|         |         |        | pass (``csrc/dense_pass.cu``) for each such gate     |
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

On the kernel rows, a gate whose dense core (its controls peeled) has
``MIN_SWEEP_PASS_CORE`` (10) qubits or more splits the circuit (the route
by width): the pieces between such gates are planned by this table as
circuits of their own, each such gate becomes a whole-state pass
(``csrc/dense_pass.cu``), and a :class:`SplitProgram` runs them in order;
the engine's name joins the pieces' engines and ``dense_pass`` (e.g.
``"whole_circuit+dense_pass"``). The sweeps, planned whole, send their unit
stages of that width to the same pass. The JAX package runs such cores
inside its kernels.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..circuit import Circuit
from .fused_circuit import MAX_WHOLE_CIRCUIT_QUBITS, MIN_WHOLE_CIRCUIT_QUBITS
from .segmented import MAX_SEGMENTED_QUBITS
from .sweeps import MAX_SWEEP_QUBITS, MIN_SWEEP_PASS_CORE, MIN_SWEEP_QUBITS

MIN_GRID_QUBITS = 20
MAX_GRID_QUBITS = 30


def engine_for(num_qubits: int, rdtype, device: torch.device) -> str:
    """Name of the engine that runs an ``num_qubits`` circuit, before the
    grid planner has seen it."""
    if np.dtype(rdtype) != np.float32 or torch.device(device).type != "cuda":
        return "torch"
    return engine_for_size(num_qubits)


def engine_for_size(num_qubits: int) -> str:
    """The kernel row of the table for float32 planes of ``num_qubits``
    qubits, whatever the device (the sharded executor plans its shards'
    programs with it, and a CPU shard runs their plain versions)."""
    if MIN_WHOLE_CIRCUIT_QUBITS <= num_qubits <= MAX_WHOLE_CIRCUIT_QUBITS:
        return "whole_circuit"
    if num_qubits == MAX_WHOLE_CIRCUIT_QUBITS + 1:
        return "segmented"
    if MIN_GRID_QUBITS <= num_qubits <= MAX_GRID_QUBITS:
        return "grid_sweep"
    return "torch"


class _TorchPiece:
    """A piece of a split circuit on the torch engine (above the segmented
    engine's range, where the grid planner refuses it): its gates one by one
    through ``apply.py``."""

    def __init__(self, circuit: Circuit):
        from .fused_circuit import as_pgates

        self.gates = as_pgates(circuit.gates)

    def run(self, state: torch.Tensor) -> torch.Tensor:
        from .fused_circuit import apply_pgates

        return apply_pgates(state, self.gates)

    run_plain = run


class SplitProgram:
    """A circuit split at its gates with dense cores of ``MIN_SWEEP_PASS_CORE``
    qubits or more: ``steps`` are the pieces' programs and the passes
    (:class:`~tpu_qsim_torch.kernels.dense_pass.DensePass`) in circuit order,
    ``engines`` the name of each. ``run`` and ``run_plain`` map (2, 2^n)
    planes through each step's ``run`` or ``run_plain`` in turn."""

    def __init__(self, steps: list, engines: list[str]):
        self.steps = steps
        self.engines = engines
        self.engine = "+".join(dict.fromkeys(engines))

    def run(self, state: torch.Tensor) -> torch.Tensor:
        for step in self.steps:
            state = step.run(state)
        return state

    __call__ = run

    def run_plain(self, state: torch.Tensor) -> torch.Tensor:
        for step in self.steps:
            state = step.run_plain(state)
        return state


def split_at_wide_cores(circuit: Circuit) -> list | None:
    """The circuit cut at its gates whose dense core has
    ``MIN_SWEEP_PASS_CORE`` qubits or more: pieces (circuits, empty ones left
    out) and such gates (``PGate``) in order; None when it has no such
    gate."""
    from .dense_pass import pass_core
    from .fused_circuit import as_pgates

    n = circuit.num_qubits
    out: list = []
    piece = Circuit(n)
    for g in circuit.gates:
        if len(g.qubits) >= MIN_SWEEP_PASS_CORE:
            (pg,) = as_pgates([g])
            if pass_core(pg, MIN_SWEEP_PASS_CORE - 1) is not None:
                if piece.gates:
                    out.append(piece)
                    piece = Circuit(n)
                out.append(pg)
                continue
        piece.append(g)
    if not out:
        return None
    if piece.gates:
        out.append(piece)
    return out


def plan_run(
    circuit: Circuit, rdtype, device: torch.device,
) -> tuple[str, Callable | None]:
    """(engine, program) for ``circuit``; the program is None for the torch
    engine, which the simulator builds from its own fusion settings."""
    engine = engine_for(circuit.num_qubits, rdtype, device)
    if engine == "torch":
        return "torch", None
    return plan_kernels(circuit, engine)


def plan_kernels(circuit: Circuit, engine: str) -> tuple[str, Callable | None]:
    """(engine, program) for ``circuit`` on the kernel row ``engine`` of the
    table, split at its cores of ``MIN_SWEEP_PASS_CORE`` qubits or more (the
    route by width); the program is None where the row gives way to the
    torch engine."""
    from .dense_pass import DensePass, pass_core

    n = circuit.num_qubits
    parts = split_at_wide_cores(circuit)
    if parts is None:
        return _plan_piece(circuit, engine)
    steps, engines = [], []
    for part in parts:
        if isinstance(part, Circuit):
            name, prog = _plan_piece(part, engine)
            steps.append(_TorchPiece(part) if prog is None else prog)
        else:
            name = "dense_pass"
            steps.append(DensePass(part, n, pass_core(part, MIN_SWEEP_PASS_CORE - 1)))
        engines.append(name)
    split = SplitProgram(steps, engines)
    return split.engine, split


def _plan_piece(circuit: Circuit, engine: str) -> tuple[str, Callable | None]:
    """(engine, program) for a circuit with no core of ``MIN_SWEEP_PASS_CORE``
    qubits or more, on the kernel row ``engine`` of the table."""
    from .fused_circuit import WholeCircuitProgram
    from .gridsweeps import GridSweepProgram
    from .segmented import SegmentedProgram
    from .sweeps import SweepProgram

    n = circuit.num_qubits
    if engine == "whole_circuit":
        return engine, WholeCircuitProgram(circuit)
    if engine == "segmented":
        return engine, SegmentedProgram(circuit)
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
