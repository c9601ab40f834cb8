"""Engine routing for ``StateVectorSimulator.run``: one table.

| dtype   | n       | device | engine                                               |
|---------|---------|--------|------------------------------------------------------|
| float32 | 10..18  | cuda   | whole-circuit program (``csrc/sweep.cu``, one unit)  |
| float32 | 19      | cuda   | segmented program (``csrc/segment.cu``)              |
| float32 | 20..30  | cuda   | grid-sweep program (``csrc/grid_sweep.cu``)          |
| float32 | 22..26  | cuda   | sweep program (``csrc/sweep.cu``), when the grid     |
|         |         |        | planner refuses                                      |
| float32 | 20..21  | cuda   | segmented program, when the grid planner refuses     |
| float32 | 22..30  | cuda   | the circuit split at each gate that the grid planner |
|         |         |        | refuses, where the sweeps refuse it too: grid-sweep  |
|         |         |        | pieces, a dense pass (``csrc/dense_pass.cu``) for    |
|         |         |        | each such gate (in place of the segments at 22-26q,  |
|         |         |        | of the torch engine above)                           |
| float32 | 10..30  | cuda   | the circuit split at each dense core of              |
|         |         |        | ``MIN_SWEEP_PASS_CORE`` (10) qubits or more, and on  |
|         |         |        | the grid row from 22q of 5 qubits or more where the  |
|         |         |        | grid planner takes it (``GRID_CUTS``): the rows      |
|         |         |        | above for the pieces, a dense pass for each such gate|
| any     | any     | any    | torch engine (:mod:`tpu_qsim_torch.apply`)           |

It follows ``tpu_qsim/kernels/dispatch.py`` row by row, with the split
added. The grid planner refuses a circuit with a dense gate that moves more
high qubits than a sweep's active budget (``gridsweeps.refuses``); the JAX
package then tries its ``sweeps`` engine at 22-26q, then its segmented
engine up to 26q, and above 26q its XLA engine. The port's row plans the
same fallbacks (:func:`_plan_piece`), but from 22q, where the sweeps
refuse too, it cuts the piece at each refused gate before it tries the
segments or the torch engine, so that no 27-30-qubit circuit leaves the
kernels for one wide gate; a piece still refused (around a gate whose core
the pass cannot take) keeps the row's fallback. The segmented
engine takes gates of up to 9 qubits (its 14-bit block keeps as few as 5
low bits in place for a wide gate), so it runs circuits that the JAX
package's own segmented planner spins on (e.g. an 8-qubit gate on qubits
14-21 of 22, which the route now cuts at instead). Where every engine in reach refuses
(at most 26 qubits), :func:`plan_run` raises a ValueError that names each
refusal. The route is decided when a circuit is planned and never changes
because a build or a launch failed.

The split (the route by width): the pieces between the cut gates are
planned by this table as circuits of their own, each cut gate becomes a
whole-state pass (:class:`~tpu_qsim_torch.kernels.dense_pass.DensePass`; a
core of fewer than 7 qubits widened to 7 by an identity), and a
:class:`SplitProgram` runs them in order; the engine's name joins the
pieces' engines and ``dense_pass`` (e.g. ``"grid_sweep+dense_pass"``). The
sweeps, planned whole, send their unit stages of ``sweeps.MIN_UNIT_PASS_CORE``
(6) qubits or more to the same pass. The JAX package runs such cores
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
# The grid row's cuts by size, from tune_route --crossover on the H100
# (PERF.md §6): from each n listed up to the next, the narrowest dense
# core that the split cuts at where the grid planner takes it, and whether
# it cuts at every gate that the grid planner refuses where the sweeps
# refuse the piece too (in place of the segments to 26q and of the torch
# engine above). Since the dense pass's stream instance the split won at
# every core of 5-9 qubits measured from 22q (20-30q, lowest, middle and
# highest qubits; 5 the narrowest measured), and the grid's tiled op at
# every one at 20q; also in circuits holding several 5-6-qubit dense gates
# at 22-30q, by 22-47% (a layer of them on disjoint qubits, or four spread
# between random layers: tune_route --several, PERF.md).
GRID_CUTS = (
    (MIN_GRID_QUBITS, MIN_SWEEP_PASS_CORE, False),
    (22, 5, True),
)


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
    engine's range, where the grid planner refuses it: around a gate whose
    core the pass cannot take): its gates one by one through ``apply.py``."""

    def __init__(self, circuit: Circuit):
        from .fused_circuit import as_pgates

        self.gates = as_pgates(circuit.gates)

    def run(self, state: torch.Tensor) -> torch.Tensor:
        from .fused_circuit import apply_pgates

        return apply_pgates(state, self.gates)

    run_plain = run


class SplitProgram:
    """A circuit split at its cut gates (:func:`split_at_wide_cores`):
    ``steps`` are the pieces' programs and the passes
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


def cuts_for(engine: str, n: int) -> tuple[int, bool]:
    """(width, refused) of the split on the kernel row ``engine`` at n
    qubits: it cuts at dense cores of ``width`` qubits or more, and with
    ``refused`` at every gate that the grid planner refuses where the sweeps
    do not take the piece that holds it (``GRID_CUTS`` on the grid row;
    ``MIN_SWEEP_PASS_CORE`` and no refused gate elsewhere)."""
    width, refused = MIN_SWEEP_PASS_CORE, False
    if engine == "grid_sweep":
        for lo, w, r in GRID_CUTS:
            if n >= lo:
                width, refused = w, r
    return width, refused


def _cut(g, n: int, width: int, refused: bool) -> bool:
    """Whether the split cuts at the planner gate ``g``: where the grid
    planner takes it (``gridsweeps.refuses``), at a peeled core of
    ``width`` qubits or more; where it refuses it, at any core with
    ``refused`` and else at one of ``MIN_SWEEP_PASS_CORE`` or more. And the
    pass takes the core (:func:`dense_pass.widened`)."""
    from .dense_pass import pass_core, widened
    from .gridsweeps import refuses

    least = width
    if (width < MIN_SWEEP_PASS_CORE or refused) and refuses(g, n):
        least = 1 if refused else MIN_SWEEP_PASS_CORE
    found = pass_core(g, least - 1)
    return found is not None and widened(found, n) is not None


def split_at_wide_cores(
    circuit: Circuit, width: int = MIN_SWEEP_PASS_CORE, refused: bool = False,
) -> list | None:
    """The circuit cut at its gates where :func:`_cut` says: pieces
    (circuits, empty ones left out) and such gates (``PGate``) in order;
    None when it has no such gate."""
    from .fused_circuit import as_pgates
    from .gridsweeps import A_MAX

    n = circuit.num_qubits
    # a gate of up to this many qubits has no core of ``width`` and moves
    # no more high qubits than the grid's active budget
    narrow = min(width - 1, A_MAX) if refused else width - 1
    out: list = []
    piece = Circuit(n)
    for g in circuit.gates:
        if len(g.qubits) > narrow:
            (pg,) = as_pgates([g])
            if _cut(pg, n, width, refused):
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
    table, split where :func:`cuts_for` says: at its wide cores, then (on the
    grid row from 22q) each piece that the grid planner and the sweeps
    refuse at its refused gates (:func:`_plan_piece`); the program is None
    where the row gives way to the torch engine."""
    n = circuit.num_qubits
    width, refused = cuts_for(engine, n)
    parts = split_at_wide_cores(circuit, width)
    if parts is None:
        return _plan_piece(circuit, engine, refused)
    split = _split_program(parts, engine, n, refused)
    return split.engine, split


def plan_split(
    circuit: Circuit, engine: str, width: int = MIN_SWEEP_PASS_CORE, refused: bool = False,
) -> tuple[str, Callable | None]:
    """(engine, program) for ``circuit`` cut as :func:`split_at_wide_cores`
    cuts it (with ``refused`` at every refused gate, whatever the sweeps
    take), its pieces planned on the kernel row ``engine``; the program is
    None where the row gives the whole circuit to the torch engine."""
    parts = split_at_wide_cores(circuit, width, refused)
    if parts is None:
        return _plan_piece(circuit, engine)
    split = _split_program(parts, engine, circuit.num_qubits, False)
    return split.engine, split


def _split_program(parts: list, engine: str, n: int, cut_refused: bool) -> SplitProgram:
    """The :class:`SplitProgram` of ``parts`` (:func:`split_at_wide_cores`):
    each piece planned by :func:`_plan_piece`, each cut gate a pass."""
    from .dense_pass import DensePass, pass_core

    steps, engines = [], []
    for part in parts:
        if isinstance(part, Circuit):
            name, prog = _plan_piece(part, engine, cut_refused)
            if isinstance(prog, SplitProgram):      # cut at its refused gates
                steps += prog.steps
                engines += prog.engines
                continue
            steps.append(_TorchPiece(part) if prog is None else prog)
        else:
            name = "dense_pass"
            steps.append(DensePass(part, n, pass_core(part, 0)))
        engines.append(name)
    return SplitProgram(steps, engines)


def _plan_piece(
    circuit: Circuit, engine: str, cut_refused: bool = False,
) -> tuple[str, Callable | None]:
    """(engine, program) for a circuit, whole, on the kernel row ``engine``
    of the table (a piece of a split, or a circuit with no cut); with
    ``cut_refused``, where the grid planner and the sweeps refuse it, the
    circuit cut at its refused gates (:func:`split_at_wide_cores`) in place
    of the segments or the torch engine."""
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
    if cut_refused:
        def cut(c: Circuit) -> SplitProgram:
            parts = split_at_wide_cores(c, refused=True)
            if parts is None:
                raise ValueError("the dense pass takes no refused gate")
            return _split_program(parts, engine, n, False)

        fallbacks.append(("cut", cut))
    if n <= MAX_SEGMENTED_QUBITS:
        fallbacks.append(("segmented", SegmentedProgram))
    refusals = []
    for name, program in fallbacks:
        try:
            prog = program(circuit)
        except ValueError as e:   # e.g. a dense gate wider than the block
            refusals.append(f"{name}: {e}")
            continue
        return (prog.engine if isinstance(prog, SplitProgram) else name), prog
    if n > MAX_SEGMENTED_QUBITS:
        return "torch", None
    raise ValueError(
        f"no engine takes this {n}-qubit circuit; " + "; ".join(refusals)
    )
