"""Sweeps engine on the CUDA card (22-26 qubits, the grid planner's fallback).

The port of ``tpu_qsim/kernels/sweeps.py``. The state is split on its top
``K = 5`` bits into 32 *parts*. Two sweep shapes cover every bit:

* a **low sweep** applies its gates to state bits ``[0, n - K)`` of each
  part; the part's top bits are out of the block;
* a **high sweep** applies its gates to bits ``[0, 16)`` plus up to 4
  *active* top bits (padded to 4), in steps over the mid bits
  ``[16, n - K)`` and the inactive top bits.

Only a gate's moving qubits must lie in the block; diagonal and control
structure on any other bit is read from the part's or step's share of the
global index. :func:`plan_sweeps` is a copy of the JAX planner (frontier
scheduling, a SWAP across the two regions as 3 CNOTs) and gives the same
plans gate by gate at the same :class:`SweepParams`.

A sweep runs as launches of ``csrc/sweep.cu`` (:func:`low_sweep`,
:func:`high_sweep`, :func:`unit_stage`) over the flat ``(2, 2^n)`` planes,
in place: a part is the view of the top K bits, so the TPU engine's
``to_parts``/``from_parts`` staging copies have no counterpart. The
relabelings of the TPU kernels (``_relabel_low``, ``_relabel_high``) are
the sweeps' :class:`BlockLayout` s, whose codes name block bits or, as
``EXT + q``, state bit q outside the block. The block (a *unit*: a part or
a step) is 2^17-2^21 slots of device memory; a launch keeps several units
in flight (:class:`SweepGeometry`, chosen on the card with ``python -m
tpu_qsim_torch.kernels.tune_sweeps``).
:func:`plan_stages` cuts a sweep's ops into stages: runs of ops that fit in
a 2^T-slot tile, each run as one grid-sweep register table over the tile's
bits (``gridsweeps.register_table``) that the kernel applies tile by tile
in one pass over the unit, and dense cores of ``TILE_CORE`` qubits or more,
each a pass of ops.cuh's tiled op over the whole unit. :func:`sweep_table`
joins stages into the kernel's table. :func:`plan_launches` cuts a sweep's
stages into launches, each run at the occupancy that suits it: a run of
tile stages on the instance for narrow cores (two CTAs an SM), a unit stage
alone on the wide instance (one CTA an SM: the tiled op's 128 registers a
thread), and a unit stage of ``MIN_SWEEP_PASS_CORE`` qubits or more through
the dense pass (``dense_pass.py``) on the gate's state qubits. On the H100
the 26-qubit main path's low sweep (tile, unit, tile) ran 0.42 ms faster
split than in one launch, and fewer units in flight were slower (PERF.md).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import apply as ap
from ..circuit import Circuit, Gate
from ..gates import op_matrix
from . import LAUNCHES
from .fused_circuit import (
    HEADER_MAX_CORE,
    MAX_DENSE_QUBITS,
    MAX_SWEEP_BITS,
    NARROW_CORE,
    SWEEP_HEADER,
    TILE_CORE,
    BlockLayout,
    OpTable,
    PGate,
    _controlled_split,
    _is_diagonal,
    apply_pgates,
    as_pgates,
    build_op_table,
    check_kernel_inputs,
    check_tile,
    check_planes,
    merge_1q_chains,
)

K_BITS = 5                 # part-split bits: the top K state bits
RB_BITS = 9                # the JAX planner's row bits ...
LANE_BITS = 7              # ... and lane bits: a high block holds bits [0, 16)
MIN_SWEEP_QUBITS = RB_BITS + LANE_BITS + K_BITS + 1   # 22
MAX_SWEEP_QUBITS = 26
# The JAX planner's per-sweep gate cap (a Mosaic compile bound there) and its
# active-top budget; kept so plans compare gate by gate. MAX_SWEEP_GATES is
# plan_grid_sweeps' default cap too.
MAX_SWEEP_GATES = 56
MAX_ACTIVE_TOPS = 4        # sweep.cu: MAX_ACTIVE


@dataclass(frozen=True)
class SweepParams:
    """Engine geometry: the module defaults, shrunk by tests."""

    k_bits: int = K_BITS
    rb_bits: int = RB_BITS

    @property
    def blk_bits(self) -> int:
        return self.rb_bits + LANE_BITS


def moving_qubits(u: np.ndarray, qubits: tuple[int, ...]) -> frozenset[int]:
    """Qubits along which ``u`` actually moves amplitudes: diagonal matrices
    move nothing; a controlled matrix moves only what its inner block moves."""
    if _is_diagonal(u):
        return frozenset()
    v = _controlled_split(u)
    if v is not None:
        return moving_qubits(v, qubits[1:])
    return frozenset(qubits)


@dataclass
class Sweep:
    kind: str                      # "low" | "high"
    gates: list[Gate] = field(default_factory=list)
    tops: set = field(default_factory=set)   # high: active top bits (moving)


def plan_sweeps(
    circuit: Circuit,
    n: int | None = None,
    params: SweepParams = SweepParams(),
) -> list[Sweep]:
    """Partition the circuit into low/high sweeps via frontier scheduling.

    low block = bits [0, n-K); high block = bits [0, blk_bits) + active top
    bits. A gate fits a sweep iff its moving qubits lie in that block.
    Local/diagonal gates fit everywhere and ride the current sweep. A swap
    moving across the two exclusive regions decomposes into 3 cnots. Raises
    ValueError for a gate no sweep can hold.
    """
    from ..commute import FrontierScheduler

    n = circuit.num_qubits if n is None else n
    top = frozenset(range(n - params.k_bits, n))
    lowmid = frozenset(range(params.blk_bits, n - params.k_bits))

    max_tops = min(MAX_ACTIVE_TOPS, params.k_bits)
    gates: list[Gate] = []
    for g in circuit.gates:
        mv = moving_qubits(op_matrix(g), g.qubits)
        if mv & top and mv & lowmid:
            if g.name == "swap":
                a, b = g.qubits
                gates += [
                    Gate("cnot", (a, b)),
                    Gate("cnot", (b, a)),
                    Gate("cnot", (a, b)),
                ]
                continue
            raise ValueError(
                f"gate {g.name}{g.qubits} moves both a mid and a top qubit"
            )
        if len(mv & top) > max_tops:
            # a dense gate moving more top bits than a high block holds can
            # never fit any sweep; without this check the scheduler below
            # would flip kinds forever without progress
            raise ValueError(
                f"gate {g.name}{g.qubits} moves {len(mv & top)} top qubits; "
                f"the sweep engine stacks at most {max_tops}"
            )
        gates.append(g)

    mv_cache = [moving_qubits(op_matrix(g), g.qubits) for g in gates]

    def fits(i: int, cur: Sweep) -> bool:
        if len(cur.gates) >= MAX_SWEEP_GATES:
            return False
        mv = mv_cache[i]
        if cur.kind == "low":
            return not (mv & top)
        return (
            not (mv & lowmid)
            and len(cur.tops | (mv & top)) <= MAX_ACTIVE_TOPS
        )

    sched = FrontierScheduler(gates)
    sweeps: list[Sweep] = []
    cur: Sweep | None = None
    flips = 0
    while not sched.done():
        if cur is not None:
            progressed = True
            while progressed:
                progressed = False
                for i in sched.ready():
                    if fits(i, cur):
                        sched.emit(i)
                        cur.gates.append(gates[i])
                        cur.tops |= mv_cache[i] & top
                        progressed = True
                        break
        if sched.done():
            break
        ready = sched.ready()
        need_low = sum(1 for i in ready if mv_cache[i] & lowmid)
        need_high = sum(1 for i in ready if mv_cache[i] & top)
        nxt = "high" if need_high >= need_low else "low"
        if cur is None or cur.gates:
            if cur is not None:
                sweeps.append(cur)
            cur = Sweep(nxt)
            flips = 0
        else:  # a fresh sweep absorbed nothing: flip kind
            cur = Sweep(nxt)
            flips += 1
            if flips > 2:  # both kinds tried fresh: nothing can ever fit
                g = gates[sched.ready()[0]]
                raise ValueError(
                    f"sweep planner cannot place gate {g.name}{g.qubits}"
                )
    if cur is not None and cur.gates:
        sweeps.append(cur)
    return sweeps


def low_layout(n: int, params: SweepParams = SweepParams()) -> BlockLayout:
    """A low sweep's block: state bits [0, n-K); the top bits are out of
    the block (the JAX package's ``_relabel_low``)."""
    return BlockLayout(n, n - params.k_bits, ())


def high_layout(
    sweep: Sweep, n: int, params: SweepParams = SweepParams(),
) -> BlockLayout:
    """A high sweep's block: bits [0, blk_bits) and the active top bits,
    padded with the lowest free top bits to ``min(MAX_ACTIVE_TOPS, K)``, at
    block bits ``blk_bits + rank`` (the JAX package's ``_relabel_high``)."""
    active = set(sweep.tops)
    for p in range(n - params.k_bits, n):
        if len(active) >= min(MAX_ACTIVE_TOPS, params.k_bits):
            break
        active.add(p)
    return BlockLayout(n, params.blk_bits, tuple(sorted(active)))


# ---------------------------------------------------------------------------
# The kernels (csrc/sweep.cu)
# ---------------------------------------------------------------------------


# Units a sweep keeps in flight when its geometry does not fix the count: as
# many as fit in half the H100's 50 MB L2, and at least MIN_IN_FLIGHT (with
# tile passes, 4 or 8 units of 16 MB at 26 qubits ran faster than 1 or 2 on
# the H100, 8 by 1-2%; a launch of three stages too, though 8 such units
# overflow the L2: 4.37-4.44 ms at 8 against 4.62-4.72 at 4, 4.94-5.02 at 2
# and 5.54-5.63 at 1: PERF.md)
L2_BUDGET = 24 << 20
MIN_IN_FLIGHT = 8


@dataclass(frozen=True)
class SweepGeometry:
    """How a sweep launch spreads over the card: ``threads`` per CTA, each
    holding 16 amplitudes of a tile (so a tile is 2^T = 16 x threads slots,
    smaller only where the unit is), and ``in_flight`` units at once (None:
    as many as fit in ``L2_BUDGET``, at least ``MIN_IN_FLIGHT``). The launch
    takes the most CTAs the card keeps resident, rounded down to a power of
    two, each unit owned by an equal share. Chosen on the H100 with
    ``python -m tpu_qsim_torch.kernels.tune_sweeps`` (PERF.md)."""

    threads: int = 512
    in_flight: int | None = None


# sweep.cu's wide instance (cores of TILE_CORE qubits and more) takes at most
# this many threads a CTA: its tiled op then has 128 registers a thread
WIDE_THREADS = 512
MAX_TILE_BITS = 14      # 1024 threads of 16 amplitudes
STAGE_WORDS = 8         # sweep.cu's descriptor per stage
HEADER_TILE_BITS = 5    # sweep table header word: T
STAGE_TILE, STAGE_UNIT = 0, 1


def sweep_tile_bits(geometry: SweepGeometry, max_core: int, kbits: int) -> int:
    """T, the tile bits of a sweep whose widest dense core is ``max_core``
    over a unit of ``kbits`` bits: 16 amplitudes a thread of the geometry's
    CTA (at most ``WIDE_THREADS`` for a table with a tiled core), no more
    than the unit. Raises ValueError for a tile the register program cannot
    hold (fewer than one warp's 2^9 slots, more than 2^MAX_TILE_BITS)."""
    from .gridsweeps import MIN_GRID_BLOCK_BITS, REG_BITS

    threads = geometry.threads if max_core < TILE_CORE else min(geometry.threads, WIDE_THREADS)
    bits = min(threads.bit_length() - 1 + REG_BITS, kbits)
    if threads & (threads - 1) or not MIN_GRID_BLOCK_BITS <= bits <= MAX_TILE_BITS:
        raise ValueError(
            f"a sweep tile holds 2^{MIN_GRID_BLOCK_BITS}..2^{MAX_TILE_BITS} slots "
            f"(16 a thread of a power of two of threads); {threads} threads over "
            f"a 2^{kbits}-slot unit give 2^{bits}"
        )
    return bits


def sweep_threads(geometry: SweepGeometry, max_core: int, kbits: int) -> int:
    """Threads per CTA of a sweep launch: 16 amplitudes of its tile each."""
    from .gridsweeps import REG_BITS

    return 1 << (sweep_tile_bits(geometry, max_core, kbits) - REG_BITS)


# (device, threads, wide, spare) -> CTAs of that kernel instance resident at once
_resident: dict[tuple, int] = {}


def resident_ctas(
    device: torch.device, threads: int, wide: bool, spare: bool = False,
) -> int:
    """How many CTAs of ``threads`` threads of the sweep kernel's instance
    for narrow cores (``wide`` False) or wide ones the card keeps resident at
    once (``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` x SMs), the most
    one cooperative sweep launch takes; with ``spare``, of the low wide
    instance whose CTAs may have more threads than a tile (the whole-circuit
    route). Each instance is counted at its own threads and shared memory.
    Asked once per process and instance."""
    from . import _build

    key = (torch.device(device), threads, bool(wide), bool(spare))
    if key not in _resident:
        lib = _build.library("sweep")
        ctas = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            err = lib.sweep_prepare(threads, int(wide), int(spare), ctypes.byref(ctas))
        _build.check("sweep", lib, err, "sweep_prepare")
        _resident[key] = ctas.value
    return _resident[key]


def launch_grid(
    layout: BlockLayout, geometry: SweepGeometry, max_core: int, resident: int,
) -> tuple[int, int]:
    """(groups, group_bits) of one sweep launch: ``groups`` units in
    flight, each owned by ``2^group_bits`` CTAs. A group takes no more CTAs
    than a unit has tiles (``sweep.cu`` deals a tile stage's tiles, and the
    tiled op's, to the group's CTAs in turn)."""
    if resident < 1:
        raise RuntimeError("the card cannot keep one sweep CTA resident")
    ctas = 1 << (resident.bit_length() - 1)     # a power of two
    units = 1 << len(layout.inactive)
    in_flight = geometry.in_flight
    if in_flight is None:
        in_flight = max(MIN_IN_FLIGHT, L2_BUDGET // (8 << layout.kbits))  # 2 float32 planes
    groups = max(1, min(in_flight, units, ctas))
    groups = 1 << (groups.bit_length() - 1)
    group_bits = (ctas // groups).bit_length() - 1
    tiles_bits = layout.kbits - sweep_tile_bits(geometry, max_core, layout.kbits)
    return groups, min(group_bits, tiles_bits)


@dataclass
class Stage:
    """A run of a sweep's ops that the kernel applies in one pass over the
    unit. ``kind`` "tile": ops whose moving bits, with state bits 0-4, lie in
    the tile's bits (``layout``, state bits; ``outside`` the unit's bits
    outside the tile); "unit": one dense core of ``TILE_CORE`` qubits or
    more, ``layout`` the sweep's unit."""

    kind: str
    gates: list[PGate]
    layout: BlockLayout
    outside: int = 0


def plan_stages(
    gates: list[PGate], unit: BlockLayout, tile_bits: int,
) -> list[Stage]:
    """Cut a sweep's ops, in order, into stages: a tile stage is a maximal run
    of ops whose moving bits, together with the lane bits 0-4, fit in
    ``tile_bits`` bits (diagonals, and controls on any bit, move nothing);
    a dense core of ``TILE_CORE`` qubits or more is a unit stage of its own.
    A tile stage's bits are those bits padded with the unit's lowest others."""
    from .gridsweeps import LANE_BITS as TILE_LANE_BITS

    unit_bits = [*range(unit.blk_bits), *unit.active]
    lanes = frozenset(range(TILE_LANE_BITS))
    stages: list[Stage] = []
    run: list[PGate] = []
    bits = set(lanes)

    def close() -> None:
        if run:
            stages.append(tile_stage(list(run), bits, unit, tile_bits))

    for g in gates:
        mv = moving_qubits(g.u, g.qubits)
        assert mv <= set(unit_bits), "the sweep planner keeps moving bits in the unit"
        if len(mv) >= TILE_CORE:
            close()
            run, bits = [], set(lanes)
            stages.append(Stage("unit", [g], unit))
            continue
        if len(bits | mv) > tile_bits:
            close()
            run, bits = [], set(lanes)
        run.append(g)
        bits |= mv
    close()
    return stages


def tile_stage(gates: list[PGate], bits, unit: BlockLayout, tile_bits: int) -> Stage:
    """A tile stage of ``gates`` whose moving bits (with the lane bits) are
    ``bits``: those bits padded with the unit's lowest others to
    ``tile_bits``."""
    unit_bits = [*range(unit.blk_bits), *unit.active]
    tile = set(bits)
    for q in unit_bits:
        if len(tile) >= tile_bits:
            break
        tile.add(q)
    blk = min(set(range(tile_bits + 1)) - tile)
    layout = BlockLayout(unit.n, blk, tuple(sorted(q for q in tile if q >= blk)))
    outside = sum(1 << q for q in unit_bits if q not in tile)
    return Stage("tile", gates, layout, outside)


def streaming_stages(stages: list[Stage], unit: BlockLayout, tile_bits: int) -> list[Stage]:
    """``stages`` with their ops removed, for the streaming-only measurement
    (``floor --sweeps``): each tile stage keeps its tiles and no op; a unit
    stage becomes a tile stage of no op, one pass over the unit as its tiled
    op makes. A launch of them at the sweep's instance keeps its passes, its
    tiles and the group barriers between stages."""
    from .gridsweeps import LANE_BITS as TILE_LANE_BITS

    return [Stage("tile", [], st.layout, st.outside) if st.kind == "tile"
            else tile_stage([], range(TILE_LANE_BITS), unit, tile_bits) for st in stages]


def sweep_table(stages: list[Stage], unit: BlockLayout, tile_bits: int) -> OpTable:
    """The sweep kernel's table: the unit's header (as ``build_op_table``
    writes it, with the stage count in word 0 and T in word
    ``HEADER_TILE_BITS``), a descriptor per stage (kind, offset of its table
    in int32 words, offset of its coefficients, the unit's bits outside the
    tile and their count), then each stage's table: a tile stage's
    ``register_table`` over its tile, a unit stage's ``build_op_table`` over
    the unit. Coefficients follow one another at even offsets (16-byte
    aligned, for the tiled op's 16-byte loads)."""
    from .gridsweeps import register_table

    head = build_op_table([], unit, max_bits=MAX_SWEEP_BITS).ints[:SWEEP_HEADER].copy()
    head[0] = len(stages)
    head[HEADER_TILE_BITS] = tile_bits
    desc = np.zeros((len(stages), STAGE_WORDS), dtype=np.int32)
    ints: list[np.ndarray] = [head, desc.reshape(-1)]
    coefs: list[np.ndarray] = []
    int_off, coef_off = SWEEP_HEADER + desc.size, 0
    flops, max_core = 0.0, 0
    for i, st in enumerate(stages):
        if st.kind == "tile":
            t = register_table(build_op_table(st.gates, st.layout), MAX_TILE_BITS)
            desc[i, :5] = (STAGE_TILE, int_off, coef_off, st.outside, bin(st.outside).count("1"))
        else:
            t = build_op_table(st.gates, unit, max_bits=MAX_SWEEP_BITS)
            desc[i, :3] = (STAGE_UNIT, int_off, coef_off)
        ints.append(t.ints)
        int_off += t.ints.size
        coefs.append(t.coef)
        coef_off += len(t.coef)
        if coef_off % 2:
            coefs.append(np.zeros((1, 2), np.float32))
            coef_off += 1
        flops += t.flops_per_amp
        max_core = max(max_core, t.max_core)
    head[HEADER_MAX_CORE] = max_core
    coef = np.concatenate(coefs) if coefs else np.zeros((1, 2), np.float32)
    return OpTable(np.concatenate(ints).astype(np.int32), np.ascontiguousarray(coef),
                   flops, max_core)


@dataclass
class SweepLaunch:
    """One launch of a sweep, in the plan's order. ``route`` "tile": a run
    of tile stages on the instance for narrow cores; "unit": one unit stage
    alone on the wide instance; "pass": one unit stage's gate through the
    dense pass (``dense_pass.DensePass``) over the whole state; "mixed": a
    whole sweep in one launch of the instance for its widest core (the plan
    before launches were split, which the measurements compare with).
    ``table`` is ``sweep.cu``'s (None for a pass), ``step`` the pass (None
    for the others)."""

    route: str
    stages: list[Stage]
    table: OpTable | None = None
    step: object | None = None

    @property
    def max_core(self) -> int:
        return self.table.max_core if self.table is not None else self.step.k


# A unit stage whose core (controls peeled) has this many qubits or more
# runs through the dense pass over the whole state, not the wide instance's
# tiled op: on the H100 the pass took 8.3803 / 15.0828 ms at k = 10 / 11 on
# a 26-qubit state against 10.0425 / 36.8317 for a low sweep holding the
# core alone, and tied at k = 9 (5.1486 against 5.0910; PERF.md)
MIN_SWEEP_PASS_CORE = 10


def plan_launches(
    stages: list[Stage], unit: BlockLayout, tile_bits: int, table: OpTable,
) -> list[SweepLaunch]:
    """Cut a sweep's stages (``table`` their :func:`sweep_table`), in order,
    into launches: a unit stage whose core has ``MIN_SWEEP_PASS_CORE``
    qubits or more is a dense pass, any other a launch of its own on the
    wide instance, and each run of tile stages between them one launch on
    the instance for narrow cores. (On the H100 a sweep with a unit stage ran
    split 8-16% faster than in one launch at 23-26 qubits and in a 22-qubit
    low sweep, also where its units in flight fit in L2, and as fast in a
    22-qubit high sweep, whose whole state fits there: PERF.md.)"""
    from .dense_pass import DensePass, pass_core

    out: list[SweepLaunch] = []
    run: list[Stage] = []

    def close() -> None:
        if run:
            whole = len(run) == len(stages)
            out.append(SweepLaunch("tile", list(run),
                                   table if whole else sweep_table(run, unit, tile_bits)))
            run.clear()

    for st in stages:
        if st.kind == "tile":
            run.append(st)
            continue
        close()
        (g,) = st.gates
        found = pass_core(g, MIN_SWEEP_PASS_CORE - 1)
        if found is not None:
            out.append(SweepLaunch("pass", [st], step=DensePass(g, unit.n, found)))
        else:
            out.append(SweepLaunch("unit", [st], sweep_table([st], unit, tile_bits)))
    close()
    return out


def _sweep(
    key: str,
    high: bool,
    state: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    layout: BlockLayout,
    geometry: SweepGeometry,
    max_core: int,
) -> torch.Tensor:
    from . import _build

    if check_kernel_inputs(state, ints, coef) != layout.n:
        raise ValueError(f"state must be (2, 2^{layout.n}) planes")
    if len(layout.active) > (MAX_ACTIVE_TOPS if high else 0):
        raise ValueError(f"{key} takes no block with active bits {layout.active}")
    if layout.kbits > MAX_SWEEP_BITS:
        raise ValueError(f"a block of 2^{layout.kbits} slots exceeds 2^{MAX_SWEEP_BITS}")
    lib = _build.library("sweep")
    threads = sweep_threads(geometry, max_core, layout.kbits)
    groups, group_bits = launch_grid(
        layout, geometry, max_core,
        resident_ctas(state.device, threads, max_core > NARROW_CORE),
    )
    barriers = torch.empty(groups, dtype=torch.int32, device=state.device)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.sweep_launch(
            int(high), state.data_ptr(), 1 << layout.n, ints.data_ptr(),
            coef.data_ptr(), layout.kbits, barriers.data_ptr(), groups,
            group_bits, threads, max_core, 0, stream,
        )
    _build.check("sweep", lib, err, f"{key} launch")
    LAUNCHES[key] += 1
    return state


def low_sweep(
    state: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    layout: BlockLayout,
    geometry: SweepGeometry = SweepGeometry(),
    max_core: int = MAX_DENSE_QUBITS,
) -> torch.Tensor:
    """Launch the low-sweep kernel on ``state`` (in place).

    ``ints``/``coef`` are the device copies of the sweep's
    :func:`sweep_table` over :func:`low_layout` for ``geometry`` (or of a
    launch's stages, :func:`plan_launches`), ``max_core`` its widest dense
    core (the kernel instance for narrow cores is launched when it is at most
    4). Launches on the current stream without synchronizing and raises on a
    refused launch.
    """
    return _sweep("low_sweep", False, state, ints, coef, layout, geometry, max_core)


def high_sweep(
    state: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    layout: BlockLayout,
    geometry: SweepGeometry = SweepGeometry(),
    max_core: int = MAX_DENSE_QUBITS,
) -> torch.Tensor:
    """Launch the high-sweep kernel on ``state`` (in place), as
    :func:`low_sweep` over a :func:`high_layout`."""
    return _sweep("high_sweep", True, state, ints, coef, layout, geometry, max_core)


def unit_stage(
    state: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    layout: BlockLayout,
    geometry: SweepGeometry = SweepGeometry(),
    max_core: int = MAX_DENSE_QUBITS,
    high: bool = False,
) -> torch.Tensor:
    """Launch the sweep kernel's wide instance on ``state`` (in place) for a
    table of one unit stage (a launch of route "unit"), over a
    :func:`low_layout` or, with ``high``, a :func:`high_layout`; counted
    apart, as ``LAUNCHES["unit_stage"]``."""
    return _sweep("unit_stage", high, state, ints, coef, layout, geometry, max_core)


class SweepProgram:
    """Planned sweep pipeline for one circuit.

    ``run`` maps (2, 2^n) float32 planes to planes: on a CUDA tensor it
    makes each sweep's launches (:attr:`launches`, :func:`plan_launches`)
    in order on the current stream, in place but for a dense pass, which
    writes a new state; on a CPU tensor it runs the plain version,
    :meth:`run_plain`. Each sweep's gates are the planner's, with same-qubit
    1q runs merged (:func:`merge_1q_chains`), cut into :attr:`stages`
    (:func:`plan_stages`) of :attr:`tile_bits` tiles, each launched at
    its sweep's :attr:`geometries` (the threads of its tiles). With
    ``_one_launch`` (for the measurements that compare with it) each sweep
    is one launch of its whole :attr:`tables` entry instead, every unit
    stage through the wide instance's tiled op.
    """

    def __init__(
        self,
        circuit: Circuit,
        params: SweepParams = SweepParams(),
        geometry: SweepGeometry = SweepGeometry(),
        *,
        _one_launch: bool = False,
    ):
        n = circuit.num_qubits
        if n <= params.blk_bits + params.k_bits:
            raise ValueError("n must exceed blk_bits + k_bits")
        self.num_qubits = n
        self.params = params
        self.geometry = geometry
        plan = plan_sweeps(circuit, n, params)
        self.sweep_kinds = [s.kind for s in plan]
        self.sweep_gates: list[list[PGate]] = [
            merge_1q_chains(as_pgates(s.gates)) for s in plan
        ]
        self.layouts = [
            low_layout(n, params) if s.kind == "low" else high_layout(s, n, params)
            for s in plan
        ]
        self.tile_bits: list[int] = []
        self.geometries: list[SweepGeometry] = []
        self.stages: list[list[Stage]] = []
        self.tables: list[OpTable] = []
        self.launches: list[list[SweepLaunch]] = []
        for gates, lay in zip(self.sweep_gates, self.layouts):
            widest = max((len(moving_qubits(g.u, g.qubits)) for g in gates), default=0)
            bits = sweep_tile_bits(geometry, widest, lay.kbits)
            # every launch of the sweep holds its tiles: a run of tile stages
            # too takes the threads of a sweep with a wide core
            geo = SweepGeometry(sweep_threads(geometry, widest, lay.kbits), geometry.in_flight)
            stages = plan_stages(gates, lay, bits)
            table = sweep_table(stages, lay, bits)
            launches = ([SweepLaunch("mixed", stages, table)] if _one_launch
                        else plan_launches(stages, lay, bits, table))
            for launch in launches:
                if launch.table is not None:
                    check_tile(launch.max_core, geo.threads)
            self.tile_bits.append(bits)
            self.geometries.append(geo)
            self.stages.append(stages)
            self.tables.append(table)
            self.launches.append(launches)
        self._device_tables: dict[torch.device, list] = {}

    @property
    def num_sweeps(self) -> int:
        return len(self.sweep_kinds)

    def _tables_on(self, device: torch.device) -> list:
        """Per sweep, the device copies (ints, coef) of each launch's table
        (None for a pass), made once per device."""
        tabs = self._device_tables.get(device)
        if tabs is None:
            tabs = [[None if ln.table is None else
                     (torch.from_numpy(ln.table.ints).to(device),
                      torch.from_numpy(ln.table.coef).to(device))
                     for ln in launches] for launches in self.launches]
            self._device_tables[device] = tabs
        return tabs

    def launch_table(self, state: torch.Tensor, i: int, tables: tuple,
                     max_core: int, route: str) -> torch.Tensor:
        """Launch sweep ``i``'s kernel on the CUDA ``state`` (in place) with
        the device ``tables`` (ints, coef) of a launch of ``route`` "tile",
        "unit" or "mixed" (its wrapper and count), the instance for
        ``max_core``."""
        high = self.sweep_kinds[i] == "high"
        ints, coef = tables
        geo = self.geometries[i]
        if route == "unit":
            return unit_stage(state, ints, coef, self.layouts[i], geo, max_core, high)
        fn = high_sweep if high else low_sweep
        return fn(state, ints, coef, self.layouts[i], geo, max_core)

    def launch_one(self, state: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """Launch ``j`` of sweep ``i`` on the CUDA ``state``: in place, or for
        a pass a new state, which it returns."""
        launch = self.launches[i][j]
        if launch.route == "pass":
            return launch.step.run(state)
        tables = self._tables_on(state.device)[i][j]
        return self.launch_table(state, i, tables, launch.max_core, launch.route)

    def launch(self, state: torch.Tensor, i: int) -> torch.Tensor:
        """Sweep ``i``'s launches on the CUDA ``state``; returns the state
        they leave (``state`` itself unless one is a dense pass)."""
        for j in range(len(self.launches[i])):
            state = self.launch_one(state, i, j)
        return state

    def run(self, state: torch.Tensor) -> torch.Tensor:
        check_planes(state, self.num_qubits, "sweep")
        if state.device.type == "cpu":
            return self.run_plain(state)
        if state.device.type != "cuda":
            raise ValueError(f"no sweep kernel for device {state.device}")
        state = state.contiguous()
        for i in range(self.num_sweeps):
            state = self.launch(state, i)
        return state

    __call__ = run

    def run_plain(self, state: torch.Tensor) -> torch.Tensor:
        """The plain version: each sweep through :meth:`step_plain`."""
        check_planes(state, self.num_qubits, "sweep")
        for i in range(self.num_sweeps):
            state = self.step_plain(state, i)
        return state

    def step_plain(self, state: torch.Tensor, i: int) -> torch.Tensor:
        """Sweep ``i``'s plain version: its gates through the torch engine,
        in the order the kernel applies them."""
        return apply_pgates(state, self.sweep_gates[i])

    def launch_plain(self, state: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """Launch ``j`` of sweep ``i``'s plain version: its stages' gates
        through the torch engine."""
        return apply_pgates(state, [g for st in self.launches[i][j].stages for g in st.gates])

    def flops(self) -> float:
        """Real flops one run needs (from the op tables)."""
        return float(sum(t.flops_per_amp for t in self.tables)) * (1 << self.num_qubits)

    def bytes_moved(self) -> int:
        """Device-memory bytes one run must move: each sweep reads and writes
        both float32 planes once."""
        return self.num_sweeps * 2 * 2 * 4 * (1 << self.num_qubits)


def build_sweep_run(
    circuit: Circuit,
    rdtype=np.float32,
    *,
    params: SweepParams | None = None,
    device=None,
) -> SweepProgram:
    """Plan ``circuit`` into the sweep pipeline, with its op tables on
    ``device`` (None: the card, which must be present)."""
    n = circuit.num_qubits
    if np.dtype(rdtype) != np.float32:
        raise ValueError("the sweep path is float32-only")
    if params is None:
        if not (MIN_SWEEP_QUBITS <= n <= MAX_SWEEP_QUBITS):
            raise ValueError(
                f"sweep path expects {MIN_SWEEP_QUBITS} <= n <= "
                f"{MAX_SWEEP_QUBITS}, got {n}"
            )
        params = SweepParams()
    device = ap.resolve_device(device)
    prog = SweepProgram(circuit, params)
    if device.type == "cuda":
        prog._tables_on(device)
    return prog
