"""Active-bit grid sweep executor on the CUDA card.

The port of ``tpu_qsim/kernels/gridsweeps.py``. A sweep is a set of at most
``a_max`` *active* high bits (any bits >= ``blk_bits``) plus gates whose
moving qubits lie in ``[0, blk_bits) | active``. One launch of the
hand-written kernel ``csrc/grid_sweep.cu`` runs one sweep: a CTA takes the
block bits and the active bits of one assignment of the inactive bits, in
its threads' registers (:func:`register_table` plans which block bits are
register bits for each run of ops, and where shared memory takes over),
applies the sweep's gates and writes back in place, so the whole state
crosses device memory once per sweep, not once per gate.

The planner (``plan_grid_sweeps``, ``_two_sweep_partition``,
``_improve_plan``) is a copy of the JAX package's planner and gives the same
plans gate by gate; as there, its frontier scheduling runs in the native
library (:mod:`tpu_qsim_torch.native`), with the Python loop
(``_frontier_sweeps_python``) kept as its plain version. The TPU geometry
(``rb_bits`` rows of 128 lanes, ``default_geometry``/``geometry_candidates``
per-size tables, the per-kernel gate cap set by Mosaic compile time) does
not carry over: ``GridParams`` takes ``blk_bits`` and ``a_max`` directly,
and the table-driven kernel compiles once, so a sweep has no gate cap.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import native
from ..circuit import Circuit
from ..gates import gate_matrix
from . import LAUNCHES
from .fused_circuit import (
    KIND_DIAG,
    MAX_DENSE_QUBITS,
    OP_HEADER,
    SWEEP_HEADER,
    TILE_CORE,
    BlockLayout,
    OpTable,
    PGate,
    _SWAP_U,
    apply_pgates,
    as_pgates,
    build_op_table,
    check_kernel_inputs,
    check_tile,
    check_planes,
    merge_1q_chains,
)
from .sweeps import MAX_SWEEP_GATES, moving_qubits

# H100 geometry, chosen on the card with kernels/tune_grid.py at 22, 24, 28
# and 30 qubits (PERF.md): 2^7-amplitude contiguous runs plus 5 active bits,
# a block of 2^12 amplitudes (32 KB, and 32 KB for the next block's
# prefetch), so 256 threads per CTA with 16 amplitudes each in registers.
BLK_BITS = 7
A_MAX = 5
# ... and for a circuit with a dense core of TILE_CORE qubits or more: the
# tiled op reuses the core over more groups in a 2^13 block of 512 threads
# (a 26q grid sweep with one 8-qubit op: 5.7 ms at blk8/a5, 9.0 at blk7/a5)
WIDE_BLK_BITS = 8
NO_GATE_CAP = 1 << 30

# The register design of csrc/grid_sweep.cu (keep in step): block bits 0-4
# index a warp's lanes; a thread holds 2^REG_BITS amplitudes, so a block of
# 2^k slots takes 2^(k - REG_BITS) threads; the header holds REG_BITS and the
# first run's register bits; REMAP ops name the register bits of the next run.
LANE_BITS = 5
REG_BITS = 4
MIN_GRID_BLOCK_BITS = LANE_BITS + REG_BITS    # one warp
MAX_GRID_BLOCK_BITS = 13                      # 512 threads
HEADER_REG_BITS = 5
HEADER_REGS = 8
KIND_REMAP = 2
REG_CORE = 1          # widest dense core that runs in registers
# after the ops, 8 int32 per op, which is what the kernel reads of it in two
# 16-byte loads: flags, coefficient offset, block-local control mask and
# value, out-of-block control mask and value, target (register position or
# lane bit), and a diagonal's qubits (m | q0 << 8 | q1 << 16). Flags: the op
# runs in registers (D_REG) or is a remap; a register op is a diagonal (of
# more than 2 qubits: D_WIDE_DIAG, read from the op's words) or a 1-qubit
# core on a lane bit (D_LANE) or a register bit, an X core (D_SWAP) a swap.
DESC_WORDS = 8
D_REG, D_REMAP, D_DIAG, D_SWAP, D_LANE, D_WIDE_DIAG = 1, 2, 4, 8, 16, 32


@dataclass(frozen=True)
class GridParams:
    """Engine geometry: block-local low bits and the active-bit budget.
    A sweep's block of ``2^k`` slots runs on ``block_threads(k)`` threads."""

    blk_bits: int = BLK_BITS
    a_max: int = A_MAX


@dataclass
class GridSweep:
    active: set = field(default_factory=set)   # moving state bits >= blk
    gates: list[PGate] = field(default_factory=list)


def _two_sweep_partition(
    gates: list[PGate],
    mv_cache: list[frozenset],
    a_max: int,
    max_gates: int,
    balance: bool = True,
) -> list[GridSweep] | None:
    """Exact 2-sweep planning by active-set partition enumeration.

    The greedy frontier packer fills a sweep's active budget on a
    first-ready basis, which can cost a whole extra full-state sweep vs
    the attainable lower bound ceil(|used bits| / a_max). Enumerates every
    split of the used high bits into two <= a_max halves (C(|used|, size1)
    candidates, capped) and checks order feasibility with a linear drain
    over the precomputed commutation DAG. Returns the feasible plan
    minimizing the larger sweep, or None.
    """
    from itertools import combinations
    from math import comb

    from ..commute import dependency_edges

    used = sorted(set().union(*mv_cache)) if mv_cache else []
    u = len(used)
    ng = len(gates)
    if u <= a_max or u > 2 * a_max or ng > 2 * max_gates:
        return None
    n_parts = sum(comb(u, s1) for s1 in range(u - a_max, a_max + 1))
    if n_parts * ng > 4_000_000:
        return None

    preds = dependency_edges(gates)
    half = (ng + 1) // 2

    def plan_for(s1: frozenset, s2: frozenset) -> tuple | None:
        """Minimal sweep-1 = transitive predecessor closure of the
        S1-colored gates, then fill with other S1-placeable gates. Program
        order is a valid order within each sweep (dependency edges only
        point backward)."""
        need = [False] * ng           # must be in sweep 1
        can1 = [False] * ng           # may be in sweep 1
        for i, mv in enumerate(mv_cache):
            if mv and not (mv <= s1 or mv <= s2):
                return None           # moving set straddles the partition
            need[i] = bool(mv) and mv <= s1
            can1[i] = mv <= s1 and all(can1[p] for p in preds[i])
        for i in range(ng - 1, -1, -1):
            if need[i]:
                if not can1[i]:
                    return None       # an S1 gate depends on an S2 gate
                for p in preds[i]:
                    need[p] = True
        m = sum(need)
        if m > max_gates:
            return None
        # balance=True fills sweep 1 to ~half; balance=False max-fills it
        fill = half if balance else max_gates
        target = min(max(m, fill, ng - max_gates), max_gates)
        sel = list(need)
        size1 = m
        for i in range(ng):
            if size1 >= target:
                break
            if not sel[i] and can1[i] and all(sel[p] for p in preds[i]):
                sel[i] = True
                size1 += 1
        if ng - size1 > max_gates:
            return None
        return (
            [i for i in range(ng) if sel[i]],
            [i for i in range(ng) if not sel[i]],
        )

    best = None
    for size1 in range(u - a_max, a_max + 1):
        for c in combinations(used, size1):
            s1 = frozenset(c)
            r = plan_for(s1, frozenset(used) - s1)
            if r is None:
                continue
            score = max(len(o) for o in r)
            if best is None or score < best[0]:
                best = (score, r)
    if best is None:
        return None
    sweeps = []
    for order in best[1]:
        s = GridSweep()
        for i in order:
            s.gates.append(gates[i])
            s.active |= mv_cache[i]
        sweeps.append(s)
    return sweeps


def default_params(gates: list[PGate]) -> GridParams:
    """The card's geometry for a sweep program over ``gates``:
    :data:`BLK_BITS`, or :data:`WIDE_BLK_BITS` where a dense core has
    ``TILE_CORE`` qubits or more."""
    widest = max((len(moving_qubits(g.u, g.qubits)) for g in gates), default=0)
    return GridParams(WIDE_BLK_BITS if widest >= TILE_CORE else BLK_BITS)


def high_moving(g: PGate, params: GridParams) -> int:
    """How many high qubits (at or above ``params.blk_bits``) ``g`` moves."""
    return sum(q >= params.blk_bits for q in moving_qubits(g.u, g.qubits))


def _is_swap(g: PGate) -> bool:
    return g.u.shape[0] == 4 and not np.any(g.u - _SWAP_U)


def refuses(g: PGate, n: int, params: GridParams | None = None) -> bool:
    """Whether the grid planner refuses ``g`` in an n-qubit circuit: it moves
    more high qubits than a sweep's active budget (``params.a_max``, at most
    the ``n - blk_bits`` high bits there are), and it is no SWAP (which the
    planner runs as 3 CNOTs). ``params`` None: the geometry that
    :class:`GridSweepProgram` picks for a circuit holding ``g``
    (:func:`default_params`)."""
    if params is None:
        params = default_params([g])
    a_max = min(params.a_max, n - params.blk_bits)
    return not _is_swap(g) and high_moving(g, params) > a_max


def plan_grid_sweeps(
    circuit,
    n: int | None = None,
    params: GridParams = GridParams(),
    max_gates: int = MAX_SWEEP_GATES,
    partition: bool = True,
    balance: bool = True,
) -> list[GridSweep]:
    """Partition the circuit into active-bit sweeps via frontier scheduling.

    ``circuit`` is a :class:`~tpu_qsim_torch.circuit.Circuit` or any gate
    list :func:`~tpu_qsim_torch.kernels.fused_circuit.as_pgates` accepts. A
    gate fits a sweep iff its moving qubits >= blk_bits fit the sweep's
    active budget. Diagonal/controlled structure along high bits costs
    nothing (the kernel reads those bits from the global index), so e.g. a
    CZ or a control anywhere always rides the current sweep. A gate that
    fits no sweep (:func:`refuses`) raises a ValueError. The frontier
    scheduling runs in the native library
    (``native/fusion.cpp::qsim_plan_grid_sweeps``).
    """
    if isinstance(circuit, Circuit):
        raw, n = circuit.gates, circuit.num_qubits if n is None else n
    else:
        raw = list(circuit)
        if n is None:
            raise ValueError("n is required for a raw gate list")
    if max_gates < 1:
        # a fresh sweep must absorb >= 1 ready gate for the frontier loop
        # to make progress; 0 would spin forever
        raise ValueError(f"max_gates must be >= 1, got {max_gates}")
    if n > native.MAX_MASK_QUBITS:
        raise ValueError(
            f"the grid planner's masks hold {native.MAX_MASK_QUBITS} qubits, got {n}"
        )
    high = frozenset(range(params.blk_bits, n))
    a_max = min(params.a_max, n - params.blk_bits)

    _cnot = None
    gates: list[PGate] = []
    for g in as_pgates(raw):
        if refuses(g, n, params):
            raise ValueError(
                f"gate on {g.qubits} moves {high_moving(g, params)} high "
                f"qubits; the grid engine stacks at most {a_max}"
            )
        if _is_swap(g) and high_moving(g, params) > a_max:
            if _cnot is None:
                _cnot = gate_matrix("cnot").astype(np.complex128)
            a, b = g.qubits
            gates += as_pgates([(_cnot, (a, b)), (_cnot, (b, a)), (_cnot, (a, b))])
            continue
        gates.append(g)

    # fold same-qubit 1q runs BEFORE sweep planning: fewer gates to place
    # and fewer ops per sweep
    gates = merge_1q_chains(gates)

    mv_cache = [moving_qubits(g.u, g.qubits) & high for g in gates]

    sweeps = []
    for members in _frontier_sweeps(gates, mv_cache, a_max, max_gates):
        s = GridSweep()
        for i in members:
            s.gates.append(gates[i])
            s.active |= mv_cache[i]
        sweeps.append(s)
    return _improve_plan(
        sweeps, gates, mv_cache, a_max, max_gates, partition, balance
    )


def _frontier_sweeps(
    gates: list[PGate], mv_cache: list[frozenset], a_max: int, max_gates: int
) -> list[list[int]]:
    """Gate indices of each sweep, in emission order, from the native
    frontier scheduler: matrix-free, on each gate's qubits, commutation
    classes and moving-qubit mask."""
    return native.plan_grid_sweeps_native(
        [g.qubits for g in gates],
        [g.classes for g in gates],
        [sum(1 << q for q in mv) for mv in mv_cache],
        a_max,
        max_gates,
    )


def _frontier_sweeps_python(
    gates: list[PGate], mv_cache: list[frozenset], a_max: int, max_gates: int
) -> list[list[int]]:
    """The plain version of :func:`_frontier_sweeps`, which the tests hold
    the native scheduler against: each pass takes the lowest ready gate
    that fits the sweep's gate count and active bits, and a sweep closes
    when no ready gate fits."""
    from ..commute import FrontierScheduler

    sched = FrontierScheduler(gates)
    sweeps: list[list[int]] = []
    cur: list[int] = []
    active: frozenset = frozenset()
    while not sched.done():
        progressed = True
        while progressed:
            progressed = False
            for i in sched.ready():
                if len(cur) < max_gates and len(active | mv_cache[i]) <= a_max:
                    sched.emit(i)
                    cur.append(i)
                    active |= mv_cache[i]
                    progressed = True
                    break
        if sched.done():
            break
        # a fresh sweep always absorbs at least one ready gate (every gate
        # passed plan_grid_sweeps' per-gate a_max validation)
        sweeps.append(cur)
        cur, active = [], frozenset()
    if cur:
        sweeps.append(cur)
    return sweeps


def _improve_plan(
    sweeps: list[GridSweep],
    gates: list[PGate],
    mv_cache: list[frozenset],
    a_max: int,
    max_gates: int,
    partition: bool = True,
    balance: bool = True,
) -> list[GridSweep]:
    """Post-pass on a frontier plan: when the greedy packer used more
    sweeps than the active-bit lower bound and that bound is 2, replace
    the plan with an enumerated 2-sweep partition (see
    :func:`_two_sweep_partition`)."""
    if not partition:
        return sweeps
    used = set().union(*mv_cache) if mv_cache else set()
    bound = -(-len(used) // a_max) if used and a_max else 1
    if len(sweeps) > bound == 2:
        alt = _two_sweep_partition(gates, mv_cache, a_max, max_gates, balance)
        if alt is not None:
            return alt
    return sweeps


def _pad_active(sweep: GridSweep, n: int, blk: int, a_max: int) -> tuple:
    """The sweep's active bits padded to ``a_max`` with the lowest free high
    bits: a larger block halves the CTA count at no extra bytes. (The TPU
    planner scored which bits to pad with by Mosaic op costs; here an
    out-of-block control is a CTA-uniform test and costs nothing.)"""
    active = set(sweep.active)
    for p in range(blk, n):
        if len(active) >= a_max:
            break
        active.add(p)
    return tuple(sorted(active))


def block_threads(kbits: int, max_bits: int = MAX_GRID_BLOCK_BITS) -> int:
    """Threads per CTA of a block of ``2^kbits`` slots, ``2^REG_BITS`` each.
    Raises ValueError for a block the register design cannot hold (in the
    grid-sweep kernel, or up to ``2^max_bits`` slots in the caller's)."""
    if not MIN_GRID_BLOCK_BITS <= kbits <= max_bits:
        raise ValueError(
            f"the register program holds blocks of 2^{MIN_GRID_BLOCK_BITS}.."
            f"2^{max_bits} amplitudes, got 2^{kbits}"
        )
    return 1 << (kbits - REG_BITS)


def register_table(table: OpTable, max_bits: int = MAX_GRID_BLOCK_BITS) -> OpTable:
    """The grid-sweep kernel's table: ``table`` with the register remaps
    written in, and after the ops a descriptor per op (:func:`_descriptor`)
    that says where and how it runs.

    A diagonal op, and a dense core of ``REG_CORE`` qubit, runs in
    registers; a core needs its target, if above the lane bits, to be a
    register bit. Where the current register bits lack one, a REMAP op before it takes new
    ones: the targets of the next register ops in order (up to the next
    shared-memory op) while they fit in ``REG_BITS``, then the current bits, then
    the lowest others. After a shared-memory op the amplitudes are reloaded
    anyway, so the bits are chosen anew there at no cost. ``max_bits``: the
    largest block of the kernel that reads the table (the sweep kernel's
    tiles reach 2^14 slots).
    """
    ints = table.ints
    head = ints[:SWEEP_HEADER].copy()
    kbits = int(head[1]) + int(head[2])
    block_threads(kbits, max_bits)    # refuses a block outside the register design
    r = REG_BITS
    ops = ints[SWEEP_HEADER:].reshape(-1, OP_HEADER)
    needs: list[frozenset | None] = []
    for op in ops:
        m = int(op[1])
        if op[0] == KIND_DIAG:
            needs.append(frozenset())
        elif m <= REG_CORE:
            needs.append(frozenset(int(c) for c in op[8:8 + m] if c >= LANE_BITS))
        else:
            needs.append(None)

    def choose(i: int, cur: list[int]) -> list[int]:
        out: list[int] = []
        for nd in needs[i:]:
            if nd is None or len(out) == r:
                break
            new = sorted(nd - set(out))
            if len(out) + len(new) <= r:
                out += new
        for b in [*cur, *range(LANE_BITS, kbits)]:
            if len(out) == r:
                break
            if b not in out:
                out.append(b)
        return sorted(out)

    regs = choose(0, [])
    head[HEADER_REG_BITS] = r
    head[HEADER_REGS:HEADER_REGS + r] = regs
    out, desc = [], []
    in_smem = False
    for i, (op, nd) in enumerate(zip(ops, needs)):
        if nd is not None and (in_smem or not nd <= set(regs)):
            new = choose(i, regs)
            if new != regs:
                remap = np.zeros(OP_HEADER, dtype=np.int32)
                remap[0] = KIND_REMAP
                remap[1] = r
                remap[8:8 + r] = new
                out.append(remap)
                desc.append(_descriptor(remap, None, table.coef))
                regs = new
        in_smem = nd is None
        out.append(op)
        desc.append(_descriptor(op, None if in_smem else regs, table.coef))
    head[0] = len(out)
    body = np.stack(out).reshape(-1) if out else np.zeros(0, np.int32)
    flat = np.stack(desc).reshape(-1) if desc else body
    return OpTable(np.concatenate([head, body, flat]).astype(np.int32), table.coef,
                   table.flops_per_amp, table.max_core)


def _descriptor(op: np.ndarray, regs: list[int] | None, coef: np.ndarray) -> np.ndarray:
    """An op's descriptor (``DESC_WORDS``); ``regs``: the register bits of
    the run it belongs to, None for an op in shared memory."""
    d = np.zeros(DESC_WORDS, dtype=np.int32)
    if op[0] == KIND_REMAP:
        d[0] = D_REMAP
        return d
    d[1:6] = op[2:7]
    if regs is None:
        return d
    d[0] = D_REG
    m = int(op[1])
    if op[0] == KIND_DIAG:
        d[0] |= D_DIAG | (D_WIDE_DIAG if m > 2 else 0)
        if m <= 2:
            d[7] = m | int(op[8]) << 8 | int(op[8 + m - 1]) << 16
        return d
    code = int(op[8])
    core = coef[int(op[2]):int(op[2]) + 4]
    if np.array_equal(core, [[0, 0], [1, 0], [1, 0], [0, 0]]):
        d[0] |= D_SWAP
    if code < LANE_BITS:
        d[0] |= D_LANE
        d[6] = code
    else:
        d[6] = regs.index(code)
    return d


def grid_sweep(
    state: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    layout: BlockLayout,
    max_core: int = MAX_DENSE_QUBITS,
) -> torch.Tensor:
    """Launch the CUDA kernel for one sweep on ``state`` (in place).

    ``ints``/``coef`` are the device copies of the sweep's
    :func:`register_table`, ``max_core`` its widest dense core (the kernel
    instance for narrow cores is launched when it is at most 4); a CTA has
    ``block_threads(layout.kbits)`` threads. Launches on the current stream
    without synchronizing and raises on a refused launch.
    """
    from . import _build

    if check_kernel_inputs(state, ints, coef) != layout.n:
        raise ValueError(f"state must be (2, 2^{layout.n}) planes")
    dim = 1 << layout.n
    lib = _build.library("grid_sweep")
    kbits = layout.kbits
    steps = 1 << len(layout.inactive)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.grid_sweep_launch(
            state.data_ptr(), dim, ints.data_ptr(), coef.data_ptr(), kbits,
            steps, max_core, stream,
        )
    _build.check("grid_sweep", lib, err, "grid_sweep launch")
    LAUNCHES["grid_sweep"] += 1
    return state


class GridSweepProgram:
    """Planned grid-sweep pipeline for one circuit.

    ``run`` maps (2, 2^n) float32 planes to planes: on a CUDA tensor it
    launches the kernel once per sweep, in place; on a CPU tensor it runs
    the plain version, :meth:`run_plain`. ``params`` None takes the card's
    geometry: :data:`BLK_BITS` and :data:`A_MAX`, or :data:`WIDE_BLK_BITS`
    for a circuit with a dense core of ``TILE_CORE`` qubits or more.
    ``plan``, as in the JAX package, runs the given sweeps instead of the
    planner's (the circuit then gives only the qubit count); a sweep with
    no gates only streams the state.
    """

    def __init__(
        self,
        circuit: Circuit,
        params: GridParams | None = None,
        max_gates: int = NO_GATE_CAP,
        plan: list[GridSweep] | None = None,
    ):
        n = circuit.num_qubits
        if params is None:
            params = default_params(
                as_pgates(circuit.gates) if plan is None else [g for s in plan for g in s.gates])
        if n <= params.blk_bits:
            raise ValueError(f"n must exceed blk_bits={params.blk_bits}")
        self.num_qubits = n
        self.params = params
        a_max = min(params.a_max, n - params.blk_bits)
        if plan is None:
            plan = plan_grid_sweeps(circuit, n, params, max_gates)
        for s in plan:
            if len(s.active) > a_max or not set(s.active) <= set(range(params.blk_bits, n)):
                raise ValueError(
                    f"a sweep's active bits {sorted(s.active)} must be at most "
                    f"{a_max} of the high bits {params.blk_bits}..{n - 1}"
                )
        self.num_sweeps = len(plan)
        self.active_sets = [sorted(s.active) for s in plan]
        self.sweep_gates = [list(s.gates) for s in plan]
        self.layouts = [
            BlockLayout(n, params.blk_bits, _pad_active(s, n, params.blk_bits, a_max))
            for s in plan
        ]
        self.tables: list[OpTable] = []
        for s, lay in zip(plan, self.layouts):
            table = build_op_table(s.gates, lay)
            check_tile(table.max_core, block_threads(lay.kbits))
            self.tables.append(register_table(table))
        self._device_tables: dict[torch.device, list] = {}

    def _tables_on(self, device: torch.device) -> list:
        tabs = self._device_tables.get(device)
        if tabs is None:
            tabs = [
                (torch.from_numpy(t.ints).to(device),
                 torch.from_numpy(t.coef).to(device))
                for t in self.tables
            ]
            self._device_tables[device] = tabs
        return tabs

    def run(self, state: torch.Tensor) -> torch.Tensor:
        check_planes(state, self.num_qubits, "grid sweep")
        if state.device.type == "cpu":
            return self.run_plain(state)
        if state.device.type != "cuda":
            raise ValueError(f"no grid-sweep kernel for device {state.device}")
        state = state.contiguous()
        for (ints, coef), lay, table in zip(
            self._tables_on(state.device), self.layouts, self.tables
        ):
            grid_sweep(state, ints, coef, lay, table.max_core)
        return state

    __call__ = run

    def run_plain(self, state: torch.Tensor) -> torch.Tensor:
        """The plain version: each sweep's gate list through the torch
        engine, in the order the kernel applies it."""
        check_planes(state, self.num_qubits, "grid sweep")
        for gates in self.sweep_gates:
            state = apply_pgates(state, gates)
        return state

    def flops(self) -> float:
        """Real flops one run needs (from the op tables)."""
        return float(sum(t.flops_per_amp for t in self.tables)) * (1 << self.num_qubits)

    def bytes_moved(self) -> int:
        """Device-memory bytes one run must move: each sweep reads and writes
        both float32 planes once."""
        return self.num_sweeps * 2 * 2 * 4 * (1 << self.num_qubits)
