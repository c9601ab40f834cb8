"""Active-bit grid sweep executor on the CUDA card.

The port of ``tpu_qsim/kernels/gridsweeps.py``. A sweep is a set of at most
``a_max`` *active* high bits (any bits >= ``blk_bits``) plus gates whose
moving qubits lie in ``[0, blk_bits) | active``. One launch of the
hand-written kernel ``csrc/grid_sweep.cu`` runs one sweep: each CTA holds the
block bits and the active bits of one assignment of the inactive bits in
shared memory, applies the sweep's gates there and writes back in place, so
the whole state crosses device memory once per sweep, not once per gate.

The planner (``plan_grid_sweeps``, ``_two_sweep_partition``,
``_improve_plan``) is a copy of the JAX package's pure-Python planner and
gives the same plans gate by gate. The TPU geometry (``rb_bits`` rows of 128
lanes, ``default_geometry``/``geometry_candidates`` per-size tables, the
per-kernel gate cap set by Mosaic compile time) does not carry over:
``GridParams`` takes ``blk_bits`` and ``a_max`` directly, and the table-driven
kernel compiles once, so a sweep has no gate cap.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import apply as ap
from ..circuit import Circuit
from ..gates import gate_matrix
from . import LAUNCHES
from .fused_circuit import (
    BlockLayout,
    OpTable,
    PGate,
    _SWAP_U,
    _is_diagonal,
    as_pgates,
    build_op_table,
    merge_1q_chains,
)
from .sweeps import MAX_SWEEP_GATES, moving_qubits

# H100 geometry, chosen on the card with kernels/tune_grid.py (PERF.md):
# 2^8-amplitude contiguous runs plus 5 active bits, a block of 2^13
# amplitudes = 64 KB of shared memory, 512 threads per CTA.
BLK_BITS = 8
A_MAX = 5
THREADS = 512
NO_GATE_CAP = 1 << 30


@dataclass(frozen=True)
class GridParams:
    """Engine geometry: block-local low bits, the active-bit budget, and
    threads per CTA (the kernel caps a CTA at 1024)."""

    blk_bits: int = BLK_BITS
    a_max: int = A_MAX
    threads: int = THREADS


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
    CZ or a control anywhere always rides the current sweep.
    """
    from ..commute import FrontierScheduler

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
    high = frozenset(range(params.blk_bits, n))
    a_max = min(params.a_max, n - params.blk_bits)

    _cnot = None
    gates: list[PGate] = []
    for g in as_pgates(raw):
        mv = moving_qubits(g.u, g.qubits)
        if len(mv & high) > a_max:
            if g.u.shape[0] == 4 and not np.any(g.u - _SWAP_U):
                if _cnot is None:
                    _cnot = gate_matrix("cnot").astype(np.complex128)
                a, b = g.qubits
                gates += as_pgates(
                    [(_cnot, (a, b)), (_cnot, (b, a)), (_cnot, (a, b))]
                )
                continue
            raise ValueError(
                f"gate on {g.qubits} moves {len(mv & high)} high "
                f"qubits; the grid engine stacks at most {a_max}"
            )
        gates.append(g)

    # fold same-qubit 1q runs BEFORE sweep planning: fewer gates to place
    # and fewer ops per sweep
    gates = merge_1q_chains(gates)

    mv_cache = [moving_qubits(g.u, g.qubits) & high for g in gates]

    sched = FrontierScheduler(gates)
    sweeps: list[GridSweep] = []
    cur = GridSweep()
    while not sched.done():
        progressed = True
        while progressed:
            progressed = False
            for i in sched.ready():
                if (
                    len(cur.gates) < max_gates
                    and len(cur.active | mv_cache[i]) <= a_max
                ):
                    sched.emit(i)
                    cur.gates.append(gates[i])
                    cur.active |= mv_cache[i]
                    progressed = True
                    break
        if sched.done():
            break
        # a fresh sweep always absorbs at least one ready gate (every gate
        # passed the per-gate a_max validation above)
        sweeps.append(cur)
        cur = GridSweep()
    if cur.gates:
        sweeps.append(cur)
    return _improve_plan(
        sweeps, gates, mv_cache, a_max, max_gates, partition, balance
    )


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


def grid_sweep(
    state: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    layout: BlockLayout,
    threads: int = THREADS,
) -> torch.Tensor:
    """Launch the CUDA kernel for one sweep on ``state`` (in place).

    ``ints``/``coef`` are the device copies of the sweep's
    :class:`~tpu_qsim_torch.kernels.fused_circuit.OpTable`. Launches on the
    current stream without synchronizing and raises on a refused launch.
    """
    from ._build import grid_sweep_library

    dim = 1 << layout.n
    if not state.is_cuda or state.dtype != torch.float32:
        raise ValueError("grid_sweep takes a float32 CUDA state")
    if tuple(state.shape) != (2, dim) or not state.is_contiguous():
        raise ValueError(f"state must be a contiguous (2, {dim}) tensor")
    for t, dt in ((ints, torch.int32), (coef, torch.float32)):
        if t.device != state.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("op tables must be contiguous, typed, on the state's device")
    lib = grid_sweep_library()
    kbits = layout.kbits
    steps = 1 << len(layout.inactive)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.grid_sweep_launch(
            state.data_ptr(), dim, ints.data_ptr(), coef.data_ptr(), kbits,
            steps, min(threads, 1 << kbits), stream,
        )
    if err != 0:
        msg = lib.grid_sweep_error_string(err).decode()
        raise RuntimeError(f"grid_sweep launch failed: {msg} ({err})")
    LAUNCHES["grid_sweep"] += 1
    return state


class GridSweepProgram:
    """Planned grid-sweep pipeline for one circuit.

    ``run`` maps (2, 2^n) float32 planes to planes: on a CUDA tensor it
    launches the kernel once per sweep, in place; on a CPU tensor it runs
    the plain version, :meth:`run_plain`.
    """

    def __init__(
        self,
        circuit: Circuit,
        params: GridParams = GridParams(),
        max_gates: int = NO_GATE_CAP,
    ):
        n = circuit.num_qubits
        if n <= params.blk_bits:
            raise ValueError(f"n must exceed blk_bits={params.blk_bits}")
        if not 1 <= params.threads <= 1024:
            raise ValueError(f"threads must be in [1, 1024], got {params.threads}")
        self.num_qubits = n
        self.params = params
        plan = plan_grid_sweeps(circuit, n, params, max_gates)
        self.num_sweeps = len(plan)
        self.active_sets = [sorted(s.active) for s in plan]
        self.sweep_gates = [list(s.gates) for s in plan]
        a_max = min(params.a_max, n - params.blk_bits)
        self.layouts = [
            BlockLayout(n, params.blk_bits, _pad_active(s, n, params.blk_bits, a_max))
            for s in plan
        ]
        self.tables: list[OpTable] = [
            build_op_table(s.gates, lay) for s, lay in zip(plan, self.layouts)
        ]
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

    def _check(self, state: torch.Tensor) -> None:
        if tuple(state.shape) != (2, 1 << self.num_qubits):
            raise ValueError(
                f"state shape {tuple(state.shape)} != (2, {1 << self.num_qubits})"
            )
        if state.dtype != torch.float32:
            raise ValueError("the grid sweep path is float32-only")

    def run(self, state: torch.Tensor) -> torch.Tensor:
        self._check(state)
        if state.device.type == "cpu":
            return self.run_plain(state)
        if state.device.type != "cuda":
            raise ValueError(f"no grid-sweep kernel for device {state.device}")
        state = state.contiguous()
        for (ints, coef), lay in zip(self._tables_on(state.device), self.layouts):
            grid_sweep(state, ints, coef, lay, self.params.threads)
        return state

    __call__ = run

    def run_plain(self, state: torch.Tensor) -> torch.Tensor:
        """The plain version: each sweep's gate list through the torch
        engine, in the order the kernel applies it."""
        self._check(state)
        rdtype = np.float32
        for gates in self.sweep_gates:
            for g in gates:
                if _is_diagonal(g.u):
                    dr, di = ap.split_matrix(np.diagonal(g.u), rdtype)
                    state = ap.apply_diagonal(state, dr, di, g.qubits)
                else:
                    ur, ui = ap.split_matrix(g.u, rdtype)
                    state = ap.apply_unitary(state, ur, ui, g.qubits)
        return state

    def flops(self) -> float:
        """Real flops one run applies (from the op tables)."""
        return float(sum(t.flops_per_amp for t in self.tables)) * (1 << self.num_qubits)

    def bytes_moved(self) -> int:
        """Device-memory bytes one run must move: each sweep reads and writes
        both float32 planes once."""
        return self.num_sweeps * 2 * 2 * 4 * (1 << self.num_qubits)
