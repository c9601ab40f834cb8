"""Segment planner: qubit relocation for the segmented kernels.

A host-only copy of ``tpu_qsim/schedule.py``; it gives the same plans gate
by gate. ``plan_segments`` cuts a circuit into **segments** whose gates all
act on the low ``local_bits`` physical bits, with a qubit relabeling
(``perm_src``) before a segment whenever it needs qubits that live in the
high (block-index) bits, and returns the relabeling that restores the
canonical placement at the end (the classic qubit-relocation scheme of
distributed state-vector simulators, with blocks in place of ranks).

On the CUDA card :mod:`tpu_qsim_torch.kernels.segmented` folds every
relabeling into a segment kernel's gather and the restore into the last
segment's scatter. ``swap_min`` keeps bits ``[0, swap_min)`` in place: the
JAX package needs that for its 128-lane axis; on the card the default of 7
keeps 2^7 contiguous amplitudes (512 B of a plane) together in every gather
and scatter, and the segmented program lowers it to as few as 5 (one 128 B
line) for a gate too wide for the block otherwise. ``stage_min`` is TPU DMA policy and the port's programs do not
pass it; it is kept so the plans compare with the JAX planner's.

``plan_blockswap_segments`` plans the full block swaps of a sharded
executor (one all-to-all per relocation).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np

from .circuit import Circuit, Gate
from .gates import op_matrix

SWAP_MIN = 7  # lowest physical bit a permutation may touch


@dataclass
class Segment:
    """One kernel launch: optional relabeling, then block-local gates."""

    perm_src: tuple[int, ...] | None          # new bit i = old bit src[i]
    gates: list[Gate] = field(default_factory=list)
    # gates carry PHYSICAL qubit tuples (all < local_bits)


class _Placement:
    """Tracks logical qubit <-> physical bit assignment."""

    def __init__(self, n: int):
        self.pos = list(range(n))   # logical qubit -> physical bit
        self.at = list(range(n))    # physical bit  -> logical qubit

    def swap_bits(self, a: int, b: int) -> None:
        qa, qb = self.at[a], self.at[b]
        self.at[a], self.at[b] = qb, qa
        self.pos[qa], self.pos[qb] = b, a


def plan_segments(
    circuit: Circuit,
    local_bits: int,
    swap_min: int = SWAP_MIN,
    stage_min: int | None = None,
) -> tuple[list[Segment], tuple[int, ...]]:
    """Segmentation with qubit relocation and commuting lookahead.

    Frontier scheduling over the commutation DAG (:mod:`tpu_qsim_torch.commute`):
    a segment keeps absorbing whichever *ready* gate introduces the fewest
    new nonlocal qubits and still fits the victim-slot budget — commuting
    gates on already-local qubits are pulled forward past gates that would
    force a relocation. A segment closes only when no ready gate fits, so
    random circuits need markedly fewer HBM sweeps than strictly sequential
    packing.

    ``stage_min`` (executor contract for the gather fold): when set, every
    relocation's row-side exchange touches only bits >= stage_min, so the
    gathered chunks stay >= 2^(stage_min-7) contiguous rows — the DMA
    granularity that streams at full rate. Victims whose free slot sits
    below stage_min are *staged*: an in-VMEM SWAP pseudo-gate appended to
    the previous segment hoists the evictee into the exchange zone first
    (data movement inside VMEM, no extra HBM traffic). Incoming qubits per
    segment are correspondingly capped at ``local_bits - stage_min``.

    Returns (segments, restore_src): run the segments in order (each segment
    may carry a pre-relabeling in ``perm_src``), then apply
    ``permute_qubits(state, restore_src)`` to return to the canonical
    qubit q = bit q placement.
    """
    from .commute import FrontierScheduler

    n = circuit.num_qubits
    if local_bits >= n:
        raise ValueError("use the whole-circuit kernel when the state fits")
    if local_bits - swap_min < 3:
        raise ValueError("not enough swap slots between swap_min and local_bits")
    if stage_min is not None and not (swap_min <= stage_min < local_bits):
        raise ValueError("stage_min must lie in [swap_min, local_bits)")
    max_incoming = (
        local_bits - stage_min if stage_min is not None else local_bits
    )

    place = _Placement(n)
    segments: list[Segment] = []
    pending: list = []            # gates accepted for the current segment
    seg_qubits: set[int] = set()  # logical qubits used by the current segment

    def new_nonlocal(qubits: tuple[int, ...]) -> int:
        return sum(
            1
            for q in set(qubits) - seg_qubits
            if place.pos[q] >= local_bits
        )

    def fits(qubits: tuple[int, ...]) -> bool:
        new_qubits = seg_qubits | set(qubits)
        nonlocal_total = sum(
            1 for q in new_qubits if place.pos[q] >= local_bits
        )
        if nonlocal_total == 0:
            return True
        if stage_min is not None and not segments:
            # the first segment takes no relocations: staging swaps need a
            # previous segment to ride in, and an unstaged relocation would
            # force sub-zone exchange bits (tiny gather chunks)
            return False
        free = sum(
            1
            for b in range(swap_min, local_bits)
            if place.at[b] not in new_qubits
        )
        return nonlocal_total <= min(free, max_incoming)

    def flush() -> None:
        nonlocal pending, seg_qubits
        if not pending:
            return
        # build the relabeling that localizes every nonlocal segment qubit
        nonlocal_qs = sorted(
            (q for q in seg_qubits if place.pos[q] >= local_bits),
            key=lambda q: place.pos[q],
        )
        src: tuple[int, ...] | None = None
        if nonlocal_qs:
            free = [
                b
                for b in range(local_bits - 1, swap_min - 1, -1)
                if place.at[b] not in seg_qubits
            ]
            if stage_min is not None:
                # prefer (a) slots already in the exchange zone and (b)
                # evicting qubits whose canonical home is >= stage_min, so
                # low-home qubits stay local and the final restore remains
                # scatter-foldable
                free.sort(
                    key=lambda b: (b < stage_min, place.at[b] < stage_min, -b)
                )
            victims = free[: len(nonlocal_qs)]
            assert len(victims) >= len(nonlocal_qs), "planner slot accounting bug"
            if stage_min is not None and segments:
                # hoist sub-zone victims into [stage_min, local_bits) with
                # in-VMEM swaps appended to the PREVIOUS segment (the zone
                # slot's occupant is displaced downward but stays local)
                zone_free = [
                    b
                    for b in range(local_bits - 1, stage_min - 1, -1)
                    if b not in victims
                ]
                staged = []
                for k, v in enumerate(victims):
                    if v >= stage_min:
                        continue
                    t = zone_free.pop(0)
                    segments[-1].gates.append(Gate("swap", (v, t)))
                    place.swap_bits(v, t)
                    victims[k] = t
                    staged.append((v, t))
                assert all(v >= stage_min for v in victims)
            mapping = list(range(n))  # new bit i <- old bit mapping[i]
            for q, v in zip(nonlocal_qs, victims):
                p = place.pos[q]
                mapping[v], mapping[p] = mapping[p], mapping[v]
                place.swap_bits(v, p)
            src = tuple(mapping)
        gates = [
            replace(g, qubits=tuple(place.pos[q] for q in g.qubits))
            for g in pending
        ]
        for g in gates:
            assert all(b < local_bits for b in g.qubits)
        segments.append(Segment(src, gates))
        pending = []
        seg_qubits = set()

    sched = FrontierScheduler(circuit.gates)
    while not sched.done():
        best = None
        best_cost = None
        for i in sched.ready():
            g = sched.gates[i]
            if not fits(g.qubits):
                continue
            cost = new_nonlocal(g.qubits)
            if best_cost is None or cost < best_cost:
                best, best_cost = i, cost
                if cost == 0:
                    break  # can't do better; earliest 0-cost gate wins
        if best is None:
            if not pending:
                # an empty segment took no ready gate, so flushing changes
                # nothing and the loop would spin: name the first that fails
                g = sched.gates[sched.ready()[0]]
                raise ValueError(
                    f"gate {g.name} on qubits {g.qubits} fits no empty "
                    f"segment: it needs {len(g.qubits)} local slots, with "
                    f"local_bits - swap_min = {local_bits - swap_min} to "
                    f"relocate into (local_bits {local_bits}, swap_min "
                    f"{swap_min}, stage_min {stage_min})"
                )
            flush()
            continue
        g = sched.gates[best]
        sched.emit(best)
        pending.append(g)
        seg_qubits |= set(g.qubits)
    flush()

    if stage_min is not None and segments:
        # normalize the sub-zone rows with in-VMEM swaps in the LAST segment
        # so the final restore only moves bits >= stage_min (+ blocks) and
        # stays scatter-foldable
        for b in range(SWAP_MIN, stage_min):
            p = place.pos[b]  # where canonical occupant of bit b sits now
            if p != b and p < local_bits:
                segments[-1].gates.append(Gate("swap", (p, b)))
                place.swap_bits(p, b)

    restore = tuple(place.pos)  # new bit i = old bit pos[i] -> canonical
    identity = tuple(range(n))
    return segments, (restore if restore != identity else identity)


@dataclass
class BlockSwapSegment:
    """One distributed segment: an optional relabeling that exchanges ALL
    device-index bits with G local victim bits, then device-local gates."""

    victims: tuple[int, ...] | None   # local bits receiving the device bits
    gates: list[tuple[np.ndarray, tuple[int, ...]]] = field(default_factory=list)


def plan_blockswap_segments(
    circuit: Circuit, device_bits: int, swap_min: int = SWAP_MIN
) -> tuple[list[BlockSwapSegment], tuple[int, ...]]:
    """Segmentation for the shard_map executor: the only relabeling primitive
    is a *full block swap* (all ``device_bits`` top bits exchanged with G
    chosen local bits — one ``all_to_all``), matching what ICI collectives
    express cheaply. Returns (segments, final placement pos list) where
    ``pos[q]`` is the physical bit of logical qubit q after all segments.
    """
    n = circuit.num_qubits
    g_bits = device_bits
    local_bits = n - g_bits
    # g victims + up to 3 swap-range bits claimed by one gate must coexist
    if local_bits - swap_min < g_bits + 3:
        raise ValueError("not enough local victim slots for a block swap")

    place = _Placement(n)
    segments: list[BlockSwapSegment] = []
    pending: list = []
    seg_qubits: set[int] = set()

    def flush() -> None:
        nonlocal pending, seg_qubits
        if not pending:
            return
        victims: tuple[int, ...] | None = None
        if any(place.pos[q] >= local_bits for q in seg_qubits):
            vlist = [
                b
                for b in range(local_bits - 1, swap_min - 1, -1)
                if place.at[b] not in seg_qubits
            ][:g_bits]
            assert len(vlist) == g_bits, "planner victim accounting bug"
            victims = tuple(vlist)
            for j, v in enumerate(victims):
                place.swap_bits(v, local_bits + j)
        gates = [
            (op_matrix(g),
             tuple(place.pos[q] for q in g.qubits))
            for g in pending
        ]
        for _, phys in gates:
            assert all(b < local_bits for b in phys)
        segments.append(BlockSwapSegment(victims, gates))
        pending = []
        seg_qubits = set()

    for g in circuit.gates:
        new_qubits = seg_qubits | set(g.qubits)
        nonlocal_any = any(place.pos[q] >= local_bits for q in new_qubits)
        free = sum(
            1
            for b in range(swap_min, local_bits)
            if place.at[b] not in new_qubits
        )
        if nonlocal_any and free < g_bits:
            flush()
            new_qubits = set(g.qubits)
        pending.append(g)
        seg_qubits = new_qubits
    flush()
    return segments, tuple(place.pos)
