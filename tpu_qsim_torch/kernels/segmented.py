"""Segmented executor on the CUDA card (19 qubits, and the grid fallback).

The host half of ``tpu_qsim/kernels/segmented.py``. :class:`SegmentedProgram`
plans a circuit with the port's :func:`tpu_qsim_torch.schedule.plan_segments`
and runs each segment as one launch of ``csrc/segment.cu``: the CTA for a
block of ``2^local_bits`` amplitudes gathers them through the segment's
relabeling, applies the segment's gates in shared memory and stores them.
The last segment is a scatter segment whenever the plan's restore is not the
identity: it stores each amplitude at its canonical index, so no separate
permute runs.

What does not carry over from the TPU plan: ``GATHER_SWAP_MIN``,
``MIN_GATHER_CHUNK_BITS`` and ``stage_min`` kept gathered chunks at 8 or
more (8, 128) tiles, and forced a ``permute_qubits`` pre-pass for any other
relabeling; here every relabeling folds into the gather. ``local_bits`` 16 was
a VMEM size; here a block is at most 2^14 amplitudes (128 KB of one CTA's
shared memory), and the default is chosen on the card (PERF.md). The plan
keeps ``SWAP_MIN`` = 7 low bits in place unless a gate wider than
``local_bits - 7`` needs the room, and never fewer than 5 (a 128 B line), so
a segment holds gates of up to 14 - 5 = 9 qubits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import apply as ap
from ..circuit import Circuit
from ..schedule import SWAP_MIN, plan_segments
from . import LAUNCHES
from .fused_circuit import (
    MAX_BLOCK_BITS,
    MAX_DENSE_QUBITS,
    BlockLayout,
    OpTable,
    PGate,
    apply_pgates,
    as_pgates,
    build_op_table,
    check_kernel_inputs,
    check_tile,
    check_planes,
    merge_1q_chains,
)

# block bits and threads per CTA, chosen on the H100 at 19 qubits with
# ``python -m tpu_qsim_torch.kernels.tune_small`` (PERF.md)
DEFAULT_LOCAL_BITS = 12
SEGMENT_THREADS = 512
MAX_SEGMENTED_QUBITS = 26       # as the JAX package's segmented engine
MAP_WORDS = 32                  # segment.cu: src at [0, n), dst at [32, 32 + n)
# the fewest low bits a plan keeps in place: 2^5 float32 values are one 128 B
# line of a plane, so a warp's 32 loads and stores stay coalesced
MIN_SWAP_MIN = 5

# devices on which segment_prepare has set the kernel's attributes
_prepared: set[torch.device] = set()


@dataclass(frozen=True)
class SegmentStep:
    """One launch: gather through ``gather_src`` (new bit i = old bit
    src[i]; None: no relabeling), apply ``gates`` (physical qubits below
    local_bits), store through ``scatter_dst`` (current bit j goes to bit
    dst[j]; None: to the gathered index)."""

    gates: list[PGate]
    gather_src: tuple[int, ...] | None
    scatter_dst: tuple[int, ...] | None
    table: OpTable

    @property
    def in_place(self) -> bool:
        return self.gather_src is None and self.scatter_dst is None

    @property
    def kernel(self) -> str:
        return "segment" if self.scatter_dst is None else "scatter_segment"


def _inverse(perm: tuple[int, ...]) -> tuple[int, ...]:
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def segment_maps(step: SegmentStep, n: int) -> np.ndarray:
    """The kernel's int32 map words for ``step``."""
    maps = np.zeros(2 * MAP_WORDS, dtype=np.int32)
    if step.gather_src is not None:
        maps[:n] = step.gather_src
    if step.scatter_dst is not None:
        maps[MAP_WORDS:MAP_WORDS + n] = step.scatter_dst
    return maps


def segment(
    inp: torch.Tensor,
    out: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    maps: torch.Tensor,
    local_bits: int,
    gather: bool,
    scatter: bool,
    threads: int = SEGMENT_THREADS,
    max_core: int = MAX_DENSE_QUBITS,
) -> torch.Tensor:
    """Launch one segment (``scatter``: the scatter segment) from ``inp``
    into ``out`` and return ``out``.

    ``out`` may be ``inp`` only when the segment neither gathers nor
    scatters. ``max_core`` is the table's widest dense core (the kernel
    instance for narrow cores is launched when it is at most 4). Launches
    on the current stream without synchronizing and raises on a refused
    launch.
    """
    from . import _build

    n = check_kernel_inputs(inp, ints, coef)
    if (
        out.shape != inp.shape or out.dtype != inp.dtype
        or out.device != inp.device or not out.is_contiguous()
    ):
        raise ValueError("out must be a contiguous tensor like inp")
    if maps.device != inp.device or maps.dtype != torch.int32 or maps.numel() != 2 * MAP_WORDS:
        raise ValueError(f"maps must be {2 * MAP_WORDS} int32 words on the state's device")
    if (gather or scatter) and out.data_ptr() == inp.data_ptr():
        raise ValueError("a relabeling segment cannot run in place")
    if not 1 <= local_bits <= min(MAX_BLOCK_BITS, n - 1):
        raise ValueError(f"local_bits {local_bits} outside [1, {min(MAX_BLOCK_BITS, n - 1)}]")
    lib = _build.library("segment")
    if inp.device not in _prepared:
        with torch.cuda.device(inp.device):
            _build.check("segment", lib, lib.segment_prepare(), "segment_prepare")
        _prepared.add(inp.device)
    launch = lib.scatter_segment_launch if scatter else lib.segment_launch
    with torch.cuda.device(inp.device):
        stream = torch.cuda.current_stream(inp.device).cuda_stream
        err = launch(
            inp.data_ptr(), out.data_ptr(), 1 << n, n, ints.data_ptr(),
            coef.data_ptr(), maps.data_ptr(), int(gather), local_bits,
            min(threads, 1 << local_bits), max_core, stream,
        )
    name = "scatter_segment" if scatter else "segment"
    _build.check("segment", lib, err, f"{name} launch")
    LAUNCHES[name] += 1
    return out


class SegmentedProgram:
    """Planned segment pipeline for one circuit.

    ``run`` maps (2, 2^n) float32 planes to planes: on a CUDA tensor it
    launches one kernel per segment. A segment with no relabeling updates
    the current buffer in place; a relabeled one writes the other of two
    buffers (the input and one ``torch.empty_like`` of it per run, which
    PyTorch's caching allocator hands back run after run), so the input's
    storage is overwritten and the result may lie in either. On a CPU
    tensor ``run`` is the plain version, :meth:`run_plain`.
    """

    def __init__(
        self,
        circuit: Circuit,
        local_bits: int = DEFAULT_LOCAL_BITS,
        threads: int = SEGMENT_THREADS,
    ):
        n = circuit.num_qubits
        # the planner makes a k-qubit gate local only in a block with at
        # least k bits above swap_min: take a larger block where one is
        # needed, and where the largest is not enough, keep fewer low bits in
        # place (never fewer than MIN_SWAP_MIN)
        widest = max((len(g.qubits) for g in circuit.gates), default=0)
        local_bits = min(max(local_bits, min(SWAP_MIN + widest, MAX_BLOCK_BITS)), n - 1)
        swap_min = max(MIN_SWAP_MIN, min(SWAP_MIN, local_bits - widest))
        if not (swap_min + 3 <= local_bits <= MAX_BLOCK_BITS and n <= MAX_SEGMENTED_QUBITS):
            raise ValueError(
                f"segmented path expects {swap_min + 3} <= local_bits <= "
                f"{MAX_BLOCK_BITS} and n <= {MAX_SEGMENTED_QUBITS}, got "
                f"local_bits={local_bits}, n={n}"
            )
        if not 32 <= threads <= 1024:
            raise ValueError(f"threads must be in [32, 1024], got {threads}")
        if widest > local_bits - swap_min:
            raise ValueError(
                f"a {widest}-qubit gate needs local_bits >= {swap_min + widest} "
                f"(a block holds at most {MAX_BLOCK_BITS} bits, "
                f"{MIN_SWAP_MIN} of them kept in place)"
            )
        self.num_qubits = n
        self.local_bits = local_bits
        self.swap_min = swap_min
        self.threads = threads
        segments, restore = plan_segments(circuit, local_bits, swap_min)
        self.restore = restore
        identity = tuple(range(n))
        layout = BlockLayout(local_bits, local_bits, ())
        self.steps: list[SegmentStep] = []
        for i, seg in enumerate(segments):
            gates = merge_1q_chains(as_pgates(seg.gates))
            last = i == len(segments) - 1
            dst = _inverse(restore) if last and restore != identity else None
            self.steps.append(SegmentStep(
                gates, seg.perm_src, dst, build_op_table(gates, layout)
            ))
        check_tile(max((s.table.max_core for s in self.steps), default=0), threads)
        self._device_tables: dict[torch.device, list] = {}

    @property
    def num_segments(self) -> int:
        return len(self.steps)

    def _tables_on(self, device: torch.device) -> list:
        tabs = self._device_tables.get(device)
        if tabs is None:
            tabs = [
                (torch.from_numpy(s.table.ints).to(device),
                 torch.from_numpy(s.table.coef).to(device),
                 torch.from_numpy(segment_maps(s, self.num_qubits)).to(device))
                for s in self.steps
            ]
            self._device_tables[device] = tabs
        return tabs

    def run(self, state: torch.Tensor) -> torch.Tensor:
        check_planes(state, self.num_qubits, "segmented")
        if state.device.type == "cpu":
            return self.run_plain(state)
        if state.device.type != "cuda":
            raise ValueError(f"no segment kernel for device {state.device}")
        cur = state.contiguous()
        other = None
        for step, (ints, coef, maps) in zip(self.steps, self._tables_on(cur.device)):
            if step.in_place:
                out = cur
            else:
                out = torch.empty_like(cur) if other is None else other
            segment(
                cur, out, ints, coef, maps, self.local_bits,
                step.gather_src is not None, step.scatter_dst is not None,
                self.threads, step.table.max_core,
            )
            if out is not cur:
                cur, other = out, cur
        return cur

    __call__ = run

    def run_plain(self, state: torch.Tensor) -> torch.Tensor:
        """The plain version: each segment through :meth:`step_plain`."""
        check_planes(state, self.num_qubits, "segmented")
        for i in range(self.num_segments):
            state = self.step_plain(state, i)
        return state

    def step_plain(self, state: torch.Tensor, i: int) -> torch.Tensor:
        """Segment ``i``'s plain version: its relabeling through
        :func:`~tpu_qsim_torch.apply.permute_qubits`, its gates through the
        torch engine, then (scatter segment) the restore."""
        step = self.steps[i]
        if step.gather_src is not None:
            state = ap.permute_qubits(state, step.gather_src)
        state = apply_pgates(state, step.gates)
        if step.scatter_dst is not None:
            state = ap.permute_qubits(state, self.restore)
        return state

    def flops(self) -> float:
        """Real flops one run needs (from the op tables)."""
        return float(sum(s.table.flops_per_amp for s in self.steps)) * (1 << self.num_qubits)

    def bytes_moved(self) -> int:
        """Device-memory bytes one run must move: each segment reads and
        writes both float32 planes once."""
        return self.num_segments * 2 * 2 * 4 * (1 << self.num_qubits)
