"""Segmented executor on the CUDA card (19 qubits, and the grid fallback).

The host half of ``tpu_qsim/kernels/segmented.py``. :class:`SegmentedProgram`
plans a circuit with the port's :func:`tpu_qsim_torch.schedule.plan_segments`
and runs the whole plan as one launch of ``csrc/segment.cu``: for each
segment, each block of ``2^local_bits`` amplitudes is gathered through the
segment's relabeling straight into registers, runs the segment's gates
through the register program (``csrc/block_program.cuh``, the grid sweep's:
a segment's op table is a ``gridsweeps.register_table`` over the block's
bits) and is stored; the CTAs meet at a barrier between segments. The last
segment is a scatter segment whenever the plan's restore is not the
identity: it stores each amplitude at its canonical index, so no separate
permute runs. Each segment's index maps are written once on the host
(:func:`map_words`) into the launch's table (:func:`run_table`).

A launch of segments ``[first, last)`` (:meth:`SegmentedProgram.launch`;
``run`` launches them all) counts once in ``LAUNCHES["segment"]``, and once
in ``SEGMENT_KINDS`` under each kind of segment it runs: ``segment`` for a
segment that stores to its gathered index, ``scatter_segment`` for the
scatter segment.

What does not carry over from the TPU plan: ``GATHER_SWAP_MIN``,
``MIN_GATHER_CHUNK_BITS`` and ``stage_min`` kept gathered chunks at 8 or
more (8, 128) tiles, and forced a ``permute_qubits`` pre-pass for any other
relabeling; here every relabeling folds into the gather. ``local_bits`` 16 was
a VMEM size; here a block is 2^9 (one warp of 16 amplitudes a thread) to
2^14 amplitudes (128 KB of one CTA's shared memory): by default
(:func:`default_local_bits`) the largest that leaves 128 blocks, unless a
plan's widest gate needs a larger one. The plan keeps
``SWAP_MIN`` = 7 low bits in place unless a gate wider than
``local_bits - 7`` needs the room, and never fewer than 5 (a 128 B line), so
a segment holds gates of up to 14 - 5 = 9 qubits.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import apply as ap
from ..circuit import Circuit
from ..schedule import SWAP_MIN, plan_segments
from . import LAUNCHES, SEGMENT_KINDS
from .fused_circuit import (
    MAX_BLOCK_BITS,
    NARROW_CORE,
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
from .gridsweeps import MIN_GRID_BLOCK_BITS, REG_BITS, register_table

DEFAULT_LOCAL_BITS = 12
# a default block leaves at least 2^7 = 128 blocks: one CTA on each of 128
# of the H100's 132 SMs
MIN_BLOCKS_BITS = 7
MAX_SEGMENTED_QUBITS = 26       # as the JAX package's segmented engine
# the fewest low bits a plan keeps in place: 2^5 float32 values are one 128 B
# line of a plane, so a warp's 32 loads and stores stay coalesced
MIN_SWAP_MIN = 5
# segment.cu's run table: a header, a descriptor per segment (flags, offsets
# of its register table, coefficients, gather map and store map), then each
# segment's register table and maps. An index map is four 256-word tables,
# one per byte of an index.
RUN_HEADER = 16
SEG_WORDS = 8
F_RELABEL = 1                   # the segment writes the other buffer
MAP_WORDS = 4 * 256

# (device, local_bits, wide) -> CTAs of that kernel instance resident at once
_resident: dict[tuple, int] = {}


@dataclass(frozen=True)
class SegmentStep:
    """One segment: gather through ``gather_src`` (new bit i = old bit
    src[i]; None: no relabeling), apply ``gates`` (physical qubits below
    local_bits) through ``table`` (a register table over the block's bits),
    store through ``scatter_dst`` (current bit j goes to bit dst[j]; None:
    to the gathered index)."""

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


def map_words(bits: tuple[int, ...] | None) -> np.ndarray:
    """The kernel's words of the index map that sends bit i of an index to
    bit ``bits[i]`` (None: the identity): for each byte k of an index, the
    256 maps of its values placed at bits 8k..8k+7, so that the map of x is
    the OR of four lookups."""
    pos = np.arange(32) if bits is None else np.concatenate(
        [np.asarray(bits, np.int64), np.arange(len(bits), 32)])
    v = np.arange(256, dtype=np.int64)
    out = np.zeros((4, 256), dtype=np.int64)
    for k in range(4):
        for j in range(8):
            out[k] |= ((v >> j) & 1) << pos[8 * k + j]
    return out.reshape(-1).astype(np.uint32).view(np.int32)


def run_table(steps: list[SegmentStep], local_bits: int, n: int) -> OpTable:
    """``segment.cu``'s table for a plan's segments: the header (segment
    count, n, local_bits, widest core), a descriptor per segment (flags,
    offset of its register table in int32 words, of its coefficients, of its
    gather map and of its store map), then each segment's register table and
    maps. Coefficients follow one another at even offsets (16-byte aligned,
    for the tiled op's 16-byte loads)."""
    head = np.zeros(RUN_HEADER, dtype=np.int32)
    desc = np.zeros((len(steps), SEG_WORDS), dtype=np.int32)
    ints: list[np.ndarray] = [head, desc.reshape(-1)]
    coefs: list[np.ndarray] = []
    off, coef_off = RUN_HEADER + desc.size, 0
    for i, step in enumerate(steps):
        maps = [map_words(step.gather_src), map_words(step.scatter_dst)]
        desc[i, :5] = (0 if step.in_place else F_RELABEL, off, coef_off,
                       off + step.table.ints.size, off + step.table.ints.size + MAP_WORDS)
        ints += [step.table.ints, *maps]
        off += step.table.ints.size + 2 * MAP_WORDS
        coefs.append(step.table.coef)
        coef_off += len(step.table.coef)
        if coef_off % 2:
            coefs.append(np.zeros((1, 2), np.float32))
            coef_off += 1
    max_core = max((s.table.max_core for s in steps), default=0)
    head[:4] = (len(steps), n, local_bits, max_core)
    coef = np.concatenate(coefs) if coefs else np.zeros((2, 2), np.float32)
    return OpTable(np.concatenate(ints).astype(np.int32), np.ascontiguousarray(coef),
                   float(sum(s.table.flops_per_amp for s in steps)), max_core)


def default_local_bits(n: int) -> int:
    """The block bits a plan of ``n`` qubits takes unless told otherwise:
    the largest block (up to 2^14 slots, at least 2^12) that leaves
    2^MIN_BLOCKS_BITS blocks, so 12 at 19 qubits, 13 at 20 and 14 from 21.
    Fewer, larger blocks mean fewer segments; fewer than 128 leave SMs idle
    (chosen on the card with ``python -m tpu_qsim_torch.kernels.tune_small``
    on the circuits each size gets, PERF.md)."""
    return min(MAX_BLOCK_BITS, max(DEFAULT_LOCAL_BITS, n - MIN_BLOCKS_BITS))


def resident_ctas(device: torch.device, local_bits: int, wide: bool) -> int:
    """How many CTAs of the segment kernel's instance for narrow cores
    (``wide`` False) or wide ones, for blocks of ``2^local_bits`` slots, the
    card keeps resident at once: the most one cooperative launch takes.
    Asked once per process, device and instance."""
    from . import _build

    key = (torch.device(device), local_bits, bool(wide))
    if key not in _resident:
        lib = _build.library("segment")
        ctas = ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            err = lib.segment_prepare(local_bits, int(wide), ctypes.byref(ctas))
        _build.check("segment", lib, err, "segment_prepare")
        _resident[key] = ctas.value
    return _resident[key]


class SegmentedProgram:
    """Planned segment pipeline for one circuit.

    ``run`` maps (2, 2^n) float32 planes to planes: on a CUDA tensor it
    launches the kernel once for all segments (:meth:`launch`); on a CPU
    tensor it runs the plain version, :meth:`run_plain`. A segment with no
    relabeling updates the current buffer in place; a relabeled one writes
    the other of two buffers (the input and one ``torch.empty_like`` of it
    per launch, which PyTorch's caching allocator hands back run after run),
    so the input's storage is overwritten and the result may lie in either.
    ``local_bits`` None takes :func:`default_local_bits`.
    """

    def __init__(self, circuit: Circuit, local_bits: int | None = None):
        n = circuit.num_qubits
        if local_bits is None:
            local_bits = default_local_bits(n)
        # the planner makes a k-qubit gate local only in a block with at
        # least k bits above swap_min: take a larger block where one is
        # needed, and where the largest is not enough, keep fewer low bits in
        # place (never fewer than MIN_SWAP_MIN)
        widest = max((len(g.qubits) for g in circuit.gates), default=0)
        local_bits = min(max(local_bits, min(SWAP_MIN + widest, MAX_BLOCK_BITS)), n - 1)
        swap_min = max(MIN_SWAP_MIN, min(SWAP_MIN, local_bits - widest))
        lowest = max(swap_min + 3, MIN_GRID_BLOCK_BITS)
        if not (lowest <= local_bits <= MAX_BLOCK_BITS and n <= MAX_SEGMENTED_QUBITS):
            raise ValueError(
                f"segmented path expects {lowest} <= local_bits <= "
                f"{MAX_BLOCK_BITS} and n <= {MAX_SEGMENTED_QUBITS}, got "
                f"local_bits={local_bits}, n={n}"
            )
        if widest > local_bits - swap_min:
            raise ValueError(
                f"a {widest}-qubit gate needs local_bits >= {swap_min + widest} "
                f"(a block holds at most {MAX_BLOCK_BITS} bits, "
                f"{MIN_SWAP_MIN} of them kept in place)"
            )
        self.num_qubits = n
        self.local_bits = local_bits
        self.swap_min = swap_min
        self.threads = 1 << (local_bits - REG_BITS)
        segments, restore = plan_segments(circuit, local_bits, swap_min)
        self.restore = restore
        identity = tuple(range(n))
        layout = BlockLayout(local_bits, local_bits, ())
        self.steps: list[SegmentStep] = []
        for i, seg in enumerate(segments):
            gates = merge_1q_chains(as_pgates(seg.gates))
            last = i == len(segments) - 1
            dst = _inverse(restore) if last and restore != identity else None
            table = register_table(build_op_table(gates, layout), MAX_BLOCK_BITS)
            self.steps.append(SegmentStep(gates, seg.perm_src, dst, table))
        self.table = run_table(self.steps, local_bits, n)
        check_tile(self.table.max_core, self.threads)
        self._device_tables: dict[torch.device, tuple] = {}

    @property
    def num_segments(self) -> int:
        return len(self.steps)

    def _tables_on(self, device: torch.device) -> tuple:
        tabs = self._device_tables.get(device)
        if tabs is None:
            tabs = (torch.from_numpy(self.table.ints).to(device),
                    torch.from_numpy(self.table.coef).to(device))
            self._device_tables[device] = tabs
        return tabs

    def launch(
        self,
        state: torch.Tensor,
        first: int = 0,
        last: int | None = None,
        other: torch.Tensor | None = None,
        max_core: int | None = None,
    ) -> torch.Tensor:
        """Run segments ``[first, last)`` (all by default) on ``state`` and
        return the buffer that holds the result: on a CUDA tensor one launch
        of the kernel, on a CPU tensor the segments' plain versions.

        A relabeled segment writes ``other`` (a tensor like ``state``; None:
        a new one), and the next reads it back, so the result lies in
        ``state`` after an even number of relabeled segments and in
        ``other`` after an odd one. ``max_core`` (None: the range's widest
        dense core) picks the kernel instance: the one for narrow cores when
        it is at most 4. Launches on the current stream without
        synchronizing and raises on a refused launch.
        """
        from . import _build

        last = self.num_segments if last is None else last
        if not 0 <= first < last <= self.num_segments:
            raise ValueError(f"segments [{first}, {last}) outside [0, {self.num_segments})")
        if state.device.type == "cpu":
            check_planes(state, self.num_qubits, "segmented")
            for i in range(first, last):
                state = self.step_plain(state, i)
            return state
        ints, coef = self._tables_on(state.device)
        if check_kernel_inputs(state, ints, coef) != self.num_qubits:
            raise ValueError(f"state must be (2, 2^{self.num_qubits}) planes")
        steps = self.steps[first:last]
        relabels = sum(not s.in_place for s in steps)
        if relabels and other is None:
            other = torch.empty_like(state)
        if other is not None and (
            other.shape != state.shape or other.dtype != state.dtype
            or other.device != state.device or not other.is_contiguous()
            or other.data_ptr() == state.data_ptr()
        ):
            raise ValueError("other must be a second contiguous tensor like state")
        if max_core is None:
            max_core = max(s.table.max_core for s in steps)
        n, lb = self.num_qubits, self.local_bits
        ctas = min(1 << (n - lb), resident_ctas(state.device, lb, max_core > NARROW_CORE))
        if ctas < 1:
            raise RuntimeError("the card cannot keep one segment CTA resident")
        lib = _build.library("segment")
        barrier = torch.empty(1, dtype=torch.int32, device=state.device)
        with torch.cuda.device(state.device):
            stream = torch.cuda.current_stream(state.device).cuda_stream
            err = lib.segment_launch(
                state.data_ptr(), (state if other is None else other).data_ptr(),
                1 << n, ints.data_ptr(), coef.data_ptr(), barrier.data_ptr(),
                first, last, lb, ctas, max_core, stream,
            )
        _build.check("segment", lib, err, "segment launch")
        LAUNCHES["segment"] += 1
        for kind in dict.fromkeys(s.kernel for s in steps):
            SEGMENT_KINDS[kind] += 1
        return other if relabels % 2 else state

    def run(self, state: torch.Tensor) -> torch.Tensor:
        check_planes(state, self.num_qubits, "segmented")
        if state.device.type == "cpu":
            return self.run_plain(state)
        if state.device.type != "cuda":
            raise ValueError(f"no segment kernel for device {state.device}")
        return self.launch(state.contiguous())

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
        return float(self.table.flops_per_amp) * (1 << self.num_qubits)

    def bytes_moved(self) -> int:
        """Device-memory bytes one run must move: each segment reads and
        writes both float32 planes once."""
        return self.num_segments * 2 * 2 * 4 * (1 << self.num_qubits)
