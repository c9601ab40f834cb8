"""Planner gates, the device op table, and the whole-circuit kernel's program.

Host half of ``tpu_qsim/kernels/fused_circuit.py``: ``PGate``, ``as_pgates``,
``merge_1q_chains`` and the matrix tests the planners share, copied without
JAX.

:func:`build_op_table` replaces ``materialize_ops`` for the CUDA card. The
TPU planner composed 7-qubit lane/row windows into 128x128 matmuls and
resolved out-of-block bits through per-step ``ext`` scalars; both are TPU
layout. Here a block's gates become a flat int32 table of ops (one header per
op) plus a float32 table of coefficients composed on the host in complex128,
which the compiled kernels (``csrc/ops.cuh``, included by ``grid_sweep.cu``,
``segment.cu``, ``sweep.cu`` and ``dense_pass.cu``) interpret for any
circuit.

:class:`WholeCircuitProgram` is the counterpart of ``build_pallas_run`` /
``build_pallas_run_gates``: the whole circuit (10-18 qubits) in one launch
of ``csrc/sweep.cu``'s low-sweep kernel over the whole state as one unit,
in stages of tile passes planned by ``sweeps.plan_stages``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import apply as ap
from ..gates import op_matrix
from . import LAUNCHES

_SWAP_U = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.complex128,
)


def _is_diagonal(u: np.ndarray) -> bool:
    return not np.any(u - np.diag(np.diagonal(u)))


def _controlled_split(u: np.ndarray) -> np.ndarray | None:
    """If u = block-diag(I, V) w.r.t. its MSB qubit (the library layout of
    cnot/cz/cry/crz/cp/toffoli), return V, else None."""
    d = u.shape[0] >> 1
    if (
        not np.any(u[:d, d:])
        and not np.any(u[d:, :d])
        and not np.any(u[:d, :d] - np.eye(d))
    ):
        return np.ascontiguousarray(u[d:, d:])
    return None


class PGate:
    """Planner gate: an explicit unitary + qubit tuple.

    ``classes`` carries the per-qubit commutation classes consumed by
    :func:`tpu_qsim_torch.commute.qubit_classes`.
    """

    __slots__ = ("u", "qubits", "classes")

    def __init__(self, u: np.ndarray, qubits: tuple[int, ...], classes):
        self.u = u
        self.qubits = qubits
        self.classes = classes


def matrix_classes(u: np.ndarray, qubits: tuple[int, ...]) -> tuple:
    """Conservative per-qubit commutation classes derived from a matrix
    (for gates that arrive without a library name): diagonal axes commute
    as DIAG, peeled control axes as DIAG, everything else OTHER."""
    from ..commute import DIAG, OTHER

    if _is_diagonal(u):
        return (DIAG,) * len(qubits)
    v = _controlled_split(u)
    if v is not None:
        return (DIAG,) + matrix_classes(v, qubits[1:])
    return (OTHER,) * len(qubits)


def as_pgates(gates) -> list[PGate]:
    """Normalize a gate list to planner gates: named circuit Gates pick up
    their library matrix + name-based commute classes; (matrix, qubits)
    pairs and existing PGates pass through."""
    from ..commute import qubit_classes

    out = []
    for g in gates:
        if isinstance(g, PGate):
            out.append(g)
        elif isinstance(g, tuple):
            u, qubits = g
            u = np.asarray(u, dtype=np.complex128)
            out.append(PGate(u, tuple(qubits), matrix_classes(u, qubits)))
        else:
            out.append(
                PGate(
                    op_matrix(g).astype(np.complex128),
                    g.qubits,
                    qubit_classes(g),
                )
            )
    return out


def merge_1q_chains(pgates: list[PGate]) -> list[PGate]:
    """Commute-aware same-qubit 1q-run folding.

    Under frontier scheduling, a 1q gate whose target already carries an
    emitted 1q gate with no intervening non-commuting toucher folds into
    it (u = u2 @ u1, composed in complex128 on host); exact-identity
    products (H·H, X·X) are elided outright. Every emitted gate is one pass
    over the block in shared memory, so fewer gates is a direct compute cut.

    Safety: merging places g at its partner's position; any gate that
    could forbid that must not commute with g, hence (conservative rule,
    :mod:`tpu_qsim_torch.commute`) shares g's qubit — and every toucher of a
    qubit closes that qubit's open slot below. Identity elision requires
    exact I (no global-phase freedom: amplitudes are compared literally
    against the oracle).
    """
    from ..commute import FrontierScheduler

    if sum(1 for g in pgates if len(g.qubits) == 1) < 2:
        return list(pgates)
    sched = FrontierScheduler(list(pgates))
    out: list[PGate | None] = []
    open_1q: dict[int, int] = {}        # qubit -> open slot index in out
    while not sched.done():
        ready = sched.ready()
        pick = None
        for i in ready:
            g = sched.gates[i]
            if len(g.qubits) == 1 and g.qubits[0] in open_1q:
                pick = i
                break
        if pick is not None:
            g = sched.gates[pick]
            sched.emit(pick)
            j = open_1q[g.qubits[0]]
            u = g.u @ out[j].u
            if not np.any(np.abs(u - np.eye(2)) > 1e-12):
                out[j] = None               # folded to identity: elide
                del open_1q[g.qubits[0]]
            else:
                out[j] = PGate(u, g.qubits, matrix_classes(u, g.qubits))
            continue
        i = ready[0]
        g = sched.gates[i]
        sched.emit(i)
        for qq in g.qubits:
            open_1q.pop(qq, None)
        out.append(g)
        if len(g.qubits) == 1:
            open_1q[g.qubits[0]] = len(out) - 1
    return [g for g in out if g is not None]


# ---------------------------------------------------------------------------
# Device op table (read by csrc/ops.cuh; keep the two in step)
# ---------------------------------------------------------------------------

SWEEP_HEADER = 64        # int32 words before the first op
HEADER_MAX_CORE = 4      # header word: the widest dense core (ops.cuh checks it)
OP_HEADER = 32           # int32 words per op
KIND_DIAG = 0
KIND_DENSE = 1
# qubit code: < EXT is a bit of the block-local index; EXT + p is state bit p,
# read from the CTA's share of the global index (bits outside the block)
EXT = 32
MAX_DIAG_QUBITS = 16     # op words [8, 24)
NARROW_CORE = 4          # widest core one thread gathers alone (2^m amplitudes)
# cores of TILE_CORE qubits and more take ops.cuh's tiled product on the
# tensor cores: stored column-major at a 16-byte aligned offset (a lane's
# coefficients of two adjacent rows are one 16-byte load), 2^m <= 4 x
# threads (a tile holds two groups or more), at most TILE_MAX_CORE qubits;
# the kernel's block is the other limit
TILE_CORE = 5
MAX_DENSE_QUBITS = 11
SORTED_WORDS = 8         # op words 24-31: the sorted codes of a core of <= 8 qubits
MAX_BLOCK_BITS = 14      # 2 planes x 2^14 x 4 B = 128 KB of one CTA's shared memory
MAX_SWEEP_BITS = 21      # the sweep kernels' block in device memory: 2^(26-5) slots


@dataclass(frozen=True)
class BlockLayout:
    """Which state bits one CTA holds: bits ``[0, blk_bits)`` plus the
    ascending ``active`` high bits; the rest index the grid."""

    n: int
    blk_bits: int
    active: tuple[int, ...]

    @property
    def kbits(self) -> int:
        return self.blk_bits + len(self.active)

    @property
    def inactive(self) -> tuple[int, ...]:
        return tuple(
            p for p in range(self.blk_bits, self.n) if p not in self.active
        )

    def code(self, q: int) -> int:
        """Qubit ``q`` as the kernel reads it (see ``EXT``)."""
        if q < self.blk_bits:
            return q
        if q in self.active:
            return self.blk_bits + self.active.index(q)
        return EXT + q


@dataclass(frozen=True)
class OpTable:
    """One sweep's kernel input: int32 headers and (re, im) coefficients."""

    ints: np.ndarray          # (SWEEP_HEADER + OP_HEADER * n_ops,) int32
    coef: np.ndarray          # (n_coef, 2) float32
    flops_per_amp: float      # real flops per amplitude the ops need (min_flops)
    max_core: int             # widest dense core, 0 without one


def _mul_flops(z: np.ndarray) -> np.ndarray:
    """Real flops of multiplying an amplitude by each coefficient: 0 for
    +-1 and +-i (a sign or a swap of planes), 2 for any other real or
    imaginary number, 6 for a general complex one."""
    real = np.abs(z.imag) <= 1e-12
    imag = np.abs(z.real) <= 1e-12
    unit = (real & np.isclose(np.abs(z.real), 1.0, rtol=0, atol=1e-12)) | (
        imag & np.isclose(np.abs(z.imag), 1.0, rtol=0, atol=1e-12)
    )
    return np.where(unit, 0.0, np.where(real | imag, 2.0, 6.0))


def min_flops(u: np.ndarray, diagonal: bool) -> float:
    """Real flops per amplitude that applying ``u`` needs at the least.

    A diagonal multiplies each amplitude by its entry. A dense core forms
    each output from the nonzero entries of its row: one multiply per entry
    (:func:`_mul_flops`) and a complex add (2 flops) per entry after the
    first. So a permutation with unit phases (X, CNOT's core, SWAP) needs
    nothing, and H 6 flops per amplitude.
    """
    if diagonal:
        return float(_mul_flops(np.diagonal(u)).mean())
    nz = np.abs(u) > 1e-12
    mul = np.where(nz, _mul_flops(u), 0.0).sum()
    adds = 2.0 * np.maximum(nz.sum(axis=1) - 1, 0).sum()
    return float(mul + adds) / u.shape[0]


def _peel_controls(u: np.ndarray, qubits: tuple[int, ...]):
    """Split block-diag(I, V) layers off the MSB qubits: (controls, core
    matrix, core qubits). The core's qubits are ``moving_qubits(u)``."""
    ctrls = []
    while len(qubits) > 1:
        v = _controlled_split(u)
        if v is None:
            break
        ctrls.append(qubits[0])
        u, qubits = v, qubits[1:]
    return ctrls, u, qubits


def build_op_table(
    pgates: list[PGate], layout: BlockLayout, max_bits: int = MAX_BLOCK_BITS,
) -> OpTable:
    """Turn one block's gates into the kernels' device op table.

    A diagonal gate becomes one DIAG op over all its qubits (any bit, in or
    out of the block). Any other gate peels its control layers into a mask
    on the block-local index and a mask on the CTA's out-of-block bits, and
    its core becomes one DENSE op whose qubits must lie in the block (the
    planner's ``moving_qubits`` guarantee). A core of up to ``NARROW_CORE``
    qubits is stored row-major; a wider one (up to ``MAX_DENSE_QUBITS``)
    column-major at an even coefficient offset, so that a lane of the tiled
    op reads two adjacent rows' coefficients as one 16-byte load.
    ``max_bits`` is the largest block the caller's kernel holds: one CTA's
    shared memory, a cluster's for the whole-circuit kernel, or
    ``MAX_SWEEP_BITS`` of device memory for the sweep kernels.
    """
    if layout.kbits > max_bits:
        raise ValueError(
            f"a block of 2^{layout.kbits} amplitudes exceeds shared memory "
            f"(at most 2^{max_bits})"
        )
    head = np.zeros(SWEEP_HEADER, dtype=np.int32)
    inact = layout.inactive
    head[0] = len(pgates)
    head[1] = layout.blk_bits
    head[2] = len(layout.active)
    head[3] = len(inact)
    head[16:16 + len(layout.active)] = layout.active
    head[32:32 + len(inact)] = inact
    ops = np.zeros((len(pgates), OP_HEADER), dtype=np.int32)
    coefs: list[np.ndarray] = []
    n_coef = 0
    flops = 0.0
    max_core = 0
    for op, g in zip(ops, pgates):
        u = np.asarray(g.u, dtype=np.complex128)
        if _is_diagonal(u):
            m = len(g.qubits)
            if m > MAX_DIAG_QUBITS:
                raise NotImplementedError(
                    f"diagonal gate on {m} qubits; the kernel takes at most "
                    f"{MAX_DIAG_QUBITS}"
                )
            op[0] = KIND_DIAG
            op[8:8 + m] = [layout.code(q) for q in g.qubits]
            c = np.diagonal(u)
            flops += min_flops(u, diagonal=True)
        else:
            ctrls, core, qs = _peel_controls(u, tuple(g.qubits))
            m = len(qs)
            if m > MAX_DENSE_QUBITS:
                raise ValueError(
                    f"dense gate core on {m} qubits; the tiled op takes at "
                    f"most MAX_DENSE_QUBITS = {MAX_DENSE_QUBITS}"
                )
            codes = [layout.code(q) for q in qs]
            if max(codes) >= EXT:
                raise ValueError(
                    f"gate on {g.qubits} moves a qubit outside the block "
                    f"{layout.active}"
                )
            op[0] = KIND_DENSE
            for q in ctrls:
                cq = layout.code(q)
                if cq < EXT:
                    op[3] |= 1 << cq
                    op[4] |= 1 << cq
                else:
                    op[5] |= 1 << q
                    op[6] |= 1 << q
            op[8:8 + m] = codes
            if m <= SORTED_WORDS:
                op[24:24 + m] = sorted(codes)
            if m < TILE_CORE:
                c = core.reshape(-1)
            else:
                c = core.T.reshape(-1)
                if n_coef % 2:       # 16-byte aligned for cp.async
                    coefs.append(np.zeros(1, np.complex128))
                    n_coef += 1
            max_core = max(max_core, m)
            # on the 2^-len(ctrls) share of amplitudes the controls pass
            flops += min_flops(core, diagonal=False) / (1 << len(ctrls))
        op[1] = m
        op[2] = n_coef
        coefs.append(c)
        n_coef += c.size
    head[HEADER_MAX_CORE] = max_core
    flat = np.concatenate(coefs) if coefs else np.zeros(1, np.complex128)
    coef = np.stack([flat.real, flat.imag], axis=1).astype(np.float32)
    return OpTable(
        np.concatenate([head, ops.reshape(-1)]), np.ascontiguousarray(coef),
        flops, max_core,
    )


# the libraries whose wide instances hold ops.cuh's tiled op
TILED_OP_LIBRARIES = ("grid_sweep", "segment", "sweep")


def tiled_op_sass() -> dict[str, dict[str, int]]:
    """Per wide kernel instance (keyed library:mangled name) of the built
    grid_sweep, segment and sweep libraries, from ``cuobjdump -sass``: the
    tensor-core products (HMMA), float32 FMAs (FFMA) and instructions of
    its tiled op, ops.cuh's ``apply_dense_tiled``, which is not inlined: the
    code from the first CALL target on, after the kernel's own; and the
    HMMA of the kernel's own code. The op multiplies on the tensor cores:
    its code holds HMMA and no FFMA, the kernel's own no HMMA. Needs
    ``nvcc`` (it builds the libraries)."""
    from . import _build

    out = {}
    for lib in TILED_OP_LIBRARIES:
        for fn, body in _build.sass_listing(lib).items():
            if f"Li{MAX_DENSE_QUBITS}E" not in fn:      # the narrow instances hold no tiled op
                continue
            calls = [int(a, 16) for _, op, a in body if op == "CALL" and a.startswith("0x")]
            start = min(calls) if calls else None
            op_code = [op for addr, op, _ in body if start is not None and addr >= start]
            own = [op for addr, op, _ in body if start is None or addr < start]
            out[f"{lib}:{fn}"] = {"HMMA": op_code.count("HMMA"), "FFMA": op_code.count("FFMA"),
                                  "instructions": len(op_code), "kernel_HMMA": own.count("HMMA"),
                                  "calls": len(calls)}
    return out


def check_tile(max_core: int, threads: int) -> None:
    """Raise ValueError unless a launch of ``threads`` threads per CTA can run
    a table whose widest dense core is ``max_core`` (ops.cuh's
    ``threads_fit_core``: the tiled op needs a power of two with 2^max_core
    <= 4 x threads)."""
    if max_core < TILE_CORE:
        return
    if threads & (threads - 1) or (1 << max_core) > 4 * threads:
        raise ValueError(
            f"a {max_core}-qubit core needs a power of two of at least "
            f"{(1 << max_core) // 4} threads per CTA, got {threads}"
        )


def apply_pgates(state: torch.Tensor, pgates: list[PGate]) -> torch.Tensor:
    """The kernels' plain version: ``pgates`` one by one through the torch
    engine, in the order the op table applies them."""
    rdtype = np.float32
    for g in pgates:
        if _is_diagonal(g.u):
            dr, di = ap.split_matrix(np.diagonal(g.u), rdtype)
            state = ap.apply_diagonal(state, dr, di, g.qubits)
        else:
            ur, ui = ap.split_matrix(g.u, rdtype)
            state = ap.apply_unitary(state, ur, ui, g.qubits)
    return state


def check_planes(state: torch.Tensor, n: int, what: str) -> None:
    """Raise ValueError unless ``state`` is (2, 2^n) float32 planes."""
    if tuple(state.shape) != (2, 1 << n):
        raise ValueError(f"state shape {tuple(state.shape)} != (2, {1 << n})")
    if state.dtype != torch.float32:
        raise ValueError(f"the {what} path is float32-only")


def check_kernel_inputs(
    state: torch.Tensor, ints: torch.Tensor, coef: torch.Tensor,
) -> int:
    """Raise ValueError unless ``state`` is contiguous (2, 2^n) float32
    planes on a CUDA device and ``ints``/``coef`` contiguous int32/float32
    tables on the same device; return n."""
    if not state.is_cuda or state.dtype != torch.float32:
        raise ValueError("the kernel takes a float32 CUDA state")
    dim = state.shape[-1]
    if (
        state.dim() != 2 or state.shape[0] != 2 or dim & (dim - 1)
        or not state.is_contiguous()
    ):
        raise ValueError(
            f"state must be contiguous (2, 2^n) planes, got {tuple(state.shape)}"
        )
    for t, dt in ((ints, torch.int32), (coef, torch.float32)):
        if t.device != state.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("op tables must be contiguous, typed, on the state's device")
    return int(dim).bit_length() - 1


# ---------------------------------------------------------------------------
# Whole-circuit route: csrc/sweep.cu over the whole state as one unit
# ---------------------------------------------------------------------------

MIN_WHOLE_CIRCUIT_QUBITS = 10   # as the JAX package's MIN_PALLAS_QUBITS
MAX_WHOLE_CIRCUIT_QUBITS = 18   # the JAX package's policy ceiling
# sweep.cu's wide instance (a table with a tiled core) takes at most 512
# threads of 16 amplitudes
WIDE_TILE_BITS = 13
# qubits -> (tile bits T, CTAs of the launch's one group), chosen on the H100
# with ``python -m tpu_qsim_torch.kernels.tune_small`` (PERF.md): one CTA a
# tile; a tile of 2^11 slots (128 threads) from 13 qubits on, where more CTAs
# beat fewer stages; at 18 qubits 2^12 ties it in 4 stages instead of 5
GEOMETRY = {
    10: (10, 1), 11: (11, 1), 12: (12, 1), 13: (11, 4), 14: (11, 8),
    15: (11, 16), 16: (11, 32), 17: (11, 64), 18: (12, 64),
}


def whole_circuit(
    state: torch.Tensor,
    ints: torch.Tensor,
    coef: torch.Tensor,
    tile_bits: int,
    threads: int,
    ctas: int,
    max_core: int = MAX_DENSE_QUBITS,
) -> torch.Tensor:
    """Launch the whole-circuit kernel on ``state`` (in place): one launch of
    ``csrc/sweep.cu``'s low-sweep kernel over the whole state as one unit.

    ``ints``/``coef`` are the device copies of the circuit's
    ``sweeps.sweep_table`` over ``BlockLayout(n, n, ())`` with tiles of
    ``2^tile_bits`` slots, ``max_core`` its widest dense core (the kernel
    instance for narrow cores is launched when it is at most 4). Each CTA
    has ``threads`` threads: 16 amplitudes of a tile each, or more where a
    unit stage's tiled op needs them (2^max_core <= 4 x threads), the other
    warps then idle in the tile stages. The launch takes ``ctas`` CTAs (a
    power of two), fewer where the state has fewer tiles or the card keeps
    fewer resident. Launches on the current stream without synchronizing
    and raises on a refused launch.
    """
    from . import _build
    from .gridsweeps import MIN_GRID_BLOCK_BITS, REG_BITS
    from .sweeps import MAX_TILE_BITS, resident_ctas

    n = check_kernel_inputs(state, ints, coef)
    tile_threads = 1 << (tile_bits - REG_BITS)
    if not MIN_GRID_BLOCK_BITS <= tile_bits <= min(n, MAX_TILE_BITS):
        raise ValueError(f"tile bits {tile_bits} outside {MIN_GRID_BLOCK_BITS}..{min(n, MAX_TILE_BITS)}")
    if threads < tile_threads or threads & (threads - 1) or ctas < 1 or ctas & (ctas - 1):
        raise ValueError(
            f"{threads} threads x {ctas} CTAs: both powers of two, at least "
            f"{tile_threads} threads for 2^{tile_bits}-slot tiles"
        )
    spare = threads > tile_threads
    resident = resident_ctas(state.device, threads, max_core > NARROW_CORE, spare)
    group = min(ctas, 1 << (n - tile_bits), resident)
    if group < 1:
        raise RuntimeError("the card cannot keep one whole-circuit CTA resident")
    lib = _build.library("sweep")
    barrier = torch.empty(1, dtype=torch.int32, device=state.device)
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.sweep_launch(
            0, state.data_ptr(), 1 << n, ints.data_ptr(), coef.data_ptr(), n,
            barrier.data_ptr(), 1, group.bit_length() - 1, threads, max_core,
            int(spare), stream,
        )
    _build.check("sweep", lib, err, "whole_circuit launch")
    LAUNCHES["whole_circuit"] += 1
    return state


class WholeCircuitProgram:
    """The whole circuit as one launch of the whole-circuit kernel.

    The counterpart of ``build_pallas_run`` (10-18 qubits), whose state
    stays in VMEM for the whole circuit. Here the state (2-8 MB at 18
    qubits) stays in L2: the merged gate list is cut into :attr:`stages`
    by ``sweeps.plan_stages`` over the whole state as one unit, runs of ops
    whose moving bits fit a ``2^tile_bits``-slot tile run in registers tile
    by tile (one pass over the state), a dense core of ``TILE_CORE`` qubits
    or more is a pass of the tiled op, and one group of :attr:`ctas` CTAs
    meets at a barrier only between stages (``sweeps.sweep_table``,
    ``csrc/sweep.cu``). ``run`` maps (2, 2^n) float32 planes to planes: on
    a CUDA tensor it launches the kernel once, in place; on a CPU tensor it
    runs the plain version, :meth:`run_plain`. ``tile_bits`` and ``ctas``
    default to the card's table :data:`GEOMETRY`; a table with a tiled core
    takes tiles of at most ``2^WIDE_TILE_BITS`` slots.
    """

    def __init__(
        self,
        circuit,
        tile_bits: int | None = None,
        ctas: int | None = None,
    ):
        from .gridsweeps import MIN_GRID_BLOCK_BITS, REG_BITS
        from .sweeps import MAX_TILE_BITS, moving_qubits, plan_stages, sweep_table

        n = circuit.num_qubits
        if not MIN_WHOLE_CIRCUIT_QUBITS <= n <= MAX_WHOLE_CIRCUIT_QUBITS:
            raise ValueError(
                f"the whole-circuit kernel takes {MIN_WHOLE_CIRCUIT_QUBITS}.."
                f"{MAX_WHOLE_CIRCUIT_QUBITS} qubits, got {n}"
            )
        t = GEOMETRY[n][0] if tile_bits is None else int(tile_bits)
        ctas = GEOMETRY[n][1] if ctas is None else int(ctas)
        if not MIN_GRID_BLOCK_BITS <= t <= MAX_TILE_BITS or ctas < 1 or ctas & (ctas - 1):
            raise ValueError(
                f"tiles of 2^{MIN_GRID_BLOCK_BITS}..2^{MAX_TILE_BITS} slots and a "
                f"power of two of CTAs, got 2^{t} and {ctas}"
            )
        self.num_qubits = n
        self.gates = merge_1q_chains(as_pgates(circuit.gates))
        widest = max((len(moving_qubits(g.u, g.qubits)) for g in self.gates), default=0)
        self.tile_bits = min(t, n, WIDE_TILE_BITS if widest >= TILE_CORE else n)
        self.layout = BlockLayout(n, n, ())
        self.stages = plan_stages(self.gates, self.layout, self.tile_bits)
        self.table = sweep_table(self.stages, self.layout, self.tile_bits)
        core = self.table.max_core
        self.threads = max(1 << (self.tile_bits - REG_BITS),
                           (1 << core) // 4 if core >= TILE_CORE else 0)
        check_tile(core, self.threads)
        self.ctas = min(ctas, 1 << (n - self.tile_bits))
        self._device_tables: dict[torch.device, tuple] = {}

    def _tables_on(self, device: torch.device) -> tuple:
        tabs = self._device_tables.get(device)
        if tabs is None:
            tabs = (torch.from_numpy(self.table.ints).to(device),
                    torch.from_numpy(self.table.coef).to(device))
            self._device_tables[device] = tabs
        return tabs

    def run(self, state: torch.Tensor) -> torch.Tensor:
        check_planes(state, self.num_qubits, "whole-circuit")
        if state.device.type == "cpu":
            return self.run_plain(state)
        if state.device.type != "cuda":
            raise ValueError(f"no whole-circuit kernel for device {state.device}")
        state = state.contiguous()
        ints, coef = self._tables_on(state.device)
        return whole_circuit(state, ints, coef, self.tile_bits, self.threads,
                             self.ctas, self.table.max_core)

    __call__ = run

    def run_plain(self, state: torch.Tensor) -> torch.Tensor:
        """The plain version: the merged gate list through the torch engine,
        op by op, as the kernel applies it."""
        check_planes(state, self.num_qubits, "whole-circuit")
        return apply_pgates(state, self.gates)

    def flops(self) -> float:
        """Real flops one run needs (from the op table)."""
        return float(self.table.flops_per_amp) * (1 << self.num_qubits)

    def bytes_moved(self) -> int:
        """Device-memory bytes one run must move: both float32 planes read
        and written once."""
        return 2 * 2 * 4 * (1 << self.num_qubits)
