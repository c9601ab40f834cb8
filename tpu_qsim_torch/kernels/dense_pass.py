"""Dense cores wider than the op table's tiled op: one whole-state pass.

A gate whose core (its control layers peeled, as ``build_op_table`` peels
them) has more than ``MAX_DENSE_QUBITS`` qubits cannot ride a block
kernel's op table: the core is 128 MB or more of complex64 coefficients, and
an op inside a block kernel would reread it for every block. The JAX package
multiplies such a core inside its kernels (``fused_circuit.py::
_emit_gate_generic``, which has no width limit); here
:func:`kernels.dispatch.plan_run` splits the circuit at each such gate, and
:class:`DensePass` applies it between the route's launches with the
hand-written kernel ``csrc/dense_pass.cu``: Y = U X over the whole state, out
of place into a second state buffer (:func:`dense_pass`), on the tensor cores
with every operand split into two TF32 parts (3xTF32).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import apply as ap
from . import LAUNCHES
from .fused_circuit import MAX_DENSE_QUBITS, PGate, _is_diagonal, _peel_controls, check_planes

# the kernel takes cores of at least 2^7 rows (a tile of its large
# instance, a chunk of its small one); the route sends it only cores wider
# than the tiled op's
MIN_PASS_CORE = 7
# dense_pass.cu's instances: (rows, groups) of a CTA's tile, and the
# launcher's number for each
INSTANCES = {"small": (32, 16), "medium": (32, 64), "large": (128, 64)}
INSTANCE_CODE = {"small": 0, "medium": 1, "large": 2}
# the large instance is taken when it makes at least this many CTAs (about
# one per SM of the H100's 132); with fewer, the medium one's 2^k / 32 row
# tiles keep more of the card streaming U
LARGE_MIN_CTAS = 128


def pass_instance(k: int, log2_groups: int) -> str:
    """Which of ``dense_pass.cu``'s instances runs a k-qubit core over
    2^log2_groups groups: "small" (32 x 16 tiles, U's bytes bound the pass)
    for 16 groups or fewer; "large" (128 x 64 tiles, the tensor cores' rate
    bounds it) when it fills the card; else "medium" (32 x 64 tiles)."""
    if log2_groups <= 4:
        return "small"
    rows, groups = INSTANCES["large"]
    tiles = ((1 << k) // rows) * max(1, (1 << log2_groups) // groups)
    return "large" if tiles >= LARGE_MIN_CTAS else "medium"


def pass_core(g: PGate, wider_than: int = MAX_DENSE_QUBITS) -> tuple | None:
    """(controls, core, core qubits) of a gate that takes a dense pass: a
    dense gate whose peeled core is wider than ``wider_than`` qubits (the
    split route: ``MAX_DENSE_QUBITS``; the sweeps route takes its unit
    stages of ``sweeps.MIN_SWEEP_PASS_CORE`` qubits and more here too); None
    for any other gate."""
    if len(g.qubits) <= wider_than or _is_diagonal(g.u):
        return None
    ctrls, core, qs = _peel_controls(g.u, tuple(g.qubits))
    return (tuple(ctrls), core, tuple(qs)) if len(qs) > wider_than else None


def core_operand(core: np.ndarray, qubits: tuple[int, ...]) -> np.ndarray:
    """The kernel's U: ``core`` (index MSB ``qubits[0]``, as every gate
    matrix) with its row and column index bits reordered so that bit j is the
    j-th lowest of ``qubits``, as (2, 2^k, 2^k) float32: the real and the
    imaginary plane, each row-major (the tensor cores' row-major A
    operand)."""
    k = len(qubits)
    order = sorted(qubits)
    # index j of the reordered core -> index of the gate's matrix
    src = np.zeros(1 << k, dtype=np.int64)
    for b, q in enumerate(order):
        src |= ((np.arange(1 << k) >> b) & 1) << (k - 1 - qubits.index(q))
    u = np.asarray(core)[np.ix_(src, src)]
    return np.ascontiguousarray(np.stack([u.real, u.imag]), dtype=np.float32)


def apply_controlled(
    state: torch.Tensor, core: np.ndarray, qubits: tuple[int, ...],
    controls: tuple[int, ...] = (),
) -> torch.Tensor:
    """The pass's plain version: the torch engine's ``apply_unitary`` of
    ``core`` on ``qubits`` (``qubits[0]`` the index MSB), on the amplitudes
    whose ``controls`` are all 1; the others unchanged."""
    rdtype = np.float32 if state.dtype == torch.float32 else np.float64
    ur, ui = ap.split_matrix(core, rdtype)
    if not controls:
        return ap.apply_unitary(state, ur, ui, qubits)
    n = ap.num_qubits_of(state)
    shape, axis = ap._segments(n, controls)
    sel = [slice(None)] * (1 + len(shape))
    for q in controls:
        sel[1 + axis[q]] = 1
    sel = tuple(sel)
    out = state.clone()
    view = out.reshape([2] + shape)
    sub = view[sel]
    # in the sub-state, qubit q is bit q less the controls below it
    inner = tuple(q - sum(c < q for c in controls) for q in qubits)
    y = ap.apply_unitary(sub.reshape(2, -1), ur, ui, inner)
    view[sel] = y.reshape(sub.shape)
    return out


def dense_pass(
    state: torch.Tensor, u: torch.Tensor, tmask: int, cmask: int = 0,
) -> torch.Tensor:
    """Launch the dense-pass kernel: a new (2, 2^n) float32 state (allocated
    here with ``torch.empty``) holding ``state`` after the core ``u`` (the
    device copy of :func:`core_operand`) on the bits of ``tmask``, where the
    bits of ``cmask`` are all 1; the instance :func:`pass_instance` picks.
    Raises ValueError on inputs the kernel does not take, RuntimeError when
    the card cannot hold the output buffer or the launch fails. Launches on
    the current stream without synchronizing."""
    from . import _build

    if not state.is_cuda or state.dtype != torch.float32:
        raise ValueError("the dense pass takes a float32 CUDA state")
    dim = state.shape[-1]
    if state.dim() != 2 or state.shape[0] != 2 or dim & (dim - 1) or not state.is_contiguous():
        raise ValueError(f"state must be contiguous (2, 2^n) planes, got {tuple(state.shape)}")
    k = bin(tmask).count("1")
    if (
        u.device != state.device or u.dtype != torch.float32 or not u.is_contiguous()
        or tuple(u.shape) != (2, 1 << k, 1 << k)
    ):
        raise ValueError(
            f"u must be a contiguous (2, 2^{k}, 2^{k}) float32 core on the state's device"
        )
    if k < MIN_PASS_CORE or tmask & cmask or (tmask | cmask) >= dim:
        raise ValueError(f"bad target mask {tmask:#x} / control mask {cmask:#x} for 2^{dim.bit_length() - 1} slots")
    try:     # the free-memory check is made once per core, in DensePass.u_on
        out = torch.empty_like(state)
    except torch.cuda.OutOfMemoryError as e:
        raise RuntimeError(
            f"the dense pass's output state needs {state.numel() * 4} B of device "
            f"memory, which the card cannot give"
        ) from e
    log2_groups = (dim.bit_length() - 1) - k - bin(cmask).count("1")
    instance = INSTANCE_CODE[pass_instance(k, log2_groups)]
    lib = _build.library("dense_pass")
    with torch.cuda.device(state.device):
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = lib.dense_pass_launch(
            state.data_ptr(), out.data_ptr(), dim, u.data_ptr(), k, tmask, cmask,
            cmask, instance, stream,
        )
    _build.check("dense_pass", lib, err, "dense_pass launch")
    LAUNCHES["dense_pass"] += 1
    return out


class DensePass:
    """One gate whose peeled core takes a dense pass (``found``, what
    :func:`pass_core` gives for it; by default the split route's, wider than
    ``MAX_DENSE_QUBITS``), as a step of a split run or a sweep's unit stage:
    ``run`` maps (2, 2^n) float32 planes to new planes, through
    :func:`dense_pass` on a CUDA tensor and :meth:`run_plain` on a CPU
    one."""

    def __init__(self, gate: PGate, n: int, found: tuple | None = None):
        found = found or pass_core(gate)
        if found is None:
            raise ValueError(f"gate on {gate.qubits} has no core wider than {MAX_DENSE_QUBITS} qubits")
        self.num_qubits = n
        self.controls, self.core, self.targets = found
        self.k = len(self.targets)
        self.tmask = sum(1 << q for q in self.targets)
        self.cmask = sum(1 << q for q in self.controls)
        self._u: dict[torch.device, torch.Tensor] = {}

    def u_on(self, device: torch.device) -> torch.Tensor:
        """The core's device copy, made once per device. Raises RuntimeError
        naming the bytes when the card cannot hold it and the output state."""
        u = self._u.get(device)
        if u is None:
            need = (8 << 2 * self.k) + (8 << self.num_qubits)
            free, _ = torch.cuda.mem_get_info(device)
            if need > free:
                raise RuntimeError(
                    f"a {self.k}-qubit dense pass at {self.num_qubits} qubits needs "
                    f"{need} B of device memory (the core and the output state); "
                    f"{free} B are free"
                )
            u = torch.from_numpy(core_operand(self.core, self.targets)).to(device)
            self._u[device] = u
        return u

    def run(self, state: torch.Tensor) -> torch.Tensor:
        check_planes(state, self.num_qubits, "dense pass")
        if state.device.type == "cpu":
            return self.run_plain(state)
        if state.device.type != "cuda":
            raise ValueError(f"no dense-pass kernel for device {state.device}")
        state = state.contiguous()
        return dense_pass(state, self.u_on(state.device), self.tmask, self.cmask)

    __call__ = run

    def run_plain(self, state: torch.Tensor) -> torch.Tensor:
        """The plain version (:func:`apply_controlled`)."""
        return apply_controlled(state, self.core, self.targets, self.controls)

    def flops(self) -> float:
        """Real flops of the product: 8 per complex multiply-add, 2^k of them
        per amplitude whose controls pass."""
        return 8.0 * (1 << self.k) * (1 << (self.num_qubits - len(self.controls)))

    def bytes_moved(self) -> int:
        """Device-memory bytes the pass must move: the core once, the state
        read and written once."""
        return (8 << 2 * self.k) + 16 * (1 << self.num_qubits)
