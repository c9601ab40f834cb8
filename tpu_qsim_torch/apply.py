"""Torch general engine on split real/imaginary planes.

The port's counterpart of ``tpu_qsim/apply.py``. The state is one real tensor
of shape ``(2, 2^n)``: axis 0 is the [real, imag] plane, axis 1 the flat
amplitude index with qubit ``q`` at bit ``q`` (little-endian, see
:mod:`tpu_qsim_torch.gates`). Complex arithmetic is written out in real ops,
so one representation serves this engine and the CUDA grid-sweep kernel.

A k-qubit gate reshapes the flat state into at most ``2k+2`` merged segments
(each contiguous run of non-target qubits is one axis), matricizes with one
permute and applies a ``(2^k, 2^k) @ (2^k, rest)`` matmul. Diagonal gates are
a broadcast multiply. This engine is the route below 20 qubits and in float64,
as XLA is in the JAX package, and the plain version of the grid-sweep kernel.

The gate functions also take a batch of states, ``(B, 2, 2^n)`` (trajectory
batches, parameter sweeps): one matrix for every state folds the batch into
the matmul's columns; a ``(B, 2^k, 2^k)`` stack of matrices (or a ``(B, 2^k)``
stack of diagonals) gives each state its own in one batched matmul. Matrices
may be numpy constants or torch tensors; a tensor is used as it is (it may
require a gradient), so a caller that applies a matrix many times moves it to
the device once.
"""

from __future__ import annotations

import numpy as np
import torch

_RDTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. A CUDA device with no card present raises:
    the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def torch_dtype(rdtype) -> torch.dtype:
    """numpy real dtype (float32/float64) -> torch dtype."""
    return _RDTYPES[np.dtype(rdtype)]


# ---------------------------------------------------------------------------
# Host <-> device representation
# ---------------------------------------------------------------------------

def num_qubits_of(state: torch.Tensor) -> int:
    return int(state.shape[-1]).bit_length() - 1


def to_complex(state: torch.Tensor) -> np.ndarray:
    """Device planes -> host complex (readback boundary only)."""
    flat = state.detach().cpu().numpy()
    ctype = np.complex64 if flat.dtype == np.float32 else np.complex128
    out = np.empty(flat.shape[-1], dtype=ctype)
    out.real = flat[0]
    out.imag = flat[1]
    return out


def from_complex(amplitudes: np.ndarray, rdtype, device) -> torch.Tensor:
    """Host complex -> device planes (2, 2^n)."""
    amplitudes = np.asarray(amplitudes).reshape(-1)
    planes = np.stack([amplitudes.real, amplitudes.imag]).astype(rdtype)
    return torch.from_numpy(planes).to(device)


def split_matrix(mat: np.ndarray, rdtype) -> tuple[np.ndarray, np.ndarray | None]:
    """Split a complex matrix into (real, imag-or-None) host constants."""
    ur = np.ascontiguousarray(mat.real.astype(rdtype))
    if np.any(mat.imag != 0.0):
        return ur, np.ascontiguousarray(mat.imag.astype(rdtype))
    return ur, None


def initial_state(
    num_qubits: int, rdtype, index: int = 0, device=None
) -> torch.Tensor:
    """|index> as (2, 2^n) planes on ``device``."""
    state = torch.zeros(
        (2, 1 << num_qubits), dtype=torch_dtype(rdtype),
        device=resolve_device(device),
    )
    state[0, index] = 1.0
    return state


def _const(m, like: torch.Tensor) -> torch.Tensor:
    if isinstance(m, torch.Tensor):
        return m.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(m), dtype=like.dtype).to(like.device)


def device_matrix(m, rdtype, device) -> torch.Tensor | None:
    """A host constant (or None) as a tensor on ``device``, made once by a
    planner so that applying it later copies nothing from the host."""
    if m is None:
        return None
    return torch.as_tensor(np.asarray(m), dtype=torch_dtype(rdtype)).to(device)


def exact_matmuls(t: torch.Tensor) -> None:
    """Keep the card's float32 matmuls off TF32: the reference contracts at
    Precision.HIGHEST, and TF32 keeps ~3 digits."""
    if t.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Segment-reshape machinery
# ---------------------------------------------------------------------------

def _segments(n: int, qubits: tuple[int, ...]) -> tuple[list[int], dict[int, int]]:
    """Reshape plan: split the 2^n flat axis so each target qubit has its own
    size-2 axis and every contiguous run of non-target qubits is one merged
    axis. Returns (shape, {qubit: axis}). Axis 0 is the MSB side.
    """
    tpos = {n - 1 - q: q for q in qubits}  # position from left -> qubit
    shape: list[int] = []
    ax_of_qubit: dict[int, int] = {}
    i = 0
    while i < n:
        if i in tpos:
            ax_of_qubit[tpos[i]] = len(shape)
            shape.append(2)
            i += 1
        else:
            j = i
            while j < n and j not in tpos:
                j += 1
            shape.append(1 << (j - i))
            i = j
    return shape, ax_of_qubit


def apply_unitary(
    state: torch.Tensor,
    ur: np.ndarray | torch.Tensor,
    ui: np.ndarray | torch.Tensor | None,
    qubits: tuple[int, ...],
) -> torch.Tensor:
    """Apply a dense k-qubit matrix U = ur + i*ui to (2, 2^n) planes, or to
    each state of a (B, 2, 2^n) batch.

    ``qubits[0]`` is the matrix-index MSB. One permute in, one matmul over
    both planes, one permute out. Real U (ui None) costs a single matmul. A
    (B, 2^k, 2^k) U applies its b-th matrix to the b-th state.
    """
    exact_matmuls(state)
    lead = state.shape[:-2]
    nb = len(lead)
    n = num_qubits_of(state)
    k = len(qubits)
    shape, axmap = _segments(n, qubits)
    x = state.reshape(list(lead) + [2] + shape)
    mr = _const(ur, state)
    per_state = mr.dim() == 3
    taxes = [nb + 1 + axmap[q] for q in qubits]      # axes in matrix-bit order
    rest = [a for a in range(nb + 1, x.dim()) if a not in taxes]
    # plane axis right after the targets: columns are plane * R + rest (a
    # batch under one matrix joins the rest; under its own, it leads)
    if per_state:
        perm = [0] + taxes + [nb] + rest
    else:
        perm = taxes + [nb] + list(range(nb)) + rest
    xt = x.permute(perm)
    tshape = xt.shape
    xt = xt.reshape(lead[0], 1 << k, -1) if per_state else xt.reshape(1 << k, -1)

    yr = mr @ xt                                     # [re | im] columns
    if ui is None:
        y = yr
    else:
        half = xt.shape[-1] // 2
        yi = _const(ui, state) @ xt
        del xt
        y = torch.cat(
            [yr[..., :half] - yi[..., half:], yr[..., half:] + yi[..., :half]],
            dim=-1,
        )
        del yr, yi
    inv = np.argsort(perm).tolist()
    return y.reshape(tshape).permute(inv).reshape(state.shape)


def apply_diagonal(
    state: torch.Tensor,
    dr: np.ndarray | torch.Tensor,
    di: np.ndarray | torch.Tensor | None,
    qubits: tuple[int, ...],
) -> torch.Tensor:
    """Apply a diagonal k-qubit matrix given its (2^k,) diagonal d = dr+i*di
    to (2, 2^n) planes, or to each state of a (B, 2, 2^n) batch (a (B, 2^k)
    diagonal gives each state its own).

    Broadcast multiply on the segment reshape: no permute, no matmul.
    """
    lead = state.shape[:-2]
    nb = len(lead)
    n = num_qubits_of(state)
    k = len(qubits)
    shape, axmap = _segments(n, qubits)
    x = state.reshape(list(lead) + [2] + shape)

    # axis j of the (2,)*k diag tensor belongs to qubits[j]; place each on
    # its segment axis (a per-state diagonal keeps its batch axis in front)
    dt_r = _const(dr, state)
    per_state = dt_r.dim() == 2
    bshape = [1] * x.dim()
    if per_state:
        bshape[0] = lead[0]
    for q in qubits:
        bshape[nb + 1 + axmap[q]] = 2
    order = sorted(range(k), key=lambda j: axmap[qubits[j]])
    if per_state:
        order = [0] + [1 + o for o in order]

    def placed(d: torch.Tensor) -> torch.Tensor:
        return d.reshape(d.shape[:-1] + (2,) * k).permute(order).reshape(bshape)

    dt_r = placed(dt_r)
    if di is None:
        y = x * dt_r
    else:
        dt_i = placed(_const(di, state))
        re, im = x.select(nb, 0), x.select(nb, 1)
        dr0, di0 = dt_r.select(nb, 0), dt_i.select(nb, 0)
        y = torch.stack([re * dr0 - im * di0, im * dr0 + re * di0], dim=nb)
    return y.reshape(state.shape)


def permute_qubits(state: torch.Tensor, src: tuple[int, ...]) -> torch.Tensor:
    """Relabel index bits: new index bit ``i`` = old index bit ``src[i]``.

    The counterpart of ``tpu_qsim/apply.py::permute_qubits`` and the plain
    version of the segment kernels' gather and scatter maps. The JAX
    function refuses to move bits 0..6, which are the TPU's 128-lane axis;
    nothing here depends on that layout, so any permutation of ``range(n)``
    is taken. Each maximal run of unmoved bits stays one axis of the
    transpose, so the copy has at most ``2 * moved + 1`` axes.
    """
    n = num_qubits_of(state)
    src = tuple(int(s) for s in src)
    if sorted(src) != list(range(n)):
        raise ValueError("src must be a permutation of range(n)")
    moved = {i for i in range(n) if src[i] != i}
    if not moved:
        return state
    shape: list[int] = []
    axis_of_bit: dict[int, int] = {}
    slot_bit: list[int | None] = []     # per axis: the exposed bit, or None
    i = n - 1
    while i >= 0:
        if i in moved:
            axis_of_bit[i] = len(shape)
            slot_bit.append(i)
            shape.append(2)
            i -= 1
        else:
            j = i
            while j >= 0 and j not in moved:
                j -= 1
            slot_bit.append(None)
            shape.append(1 << (i - j))
            i = j
    # the axis that holds new bit b takes the old axis of bit src[b]; the
    # moved set is closed under src, so every such axis exists
    perm = [0] + [
        1 + (axis_of_bit[src[b]] if b is not None else k)
        for k, b in enumerate(slot_bit)
    ]
    return state.reshape([2] + shape).permute(perm).reshape(2, 1 << n)


# ---------------------------------------------------------------------------
# Readout / measurement primitives
# ---------------------------------------------------------------------------

def probabilities(state: torch.Tensor) -> torch.Tensor:
    """|amplitude|^2 (2^n,)."""
    return state[0] * state[0] + state[1] * state[1]


def total_probability(state: torch.Tensor) -> torch.Tensor:
    return torch.sum(state * state)


def inner_product(
    a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """<a|b> = (re, im) from two planes states."""
    ar, ai = a[0], a[1]
    br, bi = b[0], b[1]
    re = torch.dot(ar, br) + torch.dot(ai, bi)
    im = torch.dot(ar, bi) - torch.dot(ai, br)
    return re, im


def qubit_marginal(state: torch.Tensor, qubit: int) -> torch.Tensor:
    """P(qubit = 1) via an on-device reduction over the half of the index
    space with that bit set (a strided view: no index mask)."""
    n = num_qubits_of(state)
    v = state.reshape(2, 1 << (n - qubit - 1), 2, 1 << qubit)[:, :, 1]
    return torch.sum(v * v)


def collapse(
    state: torch.Tensor, qubit: int, outcome: int, p_outcome: float
) -> torch.Tensor:
    """Project onto ``qubit == outcome`` and renormalize."""
    n = num_qubits_of(state)
    v = state.reshape(2, 1 << (n - qubit - 1), 2, 1 << qubit)
    out = torch.zeros_like(v)
    norm = 1.0 / np.sqrt(max(p_outcome, np.finfo(np.float64).tiny))
    out[:, :, outcome] = v[:, :, outcome] * norm
    return out.reshape(2, 1 << n)
