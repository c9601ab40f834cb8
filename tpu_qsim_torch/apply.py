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
    return torch.as_tensor(np.asarray(m), dtype=like.dtype).to(like.device)


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
    """Apply a dense k-qubit unitary U = ur + i*ui to (2, 2^n) planes.

    ``qubits[0]`` is the matrix-index MSB. One permute in, one matmul over
    both planes, one permute out. Real U (ui None) costs a single matmul.
    """
    if state.is_cuda:
        # the reference contracts at Precision.HIGHEST; TF32 keeps ~3 digits
        torch.backends.cuda.matmul.allow_tf32 = False
    n = num_qubits_of(state)
    k = len(qubits)
    shape, axmap = _segments(n, qubits)
    x = state.reshape([2] + shape)
    taxes = [1 + axmap[q] for q in qubits]           # axes in matrix-bit order
    rest = [a for a in range(x.dim()) if a != 0 and a not in taxes]
    # plane axis right after the targets: columns are plane * R + rest
    perm = taxes + [0] + rest
    xt = x.permute(perm)
    tshape = xt.shape
    xt = xt.reshape(1 << k, -1)                      # (2^k, 2R), [re | im] cols

    yr = _const(ur, state) @ xt
    if ui is None:
        y = yr
    else:
        half = xt.shape[1] // 2
        yi = _const(ui, state) @ xt
        del xt
        y = torch.cat(
            [yr[:, :half] - yi[:, half:], yr[:, half:] + yi[:, :half]], dim=1
        )
        del yr, yi
    inv = np.argsort(perm).tolist()
    return y.reshape(tshape).permute(inv).reshape(2, 1 << n)


def apply_diagonal(
    state: torch.Tensor,
    dr: np.ndarray | torch.Tensor,
    di: np.ndarray | torch.Tensor | None,
    qubits: tuple[int, ...],
) -> torch.Tensor:
    """Apply a diagonal k-qubit unitary given its (2^k,) diagonal d = dr+i*di.

    Broadcast multiply on the segment reshape: no permute, no matmul.
    """
    n = num_qubits_of(state)
    k = len(qubits)
    shape, axmap = _segments(n, qubits)
    x = state.reshape([2] + shape)

    # axis j of the (2,)*k diag tensor belongs to qubits[j]; place each on
    # its segment axis
    bshape = [1] * x.dim()
    for q in qubits:
        bshape[1 + axmap[q]] = 2
    order = sorted(range(k), key=lambda j: axmap[qubits[j]])
    dt_r = _const(dr, state).reshape((2,) * k).permute(order).reshape(bshape)
    if di is None:
        y = x * dt_r
    else:
        dt_i = _const(di, state).reshape((2,) * k).permute(order).reshape(bshape)
        re, im = x[0], x[1]
        y = torch.stack(
            [re * dt_r[0] - im * dt_i[0], im * dt_r[0] + re * dt_i[0]]
        )
    return y.reshape(2, 1 << n)


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
