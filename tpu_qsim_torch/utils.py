"""Utilities: endianness adapters, fidelity metrics, timing and profiling.

The port of ``tpu_qsim/utils.py``. The library convention is qubit q <->
bit q (little-endian, Qiskit-like); Cirq orders its computational basis
big-endian, so comparisons against Cirq take the bit-reversal permutation
below. The JAX package's XLA compile options (``SCOPED_VMEM_KIB``,
``jit_scoped``, ``enable_persistent_compilation_cache``) have no counterpart
here: the port compiles its kernels once with ``nvcc`` and caches the
libraries by source hash (:mod:`tpu_qsim_torch.kernels._build`).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch


def bit_reversal_permutation(num_qubits: int) -> np.ndarray:
    """perm[i] = bit-reversed i over ``num_qubits`` bits.

    ``state_cirq = state_ours[perm]`` converts our little-endian amplitudes
    to Cirq's big-endian basis ordering (and the map is an involution).
    """
    dim = 1 << num_qubits
    idx = np.arange(dim)
    out = np.zeros(dim, dtype=np.int64)
    for b in range(num_qubits):
        out |= ((idx >> b) & 1) << (num_qubits - 1 - b)
    return out


def to_big_endian(state: np.ndarray, num_qubits: int) -> np.ndarray:
    """Reorder amplitudes from qubit0=LSB (ours/Qiskit) to qubit0=MSB (Cirq)."""
    return np.asarray(state)[bit_reversal_permutation(num_qubits)]


from_big_endian = to_big_endian  # bit reversal is an involution


def state_fidelity(a: np.ndarray, b: np.ndarray) -> float:
    """|<a|b>|^2 with normalization."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    na = np.linalg.norm(a)
    nb = np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(abs(np.vdot(a, b)) ** 2 / (na * nb) ** 2)


def max_amplitude_error(a: np.ndarray, b: np.ndarray, *, up_to_phase: bool = True) -> float:
    """Elementwise max |a - phase*b|, optionally aligning global phase."""
    a = np.asarray(a).ravel()
    b = np.asarray(b).ravel()
    if up_to_phase:
        i = int(np.argmax(np.abs(b)))
        if abs(b[i]) > 1e-12:
            ph = a[i] / b[i]
            if abs(ph) > 1e-12:
                # only ever align by a UNIT-modulus phase: applying the full
                # complex ratio would silently mask magnitude errors
                b = b * (ph / abs(ph))
    return float(np.max(np.abs(a - b)))


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sync_time(fn: Callable[[], object], *, repeats: int = 1) -> float:
    """Wall-clock seconds per call of ``repeats`` chained calls, the card
    synchronized before the first and after the last (CUDA launches return
    before the work is done)."""
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    _synchronize()
    return (time.perf_counter() - t0) / repeats


@contextlib.contextmanager
def profiler_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` over the block (CPU activity, and CUDA where a card
    is present); on exit the Chrome trace is written to
    ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def view_amp_summary(y: torch.Tensor, *, ends: int = 1) -> tuple[torch.Tensor, ...]:
    """Scalar amplitude summary of ``(2, 2^n)`` planes: ``(a0_re, a0_im,
    rest)`` for ``ends=1`` or ``(a0_re, a0_im, aN_re, aN_im, rest)`` for
    ``ends=2``, where ``rest`` is max |plane value| over every other
    amplitude's planes. Reductions on the device; no copy of the state.
    (The JAX package reads the grid engine's multi-axis view form; the
    port's engines keep the flat planes.)"""
    if ends not in (1, 2):
        raise ValueError(f"ends must be 1 or 2, got {ends}")
    last = y.shape[1] - 1
    rest = y[:, 1:last] if ends == 2 else y[:, 1:]
    rest = rest.abs().amax() if rest.numel() else y.new_zeros(())
    out = [y[0, 0], y[1, 0]]
    if ends == 2:
        out += [y[0, last], y[1, last]]
    return tuple(out) + (rest,)
