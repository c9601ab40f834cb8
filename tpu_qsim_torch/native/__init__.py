"""The port's native host planner: ``fusion.cpp`` through :mod:`ctypes`.

The port's copy of the planners of ``tpu_qsim/native``. ``fusion.cpp``
holds the fusion planner (:func:`plan_groups_native`) and the grid-sweep
frontier scheduler (:func:`plan_grid_sweeps_native`).
:func:`tpu_qsim_torch.fusion.plan_groups` and
:func:`tpu_qsim_torch.kernels.gridsweeps.plan_grid_sweeps` call it; the
Python planners stay beside them as the plain versions the tests hold it
against. The JAX package's schedule depth and sample histogram are not
copied: nothing in the port would call the depth (``Circuit.depth`` is
Python), and the port's histogram is ``np.unique`` over int64 samples, in
O(shots) memory, where the JAX counter holds one bin per basis state.

:func:`library` builds the source at first use with a plain ``g++ -O2
-std=c++17 -shared -fPIC`` subprocess into ``native/_build/`` (not tracked
by git), keyed by a hash of the source and the command, and loads it. A
build writes a temporary file and renames it into place, so processes that
build at once never load a half-written library. A failed build or load
raises RuntimeError with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fusion.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120
# the grid planner's moving-qubit masks are uint64
MAX_MASK_QUBITS = 64

_P = ctypes.c_void_p
# C function -> (restype, argtypes)
SIGNATURES = {
    # num_qubits, num_gates, gate_qubits, gate_offsets, max_fused, group_ids
    "qsim_plan_groups": (ctypes.c_int, [ctypes.c_int, ctypes.c_int, _P, _P, ctypes.c_int, _P]),
    # num_gates, gate_qubits, gate_offsets, classes, moving_masks, a_max,
    # max_gates, sweep_ids, emit_order
    "qsim_plan_grid_sweeps": (
        ctypes.c_int,
        [ctypes.c_int, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P],
    ),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# (seconds, compiler output) of the build this process made, if it made one
build_log: tuple[float, str] | None = None


def library_path() -> Path:
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(" ".join((CXX, *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libqsimnative_{key.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``fusion.cpp`` unless its library is already built."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{CXX} could not build {SOURCE.name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{CXX} failed ({proc.returncode}) for {SOURCE.name}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_log = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def library() -> ctypes.CDLL:
    """The loaded library with its functions' types set, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load {path}: {e}") from e
            for fn, (restype, argtypes) in SIGNATURES.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _lib = lib
        return _lib


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _flatten(gate_qubit_lists) -> tuple[np.ndarray, np.ndarray]:
    """(flat qubits, offsets): gate g's qubits are flat[offsets[g]:offsets[g + 1]].
    ``flat`` holds at least one element, so its pointer is never null."""
    lens = np.fromiter((len(qs) for qs in gate_qubit_lists), dtype=np.int32,
                       count=len(gate_qubit_lists))
    offsets = np.zeros(len(lens) + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    flat = np.zeros(max(int(offsets[-1]), 1), dtype=np.int32)
    flat[:offsets[-1]] = [q for qs in gate_qubit_lists for q in qs]
    return flat, offsets


def plan_groups_native(
    num_qubits: int, gate_qubit_lists, max_fused: int
) -> list[list[int]]:
    """Fusion groups as lists of gate indices, the same as
    :func:`tpu_qsim_torch.fusion._plan_groups_python`. Raises ValueError on
    a qubit outside ``[0, num_qubits)``, more than 63 qubits, or
    ``max_fused < 1``."""
    lib = library()
    flat, offsets = _flatten(gate_qubit_lists)
    n = len(gate_qubit_lists)
    out = np.zeros(max(n, 1), dtype=np.int32)
    ngroups = lib.qsim_plan_groups(num_qubits, n, _ptr(flat), _ptr(offsets),
                                   max_fused, _ptr(out))
    if ngroups < 0:
        raise ValueError("native planner rejected the circuit")
    members: list[list[int]] = [[] for _ in range(ngroups)]
    for gi, grp in enumerate(out[:n].tolist()):
        members[grp].append(gi)
    return members


def plan_grid_sweeps_native(
    gate_qubit_lists,
    gate_class_lists,
    moving_masks: list[int],
    a_max: int,
    max_gates: int,
) -> list[list[int]]:
    """Gate indices of each sweep, in emission order: the frontier scheduler
    may pull a later gate forward past gates it commutes with, so the order
    within a sweep is not ascending. The same as
    :func:`tpu_qsim_torch.kernels.gridsweeps._frontier_sweeps_python`.
    Raises ValueError on a qubit of 64 or more and on a gate whose moving
    mask exceeds ``a_max``."""
    lib = library()
    flat, offsets = _flatten(gate_qubit_lists)
    classes = np.zeros(flat.size, dtype=np.int8)
    cls = [c for cs in gate_class_lists for c in cs]
    if len(cls) != offsets[-1]:
        raise ValueError("gate_class_lists must align with gate_qubit_lists")
    classes[:len(cls)] = cls
    n = len(gate_qubit_lists)
    masks = np.zeros(max(n, 1), dtype=np.uint64)
    masks[:n] = moving_masks
    sweep_ids = np.zeros(max(n, 1), dtype=np.int32)
    emit_order = np.zeros(max(n, 1), dtype=np.int32)
    nsweeps = lib.qsim_plan_grid_sweeps(
        n, _ptr(flat), _ptr(offsets), _ptr(classes), _ptr(masks),
        a_max, max_gates, _ptr(sweep_ids), _ptr(emit_order),
    )
    if nsweeps < 0:
        raise ValueError("native grid planner rejected the gate list")
    members: list[list[int]] = [[] for _ in range(nsweeps)]
    ids = sweep_ids.tolist()
    for gi in emit_order[:n].tolist():
        members[ids[gi]].append(gi)
    return members

