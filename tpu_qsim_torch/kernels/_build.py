"""Build and load the CUDA kernels with a plain ``nvcc`` subprocess.

Each ``csrc/*.cu`` source is compiled into a shared library with a plain C
interface and loaded with :mod:`ctypes`: no ``torch.utils.cpp_extension``,
no ninja and no PyTorch headers, so a build takes seconds. Libraries land in
``kernels/_build/`` (not tracked by git), keyed by a hash of the source and
the compiler flags, so the first call on a fresh checkout builds and later
calls reuse the library. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-arch=sm_90a", "-Xcompiler", "-fPIC", "-shared",
    "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of builds made by this process
build_log: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(
        cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {name}.cu:\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    build_log[name] = (time.perf_counter() - t0, proc.stdout + proc.stderr)
    return out


def grid_sweep_library() -> ctypes.CDLL:
    """The loaded, bound library of ``csrc/grid_sweep.cu``, built on first
    use."""
    with _lock:
        lib = _libs.get("grid_sweep")
        if lib is None:
            lib = ctypes.CDLL(str(build("grid_sweep")))
            lib.grid_sweep_launch.argtypes = [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p,
            ]
            lib.grid_sweep_launch.restype = ctypes.c_int
            lib.grid_sweep_error_string.argtypes = [ctypes.c_int]
            lib.grid_sweep_error_string.restype = ctypes.c_char_p
            _libs["grid_sweep"] = lib
        return lib
