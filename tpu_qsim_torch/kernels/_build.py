"""Build and load the CUDA kernels with a plain ``nvcc`` subprocess.

Each ``csrc/<name>.cu`` source is compiled into a shared library with a
plain C interface and loaded with :mod:`ctypes` by :func:`library`: no
``torch.utils.cpp_extension``, no ninja and no PyTorch headers, so a build
takes seconds. Libraries land in ``kernels/_build/`` (not tracked by git),
keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and the
compiler flags, so the first call on a fresh checkout builds, a change to
``ops.cuh`` rebuilds every kernel, and later calls reuse the library.
:func:`build_all` starts one ``nvcc`` per source at once. A failed build
raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-arch=sm_90a", "-Xcompiler", "-fPIC", "-shared",
    "-Xptxas", "-v", "--split-compile=4",
)
# libraries whose kernels use sm_90a-only instructions (wgmma): -arch=sm_90a
# emits compute_90 PTX, which ptxas refuses them in
ARCH_FLAGS = {"dense_pass": ("-gencode", "arch=compute_90a,code=sm_90a")}
# libraries built from another library's source with a macro: the grid
# sweep's stamp instance (kernels/floor.py --stamps), which no main path
# builds or launches
VARIANTS = {"grid_sweep_stamps": ("grid_sweep", ("-DQSIM_STAMPS",))}


def source(name: str) -> Path:
    """The ``csrc/*.cu`` file library ``name`` is built from."""
    return CSRC / f"{VARIANTS.get(name, (name,))[0]}.cu"


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The flags library ``name`` is built with."""
    flags = NVCC_FLAGS + VARIANTS.get(name, (name, ()))[1]
    arch = ARCH_FLAGS.get(name)
    if arch is None:
        return flags
    return tuple(f for f in flags if f != "-arch=sm_90a") + arch
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


_P, _I, _U, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_longlong
# name -> {C function: argtypes}; every launch returns an int (cudaError_t)
# and every library has <name>_error_string(int) -> const char*
SIGNATURES: dict[str, dict[str, list]] = {
    "grid_sweep": {
        # state, dim, table, coef, kbits, steps, max_core, stream
        "grid_sweep_launch": [_P, _LL, _P, _P, _I, _LL, _I, _P],
    },
    "grid_sweep_stamps": {
        "grid_sweep_launch": [_P, _LL, _P, _P, _I, _LL, _I, _P],
        # ..., max_core, stamps, stamp_ctas, stamp_steps, one_per_sm, stream
        "grid_sweep_stamp_launch": [_P, _LL, _P, _P, _I, _LL, _I, _P, _I, _I, _I, _P],
    },
    "segment": {
        # local_bits, wide, int* ctas
        "segment_prepare": [_I, _I, _P],
        # a, b, dim, table, coef, barrier, first, last, local_bits, ctas,
        # max_core, stream
        "segment_launch": [_P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    },
    "sweep": {
        # threads, wide, spare, int* ctas
        "sweep_prepare": [_I, _I, _I, _P],
        # high, state, dim, table, coef, kbits, barriers, groups, group_bits,
        # threads, max_core, spare, stream
        "sweep_launch": [_I, _P, _LL, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    },
    "dense_pass": {
        # state, out, dim, u, k, tmask, cmask, cval, instance, stream
        "dense_pass_launch": [_P, _P, _LL, _P, _I, _U, _U, _U, _I, _P],
    },
    "rotation_chain": {
        # state, dim, (cos, sin) pairs, k, blk, active_mask, stream
        "rotation_chain_launch": [_P, _LL, _P, _I, _I, _U, _P],
    },
}


def library_path(name: str) -> Path:
    key = hashlib.sha256()
    key.update(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.name.encode() + header.read_bytes())
    key.update(" ".join(nvcc_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{key.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile library ``name`` (``csrc/<name>.cu``, or a variant's source)
    unless it is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *nvcc_flags(name), "-o", str(tmp), str(source(name))]
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


def build_all(names=tuple(SIGNATURES)) -> None:
    """Build every named library at once, one ``nvcc`` process each."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        for fut in [pool.submit(build, name) for name in names]:
            fut.result()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` with its functions' argument
    types set (pointers and the stream as ``c_void_p``), built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            err = getattr(lib, f"{source(name).stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(name: str, lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise RuntimeError when a launch function returned non-zero."""
    if err != 0:
        msg = getattr(lib, f"{source(name).stem}_error_string")(err).decode()
        raise RuntimeError(f"{what} failed: {msg} ({err})")


_SASS_LINE = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)(?:\.[A-Z0-9_]+)*\s*([^;]*);")


def sass_text(name: str) -> str:
    """``cuobjdump -sass`` of library ``name``'s build (built first)."""
    lib = build(name)
    tool = Path(_nvcc()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


def sass_listing(name: str) -> dict[str, list[tuple[int, str, str]]]:
    """Every function in the built library of ``csrc/<name>.cu`` (by mangled
    name) as its instructions, (address, opcode, operands), from
    ``cuobjdump -sass`` beside ``nvcc``. A device function that is not
    inlined is compiled into each kernel that calls it, after the caller's
    code, and reached by CALL."""
    sass = sass_text(name)
    out: dict[str, list[tuple[int, str, str]]] = {}
    body = None
    for line in sass.splitlines():
        if "Function :" in line:
            body = out.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = _SASS_LINE.search(line) if body is not None else None
        if m:
            body.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return out

