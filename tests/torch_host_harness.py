"""The port's CUDA kernel sources, built for the CPU and run there under
AddressSanitizer and UBSan.

``tpu_qsim_torch/kernels/csrc/*.cu`` and their headers are compiled by g++
as they stand, with ``QSIM_HOST`` defined: ``csrc/ptx.cuh`` then takes its
host twin from ``tests/host_kernels/include/`` (with a ``cuda_runtime.h``
of the same intrinsics), whose runtime (``tests/host_kernels/runtime.cpp``)
runs a CTA's threads as fibers, warp collectives as 32-lane barriers,
warpgroup collectives (``wgmma``) as 128-lane ones, shared memory as a
poisoned arena and a cooperative launch's CTAs one at a time, in an order
that turns back at every grid barrier. Each source is one translation unit;
with the runtime, ``tests/host_kernels/faults.cu`` (test-only kernels with
a fault each) and the driver ``tests/host_kernels/main.cpp`` they link
into one executable, ``qsim_host_run``: an instrumented library could not
be loaded into an uninstrumented Python.

The executable is built at first use into ``tests/host_kernels/_build/``
(not tracked by git), keyed by a hash of every source and the commands,
under a file lock so that parallel test workers build it once; a failed
build raises with g++'s output. :class:`HostRun` writes buffers and the
launchers' calls to a file, runs the executable on it with a timeout and
reads the buffers back; a sanitizer report, a trap or a deadlock raises
:class:`HostFault` with the report.

The ``run_*`` functions launch a planned program of the port as its
wrapper does on the card (the same op tables and launch arguments; each
``*_prepare`` answers for the runtime's device of two multiprocessors) and
return the result as complex128.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import struct
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "tpu_qsim_torch" / "kernels" / "csrc"
HOST = Path(__file__).resolve().parent / "host_kernels"
BUILD_DIR = HOST / "_build"
KERNELS = ("grid_sweep", "sweep", "segment", "dense_pass", "rotation_chain")
CXX = "g++"
SANITIZE = ("-fsanitize=address,undefined", "-fno-sanitize-recover=all")
FLAGS = ("-std=c++20", "-O1", "-g", *SANITIZE, "-fno-omit-frame-pointer", "-pthread",
         "-DQSIM_HOST", f"-I{HOST / 'include'}", f"-I{CSRC}", "-Wno-unknown-pragmas")
# the runtime, after FLAGS: optimised and not instrumented (its switches and
# collectives are the harness's hot loop; every access it makes for a kernel
# is checked in the kernel's own translation unit, qsim_host_ptx.h)
RUNTIME_FLAGS = ("-O2", "-fno-sanitize=all")
BUILD_TIMEOUT_S = 300
RUN_TIMEOUT_S = 240
ENV = {
    "ASAN_OPTIONS": "detect_leaks=0:halt_on_error=1:abort_on_error=0:exitcode=23",
    "UBSAN_OPTIONS": "halt_on_error=1:print_stacktrace=1",
}

class HostFault(RuntimeError):
    """The executable ended without its output: a sanitizer report, a trap
    or a deadlock (the message holds its standard error)."""


def _commands(tmp: Path) -> list[tuple[Path, list[str]]]:
    """(object file, g++ command) of each translation unit."""
    units = [(CSRC / f"{k}.cu", ("-x", "c++")) for k in KERNELS]
    units += [(HOST / "faults.cu", ("-x", "c++")), (HOST / "main.cpp", ()),
              (HOST / "runtime.cpp", RUNTIME_FLAGS)]
    out = []
    for src, extra in units:
        obj = tmp / f"{src.name}.o"
        out.append((obj, [CXX, *FLAGS, *extra, "-c", str(src), "-o", str(obj)]))
    return out


def executable_path() -> Path:
    key = hashlib.sha256()
    sources = [*sorted(CSRC.glob("*.cu*")), *sorted((HOST / "include").glob("*")),
               *sorted(p for p in HOST.glob("*") if p.is_file())]
    for p in sources:
        key.update(p.name.encode() + p.read_bytes())
    key.update(" ".join((CXX, *FLAGS, *RUNTIME_FLAGS)).encode())
    return BUILD_DIR / f"qsim_host_run_{key.hexdigest()[:16]}"


def executable() -> Path:
    """The built executable, built first if needed: one g++ per translation
    unit, all at once, then the link; one build for all the processes that
    ask at once."""
    out = executable_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            commands = _commands(Path(tmp))
            with ThreadPoolExecutor(max_workers=len(commands)) as pool:
                procs = list(pool.map(
                    lambda c: subprocess.run(c[1], capture_output=True, text=True,
                                             timeout=BUILD_TIMEOUT_S), commands))
            for (obj, _), proc in zip(commands, procs):
                if proc.returncode != 0:
                    raise RuntimeError(f"{CXX} failed ({proc.returncode}) for {obj.stem}:\n"
                                       f"{proc.stdout}{proc.stderr}")
            exe = Path(tmp) / "qsim_host_run"
            link = subprocess.run([CXX, *SANITIZE, "-pthread", *(str(o) for o, _ in commands),
                                   "-o", str(exe)], capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
            if link.returncode != 0:
                raise RuntimeError(f"{CXX} failed to link qsim_host_run:\n{link.stdout}{link.stderr}")
            os.replace(exe, out)
    return out


class Buf:
    """A buffer of a :class:`HostRun`, as a launcher's pointer argument."""

    def __init__(self, index: int):
        self.index = index


class HostRun:
    """Buffers and launcher calls for one run of the executable."""

    def __init__(self):
        self.arrays: list[np.ndarray] = []
        self.calls: list[tuple[str, tuple]] = []

    def buffer(self, array: np.ndarray) -> Buf:
        self.arrays.append(np.ascontiguousarray(array))
        return Buf(len(self.arrays) - 1)

    def call(self, name: str, *args) -> None:
        """Call the launcher ``name``: each argument an int, a :class:`Buf`
        or None (a null pointer, as the stream)."""
        self.calls.append((name, args))

    def _input(self) -> bytes:
        out = [b"QSIMHOST", struct.pack("<I", len(self.arrays))]
        for a in self.arrays:
            out += [struct.pack("<Q", a.nbytes), a.tobytes()]
        out.append(struct.pack("<I", len(self.calls)))
        for name, args in self.calls:
            out += [struct.pack("<I", len(name)), name.encode(), struct.pack("<I", len(args))]
            for a in args:
                if a is None:
                    out.append(struct.pack("<B", 2))
                elif isinstance(a, Buf):
                    out.append(struct.pack("<BI", 1, a.index))
                else:
                    out.append(struct.pack("<Bq", 0, int(a)))
        return b"".join(out)

    def run(self, timeout: float = RUN_TIMEOUT_S, sms: int | None = None) -> list[int]:
        """Run the calls in order, on a device of ``sms`` multiprocessors
        (by default the runtime's 2); return each call's result (a
        cudaError_t) and replace :attr:`arrays` by the buffers as the calls
        left them. Raises HostFault when the executable ends without its
        output."""
        exe = executable()
        with tempfile.TemporaryDirectory() as tmp:
            src, dst = Path(tmp) / "in", Path(tmp) / "out"
            src.write_bytes(self._input())
            proc = subprocess.run([str(exe), str(src), str(dst)], capture_output=True,
                                  text=True, timeout=timeout,
                                  env={**os.environ, **ENV,
                                       **({"QSIM_HOST_SMS": str(sms)} if sms else {})})
            if proc.returncode != 0 or not dst.exists():
                raise HostFault(f"qsim_host_run exited with {proc.returncode}:\n{proc.stderr[-20000:]}")
            data = dst.read_bytes()
        assert data[:8] == b"QSIMHOST"
        (n,) = struct.unpack_from("<I", data, 8)
        rcs = list(struct.unpack_from(f"<{n}i", data, 12))
        pos = 12 + 4 * n
        (nb,) = struct.unpack_from("<I", data, pos)
        pos += 4
        arrays = []
        for a in self.arrays:
            (size,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            assert size == a.nbytes
            arrays.append(np.frombuffer(data, a.dtype, a.size, pos).reshape(a.shape).copy())
            pos += size
        assert nb == len(arrays) and pos == len(data)
        self.arrays = arrays
        return rcs


def run_checked(run: HostRun, sms: int | None = None) -> None:
    """:meth:`HostRun.run`, raising RuntimeError where a launcher refused."""
    rcs = run.run(sms=sms)
    bad = [(name, rc) for (name, _), rc in zip(run.calls, rcs) if rc != 0]
    if bad:
        raise RuntimeError(f"launches refused: {bad}")


# ---------------------------------------------------------------------------
# the port's programs, launched as their wrappers launch them on the card
# ---------------------------------------------------------------------------

# (launcher, arguments) -> the resident CTAs it reports
_resident: dict[tuple, int] = {}


def resident(name: str, *args) -> int:
    """The CTAs ``name`` (``sweep_prepare`` or ``segment_prepare``) reports
    for the runtime's device, as the wrappers ask the card (once per
    process and arguments)."""
    key = (name, args)
    if key not in _resident:
        run = HostRun()
        ctas = run.buffer(np.zeros(1, np.int32))
        run.call(name, *args, ctas)
        run_checked(run)
        _resident[key] = int(run.arrays[ctas.index][0])
    return _resident[key]


def prepare(run: HostRun, name: str, *args) -> int:
    """:func:`resident`, with the call made in ``run`` too, before its
    launches, as the wrappers make it (it sets the kernel's shared-memory
    attribute)."""
    run.call(name, *args, run.buffer(np.zeros(1, np.int32)))
    return resident(name, *args)


def sweep_geometry(prog) -> list[list[tuple[int, int, int] | None]]:
    """Per sweep, (threads, groups, group_bits) of each of its launches
    (``SweepProgram.launches``), as ``sweeps._sweep`` sizes it for the
    launch's instance at the sweep's geometry (``SweepProgram.geometries``);
    None for a dense pass."""
    from tpu_qsim_torch.kernels import sweeps as ts
    from tpu_qsim_torch.kernels.fused_circuit import NARROW_CORE

    out = []
    for launches, lay, geo in zip(prog.launches, prog.layouts, prog.geometries):
        row = []
        for launch in launches:
            if launch.table is None:
                row.append(None)
                continue
            core = launch.max_core
            threads = ts.sweep_threads(geo, core, lay.kbits)
            ctas = resident("sweep_prepare", threads, int(core > NARROW_CORE), 0)
            row.append((threads, *ts.launch_grid(lay, geo, core, ctas)))
        out.append(row)
    return out


def planes(psi: np.ndarray) -> np.ndarray:
    """(2, dim) float32 planes of a complex state."""
    return np.stack([psi.real, psi.imag]).astype(np.float32)


def complex_of(x: np.ndarray) -> np.ndarray:
    return x[0].astype(np.float64) + 1j * x[1].astype(np.float64)


def _garbage(shape, dtype) -> np.ndarray:
    """What ``torch.empty`` may hand a launch: here every byte 0xFF (NaN in
    float32, -1 in int32)."""
    count = int(np.prod(shape)) * np.dtype(dtype).itemsize
    return np.full(count, 0xFF, np.uint8).view(dtype).reshape(shape)


def run_grid_sweep(prog, psi: np.ndarray) -> np.ndarray:
    """``GridSweepProgram.run``: one ``grid_sweep_launch`` a sweep."""
    run = HostRun()
    state = run.buffer(planes(psi))
    for table, lay in zip(prog.tables, prog.layouts):
        run.call("grid_sweep_launch", state, 1 << lay.n, run.buffer(table.ints),
                 run.buffer(table.coef), lay.kbits, 1 << len(lay.inactive), table.max_core, None)
    run_checked(run)
    return complex_of(run.arrays[state.index])


def run_sweeps(prog, psi: np.ndarray) -> np.ndarray:
    """``SweepProgram.run``: each sweep's launches in order, a cooperative
    ``sweep_launch`` at :func:`sweep_geometry` for each table, a
    ``dense_pass_launch`` into a new buffer for each pass."""
    from tpu_qsim_torch.kernels import dense_pass as dp
    from tpu_qsim_torch.kernels.fused_circuit import NARROW_CORE

    run = HostRun()
    state = run.buffer(planes(psi))
    n = prog.num_qubits
    for kind, launches, lay, geometry in zip(prog.sweep_kinds, prog.launches, prog.layouts,
                                             sweep_geometry(prog)):
        for launch, geo in zip(launches, geometry):
            if launch.table is None:
                step = launch.step
                out = run.buffer(_garbage((2, 1 << n), np.float32))
                cmask = step.cmask
                instance = dp.INSTANCE_CODE[dp.pass_instance(step.k, n - step.k - len(step.controls))]
                run.call("dense_pass_launch", state, out, 1 << n,
                         run.buffer(dp.core_operand(step.core, step.targets)), step.k, step.tmask,
                         cmask, cmask, instance, None)
                state = out
                continue
            threads, groups, group_bits = geo
            table = launch.table
            prepare(run, "sweep_prepare", threads, int(table.max_core > NARROW_CORE), 0)
            run.call("sweep_launch", int(kind == "high"), state, 1 << lay.n,
                     run.buffer(table.ints), run.buffer(table.coef), lay.kbits,
                     run.buffer(_garbage(groups, np.int32)), groups, group_bits, threads,
                     table.max_core, 0, None)
    run_checked(run)
    return complex_of(run.arrays[state.index])


def run_whole_circuit(prog, psi: np.ndarray) -> np.ndarray:
    """``WholeCircuitProgram.run``: one cooperative ``sweep_launch`` over
    the whole state, as ``fused_circuit.whole_circuit`` sizes it."""
    from tpu_qsim_torch.kernels.fused_circuit import NARROW_CORE
    from tpu_qsim_torch.kernels.gridsweeps import REG_BITS

    n, table = prog.num_qubits, prog.table
    spare = prog.threads > 1 << (prog.tile_bits - REG_BITS)
    run = HostRun()
    state = run.buffer(planes(psi))
    resident = prepare(run, "sweep_prepare", prog.threads, int(table.max_core > NARROW_CORE),
                       int(spare))
    group = min(prog.ctas, 1 << (n - prog.tile_bits), resident)
    run.call("sweep_launch", 0, state, 1 << n, run.buffer(table.ints), run.buffer(table.coef), n,
             run.buffer(_garbage(1, np.int32)), 1, group.bit_length() - 1, prog.threads,
             table.max_core, int(spare), None)
    run_checked(run)
    return complex_of(run.arrays[state.index])


def run_segments(prog, psi: np.ndarray, first: int = 0, last: int | None = None) -> np.ndarray:
    """``SegmentedProgram.launch``: segments [first, last) in one
    cooperative ``segment_launch``, the result from the buffer it ends in."""
    from tpu_qsim_torch.kernels.fused_circuit import NARROW_CORE

    last = prog.num_segments if last is None else last
    steps = prog.steps[first:last]
    max_core = max(s.table.max_core for s in steps)
    n, lb = prog.num_qubits, prog.local_bits
    run = HostRun()
    state = run.buffer(planes(psi))
    other = run.buffer(_garbage((2, 1 << n), np.float32))
    resident = prepare(run, "segment_prepare", lb, int(max_core > NARROW_CORE))
    ctas = min(1 << (n - lb), resident)
    run.call("segment_launch", state, other, 1 << n, run.buffer(prog.table.ints),
             run.buffer(prog.table.coef), run.buffer(_garbage(1, np.int32)), first, last, lb,
             ctas, max_core, None)
    run_checked(run)
    relabels = sum(not s.in_place for s in steps)
    return complex_of(run.arrays[(other if relabels % 2 else state).index])


def run_dense_pass(core: np.ndarray, targets, controls, psi: np.ndarray,
                   instance: str | None = None, sms: int | None = None) -> np.ndarray:
    """``dense_pass.dense_pass``: ``core`` on ``targets`` (``targets[0]``
    the index MSB) where every bit of ``controls`` is 1, out of place, on
    ``instance`` ("small", "medium", "large" or "stream"), by default the one
    ``pass_instance`` picks, on a device of ``sms`` multiprocessors (the
    stream instance's persistent grid is one CTA an SM)."""
    from tpu_qsim_torch.kernels import dense_pass as dp

    n = int(psi.size).bit_length() - 1
    k = len(targets)
    tmask = sum(1 << q for q in targets)
    cmask = sum(1 << q for q in controls)
    instance = dp.INSTANCE_CODE[instance or dp.pass_instance(k, n - k - len(controls))]
    run = HostRun()
    state = run.buffer(planes(psi))
    out = run.buffer(_garbage((2, 1 << n), np.float32))
    run.call("dense_pass_launch", state, out, 1 << n, run.buffer(dp.core_operand(core, tuple(targets))),
             k, tmask, cmask, cmask, instance, None)
    run_checked(run, sms)
    return complex_of(run.arrays[out.index])


def run_rotation_chain(psi: np.ndarray, angles) -> np.ndarray:
    """``floor.rotation_chain`` on the card: ``launch_chain`` over
    ``chain_layout``'s blocks."""
    from tpu_qsim_torch.kernels import floor

    n = int(psi.size).bit_length() - 1
    lay = floor.chain_layout(n)
    table = floor.chain_table(angles)
    run = HostRun()
    state = run.buffer(planes(psi))
    run.call("rotation_chain_launch", state, 1 << n, run.buffer(table), len(table), lay.blk_bits,
             sum(1 << p for p in lay.active), None)
    run_checked(run)
    return complex_of(run.arrays[state.index])
