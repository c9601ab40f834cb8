"""The floor certificate on the card: its float32 rate, and the grid sweep's
time split into streaming, exposed compute and cost per op.

    python -m tpu_qsim_torch.kernels.floor [--vpu N] [--decompose N]
        [--scale N --flavor {reg,lane,extctrl}] [--stamps N] [--sweeps N]
        [--plan-only [--rate T]] [--device cpu]

The port of ``benchmarks/benchmark_floor.py``. Modes:

* ``--vpu N``: the rate the card delivers, from a K-step rotation chain
  ``(r, i) <- (r c - i s, r s + i c)`` (a different angle at each step) over
  every amplitude, in the grid sweep's block shape: the hand-written kernel
  ``csrc/rotation_chain.cu``, the port of ``run_vpu`` (the ``pallas_call``
  at ``benchmark_floor.py:359``). K = 16, 64, 256; the slope of time against
  K over each step [16->64] and [64->256] is the rate, counted as 6 flops
  and 4 float32 instructions (2 FMUL + 2 FFMA) per complex amplitude per
  step. (``run_vpu`` counts both planes' elements and 6 flops for each, so
  it prints twice the rate delivered; that is not copied.) Beside it the SM
  clock read under load, the peak at that clock (SMs x 128 float32 lanes x
  clock), each K's bound (bytes or instruction issue) and the kernel's
  float32 instructions as ``cuobjdump -sass`` shows them.
* ``--decompose N``: the production plan of ``random_circuit(N, 100,
  seed=42)`` on the grid-sweep kernel as it runs, with the same sweeps and
  no gates (streaming only), and each sweep alone; the exposed compute per
  gate is (full - streaming) / gates. Needs ``GridSweepProgram(plan=...)``.
* ``--scale N --flavor F``: K = 0, 8, 16, 32 CNOTs of one op class in one
  grid-sweep launch at the production geometry (an empty active set, padded
  to blk7/a5); the slope is the cost of one op on the main path. Flavors:
  ``reg`` (control and target register bits), ``lane`` (the target a lane
  bit: a warp shuffle), ``extctrl`` (the control an inactive high bit: a
  CTA-uniform test). Each op's descriptor flags are checked, so the planner
  cannot move an op into another class.
* ``--stamps N`` (the card only): the grid sweep's stamp instance
  (``csrc/grid_sweep.cu`` built with ``QSIM_STAMPS``, library
  ``grid_sweep_stamps``, which no main path builds or launches) on each
  sweep of the production plan and on ``--scale``'s 32 CNOTs of each
  flavor: thread 0 of 64 CTAs writes ``clock64()`` at each op boundary of 8
  of its steps, spread over its run; printed per sweep as warp 0's cycles a
  step (the wait for its block, the ops, the last store) and the median
  cycles of an op of each class (``op_class``), at full occupancy and at one
  CTA an SM: an op's latency against the SM's throughput.
* ``--sweeps N``: the sweeps main path at N qubits (``time_run.wide_circuit(N,
  8, 10)``: an 8-qubit core among random gates) launch by launch, each sweep
  in one launch and then as the route plans its launches: each launch as planned and with every stage's ops removed (the same stages,
  tiles, barriers and instance: streaming plus barriers), the difference
  its exposed compute.
* ``--plan-only`` (no card): the float32, select, shuffle and shared-memory
  instructions per amplitude of each register-op class, counted by hand
  from the op semantics in ``csrc/block_program.cuh``, and the op loop's
  own instructions an op (its decode, from ``sass_census --classes`` on the
  card) over a thread's 16 amplitudes; a model, cross-checked against
  ``fused_circuit.min_flops``, and the model's N = 28 floor per op and per
  sweep of the production plan at a rate (``--rate``, T float32
  instructions/s, measured by ``--vpu``; else the data sheet's 67 TFLOP/s,
  and the output says which). Each floor is a range: selects at half and
  at the full float32 rate (``PIPE_SHARE``; their rate is assumed).

``benchmark_floor.lane_coverage_bound`` has no counterpart: it bounds a
lever of the TPU's layout (which 7 qubits ride the 128 lanes of a vector
register); on the card a block's bits 0-4 are a warp's lanes and any other
block bit a register or shared-memory bit, chosen per run of ops by
``gridsweeps.register_table``, so there is no lane window to place.

With no ``--device`` it runs on the card and raises without one; on
``--device cpu`` it runs the plain versions and times them with the host
clock (a check of the control flow, no device number).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from .. import apply as ap
from ..circuit import Circuit, random_circuit
from . import LAUNCHES
from .fused_circuit import (
    OP_HEADER, SWEEP_HEADER, BlockLayout, OpTable, _is_diagonal, _peel_controls, as_pgates,
    check_planes, min_flops,
)
from .gridsweeps import (
    A_MAX, BLK_BITS, D_DIAG, D_LANE, D_REG, D_REMAP, D_SWAP, D_WIDE_DIAG, DESC_WORDS,
    LANE_BITS, REG_BITS, GridParams, GridSweep, GridSweepProgram,
)

SEED = 42
NUM_GATES = 100
VPU_KS = (16, 64, 256)
SCALE_KS = (0, 8, 16, 32)
MAX_STEPS = 4096               # csrc/rotation_chain.cu: (cos, sin) pairs in shared memory
FLOPS_PER_STEP = 6             # per complex amplitude: 2 products and a sum per plane
INSTR_PER_STEP = 4             # 2 FMUL + 2 FFMA per complex amplitude
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # non-tensor-core float32 peak, same source
FP32_LANES = 128               # float32 lanes an SM (Hopper)
# The census's model of an SM's throughput of each instruction class
# against its float32 lanes: warp shuffles at 32 a clock (CUDA C++
# Programming Guide, arithmetic instruction throughput, compute capability
# 9.0), shared-memory accesses taken at the same 32. Selects have no row in
# that table: their share is an assumption, bracketed by half the float32
# rate (a 64-lane integer pipe, "alu") and the full rate ("alu_fast").
PIPE_SHARE = {"fp32": 1.0, "alu": 0.5, "alu_fast": 1.0, "mio": 0.25}


# ---------------------------------------------------------------------------
# The rotation chain: the kernel and its plain version
# ---------------------------------------------------------------------------

def chain_angles(k: int) -> np.ndarray:
    """``run_vpu``'s K angles: 0.1 + 0.001 j radians."""
    return 0.1 + 0.001 * np.arange(k, dtype=np.float64)


def chain_table(angles) -> np.ndarray:
    """(K, 2) float32 (cos, sin) of each angle, rounded from float64 as
    ``run_vpu`` rounds them."""
    a = np.asarray(angles, dtype=np.float64).reshape(-1)
    return np.ascontiguousarray(np.stack([np.cos(a), np.sin(a)], axis=1).astype(np.float32))


def chain_layout(n: int, params: GridParams = GridParams()) -> BlockLayout:
    """The block the kernel gives a CTA: the grid sweep's ``blk_bits`` low
    bits and, as ``run_vpu``'s block spec, the top ``a_max`` bits (fewer
    where n - blk_bits is smaller)."""
    a = min(params.a_max, n - params.blk_bits)
    if a < 0 or params.blk_bits + a < LANE_BITS + REG_BITS:
        raise ValueError(
            f"the rotation chain needs blocks of at least 2^{LANE_BITS + REG_BITS} "
            f"amplitudes, got n = {n}"
        )
    return BlockLayout(n, params.blk_bits, tuple(range(n - a, n)))


def rotation_chain_plain(planes: torch.Tensor, angles) -> torch.Tensor:
    """The plain version: the K steps as torch ops in ``run_vpu``'s order,
    ``(r c - i s, r s + i c)``, with float32 (cos, sin); a new tensor."""
    r, i = planes[0], planes[1]
    for c, s in chain_table(angles).tolist():
        r, i = r * c - i * s, r * s + i * c
    return torch.stack([r, i])


def launch_chain(planes: torch.Tensor, table: torch.Tensor,
                 layout: BlockLayout) -> torch.Tensor:
    """Launch ``csrc/rotation_chain.cu`` on CUDA ``planes`` (in place):
    ``table`` is the (K, 2) float32 (cos, sin) pairs on the same device. One
    CTA per assignment of ``layout``'s inactive bits, 2^(kbits - 4)
    threads. Launches on the current stream without synchronizing; raises
    on a refused launch."""
    from . import _build

    dim = planes.shape[-1]
    if not planes.is_cuda or planes.dtype != torch.float32 or not planes.is_contiguous() \
            or planes.dim() != 2 or planes.shape[0] != 2 or dim != 1 << layout.n:
        raise ValueError(f"the kernel takes contiguous float32 CUDA (2, 2^{layout.n}) planes")
    if table.device != planes.device or table.dtype != torch.float32 \
            or not table.is_contiguous() or table.dim() != 2 or table.shape[1] != 2:
        raise ValueError("the (cos, sin) table must be contiguous (K, 2) float32 on the planes' device")
    k = table.shape[0]
    if k > MAX_STEPS:
        raise ValueError(f"the kernel takes at most {MAX_STEPS} steps, got {k}")
    lib = _build.library("rotation_chain")
    mask = sum(1 << p for p in layout.active)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = lib.rotation_chain_launch(planes.data_ptr(), dim, table.data_ptr(), k,
                                        layout.blk_bits, mask, stream)
    _build.check("rotation_chain", lib, err, "rotation_chain launch")
    LAUNCHES["rotation_chain"] += 1
    return planes


def rotation_chain(planes: torch.Tensor, angles) -> torch.Tensor:
    """Rotate each amplitude of (2, 2^n) float32 ``planes`` by each angle in
    turn, in place, and return them: the kernel (blocks of
    :func:`chain_layout`) on a CUDA tensor, the plain version on a CPU
    tensor."""
    n = int(planes.shape[-1]).bit_length() - 1
    check_planes(planes, n, "rotation chain")
    if planes.device.type == "cpu":
        return planes.copy_(rotation_chain_plain(planes, angles))
    if planes.device.type != "cuda":
        raise ValueError(f"no rotation-chain kernel for device {planes.device}")
    table = torch.from_numpy(chain_table(angles)).to(planes.device)
    return launch_chain(planes, table, chain_layout(n))


def random_planes(n: int, seed: int, device=None) -> torch.Tensor:
    """Unit-norm random float32 planes made on ``device`` from ``seed``."""
    dev = ap.resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randn((2, 1 << n), generator=gen, device=dev, dtype=torch.float32)
    return x.div_(torch.linalg.vector_norm(x.double()).float())


def chain_rates(n: int, ks, ms) -> list[dict]:
    """The rate over each step between consecutive K (``ms`` per K):
    6 flops and 4 float32 instructions per complex amplitude per step."""
    out = []
    for (k0, t0), (k1, t1) in zip(zip(ks, ms), list(zip(ks, ms))[1:]):
        dt = (t1 - t0) * 1e-3
        work = (1 << n) * (k1 - k0)
        out.append({
            "from": k0, "to": k1, "us_per_step": dt * 1e6 / (k1 - k0),
            "tflop_per_s": FLOPS_PER_STEP * work / dt / 1e12 if dt > 0 else float("inf"),
            "tinstr_per_s": INSTR_PER_STEP * work / dt / 1e12 if dt > 0 else float("inf"),
        })
    return out


def peak_instr_per_s(sms: int, clock_mhz: float) -> float:
    """Float32 instructions a second: SMs x 128 lanes x clock."""
    return sms * FP32_LANES * clock_mhz * 1e6


def chain_bound(n: int, k: int, instr_per_s: float | None = None) -> dict:
    """Least times of a K-step chain over 2^n amplitudes: the bytes (each
    plane read and written once, 16 B an amplitude) at 3.35 TB/s; the flops
    at the data sheet's 67 TFLOP/s; and, at ``instr_per_s``, the float32
    instructions (the tighter of the two operation bounds: an FMUL is one
    flop on a lane that could do two)."""
    amps = 1 << n
    out = {"bytes_ms": 16 * amps / HBM_BYTES_PER_S * 1e3,
           "flops_ms": FLOPS_PER_STEP * k * amps / FP32_FLOP_PER_S * 1e3}
    out["bound_ms"] = max(out["bytes_ms"], out["flops_ms"])
    out["bound_by"] = "bytes" if out["bytes_ms"] >= out["flops_ms"] else "operations"
    if instr_per_s:
        out["issue_ms"] = INSTR_PER_STEP * k * amps / instr_per_s * 1e3
    return out


def sm_clocks() -> tuple[float, float]:
    """(SM clock, its maximum) in MHz, from ``nvidia-smi``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]
    sm, mx = (float(v) for v in out.split(","))
    return sm, mx


def sass_counts(name: str = "rotation_chain", kernel: str = "rotation_chain_kernel") -> dict:
    """Instruction counts by opcode of ``kernel`` in the built library of
    ``csrc/<name>.cu``, from ``cuobjdump -sass`` (beside ``nvcc``)."""
    from . import _build

    counts: dict[str, int] = {}
    for fn, body in _build.sass_listing(name).items():
        if kernel in fn:
            for _, op, _ in body:
                counts[op] = counts.get(op, 0) + 1
    if not counts:
        raise RuntimeError(f"no SASS of {kernel} in {_build.library_path(name).name}")
    return counts


def median_ms(fn, device: torch.device, reps: int = 5) -> float:
    """Median of ``reps`` times of ``fn`` after a warm-up: CUDA events on
    the card (``tune_small.median_ms``), the host clock on the CPU."""
    if device.type == "cuda":
        from .tune_small import median_ms as cuda_median_ms

        return cuda_median_ms(fn, 1, reps)
    fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def vpu(n: int, ks=VPU_KS, device=None, seed: int = SEED) -> dict:
    """``--vpu``: time the chain at each K on seeded random planes, the rate
    over each step, the SM clock under load and the bounds."""
    dev = ap.resolve_device(device)
    layout = chain_layout(n)
    x = random_planes(n, seed, dev)
    tables = {k: torch.from_numpy(chain_table(chain_angles(k))).to(dev) for k in ks}
    if dev.type == "cuda":
        def step(k):
            return lambda: launch_chain(x, tables[k], layout)
    else:
        def step(k):
            return lambda: rotation_chain(x, chain_angles(k))
    ms = [median_ms(step(k), dev) for k in ks]
    out = {"n": n, "ks": list(ks), "ms": ms, "layout": {"blk": layout.blk_bits, "active": list(layout.active)},
           "rates": chain_rates(n, ks, ms), "device": str(dev)}
    instr_per_s = None
    if dev.type == "cuda":
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        run = step(ks[-1])
        for _ in range(max(8, int(400 / max(ms[-1], 1e-3)))):   # ~0.4 s of launches
            run()
        clock, clock_max = sm_clocks()                           # read while they run
        torch.cuda.synchronize(dev)
        instr_per_s = peak_instr_per_s(sms, clock)
        out.update(sms=sms, sm_clock_mhz=clock, sm_clock_max_mhz=clock_max,
                   peak_tinstr_per_s=instr_per_s / 1e12,
                   peak_tflop_per_s_at_clock=2 * instr_per_s / 1e12,
                   datasheet_tflop_per_s=FP32_FLOP_PER_S / 1e12,
                   sass=sass_counts())
    out["bounds"] = [chain_bound(n, k, instr_per_s) for k in ks]
    return out


# ---------------------------------------------------------------------------
# --decompose: the production plan as it runs, streaming only, each sweep
# ---------------------------------------------------------------------------

def decompose_programs(n: int, seed: int = SEED) -> dict:
    """The production plan of ``random_circuit(n, 100, seed)`` and three
    variants on the grid-sweep kernel: ``full`` (the program as planned),
    ``zero`` (the same sweeps with no gates: each streams the state) and
    ``sweeps`` (one program per sweep)."""
    circuit = random_circuit(n, NUM_GATES, seed=seed)
    prog = GridSweepProgram(circuit)
    plan = [GridSweep(active=set(a), gates=list(g))
            for a, g in zip(prog.active_sets, prog.sweep_gates)]
    return {
        "circuit": circuit, "plan": plan, "full": prog,
        "zero": GridSweepProgram(circuit, prog.params,
                                 plan=[GridSweep(active=set(s.active)) for s in plan]),
        "sweeps": [GridSweepProgram(circuit, prog.params, plan=[s]) for s in plan],
    }


def decompose(n: int, device=None, seed: int = SEED) -> dict:
    """``--decompose``: ms of the full run, the streaming-only run and each
    sweep alone, the exposed compute per gate, and the bytes bound; also the
    full variant's state from |0...0> (``state``)."""
    dev = ap.resolve_device(device)
    progs = decompose_programs(n, seed)
    x = ap.initial_state(n, np.float32, device=dev)
    state = progs["full"].run(x.clone())
    full = median_ms(lambda: progs["full"].run(x), dev)
    zero = median_ms(lambda: progs["zero"].run(x), dev)
    alone = [median_ms(lambda p=p: p.run(x), dev) for p in progs["sweeps"]]
    gates = [len(s.gates) for s in progs["plan"]]
    sweep_bytes_ms = 16 * (1 << n) / HBM_BYTES_PER_S * 1e3
    return {
        "n": n, "device": str(dev),
        "geometry": {"blk_bits": progs["full"].params.blk_bits, "a_max": progs["full"].params.a_max},
        "gates_per_sweep": gates, "full_ms": full, "zero_gate_ms": zero,
        "sweep_ms": alone, "sum_of_sweeps_ms": sum(alone),
        "exposed_ms": full - zero, "exposed_us_per_gate": (full - zero) * 1e3 / max(sum(gates), 1),
        "streaming_share": zero / full, "sweep_bytes_ms": sweep_bytes_ms,
        "bytes_ms": sweep_bytes_ms * len(gates), "state": state,
    }


def sweeps_decompose(n: int = 26, device=None, params=None, circuit: Circuit | None = None,
                     one_launch: bool = False) -> dict:
    """``--sweeps``: the sweeps main path (``time_run.wide_circuit(n, 8,
    10)``, or ``circuit`` at ``params``) launch by launch, as the route
    plans them or (``one_launch``) each sweep in one launch: each launch's ms as planned and with every stage's ops
    removed (``sweeps.streaming_stages``: the same stages, tiles, barriers,
    instance and geometry), so that each splits into streaming plus
    barriers and exposed compute (the difference); beside them the bytes of
    one pass (a read and a write of the state). On the CPU the plain
    versions (the launch's gates, and a copy of the state), by the host
    clock."""
    from .sweeps import SweepParams, SweepProgram, streaming_stages, sweep_table
    from .time_run import wide_circuit

    dev = ap.resolve_device(device)
    prog = SweepProgram(wide_circuit(n, 8, 10) if circuit is None else circuit,
                        SweepParams() if params is None else params, _one_launch=one_launch)
    x = random_planes(prog.num_qubits, SEED, dev)
    rows = []
    for i, kind in enumerate(prog.sweep_kinds):
        for j, launch in enumerate(prog.launches[i]):
            row = {"sweep": i, "kind": kind, "launch": j, "route": launch.route,
                   "stages": [[st.kind, len(st.gates)] for st in launch.stages]}
            if launch.route == "pass":
                row["ms"] = median_ms(lambda: (prog.launch_one if dev.type == "cuda"
                                               else prog.launch_plain)(x, i, j), dev)
                rows.append(row)
                continue
            lay, bits = prog.layouts[i], prog.tile_bits[i]
            zero = sweep_table(streaming_stages(launch.stages, lay, bits), lay, bits)
            if dev.type == "cuda":
                zero_dev = (torch.from_numpy(zero.ints).to(dev), torch.from_numpy(zero.coef).to(dev))

                def stream(i=i, z=zero_dev, launch=launch):
                    prog.launch_table(x, i, z, launch.max_core, launch.route)

                def full(i=i, j=j):
                    prog.launch_one(x, i, j)
            else:
                def stream():
                    x.clone()

                def full(i=i, j=j):
                    prog.launch_plain(x, i, j)
            row["ms"] = median_ms(full, dev)
            row["streaming_ms"] = median_ms(stream, dev)
            row["exposed_ms"] = row["ms"] - row["streaming_ms"]
            rows.append(row)
    bytes_ms = 16 * (1 << prog.num_qubits) / HBM_BYTES_PER_S * 1e3
    return {"n": prog.num_qubits, "device": str(dev), "one_launch": one_launch, "launches": rows,
            "pass_bytes_ms": bytes_ms, "geometry": str(prog.geometry),
            "ms": sum(r["ms"] for r in rows),
            "streaming_ms": sum(r.get("streaming_ms", r["ms"]) for r in rows)}


# ---------------------------------------------------------------------------
# --scale: K CNOTs of one class in one launch
# ---------------------------------------------------------------------------

SCALE_FLAVORS = ("reg", "lane", "extctrl")
SCALE_MIN_QUBITS = BLK_BITS + A_MAX + 2     # two inactive high bits for extctrl


def scale_circuit(n: int, flavor: str, k: int) -> Circuit:
    """K CNOTs of one class, at blk7/a5 with the block bits 0-11:
    ``reg`` controls and targets among the register bits 5, 6, 9, 10;
    ``lane`` control a register bit (5-8), target a lane bit (0-4);
    ``extctrl`` control the top two (inactive) bits, target a register bit."""
    if flavor not in SCALE_FLAVORS:
        raise ValueError(f"flavor must be one of {SCALE_FLAVORS}, got {flavor!r}")
    if n < SCALE_MIN_QUBITS:
        raise ValueError(f"the scale mode needs n >= {SCALE_MIN_QUBITS}, got {n}")
    c = Circuit(n)
    for i in range(k):
        if flavor == "reg":
            c.cnot(*((5, 9), (6, 10), (9, 5), (10, 6))[i % 4])
        elif flavor == "lane":
            c.cnot(5 + i % 4, i % LANE_BITS)
        else:
            c.cnot(n - 1 - i % 2, 9 + i % 2)
    return c


def descriptors(table: OpTable) -> np.ndarray:
    """The (ops, 8) descriptors after a register table's ops."""
    n_ops = int(table.ints[0])
    start = SWEEP_HEADER + n_ops * OP_HEADER
    return table.ints[start:start + n_ops * DESC_WORDS].reshape(n_ops, DESC_WORDS)


def check_flavor(prog: GridSweepProgram, flavor: str) -> None:
    """Raise ValueError unless every op of ``prog``'s one sweep runs in
    registers as a swap of ``flavor``'s class: ``reg`` a register target and
    an in-block control, ``lane`` a lane target, ``extctrl`` a register
    target and only an out-of-block control; no remap."""
    (table,) = prog.tables
    for j, d in enumerate(descriptors(table)):
        flags = int(d[0])
        ok = flags & D_REG and flags & D_SWAP and not flags & (D_REMAP | D_DIAG)
        if flavor == "reg":
            ok = ok and not flags & D_LANE and d[2] and not d[4]
        elif flavor == "lane":
            ok = ok and flags & D_LANE and not d[4]
        else:
            ok = ok and not flags & D_LANE and d[4] and not d[2]
        if not ok:
            raise ValueError(f"op {j} of the {flavor} scale program has descriptor {d.tolist()}")


def scale_program(n: int, flavor: str, k: int) -> GridSweepProgram:
    """One sweep of :func:`scale_circuit`'s K CNOTs, an empty active set
    (padded to the production block), flags checked."""
    c = scale_circuit(n, flavor, k)
    prog = GridSweepProgram(c, GridParams(), plan=[GridSweep(gates=as_pgates(c.gates))])
    check_flavor(prog, flavor)
    return prog


def scale(n: int, flavor: str, device=None, ks=SCALE_KS) -> dict:
    """``--scale``: ms of one launch with K ops of ``flavor``, and us per op
    over each step of K."""
    dev = ap.resolve_device(device)
    x = ap.initial_state(n, np.float32, device=dev)
    ms = []
    for k in ks:
        prog = scale_program(n, flavor, k)
        ms.append(median_ms(lambda: prog.run(x), dev))
    steps = [{"from": k0, "to": k1, "us_per_op": (t1 - t0) * 1e3 / (k1 - k0)}
             for (k0, t0), (k1, t1) in zip(zip(ks, ms), list(zip(ks, ms))[1:])]
    return {"n": n, "flavor": flavor, "device": str(dev), "ks": list(ks), "ms": ms,
            "us_per_op": steps}


# ---------------------------------------------------------------------------
# --stamps: clock64() at each op boundary of sampled CTAs
# ---------------------------------------------------------------------------

STAMP_CTAS = 64        # CTAs whose thread 0 stamps (spread over the SMs)
STAMP_STEPS = 8        # steps of each, spread over its run
STAMP_EXTRA = 5        # a row's slots past the ops: see grid_sweep.cu's ClockStamp
OCCUPANCIES = {"full": 0, "one_cta_per_sm": 1}


def op_class(d: np.ndarray) -> str:
    """The class of the op with descriptor ``d``, as the stamps and the SASS
    census group ops: ``remap``, ``smem`` (an op in shared memory),
    ``diag1``/``diag2``/``diag_wide``, ``swap``/``dense1`` with ``_lane``
    for a lane target, ``_ctrl`` for block-local controls and ``_ext`` for
    out-of-block ones."""
    flags = int(d[0])
    if flags & D_REMAP:
        return "remap"
    if not flags & D_REG:
        return "smem"
    if flags & D_DIAG:
        if flags & D_WIDE_DIAG:
            return "diag_wide"
        return f"diag{int(d[7]) & 0xFF}"
    name = "swap" if flags & D_SWAP else "dense1"
    if flags & D_LANE:
        name += "_lane"
    if int(d[2]):
        name += "_ctrl"
    if int(d[4]):
        name += "_ext"
    return name


def stamp_rows(prog: GridSweepProgram, x: torch.Tensor, one_per_sm: int,
               ctas: int = STAMP_CTAS, steps: int = STAMP_STEPS) -> list[np.ndarray]:
    """Run ``prog`` on ``x`` (in place) through the grid sweep's stamp
    instance (``csrc/grid_sweep.cu`` built with ``QSIM_STAMPS``), at as
    many CTAs an SM as fit or (``one_per_sm`` 1) one; each sweep's stamps as
    a (ctas, steps, n_ops + STAMP_EXTRA) int64 array, rows never written 0.
    Each launch counts in ``LAUNCHES["grid_sweep_stamps"]``."""
    from . import _build

    lib = _build.library("grid_sweep_stamps")
    out = []
    for (ints, coef), lay, table in zip(prog._tables_on(x.device), prog.layouts, prog.tables):
        n_ops = int(table.ints[0])
        buf = torch.zeros((ctas, steps, n_ops + STAMP_EXTRA), dtype=torch.int64, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.grid_sweep_stamp_launch(
                x.data_ptr(), 1 << lay.n, ints.data_ptr(), coef.data_ptr(), lay.kbits,
                1 << len(lay.inactive), table.max_core, buf.data_ptr(), ctas, steps, one_per_sm,
                stream)
        _build.check("grid_sweep_stamps", lib, err, "grid_sweep stamp launch")
        LAUNCHES["grid_sweep_stamps"] += 1
        out.append(buf.cpu().numpy())
    return out


def stamp_summary(table: OpTable, rows: np.ndarray) -> dict:
    """Cycles of warp 0 of each stamped step: the wait for its block and
    first load (slots 0-1), each op (slot 2 + o to the next boundary) by
    class, and the last store; an op whose out-of-block controls fail on
    the step's block (the row's last slot holds its share of the global
    index) is counted apart, as ``skipped``."""
    n_ops = int(table.ints[0])
    descs = descriptors(table)
    classes = [op_class(d) for d in descs]
    ext = [(int(d[4]) & 0xFFFFFFFF, int(d[5]) & 0xFFFFFFFF) for d in descs]
    by_class: dict[str, list[int]] = {}
    wait, ops, store = [], [], []
    for row in rows.reshape(-1, rows.shape[-1]):
        if not row[0]:
            continue
        cta_g = int(row[-1]) & 0xFFFFFFFF
        wait.append(int(row[1] - row[0]))
        ops.append(int(row[2 + n_ops] - row[2]) if n_ops else 0)
        store.append(int(row[3 + n_ops] - row[2 + n_ops]))
        for o in range(n_ops):
            dt = int(row[3 + o] - row[2 + o])
            name = classes[o] if (cta_g & ext[o][0]) == ext[o][1] else "skipped"
            by_class.setdefault(name, []).append(dt)
    med = (lambda v: float(np.median(v)) if v else None)
    return {"steps": len(wait), "wait_cycles": med(wait), "ops_cycles": med(ops),
            "store_cycles": med(store), "ops": n_ops,
            "class_cycles": {k: med(v) for k, v in sorted(by_class.items())},
            "class_counts": {k: len(v) for k, v in sorted(by_class.items())}}


def stamp_programs(n: int) -> dict:
    """The programs ``--stamps`` runs: each sweep of the production plan of
    ``random_circuit(n, 100, seed)``, and ``--scale``'s 32 CNOTs of each
    flavor."""
    progs = decompose_programs(n)
    out = {f"sweep{i}": p for i, p in enumerate(progs["sweeps"])}
    out.update({f"scale_{f}": scale_program(n, f, SCALE_KS[-1]) for f in SCALE_FLAVORS})
    return out


def stamps(n: int, device=None) -> dict:
    """``--stamps``: each of :func:`stamp_programs` through the stamp
    instance at full occupancy and at one CTA an SM (latency against
    throughput), summarised per sweep and per op class in cycles of warp 0;
    with the SM clock read under load."""
    dev = ap.resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("--stamps reads clock64() on the card: it needs a CUDA device")
    x = ap.initial_state(n, np.float32, device=dev)
    out = {"n": n, "device": str(dev), "ctas": STAMP_CTAS, "steps": STAMP_STEPS, "programs": {}}
    progs = stamp_programs(n)
    for name, prog in progs.items():
        res = {}
        for occ, one_per_sm in OCCUPANCIES.items():
            stamp_rows(prog, x, one_per_sm)           # warm-up
            rows = stamp_rows(prog, x, one_per_sm)
            res[occ] = [stamp_summary(t, r) for t, r in zip(prog.tables, rows)]
        out["programs"][name] = res
    for _ in range(200):
        progs["sweep0"].run(x)
    out["sm_clock_mhz"], out["sm_clock_max_mhz"] = sm_clocks()
    torch.cuda.synchronize(dev)
    return out


def print_stamps(r: dict) -> None:
    for name, res in r["programs"].items():
        for occ, sweeps in res.items():
            for i, s in enumerate(sweeps):
                classes = ", ".join(f"{k} {v:.0f} (x{s['class_counts'][k]})"
                                    for k, v in s["class_cycles"].items())
                print(f"{r['n']}q stamps {name}[{i}] {occ}: {s['steps']} steps, cycles a step: wait "
                      f"{s['wait_cycles']:.0f}, {s['ops']} ops {s['ops_cycles']:.0f}, store "
                      f"{s['store_cycles']:.0f}; median cycles an op: {classes}", flush=True)
    print(f"SM clock under load {r['sm_clock_mhz']:.0f} MHz (max {r['sm_clock_max_mhz']:.0f})",
          flush=True)


# ---------------------------------------------------------------------------
# --plan-only: instructions per amplitude of each register-op class
# ---------------------------------------------------------------------------

# The op loop's own instructions a thread issues for a register op before
# its class's code starts (its descriptor loads, tests and dispatch): the
# fewest of each class in the narrow grid sweep's SASS, as ``sass_census
# --classes`` counts them in the measurement build's marked instance
# (``chip_smoke.py`` fails where the build no longer has these counts).
# Work of the compiled loop, not of the function: only ``loop_census``
# (the loop model) counts it, never a bound.
DECODE = {"diag": 31, "swap": 62, "swap_lane": 62, "dense1": 61, "dense1_lane": 61}


def op_census(d: np.ndarray) -> dict | None:
    """Instructions per amplitude of the register op with descriptor ``d``,
    on the CTAs whose out-of-block controls pass, as ``block_program.cuh``'s
    ``reg_op`` spends them (address arithmetic not counted); None for an op
    in shared memory. FMUL/FFMA: float32; SEL: a conditional move of a
    value (integer pipe); SHFL: a warp shuffle; LDS/STS: shared memory.

    - diagonal (``cmul``): r' = fma(c.x, r, -c.y i), i' = fma(c.x, i, c.y r):
      2 FMUL + 2 FFMA; a 2-qubit diagonal picks its entry by value: 3
      selects of a float2;
    - 1-qubit core on a register bit (``reg_dense1``): 4 ``cmac`` per pair,
      4 FFMA each: 8 FFMA; on a lane bit (``lane_dense1``) 2 ``cmac`` and 2
      shuffles per value;
    - X core (``reg_swap``): 4 selects per pair; on a lane bit
      (``lane_swap``) 2 shuffles and 2 selects per value;
    - remap: each value stored to shared memory and loaded back, both planes.
    """
    flags = int(d[0])
    c = {"FMUL": 0, "FFMA": 0, "SEL": 0, "SHFL": 0, "LDS": 0, "STS": 0}
    if flags & D_REMAP:
        c.update(STS=2, LDS=2)
        return c
    if not flags & D_REG:
        return None
    lane = bool(flags & D_LANE)
    if flags & D_DIAG:
        c.update(FMUL=2, FFMA=2)
        if not flags & D_WIDE_DIAG and int(d[7]) & 0xFF == 2:
            c["SEL"] = 6
    elif flags & D_SWAP:
        c.update(SEL=2, SHFL=2 if lane else 0)
    else:
        c.update(FFMA=8, SHFL=2 if lane else 0)
    return c


def decode_class(d: np.ndarray) -> str | None:
    """``DECODE``'s key for the register op with descriptor ``d`` (None for
    a remap or an op in shared memory)."""
    flags = int(d[0])
    if flags & D_REMAP or not flags & D_REG:
        return None
    if flags & D_DIAG:
        return "diag"
    return ("swap" if flags & D_SWAP else "dense1") + ("_lane" if flags & D_LANE else "")


def loop_census(d: np.ndarray, decode: dict = DECODE) -> dict | None:
    """The loop model: :func:`op_census` plus INT, the op's decode
    (``decode``, a thread's instructions over its 16 amplitudes; integer
    pipe), which the compiled op loop issues and the function does not
    need."""
    c = op_census(d)
    if c is not None:
        key = decode_class(d)
        c["INT"] = decode[key] / 16 if key else 0
    return c


def census_flops(c: dict) -> int:
    return c["FMUL"] + 2 * c["FFMA"]


def ctrl_share(d: np.ndarray) -> float:
    """The share of CTAs whose out-of-block controls (descriptor word 4)
    pass: 2^-(controls)."""
    return 1.0 / (1 << bin(int(d[4]) & 0xFFFFFFFF).count("1"))


def op_floor_s(c: dict, amps: float, instr_per_s: float, alu: str = "alu") -> float:
    """The model's least seconds of ``c``'s instructions on ``amps``
    amplitudes: the larger of their issue (one instruction a lane a clock)
    and each pipe's share of the float32 rate (``PIPE_SHARE``; selects, and
    a loop census's decode, at ``PIPE_SHARE[alu]``)."""
    fp32 = c["FMUL"] + c["FFMA"]
    sel = c["SEL"] + c.get("INT", 0)
    mio = c["SHFL"] + c["LDS"] + c["STS"]
    lanes = max(fp32 + sel + mio, fp32 / PIPE_SHARE["fp32"], sel / PIPE_SHARE[alu],
                mio / PIPE_SHARE["mio"])
    return lanes * amps / instr_per_s


def census_classes(n: int = 28) -> dict:
    """One-op register tables at blk7/a5 (empty active set) for each class:
    the three scale flavors, a 1-qubit core (a fixed random unitary) on a
    register and on a lane bit, and a 1-qubit diagonal (rz)."""
    rng = np.random.default_rng(SEED)
    u = np.linalg.qr(rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2)))[0]
    c = Circuit(n).cnot(5, 9).cnot(5, 0).cnot(n - 1, 9)
    gates = as_pgates([*c.gates, (u, (9,)), (u, (0,))]) + as_pgates(Circuit(n).rz(9, 0.7).gates)
    out = {}
    for name, g in zip(("reg", "lane", "extctrl", "dense1", "dense1_lane", "diag1"), gates):
        prog = GridSweepProgram(Circuit(n), GridParams(), plan=[GridSweep(gates=[g])])
        (d,) = descriptors(prog.tables[0])
        diagonal = _is_diagonal(g.u)
        core = g.u if diagonal else _peel_controls(g.u, g.qubits)[1]
        out[name] = {"descriptor": d, "census": op_census(d), "share": ctrl_share(d),
                     "min_flops": min_flops(core, diagonal)}
    return out


def plan_floor(prog: GridSweepProgram, instr_per_s: float, decode: dict = DECODE) -> list[dict]:
    """Per sweep of ``prog``: its bytes time, and the model's floor of its
    register ops and remaps (each op's census on its share of CTAs), with
    selects at half (``ops_ms``) and at the full float32 rate
    (``ops_fast_sel_ms``); the same with each op's decode (``decode``;
    ``loop_ms``, ``loop_fast_sel_ms``: the loop model); a shared-memory op
    is counted, not priced."""
    amps = 1 << prog.num_qubits
    out = []
    for table in prog.tables:
        ms = {"ops_ms": 0.0, "ops_fast_sel_ms": 0.0, "loop_ms": 0.0, "loop_fast_sel_ms": 0.0}
        smem_ops, n_ops = 0, 0
        for d in descriptors(table):
            c = op_census(d)
            if c is None:
                smem_ops += 1
                continue
            n_ops += 1
            on = amps * ctrl_share(d)
            for key, census in (("ops", c), ("loop", loop_census(d, decode))):
                ms[f"{key}_ms"] += op_floor_s(census, on, instr_per_s) * 1e3
                ms[f"{key}_fast_sel_ms"] += op_floor_s(census, on, instr_per_s, "alu_fast") * 1e3
        out.append({"entries": n_ops, "smem_ops": smem_ops, **ms,
                    "bytes_ms": 16 * amps / HBM_BYTES_PER_S * 1e3})
    return out


def plan_only(n: int = 28, tinstr_per_s: float | None = None, decode: dict = DECODE) -> dict:
    """``--plan-only``: the census of each class, the model's floor per op
    at n qubits, and the production plan's floor per sweep, at
    ``tinstr_per_s`` (T float32 instructions/s) or the data sheet's; each
    floor with selects at half and at the full float32 rate. Sums over the
    sweeps: the ops floor, the bound (each sweep's larger of its bytes and
    its ops floor, ``max_bytes_ops_ms``) and the loop model (its larger of
    bytes and the ops with their decode, ``decode`` or ``DECODE``,
    ``loop_model_ms``), each as [full-rate selects, half-rate]."""
    if tinstr_per_s is None:
        rate, source = FP32_FLOP_PER_S / 2, "data sheet: 67 TFLOP/s of FMAs = 33.5 T instructions/s"
    else:
        rate, source = tinstr_per_s * 1e12, "measured (--rate)"
    classes = census_classes(n)
    rows = {}
    for name, cls in classes.items():
        c, loop = cls["census"], loop_census(cls["descriptor"], decode)
        amps = (1 << n) * cls["share"]
        rows[name] = {**c, "decode": loop["INT"], "share": cls["share"],
                      "flops": census_flops(c), "min_flops": cls["min_flops"],
                      "floor_us": op_floor_s(c, amps, rate) * 1e6,
                      "floor_fast_sel_us": op_floor_s(c, amps, rate, "alu_fast") * 1e6,
                      "loop_us": op_floor_s(loop, amps, rate) * 1e6,
                      "loop_fast_sel_us": op_floor_s(loop, amps, rate, "alu_fast") * 1e6}
    prog = GridSweepProgram(random_circuit(n, NUM_GATES, seed=SEED))
    sweeps = plan_floor(prog, rate, decode)

    def total(key):
        return sum(s[key] for s in sweeps)

    def over_bytes(key):
        return [sum(max(s["bytes_ms"], s[f"{key}_fast_sel_ms"]) for s in sweeps),
                sum(max(s["bytes_ms"], s[f"{key}_ms"]) for s in sweeps)]

    return {"n": n, "tinstr_per_s": rate / 1e12, "rate_source": source,
            "model": "hand count of block_program.cuh's instructions; the select rate is assumed",
            "classes": rows, "plan": sweeps, "plan_ops_ms": total("ops_ms"),
            "plan_ops_fast_sel_ms": total("ops_fast_sel_ms"), "plan_bytes_ms": total("bytes_ms"),
            "max_bytes_ops_ms": over_bytes("ops"), "plan_loop_ms": total("loop_ms"),
            "plan_loop_fast_sel_ms": total("loop_fast_sel_ms"),
            "loop_model_ms": over_bytes("loop")}


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def print_vpu(r: dict) -> None:
    for k, t, b in zip(r["ks"], r["ms"], r["bounds"]):
        issue = f" issue_ms={b['issue_ms']:.4f}" if "issue_ms" in b else ""
        print(f"{r['n']}q rotation-chain K={k:4d}: {t:.4f} ms (bytes_ms={b['bytes_ms']:.4f} "
              f"flops_ms={b['flops_ms']:.4f}{issue})", flush=True)
    for s in r["rates"]:
        print(f"{r['n']}q rate [{s['from']}->{s['to']}]: {s['tflop_per_s']:.3f} TFLOP/s, "
              f"{s['tinstr_per_s']:.3f} T float32 instructions/s ({s['us_per_step']:.3f} us/step)",
              flush=True)
    if "sm_clock_mhz" in r:
        print(f"SM clock {r['sm_clock_mhz']:.0f} MHz (max {r['sm_clock_max_mhz']:.0f}), "
              f"{r['sms']} SMs: peak {r['peak_tinstr_per_s']:.3f} T instructions/s = "
              f"{r['peak_tflop_per_s_at_clock']:.3f} TFLOP/s at that clock "
              f"(data sheet {r['datasheet_tflop_per_s']:.0f}); SASS {r['sass']}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--vpu", type=int, default=None, metavar="N")
    parser.add_argument("--decompose", type=int, default=None, metavar="N")
    parser.add_argument("--scale", type=int, default=None, metavar="N")
    parser.add_argument("--flavor", choices=SCALE_FLAVORS, default="reg")
    parser.add_argument("--stamps", type=int, default=None, metavar="N")
    parser.add_argument("--sweeps", type=int, default=None, metavar="N")
    parser.add_argument("--plan-only", action="store_true")
    parser.add_argument("--rate", type=float, default=None,
                        help="T float32 instructions/s for --plan-only (from --vpu)")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args()
    if args.plan_only:
        r = plan_only(28, args.rate)
        print(f"rate: {r['tinstr_per_s']:.3f} T float32 instructions/s ({r['rate_source']}); "
              f"a model: {r['model']}; floors with selects at the full / half float32 rate")
        for name, c in r["classes"].items():
            print(f"{name:12s} per amplitude: FMUL {c['FMUL']} FFMA {c['FFMA']} SEL {c['SEL']} "
                  f"SHFL {c['SHFL']} LDS {c['LDS']} STS {c['STS']}; {c['flops']} flops "
                  f"(min_flops {c['min_flops']:g}); on {c['share']:g} of the CTAs; "
                  f"28q model floor {c['floor_fast_sel_us']:.1f}-{c['floor_us']:.1f} us/op; "
                  f"loop model (decode {c['decode']:g}) {c['loop_fast_sel_us']:.1f}-"
                  f"{c['loop_us']:.1f} us/op")
        for i, s in enumerate(r["plan"]):
            print(f"28q plan sweep[{i}]: {s['entries']} register entries, {s['smem_ops']} "
                  f"shared-memory ops: ops floor {s['ops_fast_sel_ms']:.4f}-{s['ops_ms']:.4f} ms, "
                  f"bytes {s['bytes_ms']:.4f} ms; loop model {s['loop_fast_sel_ms']:.4f}-"
                  f"{s['loop_ms']:.4f} ms")
        lo, hi = r["max_bytes_ops_ms"]
        llo, lhi = r["loop_model_ms"]
        print(f"28q plan: ops floor {r['plan_ops_fast_sel_ms']:.4f}-{r['plan_ops_ms']:.4f} ms, "
              f"bytes {r['plan_bytes_ms']:.4f} ms; sum per sweep of max(bytes, ops floor) "
              f"{lo:.4f}-{hi:.4f} ms; loop model (ops with their decode) "
              f"{r['plan_loop_fast_sel_ms']:.4f}-{r['plan_loop_ms']:.4f} ms, over the bytes "
              f"{llo:.4f}-{lhi:.4f} ms")
        print(json.dumps(r, default=float))
        return
    dev = ap.resolve_device(args.device)
    if dev.type == "cuda":
        print(f"card: {_card()}", flush=True)
    else:
        print("device cpu: plain versions, host clock (no device number)", flush=True)
    if args.vpu:
        r = vpu(args.vpu, device=dev)
        print_vpu(r)
        print(json.dumps(r), flush=True)
    if args.decompose:
        r = decompose(args.decompose, device=dev)
        r.pop("state")
        for i, (g, t) in enumerate(zip(r["gates_per_sweep"], r["sweep_ms"])):
            print(f"{r['n']}q sweep[{i}] ({g:2d} gates): {t:.4f} ms (bytes {r['sweep_bytes_ms']:.4f})")
        print(f"{r['n']}q full {r['full_ms']:.4f} ms, streaming only {r['zero_gate_ms']:.4f} ms "
              f"({100 * r['streaming_share']:.1f}%), sum of sweeps {r['sum_of_sweeps_ms']:.4f} ms, "
              f"bytes bound {r['bytes_ms']:.4f} ms; exposed compute {r['exposed_ms']:.4f} ms = "
              f"{r['exposed_us_per_gate']:.2f} us/gate", flush=True)
        print(json.dumps(r), flush=True)
    if args.sweeps:
        for one in (True, False):
            r = sweeps_decompose(args.sweeps, device=dev, one_launch=one)
            for row in r["launches"]:
                split = (f", streaming only {row['streaming_ms']:.4f} ms, exposed "
                         f"{row['exposed_ms']:.4f} ms" if "streaming_ms" in row else "")
                print(f"{r['n']}q sweeps ({'one launch a sweep' if one else 'as the route plans'}) "
                      f"sweep[{row['sweep']}] {row['kind']} launch {row['launch']} "
                      f"({row['route']}, stages {row['stages']}): {row['ms']:.4f} ms{split} "
                      f"(a pass's bytes {r['pass_bytes_ms']:.4f})", flush=True)
            print(f"{r['n']}q sweeps ({'one launch a sweep' if one else 'as the route plans'}): "
                  f"{r['ms']:.4f} ms, streaming only {r['streaming_ms']:.4f} ms", flush=True)
            print(json.dumps(r), flush=True)
    if args.stamps:
        r = stamps(args.stamps, device=dev)
        print_stamps(r)
        print(json.dumps(r), flush=True)
    if args.scale:
        r = scale(args.scale, args.flavor, device=dev)
        for k, t in zip(r["ks"], r["ms"]):
            print(f"{r['n']}q {r['flavor']} K={k:3d}: {t:.4f} ms")
        for s in r["us_per_op"]:
            print(f"{r['n']}q {r['flavor']} us/op [{s['from']}->{s['to']}]: {s['us_per_op']:.3f}")
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
