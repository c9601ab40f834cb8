#!/usr/bin/env python3
"""Drive tpu_qsim_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and ``nvcc``; imports nothing of JAX. Phases:

1. build the host planner ``native/fusion.cpp`` with g++, then
   ``grid_sweep.cu``, ``segment.cu``, ``sweep.cu`` (also the
   whole-circuit route's kernel), ``dense_pass.cu`` and
   ``rotation_chain.cu``, one nvcc each, all at once (under 60 s in all),
   with ptxas's registers and spills; then the SASS of every wide kernel
   instance's tiled dense op (``ops.cuh::apply_dense_tiled``, from
   ``cuobjdump -sass``): tensor-core products (HMMA) and no float32 FMA;
2. 20 qubits: ``random_circuit(20, 100, seed=42)`` through the simulator's
   grid-sweep kernel against the complex128 host oracle (max |d amp| <= 1e-6);
3. whole-circuit route: ``random_circuit(n, 100, seed=42)`` at n = 10, 14,
   16, 18 through the simulator against the oracle (max |d amp| <= 1e-6,
   one launch per run), its stages as planned (every op in one, at most 4
   at 18 qubits);
4. 18 qubits, the whole-circuit main path: ``StateVectorSimulator(18).run``
   then ``get_state``, ``probabilities``, ``sample`` and ``histogram``,
   counted; then the kernel against its plain version on the card
   (max |d amp| <= 1e-7, 1 - fidelity <= 1e-5); GHZ and QFT|0> closed forms;
5. 19 qubits, the segmented main path, counted, against the oracle
   (max |d amp| <= 1e-6; one launch for all segments, counted once in
   ``LAUNCHES``, whose tally in ``SEGMENT_KINDS`` shows that it ran both
   kinds, the last segment a scatter segment); the same kernel launched on each segment alone against that
   segment's plain version on the same input, and on all of them against
   the run's plain version (max |d amp| <= 1e-7); GHZ and QFT|0> closed
   forms;
6. grid fallback: a 6-qubit dense gate at 22 qubits that the grid planner
   refuses, planned whole by the grid row's engines, runs on the segmented
   engine in one launch and matches its plain version (1e-6), and through
   ``run`` (the route cuts there: grid pieces and a pass) matches it too;
   ``random_circuit(24, 100, seed=42)`` through the segmented program (more
   blocks than resident CTAs) and the grid-sweep program agrees within
   1e-6; an 8-qubit dense gate on qubits 14-21 of 22 (grid and sweeps
   refuse it) the same way, on the segmented engine 6 low bits kept in
   place, in one launch;
7. sweeps engine: ``random_circuit(22, 100, seed=42)`` through
   ``build_sweep_run`` against the oracle (1e-6); 26 qubits, the sweeps main
   path: ``random_circuit(26, 40, seed=42)``, an 8-qubit dense gate on
   qubits 10-17 (the grid planner refuses it), ``random_circuit(26, 40,
   seed=43)`` through ``StateVectorSimulator(26).run`` then readout,
   counted (only ``low_sweep``/``high_sweep``/``dense_pass``, the pass on
   the stream instance), its stages as planned (one tile stage per sweep
   but the low sweep with the 8-qubit core: tile, unit, tile) and its
   launches (each run of tile stages one launch of the instance for narrow
   cores, the unit stage through the dense pass,
   ``sweeps.MIN_UNIT_PASS_CORE``), against its plain version (1e-7, 1 -
   fidelity <= 1e-5), and each launch against the plain version of its
   gates on one input (1e-7); the unit stage on its own path (the route
   reaches it no more): ``SweepProgram`` of the same circuit with a 5-qubit
   core on 10-14, counted (one ``unit_stage``), against its plain version;
   ``random_circuit(26, 100, seed=42)`` through the sweeps (at most 6 tile
   stages) and the grid-sweep programs agrees within 1e-6;
8. dense cores of 7-10 qubits through ``run`` (the tiled op up to 9
   qubits, 10 through the dense pass between the row's pieces; the
   sweeps' unit stages from 6): the whole
   circuit at 12 qubits, and a 9-qubit core at 10 (its tiled op on more
   threads than the tile has), against the oracle, segments at 22 (7
   qubits on 15-21), the grid sweep at 26 (on qubits 0..k-1) and the low
   sweep at 26 against their plain versions (1e-6); the segments' and the
   grid sweep's cases, which the route cuts (``dispatch.GRID_CUTS``), run
   planned whole and through ``run``;
8b. dense cores of 12 qubits, the split route: ``random_circuit(n, 40,
    seed=42)``, a 12-qubit dense gate on qubits 0-11, ``random_circuit(n,
    40, seed=43)`` through ``StateVectorSimulator(n).run``, counted: at 16
    qubits whole-circuit launches around one dense pass, against the
    complex128 oracle (1e-6) and its plain version (1e-7); at 22 grid-sweep
    launches around it, against its plain version (1e-7); the pass alone on
    a random state against its plain version and against ``torch.matmul``
    of the core on the complex64 view (TF32 off), 1e-7 each, and timed
    beside both at 16 and 22 qubits, with two bounds and the share of each:
    the float32 FMAs' (any design without tensor cores) and this design's
    (three TF32 tensor-core products per real one);
8d. dense cores of 7-9 qubits alone (``tune_route --passes``): at 26 and
    28 qubits a 7-, 8- and 9-qubit core on the lowest, middle and highest
    qubits, an 8-qubit core under a control, and the 6-qubit core widened
    to 7, each on ``dense_pass.cu``'s stream and large instances in turns,
    each launch's instance asserted by ``PASS_INSTANCES``, against the
    plain version and ``torch.matmul`` of the core (1e-7 each), timed
    beside the matmul (TF32 off; without and with the planes-to-complex64
    copies), the plain version and the 3xTF32 bound;
8c. the route by width: cores of 10 and 11 qubits on the grid and
    segmented rows, and on the grid row from 22 qubits cores of 7+ (8+ at
    27) and every gate the grid planner refuses where the segments or the
    torch engine would take the circuit, take the dense pass between the
    row's pieces. At 26 qubits ``random_circuit(26, 40, seed=42)``, a
    seeded k-qubit unitary on qubits 0..k-1, ``random_circuit(26, 40,
    seed=43)`` for k = 8 and 10; built the same way, a 10-qubit core on
    qubits 9-18 of 19 (segmented pieces), on 12-21 of 22 and an 11-qubit
    core on 17-27 of 28, and the refused cores 9 on 18-26 of 27, 6 on
    11-16 (widened to 7) and 8 on 20-27 of 28, 7 on 23-29 of 30 (the torch
    engine ran these whole before) and 8 on 18-25 of 26 (the segments):
    each through ``StateVectorSimulator(n).run``, engines, launches and
    the pass's instance asserted, against its plain version and (up to 26 qubits) the
    complex128 oracle (1e-6; the 26-qubit ones computed in worker
    processes from the start of the run, the phase run late), timed, with
    the peak device memory of one run over the state's, the pass alone
    beside its bound and, from 27 qubits, the torch engine's run;
9. 28 qubits, the grid-sweep main path: ``StateVectorSimulator(28).run``
   then readout, counted; the kernel against its plain torch version
   (max |d amp| <= 1e-7, 1 - fidelity <= 1e-5);
9b. native host planner: ``random_circuit(n, G, seed=42)`` at (n, G) =
    (12, 100), (19, 100), (28, 100), (28, 1000) planned by the native and
    the plain (Python) planners, grid sweeps and fusion groups identical,
    host ms of each; the first ``run`` of ``random_circuit(28, 100)``,
    ``(12, 100)`` and ``(28, 1000)`` (plan + launch) against the cached
    run; the 28-qubit main path planned natively, its program the plain
    planners', against its plain version (1e-7) and phase 9's state (1e-7);
    the histogram of 10^6 shots of that state (``np.unique``) against the
    samples' counts, with its ms and the host memory it takes;
9c. fixtures: every case of ``validation/fixtures``' Cirq and Qiskit packs
    (67 cases, 4-10 qubits, built by ``tpu_qsim_torch.fixture_corpus``) in float32 on the card at its own width (the
    torch engine below 10 qubits, the whole-circuit kernel at 10) and
    padded with idle qubits to 12 (the whole-circuit kernel), against both
    packs (1e-6 up to a global phase; Cirq's through the bit-reversal
    adapter);
9d. floor certificate (``tpu_qsim_torch.kernels.floor``) at 28 qubits: the
    rotation-chain kernel against its plain version at K = 16, 64, 256 on
    seeded random unit-norm planes (max |d amp| <= 1e-7, 1 - fidelity <=
    1e-5); then ``--vpu`` counted (only ``rotation_chain``), its rate over
    [16->64] and [64->256] (6 flops, 4 float32 instructions per amplitude
    per step) beside the SM clock under load and the peak at that clock,
    the SASS's FMUL and FFMA (equal, 16 amplitudes x 2 each per step copy,
    no FADD), the plain version timed at K = 256 and the library call, one
    ``torch.matmul`` of the K rotations folded into one (1e-7 against the
    plain chain; 1/K of its arithmetic); ``--decompose`` (the
    production plan, streaming only, each sweep alone; the full variant's
    state against phase 9's, 1e-6) and ``--scale`` for the reg, lane and
    extctrl flavors, each counted (only ``grid_sweep``); the census model's
    floor per op class and per sweep at the measured rate, and each sweep's
    time beside the larger of its bytes and its census ops floor at the
    data sheet's rate (the kernels line gives row 1 that sum beside its
    bytes bound); ``--stamps`` (the grid sweep's stamp instance, built from
    the same source with ``QSIM_STAMPS``): warp 0's cycles a step and an op
    class on the 28q plan's sweeps and ``--scale``'s 32 CNOTs, at full
    occupancy and at one CTA an SM;
10. 28-qubit closed forms through the grid-sweep kernel: GHZ probabilities
    and histogram, QFT|0> amplitudes;
11. timing with CUDA events (median of 5 after a warm-up) of the 28-qubit
    grid-sweep run, the whole-circuit route at 12, 16 and 18 qubits, the
    segment kernel at 19 (the run's one launch, and each segment launched
    alone) and the 26-qubit sweeps runs (each sweep, each launch beside its
    bound, each kernel's share, the unit stage beside one ``torch.matmul``
    of its core, and the grid sweep on the same random circuit), beside
    the plain versions, the torch engine (the route below 20 qubits before
    these kernels) and the bound; and the cost of one 6- to 10-qubit dense
    op in a low sweep and a grid sweep at 26 qubits beside its flops bound
    and one ``torch.matmul`` of the core on the complex64 state (TF32 off;
    without and with the planes-to-complex64 copies), the op checked
    against the matmul (1e-7), k = 5 to 11: its bounds are the flops over
    float32 FMAs and this design's, three TF32 tensor-core products per
    real one; for k >= 7 the dense pass of the same core on the same state
    beside it (checked against the matmul at 1e-7; the sweeps route takes
    it for cores of 10 and 11 qubits, and that route's one-op run is checked
    against the matmul too). Below 20 qubits a
    kernel's time is its device time, from CUDA-graph replays of its
    launches (many per event pair); the eager time through the Python
    wrappers is printed beside it;
12. certify at 29 and 30 qubits on the grid-sweep kernel (launches counted):
    the QFT and diagonal-layer closed forms (< 5e-6 and <= 1e-4 x 2^(-n/2))
    and the permutation check (< 5e-6), with the peak device memory of each
    size and the QFT run timed; the cross-engine check at 28 (grid sweep
    against the torch engine, < 5e-6);
13. noisy: ``NoisySimulator(24)`` on ``random_circuit(24, 40, seed=42)``
    with every channel at p = 0 against ``StateVectorSimulator(24)``
    (1e-5); with a global depolarizing channel and amplitude damping on
    qubits 0-3 at 1e-3, the norm within 1e-4, timed; the ensemble of
    ``BatchedSimulator(10, 1024)`` against ``DensityMatrixSimulator(10)``'s
    rho, ``insertion="all"``: |mean_b p_b(x) - rho_xx| <= 5 std_b / sqrt(B)
    + 1e-6 for every x; ``BatchedSimulator(20, 128)`` on
    ``random_circuit(20, 10, seed=42)`` timed;
14. density matrix: ``DensityMatrixSimulator(14)`` on
    ``random_circuit(14, 40, seed=42)`` with depolarizing and amplitude
    damping (trace within 1e-4, valid, purity < 1), timed; the noiseless
    rho's fidelity with ``StateVectorSimulator(14)`` >= 1 - 1e-5; 8-qubit
    rho on the card against the CPU (1e-5);
15. variational: ``build_expectation_fn(hardware_efficient_ansatz(20, 4),
    tfim_hamiltonian(20))``: the autograd gradient against the parameter
    shift on 4 rotations (1e-3), a batch of 8 parameter vectors against 8
    single calls (1e-5), value and gradient timed; ``vqe_minimize`` on
    ``tfim_hamiltonian(10)`` for 50 steps descends (the exact ground energy
    printed beside it).

16. sharded: 4 ranks on the one card (gloo: NCCL refuses two ranks on one
    device), spawned and joined under a deadline: ``random_circuit(28, 100,
    seed=42)`` through ``ShardedStateVectorSimulator(28, engine="sweeps")``
    ("auto" picks "collective" there), the grid-sweep kernel on every rank's
    26-qubit shard, exactly the plan's ``all_to_all`` calls, each shard
    against its slice of ``StateVectorSimulator(28).run`` (1e-6), timed (the
    run after a barrier, its exchanges, its local work by CUDA events, each
    rank's segment programs alone, each rank's peak); ``random_circuit(20,
    100, seed=42)`` with the whole-circuit kernel on 18-qubit shards (one
    launch a segment) and on the replicated "gspmd" engine ("auto" there),
    both against the oracle (1e-6); GHZ-28's total probability, <Z_27>,
    <Z_27 Z_26>, a 1000-shot histogram (the same on every rank) and
    ``measure_qubit`` on a device and a local qubit; ``ShardedBatchedSimulator
    (20, 128)`` over dp = 4 against ``BatchedSimulator(20, 128)`` with the
    same seed (1e-6), and dp 2 x tp 2 at 16 qubits;
17. demo: ``python -m tpu_qsim_torch`` exits 0 with the Bell state's |00>
    and |11> at P = 0.5000;
18. profiler: a 20-qubit run inside ``utils.profiler_trace``; the trace
    holds the grid sweep's kernel events.

Phases 12-15 run on the torch engine (certify on the grid-sweep kernel), on
the card; each prints its ms (CUDA events, median of 5 after a warm-up) and
peak device memory. Phase 16 writes its rendezvous files, and phase 18 its
trace, under ``.smoke_run/``. Before its last lines the run checks that no
module of JAX, Flax or ``tpu_qsim`` was ever imported. Every check raises
on failure. The last two lines are the kernels JSON and
the device JSON; the exit code is 0 only if every phase passed.
"""

from __future__ import annotations

import collections
import concurrent.futures
import json
import math
import multiprocessing
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import tracemalloc

import numpy as np
import torch
import torch.distributed as dist

import tpu_qsim_torch as tq
from tpu_qsim_torch import apply as ap
from tpu_qsim_torch import certify, fixture_corpus, fusion, native, utils
from tpu_qsim_torch.base import counts_to_histogram
from tpu_qsim_torch.fusion import fuse_circuit
from tpu_qsim_torch.gates import GATE_ARITY, register_gate
from tpu_qsim_torch.kernels import (
    LAUNCHES, PASS_INSTANCES, SEGMENT_KINDS, _build, dispatch, gridsweeps, reset_launches,
)
from tpu_qsim_torch.kernels.dense_pass import MIN_PASS_CORE, DensePass, core_operand, dense_pass, pass_instance
from tpu_qsim_torch.kernels import floor, sass_census
from tpu_qsim_torch.kernels.fused_circuit import (
    MAX_SWEEP_BITS, NARROW_CORE, WholeCircuitProgram, as_pgates, build_op_table,
    merge_1q_chains, tiled_op_sass,
)
from tpu_qsim_torch.kernels.gridsweeps import (
    A_MAX, WIDE_BLK_BITS, GridParams, GridSweepProgram, grid_sweep,
)
from tpu_qsim_torch.kernels.segmented import SegmentedProgram, resident_ctas
from tpu_qsim_torch.kernels.sweeps import (
    MIN_SWEEP_PASS_CORE, MIN_UNIT_PASS_CORE, SweepProgram, build_sweep_run,
)
from tpu_qsim_torch.kernels.time_run import kron_gate
from tpu_qsim_torch.kernels.tune_route import passes as stream_passes
from tpu_qsim_torch.parallel import ShardedBatchedSimulator, ShardedStateVectorSimulator, make_mesh
from tpu_qsim_torch.ranks import run_ranks
from tpu_qsim_torch.statevector import build_torch_run_fn

N_MAIN = 28
N_WHOLE = 18       # the whole-circuit kernel's main path
N_SEG = 19         # the segmented engine's main path
N_SWEEPS = 26      # the sweeps engine's main path
N_SWEEPS_ORACLE = 22
SMS = 132          # H100 SXM
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # non-tensor-core float32 peak, same source
TF32_FLOP_PER_S = 495e12       # dense TF32 tensor-core peak, same source
MAX_WHOLE_STAGES = 4           # random_circuit(18, 100, seed=42) at its geometry


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def compare(a: torch.Tensor, b: torch.Tensor) -> tuple[float, float]:
    """(max |a - b| over complex amplitudes, |<a|b>|^2) of two planes
    states, in float64 slices so no full-size temporary is made."""
    worst, re, im = 0.0, 0.0, 0.0
    step = 1 << 24
    for s in range(0, a.shape[1], step):
        x, y = a[:, s:s + step].double(), b[:, s:s + step].double()
        d = x - y
        worst = max(worst, float(torch.sqrt(d[0] * d[0] + d[1] * d[1]).max()))
        r, i = ap.inner_product(x, y)
        re, im = re + float(r), im + float(i)
    return worst, re * re + im * im


def phase_build() -> dict:
    native.library()       # the host planner, g++ (phase native reads its time)
    built = native.build_log
    log(f"build: native/fusion.cpp {f'built in {built[0]:.2f} s' if built else 'reused'}")
    t0 = time.perf_counter()
    names = tuple(_build.SIGNATURES)
    _build.build_all(names)
    for name in names:
        _build.library(name)
    wall = time.perf_counter() - t0
    for name in names:
        built = _build.build_log.get(name)
        if built is not None:
            for line in built[1].splitlines():
                if "registers" in line or "spill" in line or "Compiling" in line:
                    log(f"ptxas {name}: {line.strip()[:200]}")
        log(f"build: {name}.cu {f'built in {built[0]:.2f} s' if built else 'reused'}")
    log(f"build: {len(names)} libraries in {wall:.2f} s")
    check(wall < 60.0, f"build took {wall:.1f} s (limit 60 s)")
    sass = tiled_op_sass()
    for key, counts in sass.items():
        log(f"sass tiled op: {key.split(':')[0]} {key.split(':')[1][-48:]} {json.dumps(counts)}")
    check(sorted(key.split(":")[0] for key in sass) == ["grid_sweep", "segment", "sweep", "sweep", "sweep"]
          and all(c["HMMA"] > 0 and c["FFMA"] == 0 and c["kernel_HMMA"] == 0 for c in sass.values()),
          f"the tiled op's SASS: {sass}")
    return {"build_s": wall, "tiled_op_sass": sass}


def oracle_planes(circuit, device) -> torch.Tensor:
    ref = tq.CPUReferenceSimulator(circuit.num_qubits)
    ref.run(circuit)
    return torch.from_numpy(np.stack([ref.state.real, ref.state.imag])).to(device)


def random_planes(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    return torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32)).cuda()


def phase_20q_oracle() -> dict:
    t0 = time.perf_counter()
    c = tq.random_circuit(20, 100, seed=42)
    sim = tq.StateVectorSimulator(20, seed=42)
    sim.run(c)
    check(sim.engine == "grid_sweep", f"20q ran on {sim.engine}")
    ref = tq.CPUReferenceSimulator(20)
    ref.run(c)
    got = sim.state_planes
    want = torch.from_numpy(np.stack([ref.state.real, ref.state.imag])).to(got.device)
    err, fid = compare(got, want)
    wall = time.perf_counter() - t0
    log(f"phase 20q_oracle: wall_s={wall:.3f} max_abs_err={err:.3e} (tol 1e-6) fidelity={fid:.9f}")
    check(err <= 1e-6, f"20q max |d amp| {err} > 1e-6")
    return {"max_abs_err": err, "fidelity": fid}


def phase_main(n: int, engine: str, kernels: tuple[str, ...], circuit=None) -> dict:
    """A main path (``random_circuit(n, 100, seed=42)`` unless ``circuit`` is
    given), counted; then its kernels against their plain version."""
    c = tq.random_circuit(n, 100, seed=42) if circuit is None else circuit
    t0 = time.perf_counter()
    reset_launches()
    sim = tq.StateVectorSimulator(n, seed=42)
    sim.run(c)
    psi = sim.get_state()
    probs = sim.probabilities()
    total = float(probs.sum(dtype=torch.float64))
    samples = sim.sample(1000)
    hist = sim.histogram(1000)
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in kernels}
    kinds = dict(SEGMENT_KINDS)
    wall = time.perf_counter() - t0
    eng, prog = sim.compiled_run(c)
    check(sim.engine == engine and eng == engine, f"{n}q ran on {sim.engine}")
    check(sum(launches.values()) == sum(LAUNCHES.values()),
          f"{n}q launched other kernels: {dict(LAUNCHES)}")
    check(psi.shape == (1 << n,) and bool(np.isfinite(psi).all()), "state not finite")
    check(abs(total - 1.0) < 1e-4, f"total probability {total}")
    check(tuple(samples.shape) == (1000,) and int(samples.min()) >= 0
          and int(samples.max()) < (1 << n), "samples out of range")
    check(sum(hist.values()) == 1000, "histogram does not hold 1000 shots")
    check(bool((probs[samples] > 0).all()), "a sample hit a zero-probability state")
    del psi, probs
    log(f"phase {n}q_main: wall_s={wall:.3f} engine={engine} launches={launches}")

    t0 = time.perf_counter()
    plain = prog.run_plain(ap.initial_state(n, np.float32, device="cuda"))
    err, fid = compare(sim.state_planes, plain)
    del plain
    wall = time.perf_counter() - t0
    log(f"phase {n}q_vs_plain: wall_s={wall:.3f} max_abs_err={err:.3e} (tol 1e-7) "
        f"fidelity={fid:.9f} (tol 1 - 1e-5)")
    check(err <= 1e-7, f"{n}q kernel vs plain max |d amp| {err} > 1e-7")
    check(1.0 - fid <= 1e-5, f"{n}q 1 - fidelity {1.0 - fid} > 1e-5")
    return {"sim": sim, "prog": prog, "launches": launches, "segment_kinds": kinds,
            "max_abs_err": err, "fidelity": fid}


def phase_28q_main() -> dict:
    res = phase_main(N_MAIN, "grid_sweep", ("grid_sweep",))
    prog = res["prog"]
    check(res["launches"]["grid_sweep"] == prog.num_sweeps,
          f"{res['launches']} launches for {prog.num_sweeps} sweeps")
    log(f"phase 28q_main: sweeps={prog.num_sweeps} "
        f"gates_per_sweep={[len(g) for g in prog.sweep_gates]}")
    res["launches"] = res["launches"]["grid_sweep"]
    return res


NATIVE_PLANS = ((12, 100), (19, 100), (28, 100), (28, 1000))
FIRST_RUNS = ((N_MAIN, 100), (12, 100), (N_MAIN, 1000))
HISTOGRAM_SHOTS = 1_000_000


class plain_planners:
    """Within the block, the port plans with its Python planners (the plain
    versions of the native library's): fusion groups and the grid planner's
    frontier scheduling."""

    def __enter__(self):
        self._saved = (fusion.plan_groups, gridsweeps._frontier_sweeps)
        fusion.plan_groups = fusion._plan_groups_python
        gridsweeps._frontier_sweeps = gridsweeps._frontier_sweeps_python

    def __exit__(self, *exc):
        fusion.plan_groups, gridsweeps._frontier_sweeps = self._saved


def host_cpu() -> str:
    """The host CPU from the first entry of /proc/cpuinfo: its model name
    (which some virtualized hosts report as "unknown"), vendor, family and
    model numbers, clock, and the CPUs this process sees."""
    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            if not line.strip():
                break
            key, _, value = line.partition(":")
            info[key.strip()] = value.strip()
    return (f"{info.get('model name', '?')} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{info.get('cpu MHz', '?')} MHz, {os.cpu_count()} CPUs)")


def host_ms(fn, reps: int = 3) -> tuple[float, object]:
    """(median host ms of ``reps`` calls, the last call's result)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def gate_lists(sweeps_gates) -> list:
    """Each sweep's gates as (qubits, matrix bytes), in emission order."""
    return [[(tuple(g.qubits), g.u.tobytes()) for g in gates] for gates in sweeps_gates]


def synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def phase_native(main_res: dict) -> dict:
    """The native host planner (``tpu_qsim_torch/native``): its build, the
    native and plain planners' plans and times, the first run of a circuit
    (plan + launch) against the cached run, the 28-qubit main path planned
    natively and by the plain planners on the grid-sweep kernel, and the
    histogram of 10^6 shots of that state (``np.unique``, O(shots))."""
    t_phase = time.perf_counter()
    out = {"host_cpu": host_cpu(), "library": native.library_path().name,
           "build_s": native.build_log[0] if native.build_log else None}
    log(f"phase native: host_cpu={out['host_cpu']!r} library={out['library']} "
        f"g++_s={out['build_s']}")

    out["plans"] = {}
    for n, g in NATIVE_PLANS:
        c = tq.random_circuit(n, g, seed=42)
        grid_ms, grid = host_ms(lambda: gridsweeps.plan_grid_sweeps(c))
        groups_ms, groups = host_ms(lambda: fusion.plan_groups(c))
        merge_ms, _ = host_ms(lambda: merge_1q_chains(as_pgates(c.gates)))
        with plain_planners():
            grid_plain_ms, grid_plain = host_ms(lambda: gridsweeps.plan_grid_sweeps(c))
            groups_plain_ms, groups_plain = host_ms(lambda: fusion.plan_groups(c))
        check(gate_lists(s.gates for s in grid) == gate_lists(s.gates for s in grid_plain)
              and [s.active for s in grid] == [s.active for s in grid_plain],
              f"{n}q/{g}: native and plain grid plans differ")
        check(groups == groups_plain, f"{n}q/{g}: native and plain fusion groups differ")
        row = {"sweeps": len(grid), "groups": len(groups),
               "grid_ms": grid_ms, "grid_plain_ms": grid_plain_ms, "merge_1q_ms": merge_ms,
               "groups_ms": groups_ms, "groups_plain_ms": groups_plain_ms}
        out["plans"][f"{n}q_{g}"] = row
        log(f"phase native: plan random_circuit({n}, {g}, seed=42) identical: "
            f"sweeps={row['sweeps']} grid_ms={grid_ms:.3f} grid_plain_ms={grid_plain_ms:.3f} "
            f"(both: merge_1q_chains {merge_ms:.3f}) "
            f"groups={row['groups']} groups_ms={groups_ms:.3f} "
            f"groups_plain_ms={groups_plain_ms:.3f}")

    out["first_run"] = {}
    for n, g in FIRST_RUNS:
        c = tq.random_circuit(n, g, seed=42)
        sim = tq.StateVectorSimulator(n, seed=42)
        first = synced_ms(lambda: sim.run(c))
        cached = statistics.median([synced_ms(lambda: sim.run(c)) for _ in range(3)])
        plan_ms, _ = host_ms(lambda: dispatch.plan_run(c, np.float32, sim.device), reps=1)
        row = {"engine": sim.engine, "first_ms": first, "cached_ms": cached, "plan_ms": plan_ms}
        out["first_run"][f"{n}q_{g}"] = row
        log(f"phase native: first run {n}q/{g} engine={sim.engine} first_ms={first:.3f} "
            f"cached_ms={cached:.3f} plan_ms={plan_ms:.3f}")
        del sim

    c = tq.random_circuit(N_MAIN, 100, seed=42)
    reset_launches()
    sim = tq.StateVectorSimulator(N_MAIN, seed=42).run(c)
    torch.cuda.synchronize()
    launches = LAUNCHES["grid_sweep"]
    prog = sim.compiled_run(c)[1]
    check(sim.engine == "grid_sweep", f"28q native ran on {sim.engine}")
    check(launches == main_res["launches"] == prog.num_sweeps,
          f"28q native: {launches} launches, 28q_main {main_res['launches']}")
    check([len(gs) for gs in prog.sweep_gates]
          == [len(gs) for gs in main_res["prog"].sweep_gates], "28q native: another plan")
    with plain_planners():
        plain_prog = GridSweepProgram(c)
    check(gate_lists(prog.sweep_gates) == gate_lists(plain_prog.sweep_gates),
          "28q: the native and the plain planners' programs differ")
    same = compare(sim.state_planes, main_res["sim"].state_planes)[0]
    plain = prog.run_plain(ap.initial_state(N_MAIN, np.float32, device="cuda"))
    err, fid = compare(sim.state_planes, plain)
    del plain
    out["main"] = {"launches": launches, "max_abs_err": err, "fidelity": fid,
                   "max_abs_err_vs_28q_main": same}
    log(f"phase native: 28q main path planned natively launches={launches} "
        f"max_abs_err={err:.3e} (tol 1e-7; 28q_main {main_res['max_abs_err']:.3e}) "
        f"fidelity={fid:.9f} vs 28q_main state max_abs_err={same:.3e}")
    check(err <= 1e-7, f"28q native vs plain max |d amp| {err} > 1e-7")
    check(same <= 1e-7, f"28q native vs the 28q_main state max |d amp| {same} > 1e-7")

    samples = sim.sample(HISTOGRAM_SHOTS).cpu().numpy()
    del sim
    hist_ms, hist = host_ms(lambda: counts_to_histogram(samples))
    check(hist == collections.Counter(samples.tolist()), "histogram != the samples' counts")
    check(sum(hist.values()) == HISTOGRAM_SHOTS, "histogram does not hold every shot")
    tracemalloc.start()
    counts_to_histogram(samples)
    traced = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    rss_gib = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    out["histogram"] = {"shots": HISTOGRAM_SHOTS, "bins": len(hist), "ms": hist_ms,
                        "traced_peak_mib": traced / 2**20, "process_peak_rss_gib": rss_gib}
    log(f"phase native: histogram shots={HISTOGRAM_SHOTS} bins={len(hist)} ms={hist_ms:.3f} "
        f"traced_peak_mib={traced / 2**20:.1f} process_peak_rss_gib={rss_gib:.2f} "
        f"(2^28 int64 bins would be 2 GiB)")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase native: {out['phase_s']:.1f} s")
    return out


FIXTURES_PADDED = 12


def phase_fixtures() -> dict:
    """Every case of the Cirq and Qiskit fixture packs in float32 on the
    card: at its own width and padded with idle qubits to 12 (the
    whole-circuit kernel), each against both packs (1e-6, up to a global
    phase; the Cirq pack through the bit-reversal adapter)."""
    t0 = time.perf_counter()
    packs = {pack: np.load(os.path.join(ROOT, "validation", "fixtures", f"{pack}_fixtures.npz"))
             for pack in ("cirq", "qiskit")}
    cases = fixture_corpus.corpus()
    check(len(cases) == 67, f"{len(cases)} fixture cases")
    worst = {"own": 0.0, "padded": 0.0}
    engines: dict[str, int] = {}
    reset_launches()
    for name, n, gates in cases:
        for width in ("own", "padded"):
            c = tq.Circuit(n if width == "own" else FIXTURES_PADDED)
            for gname, qubits, param in gates:
                c.add(gname, *qubits, param=param)
            sim = tq.StateVectorSimulator(c.num_qubits).run(c)
            engines[sim.engine] = engines.get(sim.engine, 0) + 1
            psi = sim.get_state()
            if width == "padded":
                check(sim.engine == "whole_circuit", f"{name} padded ran on {sim.engine}")
                check(float(np.abs(psi[1 << n:]).max()) < 1e-6, f"{name}: idle qubits left |0>")
                psi = psi[:1 << n]
            psi = psi.astype(np.complex128)
            for pack in ("cirq", "qiskit"):
                got = utils.to_big_endian(psi, n) if pack == "cirq" else psi
                err = utils.max_amplitude_error(got, packs[pack][name], up_to_phase=True)
                worst[width] = max(worst[width], err)
                check(err <= 1e-6, f"fixture {name} ({pack}, {width} width) max |d amp| {err}")
    whole = LAUNCHES["whole_circuit"]
    check(whole >= len(cases), f"{whole} whole-circuit launches for {len(cases)} padded cases")
    wall = time.perf_counter() - t0
    log(f"phase fixtures: wall_s={wall:.3f} cases={len(cases)} x 2 packs engines={engines} "
        f"whole_circuit_launches={whole} max_abs_err own={worst['own']:.3e} "
        f"padded={worst['padded']:.3e} (tol 1e-6)")
    return {"cases": len(cases), "engines": engines, "max_abs_err": worst, "wall_s": wall}


FLOOR_SEED = 7


def folded_rotation(angles) -> np.ndarray:
    """The K rotations of a chain folded into one 2x2 float32 matrix
    (products in float64 of the kernel's float32 (cos, sin) pairs): one
    ``torch.matmul`` of it on the planes is the library call that computes
    the chain's function, with 1/K of its arithmetic."""
    m = np.eye(2)
    for c, s in floor.chain_table(angles).astype(np.float64):
        m = np.array([[c, -s], [s, c]]) @ m
    return m.astype(np.float32)


def phase_floor(main_res: dict) -> dict:
    """The floor certificate's modes at 28 qubits (``kernels/floor.py``):
    the rotation-chain kernel against its plain version at each K, the
    ``--vpu`` run counted, ``--decompose`` (its full variant against the 28q
    main path's state) and ``--scale`` for each flavor, counted, and the
    census model's floor at the measured rate."""
    t_phase = time.perf_counter()
    out = {"max_abs_err": {}, "fidelity": {}}
    x = floor.random_planes(N_MAIN, FLOOR_SEED, "cuda")
    for k in floor.VPU_KS:
        angles = floor.chain_angles(k)
        want = floor.rotation_chain_plain(x, angles)
        got = floor.rotation_chain(x.clone(), angles)
        err, fid = compare(got, want)
        del got, want
        out["max_abs_err"][k], out["fidelity"][k] = err, fid
        log(f"phase floor: rotation_chain K={k} vs plain max_abs_err={err:.3e} (tol 1e-7) "
            f"fidelity={fid:.9f} (tol 1 - 1e-5)")
        check(err <= 1e-7, f"rotation chain K={k} vs plain max |d amp| {err} > 1e-7")
        check(1.0 - fid <= 1e-5, f"rotation chain K={k} 1 - fidelity {1.0 - fid} > 1e-5")
    angles = floor.chain_angles(floor.VPU_KS[-1])
    out["plain_ms"] = median_ms(lambda: floor.rotation_chain_plain(x, angles), reps=1)
    log(f"phase floor: plain version K={floor.VPU_KS[-1]} ms={out['plain_ms']:.3f}")
    # the library call: the chain folded into one rotation, one float32 GEMM
    rot = torch.from_numpy(folded_rotation(angles)).to(x.device)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["library_ms"] = median_ms(lambda: torch.matmul(rot, x))
        err = compare(torch.matmul(rot, x), floor.rotation_chain_plain(x, angles))[0]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    del x
    out["library_max_abs_err"] = err
    log(f"phase floor: library torch.matmul of the folded rotation K={floor.VPU_KS[-1]} "
        f"ms={out['library_ms']:.4f} vs plain max_abs_err={err:.3e} (tol 1e-7; 1/K of the "
        f"chain's arithmetic)")
    check(err <= 1e-7, f"folded rotation vs plain chain max |d amp| {err} > 1e-7")

    reset_launches()
    vpu = floor.vpu(N_MAIN)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    out["launches"] = launches.get("rotation_chain", 0)
    check(out["launches"] > 0 and set(launches) == {"rotation_chain"},
          f"--vpu launches {launches}")
    floor.print_vpu(vpu)
    sass = vpu["sass"]
    check(sass.get("FMUL", 0) == sass.get("FFMA", 0) > 0 and sass["FMUL"] % 32 == 0
          and not sass.get("FADD"), f"rotation_chain SASS {sass}: not 2 FMUL + 2 FFMA a step")
    check(all(0 < a < b for a, b in zip(vpu["ms"], vpu["ms"][1:])), f"--vpu ms {vpu['ms']}")
    out["vpu"] = vpu
    rate = vpu["rates"][-1]["tinstr_per_s"]

    reset_launches()
    dec = floor.decompose(N_MAIN)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    err = compare(dec.pop("state"), main_res["sim"].state_planes)[0]
    log(f"phase floor: decompose gates_per_sweep={dec['gates_per_sweep']} "
        f"full_ms={dec['full_ms']:.4f} zero_gate_ms={dec['zero_gate_ms']:.4f} "
        f"sweep_ms={[round(t, 4) for t in dec['sweep_ms']]} "
        f"sum_of_sweeps_ms={dec['sum_of_sweeps_ms']:.4f} bytes_ms={dec['bytes_ms']:.4f} "
        f"exposed_ms={dec['exposed_ms']:.4f} exposed_us_per_gate={dec['exposed_us_per_gate']:.3f} "
        f"launches={launches} full vs 28q_main max_abs_err={err:.3e} (tol 1e-6)")
    check(launches.get("grid_sweep", 0) > 0 and set(launches) == {"grid_sweep"},
          f"--decompose launches {launches}")
    check(err <= 1e-6, f"decompose full variant vs the 28q main state {err} > 1e-6")
    dec["max_abs_err_vs_main"] = err
    out["decompose"] = dec

    out["scale"] = {}
    for flavor in floor.SCALE_FLAVORS:
        reset_launches()
        sc = floor.scale(N_MAIN, flavor)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        log(f"phase floor: scale {flavor} K={sc['ks']} ms={[round(t, 4) for t in sc['ms']]} "
            f"us_per_op={[round(s['us_per_op'], 3) for s in sc['us_per_op']]} launches={launches}")
        check(launches.get("grid_sweep", 0) > 0 and set(launches) == {"grid_sweep"},
              f"--scale {flavor} launches {launches}")
        out["scale"][flavor] = sc

    # each register-op class's decode in this build's SASS: the marked
    # instance of the grid sweep, whose opcodes are the main instance's but
    # its markers and alignment NOPs, and the census's DECODE
    match = sass_census.marks_match(_build)
    for fn, m in match.items():
        log(f"phase floor: SASS {fn[-44:]}: {m['marked']} instructions but its markers and NOPs "
            f"({m['nops'][0]} NOPs), the main instance {m['main']} ({m['nops'][1]}): "
            f"{'equal opcodes' if m['equal'] else m['differ']}, "
            f"{'in' if m['same_order'] else 'not in'} the same order")
    check(len(match) == 2 and all(m["equal"] for m in match.values()),
          f"the marked grid sweep's opcodes are not the main instance's: {match}")
    decode = sass_census.narrow_decode(sass_census.classes(_build))
    log(f"phase floor: SASS decode a class (narrow instance) {decode}; floor.DECODE {floor.DECODE}")
    check(decode == floor.DECODE, f"floor.DECODE {floor.DECODE} is not this build's {decode}")
    out["marks_match"], out["decode"] = match, decode

    po = floor.plan_only(N_MAIN, rate, decode)
    log(f"phase floor: census model ({po['model']}) at {po['tinstr_per_s']:.3f} T instructions/s "
        f"({po['rate_source']}), selects at the full-half float32 rate: "
        + ", ".join(f"{name} {c['floor_fast_sel_us']:.1f}-{c['floor_us']:.1f} us/op (loop model "
                    f"{c['loop_fast_sel_us']:.1f}-{c['loop_us']:.1f})"
                    for name, c in po["classes"].items())
        + f"; 28q plan ops floor {po['plan_ops_fast_sel_ms']:.4f}-{po['plan_ops_ms']:.4f} ms "
        f"(per sweep {[round(s['ops_ms'], 4) for s in po['plan']]}), bytes {po['plan_bytes_ms']:.4f} ms")
    out["census"] = po
    # each sweep's time beside the larger of its bytes and its census ops
    # floor (at the data sheet's rate, as the kernels line's bound), and
    # beside the loop model (the ops with their decode)
    sheet = floor.plan_only(N_MAIN, decode=decode)
    check(len(sheet["plan"]) == len(dec["sweep_ms"]), "the census plan is not the decompose plan")
    for i, (t, s) in enumerate(zip(dec["sweep_ms"], sheet["plan"])):
        lo, hi = max(s["bytes_ms"], s["ops_fast_sel_ms"]), max(s["bytes_ms"], s["ops_ms"])
        log(f"phase floor: 28q sweep[{i}] {t:.4f} ms against max(bytes, census ops floor) "
            f"{lo:.4f}-{hi:.4f} ms ({t / hi:.2f}-{t / lo:.2f}x); loop model "
            f"{max(s['bytes_ms'], s['loop_fast_sel_ms']):.4f}-{max(s['bytes_ms'], s['loop_ms']):.4f} ms")
    out["max_bytes_ops_ms"] = sheet["max_bytes_ops_ms"]
    out["census_ops_floor_ms"] = [sheet["plan_ops_fast_sel_ms"], sheet["plan_ops_ms"]]
    out["loop_model_ms"] = sheet["loop_model_ms"]
    log(f"phase floor: 28q plan {dec['full_ms']:.4f} ms against the sum of max(bytes, census ops "
        f"floor) {out['max_bytes_ops_ms'][0]:.4f}-{out['max_bytes_ops_ms'][1]:.4f} ms (data sheet "
        f"rate); loop model {out['loop_model_ms'][0]:.4f}-{out['loop_model_ms'][1]:.4f} ms")

    # --stamps: the stamp instance on one sweep against its plain version,
    # at each occupancy; then counted, cycles of warp 0 a step and an op
    prog = floor.decompose_programs(N_MAIN)["sweeps"][0]
    x = floor.random_planes(N_MAIN, FLOOR_SEED, "cuda")
    want = prog.run_plain(x.clone())
    for occ, one_per_sm in floor.OCCUPANCIES.items():
        got = x.clone()
        floor.stamp_rows(prog, got, one_per_sm)
        err, fid = compare(got, want)
        del got
        log(f"phase floor: stamp instance {occ}, 28q sweep[0] vs plain max_abs_err={err:.3e} "
            f"(tol 1e-7) fidelity={fid:.9f} (tol 1 - 1e-5)")
        check(err <= 1e-7, f"stamp instance {occ} vs plain max |d amp| {err} > 1e-7")
        check(1.0 - fid <= 1e-5, f"stamp instance {occ} 1 - fidelity {1.0 - fid} > 1e-5")
    del x, want
    reset_launches()
    st = floor.stamps(N_MAIN)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    stamped = 2 * sum(len(sweeps) for res in st["programs"].values() for sweeps in res.values())
    log(f"phase floor: --stamps launches {launches} (stamp instance: programs x occupancies x "
        f"sweeps x 2 = {stamped}; the clock reading's grid sweeps 200)")
    check(launches == {"grid_sweep_stamps": stamped, "grid_sweep": 200},
          f"--stamps launches {launches}, not {stamped} of the stamp instance and 200 grid sweeps")
    for name, res in st["programs"].items():
        for occ, sweeps in res.items():
            check(all(s["steps"] > 0 for s in sweeps), f"--stamps {name} {occ}: no step stamped")
    floor.print_stamps(st)
    out["stamps"] = st
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase floor: {out['phase_s']:.1f} s")
    return out


def phase_closed_forms(n: int, engine: str) -> dict:
    last = (1 << n) - 1
    t0 = time.perf_counter()
    before = sum(LAUNCHES.values())
    sim = tq.StateVectorSimulator(n, seed=7)
    sim.run(tq.ghz_circuit(n))
    check(sim.engine == engine, f"GHZ ran on {sim.engine}")
    p = sim.probabilities()
    p0, pl = float(p[0]), float(p[last])
    rest = float(p.sum(dtype=torch.float64)) - p0 - pl
    a0, al = complex(*sim.state_planes[:, 0].tolist()), complex(*sim.state_planes[:, last].tolist())
    ghz_err = max(abs(a0 - 2 ** -0.5), abs(al - 2 ** -0.5),
                  float(torch.sqrt(p[1:last].max())))
    ghz_fid = abs((a0 + al) * 2 ** -0.5) ** 2
    hist = sim.histogram(10000)
    del p
    log(f"phase {n}q_ghz: wall_s={time.perf_counter() - t0:.3f} p0={p0:.7f} plast={pl:.7f} "
        f"rest={rest:.3e} max_abs_err={ghz_err:.3e} fidelity={ghz_fid:.9f} hist={hist}")
    check(abs(p0 - 0.5) <= 1e-5 and abs(pl - 0.5) <= 1e-5, "GHZ end probabilities")
    check(rest <= 1e-5, f"GHZ leaked {rest}")
    check(set(hist) <= {0, last}, f"GHZ histogram keys {sorted(hist)[:4]}")
    sigma = math.sqrt(10000 * 0.25)
    check(all(abs(hist.get(k, 0) - 5000) <= 5 * sigma for k in (0, last)),
          f"GHZ histogram {hist} beyond 5 sigma of 5000")

    t0 = time.perf_counter()
    sim.reset()
    sim.run(tq.qft_circuit(n))
    check(sim.engine == engine, f"QFT ran on {sim.engine}")
    st = sim.state_planes
    amp = 2.0 ** -(n / 2)
    qft_err = 0.0
    step = 1 << 24
    for s in range(0, st.shape[1], step):
        d = st[:, s:s + step].double()
        qft_err = max(qft_err, float(torch.sqrt((d[0] - amp) ** 2 + d[1] ** 2).max()))
    mag_err = float((torch.sqrt(sim.probabilities()) - amp).abs().max())
    ov_re = float(st[0].sum(dtype=torch.float64)) * amp
    ov_im = float(st[1].sum(dtype=torch.float64)) * amp
    qft_fid = ov_re ** 2 + ov_im ** 2
    wall = time.perf_counter() - t0
    log(f"phase {n}q_qft: wall_s={wall:.3f} max_abs_err={qft_err:.3e} max_mag_err={mag_err:.3e} "
        f"(tol 1e-6) fidelity={qft_fid:.9f} launches={sum(LAUNCHES.values()) - before}")
    check(mag_err <= 1e-6, f"QFT |amp| off 2^-{n / 2:g} by {mag_err}")
    return {"ghz_max_abs_err": ghz_err, "qft_max_mag_err": mag_err}


def phase_whole_circuit_oracle() -> dict:
    errs = {}
    for n in (10, 14, 16, N_WHOLE):
        t0 = time.perf_counter()
        c = tq.random_circuit(n, 100, seed=42)
        reset_launches()
        sim = tq.StateVectorSimulator(n, seed=42)
        sim.run(c)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        _, prog = sim.compiled_run(c)
        err, fid = compare(sim.state_planes, oracle_planes(c, sim.device))
        stages = check_whole_stages(prog)
        log(f"phase {n}q_whole_circuit_oracle: wall_s={time.perf_counter() - t0:.3f} "
            f"max_abs_err={err:.3e} (tol 1e-6) fidelity={fid:.9f} launches={launches} "
            f"tiles=2^{prog.tile_bits} slots, {prog.ctas} CTAs x {prog.threads} threads, "
            f"ops={len(prog.gates)} stages={stages}")
        check(sim.engine == "whole_circuit", f"{n}q ran on {sim.engine}")
        check(launches == {"whole_circuit": 1}, f"{n}q launches {launches}")
        check(err <= 1e-6, f"{n}q max |d amp| {err} > 1e-6")
        errs[n] = err
    return errs


def check_whole_stages(prog) -> list:
    """The whole-circuit program's stages ((kind, ops) each): every merged
    op in one stage, in order; at most ``MAX_WHOLE_STAGES`` for the main
    path's circuit at 18 qubits."""
    stages = [(st.kind, len(st.gates)) for st in prog.stages]
    check([id(g) for st in prog.stages for g in st.gates] == [id(g) for g in prog.gates],
          f"{prog.num_qubits}q stages do not hold the ops in order")
    if prog.num_qubits == N_WHOLE:
        check(len(stages) <= MAX_WHOLE_STAGES,
              f"{N_WHOLE}q in {len(stages)} stages (at most {MAX_WHOLE_STAGES})")
    return stages


def check_one_launch(prog, launches: dict, kinds: dict, label: str) -> None:
    """A run of ``prog``'s segments was one launch of the segment kernel
    and no other kernel, and that launch ran every kind of segment the plan
    holds."""
    check(launches == {"segment": 1}, f"{label}: launches {launches}, not one")
    want = {k: 1 for k in dict.fromkeys(s.kernel for s in prog.steps)}
    check(kinds == want, f"{label}: the launch ran kinds {kinds}, the plan {want}")


def phase_segmented() -> dict:
    """19q: the segmented main path against the oracle, then the kernel on
    each segment alone against the segment's plain version on the same
    input, and on all segments against the run's plain version."""
    n = N_SEG
    res = phase_main(n, "segmented", ("segment",))
    prog = res["prog"]
    kinds = [s.kernel for s in prog.steps]
    check_one_launch(prog, res["launches"], res["segment_kinds"], f"{n}q main path")
    check("scatter_segment" in kinds, f"no scatter segment in {kinds}")
    check(prog.restore == tuple(range(n)) or kinds[-1] == "scatter_segment",
          "a non-identity restore without a scatter segment")
    c = tq.random_circuit(n, 100, seed=42)
    err, fid = compare(res["sim"].state_planes, oracle_planes(c, res["sim"].device))
    log(f"phase {n}q_segmented_oracle: max_abs_err={err:.3e} (tol 1e-6) fidelity={fid:.9f} "
        f"segments={kinds} local_bits={prog.local_bits} ops={[len(s.gates) for s in prog.steps]} "
        f"launches={res['launches']} segment_kinds={res['segment_kinds']}")
    check(err <= 1e-6, f"{n}q segmented max |d amp| {err} > 1e-6")
    step_err = {"segment": 0.0, "scatter_segment": 0.0}
    x0 = x = random_planes(n, 5)
    for i, step in enumerate(prog.steps):
        want = prog.step_plain(x, i)
        e, _ = compare(prog.launch(x.clone(), i, i + 1), want)
        step_err[step.kernel] = max(step_err[step.kernel], e)
        x = want
    run_err, _ = compare(prog.launch(x0.clone()), x)
    log(f"phase {n}q_segment_vs_plain: max_abs_err={step_err} (each segment alone) "
        f"run_max_abs_err={run_err:.3e} (tol 1e-7)")
    check(max(step_err.values()) <= 1e-7, f"segment kernels vs plain {step_err}")
    check(run_err <= 1e-7, f"segments in one launch vs plain {run_err}")
    res["oracle_err"] = err
    res["step_err"] = step_err
    res["run_err"] = run_err
    return res


def _dense_gate(k: int) -> str:
    name = f"chip_smoke_dense{k}"
    if name not in GATE_ARITY:
        rng = np.random.default_rng(1)
        m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
        register_gate(name, np.linalg.qr(m)[0])
    return name


def phase_grid_fallback() -> dict:
    n = 22
    c = tq.random_circuit(n, 40, seed=42)
    c.add(_dense_gate(6), *range(n - 6, n))
    for g in tq.random_circuit(n, 40, seed=43).gates:
        c.add(g.name, *g.qubits, param=g.param)
    t0 = time.perf_counter()
    prog, launches, kinds, got, plain = run_row_whole(c)
    err, _ = compare(got, plain)
    route, route_err = run_route_cut(c, plain)
    log(f"phase {n}q_grid_fallback: wall_s={time.perf_counter() - t0:.3f} "
        f"launches={launches} local_bits={prog.local_bits} max_abs_err={err:.3e} (tol 1e-6) "
        f"route={route} route_max_abs_err={route_err:.3e}")
    check(isinstance(prog, SegmentedProgram), f"{n}q fallback planned {type(prog).__name__}")
    check_one_launch(prog, launches, kinds, f"{n}q grid fallback")
    check(err <= 1e-6, f"{n}q fallback vs plain {err} > 1e-6")
    del got, plain

    n = 24
    t0 = time.perf_counter()
    c = tq.random_circuit(n, 100, seed=42)
    sprog, gprog = SegmentedProgram(c), GridSweepProgram(c)
    a = sprog.run(ap.initial_state(n, np.float32, device="cuda"))
    b = gprog.run(ap.initial_state(n, np.float32, device="cuda"))
    cross, fid = compare(a, b)
    blocks = 1 << (n - sprog.local_bits)
    resident = resident_ctas(a.device, sprog.local_bits, sprog.table.max_core > 4)
    log(f"phase {n}q_cross_engine: wall_s={time.perf_counter() - t0:.3f} segments={sprog.num_segments} "
        f"blocks={blocks} resident_ctas={resident} sweeps={gprog.num_sweeps} "
        f"max_abs_err={cross:.3e} (tol 1e-6) fidelity={fid:.9f}")
    check(blocks > resident, f"{n}q: {blocks} blocks, {resident} resident CTAs")
    check(cross <= 1e-6, f"{n}q segmented vs grid sweep {cross} > 1e-6")
    return {"fallback_err": err, "cross_err": cross}


def run_row_whole(c) -> tuple:
    """The grid row's engines' program for ``c``, planned whole (for a
    circuit the grid planner refuses: the sweeps or the segments), run on
    the card from |0..0>, counted: (program, launches, segment kinds,
    state, plain version's state)."""
    _, prog = dispatch._plan_piece(c, "grid_sweep")
    reset_launches()
    got = prog.run(ap.initial_state(c.num_qubits, np.float32, device="cuda"))
    torch.cuda.synchronize()
    launches, kinds = dict(LAUNCHES), dict(SEGMENT_KINDS)
    plain = prog.run_plain(ap.initial_state(c.num_qubits, np.float32, device="cuda"))
    return prog, launches, kinds, got, plain


def run_route_cut(c, want: torch.Tensor) -> tuple[str, float]:
    """``c`` through ``run``, where the route cuts it into grid pieces and
    dense passes (``dispatch.GRID_CUTS``), counted, against ``want``:
    (engine, max abs err)."""
    reset_launches()
    sim = tq.StateVectorSimulator(c.num_qubits, seed=1)
    sim.run(c)
    torch.cuda.synchronize()
    check(sim.engine == "grid_sweep+dense_pass" and set(LAUNCHES) == {"grid_sweep", "dense_pass"},
          f"{c.num_qubits}q cut ran on {sim.engine}, launches {dict(LAUNCHES)}")
    err, _ = compare(sim.state_planes, want)
    check(err <= 1e-6, f"{c.num_qubits}q cut vs the row's plain version {err} > 1e-6")
    return sim.engine, err


def phase_fault1_segmented() -> dict:
    """The 22-qubit circuit with an 8-qubit dense gate on qubits 14-21 (the
    grid and sweep planners refuse it; segments keep 6 low bits in place
    for it) on the segmented engine, planned whole as the grid row's
    engines plan it, counted, against its plain version; then through
    ``run``, which cuts at the gate (grid pieces and a pass)."""
    n = 22
    c = wide_core_circuit(n, 8, 14)
    t0 = time.perf_counter()
    prog, launches, kinds, got, plain = run_row_whole(c)
    err, fid = compare(got, plain)
    route, route_err = run_route_cut(c, plain)
    log(f"phase {n}q_fault1_segmented: wall_s={time.perf_counter() - t0:.3f} "
        f"launches={launches} local_bits={prog.local_bits} swap_min={prog.swap_min} "
        f"max_core={max(s.table.max_core for s in prog.steps)} max_abs_err={err:.3e} "
        f"(tol 1e-6) fidelity={fid:.9f} route={route} route_max_abs_err={route_err:.3e}")
    check(isinstance(prog, SegmentedProgram), f"{n}q fault-1 circuit planned {type(prog).__name__}")
    check_one_launch(prog, launches, kinds, f"{n}q fault-1 circuit")
    check(err <= 1e-6, f"{n}q fault-1 circuit vs plain {err} > 1e-6")
    return {"max_abs_err": err}


def wide_core_circuit(n: int, k: int, lo: int) -> "tq.Circuit":
    """``random_circuit(n, 40, seed=42)``, a k-qubit dense gate on qubits
    lo..lo+k-1, then ``random_circuit(n, 40, seed=43)``."""
    c = tq.random_circuit(n, 40, seed=42)
    c.add(_dense_gate(k), *range(lo, lo + k))
    for g in tq.random_circuit(n, 40, seed=43).gates:
        c.add(g.name, *g.qubits, param=g.param)
    return c


def phase_22q_sweeps_oracle() -> dict:
    n = N_SWEEPS_ORACLE
    t0 = time.perf_counter()
    c = tq.random_circuit(n, 100, seed=42)
    prog = build_sweep_run(c)
    reset_launches()
    got = prog.run(ap.initial_state(n, np.float32, device="cuda"))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    err, fid = compare(got, oracle_planes(c, got.device))
    log(f"phase {n}q_sweeps_oracle: wall_s={time.perf_counter() - t0:.3f} max_abs_err={err:.3e} "
        f"(tol 1e-6) fidelity={fid:.9f} sweeps={prog.sweep_kinds} "
        f"ops={[len(g) for g in prog.sweep_gates]} launches={launches}")
    check(launches == {k: prog.sweep_kinds.count(k[:-6]) for k in ("low_sweep", "high_sweep")},
          f"{n}q sweeps launches {launches}")
    check(err <= 1e-6, f"{n}q sweeps max |d amp| {err} > 1e-6")
    return {"max_abs_err": err}


SWEEP_KEYS = ("low_sweep", "high_sweep", "unit_stage")
# the sweeps main path's kernels: its 8-qubit unit stage takes the dense
# pass (sweeps.MIN_UNIT_PASS_CORE); the unit stage's own path is
# phase_sweeps_unit's
MAIN_SWEEP_KEYS = ("low_sweep", "high_sweep", "dense_pass")


def launch_key(kind: str, route: str) -> str:
    """The ``LAUNCHES`` key of a sweep launch of ``route`` in a sweep of
    ``kind``."""
    return {"tile": f"{kind}_sweep", "mixed": f"{kind}_sweep", "unit": "unit_stage",
            "pass": "dense_pass"}[route]


def phase_sweeps_main() -> dict:
    """26q, the sweeps main path: a circuit the grid planner refuses (an
    8-qubit dense gate on qubits 10-17) through the simulator, counted; its
    stages and its launches as planned (each run of tile stages one launch
    on the instance for narrow cores, the unit stage through the dense
    pass); each launch against the plain version of its gates on one
    input."""
    n = N_SWEEPS
    c = wide_core_circuit(n, 8, 10)
    check(grid_planner_refuses(c), "the grid planner took the sweeps main-path circuit")
    res = phase_main(n, "sweeps", MAIN_SWEEP_KEYS, circuit=c)
    prog = res["prog"]
    kinds = prog.sweep_kinds
    routes = [[ln.route for ln in sweep] for sweep in prog.launches]
    want = collections.Counter(launch_key(k, r) for k, rs in zip(kinds, routes) for r in rs)
    check(res["launches"] == {key: want[key] for key in MAIN_SWEEP_KEYS},
          f"launches {res['launches']} for sweeps {kinds} routes {routes}")
    check(dict(PASS_INSTANCES) == {"stream": 1}, f"the main path's pass ran {dict(PASS_INSTANCES)}")
    res["pass_instances"] = dict(PASS_INSTANCES)
    stages = [[st.kind for st in sweep] for sweep in prog.stages]
    instances = [["pass" if ln.route == "pass" else "narrow" if ln.max_core <= NARROW_CORE
                  else "wide" for ln in sweep] for sweep in prog.launches]
    log(f"phase {n}q_sweeps_stages: tile_bits={prog.tile_bits} stages={stages} "
        f"ops={[[len(st.gates) for st in sweep] for sweep in prog.stages]} "
        f"launches={routes} instances={instances}")
    check(stages == [["tile"], ["tile", "unit", "tile"], ["tile"], ["tile"]],
          f"sweeps main path stages {stages}")
    check(routes == [["tile"], ["tile", "pass", "tile"], ["tile"], ["tile"]],
          f"sweeps main path launches {routes}")
    check(instances == [["narrow"], ["narrow", "pass", "narrow"], ["narrow"], ["narrow"]],
          f"sweeps main path instances {instances}")
    step_err = {key: 0.0 for key in MAIN_SWEEP_KEYS}
    t0 = time.perf_counter()
    x = random_planes(n, 5)
    for i, kind in enumerate(kinds):
        for j, ln in enumerate(prog.launches[i]):
            got = prog.launch_one(x.clone(), i, j)
            want_ij = prog.launch_plain(x, i, j)
            e, _ = compare(got, want_ij)
            key = launch_key(kind, ln.route)
            step_err[key] = max(step_err[key], e)
            del got
            x = want_ij
    del x
    log(f"phase {n}q_sweep_vs_plain: wall_s={time.perf_counter() - t0:.3f} "
        f"max_abs_err={step_err} (tol 1e-7) sweeps={kinds} launches={routes} "
        f"ops={[len(g) for g in prog.sweep_gates]} max_core={[t.max_core for t in prog.tables]} "
        f"active={[lay.active for lay in prog.layouts]}")
    check(max(step_err.values()) <= 1e-7, f"sweep launches vs plain {step_err}")
    res["step_err"] = step_err
    res["circuit"] = c
    return res


def phase_sweeps_unit() -> dict:
    """The sweeps' unit stage on its own path: since the route sends unit
    stages of ``MIN_UNIT_PASS_CORE`` qubits or more to the dense pass and
    circuits with a narrower dense core to the grid sweep, a unit stage
    runs only in a ``SweepProgram`` planned directly (as the tune and floor
    modules plan it): ``wide_core_circuit(26, 5, 10)``, its 5-qubit core a
    unit stage on the wide instance, run counted, each launch against the
    plain version of its gates."""
    n = N_SWEEPS
    c = wide_core_circuit(n, 5, 10)
    prog = SweepProgram(c)
    routes = [[ln.route for ln in sweep] for sweep in prog.launches]
    check(sum(r.count("unit") for r in routes) == 1, f"5-qubit core's sweeps launches {routes}")
    x = random_planes(n, 6)
    reset_launches()
    y = prog.run(x.clone())
    torch.cuda.synchronize()
    launches = {k: LAUNCHES[k] for k in SWEEP_KEYS}
    check(launches["unit_stage"] == 1 and sum(launches.values()) == sum(LAUNCHES.values()),
          f"5-qubit core's sweeps launched {dict(LAUNCHES)}")
    err, fid = compare(y, prog.run_plain(x))
    del y
    step_err = {key: 0.0 for key in SWEEP_KEYS}
    for i, kind in enumerate(prog.sweep_kinds):
        for j, ln in enumerate(prog.launches[i]):
            got = prog.launch_one(x.clone(), i, j)
            want_ij = prog.launch_plain(x, i, j)
            e, _ = compare(got, want_ij)
            key = launch_key(kind, ln.route)
            step_err[key] = max(step_err[key], e)
            del got
            x = want_ij
    del x
    log(f"phase {n}q_sweeps_unit: launches={launches} routes={routes} max_abs_err={err:.3e} "
        f"(tol 1e-7) fidelity={fid:.9f} step_err={step_err}")
    check(err <= 1e-7 and max(step_err.values()) <= 1e-7,
          f"5-qubit core's sweeps vs plain {err}, launches {step_err}")
    return {"prog": prog, "launches": launches, "max_abs_err": err, "fidelity": fid,
            "step_err": step_err}


def grid_planner_refuses(c) -> bool:
    try:
        GridSweepProgram(c)
    except ValueError:
        return True
    return False


def phase_sweeps_cross_engine() -> dict:
    n = N_SWEEPS
    t0 = time.perf_counter()
    c = tq.random_circuit(n, 100, seed=42)
    sprog, gprog = build_sweep_run(c), GridSweepProgram(c)
    a = sprog.run(ap.initial_state(n, np.float32, device="cuda"))
    b = gprog.run(ap.initial_state(n, np.float32, device="cuda"))
    cross, fid = compare(a, b)
    del a, b
    stages = [[len(st.gates) for st in sweep] for sweep in sprog.stages]
    log(f"phase {n}q_sweeps_cross_engine: wall_s={time.perf_counter() - t0:.3f} "
        f"sweeps={sprog.sweep_kinds} stages={stages} grid_sweeps={gprog.num_sweeps} "
        f"max_abs_err={cross:.3e} (tol 1e-6) fidelity={fid:.9f}")
    check(cross <= 1e-6, f"{n}q sweeps vs grid sweep {cross} > 1e-6")
    check(sum(map(len, stages)) <= 6, f"random_circuit({n}, 100) in {stages} stages")
    return {"cross_err": cross, "sprog": sprog, "gprog": gprog}


def phase_wide_cores() -> dict:
    """Dense cores of 7-10 qubits on every kernel: the whole circuit at 12q
    against the oracle, segments (22q, qubits 15-21), the grid sweep (26q,
    qubits 0..k-1) and the low sweep (26q, qubits 17-k..16) against their
    plain version; a 10-qubit core takes the dense pass between the row's
    pieces (the route by width), and so do, on the grid row, the segments'
    and the grid sweep's cores here (``dispatch.GRID_CUTS``): those run
    twice, the row's program planned whole (the core in its kernel) and
    through ``run`` (grid pieces and a pass)."""
    errs = {}
    for n, k, lo, engine in ((12, 7, 2, "whole_circuit"), (12, 8, 4, "whole_circuit"),
                             (12, 9, 3, "whole_circuit"),
                             (12, 10, 2, "whole_circuit+dense_pass"),
                             (10, 9, 0, "whole_circuit"),
                             (22, 7, 15, "segmented"), (26, 7, 0, "grid_sweep"),
                             (26, 8, 0, "grid_sweep"), (26, 9, 0, "grid_sweep"),
                             (26, 10, 0, "grid_sweep+dense_pass"), (26, 9, 8, "sweeps"),
                             (26, 10, 7, "grid_sweep+dense_pass")):
        t0 = time.perf_counter()
        c = wide_core_circuit(n, k, lo)
        if n >= 20 and engine in ("grid_sweep", "segmented"):
            prog, launches, _, got, plain = run_row_whole(c)
            err, _ = compare(got, plain)
            route, route_err = run_route_cut(c, plain)
            del got, plain
            log(f"phase wide_core: n={n} k={k} qubits={lo}..{lo + k - 1} whole={engine} "
                f"wall_s={time.perf_counter() - t0:.3f} launches={launches} "
                f"max_abs_err={err:.3e} vs plain (tol 1e-6) route={route} "
                f"route_max_abs_err={route_err:.3e}")
            kernel = {"grid_sweep": "grid_sweep", "segmented": "segment"}[engine]
            check(set(launches) == {kernel} and err <= 1e-6,
                  f"{k}-qubit core at {n}q on {engine}: launches {launches}, error {err}")
            errs[f"{n}q_{k}"] = err
            continue
        reset_launches()
        sim = tq.StateVectorSimulator(n, seed=1)
        sim.run(c)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        ran = sim.engine
        _, prog = sim.compiled_run(c)
        if n <= 14:
            want, ref = oracle_planes(c, sim.device), "oracle"
        else:
            want, ref = prog.run_plain(ap.initial_state(n, np.float32, device="cuda")), "plain"
        err, _ = compare(sim.state_planes, want)
        del sim, want
        log(f"phase wide_core: n={n} k={k} qubits={lo}..{lo + k - 1} engine={ran} "
            f"wall_s={time.perf_counter() - t0:.3f} launches={launches} "
            f"max_abs_err={err:.3e} vs {ref} (tol 1e-6)")
        check(ran == engine and sum(launches.values()) >= 1 and err <= 1e-6,
              f"{k}-qubit core at {n}q: engine {ran} (want {engine}), "
              f"launches {launches}, error {err}")
        if engine == "sweeps":   # the unit stage: the tiled op below 6 qubits, else the pass
            via_pass = k >= MIN_UNIT_PASS_CORE
            check(launches.get("dense_pass", 0) == int(via_pass)
                  and launches.get("unit_stage", 0) == int(not via_pass),
                  f"{k}-qubit unit stage at {n}q: launches {launches}")
        errs[f"{n}q_{k}"] = err
    return errs


DENSE_PASS_QUBITS = (16, 22)
DENSE_PASS_CORE = 12


def phase_dense_pass() -> dict:
    """Cores of 12 qubits: at 16 and 22 qubits a circuit with a 12-qubit
    dense gate on qubits 0-11 through ``run`` (the route's launches around
    one dense pass), counted, against the oracle (16q) and its plain
    version; then the pass alone on a random state against its plain
    version and ``torch.matmul``, timed beside both and its bound."""
    out = {}
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for n, engine in zip(DENSE_PASS_QUBITS, ("whole_circuit", "grid_sweep")):
            t0 = time.perf_counter()
            gate = kron_gate(tuple(range(DENSE_PASS_CORE)), seed=n)
            c = tq.random_circuit(n, 40, seed=42).append(gate)
            c.extend(tq.random_circuit(n, 40, seed=43).gates)
            reset_launches()
            sim = tq.StateVectorSimulator(n, seed=1)
            sim.run(c)
            torch.cuda.synchronize()
            launches = dict(LAUNCHES)
            _, prog = sim.compiled_run(c)
            want_engine = f"{engine}+dense_pass"
            check(sim.engine == want_engine, f"{n}q 12-qubit core ran on {sim.engine}")
            check(launches.get("dense_pass") == 1 and launches.get(engine, 0) >= 2
                  and set(launches) == {engine, "dense_pass"}, f"{n}q launches {launches}")
            plain = prog.run_plain(ap.initial_state(n, np.float32, device="cuda"))
            err_plain, fid = compare(sim.state_planes, plain)
            del plain
            err_oracle = None
            if n <= 16:
                err_oracle, _ = compare(sim.state_planes, oracle_planes(c, sim.device))
                check(err_oracle <= 1e-6, f"{n}q 12-qubit core vs oracle {err_oracle} > 1e-6")
            log(f"phase {n}q_dense_pass_run: wall_s={time.perf_counter() - t0:.3f} "
                f"engine={sim.engine} launches={launches} max_abs_err_vs_plain={err_plain:.3e} "
                f"(tol 1e-7) max_abs_err_vs_oracle={err_oracle} (tol 1e-6) fidelity={fid:.9f}")
            check(err_plain <= 1e-7, f"{n}q 12-qubit core vs plain {err_plain} > 1e-7")
            del sim

            # the pass alone: kernel, plain version and torch.matmul on one input
            step = next(s for s in prog.steps if isinstance(s, DensePass))
            x = random_planes(n, 11)
            u = step.u_on(x.device)
            got = dense_pass(x, u, step.tmask, step.cmask)
            err, _ = compare(got, step.run_plain(x))
            # targets 0-11: the complex view (2^(n-12), 4096) times the
            # operand transposed (its index bit j is qubit j)
            um = torch.complex(u[0], u[1])
            z = torch.complex(x[0], x[1]).view(-1, 1 << DENSE_PASS_CORE)
            y = torch.matmul(z, um.T).reshape(-1)
            err_mm = float(torch.max(torch.abs(torch.complex(got[0], got[1]) - y)))
            del got, y
            ms = median_ms(lambda: dense_pass(x, u, step.tmask, step.cmask), inner=10)
            plain_ms = median_ms(lambda: step.run_plain(x), reps=3)
            mm_ms = median_ms(lambda: torch.matmul(z, um.T), inner=10)
            # this design's bound: three TF32 tensor-core products per real
            # one; beside it the float32 FMAs' (any design without them)
            b = bound(step.bytes_moved(), 3 * step.flops(), TF32_FLOP_PER_S)
            fp32 = bound(step.bytes_moved(), step.flops())
            row = {"ms": ms, "plain_ms": plain_ms, "library_ms": mm_ms, **b,
                   "share": b["bound_ms"] / ms, "fp32_bound_ms": fp32["bound_ms"],
                   "fp32_bound_by": fp32["bound_by"], "fp32_share": fp32["bound_ms"] / ms,
                   "max_abs_err": err, "max_abs_err_vs_matmul": err_mm,
                   "launches": launches["dense_pass"], "run_max_abs_err": err_plain,
                   "run_oracle_max_abs_err": err_oracle,
                   "instance": pass_instance(step.k, n - step.k - len(step.controls))}
            log(f"phase {n}q_dense_pass: k={step.k} {json.dumps(row)}")
            check(err <= 1e-7, f"{n}q dense pass vs plain {err} > 1e-7")
            check(err_mm <= 1e-7, f"{n}q dense pass vs torch.matmul {err_mm} > 1e-7")
            out[n] = row
            del x, z, um
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return out


STREAM_PASS_QUBITS = (26, 28)


def phase_stream_passes() -> dict:
    """The dense pass alone where the route sends 7-9-qubit cores
    (``tune_route --passes``): at 26 and 28 qubits, a 7-, 8- and 9-qubit
    core on the lowest, middle and highest qubits, an 8-qubit core under a
    control on the highest qubit, and the 6-qubit core widened to 7 three
    ways, each on the instance ``pass_instance`` picks and on the other of
    the stream and large instances (forced), in turns, each launch's
    instance asserted by its tally in ``PASS_INSTANCES``; each against the
    plain version (1e-7) and, for contiguous targets, ``torch.matmul`` of the
    core with TF32 off (1e-7; timed without and with the planes-to-complex64
    copies), beside the plain version's time and the gate's 3xTF32 bound."""
    out = {}
    for n in STREAM_PASS_QUBITS:
        t0 = time.perf_counter()
        rows = stream_passes(n, torch.device("cuda"), plain_reps=1)
        for row in rows:
            log(f"phase {n}q_stream_passes: {json.dumps(row)}")
            k, name = row["k"], row["row"]
            check(row["picked"] == pass_instance(k, n - k - len(row["controls"])),
                  f"{name}: picked {row['picked']}")
            for inst in ("stream", "large"):
                check(row[inst]["max_abs_err"] <= 1e-7,
                      f"{name}: {inst} vs plain {row[inst]['max_abs_err']} > 1e-7")
            if "matmul_ms" in row:
                check(row["picked_vs_matmul_max_abs_err"] <= 1e-7,
                      f"{name}: vs torch.matmul {row['picked_vs_matmul_max_abs_err']} > 1e-7")
        out[n] = rows
        log(f"phase {n}q_stream_passes: wall_s={time.perf_counter() - t0:.1f}")
        torch.cuda.empty_cache()
    return out


# The route by width: (name, qubits, core width, lowest core qubit, engines
# of the split, or the one program that holds the core)
SPLIT = ["grid_sweep", "dense_pass", "grid_sweep"]
ROUTE_CASES = (
    ("26q_grid_wide_k8", 26, 8, 0, SPLIT),      # before GRID_CUTS: the tiled op
    ("26q_grid_wide_k10", 26, 10, 0, SPLIT),
    ("19q_dense10_on_9", 19, 10, 9, ["segmented", "dense_pass", "segmented"]),
    ("22q_dense10_on_12", 22, 10, 12, SPLIT),
    ("28q_dense11_on_17", 28, 11, 17, SPLIT),
    # a gate that the grid planner refuses: cut there above 26q (the torch
    # engine ran the whole circuit before); the 6-qubit core widened to 7
    ("27q_dense9_on_18", 27, 9, 18, SPLIT),
    ("28q_dense6_on_11", 28, 6, 11, SPLIT),
    ("28q_dense8_on_20", 28, 8, 20, SPLIT),
    ("30q_dense7_on_23", 30, 7, 23, SPLIT),
    ("26q_dense8_on_18", 26, 8, 18, SPLIT),     # before GRID_CUTS: the segments
)
ROUTE_KERNEL = {"grid_sweep": "grid_sweep", "segmented": "segment"}
ROUTE_ORACLE_QUBITS = 26     # the complex128 host oracle up to this size
ROUTE_ORACLE_WORKERS = 22    # from this size the oracle runs in a worker process
ROUTE_TORCH_QUBITS = 27      # from this size the torch engine is timed beside the run


def route_oracle(n: int, k: int, lo: int) -> np.ndarray:
    """The complex128 host oracle's state after ``wide_circuit(n, k, lo)``
    (run in a worker process)."""
    from tpu_qsim_torch.kernels.time_run import wide_circuit

    ref = tq.CPUReferenceSimulator(n)
    ref.run(wide_circuit(n, k, lo))
    return ref.state


def start_route_oracles() -> tuple:
    """The host oracles of the large ``ROUTE_CASES``, started in worker
    processes (a 26-qubit one takes minutes of host time) while the card
    runs the phases before them: (pool, {name: future})."""
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    futures = {name: pool.submit(route_oracle, n, k, lo) for name, n, k, lo, _ in ROUTE_CASES
               if ROUTE_ORACLE_WORKERS <= n <= ROUTE_ORACLE_QUBITS}
    return pool, futures


def phase_route_by_width(oracles: tuple) -> dict:
    """Dense cores that the route cuts or holds, on the grid and segmented
    rows: each of ``ROUTE_CASES`` (``random_circuit(n, 40, seed=42)``, a
    seeded k-qubit unitary on qubits lo..lo+k-1, ``random_circuit(n, 40,
    seed=43)``) through ``StateVectorSimulator(n).run``, counted (the
    pieces' kernel and one dense pass, or the one program's kernel), against
    its plain version and, up to 26 qubits, the complex128 oracle (1e-6
    each), timed (device time from CUDA-graph replays below 20 qubits), with
    the peak device memory of one run beside the state's own bytes (the
    pass writes a new state), a split's pass alone beside its bound, and
    from 27 qubits the torch engine's run of the same circuit."""
    from tpu_qsim_torch.kernels.time_run import wide_circuit

    pool, futures = oracles
    out = {}
    for name, n, k, lo, engines in ROUTE_CASES:
        t0 = time.perf_counter()
        c = wide_circuit(n, k, lo)
        reset_launches()
        sim = tq.StateVectorSimulator(n, seed=1)
        sim.run(c)
        torch.cuda.synchronize()
        launches, instances = dict(LAUNCHES), dict(PASS_INSTANCES)
        _, prog = sim.compiled_run(c)
        if isinstance(engines, str):
            check(sim.engine == engines and launches.get(ROUTE_KERNEL[engines], 0) >= 1
                  and set(launches) == {ROUTE_KERNEL[engines]},
                  f"{name} ran on {sim.engine}, launches {launches}")
            if engines == "grid_sweep":     # the core in the grid sweep's tiled op
                check(launches == {"grid_sweep": prog.num_sweeps}
                      and max(t.max_core for t in prog.tables) == k,
                      f"{name}: launches {launches}, tables' cores")
        else:
            piece = ROUTE_KERNEL[engines[0]]
            check(prog.engines == engines and sim.engine == f"{engines[0]}+dense_pass",
                  f"{name} ran on {sim.engine} {getattr(prog, 'engines', None)}")
            check(launches.get("dense_pass") == 1 and launches.get(piece, 0) >= 2
                  and set(launches) == {piece, "dense_pass"}, f"{name} launches {launches}")
            step_ = next(s for s in prog.steps if isinstance(s, DensePass))
            picked = pass_instance(step_.k, n - step_.k - len(step_.controls))
            check(instances == {picked: 1}, f"{name}: pass instances {instances}, not {picked}")
        x0 = ap.initial_state(n, np.float32, device="cuda")
        err_plain, fid = compare(sim.state_planes, prog.run_plain(x0))
        err_oracle = None
        if n <= ROUTE_ORACLE_QUBITS:
            t1 = time.perf_counter()
            if name in futures:
                psi = futures.pop(name).result(timeout=900)
                want = torch.from_numpy(np.stack([psi.real, psi.imag])).to(sim.device)
                del psi
            else:
                want = oracle_planes(c, sim.device)
            err_oracle, _ = compare(sim.state_planes, want)
            del want
            oracle_s = time.perf_counter() - t1   # for a worker's oracle, the wait for it
        del sim
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        y = prog.run(x0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        del y
        state = [x0]

        def step():
            state[0] = prog.run(state[0])

        ms = graph_ms(step) if n < 20 else median_ms(step)
        row = {"engine": engines if isinstance(engines, str) else "+".join(engines),
               "launches": launches, "pass_instances": instances, "ms": ms,
               "max_abs_err_vs_plain": err_plain,
               "fidelity": fid, "max_abs_err_vs_oracle": err_oracle,
               "peak_gib_over_state": peak / 2 ** 30, "state_gib": 8 * (1 << n) / 2 ** 30}
        if not isinstance(engines, str):
            # the pass alone on the same input: the core's width as cut and
            # as launched (widened), beside the gate's 3xTF32 bound (its
            # core as cut: the widening's identity is no work of the gate)
            step_ = next(s for s in prog.steps if isinstance(s, DensePass))
            row.update(core_k=k, pass_k=step_.k,
                       pass_ms=median_ms(lambda: step_.run(state[0])),
                       pass_bound=bound(step_.bytes_moved(), 3 * step_.flops(), TF32_FLOP_PER_S))
        if n >= ROUTE_TORCH_QUBITS:
            row["torch_engine_ms"] = torch_engine_ms(c, 1)
            row["torch_engine_over_ms"] = row["torch_engine_ms"] / ms
        log(f"phase {name}: wall_s={time.perf_counter() - t0:.3f} "
            f"oracle_s={oracle_s if err_oracle is not None else None} {json.dumps(row)}")
        check(err_plain <= 1e-6, f"{name} vs plain {err_plain} > 1e-6")
        check(err_oracle is None or err_oracle <= 1e-6, f"{name} vs oracle {err_oracle} > 1e-6")
        out[name] = row
        del state, x0, prog
        torch.cuda.empty_cache()
    pool.shutdown()
    return out


def time_cuda(fn, reps: int, inner: int = 1) -> list[float]:
    """``reps`` CUDA-event times of ``inner`` back-to-back calls, per call."""
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return out


def median_ms(fn, reps: int = 5, inner: int = 1) -> float:
    time_cuda(fn, 1, inner)                                      # warm-up
    return statistics.median(time_cuda(fn, reps, inner))


def graph_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Device time of ``fn``'s launches: run once, captured once into a CUDA
    graph, then ``median_ms`` of graph replays. Eager calls of a kernel this
    short are bounded by the host's launch path instead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return median_ms(graph.replay, reps, inner)


def bound(bytes_moved: float, flops: float, flop_per_s: float = FP32_FLOP_PER_S) -> dict:
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / flop_per_s * 1e3
    return {"bound_ms": max(bytes_ms, flops_ms), "bytes_ms": bytes_ms, "flops_ms": flops_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def torch_engine_ms(circuit, inner: int) -> float:
    fn = build_torch_run_fn(fuse_circuit(circuit, 5), np.float32)
    x = ap.initial_state(circuit.num_qubits, np.float32, device="cuda")
    return median_ms(lambda: fn(x), inner=inner)


def phase_timing(sim, prog) -> dict:
    state = sim.state_planes
    ms = median_ms(lambda: prog.run(state))
    x0 = ap.initial_state(N_MAIN, np.float32, device="cuda")
    plain_ms = median_ms(lambda: prog.run_plain(x0), reps=3)
    del x0
    # per-sweep split of one run
    per = []
    for (ints, coef), lay, t in zip(prog._tables_on(state.device), prog.layouts, prog.tables):
        per.append(time_cuda(lambda: grid_sweep(state, ints, coef, lay, t.max_core), 3)[-1])
    b = bound(prog.bytes_moved(), prog.flops())
    # the same circuit in the largest blocks (2^13: blk WIDE_BLK_BITS, A_MAX
    # active bits), where the planner needs the fewest sweeps: the bound of
    # the circuit rather than of the geometry the run took
    fewest = GridSweepProgram(tq.random_circuit(N_MAIN, 100, seed=42), GridParams(WIDE_BLK_BITS))
    b_fewest = bound(fewest.bytes_moved(), fewest.flops())
    log(f"phase timing: n={N_MAIN} sweeps={prog.num_sweeps} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={b['bound_ms']:.4f} bytes_ms={b['bytes_ms']:.4f} flops_ms={b['flops_ms']:.4f} "
        f"per_sweep_ms={[round(t, 4) for t in per]} geometry={prog.params}; "
        f"fewest sweeps: {fewest.num_sweeps} at {fewest.params}, "
        f"bound_ms={b_fewest['bound_ms']:.4f} ({b_fewest['bound_by']})")
    return {"ms": ms, "plain_ms": plain_ms, **b}


def phase_timing_whole_circuit() -> dict:
    rows = {}
    for n in (12, 16, N_WHOLE):
        c = tq.random_circuit(n, 100, seed=42)
        prog = WholeCircuitProgram(c)
        x = ap.initial_state(n, np.float32, device="cuda")
        ms = graph_ms(lambda: prog.run(x), inner=50)
        eager_ms = median_ms(lambda: prog.run(x), inner=50)
        plain_ms = median_ms(lambda: prog.run_plain(x), inner=5)
        engine_ms = torch_engine_ms(c, inner=5)
        b = bound(prog.bytes_moved(), prog.flops())
        stages = check_whole_stages(prog)
        log(f"phase timing_whole_circuit: n={n} ops={len(prog.gates)} ms={ms:.5f} "
            f"eager_ms={eager_ms:.5f} plain_ms={plain_ms:.4f} torch_engine_ms={engine_ms:.4f} "
            f"bound_ms={b['bound_ms']:.5f} bytes_ms={b['bytes_ms']:.5f} flops_ms={b['flops_ms']:.5f} "
            f"tiles=2^{prog.tile_bits} slots, {prog.ctas} CTAs x {prog.threads} threads, "
            f"SMs <= {min(prog.ctas, SMS)} of {SMS}, stages={stages}")
        rows[n] = {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
                   "torch_engine_ms": engine_ms, "stages": len(stages), **b}
    return rows


def phase_timing_segmented(prog: SegmentedProgram) -> dict:
    """The whole 19q run, one launch (device time, and eager through the
    Python wrapper), then each kernel's share: its segments launched one by
    one on fixed buffers, beside the same segments' plain version."""
    n = prog.num_qubits
    c = tq.random_circuit(n, 100, seed=42)
    x = ap.initial_state(n, np.float32, device="cuda")
    run_ms = graph_ms(lambda: prog.run(x), inner=50)
    eager_ms = median_ms(lambda: prog.run(x), inner=50)
    plain_run_ms = median_ms(lambda: prog.run_plain(x), inner=5)
    engine_ms = torch_engine_ms(c, inner=5)
    a, out = random_planes(n, 1), torch.empty((2, 1 << n), device="cuda")
    per = {"segment": [], "scatter_segment": []}
    for i, step in enumerate(prog.steps):
        ms = graph_ms(lambda: prog.launch(a, i, i + 1, other=out), inner=50)
        pms = median_ms(lambda: prog.step_plain(a, i), inner=5)
        b = bound(2 * 2 * 4 * (1 << n), step.table.flops_per_amp * (1 << n))
        per[step.kernel].append((ms, pms, b["bytes_ms"], b["flops_ms"]))
    kernels = {}
    for k, rows in per.items():
        bytes_ms = sum(r[2] for r in rows)
        flops_ms = sum(r[3] for r in rows)
        kernels[k] = {"ms": sum(r[0] for r in rows), "plain_ms": sum(r[1] for r in rows),
                      "bound_ms": max(bytes_ms, flops_ms),
                      "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
                      "per_launch_ms": [r[0] for r in rows]}
    b = bound(prog.bytes_moved(), prog.flops())
    blocks = 1 << (n - prog.local_bits)
    ctas = min(blocks, resident_ctas(a.device, prog.local_bits, prog.table.max_core > 4))
    log(f"phase timing_segmented: n={n} segments={prog.num_segments} ms={run_ms:.5f} (one launch) "
        f"eager_ms={eager_ms:.5f} plain_ms={plain_run_ms:.4f} torch_engine_ms={engine_ms:.4f} "
        f"bound_ms={b['bound_ms']:.5f} bytes_ms={b['bytes_ms']:.5f} flops_ms={b['flops_ms']:.5f} "
        f"blocks={blocks} of 2^{prog.local_bits} on {ctas} CTAs x {prog.threads} threads, "
        f"SMs <= {min(ctas, SMS)} of {SMS}, register-table entries="
        f"{[int(s.table.ints[0]) for s in prog.steps]} per_kernel={json.dumps(kernels)}")
    return {"run_ms": run_ms, "eager_ms": eager_ms, "plain_run_ms": plain_run_ms,
            "torch_engine_ms": engine_ms, "kernels": kernels, **b}


def core_matmul(gate, n: int, x: torch.Tensor):
    """A dense gate on contiguous ascending qubits lo..lo+k-1 as one
    ``torch.matmul`` on the complex64 view (2^(n-lo-k), 2^k, 2^lo) of the
    planes ``x``: (the call, its result). The gate's first qubit is its
    matrix index's MSB and the view's lowest core bit, so U's indices are
    bit-reversed for the view."""
    qubits = tuple(gate.qubits)
    k, lo = len(qubits), qubits[0]
    check(qubits == tuple(range(lo, lo + k)), f"core on {qubits}: not contiguous")
    rev = [int(f"{i:0{k}b}"[::-1], 2) for i in range(1 << k)]
    u = torch.from_numpy(np.asarray(gate.u)[np.ix_(rev, rev)].astype(np.complex64)).cuda()
    z = torch.complex(x[0], x[1]).view(1 << (n - lo - k), 1 << k, 1 << lo)
    return (lambda: torch.matmul(u, z)), torch.matmul(u, z).reshape(-1)


def sweeps_timing(prog, label: str) -> dict:
    """One sweeps program at 26q: the run, each sweep, each launch, each
    kernel's share, beside the plain versions and the bound. A kind of
    sweep's bound is its function's: one pass of the state's bytes per
    sweep (a read and a write; a dense pass's core besides), or all its
    stages' operations (a unit stage's and a dense pass's core on the tensor
    cores in 3xTF32, the rest float32), whichever is longer. It is split
    between the sweeps' launches, so that the kernels' shares add up to it:
    each launch takes its own operations and, where the bytes are longer,
    a share of the difference by its stages. ``launch_passes_ms`` is what
    the launches cost as launched instead, a pass of bytes each (or its
    operations). For a unit stage's launch and a dense pass's also one
    ``torch.matmul`` of its core (TF32 off); for a dense pass also its own
    bound as ``phase_dense_pass`` takes it (its bytes, or its core's
    operations in 3xTF32)."""
    n = prog.num_qubits
    x = random_planes(n, 2)
    ms = median_ms(lambda: prog.run(x))
    plain_ms = median_ms(lambda: prog.run_plain(x), reps=3)
    per = [median_ms(lambda: prog.launch(x, i), reps=3) for i in range(prog.num_sweeps)]
    pass_bytes_ms = 16 * (1 << n) / HBM_BYTES_PER_S * 1e3
    rows = []
    for i, kind in enumerate(prog.sweep_kinds):
        for j, ln in enumerate(prog.launches[i]):
            if ln.route == "pass":
                core = ln.step.flops()
                rest = 0.0
                launch_bytes_ms = ln.step.bytes_moved() / HBM_BYTES_PER_S * 1e3
            else:
                # a unit stage's core: three TF32 tensor-core products per real one
                core = sum(build_op_table(st.gates, st.layout, MAX_SWEEP_BITS).flops_per_amp
                           for st in ln.stages if st.kind == "unit") * (1 << n)
                rest = ln.table.flops_per_amp * (1 << n) - core
                launch_bytes_ms = pass_bytes_ms
            row = {"sweep": i, "launch": j, "key": launch_key(kind, ln.route), "route": ln.route,
                   "stages": [[st.kind, len(st.gates)] for st in ln.stages],
                   "ms": median_ms(lambda: prog.launch_one(x, i, j), reps=3),
                   "plain_ms": median_ms(lambda: prog.launch_plain(x, i, j), reps=3),
                   "flops_ms": (3 * core / TF32_FLOP_PER_S + rest / FP32_FLOP_PER_S) * 1e3,
                   "fp32_flops_ms": (core + rest) / FP32_FLOP_PER_S * 1e3,
                   "extra_bytes_ms": launch_bytes_ms - pass_bytes_ms}
            row["launch_passes_ms"] = max(launch_bytes_ms, row["flops_ms"])
            if ln.route == "pass":
                own = bound(ln.step.bytes_moved(), 3 * ln.step.flops(), TF32_FLOP_PER_S)
                row["own_bound_ms"] = own["bound_ms"]
                row["own_bound_by"] = own["bound_by"]
            if ln.route in ("unit", "pass"):
                allow = torch.backends.cuda.matmul.allow_tf32
                torch.backends.cuda.matmul.allow_tf32 = False
                try:
                    call, y = core_matmul(ln.stages[0].gates[0], n, x)
                    got = prog.launch_one(x.clone(), i, j)
                    row["library_max_abs_err"] = float(torch.max(torch.abs(
                        torch.complex(got[0], got[1]).reshape(-1) - y)))
                    del got, y
                    row["library_ms"] = median_ms(call)
                finally:
                    torch.backends.cuda.matmul.allow_tf32 = allow
                check(row["library_max_abs_err"] <= 1e-7,
                      f"{ln.route} vs torch.matmul {row['library_max_abs_err']} > 1e-7")
            rows.append(row)
    del x
    # each kind's bound (one pass a sweep, or its operations), split between
    # its launches: their operations, and the bytes' excess by their stages
    for kind in ("low", "high"):
        mine = [r for r in rows if prog.sweep_kinds[r["sweep"]] == kind]
        stages = sum(len(r["stages"]) for r in mine)
        bytes_ms = (prog.sweep_kinds.count(kind) * pass_bytes_ms
                    + sum(r["extra_bytes_ms"] for r in mine))
        for flops, out in (("flops_ms", "bound_ms"), ("fp32_flops_ms", "fp32_bound_ms")):
            excess = max(0.0, bytes_ms - sum(r[flops] for r in mine))
            for r in mine:
                r[f"{out}_bytes_part"] = excess * len(r["stages"]) / stages
                r[out] = r[flops] + r[f"{out}_bytes_part"]
    b = bound(prog.bytes_moved(), prog.flops())
    # the flops of each sweep's unit stages (three TF32 tensor-core products
    # per real multiply-add) and of the rest (float32)
    tiled = [sum(build_op_table(st.gates, st.layout, MAX_SWEEP_BITS).flops_per_amp
                 for st in stages if st.kind == "unit") * (1 << n) for stages in prog.stages]
    flops = [t.flops_per_amp * (1 << n) for t in prog.tables]
    ops_ms = (3 * sum(tiled) / TF32_FLOP_PER_S + (sum(flops) - sum(tiled)) / FP32_FLOP_PER_S) * 1e3
    b["tf32x3_bound_ms"] = max(b["bytes_ms"], ops_ms)
    kernels = {}
    for key in (*SWEEP_KEYS, "dense_pass"):
        mine = [r for r in rows if r["key"] == key]
        if not mine:
            continue
        part = sum(r["bound_ms_bytes_part"] for r in mine)
        bound_ms = sum(r["bound_ms"] for r in mine)
        kernels[key] = {
            "ms": sum(r["ms"] for r in mine), "plain_ms": sum(r["plain_ms"] for r in mine),
            "bound_ms": bound_ms,
            "bound_by": "bytes" if part >= bound_ms - part else "operations",
            "library_ms": (sum(r["library_ms"] for r in mine)
                           if key in ("unit_stage", "dense_pass") else None),
            "fp32_bound_ms": sum(r["fp32_bound_ms"] for r in mine),
            "launch_passes_ms": sum(r["launch_passes_ms"] for r in mine),
            "per_launch_ms": [r["ms"] for r in mine]}
        if key == "dense_pass":
            own = sum(r["own_bound_ms"] for r in mine)
            kernels[key]["own_bound_ms"] = own
            kernels[key]["own_bound_by"] = ("bytes" if all(r["own_bound_by"] == "bytes" for r in mine)
                                            else "operations")
    for r in rows:
        log(f"phase timing_sweeps: {label} n={n} sweep[{r['sweep']}] launch {r['launch']} "
            f"{r['key']} ({r['route']}, stages {r['stages']}): ms={r['ms']:.4f} "
            f"bound_ms={r['bound_ms']:.4f} (flops_ms={r['flops_ms']:.4f} + bytes' share "
            f"{r['bound_ms_bytes_part']:.4f}) launch_passes_ms={r['launch_passes_ms']:.4f} "
            f"plain_ms={r['plain_ms']:.4f}"
            + (f" library_ms={r['library_ms']:.4f}" if "library_ms" in r else ""))
    log(f"phase timing_sweeps: {label} n={n} sweeps={prog.sweep_kinds} "
        f"launches={[[ln.route for ln in sw] for sw in prog.launches]} "
        f"ops={[len(g) for g in prog.sweep_gates]} max_core={[t.max_core for t in prog.tables]} "
        f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={b['bound_ms']:.4f} "
        f"tf32x3_bound_ms={b['tf32x3_bound_ms']:.4f} "
        f"bytes_ms={b['bytes_ms']:.4f} flops_ms={b['flops_ms']:.4f} "
        f"per_sweep_ms={[round(t, 4) for t in per]} geometry={prog.geometry} "
        f"per_kernel={json.dumps(kernels)}")
    return {"ms": ms, "plain_ms": plain_ms, "kernels": kernels, "per_sweep_ms": per,
            "per_launch": rows, **b}


def phase_timing_sweeps(main_prog, cross: dict, unit_prog) -> dict:
    """The sweeps main path's run (an 8-qubit core among 80 random gates),
    the unit stage's path (``phase_sweeps_unit``: a 5-qubit core), then
    ``random_circuit(26, 100, seed=42)`` through the sweeps and the grid
    sweep, then the wide-core op's cost: one op of a k-qubit core in a low
    sweep (qubits 17-k..16) and in a grid sweep (qubits 0..k-1) at 26q, less
    the same sweep with one 1-qubit op."""
    res = {"main": sweeps_timing(main_prog, "main_path"),
           "unit": sweeps_timing(unit_prog, "unit_stage_k5"),
           "random": sweeps_timing(cross["sprog"], "random_circuit_100")}
    n = N_SWEEPS
    x = random_planes(n, 3)
    grid_ms = median_ms(lambda: cross["gprog"].run(x))
    log(f"phase timing_sweeps: random_circuit_100 grid_sweep_ms={grid_ms:.4f} "
        f"sweeps_ms={res['random']['ms']:.4f}")
    res["grid_ms"] = grid_ms
    del x
    res["wide_op_ms"] = phase_timing_dense_op()
    return res


DENSE_OP_WIDTHS = (5, 6, 7, 8, 9, 10, 11)
WIDE_GRID = GridParams(WIDE_BLK_BITS, A_MAX)


def phase_timing_dense_op() -> dict:
    """The tiled dense op's cost at 26q: one k-qubit core alone in a low
    sweep (qubits 17-k..16) and in a grid sweep (qubits 0..k-1, the grid's
    geometry for wide cores), less the same sweep holding one 1-qubit op,
    beside its bounds (the flops over float32 FMAs, and three TF32 products
    per real one over the tensor cores: this design's), one
    ``torch.matmul`` of the core on the complex64 view of the same state
    (TF32 off), timed without and with the planes-to-complex64 copies, and
    for k >= 7 the dense pass of the same core on the same state (a second
    yardstick; the sweeps route takes it for unit stages from
    ``MIN_SWEEP_PASS_CORE`` qubits: the crossover of the low sweep holding
    the core alone and the pass is printed beside it, and the route's run
    of the one-op circuit is checked against the matmul)."""
    n = N_SWEEPS
    x = random_planes(n, 3)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    one_op = {}
    rows = {}
    try:
        for k in (1, *DENSE_OP_WIDTHS):
            gate = "h" if k == 1 else _dense_gate(k)
            # qubits 17-k..16: a moving mid qubit (16) makes it a low sweep
            qubits = tuple(range(17 - k, 17))
            # the tiled op forced (the sweep in one launch), and the route's program
            sprog = SweepProgram(tq.Circuit(n).add(gate, *qubits), _one_launch=True)
            route = SweepProgram(tq.Circuit(n).add(gate, *qubits))
            gprog = GridSweepProgram(tq.Circuit(n).add(gate, *range(k)), WIDE_GRID)
            check(sprog.sweep_kinds == ["low"] and gprog.num_sweeps == 1, "one-op programs")
            check([ln.route for ln in route.launches[0]]
                  == ["pass" if k >= MIN_UNIT_PASS_CORE else "unit" if k >= 5 else "tile"],
                  f"{k}-qubit one-op sweep launches {route.launches[0]}")
            one_op[k] = (median_ms(lambda: sprog.launch(x, 0)), median_ms(lambda: gprog.run(x)))
            if k == 1:
                continue
            # the same function as one library call: U on the complex state
            # viewed as (2^(n-17), D, 2^(17-k)); the gate's first qubit
            # (17-k) is its matrix index's MSB and the view's lowest core
            # bit, so U's indices are bit-reversed for the view
            rev = [int(f"{i:0{k}b}"[::-1], 2) for i in range(1 << k)]
            um = tq.gates.gate_matrix(gate)[np.ix_(rev, rev)]
            u = torch.from_numpy(um.astype(np.complex64)).cuda()
            z = torch.complex(x[0], x[1]).view(1 << (n - 17), 1 << k, 1 << (17 - k))
            want = torch.matmul(u, z).reshape(-1)
            got = sprog.run(x.clone())
            err = float(torch.max(torch.abs(torch.complex(got[0], got[1]) - want)))
            got = route.run(x.clone())
            route_err = float(torch.max(torch.abs(torch.complex(got[0], got[1]) - want)))
            del got
            pass_err = pass_ms = None
            if k >= MIN_PASS_CORE:
                # the dense pass: out of place, the same core on the same bits
                tmask = sum(1 << q for q in qubits)
                up = torch.from_numpy(core_operand(tq.gates.gate_matrix(gate), qubits)).cuda()
                got = dense_pass(x, up, tmask)
                pass_err = float(torch.max(torch.abs(torch.complex(got[0], got[1]) - want)))
                del got
                pass_ms = median_ms(lambda: dense_pass(x, up, tmask))
                del up
            del want
            mm_ms = median_ms(lambda: torch.matmul(u, z))

            def with_copy():
                y = torch.matmul(u, torch.complex(x[0], x[1]).view(z.shape)).view(-1)
                x[0].copy_(y.real)
                x[1].copy_(y.imag)

            mm_copy_ms = median_ms(with_copy)
            del z
            flops = sprog.tables[0].flops_per_amp * (1 << n)
            row = {"low_sweep_ms": one_op[k][0] - one_op[1][0],
                   "grid_sweep_ms": one_op[k][1] - one_op[1][1],
                   "bound_ms": bound(0, flops)["flops_ms"],
                   "tf32x3_bound_ms": bound(0, 3 * flops, TF32_FLOP_PER_S)["flops_ms"],
                   "matmul_ms": mm_ms, "matmul_with_copy_ms": mm_copy_ms,
                   "max_abs_err_vs_matmul": err, "one_op_low_sweep_ms": one_op[k][0],
                   "route": route.launches[0][0].route,
                   "route_max_abs_err_vs_matmul": route_err}
            if pass_ms is not None:
                row.update(dense_pass_ms=pass_ms, dense_pass_max_abs_err_vs_matmul=pass_err)
            rows[k] = row
            log(f"phase timing_dense_op: n={n} k={k} {json.dumps(row)}")
            check(err <= 1e-7, f"{k}-qubit op vs torch.matmul {err} > 1e-7")
            check(route_err <= 1e-7, f"{k}-qubit op's route vs torch.matmul {route_err} > 1e-7")
            check(pass_err is None or pass_err <= 1e-7,
                  f"{k}-qubit dense pass vs torch.matmul {pass_err} > 1e-7")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    del x
    log(f"phase timing_dense_op: one_op_ms(low_sweep, grid_sweep)={one_op}")
    faster = [k for k, r in rows.items() if "dense_pass_ms" in r
              and r["dense_pass_ms"] < r["one_op_low_sweep_ms"]]
    log(f"phase timing_dense_op: the dense pass beats the low sweep holding the core alone "
        f"at k = {faster}; the sweeps route takes it from k = {MIN_UNIT_PASS_CORE}")
    return rows


# ---------------------------------------------------------------------------
# The noisy, density-matrix and variational paths, and certification at
# 29-30 qubits (torch engine; certification on the grid-sweep kernel)
# ---------------------------------------------------------------------------


def peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2 ** 30


def fresh_peak() -> float:
    """Reset the peak device memory; returns the GiB that earlier phases
    still hold, which the peak includes."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated() / 2 ** 30


def phase_certify() -> dict:
    """The four checks of ``certify``: the closed forms at 29 and 30 qubits
    and the cross-engine check at 28, each on the grid-sweep kernel (its
    launches counted, no other kernel), with the peak device memory of
    each size; the QFT check's engine run timed at 29 and 30."""
    out = {"launches": {}}
    for n in (29, 30):
        held = fresh_peak()
        reset_launches()
        t0 = time.perf_counter()
        vals = {
            "qft": certify.qft_analytic_max_diff(n),
            "diag": certify.diag_layer_analytic_max_diff(n),
            "perm": certify.permutation_analytic_max_dev(n),
        }
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        peak = peak_gib()
        scaled = 1e-4 * 2.0 ** (-n / 2)
        prog = GridSweepProgram(tq.qft_circuit(n))
        x = ap.initial_state(n, np.float32, 1, "cuda")
        check(x.is_cuda, "certify state not on the card")
        ms = median_ms(lambda: prog.run(x))
        del x
        b = bound(prog.bytes_moved(), prog.flops())
        log(f"phase {n}q_certify: wall_s={wall:.3f} qft={vals['qft']:.3e} diag={vals['diag']:.3e} "
            f"perm={vals['perm']:.3e} (tol 5e-6; qft, diag also <= {scaled:.3e}) "
            f"launches={launches} peak_gib={peak:.3f} held_gib={held:.3f} qft_run_ms={ms:.4f} "
            f"qft_sweeps={prog.num_sweeps} qft_bound_ms={b['bound_ms']:.4f} ({b['bound_by']})")
        check(launches.get("grid_sweep", 0) > 0 and set(launches) == {"grid_sweep"},
              f"{n}q certify launches {launches}")
        check(max(vals.values()) < 5e-6, f"{n}q certify {vals}")
        check(vals["qft"] <= scaled and vals["diag"] <= scaled, f"{n}q certify beyond {scaled}")
        out[n] = {**vals, "peak_gib": peak, "held_gib": held, "qft_run_ms": ms,
                  "qft_bound_ms": b["bound_ms"], "wall_s": wall}
        out["launches"][n] = launches.get("grid_sweep", 0)
    held = fresh_peak()
    reset_launches()
    t0 = time.perf_counter()
    cross = certify.cross_engine_max_diff(tq.random_circuit(N_MAIN, 100, seed=42))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    log(f"phase {N_MAIN}q_certify_cross_engine: wall_s={time.perf_counter() - t0:.3f} "
        f"max_abs_diff={cross:.3e} (tol 5e-6) launches={launches} peak_gib={peak_gib():.3f} held_gib={held:.3f}")
    check(launches.get("grid_sweep", 0) > 0, f"cross-engine launches {launches}")
    check(cross < 5e-6, f"{N_MAIN}q cross-engine {cross}")
    out["cross_28"] = cross
    return out


def noisy_10q_circuit() -> "tq.Circuit":
    """An H layer, then ``random_circuit(10, 60, seed=5)``: every trajectory
    spreads over the basis states, so no p_b(x) sits in a rare-event tail
    that the 5-sigma bound's sample std would understate."""
    c = tq.Circuit(10)
    for q in range(10):
        c.h(q)
    for g in tq.random_circuit(10, 60, seed=5).gates:
        c.append(g)
    return c


def phase_noisy() -> dict:
    """Trajectories: ``NoisySimulator(24)`` with every channel at p = 0
    against ``StateVectorSimulator(24)``; with a global depolarizing channel
    and amplitude damping on qubits 0-3 (norm kept), timed; the ensemble of
    ``BatchedSimulator(10, 1024)`` against ``DensityMatrixSimulator(10)``'s
    exact rho (5 sigma); ``BatchedSimulator(20, 128)`` timed."""
    n = 24
    c = tq.random_circuit(n, 40, seed=42)
    zero = tq.NoiseModel().add_depolarizing(0.0).add_amplitude_damping(0.0, list(range(4)))
    t0 = time.perf_counter()
    noisy = tq.NoisySimulator(n, zero, seed=1).run(c)
    ideal = tq.StateVectorSimulator(n).run(c)
    check(noisy.state_planes.is_cuda and ideal.state_planes.is_cuda, "24q noisy not on the card")
    err, _ = compare(noisy.state_planes, ideal.state_planes)
    log(f"phase {n}q_noisy_p0: wall_s={time.perf_counter() - t0:.3f} max_abs_err={err:.3e} "
        f"(tol 1e-5) against {ideal.engine}")
    check(err <= 1e-5, f"24q noisy at p = 0 vs ideal {err}")
    del noisy, ideal

    model = tq.NoiseModel().add_depolarizing(1e-3).add_amplitude_damping(1e-3, list(range(4)))
    sim = tq.NoisySimulator(n, model, seed=2)
    held = fresh_peak()

    def trajectory():
        sim.reset()
        sim.run(c)

    ms = median_ms(trajectory)
    norm = sim.total_probability()
    peak = peak_gib()
    _, n_draws = sim._compiled_run(c)
    log(f"phase {n}q_noisy: ms={ms:.3f} (median of 5) channel_applications={n_draws} "
        f"norm={norm:.7f} (tol 1e-4) peak_gib={peak:.3f} held_gib={held:.3f}")
    check(sim.state_planes.is_cuda, "trajectory not on the card")
    check(abs(norm - 1.0) <= 1e-4, f"24q trajectory norm {norm}")
    res = {"noisy_24q": {"ms": ms, "peak_gib": peak, "held_gib": held,
                         "p0_max_abs_err": err, "norm": norm}}
    del sim

    c10 = noisy_10q_circuit()
    model10 = tq.NoiseModel().add_depolarizing(0.01)
    batch = 1024
    t0 = time.perf_counter()
    ens = tq.BatchedSimulator(10, batch, model10, seed=3, insertion="all").run(c10)
    dm = tq.DensityMatrixSimulator(10, model10, insertion="all").run(c10)
    check(ens.state_planes.is_cuda and dm.state_planes.is_cuda, "10q ensemble not on the card")
    p = ens.trajectory_probabilities().double()
    rho = dm.probabilities().double()
    excess = (p.mean(0) - rho).abs() - (5 * p.std(0) / math.sqrt(batch) + 1e-6)
    worst = float(excess.max())
    log(f"phase 10q_batched_vs_density: wall_s={time.perf_counter() - t0:.3f} "
        f"max(|mean - rho_xx| - (5 std/sqrt(B) + 1e-6))={worst:.3e} (tol <= 0) "
        f"max_abs_diff={float((p.mean(0) - rho).abs().max()):.3e} trace={dm.trace():.7f}")
    check(worst <= 0.0, f"10q ensemble beyond 5 sigma of rho: {worst}")
    res["batched_vs_density_10q"] = worst
    del ens, dm, p

    nb, batch = 20, 128
    cb = tq.random_circuit(nb, 10, seed=42)
    held = fresh_peak()
    bsim = tq.BatchedSimulator(nb, batch, model, seed=4)

    def batched():
        bsim.reset()
        bsim.run(cb)

    ms_b = median_ms(batched)
    peak_b = peak_gib()
    tp = bsim.total_probability()
    log(f"phase {nb}q_batched: batch={batch} state_gib={bsim.total_memory_bytes / 2 ** 30:.3f} "
        f"ms={ms_b:.3f} (median of 5) peak_gib={peak_b:.3f} held_gib={held:.3f} "
        f"total_probability={tp:.7f}")
    check(bsim.state_planes.is_cuda, "batch not on the card")
    check(abs(tp - 1.0) <= 1e-4, f"20q batch total probability {tp}")
    res["batched_20q"] = {"ms": ms_b, "peak_gib": peak_b, "held_gib": held}
    return res


def phase_density() -> dict:
    """``DensityMatrixSimulator(14)`` with depolarizing and amplitude damping
    (trace, validity, purity), timed with its peak memory; the noiseless 14q
    rho against ``StateVectorSimulator(14)``; 8q rho on the card against the
    port's rho on the CPU."""
    n = 14
    c = tq.random_circuit(n, 40, seed=42)
    model = tq.NoiseModel().add_depolarizing(1e-3).add_amplitude_damping(1e-3)
    held = fresh_peak()
    dm = tq.DensityMatrixSimulator(n, model)

    def run():
        dm.reset()
        dm.run(c)

    ms = median_ms(run)
    peak = peak_gib()
    tr, pu, valid = dm.trace(), dm.purity(), dm.is_valid()
    log(f"phase {n}q_density: ms={ms:.3f} (median of 5) trace={tr:.7f} (tol 1e-4) "
        f"purity={pu:.6f} valid={valid} peak_gib={peak:.3f} held_gib={held:.3f} "
        f"rho_gib={dm.memory_bytes / 2 ** 30:.3f}")
    check(dm.state_planes.is_cuda, "rho not on the card")
    check(abs(tr - 1.0) <= 1e-4 and valid and pu < 1.0, f"14q rho trace {tr} purity {pu}")
    del dm
    clean = tq.DensityMatrixSimulator(n).run(c)
    sv = tq.StateVectorSimulator(n).run(c)
    fid = clean.fidelity_with(sv)
    log(f"phase {n}q_density_noiseless: fidelity={fid:.9f} (tol 1 - 1e-5) against {sv.engine}")
    check(1.0 - fid <= 1e-5, f"14q noiseless rho fidelity {fid}")
    del clean, sv

    c8 = tq.random_circuit(8, 12, seed=7).cry(0, 7, 0.3)
    card = tq.DensityMatrixSimulator(8, model).run(c8)
    cpu = tq.DensityMatrixSimulator(8, model, device="cpu").run(c8)
    err8 = float((card.state_planes.cpu() - cpu.state_planes).abs().max())
    log(f"phase 8q_density_card_vs_cpu: max_abs_err={err8:.3e} (tol 1e-5)")
    check(card.state_planes.is_cuda, "8q rho not on the card")
    check(err8 <= 1e-5, f"8q rho card vs CPU {err8}")
    return {"ms": ms, "peak_gib": peak, "held_gib": held, "trace": tr, "purity": pu, "fidelity": fid, "card_vs_cpu": err8}


def tfim_ground_energy(n: int) -> float:
    """Exact ground energy of ``tfim_hamiltonian(n)`` from its dense matrix."""
    paulis = {"I": np.eye(2), "X": np.array([[0, 1], [1, 0]]), "Z": np.diag([1, -1])}
    h = np.zeros((1 << n, 1 << n))
    for coeff, word in tq.tfim_hamiltonian(n):
        m = np.ones((1, 1))
        for ch in word:          # leftmost character is the highest qubit
            m = np.kron(m, paulis[ch])
        h += coeff * m
    return float(np.linalg.eigvalsh(h)[0])


def phase_variational() -> dict:
    """``build_expectation_fn`` at 20 qubits: the autograd gradient against
    the parameter shift on 4 rotations (1e-3), a batch of 8 parameter vectors
    against 8 single calls (1e-5), expectation + gradient timed;
    ``vqe_minimize`` on ``tfim_hamiltonian(10)`` for 50 steps."""
    n = 20
    c = tq.hardware_efficient_ansatz(n, 4)
    f = tq.build_expectation_fn(c, tq.tfim_hamiltonian(n))
    params = torch.tensor(c.params(), device="cuda", requires_grad=True)
    held = fresh_peak()

    def value_and_grad():
        params.grad = None
        e = f(params)
        e.backward()
        return e

    e = value_and_grad()
    check(e.is_cuda and params.grad.is_cuda, "expectation not on the card")
    grad = params.grad.clone()
    shift_err = 0.0
    with torch.no_grad():
        for i in (0, 1, 77, len(c.params()) - 1):
            s = torch.zeros_like(params)
            s[i] = math.pi / 2
            ps = float((f(params + s) - f(params - s)) / 2)
            shift_err = max(shift_err, abs(ps - float(grad[i])))
        batch = torch.stack([params + 0.1 * k for k in range(8)])
        together = f(batch)
        singles = torch.stack([f(row) for row in batch])
        batch_err = float((together - singles).abs().max())
    ms = median_ms(value_and_grad)
    peak = peak_gib()
    log(f"phase {n}q_expectation: energy={float(e.detach()):.6f} params={len(c.params())} "
        f"terms={len(tq.tfim_hamiltonian(n))} param_shift_max_diff={shift_err:.3e} (tol 1e-3) "
        f"batch8_max_diff={batch_err:.3e} (tol 1e-5) value_and_grad_ms={ms:.3f} (median of 5) "
        f"peak_gib={peak:.3f} held_gib={held:.3f}")
    check(shift_err <= 1e-3, f"gradient vs parameter shift {shift_err}")
    check(together.is_cuda, "batched expectation not on the card")
    check(batch_err <= 1e-5, f"batch of 8 vs single calls {batch_err}")

    t0 = time.perf_counter()
    energy, best, hist = tq.vqe_minimize(tq.tfim_hamiltonian(10), 10, steps=50)
    wall = time.perf_counter() - t0
    exact = tfim_ground_energy(10)
    log(f"phase 10q_vqe: wall_s={wall:.3f} steps=50 start={hist[0]:.6f} final={hist[-1]:.6f} "
        f"best={energy:.6f} exact_ground={exact:.6f}")
    check(best.is_cuda, "VQE parameters not on the card")
    check(hist[-1] < hist[0], f"VQE did not descend: {hist[0]} -> {hist[-1]}")
    return {"value_and_grad_ms": ms, "peak_gib": peak, "held_gib": held,
            "param_shift_max_diff": shift_err,
            "batch8_max_diff": batch_err, "vqe_start": hist[0], "vqe_final": hist[-1],
            "vqe_exact": exact, "vqe_wall_s": wall}


ROOT = os.path.dirname(os.path.abspath(__file__))
JAX_SIDE = ("jax", "jaxlib", "flax", "tpu_qsim")   # none is ever imported
RUN_DIR = os.path.join(ROOT, ".smoke_run")   # rendezvous files, the trace
SHARD_RANKS = 4
N_SHARD = 28        # 26 local qubits a rank: the grid sweep on every shard
N_SHARD_WHOLE = 20  # 18 local qubits a rank: the whole-circuit kernel
SHARD_TIMEOUT_S = 400


def _all_max(x: float) -> float:
    t = torch.tensor([float(x)], dtype=torch.float64, device="cuda")
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def _slice_err(shard: torch.Tensor, full: torch.Tensor, rank: int) -> float:
    """max |d amp| between a rank's shard and its slice of a full state."""
    lo = rank * shard.shape[1]
    return compare(shard, full[:, lo:lo + shard.shape[1]])[0]


def _synced() -> float:
    torch.cuda.synchronize()
    dist.barrier()
    return time.perf_counter()


def rank_sharded(rank: int, world: int) -> dict:
    """One rank of the sharded phase; every rank of the gloo group runs it
    on the one card, the maxima of its errors taken across ranks."""
    res = {}
    mesh = make_mesh(("tp",))

    # 1. the main sharded path: 28 qubits, the grid sweep on every shard
    c = tq.random_circuit(N_SHARD, 100, seed=42)
    res["auto_engine"] = ShardedStateVectorSimulator(N_SHARD, mesh).engine
    check(res["auto_engine"] == "collective", f"auto at {N_SHARD}q picked {res['auto_engine']}")
    sim = ShardedStateVectorSimulator(N_SHARD, mesh, engine="sweeps", seed=42)
    t0 = _synced()
    reset_launches()
    sim.run(c)
    res["first_run_ms"] = 1e3 * (_synced() - t0)
    res["launches"] = dict(LAUNCHES)
    _, prog = sim.compiled_run(c)
    res["engines"], res["exchanges"] = prog.engines, prog.exchanges
    res["planned_exchanges"] = prog.planned_exchanges
    check(res["launches"].get("grid_sweep", 0) > 0, f"rank {rank}: no grid sweep {res['launches']}")
    check(set(prog.engines) == {"grid_sweep"}, f"shard engines {prog.engines}")
    check(prog.exchanges == prog.planned_exchanges,
          f"{prog.exchanges} all_to_all calls for a plan of {prog.planned_exchanges}")
    ref = tq.StateVectorSimulator(N_SHARD).run(c).state_planes
    res["max_abs_err"] = _all_max(_slice_err(sim.state_planes, ref, rank))
    del ref
    torch.cuda.empty_cache()
    check(res["max_abs_err"] <= 1e-6, f"{N_SHARD}q sharded vs one card {res['max_abs_err']}")
    sim.reset()
    times = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = _synced()
    prog.run(sim.state_planes, times)
    res["run_ms"] = 1e3 * (_synced() - t0)
    res["exchange_ms"], res["local_ms"] = times["exchange_ms"], times["local_ms"]
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    # each rank's segment programs alone on the card (the others wait)
    for r in range(world):
        _synced()
        if r == rank:
            x = sim.state_planes.clone()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _, step in prog.steps:
                x = step(x)
            end.record()
            torch.cuda.synchronize()
            res["local_alone_ms"] = start.elapsed_time(end)
            del x
    del sim, prog
    torch.cuda.empty_cache()

    # 2. 18 local qubits: the whole-circuit kernel, one launch a segment;
    # 3. the replicated ("gspmd") engine, which "auto" picks at 20 qubits
    c20 = tq.random_circuit(N_SHARD_WHOLE, 100, seed=42)
    oracle = oracle_planes(c20, "cuda")
    s20 = ShardedStateVectorSimulator(N_SHARD_WHOLE, mesh, engine="sweeps")
    reset_launches()
    s20.run(c20)
    torch.cuda.synchronize()
    res["whole_launches"] = LAUNCHES["whole_circuit"]
    _, p20 = s20.compiled_run(c20)
    check(set(p20.engines) == {"whole_circuit"} and res["whole_launches"] == len(p20.engines),
          f"20q shards: {p20.engines}, {dict(LAUNCHES)}")
    res["whole_max_abs_err"] = _all_max(_slice_err(s20.state_planes, oracle, rank))
    check(res["whole_max_abs_err"] <= 1e-6, f"20q sharded vs oracle {res['whole_max_abs_err']}")
    g20 = ShardedStateVectorSimulator(N_SHARD_WHOLE, mesh)
    check(g20.engine == "gspmd", f"auto at 20q picked {g20.engine}")
    reset_launches()
    g20.run(c20)
    torch.cuda.synchronize()
    res["gspmd_launches"] = dict(LAUNCHES)
    res["gspmd_max_abs_err"] = _all_max(_slice_err(g20.state_planes, oracle, rank))
    check(res["gspmd_max_abs_err"] <= 1e-6, f"20q gspmd vs oracle {res['gspmd_max_abs_err']}")
    del s20, g20, oracle

    # 4. readouts on a sharded GHZ-28
    last = (1 << N_SHARD) - 1
    ghz = ShardedStateVectorSimulator(N_SHARD, mesh, engine="sweeps", seed=7)
    ghz.run(tq.ghz_circuit(N_SHARD))
    res["ghz_total_probability"] = ghz.total_probability()
    res["ghz_z_top"] = ghz.expectation_pauli("Z" + "I" * (N_SHARD - 1))
    res["ghz_zz_device"] = ghz.expectation_pauli("ZZ" + "I" * (N_SHARD - 2))
    hist = ghz.histogram(1000)
    hists = [None] * world
    dist.all_gather_object(hists, hist)
    res["ghz_histogram"] = hist
    res["ghz_measure"] = [ghz.measure_qubit(N_SHARD - 1), ghz.measure_qubit(3)]
    check(abs(res["ghz_total_probability"] - 1.0) <= 1e-5, f"GHZ total {res['ghz_total_probability']}")
    check(abs(res["ghz_z_top"]) <= 1e-5 and abs(res["ghz_zz_device"] - 1.0) <= 1e-5,
          f"GHZ <Z_27> {res['ghz_z_top']}, <Z_27 Z_26> {res['ghz_zz_device']}")
    check(set(hist) <= {0, last} and sum(hist.values()) == 1000, f"GHZ histogram {hist}")
    check(all(h == hist for h in hists), f"histograms differ across ranks: {hists}")
    check(res["ghz_measure"][0] == res["ghz_measure"][1], f"GHZ outcomes {res['ghz_measure']}")
    del ghz
    torch.cuda.empty_cache()

    # 5. trajectories: dp = 4 against the unsharded batch, then dp 2 x tp 2
    dp = make_mesh(("dp",))
    dp_tp = make_mesh(("dp", "tp"), (2, 2))
    model = tq.NoiseModel().add_depolarizing(1e-3).add_amplitude_damping(1e-3, list(range(4)))
    cb = tq.random_circuit(20, 10, seed=42)
    sb = ShardedBatchedSimulator(20, 128, model, dp, seed=4)
    t0 = _synced()
    sb.run(cb)
    res["batched_ms"] = 1e3 * (_synced() - t0)
    ref = tq.BatchedSimulator(20, 128, model, seed=4).run(cb).state_planes
    rows = ref[rank * sb.local_batch:(rank + 1) * sb.local_batch]
    res["batched_max_abs_err"] = _all_max(float((sb.state_planes - rows).abs().max()))
    check(res["batched_max_abs_err"] <= 1e-6, f"sharded batch vs batch {res['batched_max_abs_err']}")
    del sb, ref, rows
    s2 = ShardedBatchedSimulator(16, 8, tq.NoiseModel().add_bit_flip(0.05), dp_tp,
                                 tp_axis="tp", seed=1).run(tq.random_circuit(16, 30, seed=4))
    res["dp_tp_total_probability"] = s2.total_probability()
    res["dp_tp_counts"] = sum(s2.histogram(50).values())
    check(abs(res["dp_tp_total_probability"] - 1.0) <= 1e-5,
          f"dp x tp total {res['dp_tp_total_probability']}")
    check(res["dp_tp_counts"] == 8 * 50, f"dp x tp histogram holds {res['dp_tp_counts']}")
    return res


def phase_sharded() -> dict:
    """Four gloo ranks on the one card (``rank_sharded``), joined under a
    deadline."""
    log(f"phase sharded: {SHARD_RANKS} ranks on one card over gloo (NCCL refuses two "
        "ranks on one device; gloo stages every CUDA tensor through host memory)")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    os.makedirs(RUN_DIR, exist_ok=True)
    store = tempfile.mkdtemp(dir=RUN_DIR)
    t0 = time.perf_counter()
    try:
        ranks = run_ranks(rank_sharded, SHARD_RANKS, backend="gloo", store_dir=store,
                          timeout=SHARD_TIMEOUT_S, group_timeout=120.0)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    out = {
        "ranks": SHARD_RANKS,
        "launches": sum(r["launches"].get("grid_sweep", 0) for r in ranks),
        "launches_by_rank": [r["launches"] for r in ranks],
        "max_abs_err": r0["max_abs_err"],
        "exchanges": r0["exchanges"],
        "run_ms": max(r["run_ms"] for r in ranks),
        "exchange_ms": max(r["exchange_ms"] for r in ranks),
        "local_ms": [r["local_ms"] for r in ranks],
        "local_alone_ms": [r["local_alone_ms"] for r in ranks],
        "first_run_ms": max(r["first_run_ms"] for r in ranks),
        "peak_gib": [r["peak_gib"] for r in ranks],
        "whole_launches": sum(r["whole_launches"] for r in ranks),
        "whole_max_abs_err": r0["whole_max_abs_err"],
        "gspmd_max_abs_err": r0["gspmd_max_abs_err"],
        "gspmd_launches": r0["gspmd_launches"],
        "batched_ms": max(r["batched_ms"] for r in ranks),
        "batched_max_abs_err": r0["batched_max_abs_err"],
        "phase_s": wall,
    }
    log(f"phase {N_SHARD}q_sharded: ranks={SHARD_RANKS} engine=sweeps auto={r0['auto_engine']} "
        f"shard_engines={r0['engines']} exchanges={r0['exchanges']} (plan "
        f"{r0['planned_exchanges']}) launches_by_rank={out['launches_by_rank']} "
        f"max_abs_err={out['max_abs_err']:.3e} (tol 1e-6, vs one card) "
        f"first_run_ms={out['first_run_ms']:.3f} run_ms={out['run_ms']:.3f} "
        f"exchange_ms={out['exchange_ms']:.3f} (gloo through the host) "
        f"local_ms_by_rank={[round(x, 3) for x in out['local_ms']]} (4 contexts time-sliced) "
        f"local_alone_ms_by_rank={[round(x, 3) for x in out['local_alone_ms']]} "
        f"peak_gib_by_rank={[round(x, 3) for x in out['peak_gib']]}")
    log(f"phase {N_SHARD_WHOLE}q_sharded: whole_circuit launches={out['whole_launches']} "
        f"max_abs_err={out['whole_max_abs_err']:.3e} (tol 1e-6, vs oracle); gspmd "
        f"launches={out['gspmd_launches']} max_abs_err={out['gspmd_max_abs_err']:.3e} (tol 1e-6)")
    log(f"phase {N_SHARD}q_sharded_readouts: total_probability={r0['ghz_total_probability']:.7f} "
        f"<Z_27>={r0['ghz_z_top']:.3e} <Z_27 Z_26>={r0['ghz_zz_device']:.7f} "
        f"histogram={r0['ghz_histogram']} measure(27, 3)={r0['ghz_measure']}")
    log(f"phase 20q_sharded_batched: dp={SHARD_RANKS} batch=128 ms={out['batched_ms']:.3f} "
        f"max_abs_err={out['batched_max_abs_err']:.3e} (tol 1e-6, vs BatchedSimulator); "
        f"16q dp2 x tp2 total_probability={r0['dp_tp_total_probability']:.7f} "
        f"histogram_counts={r0['dp_tp_counts']}")
    log(f"phase sharded: {wall:.1f} s")
    return out


def phase_demo() -> dict:
    """``python -m tpu_qsim_torch`` on the card: exit 0, the Bell state's
    |00> and |11> at P = 0.5000."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "tpu_qsim_torch"], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"demo exited {proc.returncode}:\n{proc.stdout}{proc.stderr}")
    bell = [line for line in proc.stdout.splitlines() if "amp =" in line]
    good = [line for line in bell if ("|00>" in line or "|11>" in line) and "P = 0.5000" in line]
    log(f"phase demo: wall_s={wall:.3f} rc=0 bell={[line.strip() for line in bell]}")
    check(len(good) == 2, f"demo Bell lines: {bell}")
    return {"wall_s": wall}


def phase_profiler() -> dict:
    """A 20-qubit run inside ``utils.profiler_trace``: the trace holds the
    grid sweep's kernel events."""
    trace_dir = os.path.join(RUN_DIR, "profile")
    c = tq.random_circuit(20, 100, seed=42)
    sim = tq.StateVectorSimulator(20).run(c)
    sim.reset()
    with utils.profiler_trace(trace_dir):
        sim.run(c)
    with open(os.path.join(trace_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    grid = [e for e in events
            if e.get("cat") == "kernel" and "grid_sweep_kernel" in e.get("name", "")]
    log(f"phase profiler: kernel_events={sum(e.get('cat') == 'kernel' for e in events)} "
        f"grid_sweep_events={len(grid)} grid_sweep_us={sum(e.get('dur', 0) for e in grid):.1f}")
    check(grid, "the trace holds no grid_sweep_kernel event")
    return {"grid_sweep_events": len(grid)}


START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    build = phase_build()
    oracles = start_route_oracles()
    try:
        return run_phases(card, build, oracles)
    finally:
        oracles[0].shutdown(cancel_futures=True)


def run_phases(card: str, build: dict, oracles: tuple) -> int:
    phase_20q_oracle()
    phase_whole_circuit_oracle()
    whole = phase_main(N_WHOLE, "whole_circuit", ("whole_circuit",))
    check(whole["launches"] == {"whole_circuit": 1}, f"18q launches {whole['launches']}")
    log(f"phase {N_WHOLE}q_whole_stages: {check_whole_stages(whole['prog'])}")
    whole_closed = phase_closed_forms(N_WHOLE, "whole_circuit")
    seg = phase_segmented()
    seg_closed = phase_closed_forms(N_SEG, "segmented")
    fallback = phase_grid_fallback()
    fault1 = phase_fault1_segmented()
    sweeps_oracle = phase_22q_sweeps_oracle()
    sweeps = phase_sweeps_main()
    unit = phase_sweeps_unit()
    cross = phase_sweeps_cross_engine()
    wide = phase_wide_cores()
    passes = phase_dense_pass()
    streams = phase_stream_passes()
    main_res = phase_28q_main()
    nat = phase_native(main_res)
    flo = phase_floor(main_res)
    fixtures = phase_fixtures()
    closed = phase_closed_forms(N_MAIN, "grid_sweep")
    timing = phase_timing(main_res["sim"], main_res["prog"])
    t_whole = phase_timing_whole_circuit()
    t_seg = phase_timing_segmented(seg["prog"])
    t_sweeps = phase_timing_sweeps(sweeps["prog"], cross, unit["prog"])
    paths = {}
    for name, phase in (("certify", phase_certify), ("noisy", phase_noisy),
                        ("density", phase_density), ("variational", phase_variational)):
        t0 = time.perf_counter()
        paths[name] = phase()
        paths[name]["phase_s"] = time.perf_counter() - t0
        log(f"phase {name}: {paths[name]['phase_s']:.1f} s")
    # late, so that the host oracles started with the build have finished
    route = phase_route_by_width(oracles)
    sharded = phase_sharded()
    paths["demo"] = phase_demo()
    paths["profiler"] = phase_profiler()
    kernels = [{
        "name": "grid_sweep",
        "route": "cuda",
        "source": "tpu_qsim_torch/kernels/csrc/grid_sweep.cu",
        "replaces": "tpu_qsim/kernels/gridsweeps.py:566",
        "launches": main_res["launches"],
        "max_abs_err": main_res["max_abs_err"],
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "route_by_width": {name: r for name, r in route.items()
                           if r["launches"].get("grid_sweep")},
        "census_ops_floor_ms": flo["census_ops_floor_ms"],
        "max_bytes_ops_bound_ms": flo["max_bytes_ops_ms"],
        "loop_model_ms": flo["loop_model_ms"],
        "fidelity": main_res["fidelity"],
        "certify_launches": paths["certify"]["launches"],
        "ghz_max_abs_err": closed["ghz_max_abs_err"],
        "qft_max_mag_err": closed["qft_max_mag_err"],
        "sharded_launches": sharded["launches"],
        "sharded_max_abs_err": sharded["max_abs_err"],
        "sharded_run_ms": sharded["run_ms"],
        "sharded_exchange_ms": sharded["exchange_ms"],
        "exchanges": sharded["exchanges"],
        "ranks": sharded["ranks"],
    }, {
        "name": "whole_circuit",
        "route": "cuda",
        "source": "tpu_qsim_torch/kernels/csrc/sweep.cu",
        "replaces": "tpu_qsim/kernels/fused_circuit.py:1552",
        "launches": whole["launches"]["whole_circuit"],
        "max_abs_err": whole["max_abs_err"],
        "ms": t_whole[N_WHOLE]["ms"],
        "plain_ms": t_whole[N_WHOLE]["plain_ms"],
        "bound_ms": t_whole[N_WHOLE]["bound_ms"],
        "bound_by": t_whole[N_WHOLE]["bound_by"],
        "library_ms": None,
        "eager_ms": t_whole[N_WHOLE]["eager_ms"],
        "torch_engine_ms": t_whole[N_WHOLE]["torch_engine_ms"],
        "ms_by_qubits": {n: r["ms"] for n, r in t_whole.items()},
        "stages_by_qubits": {n: r["stages"] for n, r in t_whole.items()},
        "fidelity": whole["fidelity"],
        "ghz_max_abs_err": whole_closed["ghz_max_abs_err"],
        "qft_max_mag_err": whole_closed["qft_max_mag_err"],
        "sharded_launches": sharded["whole_launches"],
        "sharded_max_abs_err": sharded["whole_max_abs_err"],
    }]
    for name, line in (("segment", 162), ("scatter_segment", 307)):
        k = t_seg["kernels"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "tpu_qsim_torch/kernels/csrc/segment.cu",
            "replaces": f"tpu_qsim/kernels/segmented.py:{line}",
            "launches": seg["segment_kinds"][name],
            "max_abs_err": seg["step_err"][name],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": None,
            "run_ms": t_seg["run_ms"],
            "run_launches": seg["launches"]["segment"],
            "run_bound_ms": t_seg["bound_ms"],
            "run_max_abs_err": seg["run_err"],
            "eager_run_ms": t_seg["eager_ms"],
            "torch_engine_ms": t_seg["torch_engine_ms"],
            "oracle_max_abs_err": seg["oracle_err"],
            "ghz_max_abs_err": seg_closed["ghz_max_abs_err"],
            "qft_max_mag_err": seg_closed["qft_max_mag_err"],
            "fallback_max_abs_err": fallback["fallback_err"],
            "fault1_22q_max_abs_err": fault1["max_abs_err"],
            "cross_engine_max_abs_err": fallback["cross_err"],
            "route_by_width": {name: r for name, r in route.items()
                               if r["launches"].get("segment")},
        })
    # unit_stage: the low sweep's unit stage on the wide instance (its tiled
    # op, ops.cuh). No route reaches it since the sweeps send unit stages of
    # MIN_UNIT_PASS_CORE qubits or more to the dense pass (the main path's
    # 8-qubit one among them) and the grid planner refuses no narrower core:
    # its main-path launches are 0, and its figures come from its own path
    # outside the main one (phase_sweeps_unit: a 5-qubit core in a
    # SweepProgram planned directly); its library call one torch.matmul
    for name, line in (("low_sweep", 292), ("high_sweep", 370), ("unit_stage", 292)):
        path, timed = (unit, t_sweeps["unit"]) if name == "unit_stage" else (sweeps, t_sweeps["main"])
        k = timed["kernels"][name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": "tpu_qsim_torch/kernels/csrc/sweep.cu",
            "replaces": f"tpu_qsim/kernels/sweeps.py:{line}",
            "launches": sweeps["launches"].get(name, 0),
            "max_abs_err": path["step_err"][name],
            "ms": k["ms"],
            "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"],
            "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
            "per_launch_ms": k["per_launch_ms"],
            "run_ms": t_sweeps["main"]["ms"],
            "run_bound_ms": t_sweeps["main"]["bound_ms"],
            "run_fidelity": sweeps["fidelity"],
            "random_circuit_run_ms": t_sweeps["random"]["ms"],
            "random_circuit_grid_sweep_ms": t_sweeps["grid_ms"],
            "oracle_22q_max_abs_err": sweeps_oracle["max_abs_err"],
            "cross_engine_max_abs_err": cross["cross_err"],
            "fp32_bound_ms": k["fp32_bound_ms"],
            "launch_passes_ms": k["launch_passes_ms"],
            "run_tf32x3_bound_ms": t_sweeps["main"]["tf32x3_bound_ms"],
            "wide_op_ms": t_sweeps["wide_op_ms"],
            "wide_core_max_abs_err": wide,
            "tiled_op_sass": build["tiled_op_sass"],
        }
        if name == "unit_stage":
            entry["figures_from"] = ("off_main_path: 26q_sweeps_unit, a 5-qubit core in a "
                                     "SweepProgram planned directly (no route reaches it)")
            entry["off_main_path_launches"] = unit["launches"][name]
            entry["off_main_path_core_qubits"] = 5
        kernels.append(entry)
    # dense_pass: the sweeps main path's own pass (its 8-qubit core on
    # qubits 10-17, the stream instance), launched once there; its time,
    # plain version and torch.matmul from that launch on one input, its
    # bound its own (bytes, or the core's operations in 3xTF32); the
    # 12-qubit passes (phase_dense_pass) and the 7-9-qubit cores alone
    # (phase_stream_passes) beside it
    main_pass = t_sweeps["main"]["kernels"]["dense_pass"]
    kernels.append({
        "name": "dense_pass",
        "route": "cuda",
        "source": "tpu_qsim_torch/kernels/csrc/dense_pass.cu",
        "replaces": "tpu_qsim/kernels/fused_circuit.py:569",
        "launches": sweeps["launches"]["dense_pass"],
        "instances": sweeps["pass_instances"],
        "max_abs_err": sweeps["step_err"]["dense_pass"],
        "ms": main_pass["ms"],
        "plain_ms": main_pass["plain_ms"],
        "bound_ms": main_pass["own_bound_ms"],
        "bound_by": main_pass["own_bound_by"],
        "library_ms": main_pass["library_ms"],
        "main_path": f"{N_SWEEPS}q sweeps main path: an 8-qubit core on qubits 10-17",
        "by_qubits": passes,
        "route_by_width": {name: r for name, r in route.items() if r["launches"].get("dense_pass")},
        # the 7-9-qubit cores alone, by instance (phase_stream_passes)
        "by_instance": {row["row"]: {
            "picked": row["picked"], "bound_ms": row["bound_ms"],
            **{f"{i}_ms": row[i]["ms"] for i in ("stream", "large")},
            **{f"{i}_share": row[i]["share"] for i in ("stream", "large")},
            "matmul_ms": row.get("matmul_ms"), "matmul_with_copies_ms": row.get("matmul_with_copies_ms"),
            "plain_ms": row["plain"]["ms"]} for rows in streams.values() for row in rows},
    })
    vpu = flo["vpu"]
    kernels.append({
        "name": "rotation_chain",
        "route": "cuda",
        "source": "tpu_qsim_torch/kernels/csrc/rotation_chain.cu",
        "replaces": "benchmarks/benchmark_floor.py:359",
        "launches": flo["launches"],
        "max_abs_err": max(flo["max_abs_err"].values()),
        "ms": vpu["ms"][-1],
        "plain_ms": flo["plain_ms"],
        "bound_ms": vpu["bounds"][-1]["bound_ms"],
        "bound_by": vpu["bounds"][-1]["bound_by"],
        "library_ms": flo["library_ms"],
        "library_call": "torch.matmul of the K rotations folded into one 2x2 (1/K of the arithmetic)",
        "library_max_abs_err": flo["library_max_abs_err"],
        "k": vpu["ks"][-1],
        "ms_by_k": dict(zip(vpu["ks"], vpu["ms"])),
        "tinstr_per_s": vpu["rates"][-1]["tinstr_per_s"],
        "tflop_per_s": vpu["rates"][-1]["tflop_per_s"],
        "rates": vpu["rates"],
        "issue_bound_ms": vpu["bounds"][-1]["issue_ms"],
        "sm_clock_mhz": vpu["sm_clock_mhz"],
        "peak_tinstr_per_s_at_clock": vpu["peak_tinstr_per_s"],
        "sass": vpu["sass"],
        "fidelity": min(flo["fidelity"].values()),
        "decompose": flo["decompose"],
        "scale_us_per_op": {f: [s["us_per_op"] for s in sc["us_per_op"]]
                            for f, sc in flo["scale"].items()},
        "census_model_plan_ops_ms": [flo["census"]["plan_ops_fast_sel_ms"], flo["census"]["plan_ops_ms"]],
    })
    # every kernel a route reaches was launched on its path (the unit stage,
    # which none reaches, on its own: phase_sweeps_unit checks it)
    check(all(k["launches"] > 0 for k in kernels if k["name"] != "unit_stage"),
          f"a kernel was not launched on its path: {[(k['name'], k['launches']) for k in kernels]}")
    log(f"paths: {json.dumps(paths, default=float)}")
    log(f"sharded: {json.dumps(sharded, default=float)}")
    log(f"native: {json.dumps(nat, default=float)}")
    log(f"fixtures: {json.dumps(fixtures, default=float)}")
    jax_side = sorted(m for m in sys.modules if m.split(".")[0] in JAX_SIDE)
    check(not jax_side, f"the run imported {jax_side}")
    log(f"run: {time.perf_counter() - START:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
