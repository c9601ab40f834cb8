#!/usr/bin/env python3
"""Drive tpu_qsim_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Needs one NVIDIA H100 (sm_90a) and ``nvcc``; imports nothing of JAX. Phases:

1. build ``grid_sweep.cu`` with nvcc (under 60 s);
2. 20 qubits: ``random_circuit(20, 100, seed=42)`` through the simulator's
   grid-sweep kernel against the complex128 host oracle (max |d amp| <= 1e-6);
3. 28 qubits, the main path: ``StateVectorSimulator(28).run`` then
   ``get_state``, ``probabilities``, ``sample`` and ``histogram``, with the
   launch counts zeroed just before and read just after; then the kernel's
   state against its plain torch version on the card (max |d amp| <= 1e-7,
   1 - fidelity <= 1e-5);
4. 28-qubit closed forms through the kernel: GHZ probabilities and histogram,
   QFT|0> amplitudes;
5. timing of the 28-qubit run with CUDA events (median of 5 after a warm-up)
   beside the plain version and the device-memory bound.

Every check raises on failure. The last two lines are the kernels JSON and
the device JSON; the exit code is 0 only if every phase passed.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch import apply as ap
from tpu_qsim_torch.kernels import LAUNCHES, _build, reset_launches
from tpu_qsim_torch.kernels.gridsweeps import grid_sweep

N_MAIN = 28
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12        # non-tensor-core float32 peak, same source


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
    t0 = time.perf_counter()
    _build.grid_sweep_library()
    wall = time.perf_counter() - t0
    built = _build.build_log.get("grid_sweep")
    if built is not None:
        for line in built[1].splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas: {line.strip()[:200]}")
    log(f"build: grid_sweep.cu {'built' if built else 'reused'} in {wall:.2f} s")
    check(wall < 60.0, f"build took {wall:.1f} s (limit 60 s)")
    return {"build_s": wall}


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


def phase_28q_main() -> dict:
    """The main path, counted; then the kernel against its plain version."""
    c = tq.random_circuit(N_MAIN, 100, seed=42)
    t0 = time.perf_counter()
    reset_launches()
    sim = tq.StateVectorSimulator(N_MAIN, seed=42)
    sim.run(c)
    psi = sim.get_state()
    probs = sim.probabilities()
    total = float(probs.sum(dtype=torch.float64))
    samples = sim.sample(1000)
    hist = sim.histogram(1000)
    torch.cuda.synchronize()
    launches = LAUNCHES["grid_sweep"]
    wall = time.perf_counter() - t0
    engine, prog = sim.compiled_run(c)
    check(sim.engine == "grid_sweep" and engine == "grid_sweep", f"28q ran on {sim.engine}")
    check(launches == prog.num_sweeps, f"{launches} launches for {prog.num_sweeps} sweeps")
    check(psi.shape == (1 << N_MAIN,) and bool(np.isfinite(psi).all()), "state not finite")
    check(abs(total - 1.0) < 1e-4, f"total probability {total}")
    check(tuple(samples.shape) == (1000,) and int(samples.min()) >= 0
          and int(samples.max()) < (1 << N_MAIN), "samples out of range")
    check(sum(hist.values()) == 1000, "histogram does not hold 1000 shots")
    check(bool((probs[samples] > 0).all()), "a sample hit a zero-probability state")
    del psi, probs
    log(f"phase 28q_main: wall_s={wall:.3f} sweeps={prog.num_sweeps} launches={launches} "
        f"gates_per_sweep={[len(g) for g in prog.sweep_gates]}")

    t0 = time.perf_counter()
    plain = prog.run_plain(ap.initial_state(N_MAIN, np.float32, device="cuda"))
    err, fid = compare(sim.state_planes, plain)
    del plain
    wall = time.perf_counter() - t0
    log(f"phase 28q_vs_plain: wall_s={wall:.3f} max_abs_err={err:.3e} (tol 1e-7) "
        f"fidelity={fid:.9f} (tol 1 - 1e-5)")
    check(err <= 1e-7, f"28q kernel vs plain max |d amp| {err} > 1e-7")
    check(1.0 - fid <= 1e-5, f"28q 1 - fidelity {1.0 - fid} > 1e-5")
    return {"sim": sim, "prog": prog, "launches": launches, "max_abs_err": err,
            "fidelity": fid}


def phase_28q_closed_forms() -> dict:
    n = N_MAIN
    last = (1 << n) - 1
    t0 = time.perf_counter()
    before = LAUNCHES["grid_sweep"]
    sim = tq.StateVectorSimulator(n, seed=7)
    sim.run(tq.ghz_circuit(n))
    check(sim.engine == "grid_sweep", f"GHZ ran on {sim.engine}")
    p = sim.probabilities()
    p0, pl = float(p[0]), float(p[last])
    rest = float(p.sum(dtype=torch.float64)) - p0 - pl
    a0, al = complex(*sim.state_planes[:, 0].tolist()), complex(*sim.state_planes[:, last].tolist())
    ghz_err = max(abs(a0 - 2 ** -0.5), abs(al - 2 ** -0.5),
                  float(torch.sqrt(p[1:last].max())))
    ghz_fid = abs((a0 + al) * 2 ** -0.5) ** 2
    hist = sim.histogram(10000)
    del p
    log(f"phase 28q_ghz: wall_s={time.perf_counter() - t0:.3f} p0={p0:.7f} plast={pl:.7f} "
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
    check(sim.engine == "grid_sweep", f"QFT ran on {sim.engine}")
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
    log(f"phase 28q_qft: wall_s={wall:.3f} max_abs_err={qft_err:.3e} max_mag_err={mag_err:.3e} "
        f"(tol 1e-6) fidelity={qft_fid:.9f} launches={LAUNCHES['grid_sweep'] - before}")
    check(mag_err <= 1e-6, f"QFT |amp| off 2^-14 by {mag_err}")
    return {"ghz_max_abs_err": ghz_err, "qft_max_mag_err": mag_err}


def time_cuda(fn, reps: int) -> list[float]:
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def phase_timing(sim, prog) -> dict:
    state = sim.state_planes
    time_cuda(lambda: prog.run(state), 1)                      # warm-up
    ms = statistics.median(time_cuda(lambda: prog.run(state), 5))
    x0 = ap.initial_state(N_MAIN, np.float32, device="cuda")
    time_cuda(lambda: prog.run_plain(x0), 1)
    plain_ms = statistics.median(time_cuda(lambda: prog.run_plain(x0), 3))
    del x0
    # per-sweep split of one run
    per = []
    threads = prog.params.threads
    for (ints, coef), lay in zip(prog._tables_on(state.device), prog.layouts):
        per.append(time_cuda(lambda: grid_sweep(state, ints, coef, lay, threads), 3)[-1])
    bytes_ms = prog.bytes_moved() / HBM_BYTES_PER_S * 1e3
    flops_ms = prog.flops() / FP32_FLOP_PER_S * 1e3
    bound_ms = max(bytes_ms, flops_ms)
    log(f"phase timing: n={N_MAIN} sweeps={prog.num_sweeps} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.4f} bytes_ms={bytes_ms:.4f} flops_ms={flops_ms:.4f} "
        f"per_sweep_ms={[round(t, 4) for t in per]} geometry={prog.params}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    phase_build()
    phase_20q_oracle()
    main_res = phase_28q_main()
    closed = phase_28q_closed_forms()
    timing = phase_timing(main_res["sim"], main_res["prog"])
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
        "fidelity": main_res["fidelity"],
        "ghz_max_abs_err": closed["ghz_max_abs_err"],
        "qft_max_mag_err": closed["qft_max_mag_err"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
