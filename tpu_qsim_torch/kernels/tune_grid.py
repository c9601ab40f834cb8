"""Time the grid-sweep kernel across block geometries on the card.

    python -m tpu_qsim_torch.kernels.tune_grid [--qubits 28] [--gates 100]

For each (blk_bits, a_max, threads) candidate: plan ``random_circuit(n, g,
seed=42)``, check one run against the plain torch version, then print the
median of 5 CUDA-event timings after a warm-up. The candidate list runs
forward and then backward, so a drift of the card's clocks shows as a
difference between the two passes. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from .. import apply as ap
from ..circuit import random_circuit
from .gridsweeps import GridParams, GridSweepProgram

CANDIDATES = [
    (10, 4, 1024), (10, 4, 512), (9, 4, 512), (9, 4, 1024), (8, 4, 256),
    (8, 4, 512), (10, 3, 512), (9, 5, 1024), (8, 5, 512), (8, 6, 1024),
]


def _median_ms(fn, reps: int = 5) -> float:
    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def main() -> None:
    ap_ = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap_.add_argument("--qubits", type=int, default=28)
    ap_.add_argument("--gates", type=int, default=100)
    args = ap_.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_grid needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    n = args.qubits
    c = random_circuit(n, args.gates, seed=42)
    progs = {cand: GridSweepProgram(c, GridParams(*cand)) for cand in CANDIDATES}
    x0 = ap.initial_state(n, np.float32, device="cuda")
    plain = progs[CANDIDATES[0]].run_plain(x0.clone())
    rows = []
    for pass_ in (CANDIDATES, CANDIDATES[::-1]):
        for blk, a, threads in pass_:
            prog = progs[(blk, a, threads)]
            state = prog.run(x0.clone())
            err = float((state - plain).abs().max())
            ms = _median_ms(lambda: prog.run(state))
            row = {"blk_bits": blk, "a_max": a, "threads": threads,
                   "sweeps": prog.num_sweeps, "ms": ms, "max_abs_err": err}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del state
    best = min(rows, key=lambda r: r["ms"])
    print(json.dumps({"card": card, "qubits": n, "gates": args.gates,
                      "best": best}))


if __name__ == "__main__":
    main()
