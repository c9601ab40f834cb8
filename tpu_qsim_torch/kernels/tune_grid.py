"""Time the grid-sweep kernel across block geometries on the card.

    python -m tpu_qsim_torch.kernels.tune_grid [--qubits 28] [--gates 100]
        [--candidate BLK,A ...]

For each (blk_bits, a_max) candidate: plan ``random_circuit(n, g,
seed=42)``, check one run against the plain torch version, then print the
median of 5 CUDA-event timings after a warm-up, with the threads per CTA
(16 amplitudes each, gridsweeps.block_threads). The candidate list runs
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
from .gridsweeps import GridParams, GridSweepProgram, block_threads

# (blk_bits, a_max): blocks of 2^11-2^13 slots, 128-512 threads
CANDIDATES = [
    (8, 5), (9, 4), (10, 3), (7, 5), (8, 4), (9, 3), (7, 4), (6, 5),
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
    ap_.add_argument("--candidate", action="append", default=None,
                     metavar="BLK,A",
                     help="time only these geometries (repeatable)")
    args = ap_.parse_args()
    candidates = CANDIDATES if args.candidate is None else [
        tuple(int(v) for v in text.split(",")) for text in args.candidate
    ]
    if not torch.cuda.is_available():
        raise SystemExit("tune_grid needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    n = args.qubits
    c = random_circuit(n, args.gates, seed=42)
    progs = {cand: GridSweepProgram(c, GridParams(*cand)) for cand in candidates}
    x0 = ap.initial_state(n, np.float32, device="cuda")
    plain = progs[candidates[0]].run_plain(x0.clone())
    rows = []
    for pass_ in (candidates, candidates[::-1]):
        for blk, a in pass_:
            prog = progs[(blk, a)]
            state = prog.run(x0.clone())
            err = float((state - plain).abs().max())
            ms = _median_ms(lambda: prog.run(state))
            row = {"blk_bits": blk, "a_max": a,
                   "threads": block_threads(prog.layouts[0].kbits),
                   "sweeps": prog.num_sweeps, "ms": ms, "max_abs_err": err}
            rows.append(row)
            print(json.dumps(row), flush=True)
            del state
    best = min(rows, key=lambda r: r["ms"])
    print(json.dumps({"card": card, "qubits": n, "gates": args.gates,
                      "best": best}))


if __name__ == "__main__":
    main()
