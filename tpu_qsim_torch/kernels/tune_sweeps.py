"""Time the sweep kernels across launch geometries on the card.

    python -m tpu_qsim_torch.kernels.tune_sweeps [--qubits 26 ...] [--gates 100]
        [--candidate THREADS,IN_FLIGHT ...] [--core K,LO]

For each n and each (threads per CTA, parts or steps in flight) candidate
(a thread holds 16 amplitudes of a tile, so 256 / 512 / 1024 threads make
tiles of 2^12 / 2^13 / 2^14 slots; IN_FLIGHT 0: as many units as fit in
``sweeps.L2_BUDGET``, at least ``sweeps.MIN_IN_FLIGHT``; every launch takes
the most CTAs the card keeps resident): plan ``random_circuit(n, gates, seed=42)`` into sweeps and their
stages, check one run against the plain torch version, then
print the median of 5 CUDA-event timings of a run and of each sweep after a
warm-up. The candidate list runs forward and then backward, so a drift of
the card's clocks shows as a difference between the two passes. With
``--core K,LO`` the same is done for ``random_circuit(n, 40, seed=42)``, a
random K-qubit dense gate on qubits LO..LO+K-1 and ``random_circuit(n, 40,
seed=43)`` (``--core 8,10`` at 26 qubits: the sweeps main path), whose
wide core takes a unit stage. Needs a CUDA card.
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
from .sweeps import SweepGeometry, SweepProgram, resident_ctas

CANDIDATES = [
    (256, 1), (256, 2), (256, 0), (512, 1), (512, 2),
    (512, 4), (512, 0), (1024, 1), (1024, 2), (1024, 0),
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
    ap_.add_argument("--qubits", type=int, action="append", default=None)
    ap_.add_argument("--gates", type=int, default=100)
    ap_.add_argument("--candidate", action="append", default=None,
                     metavar="THREADS,IN_FLIGHT",
                     help="time only these geometries (repeatable)")
    ap_.add_argument("--core", default=None, metavar="K,LO",
                     help="also time a circuit with a K-qubit core on LO..LO+K-1")
    args = ap_.parse_args()
    candidates = CANDIDATES if args.candidate is None else [
        tuple(int(v) for v in text.split(",")) for text in args.candidate
    ]
    if not torch.cuda.is_available():
        raise SystemExit("tune_sweeps needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    for threads in sorted({t for t, _ in candidates}):
        print(json.dumps({"threads": threads,
                          "resident_ctas": resident_ctas(torch.device("cuda"), threads, False)}))
    circuits = [("random", None)]
    if args.core:
        circuits.append(("core", tuple(int(v) for v in args.core.split(","))))
    for n, (label, core) in [(n, c) for n in args.qubits or [26] for c in circuits]:
        if core is None:
            c = random_circuit(n, args.gates, seed=42)
        else:
            from .time_run import wide_circuit

            c = wide_circuit(n, *core)
        try:
            progs = {
                cand: SweepProgram(c, geometry=SweepGeometry(cand[0], cand[1] or None))
                for cand in candidates
            }
        except ValueError as e:     # e.g. the core straddles the mid and top bits
            print(json.dumps({"circuit": label, "qubits": n, "refused": str(e)}), flush=True)
            continue
        x0 = ap.initial_state(n, np.float32, device="cuda")
        plain = progs[candidates[0]].run_plain(x0.clone())
        rows = []
        for pass_ in (candidates, candidates[::-1]):
            for cand in pass_:
                prog = progs[cand]
                state = prog.run(x0.clone())
                err = float((state - plain).abs().max())
                ms = _median_ms(lambda: prog.run(state))
                per = [_median_ms(lambda: prog.launch(state, i), 3)
                       for i in range(prog.num_sweeps)]
                row = {"circuit": label, "qubits": n, "threads": cand[0],
                       "in_flight": cand[1], "ms": ms,
                       "per_sweep_ms": per, "kinds": prog.sweep_kinds,
                       "ops": [len(g) for g in prog.sweep_gates],
                       "stages": [[len(st.gates) for st in sw] for sw in prog.stages],
                       "max_abs_err": err}
                rows.append(row)
                print(json.dumps(row), flush=True)
                del state
        best = min(rows, key=lambda r: r["ms"])
        print(json.dumps({"card": card, "circuit": label, "qubits": n,
                          "gates": args.gates, "best": best}), flush=True)
        del x0, plain


if __name__ == "__main__":
    main()
