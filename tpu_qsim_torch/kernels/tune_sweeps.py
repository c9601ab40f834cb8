"""Time the sweep kernels across launch geometries on the card.

    python -m tpu_qsim_torch.kernels.tune_sweeps [--qubits 26 ...] [--gates 100]
        [--candidate THREADS,IN_FLIGHT ...] [--core K,LO]
        [--launches {one,split}] [--instances]

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
wide core takes a unit stage; ``--launches one`` plans each sweep as one
launch (its unit stages among its tile stages, on the wide instance), the
route's ``split`` (the default) launches each unit stage alone. With
``--instances`` (and ``--core``), for each sweep with a unit stage: the
sweep as one launch and as the route splits it, each of the split
launches, and its tile stages alone (one table) through the instance for
narrow cores and, the same table forced, through the wide one. Needs a
CUDA card.
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
from .fused_circuit import MAX_DENSE_QUBITS
from .sweeps import SweepGeometry, SweepProgram, resident_ctas, sweep_table

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


def instances(c, card: str, geometry: SweepGeometry = SweepGeometry()) -> list[dict]:
    """``--instances``: each sweep of ``c`` that holds a unit stage, as one
    launch (its cores through the tiled op), as the route splits it, each
    split launch, and its tile stages alone (one table) through the narrow
    and the wide instance."""
    n = c.num_qubits
    one = SweepProgram(c, geometry=geometry, _one_launch=True)
    split = SweepProgram(c, geometry=geometry)
    x = ap.initial_state(n, np.float32, device="cuda")
    rows = []
    for i, (stages, lay, bits) in enumerate(zip(one.stages, one.layouts, one.tile_bits)):
        if all(st.kind == "tile" for st in stages):
            continue
        tiles = sweep_table([st for st in stages if st.kind == "tile"], lay, bits)
        t = (torch.from_numpy(tiles.ints).cuda(), torch.from_numpy(tiles.coef).cuda())
        row = {"card": card, "qubits": n, "sweep": i, "kind": one.sweep_kinds[i],
               "stages": [[st.kind, len(st.gates)] for st in stages],
               "one_launch_ms": _median_ms(lambda: one.launch(x, i)),
               "split_ms": _median_ms(lambda: split.launch(x, i)),
               "split_launch_ms": [_median_ms(lambda j=j: split.launch_one(x, i, j))
                                   for j in range(len(split.launches[i]))],
               "split_routes": [ln.route for ln in split.launches[i]],
               "tile_stages_narrow_ms": _median_ms(
                   lambda: one.launch_table(x, i, t, tiles.max_core, "tile")),
               "tile_stages_wide_ms": _median_ms(
                   lambda: one.launch_table(x, i, t, MAX_DENSE_QUBITS, "tile"))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> None:
    ap_ = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap_.add_argument("--qubits", type=int, action="append", default=None)
    ap_.add_argument("--gates", type=int, default=100)
    ap_.add_argument("--candidate", action="append", default=None,
                     metavar="THREADS,IN_FLIGHT",
                     help="time only these geometries (repeatable)")
    ap_.add_argument("--core", default=None, metavar="K,LO",
                     help="also time a circuit with a K-qubit core on LO..LO+K-1")
    ap_.add_argument("--launches", choices=("one", "split"), default="split",
                     help="one launch a sweep, or its unit stages launched alone")
    ap_.add_argument("--instances", action="store_true",
                     help="time the --core circuit's unit-stage sweeps by launch and instance")
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
                cand: SweepProgram(c, geometry=SweepGeometry(cand[0], cand[1] or None),
                                   _one_launch=args.launches == "one")
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
                       "in_flight": cand[1], "launches": args.launches, "ms": ms,
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
        if args.instances and core is not None:
            instances(c, card)


if __name__ == "__main__":
    main()
