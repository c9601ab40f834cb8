"""Time the whole-circuit and segment kernels across geometries on the card.

    python -m tpu_qsim_torch.kernels.tune_small [--gates 100] [--inner 20]

Whole-circuit kernel, for each n in 10..18: every cluster size 2^c the
kernel takes (n - 14 <= c <= 4) at 256, 512 and 1024 threads per CTA.
Segmented program at 19 qubits: every local_bits in 10..14 at 256, 512 and
1024 threads. Each candidate plans ``random_circuit(n, gates, seed=42)``,
checks one run against its plain torch version, then prints the median of 5
CUDA-event timings of ``inner`` back-to-back runs (after a warm-up), divided
by ``inner``, and the torch engine's time for the same circuit (the route
these sizes took before the kernels). Candidates run forward and then
backward, so a drift of the card's clocks shows as a difference between the
two passes. Needs a CUDA card.
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
from ..fusion import fuse_circuit
from ..statevector import build_torch_run_fn
from .fused_circuit import (
    MAX_BLOCK_BITS,
    MAX_CLUSTER_BITS,
    MAX_WHOLE_CIRCUIT_QUBITS,
    MIN_WHOLE_CIRCUIT_QUBITS,
    WholeCircuitProgram,
    placeable_clusters,
)
from .segmented import SegmentedProgram

THREADS = (256, 512, 1024)


def median_ms(fn, inner: int, reps: int = 5) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls of
    ``fn``, per call, after one warm-up call."""
    fn()
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
    return statistics.median(out)


def torch_engine_ms(circuit, inner: int) -> float:
    """The torch engine (fused groups, as the simulator builds it) on
    ``circuit``, per run."""
    n = circuit.num_qubits
    fn = build_torch_run_fn(fuse_circuit(circuit, 5), np.float32)
    x = ap.initial_state(n, np.float32, device="cuda")
    return median_ms(lambda: fn(x), inner)


def _candidates(n_seg: int):
    for n in range(MIN_WHOLE_CIRCUIT_QUBITS, MAX_WHOLE_CIRCUIT_QUBITS + 1):
        for c in range(max(0, n - MAX_BLOCK_BITS), MAX_CLUSTER_BITS + 1):
            for t in THREADS:
                yield ("whole_circuit", n, c, t)
    for lb in range(10, MAX_BLOCK_BITS + 1):
        for t in THREADS:
            yield ("segmented", n_seg, lb, t)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gates", type=int, default=100)
    parser.add_argument("--inner", type=int, default=20)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_small needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    n_seg = MAX_WHOLE_CIRCUIT_QUBITS + 1
    cands = list(_candidates(n_seg))
    circuits = {n: random_circuit(n, args.gates, seed=42)
                for n in range(MIN_WHOLE_CIRCUIT_QUBITS, n_seg + 1)}
    progs = {}
    for cand in cands:
        kind, n, g, t = cand
        if kind == "whole_circuit":
            progs[cand] = WholeCircuitProgram(circuits[n], cluster_bits=g, threads=t)
        else:
            progs[cand] = SegmentedProgram(circuits[n], local_bits=g, threads=t)
    engine_ms = {n: torch_engine_ms(c, args.inner) for n, c in circuits.items()}
    plain = {}
    rows = []
    for pass_ in (cands, cands[::-1]):
        for cand in pass_:
            kind, n, g, t = cand
            prog = progs[cand]
            x0 = ap.initial_state(n, np.float32, device="cuda")
            if n not in plain:
                plain[n] = prog.run_plain(x0.clone())
            try:
                state = prog.run(x0.clone())
            except RuntimeError as e:      # a geometry the card cannot place
                print(json.dumps({"kind": kind, "n": n, "geometry": g,
                                  "threads": t, "error": str(e)}), flush=True)
                continue
            err = float((state - plain[n]).abs().max())
            ms = median_ms(lambda: prog.run(state), args.inner)
            row = {"kind": kind, "n": n, "threads": t, "ms": ms,
                   "torch_engine_ms": engine_ms[n], "max_abs_err": err}
            if kind == "whole_circuit":
                row.update(cluster_bits=g,
                           clusters=placeable_clusters(state.device, n, g, t))
            else:
                row.update(local_bits=g, segments=prog.num_segments)
            rows.append(row)
            print(json.dumps(row), flush=True)
    best = {}
    for r in rows:
        key = (r["kind"], r["n"])
        if key not in best or r["ms"] < best[key]["ms"]:
            best[key] = r
    print(json.dumps({"card": card, "gates": args.gates,
                      "best": sorted(best.values(), key=lambda r: r["n"])}))


if __name__ == "__main__":
    main()
