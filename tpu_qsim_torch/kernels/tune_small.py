"""Time the whole-circuit and segment kernels across geometries on the card.

    python -m tpu_qsim_torch.kernels.tune_small [--gates 100] [--inner 20]
        [--qubits N ...] [--op-cost]

Whole-circuit route, for each n in 10..18: every tile size 2^T the register
program takes (9 <= T <= min(n, 14)), each with one CTA per tile, half and
a quarter as many (a CTA then takes tiles in turn). Segmented program at
19, 22 and 24 qubits (or any of 19..26 given with ``--qubits``): every
local_bits in 10..14 (a CTA of 2^(local_bits - 4) threads; a block a plan
widens for its widest gate is timed once). Each candidate plans
``random_circuit(n, gates, seed=42)``; above 19 qubits instead a circuit
the grid and the sweeps refuse, so one the segments really get there:
``random_circuit(n, 40, seed=42)``, a dense gate on the top 6 qubits,
``random_circuit(n, 40, seed=43)``. Each candidate checks one run
against its plain torch version, then prints its device time: the median
of 5 CUDA-event timings of ``inner`` replays of a CUDA graph of one run,
divided by ``inner`` (eager launches of a kernel this short time the
host), with the stages or segments, the torch engine's time for the same
circuit (the route these sizes took before the kernels) and the run's
eager time.
Candidates run forward and then backward, so a drift of the card's clocks
shows as a difference between the two passes. With ``--op-cost`` it times
instead the whole-circuit route at its geometry on ``random_circuit(n, g,
seed=42)`` for g = 25 .. 400 gates and fits device time against merged ops
(least squares): the slope is the cost of one op in its tile pass, the
intercept the launch and the state's passes. Needs a CUDA card.
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
    MAX_WHOLE_CIRCUIT_QUBITS,
    MIN_WHOLE_CIRCUIT_QUBITS,
    WholeCircuitProgram,
)
from .gridsweeps import MIN_GRID_BLOCK_BITS
from .segmented import SegmentedProgram
from .sweeps import MAX_TILE_BITS
from .time_run import wide_circuit

SEGMENT_QUBITS = (19, 22, 24)




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


def graph_ms(fn, inner: int, reps: int = 5) -> float:
    """Device time of one call of ``fn``: captured once into a CUDA graph
    (after a call outside it), then :func:`median_ms` of replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return median_ms(graph.replay, inner, reps)


def torch_engine_ms(circuit, inner: int) -> float:
    """The torch engine (fused groups, as the simulator builds it) on
    ``circuit``, per run."""
    n = circuit.num_qubits
    fn = build_torch_run_fn(fuse_circuit(circuit, 5), np.float32)
    x = ap.initial_state(n, np.float32, device="cuda")
    return median_ms(lambda: fn(x), inner)


def _candidates(qubits):
    for n in qubits:
        if n > MAX_WHOLE_CIRCUIT_QUBITS:
            for lb in range(10, MAX_BLOCK_BITS + 1):
                yield ("segmented", n, lb, None)
            continue
        for bits in range(MIN_GRID_BLOCK_BITS, min(n, MAX_TILE_BITS) + 1):
            for ctas in sorted({max(1, (1 << (n - bits)) >> j) for j in range(3)}):
                yield ("whole_circuit", n, bits, ctas)


def op_cost(qubits, inner: int) -> list[dict]:
    """Device time of the whole-circuit route against circuit length at each
    n, and the fitted cost per merged op."""
    rows = []
    for n in qubits:
        ops, ms = [], []
        for gates in (25, 50, 100, 200, 400):
            prog = WholeCircuitProgram(random_circuit(n, gates, seed=42))
            x = ap.initial_state(n, np.float32, device="cuda")
            ops.append(len(prog.gates))
            ms.append(graph_ms(lambda: prog.run(x), inner))
            print(json.dumps({"n": n, "gates": gates, "ops": ops[-1],
                              "stages": len(prog.stages), "ms": ms[-1]}), flush=True)
        slope, intercept = np.polyfit(ops, ms, 1)
        rows.append({"n": n, "ms_per_op": float(slope), "ms_at_0_ops": float(intercept)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--gates", type=int, default=100)
    parser.add_argument("--inner", type=int, default=20)
    parser.add_argument("--qubits", type=int, action="append", default=None,
                        help="only these sizes (10..26)")
    parser.add_argument("--op-cost", action="store_true",
                        help="time the whole-circuit route against circuit length instead")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_small needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.op_cost:
        op_cost(args.qubits or (10, 14, 18), args.inner)
        return
    qubits = args.qubits or (*range(MIN_WHOLE_CIRCUIT_QUBITS, MAX_WHOLE_CIRCUIT_QUBITS + 1),
                             *SEGMENT_QUBITS)
    # above 19 qubits the segments get only circuits the grid refuses
    circuits = {n: wide_circuit(n, 6, n - 6) if n > MAX_WHOLE_CIRCUIT_QUBITS + 1
                else random_circuit(n, args.gates, seed=42) for n in qubits}
    progs = {}
    for cand in _candidates(qubits):
        kind, n, g, t = cand
        if kind == "whole_circuit":
            progs[cand] = WholeCircuitProgram(circuits[n], tile_bits=g, ctas=t)
        else:
            prog = SegmentedProgram(circuits[n], local_bits=g)
            if prog.local_bits == g:         # a widened block is its own candidate
                progs[cand] = prog
    cands = list(progs)
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
            ms = graph_ms(lambda: prog.run(state), args.inner)
            row = {"kind": kind, "n": n, "ms": ms, "torch_engine_ms": engine_ms[n],
                   "max_abs_err": err}
            if kind == "whole_circuit":
                row.update(tile_bits=g, ctas=prog.ctas, threads=prog.threads,
                           stages=[len(st.gates) for st in prog.stages],
                           eager_ms=median_ms(lambda: prog.run(state), args.inner))
            else:
                row.update(threads=prog.threads, local_bits=g,
                           segments=[int(st.table.ints[0]) for st in prog.steps],
                           eager_ms=median_ms(lambda: prog.run(state), args.inner))
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
