"""The route by width on the card: where a dense core stops riding a block
kernel's tiled op and takes the dense pass, and what the grid sweep's wide
instance costs by itself.

    python -m tpu_qsim_torch.kernels.tune_route [--instances N] [--crossover]
        [--grid-qubits N ...] [--whole-qubits N ...] [--segment-qubits N ...]
        [--cores K ...] [--device cpu]

Modes:

* ``--instances N``: the grid sweep's two instances (``csrc/grid_sweep.cu``:
  for cores of up to 4 qubits, and the wide one with the tiled op's code and
  scratch) on the same tables: one sweep (blk 8, 5 active bits) holding one
  1-qubit op, and the first sweep of the production plan of
  ``random_circuit(N, 100, seed=42)``, each launched on the instance its
  table picks and forced onto the wide one (``grid_sweep``'s ``max_core``);
  then one sweep holding one k-qubit op on qubits 0..k-1 for each of
  ``--cores`` (the wide instance), so that an op's own cost is its sweep
  less the 1-qubit sweep on the wide instance.
* ``--crossover``: a k-qubit dense gate on qubits 0..k-1 between two random
  layers (``time_run.wide_circuit``) on each route, as one program holding
  the core in its tiled op (``GridSweepProgram``, ``WholeCircuitProgram``,
  ``SegmentedProgram``; a refusal is printed) and as the route by width
  runs it: the pieces on the route's program and the gate as a dense pass
  (``split_program``: ``dispatch``'s split, at k), each against the other.
  Grid sweep at ``--grid-qubits`` (20, 24, 28), whole circuit at
  ``--whole-qubits`` (12, 16, 18), segments at ``--segment-qubits`` (19);
  cores ``--cores`` (8-11 on the grid, 10-11 on the others); ``--routes``
  picks some of the three.

Times are medians of 7 CUDA-event timings after a warm-up, device time from
CUDA-graph replays below 20 qubits. With ``--device cpu`` it runs the plain
versions at the sizes given and times them with the host clock (a check of
the control flow, no device number).
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
from . import LAUNCHES, reset_launches
from .fused_circuit import TILE_CORE, WholeCircuitProgram
from .gridsweeps import GridSweepProgram, grid_sweep
from .segmented import SegmentedProgram

SEED = 42
GRID_QUBITS = (20, 24, 28)
WHOLE_QUBITS = (12, 16, 18)
SEGMENT_QUBITS = (19,)
GRID_CORES = (8, 9, 10, 11)
BLOCK_CORES = (10, 11)
INSTANCE_CORES = (5, 6, 7, 8, 9)
REPS = 7
TILED = {"grid_sweep": GridSweepProgram, "whole_circuit": WholeCircuitProgram,
         "segmented": SegmentedProgram}


def _times_ms(fn, device: torch.device, reps: int = REPS) -> list[float]:
    """``reps`` timings of ``fn`` after a warm-up: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    out = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
    return out


def _graph_times_ms(fn, device: torch.device, reps: int = REPS, inner: int = 20) -> list[float]:
    """Device time of ``fn``'s launches from CUDA-graph replays (``inner``
    a timing); on the CPU, :func:`_times_ms`."""
    if device.type != "cuda":
        return _times_ms(fn, device, reps)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()

    def replays():
        for _ in range(inner):
            graph.replay()

    return [t / inner for t in _times_ms(replays, device, reps)]


def _median(times: list[float]) -> dict:
    return {"ms": statistics.median(times), "all_ms": times}


def _state(n: int, device: torch.device) -> torch.Tensor:
    rng = np.random.default_rng(n)
    psi = rng.standard_normal((2, 1 << n)).astype(np.float32)
    return torch.from_numpy(psi / np.linalg.norm(psi)).to(device)


def instances(n: int, device: torch.device, cores=INSTANCE_CORES) -> list[dict]:
    """``--instances``: each table on the instance it picks and on the wide
    one; then one k-qubit op's sweep for each of ``cores``."""
    from .floor import core_program

    x = _state(n, device)
    progs = {"one_1q_op": core_program(n, 1),
             "random_first_sweep": GridSweepProgram(random_circuit(n, 100, seed=SEED))}
    rows = []
    for name, prog in progs.items():
        (ints, coef) = prog._tables_on(device)[0]
        lay, table = prog.layouts[0], prog.tables[0]
        row = {"row": f"{n}q_{name}", "kbits": lay.kbits, "ops": int(table.ints[0]),
               "max_core": table.max_core}
        # a max_core past NARROW_CORE picks the wide instance; TILE_CORE
        # fits every geometry's threads
        for inst, max_core in (("own", table.max_core), ("wide", TILE_CORE)):
            if device.type == "cuda":
                fn = (lambda m=max_core: grid_sweep(x, ints, coef, lay, m))
            else:       # the plain version has one instance
                fn = (lambda: prog.run_plain(x))
            row[f"{inst}_instance"] = _median(_times_ms(fn, device))
        rows.append(row)
    for k in cores:
        prog = core_program(n, k)
        rows.append({"row": f"{n}q_one_dense{k}_op_sweep", "max_core": prog.tables[0].max_core,
                     **_median(_times_ms(lambda: prog.run(x), device))})
    return rows


def split_program(circuit: Circuit, route: str, k: int):
    """``circuit`` as the route by width runs a core of 10+ qubits, at any
    width k: its pieces before and after its one k-qubit gate on ``route``'s
    program, the gate as a dense pass (:class:`dispatch.SplitProgram`)."""
    from .dense_pass import DensePass, pass_core
    from .dispatch import SplitProgram, _plan_piece
    from .fused_circuit import as_pgates

    n = circuit.num_qubits
    (at,) = [i for i, g in enumerate(circuit.gates) if len(g.qubits) == k]
    steps, engines = [], []
    for gates in (circuit.gates[:at], None, circuit.gates[at + 1:]):
        if gates is None:
            (pg,) = as_pgates([circuit.gates[at]])
            steps.append(DensePass(pg, n, pass_core(pg, k - 1)))
            engines.append("dense_pass")
            continue
        piece = Circuit(n)
        for g in gates:
            piece.append(g)
        name, prog = _plan_piece(piece, route)
        if prog is None:
            raise ValueError(f"{route} gives a {n}-qubit piece to the torch engine")
        steps.append(prog)
        engines.append(name)
    return SplitProgram(steps, engines)


def crossover_case(route: str, n: int, k: int, device: torch.device) -> dict:
    """One route at n qubits with a k-qubit core: the tiled op's program
    (or its refusal) against the route by width's split, each timed, their
    outputs compared."""
    from .time_run import wide_circuit

    c = wide_circuit(n, k, 0)
    x = _state(n, device)
    row = {"row": f"{route}_{n}q_dense{k}", "route": route, "n": n, "k": k}
    timer = _graph_times_ms if n < 20 and device.type == "cuda" else _times_ms
    outs = {}
    for name in ("tiled", "split"):
        try:
            if name == "tiled":
                prog = TILED[route](c)
            else:
                prog = split_program(c, route, k)
        except ValueError as e:
            row[name] = {"refused": str(e)[:200]}
            continue
        reset_launches()
        outs[name] = prog.run(x.clone())
        launches = dict(LAUNCHES)
        state = x.clone()

        def step(prog=prog):
            nonlocal state
            state = prog.run(state)

        row[name] = {"engines": getattr(prog, "engines", [route]), "launches": launches,
                     **_median(timer(step, device))}
        del state
    if len(outs) == 2:
        row["max_abs_diff"] = float(torch.max(torch.abs(outs["tiled"] - outs["split"])))
    if "ms" in row.get("tiled", {}) and "ms" in row.get("split", {}):
        row["split_over_tiled"] = row["split"]["ms"] / row["tiled"]["ms"]
    return row


def crossover(device: torch.device, grid=GRID_QUBITS, whole=WHOLE_QUBITS,
              segment=SEGMENT_QUBITS, cores=None, routes=tuple(TILED)) -> list[dict]:
    """``--crossover``: every (route, n, k) case of ``routes``."""
    rows = []
    for route, sizes, widths in (("grid_sweep", grid, cores or GRID_CORES),
                                 ("whole_circuit", whole, cores or BLOCK_CORES),
                                 ("segmented", segment, cores or BLOCK_CORES)):
        if route not in routes:
            continue
        for n in sizes:
            for k in widths:
                if k > n:
                    continue
                rows.append(crossover_case(route, n, k, device))
                if device.type == "cuda":
                    torch.cuda.empty_cache()
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--instances", type=int, default=None, metavar="N")
    parser.add_argument("--crossover", action="store_true")
    parser.add_argument("--grid-qubits", type=int, action="append", default=None)
    parser.add_argument("--whole-qubits", type=int, action="append", default=None)
    parser.add_argument("--segment-qubits", type=int, action="append", default=None)
    parser.add_argument("--cores", type=int, action="append", default=None, metavar="K")
    parser.add_argument("--routes", action="append", choices=tuple(TILED), default=None,
                        help="--crossover on these routes only (repeatable; default all)")
    parser.add_argument("--device", default=None, help="default: the CUDA card")
    args = parser.parse_args()
    dev = ap.resolve_device(args.device)
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout.strip()
        print(f"card: {card}", flush=True)
    else:
        print("device cpu: plain versions, host clock (no device number)", flush=True)
    if args.instances:
        for row in instances(args.instances, dev, args.cores or INSTANCE_CORES):
            print(json.dumps(row), flush=True)
    if args.crossover:
        for row in crossover(dev, args.grid_qubits or GRID_QUBITS,
                             args.whole_qubits or WHOLE_QUBITS,
                             args.segment_qubits or SEGMENT_QUBITS, args.cores,
                             tuple(args.routes or TILED)):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
