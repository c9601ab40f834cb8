"""The route by width on the card: where a dense core stops riding a block
kernel's tiled op and takes the dense pass, and what the grid sweep's wide
instance costs by itself.

    python -m tpu_qsim_torch.kernels.tune_route [--instances N] [--crossover] [--passes N ...]
        [--units N ...] [--several N ...]
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
* ``--crossover``: a k-qubit dense gate between two random layers
  (``time_run.wide_circuit``) on each route, as one program holding the
  core (the "tiled" candidate: the route's program, planned whole by
  ``dispatch._plan_piece``; on the grid row that is the grid sweep's tiled
  op where the grid planner takes the core, else the row's fallback, the
  sweeps or the segments at 20-26q; above 26q the torch engine, which is
  printed as refused and timed once, at ``--torch-at`` qubits with k = 8 on
  the highest qubits) and as the route by width runs it (the "split": the
  pieces on the route's program and the gate as a dense pass,
  ``dispatch.plan_split`` cut at k and at the gate the grid planner
  refuses). Grid sweep at ``--grid-qubits`` (20, 22, 24, 26, 27, 28, 30)
  with the core on the lowest, the middle (from n/2 - k/2) or the highest
  qubits (``--placements``), whole circuit at ``--whole-qubits`` (12, 16,
  18), segments at ``--segment-qubits`` (19), each on the lowest qubits;
  cores ``--cores`` (5-9 on the grid, 10-11 on the others); ``--routes``
  picks some of the three. The two candidates are timed in turns, tiled /
  split / split / tiled, each turn a median of 7.

* ``--passes N``: the dense pass alone on an N-qubit state: a 6-qubit core
  on the middle qubits widened to 7 by an identity on the lowest free qubit
  (the route's choice, ``dense_pass.widened``), on the qubit below the core
  and on the one above it; 7-9-qubit cores (``--cores``) on the lowest, the middle and
  the highest qubits; and an 8-qubit core on the middle ones under a
  control on the highest; each on ``dense_pass.cu``'s stream and large
  instances in turns, against the plain version, beside ``torch.matmul``
  of the core (TF32 off; without and with the planes-to-complex64 copies),
  the plain version's time and the gate's 3xTF32 bound (of its core as cut:
  the widening adds no work).
* ``--units N``: a 6-9-qubit core alone on the middle qubits of an N-qubit
  state: the sweeps' program holding it in a unit stage against the dense
  pass of the gate, in turns (the sweeps' unit-stage width).
* ``--several N``: circuits holding several 5- or 6-qubit dense gates at N
  qubits (``several_circuit``: a layer of N // k of them on disjoint random
  qubits, as a quantum-volume layer, between two random layers; or four of
  them on random qubits, each after ten random layers), planned by the
  route (``dispatch.plan_kernels``) with the grid row cutting from 22q at
  7 qubits and at 5 (``GRID_CUTS``), timed in turns (7 / 5 / 5 / 7).

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
from .fused_circuit import TILE_CORE
from .gridsweeps import GridSweepProgram, grid_sweep

SEED = 42
GRID_QUBITS = (20, 22, 24, 26, 27, 28, 30)
WHOLE_QUBITS = (12, 16, 18)
SEGMENT_QUBITS = (19,)
GRID_CORES = (5, 6, 7, 8, 9)
BLOCK_CORES = (10, 11)
INSTANCE_CORES = (5, 6, 7, 8, 9)
PLACEMENTS = ("low", "middle", "high")
TORCH_AT = 28
REPS = 7
ROUTES = ("grid_sweep", "whole_circuit", "segmented")


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
    """A seeded random normalised state, made on ``device`` (at 30 qubits
    the host's normals took tens of seconds a case)."""
    gen = torch.Generator(device=device).manual_seed(n)
    psi = torch.randn((2, 1 << n), generator=gen, device=device)
    return psi / torch.linalg.vector_norm(psi)


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


def core_matmul(step, n: int, x: torch.Tensor):
    """``step``'s core as one ``torch.matmul`` on the complex64 view of the
    planes ``x``, where its targets are contiguous ascending qubits lo..lo+k-1
    and its controls (if any) the highest qubits: (the call, the call with
    the planes-to-complex64 copies there and back, or None under controls);
    (None, None) for other placements. ``core_operand``'s index bit j is the
    j-th lowest target, as the view's."""
    from .dense_pass import core_operand

    targets = sorted(step.targets)
    k, lo, c = step.k, targets[0], len(step.controls)
    if targets != list(range(lo, lo + k)) or sorted(step.controls) != list(range(n - c, n)):
        return None, None
    u = torch.from_numpy(core_operand(step.core, step.targets)).to(x.device)
    um = torch.complex(u[0], u[1])
    shape = (1 << (n - c - lo - k), 1 << k, 1 << lo)
    on = (1 << n) - (1 << (n - c))                # the first slot whose controls are all 1
    z = torch.complex(x[0], x[1])[on:].view(shape)

    def with_copies():
        y = torch.matmul(um, torch.complex(x[0], x[1]).view(shape)).view(-1)
        x[0].copy_(y.real)
        x[1].copy_(y.imag)

    return (lambda: torch.matmul(um, z)), (None if c else with_copies)


def passes(n: int, device: torch.device, cores=(7, 8, 9), plain_reps: int = 3) -> list[dict]:
    """``--passes N``: the 6-qubit core widened three ways, then each of
    ``cores`` on each placement and one 8-qubit core on the middle qubits
    under a control on the highest, the pass alone on one random state: on
    the instance ``pass_instance`` picks and on the others of the 7-9-qubit
    cores' (``stream``, ``large``), in turns (picked / other / other /
    picked), each held against the plain version (and the instances' launch
    tallies checked); beside them ``torch.matmul`` of the core with TF32 off
    (placements of contiguous targets), without and with the
    planes-to-complex64 copies, the plain version once, and the gate's
    3xTF32 bound (``plain_reps`` timings of the plain version). On the CPU
    only the plain version runs."""
    from . import PASS_INSTANCES
    from .dense_pass import DensePass, dense_pass, pass_core, pass_instance
    from .fused_circuit import as_pgates
    from .time_run import dense_gate

    x = _state(n, device)
    cases = []
    lo = placement(n, 6, "middle")
    (g,) = as_pgates(Circuit(n).add(dense_gate(6), *range(lo, lo + 6)).gates)
    ctrls, core, qs = pass_core(g, 0)
    for name, extra in (("lowest_free", 0), ("below", lo - 1), ("above", lo + 6)):
        wide = (ctrls, np.kron(np.eye(2), core), (extra, *qs))
        cases.append((f"{n}q_pass_dense6_on_{lo}_widened_{name}", DensePass(g, n, wide)))
    for k in cores:
        for where in PLACEMENTS:
            lo = placement(n, k, where)
            (g,) = as_pgates(Circuit(n).add(dense_gate(k), *range(lo, lo + k)).gates)
            cases.append((f"{n}q_pass_dense{k}_on_{lo}", DensePass(g, n, pass_core(g, 0))))
    lo = placement(n, 8, "middle")
    c = Circuit(n).add(dense_gate(8), *range(lo, lo + 8))
    (g,) = as_pgates(c.gates)
    cg = pass_core(g, 0)
    cases.append((f"{n}q_pass_dense8_on_{lo}_control_{n - 1}",
                  DensePass(g, n, ((n - 1,), cg[1], cg[2]))))
    rows = []
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, step in cases:
            flops = 3 * step.flops()       # three TF32 products per real one, of the core as cut
            bound_ms = max(step.bytes_moved() / 3.35e12, flops / 495e12) * 1e3
            row = {"row": name, "targets": list(step.targets), "controls": list(step.controls),
                   "k": step.k, "core_k": step.core_k, "bound_ms": bound_ms}
            plain = step.run_plain(x)
            row["plain"] = _median(_times_ms(lambda: step.run_plain(x), device, reps=plain_reps))
            if device.type == "cuda":
                picked = pass_instance(step.k, n - step.k - len(step.controls))
                others = [i for i in ("stream", "large") if i != picked]
                u = step.u_on(x.device)
                for inst in (picked, *others):
                    reset_launches()
                    got = dense_pass(x, u, step.tmask, step.cmask, inst)
                    if dict(PASS_INSTANCES) != {inst: 1}:
                        raise RuntimeError(f"{name}: instance launches {dict(PASS_INSTANCES)}")
                    row[inst] = {"max_abs_err": float(torch.max(torch.abs(got - plain))),
                                 "turns": []}
                    if inst == picked:
                        picked_out = torch.complex(got[0], got[1])
                    del got
                for inst in (picked, *others, *others, picked):
                    row[inst]["turns"].append(_median(_times_ms(
                        lambda: dense_pass(x, u, step.tmask, step.cmask, inst), device)))
                for inst in (picked, *others):
                    times = [t for turn_ in row[inst].pop("turns") for t in turn_["all_ms"]]
                    row[inst]["ms"] = statistics.median(times)
                    row[inst]["share"] = bound_ms / row[inst]["ms"]
                row["picked"] = picked
                mm, mm_copy = core_matmul(step, n, x)
                if mm is not None:
                    y = mm().reshape(-1)
                    on = (1 << n) - y.numel()
                    want = torch.complex(plain[0], plain[1])[on:]
                    row["matmul_max_abs_err"] = float(torch.max(torch.abs(y - want)))
                    row["picked_vs_matmul_max_abs_err"] = float(torch.max(torch.abs(
                        y - picked_out[on:])))
                    del y, want
                    row["matmul_ms"] = _median(_times_ms(mm, device))["ms"]
                del picked_out
                if mm_copy is not None:
                    xs = x.clone()
                    _, mm_copy = core_matmul(step, n, xs)
                    row["matmul_with_copies_ms"] = _median(_times_ms(mm_copy, device))["ms"]
                    del xs
            del plain
            rows.append(row)
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return rows


def units(n: int, device: torch.device, cores=(6, 7, 8, 9)) -> list[dict]:
    """``--units N``: a k-qubit core alone on the middle qubits of an
    N-qubit state, for each of ``cores``: the sweeps' program holding it
    (``SweepProgram``: its unit stage on the wide instance below
    ``MIN_SWEEP_PASS_CORE``) against the dense pass of the same gate, timed
    in turns (sweeps / pass / pass / sweeps), their outputs compared."""
    from .dense_pass import DensePass, pass_core
    from .fused_circuit import as_pgates
    from .sweeps import SweepProgram
    from .time_run import dense_gate

    x = _state(n, device)
    rows = []
    for k in cores:
        lo = placement(n, k, "middle")
        c = Circuit(n).add(dense_gate(k), *range(lo, lo + k))
        (g,) = as_pgates(c.gates)
        step = DensePass(g, n, pass_core(g, 0))
        row = {"row": f"{n}q_unit_dense{k}_on_{lo}", "n": n, "k": k, "lo": lo}
        try:
            prog = SweepProgram(c)
        except ValueError as e:
            row["sweeps"] = {"refused": str(e)[:200]}
            rows.append(row)
            continue
        row["launches"] = [ln.route for launch in prog.launches for ln in launch]
        cands = {"sweeps": prog.run, "pass": step.run}
        row["max_abs_diff"] = float(torch.max(torch.abs(prog.run(x.clone()) - step.run(x))))
        for name in cands:
            row[name] = {"turns": []}
        for name in ("sweeps", "pass", "pass", "sweeps"):
            row[name]["turns"].append(_median(_times_ms(lambda: cands[name](x.clone()), device)))
        for name in cands:
            times = [t for turn_ in row[name].pop("turns") for t in turn_["all_ms"]]
            row[name]["ms"] = statistics.median(times)
        row["pass_over_sweeps"] = row["pass"]["ms"] / row["sweeps"]["ms"]
        rows.append(row)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


SEVERAL_SHAPES = ("layer", "spread")


def several_circuit(n: int, k: int, shape: str) -> Circuit:
    """A circuit holding several k-qubit dense gates (``time_run.dense_gate``)
    on seeded random qubits: for ``shape`` "layer", n // k of them on
    disjoint qubits between ``random_circuit(n, 40)`` twice; for "spread",
    four, each after ten random layers, and ten more at the end."""
    from .time_run import dense_gate

    rng = np.random.default_rng(1000 * n + k)
    if shape == "layer":
        c = random_circuit(n, 40, seed=SEED)
        perm = rng.permutation(n)
        for i in range(n // k):
            c.add(dense_gate(k), *(int(q) for q in perm[i * k:(i + 1) * k]))
        for g in random_circuit(n, 40, seed=SEED + 1).gates:
            c.append(g)
        return c
    c = Circuit(n)
    for i in range(5):
        for g in random_circuit(n, 10, seed=SEED + i).gates:
            c.append(g)
        if i < 4:
            c.add(dense_gate(k), *(int(q) for q in rng.choice(n, k, replace=False)))
    return c


def several(n: int, device: torch.device, cores=(5, 6), widths=(7, 5)) -> list[dict]:
    """``--several N``: each of :data:`SEVERAL_SHAPES` with k-qubit gates for
    k in ``cores``, planned by the route with the grid row's cut from 22q at
    each of ``widths`` (``dispatch.GRID_CUTS`` set for the planning), timed
    in turns (first / second / second / first), their outputs compared."""
    from . import dispatch

    x = _state(n, device)
    rows = []
    saved = dispatch.GRID_CUTS
    for k in cores:
        for shape in SEVERAL_SHAPES:
            c = several_circuit(n, k, shape)
            row = {"row": f"{n}q_several_dense{k}_{shape}", "n": n, "k": k, "shape": shape,
                   "gates": len(c.gates)}
            progs, outs = {}, {}
            for w in widths:
                dispatch.GRID_CUTS = tuple((lo, w if lo == 22 else cw, r) for lo, cw, r in saved)
                try:
                    engine, prog = dispatch.plan_kernels(c, "grid_sweep")
                finally:
                    dispatch.GRID_CUTS = saved
                name = f"cut{w}"
                if prog is None:
                    row[name] = {"refused": f"{engine} runs the whole circuit"}
                    continue
                engines = getattr(prog, "engines", [engine])
                reset_launches()
                outs[name] = prog(x.clone())
                progs[name] = prog
                row[name] = {"passes": engines.count("dense_pass"), "pieces": len(engines)
                             - engines.count("dense_pass"), "launches": dict(LAUNCHES),
                             "turns": []}
            names = list(progs)
            for name in names[:1] + names[1:] * 2 + names[:1]:
                state = {"x": x.clone()}

                def step():
                    state["x"] = progs[name](state["x"])

                row[name]["turns"].append(_median(_times_ms(step, device)))
                del state
            for name in names:
                times = [t for turn_ in row[name].pop("turns") for t in turn_["all_ms"]]
                row[name]["ms"] = statistics.median(times)
            if len(names) == 2:
                a, b = names
                row["max_abs_diff"] = float(torch.max(torch.abs(outs[a] - outs[b])))
                row[f"{b}_over_{a}"] = row[b]["ms"] / row[a]["ms"]
            rows.append(row)
            del outs
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def placement(n: int, k: int, where: str) -> int:
    """The lowest qubit of a k-qubit core on the ``where`` qubits of n."""
    return {"low": 0, "middle": n // 2 - k // 2, "high": n - k}[where]


def split_program(circuit: Circuit, route: str, k: int):
    """``circuit`` as the route by width runs it when it cuts at k qubits:
    the pieces around its k-qubit gate on ``route``'s program, the gate as a
    dense pass (:func:`dispatch.plan_split` cut at k and at every gate the
    grid planner refuses)."""
    from .dispatch import plan_split

    _, prog = plan_split(circuit, route, k, refused=True)
    if "torch" in getattr(prog, "engines", ["torch"]):
        raise ValueError(f"{route} gives a {circuit.num_qubits}-qubit piece to the torch engine")
    return prog


def _torch_engine(circuit: Circuit):
    """The torch engine's run of ``circuit``, as ``StateVectorSimulator``
    builds it where the table gives no kernel."""
    from ..config import DEFAULT_CONFIG
    from ..fusion import fuse_circuit
    from ..statevector import build_torch_run_fn

    return build_torch_run_fn(fuse_circuit(circuit, DEFAULT_CONFIG.max_fused_qubits), np.float32)


def crossover_case(route: str, n: int, k: int, device: torch.device, where: str = "low",
                   torch_engine: bool = False) -> dict:
    """One route at n qubits with a k-qubit core on the ``where`` qubits:
    the route's program holding the core (or its refusal) against the
    route by width's split, timed in turns (tiled / split / split / tiled),
    their outputs compared; with ``torch_engine`` the torch engine's run
    beside them."""
    from .dispatch import _plan_piece
    from .time_run import wide_circuit

    lo = placement(n, k, where)
    c = wide_circuit(n, k, lo)
    x = _state(n, device)
    row = {"row": f"{route}_{n}q_dense{k}_on_{lo}", "route": route, "n": n, "k": k,
           "placement": where, "lo": lo}
    timer = _graph_times_ms if n < 20 and device.type == "cuda" else _times_ms
    progs, outs = {}, {}
    for name in ("tiled", "split", "torch"):
        try:
            if name == "tiled":
                engine, prog = _plan_piece(c, route)
                if prog is None:
                    raise ValueError(f"{route} gives the circuit to the torch engine")
                engines = [engine]
            elif name == "split":
                prog = split_program(c, route, k)
                engines = prog.engines
            elif torch_engine:
                prog, engines = _torch_engine(c), ["torch"]
            else:
                continue
        except ValueError as e:
            row[name] = {"refused": str(e)[:200]}
            continue
        reset_launches()
        outs[name] = prog(x.clone())
        progs[name] = prog
        row[name] = {"engines": engines, "launches": dict(LAUNCHES), "turns": []}
    state = {}

    def turn(name: str) -> None:
        state[name] = x.clone()

        def step():
            state[name] = progs[name](state[name])

        row[name]["turns"].append(_median(timer(step, device)))
        del state[name]

    order = [name for name in ("tiled", "split", "split", "tiled") if name in progs]
    for name in order + (["torch"] if "torch" in progs else []):
        turn(name)
    for name in progs:
        times = [t for turn_ in row[name]["turns"] for t in turn_["all_ms"]]
        row[name]["ms"] = statistics.median(times)
    if "tiled" in outs and "split" in outs:
        row["max_abs_diff"] = float(torch.max(torch.abs(outs["tiled"] - outs["split"])))
        row["split_over_tiled"] = row["split"]["ms"] / row["tiled"]["ms"]
    if "torch" in outs and "split" in outs:
        row["max_abs_diff_vs_torch"] = float(torch.max(torch.abs(outs["torch"] - outs["split"])))
        row["split_over_torch"] = row["split"]["ms"] / row["torch"]["ms"]
    return row


def crossover(device: torch.device, grid=GRID_QUBITS, whole=WHOLE_QUBITS,
              segment=SEGMENT_QUBITS, cores=None, routes=ROUTES,
              placements=("low",), torch_at=None) -> list[dict]:
    """``--crossover``: every (route, n, k) case of ``routes``, the grid's at
    each of ``placements``; the torch engine beside the split once, at
    ``torch_at`` qubits with k = 8 on the highest qubits."""
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
                for where in placements if route == "grid_sweep" else ("low",):
                    once = route == "grid_sweep" and n == torch_at and k == 8 and where == "high"
                    rows.append(crossover_case(route, n, k, device, where, torch_engine=once))
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--instances", type=int, default=None, metavar="N")
    parser.add_argument("--crossover", action="store_true")
    parser.add_argument("--passes", type=int, action="append", default=None, metavar="N")
    parser.add_argument("--units", type=int, action="append", default=None, metavar="N")
    parser.add_argument("--several", type=int, action="append", default=None, metavar="N")
    parser.add_argument("--grid-qubits", type=int, action="append", default=None)
    parser.add_argument("--whole-qubits", type=int, action="append", default=None)
    parser.add_argument("--segment-qubits", type=int, action="append", default=None)
    parser.add_argument("--cores", type=int, action="append", default=None, metavar="K")
    parser.add_argument("--routes", action="append", choices=ROUTES, default=None,
                        help="--crossover on these routes only (repeatable; default all)")
    parser.add_argument("--placements", action="append", choices=PLACEMENTS, default=None,
                        help="--crossover's grid cores on these qubits (repeatable; default all)")
    parser.add_argument("--torch-at", type=int, default=TORCH_AT, metavar="N",
                        help="--crossover times the torch engine once at N qubits")
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
    for n in args.passes or ():
        for row in passes(n, dev, tuple(args.cores or (7, 8, 9))):
            print(json.dumps(row), flush=True)
    for n in args.units or ():
        for row in units(n, dev):
            print(json.dumps(row), flush=True)
    for n in args.several or ():
        for row in several(n, dev):
            print(json.dumps(row), flush=True)
    if args.crossover:
        for row in crossover(dev, args.grid_qubits or GRID_QUBITS,
                             args.whole_qubits or WHOLE_QUBITS,
                             args.segment_qubits or SEGMENT_QUBITS, args.cores,
                             tuple(args.routes or ROUTES), tuple(args.placements or PLACEMENTS),
                             args.torch_at):
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
