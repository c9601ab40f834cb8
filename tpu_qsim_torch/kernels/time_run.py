"""Time ``StateVectorSimulator.run`` and single sweeps on the card.

    python -m tpu_qsim_torch.kernels.time_run [--only NAME ...]

Rows (``ROWS``):

* the main paths: ``random_circuit(n, 100, seed=42)`` at 28 qubits (grid
  sweep), 10-18 (whole circuit) and 19 (segments), and the 26-qubit sweeps
  main path (``random_circuit(26, 40, seed=42)``, a random 8-qubit unitary on
  qubits 10-17, ``random_circuit(26, 40, seed=43)``);
* circuits with one wide dense gate, built the same way (a 6-qubit core at
  22 and 26 qubits; an 8-qubit core on qubits 14-21 of 22 and a 6-qubit
  core on qubits 18-23 of 24, which of the engines planned whole only the
  segmented one takes, and which the route cuts since ``GRID_CUTS``);
* ``random_circuit(26, 100, seed=42)`` through the sweeps and the grid-sweep
  programs, each forced, and ``random_circuit(24, 100, seed=42)`` through
  the segmented program, forced (traffic the dispatcher sends to the grid
  sweep: it times the segments' kernel on more blocks than CTAs);
* the segmented engine's fixed costs at 19 qubits: programs of one segment
  each, in place with 0 ops (``h(0) h(0)``, merged away) and with 1 op
  (``h(0)``), and one that gathers and scatters for its 1 op (``h(18)``);
* one k-qubit dense op at 26 qubits (k = 5 to 11) alone in a low sweep
  (qubits 17-k..16) and in a grid sweep (qubits 0..k-1, blk 8, 5 active
  bits: 512 threads), less the same sweep holding one 1-qubit op instead;
* circuits built the same way with a 10- or 11-qubit core, which the grid
  and segmented rows send to the dense pass (the 26q grid sweep with a core
  on qubits 0..k-1, k = 8 and 10; a 10-qubit core on qubits 12-21 of 22 and
  9-18 of 19, an 11-qubit core on 17-27 of 28; a 10-qubit core on 7-16
  of 26, which the sweeps took whole before the route by width);
* circuits built the same way with a 6-9-qubit core that the grid planner
  refuses (9 on 18-26 of 27, 6 on 11-16 and 8 on 20-27 of 28, 7 on 23-29
  of 30: the torch engine ran them whole before the cut at refused gates;
  8 on 18-25 of 26: the segments);
* a 12-qubit dense gate on qubits 0-11 (a Kronecker product of seeded
  random 1-qubit unitaries), built as above at 16 and 22 qubits: the run
  (whole-circuit or grid-sweep launches around one dense pass), and the
  pass alone on a random state at 16, 18 and 22 qubits beside
  ``torch.matmul`` of the core on the complex64 view (TF32 off; its operand
  made from the gate's matrix, so that checkouts whose kernel stores the
  core otherwise compare alike). A checkout without the dense pass prints
  the refusal instead.

For each row: plan it, run it once from |0..0> (or a seeded random state)
and print the engine, the kernels it launched and a fingerprint of the state
(each plane summed against the weights cos(0.7 i), so two checkouts can be
compared), then the median of 7 CUDA-event timings after a warm-up. Below 20
qubits the time is device time from CUDA-graph replays (20 runs per replay),
since eager launches there measure the host. The module uses only entry
points an older checkout of the package has too, so the same file times the
parent: run it there and here in turns (parent, change, change, parent).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import numpy as np
import torch

from tpu_qsim_torch import Circuit, StateVectorSimulator, random_circuit
from tpu_qsim_torch.circuit import Gate
from tpu_qsim_torch.gates import GATE_ARITY, register_gate
from tpu_qsim_torch.kernels import LAUNCHES, reset_launches

# name -> (qubits, core width, lowest core qubit); width 0: random_circuit(n, 100)
ROWS = {
    "28q_random_grid": (28, 0, 0),
    "26q_sweeps_main": (26, 8, 10),
    **{f"{n}q_random_whole": (n, 0, 0) for n in range(10, 19)},
    "19q_random_segments": (19, 0, 0),
    "19q_segment_0_ops": (19, 0, 0),
    "19q_segment_1_op": (19, 0, 0),
    "19q_segment_relabel_1_op": (19, 0, 0),
    "22q_dense8_on_14": (22, 8, 14),    # grid and sweeps refuse it: segments,
    "24q_dense6_on_18": (24, 6, 18),    # since dispatch.GRID_CUTS grid + pass
    "24q_random_on_segments": (24, 0, 0),
    "22q_dense6_on_8": (22, 6, 8),      # the grid refuses it: sweeps
    "26q_dense6_on_0": (26, 6, 0),      # grid sweep, the wide instance
    "26q_random_on_sweeps": (26, 0, 0),
    "26q_random_on_grid": (26, 0, 0),
    "16q_dense12_on_0": (16, 12, 0),    # whole circuit + dense pass
    "22q_dense12_on_0": (22, 12, 0),    # grid sweep + dense pass
    # the route by width: cores of 10+ qubits on the grid and segmented
    # rows take the dense pass (a checkout without it prints its own route:
    # the grid's tiled op, a refusal or the torch engine)
    "26q_grid_dense8_on_0": (26, 8, 0),     # grid sweep, the tiled op (since
                                            # dispatch.GRID_CUTS + dense pass)
    "26q_grid_dense10_on_0": (26, 10, 0),   # grid sweep + dense pass
    "28q_dense11_on_17": (28, 11, 17),      # grid sweep + dense pass
    "22q_dense10_on_12": (22, 10, 12),      # grid sweep + dense pass
    "19q_dense10_on_9": (19, 10, 9),        # segments + dense pass
    "26q_dense10_on_7": (26, 10, 7),        # grid sweep + dense pass (before
                                            # the route by width: the sweeps)
    # a gate that the grid planner refuses: above 26q the torch engine ran
    # the whole circuit before the cut at refused gates, grid pieces and a
    # pass now (a 6-qubit core widened to 7); at 26q in place of the segments
    "27q_dense9_on_18": (27, 9, 18),
    "28q_dense6_on_11": (28, 6, 11),
    "28q_dense8_on_20": (28, 8, 20),
    "30q_dense7_on_23": (30, 7, 23),
    "26q_dense8_on_18": (26, 8, 18),
}
# the one-segment rows' gates
SEGMENT_GATES = {
    "19q_segment_0_ops": (("h", 0), ("h", 0)),
    "19q_segment_1_op": (("h", 0),),
    "19q_segment_relabel_1_op": (("h", 18),),
}
PASS_QUBITS = (16, 18, 22)
PASS_CORE = 12
ONE_OP_QUBITS = 26
ONE_OP_WIDTHS = (5, 6, 7, 8, 9, 10, 11)


def dense_gate(k: int) -> str:
    name = f"time_run_dense{k}"
    if name not in GATE_ARITY:
        rng = np.random.default_rng(k)
        m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
        register_gate(name, np.linalg.qr(m)[0])
    return name


def kron_gate(qubits: tuple[int, ...], seed: int) -> Gate:
    """A dense gate on ``qubits``: a Kronecker product of seeded random
    1-qubit unitaries, carried inline (a QR and the registry's unitarity
    check of a 4096 x 4096 matrix would take seconds)."""
    rng = np.random.default_rng(seed)
    u = np.ones((1, 1), np.complex128)
    for _ in qubits:
        m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        u = np.kron(u, np.linalg.qr(m)[0])
    return Gate(f"kron{len(qubits)}", tuple(qubits), matrix_bytes=u.tobytes())


def wide_circuit(n: int, k: int, lo: int) -> Circuit:
    c = random_circuit(n, 40, seed=42)
    if k >= PASS_CORE:
        c.append(kron_gate(tuple(range(lo, lo + k)), seed=n))
    else:
        c.add(dense_gate(k), *range(lo, lo + k))
    for g in random_circuit(n, 40, seed=43).gates:
        c.append(g)
    return c


def _times_ms(fn, reps: int) -> list[float]:
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
    return out


def _graph_times_ms(fn, reps: int, inner: int = 20) -> list[float]:
    """Device time of ``fn``'s launches: captured once into a CUDA graph,
    then ``inner`` replays per event pair."""
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

    return [t / inner for t in _times_ms(replays, reps)]


def _probe(planes: torch.Tensor) -> list[float]:
    w = torch.cos(0.7 * torch.arange(planes.shape[1], device=planes.device,
                                     dtype=torch.float64))
    return (planes.double() @ w).tolist()


def time_row(name: str, card: str) -> dict:
    n, k, lo = ROWS[name]
    c = wide_circuit(n, k, lo) if k else random_circuit(n, 100, seed=42)
    if name in SEGMENT_GATES:
        c = Circuit(n)
        for gate, q in SEGMENT_GATES[name]:
            c.add(gate, q)
    if name.endswith(("_on_sweeps", "_on_grid", "_on_segments")) or name in SEGMENT_GATES:
        from tpu_qsim_torch.kernels.gridsweeps import GridSweepProgram
        from tpu_qsim_torch.kernels.segmented import SegmentedProgram
        from tpu_qsim_torch.kernels.sweeps import SweepProgram

        engine = ("sweeps" if name.endswith("_on_sweeps") else
                  "grid_sweep" if name.endswith("_on_grid") else "segmented")
        prog = {"sweeps": SweepProgram, "grid_sweep": GridSweepProgram,
                "segmented": SegmentedProgram}[engine](c)
        state = torch.zeros((2, 1 << n), dtype=torch.float32, device="cuda")
        state[0, 0] = 1.0
        reset_launches()
        state = prog.run(state)
        fn = prog.run
    else:
        sim = StateVectorSimulator(n)
        reset_launches()
        try:
            sim.run(c)
        except ValueError as e:     # a checkout that refuses the circuit
            return {"row": name, "card": card, "refused": str(e)[:300]}
        engine = sim.engine
        _, fn = sim.compiled_run(c)
        state = sim.state_planes
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    probe = _probe(state)

    def step():
        nonlocal state
        state = fn(state)

    times = _graph_times_ms(step, 7) if n < 20 else _times_ms(step, 7)
    return {"row": name, "card": card, "engine": engine, "launches": launches,
            "ms": statistics.median(times), "all_ms": times, "probe": probe}


def time_one_op(card: str) -> list[dict]:
    from tpu_qsim_torch.kernels.gridsweeps import GridParams, GridSweepProgram
    from tpu_qsim_torch.kernels.sweeps import SweepProgram

    n = ONE_OP_QUBITS
    rng = np.random.default_rng(3)
    psi = rng.standard_normal((2, 1 << n)).astype(np.float32)
    x = torch.from_numpy(psi / np.linalg.norm(psi)).cuda()
    base = {}
    rows = []
    for k in (1, *ONE_OP_WIDTHS):
        gate = "h" if k == 1 else dense_gate(k)
        # qubits 17-k..16: a moving mid qubit (16) makes it a low sweep
        sprog = SweepProgram(Circuit(n).add(gate, *range(17 - k, 17)))
        gprog = GridSweepProgram(Circuit(n).add(gate, *range(k)), GridParams(8, 5))
        ms = {"low_sweep": statistics.median(_times_ms(lambda: sprog.run(x), 7)),
              "grid_sweep": statistics.median(_times_ms(lambda: gprog.run(x), 7))}
        if k == 1:
            base = ms
            continue
        rows.append({"row": f"{n}q_one_dense{k}_op", "card": card, "sweep_ms": ms,
                     "op_ms": {key: ms[key] - base[key] for key in ms}})
    return rows


def time_dense_pass(card: str) -> list[dict]:
    """The dense pass alone at ``PASS_QUBITS`` on a random state, beside one
    ``torch.matmul`` of its core on the complex64 view (TF32 off)."""
    try:
        from tpu_qsim_torch.kernels.dense_pass import DensePass, dense_pass
        from tpu_qsim_torch.kernels.fused_circuit import as_pgates
    except ImportError as e:
        return [{"row": "dense_pass", "card": card, "refused": str(e)}]
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = []
    try:
        for n in PASS_QUBITS:
            step = DensePass(as_pgates([kron_gate(tuple(range(PASS_CORE)), seed=n)])[0], n)
            rng = np.random.default_rng(n)
            psi = rng.standard_normal((2, 1 << n)).astype(np.float32)
            x = torch.from_numpy(psi / np.linalg.norm(psi)).cuda()
            u = step.u_on(x.device)
            # the core on the view (2^(n-12), 4096) of the state, whose column
            # index bit j is qubit j: the gate's matrix (index MSB qubit 0)
            # with its index bits reversed, transposed
            rev = [int(f"{i:0{PASS_CORE}b}"[::-1], 2) for i in range(1 << PASS_CORE)]
            um = torch.from_numpy(np.ascontiguousarray(
                step.core[np.ix_(rev, rev)].T).astype(np.complex64)).cuda()
            z = torch.complex(x[0], x[1]).view(-1, 1 << PASS_CORE)
            got = dense_pass(x, u, step.tmask, step.cmask)
            y = torch.matmul(z, um).reshape(-1)
            err = float(torch.max(torch.abs(torch.complex(got[0], got[1]) - y)))
            ms = statistics.median(_times_ms(lambda: dense_pass(x, u, step.tmask), 7))
            mm_ms = statistics.median(_times_ms(lambda: torch.matmul(z, um), 7))
            rows.append({"row": f"{n}q_dense12_pass", "card": card, "ms": ms,
                         "matmul_ms": mm_ms, "max_abs_err_vs_matmul": err})
            del u
            step._u.clear()
            del x, z, um, got, y
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--only", action="append", default=None, metavar="NAME",
                        help=f"time only these rows (of {', '.join(ROWS)}, one_op, "
                             "dense_pass)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_run needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    names = [*ROWS, "one_op", "dense_pass"] if args.only is None else args.only
    for name in names:
        if name in ("one_op", "dense_pass"):
            for row in (time_one_op if name == "one_op" else time_dense_pass)(card):
                print(json.dumps(row), flush=True)
        else:
            print(json.dumps(time_row(name, card)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
