"""The route by width: on every kernel row of the dispatch table a dense
core of ``sweeps.MIN_SWEEP_PASS_CORE`` (10) qubits or more splits the
circuit, and the gate runs as a whole-state dense pass between the row's
programs for the pieces (the sweeps send their unit stages of that width
to the same pass); a row's program planned directly still holds such a core
in its tiled op.

* Each kernel row through ``dispatch.plan_kernels`` at 12-15 qubits, with a
  10- and an 11-qubit core on the lowest and on the highest qubits: the
  engines of the plan, and its plain version against the JAX package's
  complex128 oracle within 1e-5.
* Circuits that no engine took before: a 19-qubit circuit with a 10- or
  11-qubit core (the segmented engine holds no core wider than 9 qubits),
  and the same cores on high qubits at 22 and 24 qubits; at 28 qubits such
  a core sent the whole circuit to the torch engine.
* The main paths' circuits plan as before: no core of 10 qubits or more,
  no split.
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.kernels import dispatch
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import segmented as seg
from tpu_qsim_torch.kernels import sweeps as ts
from tpu_qsim_torch.kernels.dense_pass import DensePass
from tpu_qsim_torch.kernels.time_run import kron_gate

from conftest import random_state
from test_torch_sweeps import jax_oracle
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-5
CUDA = torch.device("cuda")


def _circuit(n: int, k: int, lo: int, seed: int = 1) -> tq.Circuit:
    """A k-qubit dense gate on qubits lo..lo+k-1 (a Kronecker product of
    seeded random 1-qubit unitaries, carried inline) between two random
    layers."""
    c = tq.random_circuit(n, 20, seed=seed)
    c.append(kron_gate(tuple(range(lo, lo + k)), seed=10 * k + lo))
    return c.extend(tq.random_circuit(n, 20, seed=seed + 1).gates)


def test_one_constant_sets_every_route():
    # every kernel row cuts where the sweeps send a unit stage to the pass:
    # at MIN_SWEEP_PASS_CORE qubits, not one below
    k = ts.MIN_SWEEP_PASS_CORE
    assert k == 10 < fc.MAX_DENSE_QUBITS + 1
    assert dispatch.split_at_wide_cores(_circuit(12, k - 1, 0)) is None
    parts = dispatch.split_at_wide_cores(_circuit(12, k, 2))
    assert [isinstance(p, tq.Circuit) for p in parts] == [True, False, True]
    assert tuple(parts[1].qubits) == tuple(range(2, 2 + k))
    # on every row but the grid's, and on the grid's below 22q; from 22q
    # the grid row's width by size (dispatch.GRID_CUTS, measured on the card)
    for engine, n in (("whole_circuit", 18), ("segmented", 19), ("grid_sweep", 21)):
        assert dispatch.cuts_for(engine, n) == (k, False)
    assert [dispatch.cuts_for("grid_sweep", n) for n in (22, 26, 27, 28, 30)] == [(5, True)] * 5


ROW_PIECES = {"grid_sweep": tgs.GridSweepProgram, "segmented": seg.SegmentedProgram,
              "whole_circuit": fc.WholeCircuitProgram}


ROW_CASES = [(engine, n, k, where)
             for engine, n in (("grid_sweep", 13), ("grid_sweep", 14), ("segmented", 14),
                               ("whole_circuit", 12), ("whole_circuit", 14))
             for k in (10, 11) for where in ("lowest", "highest")]


@pytest.mark.parametrize("engine,n,k,where", [*ROW_CASES, ("segmented", 15, 10, "highest")])
def test_kernel_rows_split_at_ten_qubit_cores(engine, n, k, where):
    lo = 0 if where == "lowest" else n - k
    c = _circuit(n, k, lo)
    got, prog = dispatch.plan_kernels(c, engine)
    assert got == f"{engine}+dense_pass"
    assert prog.engines == [engine, "dense_pass", engine]
    assert [type(s) for s in prog.steps] == [ROW_PIECES[engine], DensePass, ROW_PIECES[engine]]
    step = prog.steps[1]
    assert (step.k, step.controls, step.tmask) == (k, (), ((1 << k) - 1) << lo)
    assert all(max(t.max_core for t in _tables(s)) < ts.MIN_SWEEP_PASS_CORE
               for s in prog.steps[0::2])
    psi = random_state(n, np.random.default_rng(n + k + lo))
    x = tq.apply.from_complex(psi, np.float32, "cpu")
    got_state = tq.apply.to_complex(prog.run_plain(x))
    np.testing.assert_allclose(got_state, jax_oracle(c, psi), atol=TOL, rtol=0)


def _tables(prog) -> list:
    if isinstance(prog, seg.SegmentedProgram):
        return [s.table for s in prog.steps]
    if isinstance(prog, fc.WholeCircuitProgram):
        return [prog.table]
    return prog.tables


@pytest.mark.parametrize("n", [12, 14])
@pytest.mark.parametrize("k", [10, 11])
@pytest.mark.parametrize("where", ["lowest", "highest"])
def test_whole_circuit_program_still_holds_wide_cores(n, k, where):
    # planned directly (the measurements' tiled op), the whole-circuit
    # program keeps cores of up to MAX_DENSE_QUBITS in its tiled op
    lo = 0 if where == "lowest" else n - k
    c = _circuit(n, k, lo)
    prog = fc.WholeCircuitProgram(c)
    assert prog.table.max_core == k
    assert [st.kind for st in prog.stages].count("unit") == 1
    psi = random_state(n, np.random.default_rng(n + k + lo))
    x = tq.apply.from_complex(psi, np.float32, "cpu")
    got_state = tq.apply.to_complex(prog.run_plain(x))
    np.testing.assert_allclose(got_state, jax_oracle(c, psi), atol=TOL, rtol=0)


@pytest.mark.parametrize("k,lo", [(10, 0), (10, 9), (11, 8)])
def test_19q_wide_core_runs_on_segments_and_a_pass(k, lo):
    """The fault: a 19-qubit circuit with a 10- or 11-qubit core raised "a
    10-qubit gate needs local_bits >= 15" in ``plan_run``, since the
    segmented engine, the only one at 19 qubits, holds no core wider than 9
    qubits; the JAX package runs it on its whole-circuit kernel. Now the
    core is a dense pass between segmented pieces."""
    n = 19
    c = _circuit(n, k, lo)
    got, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert got == "segmented+dense_pass"
    assert prog.engines == ["segmented", "dense_pass", "segmented"]
    assert prog.steps[1].k == k
    if (k, lo) == (10, 9):
        psi = random_state(n, np.random.default_rng(n))
        x = tq.apply.from_complex(psi, np.float32, "cpu")
        np.testing.assert_allclose(tq.apply.to_complex(prog.run_plain(x)),
                                   jax_oracle(c, psi), atol=TOL, rtol=0)


@pytest.mark.parametrize("n,k,lo,parent", [
    (22, 10, 12, "refused"),       # every engine refused it
    (24, 11, 13, "refused"),
    (26, 10, 0, "grid_sweep"),     # the grid sweep's tiled op took it
    (28, 11, 17, "torch"),         # the torch engine took the whole circuit
    (30, 10, 20, "torch"),
])
def test_wide_cores_above_19q_plan_grid_pieces_and_a_pass(n, k, lo, parent):
    c = _circuit(n, k, lo)
    got, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert got == "grid_sweep+dense_pass"
    assert prog.engines == ["grid_sweep", "dense_pass", "grid_sweep"]
    assert (prog.steps[1].k, prog.steps[1].num_qubits) == (k, n)
    # the parent's plan of the same circuit, from its engines: the grid
    # planner refuses a core on high qubits and takes one on block bits
    pieces = dispatch._plan_piece
    if parent == "grid_sweep":
        assert isinstance(tgs.GridSweepProgram(c), tgs.GridSweepProgram)
    elif parent == "torch":
        assert pieces(c, "grid_sweep") == ("torch", None)
    else:
        with pytest.raises(ValueError, match="no engine takes"):
            pieces(c, "grid_sweep")


@pytest.mark.parametrize("name", ["28q", "26q_sweeps", "19q", "18q", "22q_dense12"])
def test_main_paths_plan_as_before(name):
    from tpu_qsim_torch.kernels.time_run import wide_circuit

    c, engine, engines = {
        "28q": (tq.random_circuit(28, 100, seed=42), "grid_sweep", None),
        "26q_sweeps": (wide_circuit(26, 8, 10), "sweeps", None),
        "19q": (tq.random_circuit(19, 100, seed=42), "segmented", None),
        "18q": (tq.random_circuit(18, 100, seed=42), "whole_circuit", None),
        "22q_dense12": (wide_circuit(22, 12, 0), "grid_sweep+dense_pass",
                        ["grid_sweep", "dense_pass", "grid_sweep"]),
    }[name]
    got, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert got == engine
    assert getattr(prog, "engines", None) == engines
    # the row's own program, planned as the parent planned it
    if engines is None:
        row = dispatch.engine_for_size(c.num_qubits)
        assert dispatch.split_at_wide_cores(c) is None
        assert dispatch._plan_piece(c, row)[0] == engine


def test_crossover_tool_plans_both_ways_on_the_cpu():
    # tune_route --crossover's cases at small sizes on the plain versions:
    # the tiled op's program (or its refusal) and the split agree
    from tpu_qsim_torch.kernels import tune_route

    rows = tune_route.crossover(torch.device("cpu"), grid=(13,), whole=(12,), segment=(14,),
                                cores=(10,))
    by = {r["route"]: r for r in rows}
    assert sorted(by) == ["grid_sweep", "segmented", "whole_circuit"]
    for route in ("grid_sweep", "whole_circuit"):
        assert by[route]["tiled"]["engines"] == [route]
        assert by[route]["split"]["engines"] == [route, "dense_pass", route]
        assert by[route]["max_abs_diff"] <= TOL
    assert "local_bits >= 15" in by["segmented"]["tiled"]["refused"]
    assert by["segmented"]["split"]["engines"] == ["segmented", "dense_pass", "segmented"]
    (row,) = [r for r in tune_route.instances(13, torch.device("cpu"), cores=(5,))
              if r["row"] == "13q_one_dense5_op_sweep"]
    assert row["max_core"] == 5


@pytest.mark.parametrize("n", [22, 24, 26])
def test_sweeps_send_unit_stages_of_six_qubits_to_the_stream_pass(n):
    # the sweeps' own width (sweeps.MIN_UNIT_PASS_CORE): a circuit the
    # sweeps take, its k-qubit core on the middle qubits, runs the core as a
    # dense pass inside the sweep from 6 qubits (widened to 7), on the
    # stream instance; a 5-qubit core, which the grid planner takes, the
    # grid row cuts (GRID_CUTS)
    from tpu_qsim_torch.kernels import dense_pass as dp

    assert ts.MIN_UNIT_PASS_CORE == 6
    for k in (5, 6, 7, 8, 9):
        lo = n // 2 - k // 2
        engine, prog = dispatch.plan_run(_circuit(n, k, lo), np.float32, CUDA)
        if k == 5:
            assert engine == "grid_sweep+dense_pass" and prog.engines[1] == "dense_pass"
            continue
        assert engine == "sweeps"
        routes = [ln.route for sweep in prog.launches for ln in sweep]
        assert "unit" not in routes and routes.count("pass") == 1
        (step,) = [ln.step for sweep in prog.launches for ln in sweep if ln.route == "pass"]
        assert step.k == max(k, dp.MIN_PASS_CORE) and step.targets[-k:] == tuple(range(lo, lo + k))
        assert dp.pass_instance(step.k, n - step.k - len(step.controls)) == "stream"


@pytest.mark.parametrize("shape", ["layer", "spread"])
@pytest.mark.parametrize("k", [5, 6])
@pytest.mark.parametrize("n", [22, 28])
def test_several_narrow_cores_each_take_a_pass(n, k, shape):
    # tune_route --several's circuits (a layer of n // k dense k-qubit gates
    # on disjoint qubits, or four spread between random layers): from 22q
    # the grid row cuts at each of them (GRID_CUTS' width 5, which beat the
    # grid holding them all by 22-47% on the card), and the route with the
    # former width, 7, left them in the grid sweep
    from tpu_qsim_torch.kernels import tune_route

    c = tune_route.several_circuit(n, k, shape)
    gates = n // k if shape == "layer" else 4
    engine, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert engine == "grid_sweep+dense_pass"
    assert prog.engines.count("dense_pass") == gates
    assert {s.core_k for s in prog.steps if isinstance(s, DensePass)} == {k}
    assert set(prog.engines) == {"grid_sweep", "dense_pass"}
    saved = dispatch.GRID_CUTS
    try:
        dispatch.GRID_CUTS = tuple((lo, 7 if lo == 22 else w, r) for lo, w, r in saved)
        before = dispatch.plan_run(c, np.float32, CUDA)
    finally:
        dispatch.GRID_CUTS = saved
    assert before[0] == "grid_sweep"
