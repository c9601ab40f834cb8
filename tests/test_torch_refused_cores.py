"""Gates that the grid planner refuses, cut there and run on the dense pass.

The grid planner refuses a gate that moves more high qubits (at or above
the block's bits) than a sweep's active budget (``gridsweeps.refuses``; the
JAX package's planner raises there too, ``tpu_qsim/kernels/gridsweeps.py``).
At 20-26 qubits the sweeps or the segments then run the circuit whole;
above 26 nothing did but the torch engine. Now the grid row's split
(``dispatch.split_at_wide_cores``, ``dispatch.GRID_CUTS``) cuts there from
22 qubits where the sweeps refuse too, and the gate runs as a dense pass
between grid-sweep pieces (and, from 22 qubits, at every dense core of 5
qubits or more that the grid planner takes); a 5- or 6-qubit core is
widened to the pass's 7 by an identity on the lowest free qubits
(``dense_pass.widened``).

* Plan only: ``time_run.wide_circuit(n, k, lo)`` at 27, 28 and 30 qubits,
  k = 5-11, on the lowest, the middle and the highest qubits, plans on
  kernels, never the torch engine; the engines pinned for one case of each
  column of the probe (k = 5; k = 6-9 low, middle, high).
* At 14 qubits on the grid row (blocks of 8 bits, high qubits 8-13), the
  two circuits that the grid planner refuses (a 6-qubit core on 8-13 and a
  7-qubit one on 7-13), which the row sends to the segments at that size:
  the split at refused gates cuts at the wide gate, and its plain version
  matches the JAX package's ``StateVectorSimulator`` and its complex128
  oracle within 1e-5.
* A 22-qubit circuit that every whole-row engine refuses (a controlled
  9-qubit core on 13-21): the route cuts at the gate.
* The widened 6-qubit core's pass: its plain version and
  ``emulate_dense_pass`` (the mirror of ``csrc/dense_pass.cu``) against the
  JAX package's oracle within 1e-6, with and without a control; and the
  kernel's own source on the host (``tests/torch_host_harness.py``) against
  both.
"""

import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim_torch as tq
from tpu_qsim_torch.circuit import Gate
from tpu_qsim_torch.kernels import dense_pass as dp
from tpu_qsim_torch.kernels import dispatch
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import sweeps as ts
from tpu_qsim_torch.kernels.time_run import wide_circuit

import torch_host_harness as host
from conftest import random_state
from test_torch_dense_op import dense_unitary
from test_torch_dense_pass import emulate_dense_pass
from test_torch_sweeps import jax_oracle, register_both
from torch_threads import one_blas_thread  # noqa: F401

CUDA = torch.device("cuda")
SPLIT = ["grid_sweep", "dense_pass", "grid_sweep"]
PLACEMENTS = ("low", "middle", "high")


def _lo(n: int, k: int, where: str) -> int:
    return {"low": 0, "middle": n // 2 - k // 2, "high": n - k}[where]


# one case of each column of the probe: (engines of the split, or the one
# program's engine; the pass's width as launched)
PINNED = {
    (28, 5, "high"): (SPLIT, dp.MIN_PASS_CORE),     # cut from 5 qubits (GRID_CUTS)
    (27, 6, "low"): (SPLIT, dp.MIN_PASS_CORE),
    (27, 7, "low"): (SPLIT, 7),
    (27, 8, "middle"): (SPLIT, 8),
    (30, 6, "high"): (SPLIT, dp.MIN_PASS_CORE),
}


@pytest.mark.parametrize("where", PLACEMENTS)
@pytest.mark.parametrize("k", range(5, 12))
@pytest.mark.parametrize("n", [27, 28, 30])
def test_no_circuit_above_26q_falls_to_the_torch_engine(n, k, where):
    lo = _lo(n, k, where)
    c = wide_circuit(n, k, lo)
    engine, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert prog is not None and "torch" not in engine.split("+")
    (g,) = [g for g in fc.as_pgates(c.gates) if len(g.qubits) == k]
    if tgs.refuses(g, n):       # the grid planner refuses the whole circuit
        assert dispatch._plan_piece(c, "grid_sweep") == ("torch", None)
        assert prog.engines == SPLIT
    if (n, k, where) in PINNED:
        engines, pass_k = PINNED[n, k, where]
        if pass_k is None:
            assert engine == engines and isinstance(prog, tgs.GridSweepProgram)
        else:
            assert prog.engines == engines and prog.steps[1].k == pass_k
            assert set(range(lo, lo + k)) <= set(prog.steps[1].targets)


@pytest.mark.parametrize("k,lo", [(6, 8), (7, 7)])
def test_split_at_a_refused_gate_matches_the_jax_package(k, lo):
    n = 14
    c = wide_circuit(n, k, lo)
    name = c.gates[40].name
    register_both(name, tq.gates.gate_matrix(name))
    (g,) = fc.as_pgates([c.gates[40]])
    params = tgs.GridParams(tgs.WIDE_BLK_BITS)
    assert tgs.refuses(g, n) and tgs.default_params([g]) == params
    assert tgs.high_moving(g, params) == 6
    with pytest.raises(ValueError, match="moves 6 high qubits"):
        tgs.GridSweepProgram(c)
    assert dispatch.plan_kernels(c, "grid_sweep")[0] == "segmented"    # the row at 14q
    parts = dispatch.split_at_wide_cores(c, refused=True)
    assert [type(p).__name__ for p in parts] == ["Circuit", "PGate", "Circuit"]
    assert parts[1].qubits == tuple(range(lo, lo + k))
    engine, prog = dispatch.plan_split(c, "grid_sweep", refused=True)
    assert engine == "grid_sweep+dense_pass" and prog.engines == SPLIT
    step = prog.steps[1]
    assert step.k == 7 and step.targets == (*((0,) if k == 6 else ()), *range(lo, lo + k))
    assert all(isinstance(s, tgs.GridSweepProgram) for s in prog.steps[0::2])
    got = tq.apply.to_complex(prog.run_plain(tq.apply.initial_state(n, np.float32, device="cpu")))
    sim = jq.StateVectorSimulator(n)
    sim.run(jq.Circuit(n).extend([jq.Gate(g.name, g.qubits, g.param, g.matrix_bytes)
                                  for g in c.gates]))
    np.testing.assert_allclose(got, sim.get_state(), atol=1e-5, rtol=0)
    psi = np.zeros(1 << n, np.complex128)
    psi[0] = 1
    np.testing.assert_allclose(got, jax_oracle(c, psi), atol=1e-5, rtol=0)


def test_cut_where_every_whole_row_engine_refuses():
    # a controlled 9-qubit core on 13-21 of 22: the grid (9 high qubits),
    # the sweeps (a mid and a top qubit) and the segments (10 qubits) all
    # refuse the circuit whole; the route cuts at the gate all the same
    rng = np.random.default_rng(3)
    u = np.eye(1 << 10, dtype=np.complex128)
    u[-512:, -512:] = dense_unitary(9, rng)
    c = tq.Circuit(22).h(0).append(Gate("c_dense9", (0, *range(13, 22)), matrix_bytes=u.tobytes()))
    c.cnot(0, 21)
    with pytest.raises(ValueError, match="no engine takes") as err:
        dispatch._plan_piece(c, "grid_sweep")
    for name in ("grid_sweep:", "sweeps:", "segmented:"):
        assert name in str(err.value)
    engine, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert engine == "grid_sweep+dense_pass" and prog.engines == SPLIT
    assert (prog.steps[1].controls, prog.steps[1].targets) == ((0,), tuple(range(13, 22)))


def _six_qubit_pass(n: int, controls: tuple, targets: tuple, seed: int):
    """A 6-qubit dense core on ``targets`` under ``controls``, as the gate
    (inline), its ``DensePass`` and a random state."""
    rng = np.random.default_rng(seed)
    core = dense_unitary(6, rng)
    u = np.eye(1 << (6 + len(controls)), dtype=np.complex128)
    u[-64:, -64:] = core
    c = tq.Circuit(n).append(Gate("kron6", (*controls, *targets), matrix_bytes=u.tobytes()))
    (g,) = fc.as_pgates(c.gates)
    step = dp.DensePass(g, n, dp.pass_core(g, 0))
    return c, step, random_state(n, rng)


# (controls, targets): qubit 0 free (the identity goes there), taken by a
# target, taken by the control
SIX_CASES = [((), (9, 3, 11, 5, 1, 7)), ((), (0, 4, 2, 8, 6, 10)), ((0,), (2, 11, 4, 6, 8, 10))]


@pytest.mark.parametrize("controls,targets", SIX_CASES)
def test_widened_core_pass_matches_the_jax_package(controls, targets):
    n = 12
    c, step, psi = _six_qubit_pass(n, controls, targets, seed=len(controls) + targets[0])
    free = min(set(range(n)) - set(targets) - set(controls))
    assert (step.k, step.targets, step.controls) == (7, (free, *targets), controls)
    # the bound's work is the gate's: its 6-qubit core, not the widened one
    assert step.core_k == 6
    assert step.flops() == 8.0 * (1 << 6) * (1 << (n - len(controls)))
    assert step.bytes_moved() == 8 * (1 << 12) + 16 * (1 << n)
    np.testing.assert_array_equal(step.core, np.kron(np.eye(2), dp.pass_core(
        fc.as_pgates(c.gates)[0], 0)[1]))
    want = jax_oracle(c, psi)
    plain = tq.apply.to_complex(step.run_plain(tq.apply.from_complex(psi, np.float32, "cpu")))
    np.testing.assert_allclose(plain, want, atol=1e-6, rtol=0)
    got = emulate_dense_pass(psi.astype(np.complex64), dp.core_operand(step.core, step.targets),
                             step.tmask, step.cmask)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_widened_core_on_the_kernel_source():
    # csrc/dense_pass.cu on the host, on the widened operand as the wrapper
    # launches it
    n = 12
    c, step, psi = _six_qubit_pass(n, (5,), (0, 9, 3, 11, 1, 7), seed=12)
    assert step.targets[0] == 2 and dp.pass_instance(7, n - 8) == "small"
    got = host.run_dense_pass(step.core, step.targets, step.controls, psi)
    plain = tq.apply.to_complex(step.run_plain(tq.apply.from_complex(psi, np.float32, "cpu")))
    np.testing.assert_allclose(got, plain, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, jax_oracle(c, psi), atol=1e-5, rtol=0)


def test_no_qubit_left_to_widen():
    # a 6-qubit core under a control on every other qubit of 7 has no free
    # qubit: the pass cannot take it, so the split does not cut there
    rng = np.random.default_rng(7)
    u = np.eye(128, dtype=np.complex128)
    u[64:, 64:] = dense_unitary(6, rng)
    (g,) = fc.as_pgates([(u, tuple(range(7)))])
    found = dp.pass_core(g, 0)
    assert len(found[2]) == 6 and dp.widened(found, 7) is None
    with pytest.raises(ValueError, match="no qubit of 7 is left"):
        dp.DensePass(g, 7, found)
    assert not dispatch._cut(g, 7, ts.MIN_SWEEP_PASS_CORE, True)
