"""The port's parameterized runs and autograd gradients against the JAX
package (gates_torch, run_parameterized, build_expectation_fn).

Same circuits and parameter vectors through both packages: float64 within
1e-12 (states, values) and 1e-10 (gradients, ``torch.autograd`` against
``jax.grad``), float32 within 1e-5. A (P, m) batch of parameter vectors runs
as one batch of states and matches P single calls and ``jax.vmap``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.gates_jax as gj
import tpu_qsim_torch as tq
import tpu_qsim_torch.gates_torch as gt
from tpu_qsim_torch.statevector import build_parameterized_run_fn

from conftest import random_state

F64 = tq.SimConfig(dtype="complex128")
JF64 = jq.SimConfig(dtype="complex128", use_pallas=False)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def _np(m):
    return None if m is None else np.asarray(m)


@pytest.mark.parametrize("name", sorted(gt.TRACED_GATES))
def test_builders_match_jax(name):
    builder, diag = gt.TRACED_GATES[name]
    jbuilder, jdiag = gj.TRACED_GATES[name]
    assert diag == jdiag
    thetas = np.array([0.0, 0.37, -1.9, 3.1])
    for theta in thetas:
        got = builder(torch.tensor(theta, dtype=torch.float64))
        want = jbuilder(jnp.asarray(theta), jnp.float64)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_allclose(g.numpy(), _np(w), atol=1e-15, rtol=0)
    # a batch of angles gives a stack of matrices
    batch = builder(torch.tensor(thetas))
    for i, theta in enumerate(thetas):
        one = builder(torch.tensor(theta, dtype=torch.float64))
        for b, o in zip(batch, one):
            if b is not None:
                torch.testing.assert_close(b[i], o, atol=0, rtol=0)


CIRCUITS = {
    "hea": lambda m: m.hardware_efficient_ansatz(6, 2, seed=3),
    "all_traced": lambda m: (m.Circuit(4).rx(0, 0.3).ry(1, 1.2).rz(2, 2.1).p(0, 0.5)
                             .cry(0, 1, 0.8).crz(1, 3, 1.5).cp(3, 0, 0.9).h(1).cnot(0, 2)
                             .s(3).cz(2, 3).t(0)),
    "qaoa": lambda m: m.qaoa_maxcut_circuit([(0, 1), (1, 2), (2, 3), (3, 0)], 4, [0.4, 0.9], [0.7, 0.2]),
}


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_run_parameterized_matches_jax(name, prec):
    tcfg, jcfg, tol = (
        (tq.SimConfig(), jq.SimConfig(), 1e-5) if prec == "f32" else (F64, JF64, 1e-12)
    )
    tc, jc = CIRCUITS[name](tq), CIRCUITS[name](jq)
    n = tc.num_qubits
    psi = random_state(n, np.random.default_rng(2))
    params = np.asarray(tc.params()) * 0.7 + 0.1
    sim = tq.StateVectorSimulator(n, tcfg, device="cpu")
    sim.set_state(psi)
    sim.run_parameterized(tc, params)
    jsim = jq.StateVectorSimulator(n, jcfg)
    jsim.set_state(psi)
    jsim.run_parameterized(jc, params)
    np.testing.assert_allclose(sim.get_state(), jsim.get_state(), atol=tol, rtol=0)
    # default params: the circuit's own, as run() applies them
    static = tq.StateVectorSimulator(n, tcfg, device="cpu").run(tc)
    dyn = tq.StateVectorSimulator(n, tcfg, device="cpu").run_parameterized(tc)
    np.testing.assert_allclose(dyn.get_state(), static.get_state(), atol=tol, rtol=0)


def test_parameter_sweep_shares_the_plan():
    c = tq.hardware_efficient_ansatz(3, 1, seed=0)
    sim = tq.StateVectorSimulator(3, F64, device="cpu")
    base = np.asarray(c.params())
    sim.run_parameterized(c, base)
    out1 = sim.get_state()
    sim.reset()
    sim.run_parameterized(c, base * 0.5)
    assert len(sim._param_cache) == 1
    assert not np.allclose(out1, sim.get_state())


def test_wrong_param_count_and_untraced_gate_raise():
    from tpu_qsim_torch import gates

    sim = tq.StateVectorSimulator(2, F64, device="cpu")
    with pytest.raises(ValueError, match="parameters"):
        sim.run_parameterized(tq.Circuit(2).rx(0, 0.5), np.zeros(3))

    if "myphase_port" not in gates.GATE_NAMES:
        gates.register_gate(
            "myphase_port", lambda t: np.diag([1.0, np.exp(1j * t)]), num_qubits=1
        )
    c = tq.Circuit(2).add("myphase_port", 0, param=0.8).rx(0, 1.0)
    with pytest.raises(ValueError, match="traced-parameter"):
        sim.run_parameterized(c)
    sim.run(c)   # run() still takes the custom gate
    assert sim.total_probability() == pytest.approx(1.0, abs=1e-12)


H4 = [(0.5, "IIII"), (1.25, "ZZII"), (-2.0, "XIIY"), (0.7, "IYZI"), (-0.3, "ZIIZ")]


def _expectation_pair(rdtype):
    tc = tq.hardware_efficient_ansatz(4, 2, seed=5)
    jc = jq.hardware_efficient_ansatz(4, 2, seed=5)
    f = tq.build_expectation_fn(tc, H4, rdtype, device="cpu")
    jf = jq.build_expectation_fn(jc, H4, rdtype)
    return tc, f, jf


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_expectation_and_gradient_match_jax(prec):
    rdtype, tol, gtol = (np.float32, 1e-5, 1e-5) if prec == "f32" else (np.float64, 1e-12, 1e-10)
    tc, f, jf = _expectation_pair(rdtype)
    params = np.asarray(tc.params()) * 0.9 - 0.2
    p = torch.tensor(params, dtype=torch.float64, requires_grad=True)
    value = f(p)
    value.backward()
    jvalue, jgrad = jax.value_and_grad(jf)(jnp.asarray(params, dtype=rdtype))
    assert float(value.detach()) == pytest.approx(float(jvalue), abs=tol)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrad), atol=gtol, rtol=0)


def test_gradient_is_the_parameter_shift():
    """For Ry/Rz rotations (generator sigma/2) the parameter shift
    (E(t + pi/2) - E(t - pi/2)) / 2 is the exact derivative."""
    tc, f, _ = _expectation_pair(np.float64)
    params = torch.tensor(tc.params(), dtype=torch.float64, requires_grad=True)
    f(params).backward()
    for i in (0, 3, 7, 12):
        shift = torch.zeros_like(params)
        shift[i] = np.pi / 2
        with torch.no_grad():
            ps = (f(params + shift) - f(params - shift)) / 2
        assert float(params.grad[i]) == pytest.approx(float(ps), abs=1e-12)


def test_batch_of_parameter_vectors():
    tc, f, jf = _expectation_pair(np.float64)
    rng = np.random.default_rng(0)
    batch = rng.uniform(-np.pi, np.pi, size=(5, len(tc.params())))
    got = f(batch)
    assert tuple(got.shape) == (5,)
    singles = torch.stack([f(row) for row in batch])
    torch.testing.assert_close(got, singles, atol=1e-12, rtol=0)
    want = np.asarray(jax.vmap(jf)(jnp.asarray(batch)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-12, rtol=0)
    # gradients of the batch sum are the per-vector gradients
    p = torch.tensor(batch, requires_grad=True)
    f(p).sum().backward()
    for i in range(2):
        q = torch.tensor(batch[i], requires_grad=True)
        f(q).backward()
        torch.testing.assert_close(p.grad[i], q.grad, atol=1e-12, rtol=0)


def test_batched_run_fn_matches_single_runs():
    c = tq.Circuit(3).ry(0, 0.1).crz(0, 2, 0.4).cry(2, 1, 0.9).p(1, 0.3).h(2).rx(1, 0.2)
    run = build_parameterized_run_fn(c, np.float64, "cpu")
    rng = np.random.default_rng(1)
    params = torch.tensor(rng.uniform(-3, 3, size=(4, len(c.params()))))
    x = tq.apply.from_complex(random_state(3, rng), np.float64, "cpu")
    batched = run(x.expand(4, 2, 8), params)
    for i in range(4):
        torch.testing.assert_close(batched[i], run(x, params[i]), atol=1e-13, rtol=0)


def test_expectation_errors_and_device():
    c = tq.Circuit(2).ry(0, 0.1)
    with pytest.raises(ValueError, match="invalid Pauli"):
        tq.build_expectation_fn(c, "ZQ", device="cpu")
    with pytest.raises(ValueError, match="invalid Pauli"):
        tq.build_expectation_fn(c, "ZZZ", device="cpu")
    f = tq.build_expectation_fn(c, "Z", device="cpu")
    with pytest.raises(ValueError, match="parameters"):
        f(np.zeros(2))
    assert float(f([0.3])) == pytest.approx(np.cos(0.3), abs=1e-6)


def test_expectation_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.build_expectation_fn(tq.Circuit(1).ry(0, 0.1), "Z")
