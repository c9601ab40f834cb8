"""The port's algorithms against the JAX package's
(tpu_qsim_torch/algorithms.py).

* Circuit factories and Hamiltonians: the same gates, entry for entry.
* Decoders (phase, amplitude, shadow estimators) on the same inputs: equal
  within 1e-12.
* The QAOA objective, its gradient and ``maxcut_expectation``: float32 within
  1e-5 of the JAX package's.
* ``vqe_minimize`` (torch.optim.Adam against optax's Adam): the two energy
  traces of 30 float32 steps within 1e-4 of each other.
* Classical shadows (a torch.Generator, not threefry): as estimates, within
  0.1 of the exact reduced matrix at 8000 snapshots, as the JAX package's
  test holds its own; a record does not depend on the chunk size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.algorithms as ja
import tpu_qsim_torch as tq
import tpu_qsim_torch.algorithms as ta
from tpu_qsim_torch.convert import circuit_from_jax

from conftest import random_state


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


EDGES = [(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)]

FACTORIES = {
    "grover": lambda m: m.grover_circuit(4, 11),
    "grover_iters": lambda m: m.grover_circuit(3, 2, iterations=2),
    "qaoa": lambda m: m.qaoa_maxcut_circuit(EDGES, 4, [0.3, 0.8], [0.5, 0.1]),
    "phase_est": lambda m: m.phase_estimation_circuit(0.3125, 4),
    "trotter1": lambda m: m.trotter_circuit(m.tfim_hamiltonian(3, 0.8, 0.6), 0.7, 3),
    "trotter2": lambda m: m.trotter_circuit(m.heisenberg_hamiltonian(3, 1.0, 0.5, 0.2), 0.4, 2, order=2),
    "trotter_y": lambda m: m.trotter_circuit([(0.3, "YXZ"), (-0.2, "IYI")], 1.1, 2, num_qubits=4),
    "amp_est": lambda m: m.amplitude_estimation_circuit(2, [1, 3], 3),
}


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_factories_match_jax(name):
    got = FACTORIES[name](ta)
    want = circuit_from_jax(FACTORIES[name](ja))
    assert got.signature() == want.signature()


def test_hamiltonians_match_jax():
    for n in (2, 5):
        assert ta.tfim_hamiltonian(n, 0.7, 1.3) == ja.tfim_hamiltonian(n, 0.7, 1.3)
        assert ta.heisenberg_hamiltonian(n, 1.0, 0.0, 0.4) == ja.heisenberg_hamiltonian(n, 1.0, 0.0, 0.4)
    with pytest.raises(ValueError):
        ta.tfim_hamiltonian(1)
    with pytest.raises(ValueError):
        ta.trotter_circuit([(1.0, "ZZ")], 1.0, 0)


def test_decoders_match_jax():
    rng = np.random.default_rng(3)
    for m in (3, 4):
        p = rng.dirichlet(np.ones(1 << (m + 1)))
        assert ta.estimate_phase(p, m) == ja.estimate_phase(p, m)
        p2 = rng.dirichlet(np.ones(1 << (m + 2)))
        assert ta.estimate_amplitude(p2, 2, m) == ja.estimate_amplitude(p2, 2, m)


def test_phase_and_amplitude_estimation_run_on_the_port():
    c = ta.phase_estimation_circuit(0.3125, 4)
    sim = tq.StateVectorSimulator(c.num_qubits, tq.SimConfig(dtype="complex128"), device="cpu").run(c)
    assert ta.estimate_phase(sim.get_probabilities(), 4) == pytest.approx(0.3125)
    c = ta.amplitude_estimation_circuit(2, [1, 3], 3)
    sim = tq.StateVectorSimulator(c.num_qubits, tq.SimConfig(dtype="complex128"), device="cpu").run(c)
    assert ta.estimate_amplitude(sim.get_probabilities(), 2, 3) == pytest.approx(0.5, abs=1e-9)
    g = tq.StateVectorSimulator(4, device="cpu").run(ta.grover_circuit(4, 11))
    assert int(np.argmax(g.get_probabilities())) == 11


def test_qaoa_objective_and_gradient_match_jax():
    obj = ta.qaoa_maxcut_objective(EDGES, 4, depth=2, device="cpu")
    jobj = ja.qaoa_maxcut_objective(EDGES, 4, depth=2)
    angles = np.array([[0.3, 0.9], [0.4, 0.2]])
    a = torch.tensor(angles, dtype=torch.float32, requires_grad=True)
    value = obj(a[0], a[1])
    value.backward()
    jvalue, jgrad = jax.value_and_grad(lambda x: jobj(x[0], x[1]))(jnp.asarray(angles, jnp.float32))
    assert float(value.detach()) == pytest.approx(float(jvalue), abs=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgrad), atol=1e-5, rtol=0)
    # and the objective is maxcut_expectation of the ansatz state
    c = ta.qaoa_maxcut_circuit(EDGES, 4, list(angles[0]), list(angles[1]))
    sim = tq.StateVectorSimulator(4, device="cpu").run(c)
    assert ta.maxcut_expectation(sim, EDGES) == pytest.approx(float(value.detach()), abs=1e-5)
    jsim = jq.StateVectorSimulator(4)
    jsim.run(ja.qaoa_maxcut_circuit(EDGES, 4, list(angles[0]), list(angles[1])))
    assert ta.maxcut_expectation(sim, EDGES) == pytest.approx(ja.maxcut_expectation(jsim, EDGES), abs=1e-5)


def test_vqe_minimize_follows_the_jax_trace():
    h = ta.tfim_hamiltonian(4)
    e, params, hist = ta.vqe_minimize(h, 4, layers=2, steps=30, learning_rate=0.05, seed=2, device="cpu")
    je, _, jhist = ja.vqe_minimize(h, 4, layers=2, steps=30, learning_rate=0.05, seed=2)
    np.testing.assert_allclose(hist, jhist, atol=1e-4, rtol=0)
    assert e == pytest.approx(je, abs=1e-4)
    assert e == min(hist) < hist[0]
    assert isinstance(params, torch.Tensor) and not params.requires_grad
    f = tq.build_expectation_fn(tq.hardware_efficient_ansatz(4, 2, seed=2), h, device="cpu")
    assert float(f(params)) == pytest.approx(e, abs=1e-5)


def test_shadow_estimates_the_reduced_matrix():
    sim = tq.StateVectorSimulator(4, tq.SimConfig(dtype="complex128"), device="cpu").run(tq.ghz_circuit(4))
    sh = ta.classical_shadow(sim, 8000, seed=7)
    assert sh[0].shape == (8000, 4) and sh[1].shape == (8000,)
    for subset in ([0], [0, 1], [2, 3]):
        est = ta.shadow_reduced_density_matrix(sh, subset)
        assert np.abs(est - sim.reduced_density_matrix(subset)).max() < 0.1
        assert abs(np.trace(est).real - 1.0) < 1e-10
    assert ta.shadow_expectation_pauli(sh, "ZZII") == pytest.approx(1.0, abs=0.15)
    assert ta.shadow_expectation_pauli(sh, "XXXX", groups=5) == pytest.approx(1.0, abs=0.4)


def test_shadow_record_is_chunk_invariant():
    sim = tq.StateVectorSimulator(3, device="cpu")
    sim.set_state(random_state(3, np.random.default_rng(1)))
    b1, o1 = ta.classical_shadow(sim, 100, seed=4, chunk=512)
    b2, o2 = ta.classical_shadow(sim, 100, seed=4, chunk=7)
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(o1, o2)
    with pytest.raises(ValueError):
        ta.classical_shadow(sim, 10, chunk=0)


def test_shadow_decoders_match_jax_on_one_record():
    rng = np.random.default_rng(9)
    bases = rng.integers(0, 3, size=(500, 4))
    outcomes = rng.integers(0, 16, size=500)
    sh = (bases, outcomes)
    for subset in ([1], [3, 0], [0, 1, 2]):
        np.testing.assert_allclose(ta.shadow_reduced_density_matrix(sh, subset),
                                   ja.shadow_reduced_density_matrix(sh, subset), atol=1e-12)
    for pauli, groups in (("ZIIX", 1), ("YXZI", 4)):
        assert ta.shadow_expectation_pauli(sh, pauli, groups) == pytest.approx(
            ja.shadow_expectation_pauli(sh, pauli, groups), abs=1e-12)
    with pytest.raises(ValueError):
        ta.shadow_reduced_density_matrix(sh, [-1])


def test_variational_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.qaoa_maxcut_objective(EDGES, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta.vqe_minimize(ta.tfim_hamiltonian(2), 2, steps=1)
