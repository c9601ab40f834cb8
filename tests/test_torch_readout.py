"""The port's readout extras on BaseSimulator against the JAX package.

Reduced density matrices, entanglement entropy and fidelities of the same
states: float32 within 1e-5, float64 within 1e-12. Checkpoints load across
the two packages. The per-call ``generator=`` argument (the port's
counterpart of ``key=``) is checked for reproducibility and for leaving the
simulator's own stream alone; sampled outcomes are compared as distributions.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim_torch as tq

from conftest import random_state

PREC = {
    "f32": (tq.SimConfig(), jq.SimConfig(), 1e-5),
    "f64": (tq.SimConfig(dtype="complex128"), jq.SimConfig(dtype="complex128", use_pallas=False), 1e-12),
}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def _pair(n, prec, psi=None, circuit=None, seed=0):
    tcfg, jcfg, tol = PREC[prec]
    sim = tq.StateVectorSimulator(n, tcfg, seed=seed, device="cpu")
    jsim = jq.StateVectorSimulator(n, jcfg, seed=seed)
    if psi is not None:
        sim.set_state(psi)
        jsim.set_state(psi)
    if circuit is not None:
        sim.run(circuit(tq))
        jsim.run(circuit(jq))
    return sim, jsim, tol


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("subset", [(0,), (3, 1), (7, 0, 4), (2, 5, 6, 1), tuple(range(8))])
def test_reduced_density_matrix_matches_jax(prec, subset):
    psi = random_state(8, np.random.default_rng(len(subset)))
    sim, jsim, tol = _pair(8, prec, psi)
    got = sim.reduced_density_matrix(subset)
    want = jsim.reduced_density_matrix(subset)
    assert got.shape == (1 << len(subset),) * 2
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got, got.conj().T, atol=tol, rtol=0)
    assert abs(np.trace(got) - 1.0) < 10 * tol


@pytest.mark.parametrize("subset", [(0,), (1, 2), (0, 3, 5)])
def test_entanglement_entropy_matches_jax(subset):
    circuit = lambda m: m.random_circuit(6, 40, seed=4)   # noqa: E731
    sim, jsim, _ = _pair(6, "f64", circuit=circuit)
    assert sim.entanglement_entropy(subset) == pytest.approx(
        jsim.entanglement_entropy(subset), abs=1e-10
    )


def test_entropy_closed_forms():
    sim = tq.StateVectorSimulator(2, device="cpu").run(tq.bell_circuit())
    assert sim.entanglement_entropy([0]) == pytest.approx(1.0, abs=1e-6)
    ghz = tq.StateVectorSimulator(5, device="cpu").run(tq.ghz_circuit(5))
    for cut in ([0], [1, 3], [0, 1, 2, 4]):
        assert ghz.entanglement_entropy(cut) == pytest.approx(1.0, abs=1e-6)
    prod = tq.StateVectorSimulator(3, device="cpu").run(tq.Circuit(3).h(0).h(2))
    assert prod.entanglement_entropy([0]) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_fidelity_with_matches_jax(prec):
    rng = np.random.default_rng(3)
    a, b = random_state(7, rng), random_state(7, rng)
    sim, jsim, tol = _pair(7, prec, a)
    other, jother, _ = _pair(7, prec, b)
    want = jsim.fidelity_with(jother)
    assert sim.fidelity_with(other) == pytest.approx(want, abs=tol)
    # raw planes, the port's and the JAX package's, are peers too
    assert sim.fidelity_with(other.state_planes) == pytest.approx(want, abs=tol)
    assert sim.fidelity_with(np.asarray(jother.state_planes)) == pytest.approx(want, abs=tol)
    assert sim.fidelity_with(sim) == pytest.approx(1.0, abs=10 * tol)


def test_fidelity_checks_width_before_shape():
    pure2 = tq.StateVectorSimulator(2, device="cpu")
    rho1 = tq.DensityMatrixSimulator(1, device="cpu")     # (2, 4) planes, one qubit
    assert tuple(rho1.state_planes.shape) == tuple(pure2.state_planes.shape)
    with pytest.raises(ValueError, match="register width mismatch"):
        pure2.fidelity_with(rho1)
    with pytest.raises(ValueError, match="state shape mismatch"):
        pure2.fidelity_with(torch.zeros(2, 8))


def test_validated_subset_errors():
    sim = tq.StateVectorSimulator(13, device="cpu")
    for bad in ([], [0, 0], [13], list(range(13))):
        with pytest.raises(ValueError):
            sim.reduced_density_matrix(bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoints_load_across_packages(tmp_path, writer):
    psi = random_state(6, np.random.default_rng(8))
    sim, jsim, _ = _pair(6, "f32", psi)
    path = str(tmp_path / "state.npz")
    (sim if writer == "port" else jsim).save_state(path)
    data = np.load(path)
    assert set(data.files) == {"planes", "num_qubits", "dtype"}
    fresh = tq.StateVectorSimulator(6, device="cpu")
    jfresh = jq.StateVectorSimulator(6)
    fresh.load_state(path)
    jfresh.load_state(path)
    np.testing.assert_array_equal(fresh.get_state(), jfresh.get_state())
    np.testing.assert_allclose(fresh.get_state(), psi, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="qubits"):
        tq.StateVectorSimulator(5, device="cpu").load_state(path)


def test_sync_and_block_until_ready():
    sim = tq.StateVectorSimulator(4, device="cpu").run(tq.ghz_circuit(4))
    assert sim.block_until_ready() is sim
    assert sim.sync() == pytest.approx(1.0, abs=1e-6)


def test_generator_argument_reproduces_and_leaves_own_stream():
    psi = random_state(5, np.random.default_rng(1))
    sim = tq.StateVectorSimulator(5, seed=4, device="cpu")
    sim.set_state(psi)
    twin = tq.StateVectorSimulator(5, seed=4, device="cpu")
    twin.set_state(psi)
    g1 = torch.Generator().manual_seed(99)
    g2 = torch.Generator().manual_seed(99)
    a = sim.sample(300, generator=g1)
    b = sim.sample(300, generator=g2)
    torch.testing.assert_close(a, b)
    # the simulator's own stream did not move
    torch.testing.assert_close(sim.sample(300), twin.sample(300))
    h1 = sim.histogram(500, generator=torch.Generator().manual_seed(5))
    h2 = twin.histogram(500, generator=torch.Generator().manual_seed(5))
    assert h1 == h2 and sum(h1.values()) == 500


def test_generator_argument_measures_like_key():
    outcomes = []
    for seed in range(60):
        sim = tq.StateVectorSimulator(2, device="cpu").run(tq.bell_circuit())
        gen = torch.Generator().manual_seed(seed)
        a = sim.measure_qubit(0, generator=gen)
        assert sim.measure_qubit(1, generator=gen) == a
        outcomes.append(a)
    assert 15 < sum(outcomes) < 45
    again = tq.StateVectorSimulator(2, device="cpu").run(tq.bell_circuit())
    assert again.measure_qubit(0, generator=torch.Generator().manual_seed(0)) == outcomes[0]


def test_sampling_with_generator_matches_distribution():
    n, shots = 4, 40000
    psi = random_state(n, np.random.default_rng(6))
    p = np.abs(psi) ** 2
    sim, jsim, _ = _pair(n, "f32", psi)
    hists = (
        sim.histogram(shots, generator=torch.Generator().manual_seed(1)),
        jsim.histogram(shots, key=jax.random.PRNGKey(1)),
    )
    for hist in hists:
        counts = np.array([hist.get(i, 0) for i in range(1 << n)])
        assert counts.sum() == shots
        assert np.all(np.abs(counts - shots * p) <= 5 * np.sqrt(shots * p * (1 - p)) + 1)
