"""The port's DensityMatrixSimulator against the JAX package's
(tpu_qsim_torch/density.py).

rho of the port against rho of the JAX package on the same circuits and noise
models, under both insertion policies: float32 within 1e-5, float64 within
1e-12 (n <= 8, at most 12 gates). Every readout (trace, purity, validity,
probabilities, qubit marginals, Pauli expectations, reduced matrices,
fidelities) is compared the same way, and the initial states against their
closed forms. Measurement and sampling are checked by their closed forms and
as distributions.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.density as jdensity
import tpu_qsim.noise as jnoise
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


def _model(m):
    return (m.NoiseModel().add_depolarizing(0.05).add_amplitude_damping(0.1, [0, 2])
            .add_phase_damping(0.07, 1).add_bit_phase_flip(0.03, [3]))


def _circuit(m, n):
    c = m.Circuit(n).h(0).ry(1, 0.4).cnot(0, 1).crz(1, 2, 0.9).t(2).cry(2, 3, 1.3)
    return c.swap(0, 3).rx(1, 0.6).cz(1, 3).p(0, 0.2)


def _pair(n, prec, insertion, noisy=True, circuit=_circuit):
    tcfg, jcfg, tol = PREC[prec]
    sim = tq.DensityMatrixSimulator(n, _model(tq) if noisy else None, tcfg,
                                    insertion=insertion, device="cpu")
    jsim = jdensity.DensityMatrixSimulator(n, _model(jnoise) if noisy else None, jcfg,
                                           insertion=insertion)
    sim.run(circuit(tq, n))
    jsim.run(circuit(jq, n))
    return sim, jsim, tol


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("insertion", ["gate_qubits", "all"])
def test_rho_matches_jax(prec, insertion):
    sim, jsim, tol = _pair(4, prec, insertion)
    np.testing.assert_allclose(sim.get_matrix(), jsim.get_matrix(), atol=tol, rtol=0)
    assert sim.purity() < 1.0 - 1e-3


def test_rho_at_8_qubits_matches_jax():
    def circuit(m, n):
        c = m.random_circuit(n, 10, seed=8)
        return c.add("cry", 7, 0, param=0.5).add("toffoli", 1, 4, 6)

    sim, jsim, tol = _pair(8, "f32", "gate_qubits", circuit=circuit)
    np.testing.assert_allclose(sim.get_matrix(), jsim.get_matrix(), atol=tol, rtol=0)


@pytest.mark.parametrize("prec", ["f32", "f64"])
def test_readouts_match_jax(prec):
    sim, jsim, tol = _pair(4, prec, "gate_qubits")
    assert sim.trace() == pytest.approx(jsim.trace(), abs=tol)
    assert sim.purity() == pytest.approx(jsim.purity(), abs=tol)
    assert sim.is_valid() and jsim.is_valid()
    np.testing.assert_allclose(sim.probabilities().numpy(), np.asarray(jsim.probabilities()),
                               atol=tol, rtol=0)
    for q in range(4):
        assert sim.qubit_probability(q) == pytest.approx(jsim.qubit_probability(q), abs=tol)
    for pauli in ("Z", "XY", "ZIIX", "YZXI", "IIII"):
        assert sim.expectation_pauli(pauli) == pytest.approx(jsim.expectation_pauli(pauli), abs=tol)
    for subset in ((0,), (2, 0), (3, 1, 2)):
        np.testing.assert_allclose(sim.reduced_density_matrix(subset),
                                   jsim.reduced_density_matrix(subset), atol=tol, rtol=0)
    psi = random_state(4, np.random.default_rng(5))
    pure = tq.StateVectorSimulator(4, PREC[prec][0], device="cpu")
    pure.set_state(psi)
    jpure = jq.StateVectorSimulator(4, PREC[prec][1])
    jpure.set_state(psi)
    assert sim.fidelity_with(pure) == pytest.approx(jsim.fidelity_with(jpure), abs=tol)
    other, jother, _ = _pair(4, prec, "all")
    assert sim.fidelity_with(other) == pytest.approx(jsim.fidelity_with(jother), abs=10 * tol)


def test_noiseless_rho_is_the_pure_state():
    c = tq.random_circuit(5, 40, seed=3)
    sim = tq.DensityMatrixSimulator(5, device="cpu").run(c)
    pure = tq.StateVectorSimulator(5, device="cpu").run(c)
    psi = pure.get_state()
    np.testing.assert_allclose(sim.get_matrix(), np.outer(psi, psi.conj()), atol=1e-6)
    assert sim.fidelity_with(pure) == pytest.approx(1.0, abs=1e-5)
    assert sim.purity() == pytest.approx(1.0, abs=1e-5)


def test_initial_states():
    n = 3
    sim = tq.DensityMatrixSimulator(n, device="cpu")
    want = np.zeros((8, 8))
    want[0, 0] = 1
    np.testing.assert_array_equal(sim.get_matrix(), want)
    sim.reset(5)
    assert sim.get_matrix()[5, 5] == 1 and np.abs(sim.get_matrix()).sum() == 1
    sim.set_maximally_mixed()
    np.testing.assert_allclose(sim.get_matrix(), np.eye(8) / 8, atol=1e-7)
    assert sim.purity() == pytest.approx(1 / 8)
    psi = random_state(n, np.random.default_rng(2))
    sim.init_from_pure_state(psi)
    np.testing.assert_allclose(sim.get_matrix(), np.outer(psi, psi.conj()), atol=1e-6)
    sim.set_state(psi)
    np.testing.assert_allclose(sim.get_state(), np.outer(psi, psi.conj()), atol=1e-6)
    rho = np.diag([0.5, 0.25, 0.25, 0, 0, 0, 0, 0]).astype(complex)
    sim.set_matrix(rho)
    np.testing.assert_allclose(sim.get_matrix(), rho, atol=1e-7)


def test_exact_channel_against_numpy():
    """Channels after every gate on a Bell pair, against the Kraus sums
    computed in numpy."""
    from tpu_qsim_torch.fusion import expand_matrix

    p = 0.3
    for ntype in tq.NoiseType:
        model = tq.NoiseModel().add(ntype, p, 0)
        sim = tq.DensityMatrixSimulator(2, model, tq.SimConfig(dtype="complex128"), device="cpu")
        sim.run(tq.bell_circuit())
        rho = np.zeros((4, 4), complex)
        rho[0, 0] = 1
        kraus = [expand_matrix(k, (0,), (1, 0)) for k in tq.noise.kraus_operators(ntype, p)]
        for g in tq.bell_circuit().gates:
            u = expand_matrix(tq.gates.op_matrix(g), g.qubits, (1, 0))
            rho = u @ rho @ u.conj().T
            if 0 in g.qubits:
                rho = sum(k @ rho @ k.conj().T for k in kraus)
        np.testing.assert_allclose(sim.get_matrix(), rho, atol=1e-12)


def test_measurement_and_sampling():
    sim = tq.DensityMatrixSimulator(2, seed=3, device="cpu").run(tq.bell_circuit())
    a = sim.measure_qubit(0)
    assert sim.trace() == pytest.approx(1.0, abs=1e-6)
    assert sim.measure_qubit(1) == a
    assert sim.get_matrix()[3 * a, 3 * a] == pytest.approx(1.0)
    basis = tq.DensityMatrixSimulator(3, device="cpu")
    basis.reset(6)
    assert [basis.measure_qubit(q) for q in range(3)] == [0, 1, 1]
    mixed = tq.DensityMatrixSimulator(2, seed=1, device="cpu")
    mixed.set_matrix(np.diag([0.1, 0.2, 0.3, 0.4]).astype(complex))
    shots = 40000
    counts = np.bincount(mixed.sample(shots).numpy(), minlength=4)
    p = np.array([0.1, 0.2, 0.3, 0.4])
    assert np.all(np.abs(counts - shots * p) <= 5 * np.sqrt(shots * p * (1 - p)))
    gen = torch.Generator().manual_seed(4)
    again = mixed.sample(100, generator=torch.Generator().manual_seed(4))
    torch.testing.assert_close(mixed.sample(100, generator=gen), again)


def test_errors():
    with pytest.raises(ValueError, match="density matrix supports"):
        tq.DensityMatrixSimulator(15, device="cpu")
    with pytest.raises(ValueError, match="insertion"):
        tq.DensityMatrixSimulator(2, insertion="every", device="cpu")
    sim = tq.DensityMatrixSimulator(2, device="cpu")
    with pytest.raises(ValueError, match="register width"):
        sim.fidelity_with(tq.StateVectorSimulator(4, device="cpu"))
    with pytest.raises(ValueError, match="neither"):
        sim.fidelity_with(torch.zeros(2, 8))
    with pytest.raises(ValueError, match="qubits"):
        sim.run(tq.Circuit(3).h(0))
