"""The port's noise models and trajectory simulators against the JAX package
(tpu_qsim_torch/noise.py, noisy.py).

* Noise tables are the JAX package's, entry for entry.
* With every channel at p = 0 a trajectory is the ideal state (float32, 1e-5
  against both packages' simulators).
* Forced branch sequences (the step takes its uniforms as an argument) give
  the product of the chosen Kraus matrices computed in numpy, renormalized
  (float64, 1e-12).
* Trajectory ensembles are distributions: for every basis state x,
  |mean_b p_b(x) - rho_xx| <= 5 std_b(p_b(x)) / sqrt(B) + 1e-6 against the
  JAX DensityMatrixSimulator's exact rho, under both insertion policies, and
  at 8 qubits, where the JAX package takes its scan layer for global
  channels. Seeds are fixed, so each case is deterministic.
* Ensemble readouts of one batch (saved by the port, loaded by the JAX
  package) agree within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.density as jdensity
import tpu_qsim.noise as jnoise
import tpu_qsim.noisy as jnoisy
import tpu_qsim_torch as tq
from tpu_qsim_torch import noise as tnoise
from tpu_qsim_torch.convert import circuit_from_jax, noise_model_from_jax
from tpu_qsim_torch.noisy import build_trajectory_step

from conftest import random_state


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


TYPES = [t.value for t in tnoise.NoiseType]


@pytest.mark.parametrize("ntype", TYPES)
def test_noise_tables_match_jax(ntype):
    for p in (0.0, 0.13, 1.0):
        got = tnoise.kraus_operators(tnoise.NoiseType(ntype), p)
        want = jnoise.kraus_operators(jnoise.NoiseType(ntype), p)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        total = sum(k.conj().T @ k for k in got)
        np.testing.assert_allclose(total, np.eye(2), atol=1e-12)
        if tnoise.NoiseType(ntype) in tnoise.UNITARY_MIX_TYPES:
            gp, gu = tnoise.unitary_mix(tnoise.NoiseType(ntype), p)
            wp, wu = jnoise.unitary_mix(jnoise.NoiseType(ntype), p)
            np.testing.assert_array_equal(gp, wp)
            np.testing.assert_array_equal(gu, wu)


def _models(m):
    return {
        "depol_damp": m.NoiseModel().add_depolarizing(0.08).add_amplitude_damping(0.15, [0, 2]),
        "flips_dephase": (m.NoiseModel().add_bit_flip(0.1, 1).add_phase_damping(0.2)
                          .add_bit_phase_flip(0.05, [0, 3]).add_phase_flip(0.07)),
    }


def test_noise_model_carries_across():
    for name, jm in _models(jnoise).items():
        tm = noise_model_from_jax(jm)
        assert tm.signature() == jm.signature()
        assert tm.signature() == _models(tnoise)[name].signature()


def _circuit(m, n, gates, seed):
    return m.random_circuit(n, gates, seed=seed)


def _h_layer_then_random(m, n, gates, seed):
    c = m.Circuit(n)
    for q in range(n):
        c.h(q)
    for g in m.random_circuit(n, gates, seed=seed).gates:
        c.append(g)
    return c


def test_zero_probability_is_the_ideal_state():
    n = 6
    tm = tq.NoiseModel().add_depolarizing(0.0).add_amplitude_damping(0.0)
    jm = jq.noise.NoiseModel().add_depolarizing(0.0).add_amplitude_damping(0.0)
    c, jc = _circuit(tq, n, 40, 42), _circuit(jq, n, 40, 42)
    noisy = tq.NoisySimulator(n, tm, device="cpu").run(c)
    ideal = tq.StateVectorSimulator(n, device="cpu").run(c)
    jnoisy_sim = jnoisy.NoisySimulator(n, jm)
    jnoisy_sim.run(jc)
    np.testing.assert_allclose(noisy.get_state(), ideal.get_state(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(noisy.get_state(), jnoisy_sim.get_state(), atol=1e-5, rtol=0)


def _full(u, qubits, n):
    """numpy: ``u`` on ``qubits`` (qubits[0] the MSB of its index) as a
    2^n x 2^n matrix, index bit q = qubit q."""
    from tpu_qsim_torch.fusion import expand_matrix

    return expand_matrix(u, tuple(qubits), tuple(range(n - 1, -1, -1)))


def _kraus_step(state, kraus, branch, qubit, n):
    """numpy: apply Kraus branch ``branch`` of a 1-qubit channel and
    renormalize."""
    out = _full(kraus[branch], (qubit,), n) @ state
    return out / np.linalg.norm(out)


@pytest.mark.parametrize("insertion", ["all", "gate_qubits"])
def test_forced_branches_are_the_kraus_product(insertion):
    """Uniform u picks branch b when cdf[b-1] <= u * total < cdf[b]; with
    the branch probabilities of each application known, the test chooses
    the uniforms that force a branch sequence and replays it in numpy."""
    from tpu_qsim_torch.fusion import unfused_circuit

    n = 3
    c = tq.Circuit(n).h(0).cnot(0, 1).ry(2, 0.7).cz(1, 2)
    nm = tq.NoiseModel().add_depolarizing(0.3, [0, 2]).add_amplitude_damping(0.4, 1)
    step, n_draws = build_trajectory_step(c, nm, np.float64, insertion, "cpu")
    rng = np.random.default_rng(7)
    dep = tnoise.kraus_operators(tnoise.NoiseType.DEPOLARIZING, 0.3)
    damp = tnoise.kraus_operators(tnoise.NoiseType.AMPLITUDE_DAMPING, 0.4)
    dep_cdf = np.cumsum([0.7, 0.1, 0.1, 0.1])
    for trial in range(4):
        psi = np.zeros(1 << n, complex)
        psi[0] = 1.0
        uniforms = []
        for g in unfused_circuit(c):
            psi = _full(g.matrix, g.qubits, n) @ psi
            apps = [(0, "dep"), (2, "dep"), (1, "damp")]
            if insertion == "gate_qubits":
                apps = [a for a in apps if a[0] in g.qubits]
            for q, kind in apps:
                if kind == "dep":
                    b = int(rng.integers(0, 4))
                    lo = 0.0 if b == 0 else dep_cdf[b - 1]
                    uniforms.append(lo + 0.5 * (dep_cdf[b] - lo))
                    psi = _kraus_step(psi, dep, b, q, n)
                else:
                    weights = [
                        np.linalg.norm(_full(k, (q,), n) @ psi) ** 2 for k in damp
                    ]
                    b = int(rng.integers(0, 2)) if weights[1] > 1e-9 else 0
                    cdf = np.cumsum(weights) / sum(weights)
                    lo = 0.0 if b == 0 else cdf[0]
                    uniforms.append(lo + 0.5 * (cdf[b] - lo))
                    psi = _kraus_step(psi, damp, b, q, n)
        assert len(uniforms) == n_draws
        x = tq.apply.initial_state(n, np.float64, 0, "cpu")
        got = tq.apply.to_complex(step(x, torch.tensor(uniforms, dtype=torch.float64)))
        np.testing.assert_allclose(got, psi, atol=1e-12, rtol=0)


def _ensemble_check(probs_b: np.ndarray, rho_diag: np.ndarray) -> None:
    b = probs_b.shape[0]
    mean = probs_b.mean(0)
    std = probs_b.std(0, ddof=1)
    excess = np.abs(mean - rho_diag) - (5 * std / np.sqrt(b) + 1e-6)
    assert excess.max() <= 0, (excess.max(), int(excess.argmax()))


@pytest.mark.parametrize("insertion", ["all", "gate_qubits"])
@pytest.mark.parametrize("model", ["depol_damp", "flips_dephase"])
def test_batched_ensemble_matches_exact_rho(model, insertion):
    n, batch = 4, 2000
    c, jc = _circuit(tq, n, 8, 3), _circuit(jq, n, 8, 3)
    sim = tq.BatchedSimulator(n, batch, _models(tq)[model], seed=5,
                              insertion=insertion, device="cpu").run(c)
    jdm = jdensity.DensityMatrixSimulator(n, _models(jnoise)[model], insertion=insertion)
    jdm.run(jc)
    rho = np.asarray(jdm.probabilities(), dtype=np.float64)
    _ensemble_check(sim.trajectory_probabilities().double().numpy(), rho)
    np.testing.assert_allclose(sim.average_probabilities(), rho, atol=0.05)


def test_global_channels_at_8_qubits_match_exact_rho():
    """Global channels at n = GLOBAL_SCAN_MIN: the JAX package takes its
    scan layer; the port's per-qubit loop, and the JAX trajectories, agree
    with the JAX package's exact rho."""
    n, batch = 8, 2000
    tm = tq.NoiseModel().add_depolarizing(0.3).add_amplitude_damping(0.1)
    jm = jnoise.NoiseModel().add_depolarizing(0.3).add_amplitude_damping(0.1)
    # an H layer first spreads every trajectory over the basis states; the
    # bound assumes p_b(x) far from a rare-event tail (strong damping with
    # few gates after it puts a basis state's weight in a few percent of
    # the trajectories, and the sample std then understates the spread)
    c, jc = (_h_layer_then_random(m, n, 4, 2) for m in (tq, jq))
    sim = tq.BatchedSimulator(n, batch, tm, seed=3, device="cpu").run(c)
    jdm = jdensity.DensityMatrixSimulator(n, jm, insertion="all")
    jdm.run(jc)
    rho = np.asarray(jdm.probabilities(), dtype=np.float64)
    _ensemble_check(sim.trajectory_probabilities().double().numpy(), rho)
    jsim = jnoisy.BatchedSimulator(n, batch, jm, seed=3)
    jsim.run(jc)
    _ensemble_check(np.asarray(jsim.trajectory_probabilities(), dtype=np.float64), rho)


def test_trajectory_basics():
    n = 4
    nm = tq.NoiseModel().add_depolarizing(0.2).add_amplitude_damping(0.3)
    c = tq.random_circuit(n, 20, seed=1)
    a = tq.NoisySimulator(n, nm, seed=9, device="cpu").run(c)
    b = tq.NoisySimulator(n, nm, seed=9, device="cpu").run(c)
    np.testing.assert_array_equal(a.get_state(), b.get_state())
    assert a.is_normalized(1e-5)
    g = tq.NoisySimulator(n, nm, seed=1, device="cpu").run(c, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(g.get_state(), a.get_state())
    flip = tq.NoisySimulator(n, tq.NoiseModel().add_bit_flip(1.0), device="cpu")
    flip.run(tq.Circuit(n).i(0))      # one gate: every qubit flips once
    assert flip.get_probabilities()[(1 << n) - 1] == pytest.approx(1.0)
    damp = tq.NoisySimulator(n, tq.NoiseModel().add_amplitude_damping(1.0), device="cpu")
    damp.reset((1 << n) - 1)
    damp.run(tq.Circuit(n).i(0))
    assert damp.get_probabilities()[0] == pytest.approx(1.0)
    with pytest.raises(ValueError, match="insertion"):
        tq.NoisySimulator(n, nm, insertion="every", device="cpu")
    with pytest.raises(ValueError, match="qubits"):
        a.run(tq.Circuit(n + 1).h(0))


def test_batched_readout_surface():
    n, batch = 3, 64
    sim = tq.BatchedSimulator(n, batch, seed=2, device="cpu").run(tq.ghz_circuit(n))
    assert sim.total_memory_bytes == sim.memory_bytes == batch * 2 * (1 << n) * 4
    s = sim.sample(10)
    assert tuple(s.shape) == (batch, 10)
    hist = sim.histogram(5)
    assert sum(hist.values()) == batch * 5 and set(hist) <= {0, 7}
    out = sim.measure_qubit(0)
    assert out.shape == (batch,) and out.dtype == np.int32
    np.testing.assert_array_equal(sim.measure_qubit(2), out)   # GHZ: correlated
    assert 10 < out.sum() < 54
    assert sim.total_probability() == pytest.approx(1.0, abs=1e-6)
    basis = tq.BatchedSimulator(n, 8, device="cpu")
    basis.reset(5)
    np.testing.assert_array_equal(basis.measure_qubit(0), np.ones(8))
    np.testing.assert_array_equal(basis.measure_qubit(1), np.zeros(8))
    assert basis.qubit_probability(2) == pytest.approx(1.0)
    psi = random_state(n, np.random.default_rng(4))
    basis.set_state(psi)
    np.testing.assert_allclose(basis.get_state(), np.tile(psi, (8, 1)), atol=1e-6)
    with pytest.raises(ValueError):
        tq.BatchedSimulator(n, 0, device="cpu")


def test_batched_readouts_and_checkpoints_match_jax(tmp_path):
    n, batch = 5, 32
    nm = tq.NoiseModel().add_depolarizing(0.1).add_amplitude_damping(0.2)
    sim = tq.BatchedSimulator(n, batch, nm, seed=4, device="cpu").run(tq.random_circuit(n, 20, seed=8))
    path = str(tmp_path / "batch.npz")
    sim.save_state(path)
    jsim = jnoisy.BatchedSimulator(n, batch)
    jsim.load_state(path)
    np.testing.assert_array_equal(np.asarray(jsim.state_planes), sim.state_planes.numpy())
    np.testing.assert_allclose(sim.reduced_density_matrix([0, 3]),
                               jsim.reduced_density_matrix([0, 3]), atol=1e-5, rtol=0)
    assert sim.entanglement_entropy([1]) == pytest.approx(jsim.entanglement_entropy([1]), abs=1e-4)
    psi = random_state(n, np.random.default_rng(0))
    pure = tq.StateVectorSimulator(n, device="cpu")
    pure.set_state(psi)
    jpure = jq.StateVectorSimulator(n)
    jpure.set_state(psi)
    assert sim.fidelity_with(pure) == pytest.approx(jsim.fidelity_with(jpure), abs=1e-5)
    for pauli in ("Z", "XZ", "YIIZX"):
        assert sim.expectation_pauli(pauli) == pytest.approx(jsim.expectation_pauli(pauli), abs=1e-5)
    np.testing.assert_allclose(sim.average_probabilities(),
                               np.asarray(jsim.average_probabilities()), atol=1e-6)
    # and back: the JAX package's checkpoint loads in the port
    jpath = str(tmp_path / "jbatch.npz")
    jsim.save_state(jpath)
    again = tq.BatchedSimulator(n, batch, device="cpu")
    again.load_state(jpath)
    torch.testing.assert_close(again.state_planes, sim.state_planes, atol=0, rtol=0)
    with pytest.raises(ValueError, match="batch size"):
        tq.BatchedSimulator(n, batch + 1, device="cpu").load_state(path)


def test_trajectory_circuit_carries_across():
    jc = jq.random_circuit(5, 30, seed=6)
    assert circuit_from_jax(jc).signature() == tq.random_circuit(5, 30, seed=6).signature()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: tq.NoisySimulator(4),
        lambda: tq.BatchedSimulator(4, 2),
        lambda: tq.DensityMatrixSimulator(2),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
