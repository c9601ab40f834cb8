"""The port's StateVectorSimulator slice on the CPU against the JAX package.

Same circuits, same seeds, n = 12..14: float32 planes within 1e-5 of the JAX
simulator (two float32 engines, 100 gates of ~1e-7 rounding each) and of the
complex128 oracle; float64 within 1e-12. Sampling is compared as
distributions (torch.Generator is not threefry). The conventions of
ROADMAP.md section C are pinned one by one.
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim_torch as tq
from tpu_qsim_torch.convert import circuit_from_jax, state_from_jax

from conftest import random_state

F32 = (tq.SimConfig(), jq.SimConfig(), 1e-5)
F64 = (tq.SimConfig(dtype="complex128"), jq.SimConfig(dtype="complex128", use_pallas=False), 1e-12)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def _port(n, cfg=tq.DEFAULT_CONFIG, **kw):
    return tq.StateVectorSimulator(n, cfg, device="cpu", **kw)


CIRCUITS = {
    "random12": lambda m: m.random_circuit(12, 100, seed=42),
    "random14": lambda m: m.random_circuit(14, 100, seed=7),
    "qft13": lambda m: m.qft_circuit(13),
    "ghz14": lambda m: m.ghz_circuit(14),
    "hea12": lambda m: m.hardware_efficient_ansatz(12, 3, seed=2),
}


@pytest.mark.parametrize("prec", ["f32", "f64"])
@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_run_matches_jax_and_oracle(name, prec):
    tcfg, jcfg, tol = F32 if prec == "f32" else F64
    tc, jc = CIRCUITS[name](tq), CIRCUITS[name](jq)
    assert tc.signature() == circuit_from_jax(jc).signature()
    sim = _port(tc.num_qubits, tcfg).run(tc)
    assert sim.engine == "torch"
    jsim = jq.StateVectorSimulator(jc.num_qubits, jcfg)
    jsim.run(jc)
    ref = tq.CPUReferenceSimulator(tc.num_qubits)
    ref.run(tc)
    got = sim.get_state()
    np.testing.assert_allclose(got, jsim.get_state(), atol=tol, rtol=0)
    np.testing.assert_allclose(got, ref.state, atol=tol, rtol=0)
    np.testing.assert_allclose(
        sim.get_probabilities(), np.asarray(jsim.get_probabilities()), atol=tol, rtol=0
    )
    for q in (0, 5, tc.num_qubits - 1):
        assert abs(sim.qubit_probability(q) - jsim.qubit_probability(q)) < tol
    for p in ("Z", "XY", "ZIZ", "YXZI", "X" * 6):
        assert abs(sim.expectation_pauli(p) - jsim.expectation_pauli(p)) < 10 * tol
    assert abs(sim.total_probability() - jsim.total_probability()) < 10 * tol
    assert sim.memory_bytes == jsim.memory_bytes


@pytest.mark.parametrize("fuse", [True, False])
def test_fusion_setting_and_renorm_agree(fuse):
    c = tq.random_circuit(12, 100, seed=3)
    a = _port(12, tq.SimConfig(dtype="complex128", fuse=fuse)).run(c).get_state()
    b = _port(12, tq.SimConfig(dtype="complex128", renorm_every=4)).run(c).get_state()
    ref = tq.CPUReferenceSimulator(12)
    ref.run(c)
    np.testing.assert_allclose(a, ref.state, atol=1e-12, rtol=0)
    np.testing.assert_allclose(b, ref.state, atol=1e-12, rtol=0)


def test_state_and_circuit_carry_across_from_jax():
    rng = np.random.default_rng(4)
    psi = random_state(12, rng)
    jc1, jc2 = jq.random_circuit(12, 60, seed=1), jq.qft_circuit(12)
    jsim = jq.StateVectorSimulator(12, F64[1])
    jsim.set_state(psi)
    jsim.run(jc1)
    planes = np.asarray(jsim.state_planes)
    st = state_from_jax(planes, "cpu")
    np.testing.assert_array_equal(st.numpy(), planes)
    sim = _port(12, F64[0])
    sim.set_state(tq.apply.to_complex(st))
    sim.run(circuit_from_jax(jc2))
    jsim.run(jc2)
    np.testing.assert_allclose(sim.get_state(), jsim.get_state(), atol=1e-12, rtol=0)
    with pytest.raises(ValueError):
        state_from_jax(planes[0], "cpu")


def test_circuit_from_jax_keeps_mcz_and_inline_matrices():
    from tpu_qsim.gates import GATE_ARITY, register_gate

    rng = np.random.default_rng(6)
    m = rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4))
    if "torch_port_fixed2" not in GATE_ARITY:
        register_gate("torch_port_fixed2", np.linalg.qr(m)[0])
    jc = jq.Circuit(5).h(0).mcz(0, 1, 2, 4).rz(3, 0.25).cp(1, 2, 0.5)
    jc.add("torch_port_fixed2", 3, 1)
    # the inverse carries the registered gate's adjoint as an inline payload,
    # which the port rebuilds without the JAX package's registry
    jc = jc.inverse()
    assert any(g.matrix_bytes is not None for g in jc)
    jc.add("s", 4)
    tc = circuit_from_jax(jc)
    assert [(g.name, g.qubits, g.param, g.matrix_bytes) for g in tc] == [
        (g.name, g.qubits, g.param, g.matrix_bytes) for g in jc
    ]
    psi = random_state(5, np.random.default_rng(8))
    ref = tq.CPUReferenceSimulator(5)
    ref.set_state(psi)
    ref.run(tc)
    jsim = jq.StateVectorSimulator(5, F64[1])
    jsim.set_state(psi)
    jsim.run(jc)
    np.testing.assert_allclose(ref.state, jsim.get_state(), atol=1e-12, rtol=0)


# ---------------------------------------------------------------------------
# conventions (ROADMAP.md section C)
# ---------------------------------------------------------------------------


def test_qubit_q_is_bit_q():
    sim = _port(6).run(tq.Circuit(6).x(3))
    assert int(np.argmax(np.abs(sim.get_state()))) == 1 << 3
    assert sim.qubit_probability(3) == pytest.approx(1.0)
    assert set(sim.histogram(50)) == {1 << 3}


def test_rightmost_pauli_char_acts_on_qubit_0():
    sim = _port(3).run(tq.Circuit(3).x(0))
    assert sim.expectation_pauli("IZ") == pytest.approx(-1.0)
    assert sim.expectation_pauli("ZI") == pytest.approx(1.0)
    assert sim.expectation_pauli("Z") == pytest.approx(-1.0)
    assert sim.expectation_pauli("") == 1.0
    with pytest.raises(ValueError):
        sim.expectation_pauli("ZZZZ")


def test_apply_matrix_qubits0_is_msb():
    cnot = np.eye(4)[[0, 1, 3, 2]]
    for cfg, jcfg in ((F32[0], F32[1]), (F64[0], F64[1])):
        sim = _port(4, cfg).run(tq.Circuit(4).x(2))
        sim.apply_matrix(cnot, (2, 0))              # control 2 (MSB), target 0
        jsim = jq.StateVectorSimulator(4, jcfg)
        jsim.run(jq.Circuit(4).x(2))
        jsim.apply_matrix(cnot, (2, 0))
        assert int(np.argmax(np.abs(sim.get_state()))) == 0b0101
        np.testing.assert_allclose(sim.get_state(), jsim.get_state(), atol=1e-7)
    with pytest.raises(ValueError, match="unitary"):
        sim.apply_matrix(np.ones((2, 2)), (0,))


def test_run_does_not_reset():
    c = tq.Circuit(5).x(1).h(4)
    sim = _port(5).run(c).run(c)
    np.testing.assert_allclose(np.abs(sim.get_state())[0], 1.0, atol=1e-6)
    sim.apply_gate("x", 0)
    assert int(np.argmax(np.abs(sim.get_state()))) == 1
    sim.reset(3)
    assert int(np.argmax(np.abs(sim.get_state()))) == 3


# ---------------------------------------------------------------------------
# sampling and measurement, as distributions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_sampling_matches_distribution(seed):
    n, shots = 5, 40000
    psi = random_state(n, np.random.default_rng(seed))
    p = np.abs(psi) ** 2
    sim = _port(n, seed=seed)
    sim.set_state(psi)
    jsim = jq.StateVectorSimulator(n, seed=seed)
    jsim.set_state(psi)
    for hist in (sim.histogram(shots), jsim.histogram(shots)):
        counts = np.array([hist.get(i, 0) for i in range(1 << n)])
        assert counts.sum() == shots
        sigma = np.sqrt(shots * p * (1 - p))
        assert np.all(np.abs(counts - shots * p) <= 5 * sigma + 1)
    assert sim.sample(7).dtype == torch.int64


def test_sampling_skips_zero_probability_states():
    sim = _port(6).run(tq.ghz_circuit(6))
    s = sim.sample(2000).numpy()
    assert set(np.unique(s)) <= {0, 63}
    assert 800 < int((s == 0).sum()) < 1200


def test_seeded_sampling_is_reproducible():
    psi = random_state(4, np.random.default_rng(2))
    runs = []
    for _ in range(2):
        sim = _port(4, seed=11)
        sim.set_state(psi)
        runs.append(sim.sample(100).numpy())
    np.testing.assert_array_equal(runs[0], runs[1])


def test_measure_qubit_collapses_bell_pairs():
    outcomes = []
    for seed in range(60):
        sim = _port(2, seed=seed).run(tq.bell_circuit())
        a = sim.measure_qubit(0)
        assert sim.is_normalized()
        assert sim.measure_qubit(1) == a
        outcomes.append(a)
    assert 15 < sum(outcomes) < 45


# ---------------------------------------------------------------------------
# device selection and errors
# ---------------------------------------------------------------------------


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.StateVectorSimulator(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.simulate(tq.bell_circuit())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_jax(np.zeros((2, 4), np.float32))


def test_simulate_matches_jax():
    c = tq.random_circuit(10, 50, seed=9)
    got = tq.simulate(c, device="cpu", dtype="complex128")
    want = jq.simulate(jq.random_circuit(10, 50, seed=9), dtype="complex128", use_pallas=False)
    np.testing.assert_allclose(got, want, atol=1e-12, rtol=0)
    hist = tq.simulate(tq.ghz_circuit(4), shots=100, device="cpu")
    assert set(hist) <= {0, 15} and sum(hist.values()) == 100


def test_argument_errors():
    with pytest.raises(ValueError):
        _port(0)
    sim = _port(3)
    with pytest.raises(ValueError):
        sim.run(tq.Circuit(4).h(0))
    with pytest.raises(ValueError):
        sim.qubit_probability(3)
    with pytest.raises(ValueError):
        sim.sample(0)
    with pytest.raises(ValueError):
        sim.set_state(np.ones(4))
