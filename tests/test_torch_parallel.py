"""The port's sharded simulators (``tpu_qsim_torch.parallel``) against the
JAX package's, the cases of ``tests/test_parallel.py``.

One spawn of 8 gloo CPU ranks (``torch_rank_cases.parallel_cases``) runs
every case; the JAX package's sharded simulators run on its 8 virtual
devices in this process. States match at 1e-12 (1e-11 after 30-60 gates) in
complex128, and every readout is the same on every rank. Sampled outcomes
come from ``torch.Generator`` (not ``jax.random``), so they are checked by
their support and against the port's unsharded simulators with the same
seed, which draw the same uniforms.
"""

import jax
import numpy as np
import pytest

import tpu_qsim as jq
import tpu_qsim.parallel as jpar
from tpu_qsim.noise import NoiseModel as JaxNoiseModel

import torch_rank_cases as rc
import tpu_qsim_torch as tq
import tpu_qsim_torch.parallel as par
from tpu_qsim_torch.ranks import run_ranks

JCFG = jq.SimConfig(dtype="complex128", use_pallas=False)
CFG = tq.SimConfig(dtype="complex128")


@pytest.fixture(scope="module")
def jax_sharded_16q():
    """A JAX sharded simulator's state, carried to the ranks as its gathered
    amplitudes."""
    _needs_devices()
    sim = jpar.ShardedStateVectorSimulator(16, config=JCFG, engine="collective")
    return sim.run(jq.random_circuit(16, 30, seed=9))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_sharded_16q):
    tmp = tmp_path_factory.mktemp("gloo")
    return run_ranks(rc.parallel_cases, 8, (str(tmp), jax_sharded_16q.get_state()),
                     backend="gloo", store_dir=str(tmp), timeout=300)


@pytest.fixture(scope="module")
def case(ranks):
    """``case(name)``: rank 0's result, after checking that every rank
    returned the same (a case that raised fails with its traceback)."""
    def get(name, same_on_every_rank=True):
        value = ranks[0][name]
        if isinstance(value, tuple) and value and isinstance(value[0], str) and value[0] == "error":
            pytest.fail(f"case {name} raised on rank 0:\n{value[1]}")
        if same_on_every_rank:
            for r in range(1, 8):
                _assert_same(ranks[r][name], value)
        return value

    return get


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def _needs_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def _oracle(circuit, psi0=None) -> np.ndarray:
    ora = jq.CPUReferenceSimulator(circuit.num_qubits)
    if psi0 is not None:
        ora.set_state(psi0)
    ora.run(circuit)
    return ora.get_state()


class TestShardedStateVector:
    def test_ghz_sharded_matches_jax_and_oracle(self, case):
        _needs_devices()
        engine, state, _ = case("ghz10")
        jsim = jpar.ShardedStateVectorSimulator(10, config=JCFG)
        jsim.run(jq.ghz_circuit(10))
        assert engine == jsim.engine == "gspmd"
        np.testing.assert_allclose(state, jsim.get_state(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(state, _oracle(jq.ghz_circuit(10)), atol=1e-12, rtol=0)

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_circuit_sharded(self, case, seed):
        _needs_devices()
        c = jq.random_circuit(8, 60, seed=seed)
        _, state, _ = case(f"random8_{seed}")
        jsim = jpar.ShardedStateVectorSimulator(8, config=JCFG)
        jsim.run(c)
        np.testing.assert_allclose(state, jsim.get_state(), atol=1e-11, rtol=0)
        np.testing.assert_allclose(state, _oracle(c), atol=1e-11, rtol=0)

    def test_state_is_actually_sharded(self, case):
        # each rank holds 1/8 of the amplitudes
        assert case("ghz10")[2] == (2, 1024 // 8)

    def test_measurement_and_sampling_on_sharded_state(self, case):
        samples, outcomes = case("measure")
        assert set(np.unique(samples)) <= {0, 1023}
        assert len(samples) == 200 and 0 < np.count_nonzero(samples) < 200
        assert outcomes == [outcomes[0]] * 10  # GHZ correlation

    def test_auto_engine_large_state_avoids_gspmd_replication(self, case, monkeypatch):
        _needs_devices()
        monkeypatch.setattr(jpar, "GSPMD_REPLICATION_LIMIT_BYTES", 1 << 10)
        engine, state, shape = case("auto_large")
        assert engine == jpar.ShardedStateVectorSimulator(16, config=JCFG).engine == "collective"
        assert shape == (2, (1 << 16) // 8)
        np.testing.assert_allclose(state, _oracle(jq.random_circuit(16, 40, seed=3)),
                                   atol=1e-11, rtol=0)

    def test_explicit_gspmd_above_limit_raises(self, case, monkeypatch):
        _needs_devices()
        monkeypatch.setattr(par, "GSPMD_REPLICATION_LIMIT_BYTES", 1 << 10)
        monkeypatch.setattr(jpar, "GSPMD_REPLICATION_LIMIT_BYTES", 1 << 10)
        with pytest.raises(ValueError, match="replicates the FULL") as ours:
            par.ShardedStateVectorSimulator(10, config=CFG, engine="gspmd", device="cpu")
        with pytest.raises(ValueError) as theirs:
            jpar.ShardedStateVectorSimulator(10, config=JCFG, engine="gspmd")
        assert str(ours.value) == str(theirs.value)
        # the escape hatch accepts the footprint
        assert case("allow_replication") == "gspmd"

    def test_unknown_engine(self):
        with pytest.raises(ValueError, match="engine"):
            par.ShardedStateVectorSimulator(16, engine="bogus", device="cpu")

    def test_indivisible_raises(self, case):
        outcome = case("indivisible")
        assert outcome[:2] == ("raised", "ValueError")
        assert "not divisible" in outcome[2]  # 4 amplitudes, 8 shards

    def test_no_card_raises(self, case):
        for name in ("no_card", "no_card_batched"):
            outcome = case(name)
            assert outcome[:2] == ("raised", "RuntimeError"), outcome
            assert "device='cpu'" in outcome[2]

    @pytest.mark.parametrize("n", [16, 17])
    def test_sweeps_engine_via_simulator(self, case, n):
        # block swaps between segments, each segment's gates on the
        # grid-sweep program (its plain version on the CPU, small geometry)
        engine, state, _ = case(f"sweeps_{n}q")
        assert engine == "sweeps"
        err = np.abs(state - _oracle(jq.random_circuit(n, 50, seed=4))).max()
        assert err < 5e-6


def test_state_carried_from_jax_sharded_simulator(case, jax_sharded_16q):
    # set_state takes the JAX simulator's gathered amplitudes; both packages
    # then run the same circuit
    jax_sharded_16q.run(jq.random_circuit(16, 20, seed=10))
    np.testing.assert_allclose(case("carried_from_jax"), jax_sharded_16q.get_state(),
                               atol=1e-12, rtol=0)


class TestShardedReadouts:
    """GHZ-16 on the collective engine (3 device bits), against the JAX
    package's sharded simulator."""

    @pytest.fixture(scope="class")
    def jax_ghz(self):
        _needs_devices()
        sim = jpar.ShardedStateVectorSimulator(16, config=JCFG, seed=5)
        sim.run(jq.ghz_circuit(16))
        return sim

    def test_deterministic_readouts_match_jax(self, case, jax_ghz):
        r = case("readouts")
        assert r["total_probability"] == pytest.approx(jax_ghz.total_probability(), abs=1e-12)
        np.testing.assert_allclose(r["probabilities"], jax_ghz.get_probabilities(), atol=1e-12)
        assert r["qubit_probability"] == pytest.approx(
            [jax_ghz.qubit_probability(q) for q in (0, 12, 13, 15)], abs=1e-12)
        np.testing.assert_allclose(r["rdm"], jax_ghz.reduced_density_matrix([0, 15]), atol=1e-12)
        assert r["entropy"] == pytest.approx(jax_ghz.entanglement_entropy([14, 15]), abs=1e-9)

    @pytest.mark.parametrize("pauli", rc.PAULIS)
    def test_expectation_matches_jax(self, case, jax_ghz, pauli):
        assert case("readouts")["expectation"][pauli] == pytest.approx(
            jax_ghz.expectation_pauli(pauli), abs=1e-12)

    def test_histogram_has_only_ghz_keys(self, case):
        h = case("readouts")["histogram"]
        assert set(h) <= {0, (1 << 16) - 1} and sum(h.values()) == 300

    def test_checkpoint_and_fidelity(self, case):
        r = case("readouts")
        full = np.zeros(1 << 16, complex)
        full[0] = full[-1] = 2 ** -0.5
        np.testing.assert_allclose(r["loaded"], full, atol=1e-12)
        assert r["fidelity"] == pytest.approx(1.0, abs=1e-12)
        assert r["peer_fidelity"] == pytest.approx(1.0, abs=1e-12)

    def test_measure_device_then_local_qubit(self, case):
        r = case("readouts")
        m15, m3 = r["measure"]
        assert m15 == m3
        expected = np.zeros(1 << 16, complex)
        expected[0 if m15 == 0 else -1] = 1.0
        np.testing.assert_allclose(np.abs(r["after_measure"]), np.abs(expected), atol=1e-12)

    def test_random_state_readouts_match_jax(self, case):
        n = 16
        r = case("random_state_readouts")
        jsim = jq.StateVectorSimulator(n, JCFG)
        jsim.set_state(rc.random_state(n, 7))
        jsim.run(jq.random_circuit(n, 30, seed=8))
        np.testing.assert_allclose(r["state"], jsim.get_state(), atol=1e-12, rtol=0)
        for p in rc.PAULIS:
            assert r[p] == pytest.approx(jsim.expectation_pauli(p), abs=1e-12)
        assert r["qubit_probability"] == pytest.approx(
            [jsim.qubit_probability(q) for q in range(n)], abs=1e-12)

    def test_apply_matrix_gate_and_parameterized_match_jax(self, case):
        n = 16
        after_matrix, after_params, u, params = case("matrix_and_params")
        jsim = jq.StateVectorSimulator(n, JCFG)
        jsim.run(jq.ghz_circuit(n))
        jsim.apply_matrix(u, (15, 2))
        jsim.apply_gate("ry", 14, param=0.3)
        np.testing.assert_allclose(after_matrix, jsim.get_state(), atol=1e-12, rtol=0)
        jsim.run_parameterized(jq.hardware_efficient_ansatz(n, 1), params)
        np.testing.assert_allclose(after_params, jsim.get_state(), atol=1e-11, rtol=0)


class TestShardedBatched:
    def test_matches_unsharded_same_seed(self, case):
        nm = tq.NoiseModel().add_depolarizing(0.1)
        states, outcomes, after = case("batched_same_seed")
        b = tq.BatchedSimulator(3, 16, nm, CFG, seed=7, device="cpu")
        b.run(tq.ghz_circuit(3))
        np.testing.assert_allclose(states, b.get_state(), atol=1e-12, rtol=0)
        np.testing.assert_array_equal(outcomes, b.measure_qubit(1))
        np.testing.assert_allclose(after, b.get_state(), atol=1e-12, rtol=0)

    def test_dp_tp_mesh(self, case):
        r = case("dp_tp")
        assert r["shape"] == (8 // 2, 2, (1 << 7) // 4)
        assert r["total_probability"] == pytest.approx(1.0, abs=1e-9)
        assert sum(r["histogram"].values()) == 8 * 50
        nm = tq.NoiseModel().add_bit_flip(0.05)
        b = tq.BatchedSimulator(7, 8, nm, CFG, seed=1, device="cpu")
        b.run(tq.random_circuit(7, 30, seed=4))
        np.testing.assert_allclose(r["state"], b.get_state(), atol=1e-12, rtol=0)
        np.testing.assert_allclose(r["probabilities"], b.average_probabilities(), atol=1e-12)
        np.testing.assert_allclose(r["rdm"], b.reduced_density_matrix([0, 6]), atol=1e-12)
        assert r["expectation"] == pytest.approx(b.expectation_pauli("ZIIIIIX"), abs=1e-12)

    def test_dp_tp_total_probability_matches_jax(self, case):
        _needs_devices()
        mesh = jpar.make_mesh(("dp", "tp"), (2, 4))
        jsim = jpar.ShardedBatchedSimulator(
            7, 8, JaxNoiseModel().add_bit_flip(0.05), mesh=mesh, tp_axis="tp",
            config=JCFG, seed=1)
        jsim.run(jq.random_circuit(7, 30, seed=4))
        assert case("dp_tp")["total_probability"] == pytest.approx(
            jsim.total_probability(), abs=1e-9)

    def test_bad_batch_divisibility(self, case):
        _needs_devices()
        outcome = case("batch_indivisible")
        with pytest.raises(ValueError) as theirs:
            jpar.ShardedBatchedSimulator(3, 9, None, config=JCFG)
        assert outcome == ("raised", "ValueError", str(theirs.value))


def test_ranks_import_no_jax(ranks):
    assert [r["imports"] for r in ranks] == [[]] * 8
