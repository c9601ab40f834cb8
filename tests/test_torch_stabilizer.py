"""The port's stabilizer simulator (``tpu_qsim_torch.stabilizer``) against
the JAX package's: random Clifford circuits from a seed give the same
tableau, the same Pauli expectations and probabilities, and, with the same
seed (numpy's ``default_rng`` in both), the same measurement outcomes,
samples and histograms; the port's expectations also match its own
state-vector simulator (1e-6)."""

import numpy as np
import pytest

import tpu_qsim as jq
from tpu_qsim.stabilizer import CliffordCircuit as JaxClifford
from tpu_qsim.stabilizer import StabilizerSimulator as JaxStabilizer

import tpu_qsim_torch as tq
from tpu_qsim_torch.stabilizer import CLIFFORD_GATES, CliffordCircuit, StabilizerSimulator

CLIFFORD_1Q = ["i", "x", "y", "z", "h", "s", "sdg"]
CLIFFORD_2Q = ["cnot", "cz", "swap"]


def random_clifford(pkg, n: int, num_gates: int, seed: int):
    rng = np.random.default_rng(seed)
    c = pkg.Circuit(n)
    for _ in range(num_gates):
        if n >= 2 and rng.random() < 0.4:
            a, b = rng.choice(n, size=2, replace=False)
            c.add(str(rng.choice(CLIFFORD_2Q)), int(a), int(b))
        else:
            c.add(str(rng.choice(CLIFFORD_1Q)), int(rng.integers(n)))
    return c


def both(n: int, num_gates: int, seed: int, sim_seed: int = 0):
    ours = StabilizerSimulator(n, seed=sim_seed).run(random_clifford(tq, n, num_gates, seed))
    theirs = JaxStabilizer(n, seed=sim_seed).run(random_clifford(jq, n, num_gates, seed))
    return ours, theirs


def assert_same_tableau(a, b):
    np.testing.assert_array_equal(a.x, b.x)
    np.testing.assert_array_equal(a.z, b.z)
    np.testing.assert_array_equal(a.r, b.r)


@pytest.mark.parametrize("seed", range(6))
def test_random_clifford_tableau_and_expectations(seed):
    n = 5
    ours, theirs = both(n, 40, seed)
    assert_same_tableau(ours, theirs)
    rng = np.random.default_rng(1000 + seed)
    sv = tq.StateVectorSimulator(n, tq.SimConfig(dtype="complex128"), device="cpu")
    sv.run(random_clifford(tq, n, 40, seed))
    for _ in range(10):
        pauli = "".join(rng.choice(list("IXYZ"), size=n))
        got = ours.expectation_pauli(pauli)
        assert got == theirs.expectation_pauli(pauli)
        assert got == pytest.approx(sv.expectation_pauli(pauli), abs=1e-6)
    assert [ours.qubit_probability(q) for q in range(n)] == [
        theirs.qubit_probability(q) for q in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_measurements_equal_for_the_same_seed(seed):
    n = 6
    ours, theirs = both(n, 50, 20 + seed, sim_seed=seed)
    order = np.random.default_rng(seed).permutation(n)
    assert [ours.measure_qubit(int(q)) for q in order] == [
        theirs.measure_qubit(int(q)) for q in order]
    assert_same_tableau(ours, theirs)


@pytest.mark.parametrize("seed", range(3))
def test_samples_and_histograms_equal_for_the_same_seed(seed):
    ours, theirs = both(5, 30, 40 + seed, sim_seed=seed)
    np.testing.assert_array_equal(ours.sample(64), theirs.sample(64))
    assert ours.histogram(200, seed=3) == theirs.histogram(200, seed=3)


def test_wide_ghz_and_inverse_round_trip():
    n = 100   # beyond the amplitude engines' 30 qubits
    ours = StabilizerSimulator(n, seed=3).run(CliffordCircuit.ghz(n))
    theirs = JaxStabilizer(n, seed=3).run(JaxClifford.ghz(n))
    assert_same_tableau(ours, theirs)
    np.testing.assert_array_equal(ours.sample(3), theirs.sample(3))
    rng = np.random.default_rng(5)
    cc = CliffordCircuit(64)
    for _ in range(200):
        g = ["h", "s", "sdg", "x", "y", "z", "cnot", "cz", "swap"][int(rng.integers(0, 9))]
        if g in ("cnot", "cz", "swap"):
            cc.add(g, *(int(v) for v in rng.choice(64, size=2, replace=False)))
        else:
            cc.add(g, int(rng.integers(0, 64)))
    stab = StabilizerSimulator(64, seed=1).run(cc).run(cc.inverse())
    assert [stab.qubit_probability(q) for q in (0, 17, 63)] == [0.0] * 3


@pytest.mark.parametrize("make", [
    lambda pkg, C: C(3).add("t", 0),
    lambda pkg, C: C(3).add("cnot", 0),
    lambda pkg, C: C(3).add("h", 3),
    lambda pkg, C: C(3).add("swap", 1, 1),
    lambda pkg, C: C.from_circuit(pkg.Circuit(2).h(0).rz(1, 0.3)),
])
def test_refusals_equal_jax(make):
    with pytest.raises(ValueError) as ours:
        make(tq, CliffordCircuit)
    with pytest.raises(ValueError) as theirs:
        make(jq, JaxClifford)
    assert str(ours.value) == str(theirs.value)


def test_non_clifford_gate_rejected_like_jax():
    with pytest.raises(ValueError) as ours:
        StabilizerSimulator(2).run(tq.Circuit(2).t(0))
    with pytest.raises(ValueError) as theirs:
        JaxStabilizer(2).run(jq.Circuit(2).t(0))
    assert str(ours.value) == str(theirs.value)


def test_gate_set_and_exports():
    assert CLIFFORD_GATES == {"i", "x", "y", "z", "h", "s", "sdg", "cnot", "cz", "swap"}
    assert tq.CliffordCircuit is CliffordCircuit and tq.StabilizerSimulator is StabilizerSimulator
