"""The port's block-swap executor (``tpu_qsim_torch.shardmap_engine``)
against the JAX package's.

The host planners (restore ops, victim sandwich, placement simulator) give
the JAX package's output on the placements and victims of
``tests/test_shardmap.py``. The executor runs on gloo CPU ranks: one spawn of
8 ranks (``torch_rank_cases.shardmap_cases``) runs it at D = 2, 4 and 8 on
sub-groups, and each state is held against the JAX ``build_shardmap_run`` on
the 8 virtual devices and the complex128 oracle at 1e-12 in float64; the
``"kernels"`` local engine (its programs' plain versions on the CPU) against
the oracle at 1e-5 in float32. Each program's ``all_to_all`` count equals the
JAX plan's (victim segments plus restore swaps), and at 8 ranks the counts
docs/PERF_NOTES.md §15 measured for the seed-11 circuits.
"""

import random as pyrandom

import jax
import numpy as np
import pytest

import tpu_qsim as jq
import tpu_qsim.apply as jap
from tpu_qsim.parallel import make_mesh as jax_make_mesh
from tpu_qsim.schedule import plan_blockswap_segments as jax_plan_blockswap
from tpu_qsim.shardmap_engine import _Sim as JaxSim
from tpu_qsim.shardmap_engine import build_shardmap_run as jax_build_shardmap_run
from tpu_qsim.shardmap_engine import plan_restore_ops as jax_plan_restore_ops
from tpu_qsim.shardmap_engine import plan_victim_sandwich as jax_plan_victim_sandwich

import torch_rank_cases as rc
from tpu_qsim_torch.ranks import run_ranks
from tpu_qsim_torch.shardmap_engine import _Sim, plan_restore_ops, plan_victim_sandwich

N = rc.N_EXEC
CIRCUITS = ("ghz", "random0", "random1", "random2", "device_bits")
# all_to_all counts of the seed-11 circuits on 8 devices (docs/PERF_NOTES.md §15)
PERF_NOTES_EXCHANGES = {"perf_notes_16q": 8, "perf_notes_18q": 9}


def _jax_circuit(name: str, n: int = N):
    if name == "ghz":
        return jq.ghz_circuit(n)
    if name.startswith("random"):
        return jq.random_circuit(n, 80, seed=int(name[len("random"):]))
    return (jq.Circuit(n).h(n - 1).x(n - 2).cnot(n - 1, n - 3).rz(n - 2, 0.7)
            .toffoli(n - 1, n - 2, n - 3).swap(n - 3, n - 1).cry(n - 2, n - 1, 1.1))


def _psi0(name: str):
    return rc.random_state(N) if name == "device_bits" else None


def _oracle(circuit, psi0=None) -> np.ndarray:
    ora = jq.CPUReferenceSimulator(circuit.num_qubits)
    if psi0 is not None:
        ora.set_state(psi0)
    ora.run(circuit)
    return ora.get_state()


def _jax_plan_exchanges(circuit, g_bits: int) -> int:
    segs, pos = jax_plan_blockswap(circuit, g_bits)
    restore = jax_plan_restore_ops(pos, circuit.num_qubits, g_bits)
    return sum(s.victims is not None for s in segs) + sum(op[0] == "swap" for op in restore)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of one 8-rank gloo spawn."""
    store = tmp_path_factory.mktemp("gloo")
    return run_ranks(rc.shardmap_cases, 8, backend="gloo", store_dir=str(store), timeout=300)


@pytest.fixture(scope="module")
def results(ranks):
    """Rank 0's results (rank 0 is in every sub-group); a case that raised
    fails its test with the rank's traceback."""
    def get(name):
        value = ranks[0][name]
        if isinstance(value, tuple) and value and isinstance(value[0], str) and value[0] == "error":
            pytest.fail(f"case {name} raised on rank 0:\n{value[1]}")
        return value

    return get


@pytest.fixture(scope="module")
def jax_states():
    """The JAX package's shard_map executor on the 8 virtual devices."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = jax_make_mesh(("tp",))
    sharding = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, "tp"))
    out = {}
    for name in CIRCUITS:
        c = _jax_circuit(name)
        fn = jax_build_shardmap_run(c, mesh, "tp", np.float64)
        psi0 = _psi0(name)
        state = (jap.initial_state(N, np.float64) if psi0 is None
                 else jap.from_complex(psi0, np.float64))
        out[name] = jap.to_complex(fn(jax.device_put(state, sharding)))
    return out


# -- host planners ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(30))
@pytest.mark.parametrize("g", [1, 2, 3])
def test_restore_ops_equal_jax(seed, g):
    n = 7 + 2 * g + 4
    rng = pyrandom.Random(seed)
    perm = list(range(7, n))
    rng.shuffle(perm)
    qpos = tuple(list(range(7)) + perm)
    ops = plan_restore_ops(qpos, n, g)
    assert ops == jax_plan_restore_ops(qpos, n, g)
    assert sum(1 for o in ops if o[0] == "swap") <= 2
    assert sum(1 for o in ops if o[0] == "local") <= 3


def test_identity_needs_no_ops():
    assert plan_restore_ops(tuple(range(14)), 14, 3) == [] == jax_plan_restore_ops(
        tuple(range(14)), 14, 3)


@pytest.mark.parametrize("victims", [(10, 9, 8), (9, 8, 7), (10, 8, 7), (8, 10, 7)])
def test_victim_sandwich_equals_jax_and_sigma(victims):
    n, g = 14, 3
    L = n - g
    lam, lam_inv = plan_victim_sandwich(victims, L, g)
    assert (lam, lam_inv) == jax_plan_victim_sandwich(victims, L, g)
    sim = _Sim(tuple(range(n)), n, g)
    sim.local(lam)
    sim.swap()
    sim.local(lam_inv)
    expected = list(range(n))
    for j, v in enumerate(victims):
        expected[v], expected[L + j] = expected[L + j], expected[v]
    assert sim.at == expected


@pytest.mark.parametrize("seed", range(4))
def test_placement_simulator_equals_jax(seed):
    n, g = 15, 2
    L = n - g
    rng = pyrandom.Random(seed)
    ours, theirs = _Sim(tuple(range(n)), n, g), JaxSim(tuple(range(n)), n, g)
    for _ in range(12):
        if rng.random() < 0.4:
            ours.swap()
            theirs.swap()
        else:
            src = list(range(L))
            rng.shuffle(src)
            ours.local(tuple(src))
            theirs.local(tuple(src))
        assert (ours.pos, ours.at) == (theirs.pos, theirs.at)


# -- the executor on gloo ranks ------------------------------------------------

@pytest.mark.parametrize("d", rc.EXEC_WORLDS)
@pytest.mark.parametrize("name", CIRCUITS)
def test_state_matches_jax_and_oracle(results, jax_states, name, d):
    state, *_ = results(f"{name}@{d}")
    np.testing.assert_allclose(state, jax_states[name], atol=1e-12, rtol=0)
    np.testing.assert_allclose(state, _oracle(_jax_circuit(name), _psi0(name)), atol=1e-12, rtol=0)


@pytest.mark.parametrize("d", rc.EXEC_WORLDS)
@pytest.mark.parametrize("name", CIRCUITS)
def test_exchanges_equal_jax_plan(results, name, d):
    _, exchanges, planned, engines = results(f"{name}@{d}")
    assert exchanges == planned == _jax_plan_exchanges(_jax_circuit(name), d.bit_length() - 1)
    assert set(engines) == {"torch"}


@pytest.mark.parametrize("case", sorted(PERF_NOTES_EXCHANGES))
def test_perf_notes_circuits(results, case):
    nq, depth = {"perf_notes_16q": (16, 60), "perf_notes_18q": (18, 100)}[case]
    c = jq.random_circuit(nq, depth, seed=11)
    state, exchanges, planned, _ = results(case)
    assert exchanges == planned == _jax_plan_exchanges(c, 3) == PERF_NOTES_EXCHANGES[case]
    np.testing.assert_allclose(state, _oracle(c), atol=1e-12, rtol=0)


@pytest.mark.parametrize("d", rc.EXEC_WORLDS)
def test_kernels_local_engine_against_oracle(results, d):
    # 13-15 local qubits: each segment is one whole-circuit program
    c = jq.random_circuit(N, 50, seed=4)
    state, exchanges, planned, engines = results(f"kernels@{d}")
    assert set(engines) == {"whole_circuit"}
    assert exchanges == planned == _jax_plan_exchanges(c, d.bit_length() - 1)
    assert np.abs(state - _oracle(c)).max() < 1e-5


@pytest.mark.parametrize("nq", [16, 17])
def test_kernels_with_small_grid_params(results, nq):
    c = jq.random_circuit(nq, 50, seed=4)
    state, _, _, engines = results(f"grid_params_{nq}q")
    assert set(engines) == {"grid_sweep"}
    assert np.abs(state - _oracle(c)).max() < 1e-5


def test_float64_kernels_take_the_torch_engine(results):
    c = jq.random_circuit(N, 40, seed=6)
    state, _, _, engines = results("kernels_f64@8")
    assert set(engines) == {"torch"}
    np.testing.assert_allclose(state, _oracle(c), atol=1e-12, rtol=0)


@pytest.mark.parametrize("case,match", [
    ("refuse_three", "power of 2"),
    ("refuse_local_bits", "too few local bits"),
    ("refuse_engine", "unknown local_engine"),
])
def test_refusals(results, case, match):
    outcome = results(case)
    assert outcome[:2] == ("raised", "ValueError"), outcome
    assert match in outcome[2]


def test_every_group_rank_holds_the_same_state(ranks):
    for d in rc.EXEC_WORLDS:
        for r in range(1, d):
            np.testing.assert_array_equal(ranks[r][f"random1@{d}"][0], ranks[0][f"random1@{d}"][0])


def test_ranks_import_no_jax(ranks):
    assert [r["imports"] for r in ranks] == [[]] * 8
