"""The port's native planner (tpu_qsim_torch/native) against its plain
versions and against the JAX package's planners.

* ``fusion.plan_groups`` (native) gives ``fusion._plan_groups_python``'s
  groups and ``tpu_qsim.fusion.plan_groups``'s, gate index for gate index.
* ``gridsweeps.plan_grid_sweeps`` with the native frontier scheduler gives
  the plan of its Python loop (``_frontier_sweeps_python``) and of
  ``tpu_qsim.kernels.gridsweeps.plan_grid_sweeps``, sweep by sweep and gate
  by gate in emission order, at 20-28 qubits and the card's geometries.
* ``base.counts_to_histogram`` (``np.unique``, not native) gives the
  samples' counts from int64 samples, at 34 qubits with indices past 2^31,
  in O(shots) memory, and needs no compiler.
* A failed build raises RuntimeError from every entry point that plans;
  nothing falls back to Python.

The JAX planners use the JAX package's own native library where it is
built, and its Python planner otherwise; the plans are the same either way.
"""

import subprocess
import sys
import textwrap
import tracemalloc
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_qsim as jq
from tpu_qsim.fusion import plan_groups as jax_plan_groups
from tpu_qsim.kernels import gridsweeps as jgs

import tpu_qsim_torch as tq
from tpu_qsim_torch import native
from tpu_qsim_torch.base import counts_to_histogram
from tpu_qsim_torch.convert import circuit_from_jax
from tpu_qsim_torch.fusion import _plan_groups_python, plan_groups
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels.sweeps import MAX_SWEEP_GATES

from test_torch_gridsweeps import _mixed_circuit

JAX_LANE_BITS = 7   # the JAX grid geometry's blk_bits = rb_bits + 7


# ---------------------------------------------------------------------------
# fusion groups
# ---------------------------------------------------------------------------


def _structured(name: str) -> "jq.Circuit":
    return {
        "ghz": lambda: jq.ghz_circuit(9),
        "qft": lambda: jq.qft_circuit(8),
        "toffoli": lambda: jq.Circuit(3).h(0).cnot(0, 1).toffoli(0, 1, 2),
        "repeat": lambda: jq.Circuit(1).h(0).h(0).h(0),
        "disjoint": lambda: jq.Circuit(6).h(0).h(5).cnot(2, 3).cnot(0, 5),
    }[name]()


def _assert_same_groups(jc: "jq.Circuit", max_k: int) -> None:
    pc = circuit_from_jax(jc)
    got = plan_groups(pc, max_k)
    assert got == _plan_groups_python(pc, max_k)
    assert got == jax_plan_groups(jc, max_k)


@pytest.mark.parametrize("max_k", [2, 3, 5])
@pytest.mark.parametrize("seed", range(10))
def test_plan_groups_matches_plain_and_jax(seed, max_k):
    _assert_same_groups(jq.random_circuit(8, 120, seed=seed), max_k)


@pytest.mark.parametrize("name", ["ghz", "qft", "toffoli", "repeat", "disjoint"])
def test_plan_groups_structured(name):
    _assert_same_groups(_structured(name), 5)


def test_plan_groups_empty_circuit():
    assert plan_groups(tq.Circuit(3)) == []
    assert native.plan_groups_native(3, [], 5) == []


@pytest.mark.parametrize(
    "num_qubits,gates,max_k",
    [(2, [(5,)], 5), (2, [(0,), (-1,)], 5), (64, [(0,)], 5), (2, [(0,)], 0)],
    ids=["qubit_past_n", "negative_qubit", "64_qubits", "max_k_0"],
)
def test_plan_groups_native_rejects(num_qubits, gates, max_k):
    with pytest.raises(ValueError):
        native.plan_groups_native(num_qubits, gates, max_k)



# ---------------------------------------------------------------------------
# grid sweeps
# ---------------------------------------------------------------------------


def _plain_grid_plan(monkeypatch, *args):
    with monkeypatch.context() as m:
        m.setattr(tgs, "_frontier_sweeps", tgs._frontier_sweeps_python)
        return tgs.plan_grid_sweeps(*args)


def _assert_same_sweeps(a, b) -> None:
    assert len(a) == len(b)
    for sa, sb in zip(a, b):
        assert set(sa.active) == set(sb.active)
        assert [tuple(g.qubits) for g in sa.gates] == [tuple(g.qubits) for g in sb.gates]
        for ga, gb in zip(sa.gates, sb.gates):
            np.testing.assert_array_equal(ga.u, gb.u)


GRID_CASES = [
    ("random", 20, 1), ("random", 24, 2), ("random", 28, 3), ("random", 28, 42),
    ("qft", 20, 0), ("mixed", 20, 0), ("mixed", 28, 0),
]


@pytest.mark.parametrize("max_gates", [MAX_SWEEP_GATES, tgs.NO_GATE_CAP], ids=["cap56", "nocap"])
@pytest.mark.parametrize("blk", [tgs.BLK_BITS, tgs.WIDE_BLK_BITS], ids=["blk7", "blk8"])
@pytest.mark.parametrize("name,n,seed", GRID_CASES)
def test_grid_plan_matches_plain_and_jax(monkeypatch, name, n, seed, blk, max_gates):
    jc = {
        "random": lambda: jq.random_circuit(n, 100, seed=seed),
        "qft": lambda: jq.qft_circuit(n),
        "mixed": lambda: _mixed_circuit(n),
    }[name]()
    pc = circuit_from_jax(jc)
    params = tgs.GridParams(blk, tgs.A_MAX)
    got = tgs.plan_grid_sweeps(pc, n, params, max_gates)
    _assert_same_sweeps(got, _plain_grid_plan(monkeypatch, pc, n, params, max_gates))
    jax_params = jgs.GridParams(blk - JAX_LANE_BITS, tgs.A_MAX)
    _assert_same_sweeps(got, jgs.plan_grid_sweeps(jc, n, jax_params, max_gates))


def test_grid_frontier_pulls_commuting_gate_forward():
    # gate 1 (a high-qubit H) does not fit the first sweep's active bits
    # beside gate 0; gate 2 commutes with it and rides sweep 0 ahead of it
    n, params = 12, tgs.GridParams(8, 1)
    c = tq.Circuit(n).h(10).h(11).h(0)
    sweeps = tgs.plan_grid_sweeps(c, n, params)
    assert [[g.qubits for g in s.gates] for s in sweeps] == [[(10,), (0,)], [(11,)]]
    members = native.plan_grid_sweeps_native(
        [(10,), (11,), (0,)], [(2,), (2,), (2,)], [1 << 10, 1 << 11, 0], 1, 56
    )
    assert members == [[0, 2], [1]]


def test_grid_planner_refuses_masks_past_64_qubits():
    h = tq.gates.gate_matrix("h").astype(np.complex128)
    with pytest.raises(ValueError, match="64"):
        tgs.plan_grid_sweeps([(h, (0,))], 65)


def test_grid_native_rejects_unplaceable_gate():
    with pytest.raises(ValueError):
        native.plan_grid_sweeps_native([(10, 11)], [(2, 2)], [3 << 10], 1, 56)


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------


def test_histogram_34_qubits_past_int32_in_o_shots_memory():
    rng = np.random.default_rng(34)
    shots = 200_000
    samples = np.concatenate([
        rng.integers(1 << 31, 1 << 34, size=shots // 2, dtype=np.int64),
        rng.integers(0, 1 << 34, size=shots // 4, dtype=np.int64),
        np.full(shots // 4, (1 << 34) - 1, dtype=np.int64),
    ])
    rng.shuffle(samples)
    tracemalloc.start()
    try:
        got = counts_to_histogram(samples)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert got == Counter(samples.tolist())
    assert max(got) == (1 << 34) - 1 and got[(1 << 34) - 1] >= shots // 4
    assert sum(got.values()) == shots
    # the dict and np.unique's sorted copy and counts: a few hundred bytes a shot
    assert peak < 400 * shots, peak


def test_histogram_allocates_no_bin_per_basis_state():
    """In a child interpreter whose address space is capped at 1 GiB above
    what it holds, a 34-qubit histogram (2^34 bins would be 128 GiB)."""
    code = textwrap.dedent("""
        import resource
        from collections import Counter
        import numpy as np
        from tpu_qsim_torch.base import counts_to_histogram
        vm = [l for l in open("/proc/self/status") if l.startswith("VmSize:")][0]
        cap = int(vm.split()[1]) * 1024 + (1 << 30)
        resource.setrlimit(resource.RLIMIT_AS, (cap, resource.getrlimit(resource.RLIMIT_AS)[1]))
        s = np.random.default_rng(1).integers(1 << 33, 1 << 34, size=1 << 20, dtype=np.int64)
        print(counts_to_histogram(s) == Counter(s.tolist()))
        try:
            np.zeros(1 << 34, dtype=np.int64)
        except MemoryError:
            print("capped")
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["True", "capped"]


def test_histogram_zero_shots():
    assert counts_to_histogram(np.zeros(0, dtype=np.int64)) == {}


@pytest.mark.parametrize("bins,shots", [(1, 5), (16, 10_000), (1 << 20, 3_000), (1 << 40, 50_000)])
def test_histogram_matches_np_unique(bins, shots):
    samples = np.random.default_rng(bins % 97 + shots).integers(0, bins, size=shots, dtype=np.int64)
    got = counts_to_histogram(samples)
    assert got == Counter(samples.tolist())
    assert list(got) == sorted(got)


def test_simulator_histogram_is_the_samples_counts():
    sim = tq.StateVectorSimulator(10, device="cpu").run(tq.random_circuit(10, 40, seed=5))
    hist = sim.histogram(5000, torch.Generator().manual_seed(3))
    samples = sim.sample(5000, torch.Generator().manual_seed(3)).numpy()
    assert samples.dtype == np.int64
    assert hist == Counter(samples.tolist())


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """The native module with no loaded library and an empty build directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    return tmp_path / "_build"


ENTRY_POINTS = {
    "plan_groups": lambda: plan_groups(tq.random_circuit(6, 20, seed=1)),
    "plan_grid_sweeps": lambda: tgs.plan_grid_sweeps(tq.random_circuit(20, 20, seed=1)),
    "simulator_run": lambda: tq.StateVectorSimulator(4, device="cpu").run(tq.qft_circuit(4)),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_missing_compiler_raises_without_fallback(monkeypatch, unbuilt, entry):
    monkeypatch.setattr(native, "CXX", "qsim-no-such-compiler")
    with pytest.raises(RuntimeError, match="qsim-no-such-compiler"):
        ENTRY_POINTS[entry]()
    assert native._lib is None
    assert not list(unbuilt.glob("*.so")) and not list(unbuilt.glob("*.tmp"))


def test_histogram_needs_no_compiler(monkeypatch, unbuilt):
    monkeypatch.setattr(native, "CXX", "qsim-no-such-compiler")
    assert counts_to_histogram(np.array([5, 1 << 40, 5], dtype=np.int64)) == {5: 2, 1 << 40: 1}
    assert native._lib is None


def test_failed_compile_raises_with_compiler_output(monkeypatch, unbuilt):
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-fqsim-no-such-flag",))
    with pytest.raises(RuntimeError, match="qsim-no-such-flag"):
        native.library()
    assert not list(unbuilt.iterdir())


def test_build_is_keyed_and_reused(monkeypatch, unbuilt):
    lib = native.library()
    assert native.library() is lib
    built = sorted(p.name for p in unbuilt.iterdir())
    assert built == [native.library_path().name]
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g0",))
    assert native.library_path().name not in built


def test_concurrent_builds_load_whole_libraries(tmp_path):
    """Six interpreters build into one empty directory at once; each loads
    a whole library and plans with it, and one library is left."""
    build_dir = tmp_path / "_build"
    code = textwrap.dedent(f"""
        import importlib.util
        from pathlib import Path
        spec = importlib.util.spec_from_file_location("qsim_native", {str(Path(native.__file__))!r})
        mod = importlib.util.module_from_spec(spec); spec.loader.exec_module(mod)
        mod.BUILD_DIR = Path({str(build_dir)!r})
        print(mod.plan_groups_native(3, [(0,), (0, 1), (2,)], 2))
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0] * 6, [e for _, e in outs]
    assert [o.strip() for o, _ in outs] == ["[[0, 1], [2]]"] * 6
    assert [p.suffix for p in build_dir.iterdir()] == [".so"]
