"""Whole-circuit kernel program of the port against the JAX package's.

* ``WholeCircuitProgram`` (its plain version, on the CPU) agrees with the
  JAX whole-circuit kernel ``build_pallas_run`` in Pallas interpret mode at
  10 and 12 qubits within 2e-6 (two float32 engines; amplitudes <= 1 and
  ~1e-7 rounding per gate), on random circuits, every single-gate type on
  lane and row bits, two-qubit gates, toffoli, and 5- and 6-qubit inline
  unitaries (on lane bits).
* The program's table (``sweeps.sweep_table`` of the stages
  ``sweeps.plan_stages`` cuts over the whole state as one unit), executed by
  the numpy mirror of ``csrc/sweep.cu`` (``test_torch_sweeps.emulate_sweep``),
  agrees with the complex128 oracle within 1e-6 at three tile sizes and CTA
  counts; ``random_circuit(18, 100, seed=42)`` plans into at most 4 stages.
  The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.apply as jap
from tpu_qsim.kernels.fused_circuit import build_pallas_run

import tpu_qsim_torch as tq
from tpu_qsim_torch.convert import circuit_from_jax
from tpu_qsim_torch.kernels import LAUNCHES, reset_launches
from tpu_qsim_torch.kernels import fused_circuit as fc

from conftest import random_state
from test_torch_sweeps import emulate_sweep
from torch_threads import one_blas_thread  # noqa: F401

TOL = 2e-6


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def _unitary(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def _inline(c: "jq.Circuit", u: np.ndarray, qubits) -> "jq.Circuit":
    return c.append(jq.Gate(f"u{len(qubits)}", tuple(qubits),
                            matrix_bytes=np.ascontiguousarray(u).tobytes()))


def _both(c: "jq.Circuit", seed: int = 0):
    """(port plain version, JAX Pallas kernel) on one random initial state."""
    n = c.num_qubits
    psi = random_state(n, np.random.default_rng(seed)).astype(np.complex64)
    fn = build_pallas_run(c, np.float32, interpret=True)
    want = jap.to_complex(fn(jap.from_complex(psi, np.float32)))
    prog = fc.WholeCircuitProgram(circuit_from_jax(c))
    got = tq.apply.to_complex(prog.run(tq.apply.from_complex(psi, np.float32, "cpu")))
    return got, want


# ---------------------------------------------------------------------------
# program against the JAX whole-circuit kernel (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(10, 1), (10, 2), (12, 1), (12, 3)])
def test_program_matches_pallas_random(n, seed):
    got, want = _both(jq.random_circuit(n, 60, seed=seed), seed)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


SINGLE_GATES = [
    ("x", None), ("y", None), ("z", None), ("h", None), ("s", None),
    ("sdg", None), ("t", None), ("tdg", None), ("rx", 0.731), ("ry", 1.42),
    ("rz", 2.2), ("p", 0.3),
]


@pytest.mark.parametrize("name,param", SINGLE_GATES)
def test_single_gate_on_lane_and_row_bits(name, param):
    c = jq.Circuit(10)
    for q in (0, 3, 6, 7, 9):          # lane bits 0..6, row bits 7..9
        c.add(name, q, param=param)
    got, want = _both(c, 4)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("name,param", [
    ("cnot", None), ("cz", None), ("swap", None), ("cry", 0.9), ("crz", 1.7),
    ("cp", 0.4),
])
def test_two_qubit_gate_on_lane_and_row_bits(name, param):
    c = jq.Circuit(10)
    for pair in [(0, 1), (5, 6), (0, 9), (7, 8), (9, 2), (6, 7)]:
        c.add(name, *pair, param=param)
    got, want = _both(c, 5)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_toffoli_on_lane_and_row_bits():
    c = jq.Circuit(10).h(0).h(7)
    for trip in [(0, 1, 2), (7, 8, 9), (0, 7, 3), (9, 1, 8)]:
        c.toffoli(*trip)
    got, want = _both(c, 6)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("n,k,qubits", [
    (10, 5, (4, 0, 3, 1, 2)), (12, 6, (5, 2, 0, 4, 1, 3)),
])
def test_wide_inline_unitary(n, k, qubits):
    # on lane bits, where the JAX kernel takes the core as one 128x128 window
    # matmul: across lane and row bits its interpret mode needs minutes per
    # compile. Cores across the cluster bits are in the emulation test below.
    c = jq.random_circuit(n, 20, seed=k)
    _inline(c, _unitary(k, k), qubits)
    c.h(1).cnot(qubits[0], 9)
    got, want = _both(c, 7)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the program's table, executed by the numpy mirror of csrc/sweep.cu
# ---------------------------------------------------------------------------


def emulate_whole_circuit(psi: np.ndarray, prog: fc.WholeCircuitProgram) -> np.ndarray:
    """``psi`` after the program's one launch, as the sweep kernel runs it
    over the whole state: its ``ctas`` CTAs of ``threads`` threads, stage by
    stage (``emulate_sweep``)."""
    re, im = psi.real.copy(), psi.imag.copy()
    emulate_sweep(re, im, prog.table, prog.ctas.bit_length() - 1, prog.threads)
    return re + 1j * im


def _wide_circuit(n: int) -> tq.Circuit:
    """Dense cores of 1-6 qubits with targets on the low and the cluster
    bits, controls on both, and diagonals."""
    import tpu_qsim_torch.gates as tg

    for k in (5, 6):
        name = f"torch_whole_dense{k}"
        if name not in tg.GATE_ARITY:
            tg.register_gate(name, _unitary(k, 10 + k))
    c = tq.Circuit(n).h(n - 1).h(0).h(n - 3)
    c.add("torch_whole_dense5", n - 1, 2, n - 2, 5, 0)
    c.toffoli(n - 1, 1, n - 2).cry(2, n - 3, 0.6).mcz(0, 4, n - 2, n - 1)
    c.add("torch_whole_dense6", 1, n - 4, 3, n - 1, 4, n - 2)
    c.swap(0, n - 1).crz(n - 2, 3, 0.8).cp(n - 1, n - 4, 1.2).ry(n - 2, 0.5)
    return c


@pytest.mark.parametrize("tile_bits,ctas", [(10, 1), (9, 1), (9, 2)])
@pytest.mark.parametrize("name", ["random", "qft", "wide"])
def test_op_table_emulation_matches_oracle(name, tile_bits, ctas):
    # one tile of the whole state, or two taken by one CTA or by two
    n = 10
    c = {
        "random": lambda: tq.random_circuit(n, 80, seed=9),
        "qft": lambda: tq.qft_circuit(n),
        "wide": lambda: _wide_circuit(n),
    }[name]()
    prog = fc.WholeCircuitProgram(c, tile_bits=tile_bits, ctas=ctas)
    assert (prog.tile_bits, prog.ctas) == (tile_bits, ctas)
    psi = random_state(n, np.random.default_rng(tile_bits + ctas))
    ref = tq.CPUReferenceSimulator(n)
    ref.set_state(psi)
    ref.run(c)
    np.testing.assert_allclose(emulate_whole_circuit(psi, prog), ref.state, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# program, wrapper and op table on the CPU
# ---------------------------------------------------------------------------


def test_cpu_program_runs_plain_version_without_launching():
    reset_launches()
    prog = fc.WholeCircuitProgram(tq.random_circuit(12, 30, seed=4))
    x = tq.apply.initial_state(12, np.float32, device="cpu")
    np.testing.assert_array_equal(prog.run(x).numpy(), prog.run_plain(x).numpy())
    assert LAUNCHES["whole_circuit"] == 0
    ints, coef = prog._tables_on(torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA"):
        fc.whole_circuit(x, ints, coef, prog.tile_bits, prog.threads, prog.ctas)
    with pytest.raises(ValueError, match="float32"):
        prog.run(x.double())
    with pytest.raises(ValueError, match="shape"):
        prog.run(x[:, :1024])


def test_program_geometry_and_limits():
    # GEOMETRY: tiles of 2^T slots, 16 a thread, and the CTAs of the one
    # group (a power of two, at most the state's tiles); the table's unit is
    # the whole state, with no part bits
    for n, (t, ctas) in fc.GEOMETRY.items():
        prog = fc.WholeCircuitProgram(tq.ghz_circuit(n))
        assert 9 <= t <= min(n, 14) and ctas & (ctas - 1) == 0 and ctas <= 1 << (n - t)
        assert (prog.tile_bits, prog.ctas, prog.threads) == (t, ctas, 1 << (t - 4))
        assert prog.table.ints[1] == n and prog.table.ints[2:4].tolist() == [0, 0]
        assert prog.table.ints[5] == t
    assert sorted(fc.GEOMETRY) == list(range(10, 19))
    for bad in (9, 19):
        with pytest.raises(ValueError, match="10..18"):
            fc.WholeCircuitProgram(tq.ghz_circuit(bad))
    for t, ctas in ((8, 1), (15, 1), (12, 3)):
        with pytest.raises(ValueError, match="power of two"):
            fc.WholeCircuitProgram(tq.ghz_circuit(18), tile_bits=t, ctas=ctas)
    # no more CTAs than tiles; a tile no larger than the state
    assert fc.WholeCircuitProgram(tq.ghz_circuit(12), tile_bits=11, ctas=64).ctas == 2
    assert fc.WholeCircuitProgram(tq.ghz_circuit(10), tile_bits=12).tile_bits == 10


def test_main_path_circuit_plans_into_few_stages():
    # random_circuit(18, 100, seed=42): 50 merged ops, each a barrier-separated
    # pass in a per-op design, in at most 4 tile passes at the chosen T
    prog = fc.WholeCircuitProgram(tq.random_circuit(18, 100, seed=42))
    assert len(prog.gates) == 50 and all(st.kind == "tile" for st in prog.stages)
    assert len(prog.stages) <= 4
    assert [id(g) for st in prog.stages for g in st.gates] == [id(g) for g in prog.gates]


def test_program_bytes_and_flops():
    prog = fc.WholeCircuitProgram(tq.Circuit(12).h(0).rz(1, 0.3).cnot(0, 11))
    assert prog.bytes_moved() == 16 * (1 << 12)
    # h: two real multiplies and an add per amplitude (6 flops); rz: one
    # complex multiply (6); cnot: a permutation, no arithmetic (0)
    assert prog.flops() == (6 + 6 + 0) * (1 << 12)


@pytest.mark.parametrize("name,param,flops", [
    ("x", None, 0.0), ("cnot", None, 0.0), ("swap", None, 0.0), ("toffoli", None, 0.0),
    ("cz", None, 0.0), ("s", None, 0.0), ("t", None, 3.0), ("h", None, 6.0),
    ("rx", 0.3, 6.0), ("rz", 0.3, 6.0),
])
def test_min_flops_counts_only_needed_arithmetic(name, param, flops):
    # permutations with unit phases need no arithmetic; a general complex
    # multiply is 6 flops, a real or imaginary one 2, a complex add 2
    from tpu_qsim_torch.gates import gate_matrix

    u = gate_matrix(name) if param is None else gate_matrix(name, param)
    diag = bool(np.allclose(u, np.diag(np.diagonal(u))))
    assert fc.min_flops(u, diag) == flops


def test_min_flops_of_a_general_core():
    # every entry general: D multiplies (6 each) and D - 1 adds (2 each) per output
    u = _unitary(3, 4)
    assert fc.min_flops(u, False) == 6 * 8 + 2 * 7


def test_op_table_records_its_widest_core():
    lay = fc.BlockLayout(12, 12, ())
    t = fc.build_op_table(fc.as_pgates(tq.random_circuit(12, 40, seed=3).gates), lay, max_bits=12)
    assert t.max_core == 1                       # merged 1q cores, controlled X / Z
    wide = fc.as_pgates([(_unitary(5, 1), (0, 11, 3, 9, 5)), (_unitary(2, 2), (1, 2))])
    wt = fc.build_op_table(wide, lay, max_bits=12)
    assert wt.max_core == 5 and wt.ints[fc.HEADER_MAX_CORE] == 5   # the kernels' check
    assert fc.build_op_table(fc.as_pgates(tq.Circuit(12).rz(0, 0.1).gates), lay,
                             max_bits=12).max_core == 0


def test_op_table_takes_six_qubit_cores_and_refuses_seven():
    # since the tiled op, cores of 5 qubits and more are stored column-major
    # at an even offset, up to MAX_DENSE_QUBITS = 11; seven and more are
    # taken, and a launch geometry whose tile is too small is refused
    lay = fc.BlockLayout(12, 12, ())
    u2 = _unitary(1, 2)
    u6 = _unitary(6, 1)
    t = fc.build_op_table(fc.as_pgates([(u2, (4,)), (u6, (0, 11, 3, 9, 5, 7))]), lay,
                          max_bits=12)
    op = t.ints[fc.SWEEP_HEADER + fc.OP_HEADER:][:fc.OP_HEADER]
    assert op[0] == fc.KIND_DENSE and op[1] == 6 and op[2] == 4   # 4 of the 1q core
    assert list(op[8:14]) == [0, 11, 3, 9, 5, 7] and list(op[24:30]) == [0, 3, 5, 7, 9, 11]
    assert t.coef.shape == (4 + 64 * 64, 2)
    np.testing.assert_allclose(t.coef[4:, 0] + 1j * t.coef[4:, 1], u6.T.reshape(-1), atol=1e-7)
    # an odd offset is padded to an even one (16 bytes for cp.async)
    odd = fc.build_op_table(fc.as_pgates([tq.Circuit(12).rz(0, 0.3).gates[0],
                                          (u6, (0, 11, 3, 9, 5, 7))]), lay, max_bits=12)
    assert odd.ints[fc.SWEEP_HEADER + fc.OP_HEADER + 2] == 2
    u7 = _unitary(7, 1)
    t7 = fc.build_op_table(fc.as_pgates([(u7, tuple(range(7)))]), lay, max_bits=12)
    assert t7.max_core == 7 and t7.coef.shape == (128 * 128, 2)
    np.testing.assert_allclose(t7.coef[:, 0] + 1j * t7.coef[:, 1], u7.T.reshape(-1), atol=1e-7)
    # a tile holds two groups or more: 2^m <= 4 x threads, a power of two
    assert fc.MAX_DENSE_QUBITS == 11
    fc.check_tile(9, 128)
    with pytest.raises(ValueError, match="threads"):
        fc.check_tile(10, 128)
    with pytest.raises(ValueError, match="threads"):
        fc.check_tile(5, 96)
    with pytest.raises(ValueError, match="shared memory"):
        fc.build_op_table([], fc.BlockLayout(15, 15, ()))
