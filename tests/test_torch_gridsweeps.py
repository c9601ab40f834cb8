"""Grid-sweep engine of the port against the JAX package's.

* The port's planner gives the JAX planner's plans gate by gate.
* The port's GridSweepProgram (its plain version, on the CPU) agrees with the
  JAX grid engine in Pallas interpret mode at 13 qubits within 1e-5 (two
  float32 engines; amplitudes <= 1, ~100 gates of 1e-7 rounding each).
* The kernel's device op table, executed by a numpy mirror of
  csrc/grid_sweep.cu, agrees with the plain version and the complex128 oracle.
  The CUDA kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.apply as jap
from tpu_qsim.kernels import gridsweeps as jgs

import tpu_qsim_torch as tq
from tpu_qsim_torch.kernels import LAUNCHES, dispatch, reset_launches
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs

from conftest import random_state

N = 13
PORT_P = tgs.GridParams(blk_bits=10, a_max=2)
JAX_P = jgs.GridParams(rb_bits=3, a_max=2)      # blk_bits = 3 + 7 = 10


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def _port_circuit(c):
    from tpu_qsim_torch.convert import circuit_from_jax

    return circuit_from_jax(c)


def _mixed_circuit(n: int) -> "jq.Circuit":
    """Controls and diagonals on every kind of bit, wide swaps, 3q gates."""
    c = jq.Circuit(n)
    c.h(n - 1).h(0).toffoli(n - 1, 3, n - 2).cry(1, n - 1, 0.3)
    c.mcz(0, 5, n - 2, n - 1).swap(n - 2, n - 1).crz(n - 1, 2, 0.7)
    c.cp(n - 2, n - 1, 1.1).swap(0, n - 3).rx(n - 3, 0.4).cz(n - 1, 4)
    c.ry(n - 2, 1.3).cnot(n - 3, n - 1).t(n - 1).s(0).y(n - 2)
    return c


# ---------------------------------------------------------------------------
# planner parity
# ---------------------------------------------------------------------------


def _assert_same_plan(port_plan, jax_plan):
    assert len(port_plan) == len(jax_plan)
    for ps, js in zip(port_plan, jax_plan):
        assert ps.active == js.active
        assert len(ps.gates) == len(js.gates)
        for pg, jg in zip(ps.gates, js.gates):
            assert tuple(pg.qubits) == tuple(jg.qubits)
            np.testing.assert_array_equal(pg.u, jg.u)


@pytest.mark.parametrize("seed", range(10))
def test_plan_matches_jax_planner(seed):
    gates = 40 + 10 * seed
    c = jq.random_circuit(N, gates, seed=seed)
    jax_plan = jgs.plan_grid_sweeps(c, N, JAX_P)
    port_plan = tgs.plan_grid_sweeps(_port_circuit(c), N, PORT_P)
    _assert_same_plan(port_plan, jax_plan)


@pytest.mark.parametrize(
    "name,max_gates,balance",
    [("qft", 56, True), ("qft", 12, False), ("mixed", 56, True), ("mixed", 4, True)],
)
def test_plan_matches_jax_planner_structured(name, max_gates, balance):
    c = jq.qft_circuit(N) if name == "qft" else _mixed_circuit(N)
    jax_plan = jgs.plan_grid_sweeps(c, N, JAX_P, max_gates, True, balance)
    port_plan = tgs.plan_grid_sweeps(
        _port_circuit(c), N, PORT_P, max_gates, True, balance
    )
    _assert_same_plan(port_plan, jax_plan)


def test_overwide_gate_raises_in_both_planners():
    import tpu_qsim.gates as jg
    import tpu_qsim_torch.gates as tg

    rng = np.random.default_rng(0)
    m = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    u, _ = np.linalg.qr(m)
    for mod in (jg, tg):
        if "torch_port_dense3" not in mod.GATE_ARITY:
            mod.register_gate("torch_port_dense3", u)
    c = jq.Circuit(N).add("torch_port_dense3", 10, 11, 12)
    with pytest.raises(ValueError):
        jgs.plan_grid_sweeps(c, N, JAX_P)
    with pytest.raises(ValueError):
        tgs.plan_grid_sweeps(_port_circuit(c), N, PORT_P)


# ---------------------------------------------------------------------------
# program against the JAX grid engine (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2])
def test_program_matches_jax_grid_engine(seed):
    c = jq.random_circuit(N, 40, seed=seed)
    jprog = jgs.build_grid_sweep_run(c, np.float32, interpret=True, params=JAX_P)
    want = jap.to_complex(jprog.run(jap.initial_state(N, np.float32)))
    prog = tgs.GridSweepProgram(_port_circuit(c), PORT_P, max_gates=tgs.MAX_SWEEP_GATES)
    assert prog.num_sweeps == jprog.num_sweeps
    assert prog.active_sets == jprog.active_sets
    got = prog.run(tq.apply.initial_state(N, np.float32, device="cpu"))
    np.testing.assert_allclose(tq.apply.to_complex(got), want, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the device op table, executed by a numpy mirror of csrc/grid_sweep.cu
# ---------------------------------------------------------------------------


def emulate_sweep(re: np.ndarray, im: np.ndarray, table: fc.OpTable) -> None:
    """Apply one sweep's op table in place, CTA by CTA, as the kernel does."""
    ints, coef = table.ints, table.coef
    n_ops, blk, a, n_inact = (int(v) for v in ints[:4])
    active, inact = ints[16:16 + a], ints[32:32 + n_inact]
    size = 1 << (blk + a)
    w = coef[:, 0].astype(np.float64) + 1j * coef[:, 1]
    local = np.arange(size, dtype=np.int64)
    for cta in range(1 << n_inact):
        cta_g = sum(1 << int(p) for b, p in enumerate(inact) if (cta >> b) & 1)
        g = cta_g | (local & ((1 << blk) - 1))
        for j in range(a):
            g = g | (((local >> (blk + j)) & 1) << int(active[j]))
        s = re[g].astype(np.complex128) + 1j * im[g]
        for o in range(n_ops):
            op = ints[fc.SWEEP_HEADER + o * fc.OP_HEADER:][: fc.OP_HEADER]
            if (cta_g & int(op[5])) != int(op[6]):
                continue
            m, off = int(op[1]), int(op[2])
            codes = [int(x) for x in op[8:8 + m]]

            def bit(code, li):
                if code < fc.EXT:
                    return (li >> code) & 1
                return np.full_like(li, (cta_g >> (code - fc.EXT)) & 1)

            if op[0] == fc.KIND_DIAG:
                idx = np.zeros(size, np.int64)
                for code in codes:
                    idx = (idx << 1) | bit(code, local)
                s = s * w[off + idx]
                continue
            assert sorted(codes) == [int(x) for x in op[24:24 + m]]
            free = np.all([((local >> t) & 1) == 0 for t in codes], axis=0)
            base = local[free]
            base = base[(base & int(op[3])) == int(op[4])]
            offs = [
                sum(1 << codes[i] for i in range(m) if (j >> (m - 1 - i)) & 1)
                for j in range(1 << m)
            ]
            x = np.stack([s[base | d] for d in offs])
            y = w[off:off + (1 << 2 * m)].reshape(1 << m, 1 << m) @ x
            for j, d in enumerate(offs):
                s[base | d] = y[j]
        re[g], im[g] = s.real, s.imag


def _dense_circuit(n: int) -> "tq.Circuit":
    """3- and 4-qubit dense cores (registered in the port only), one with a
    block-local and one with an out-of-block control."""
    import tpu_qsim_torch.gates as tg

    rng = np.random.default_rng(2)
    for k in (3, 4):
        name = f"torch_port_dense{k}q"
        if name not in tg.GATE_ARITY:
            m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
            tg.register_gate(name, np.linalg.qr(m)[0])
    c = tq.Circuit(n).h(n - 1).h(n - 2)
    c.add("torch_port_dense3q", 2, n - 1, 6).add("torch_port_dense4q", 7, 1, n - 2, 4)
    c.toffoli(n - 3, 0, 5).mcz(1, 2, n - 3, n - 1).cry(n - 2, 8, 0.9)
    return c


@pytest.mark.parametrize(
    "blk,a_max", [(10, 2), (9, 3), (8, 1), (11, 2)]
)
@pytest.mark.parametrize("name", ["random", "qft", "ghz", "mixed", "dense"])
def test_op_table_emulation_matches_plain_and_oracle(name, blk, a_max):
    circuits = {
        "random": lambda: tq.random_circuit(N, 80, seed=5),
        "qft": lambda: tq.qft_circuit(N),
        "ghz": lambda: tq.ghz_circuit(N),
        "mixed": lambda: _port_circuit(_mixed_circuit(N)),
        "dense": lambda: _dense_circuit(N),
    }
    c = circuits[name]()
    prog = tgs.GridSweepProgram(c, tgs.GridParams(blk, a_max))
    psi = random_state(N, np.random.default_rng(blk * 10 + a_max))
    re, im = psi.real.copy(), psi.imag.copy()
    for table in prog.tables:
        emulate_sweep(re, im, table)
    ref = tq.CPUReferenceSimulator(N)
    ref.set_state(psi)
    ref.run(c)
    np.testing.assert_allclose(re + 1j * im, ref.state, atol=1e-6, rtol=0)
    x = torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32))
    plain = tq.apply.to_complex(prog.run_plain(x))
    np.testing.assert_allclose(plain, ref.state, atol=1e-5, rtol=0)


def test_op_table_layout():
    lay = fc.BlockLayout(n=13, blk_bits=10, active=(12,))
    assert lay.kbits == 11 and lay.inactive == (10, 11)
    assert [lay.code(q) for q in (3, 12, 11)] == [3, 10, fc.EXT + 11]
    pg = fc.as_pgates(tq.Circuit(13).toffoli(11, 3, 12).cz(11, 12).gates)
    t = fc.build_op_table(pg, lay)
    head, ops = t.ints[:fc.SWEEP_HEADER], t.ints[fc.SWEEP_HEADER:].reshape(-1, fc.OP_HEADER)
    assert list(head[:4]) == [2, 10, 1, 2]
    assert head[16] == 12 and list(head[32:34]) == [10, 11]
    # toffoli: X core on the active bit, local control on 3, ext control on 11
    assert list(ops[0, :7]) == [fc.KIND_DENSE, 1, 0, 1 << 3, 1 << 3, 1 << 11, 1 << 11]
    assert ops[0, 8] == 10
    # cz: one diagonal over an ext bit and a block bit, after the X core's 4
    assert list(ops[1, :3]) == [fc.KIND_DIAG, 2, 4]
    assert list(ops[1, 8:10]) == [fc.EXT + 11, 10]
    np.testing.assert_array_equal(t.coef[4:8], [[1, 0], [1, 0], [1, 0], [-1, 0]])


def test_op_table_rejects_moving_out_of_block():
    lay = fc.BlockLayout(n=13, blk_bits=10, active=(12,))
    with pytest.raises(ValueError, match="outside the block"):
        fc.build_op_table(fc.as_pgates(tq.Circuit(13).h(11).gates), lay)
    with pytest.raises(ValueError, match="shared memory"):
        fc.build_op_table([], fc.BlockLayout(n=20, blk_bits=12, active=(12, 13, 14)))


# ---------------------------------------------------------------------------
# wrapper, program and dispatch on the CPU
# ---------------------------------------------------------------------------


def test_cpu_program_runs_plain_version_without_launching():
    reset_launches()
    c = tq.random_circuit(N, 30, seed=4)
    prog = tgs.GridSweepProgram(c, PORT_P)
    x = tq.apply.initial_state(N, np.float32, device="cpu")
    np.testing.assert_array_equal(prog.run(x).numpy(), prog.run_plain(x).numpy())
    assert LAUNCHES["grid_sweep"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ints, coef = prog._tables_on(torch.device("cpu"))[0]
        tgs.grid_sweep(x, ints, coef, prog.layouts[0])
    with pytest.raises(ValueError, match="float32"):
        prog.run(x.double())


def test_program_bytes_and_flops():
    prog = tgs.GridSweepProgram(tq.Circuit(N).h(0).rz(1, 0.3).cnot(0, 12), PORT_P)
    assert prog.bytes_moved() == prog.num_sweeps * 16 * (1 << N)
    # h: dense 1q (16 flops/amp); rz: diagonal (6); cnot: dense 1q on half
    assert prog.flops() == (16 + 6 + 8) * (1 << N)


def test_dispatch_routing_table():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert dispatch.engine_for(20, np.float32, cuda) == "grid_sweep"
    assert dispatch.engine_for(30, np.float32, cuda) == "grid_sweep"
    assert dispatch.engine_for(19, np.float32, cuda) == "torch"
    assert dispatch.engine_for(28, np.float64, cuda) == "torch"
    assert dispatch.engine_for(28, np.float32, cpu) == "torch"


def test_dispatch_raises_for_unplaceable_circuit():
    from tpu_qsim_torch.gates import GATE_ARITY, register_gate

    rng = np.random.default_rng(1)
    m = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
    u, _ = np.linalg.qr(m)
    if "torch_port_dense6" not in GATE_ARITY:
        register_gate("torch_port_dense6", u)
    c = tq.Circuit(22).add("torch_port_dense6", 16, 17, 18, 19, 20, 21)
    with pytest.raises(NotImplementedError, match="sweeps, segmented"):
        dispatch.build_grid_run(c)
