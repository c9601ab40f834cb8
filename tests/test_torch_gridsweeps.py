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


def core_matrix(w: np.ndarray, off: int, m: int) -> np.ndarray:
    """A dense op's 2^m x 2^m core from the coefficient table: row-major up
    to ``NARROW_CORE`` qubits, column-major above (ops.cuh's tiled op)."""
    u = w[off:off + (1 << 2 * m)].reshape(1 << m, 1 << m)
    return u if m <= fc.NARROW_CORE else u.T


def apply_core(s, size, targets, u, lmask, lval) -> None:
    """``s`` (one block) under the core ``u`` whose index bit k is block bit
    ``targets[k]``, on the groups whose control bits match; a core of
    ``TILE_CORE`` qubits or more as ops.cuh's tiled op multiplies it on the
    tensor cores (``test_torch_dense_op.emulate_tiled_op``)."""
    from test_torch_dense_op import emulate_tiled_op

    local = np.arange(size, dtype=np.int64)
    free = np.all([((local >> t) & 1) == 0 for t in targets], axis=0)
    base = local[free]
    base = base[(base & lmask) == lval]
    offs = [sum(1 << t for k, t in enumerate(targets) if (j >> k) & 1)
            for j in range(1 << len(targets))]
    x = np.stack([s[base | d] for d in offs])
    y = emulate_tiled_op(u, x) if len(targets) >= fc.TILE_CORE else u @ x
    for j, d in enumerate(offs):
        s[base | d] = y[j]


def emulate_sweep(re: np.ndarray, im: np.ndarray, table: fc.OpTable) -> None:
    """Apply one sweep's op table in place, CTA by CTA, as grid_sweep.cu
    does (:func:`emulate_block` for each assignment of the inactive bits)."""
    ints = table.ints
    n_inact = int(ints[3])
    inact = ints[32:32 + n_inact]
    for cta in range(1 << n_inact):
        cta_g = sum(1 << int(p) for b, p in enumerate(inact) if (cta >> b) & 1)
        emulate_block(re, im, table, cta_g)


def emulate_block(re: np.ndarray, im: np.ndarray, table: fc.OpTable, cta_g: int) -> None:
    """Apply a register table in place to the block whose share of the global
    index is ``cta_g``, as block_program.cuh's ``run_block`` does, each op as
    its descriptor (after the ops) says: a remap takes new register bits; a
    register op's descriptor must repeat its words (target as a lane bit or
    a position among the current register bits, X cores flagged as swaps, a
    diagonal's qubits packed); any other op reads its codes and core as
    ops.cuh does on shared memory."""
    ints, coef = table.ints, table.coef
    n_ops, blk, a = (int(v) for v in ints[:3])
    kbits = blk + a
    active = ints[16:16 + a]
    r = int(ints[tgs.HEADER_REG_BITS])
    assert r == tgs.REG_BITS and tgs.LANE_BITS + r <= kbits
    descs = ints[fc.SWEEP_HEADER + n_ops * fc.OP_HEADER:][:n_ops * tgs.DESC_WORDS]
    descs = descs.reshape(n_ops, tgs.DESC_WORDS)
    size = 1 << kbits
    w = coef[:, 0].astype(np.float64) + 1j * coef[:, 1]
    local = np.arange(size, dtype=np.int64)
    g = cta_g | (local & ((1 << blk) - 1))
    for j in range(a):
        g = g | (((local >> (blk + j)) & 1) << int(active[j]))
    assert not cta_g & int(np.bitwise_or.reduce(g ^ cta_g)), "the block's bits overlap cta_g"
    s = re[g].astype(np.complex128) + 1j * im[g]
    regs = [int(x) for x in ints[tgs.HEADER_REGS:tgs.HEADER_REGS + r]]
    for o in range(n_ops):
        op = ints[fc.SWEEP_HEADER + o * fc.OP_HEADER:][: fc.OP_HEADER]
        d = descs[o]
        assert regs == sorted(set(regs)) and len(regs) == r
        assert all(tgs.LANE_BITS <= b < kbits for b in regs)
        if op[0] == tgs.KIND_REMAP:
            assert op[1] == r and list(d) == [tgs.D_REMAP] + [0] * 7
            regs = [int(x) for x in op[8:8 + r]]
            continue
        assert list(d[1:6]) == [int(x) for x in op[2:7]]
        if (cta_g & int(d[4])) != int(d[5]):
            continue
        m, off = int(op[1]), int(op[2])
        codes = [int(x) for x in op[8:8 + m]]

        def bit(code, li):
            if code < fc.EXT:
                return (li >> code) & 1
            return np.full_like(li, (cta_g >> (code - fc.EXT)) & 1)

        if op[0] == fc.KIND_DIAG:
            assert d[0] == tgs.D_REG | tgs.D_DIAG | (tgs.D_WIDE_DIAG if m > 2 else 0)
            if m <= 2:
                assert d[7] == m | codes[0] << 8 | codes[-1] << 16
            idx = np.zeros(size, np.int64)
            for code in codes:
                idx = (idx << 1) | bit(code, local)
            s = s * w[off + idx]
            continue
        if d[0] & tgs.D_REG:
            assert m <= tgs.REG_CORE
            u = w[off:off + 4].reshape(2, 2)
            swap = np.array_equal(u, [[0, 1], [1, 0]])
            lane = bool(d[0] & tgs.D_LANE)
            assert d[0] == tgs.D_REG | (tgs.D_SWAP if swap else 0) | (tgs.D_LANE if lane else 0)
            target = int(d[6]) if lane else regs[int(d[6])]
            assert (target < tgs.LANE_BITS) == lane and [target] == codes
            targets = [target]
        else:
            assert d[0] == 0
            if m <= fc.SORTED_WORDS:
                assert sorted(codes) == [int(x) for x in op[24:24 + m]]
            targets = codes[::-1]
            u = core_matrix(w, off, m)
        apply_core(s, size, targets, u, int(op[3]), int(op[4]))
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
    # h: two real multiplies and an add per amplitude (6 flops); rz: one
    # complex multiply (6); cnot: a permutation, no arithmetic (0)
    assert prog.flops() == (6 + 6 + 0) * (1 << N)


def test_dispatch_routing_table():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for n in range(10, 19):
        assert dispatch.engine_for(n, np.float32, cuda) == "whole_circuit"
    assert dispatch.engine_for(19, np.float32, cuda) == "segmented"
    assert dispatch.engine_for(20, np.float32, cuda) == "grid_sweep"
    assert dispatch.engine_for(30, np.float32, cuda) == "grid_sweep"
    assert dispatch.engine_for(9, np.float32, cuda) == "torch"
    assert dispatch.engine_for(16, np.float64, cuda) == "torch"
    assert dispatch.engine_for(28, np.float64, cuda) == "torch"
    assert dispatch.engine_for(28, np.float32, cpu) == "torch"
    assert dispatch.engine_for(14, np.float32, cpu) == "torch"


def _unplaceable(n: int) -> "tq.Circuit":
    """A dense 6-qubit gate on the top six qubits: more moving high qubits
    than a grid sweep's active budget of 5."""
    from tpu_qsim_torch.gates import GATE_ARITY, register_gate

    rng = np.random.default_rng(1)
    m = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
    u, _ = np.linalg.qr(m)
    if "torch_port_dense6" not in GATE_ARITY:
        register_gate("torch_port_dense6", u)
    return tq.Circuit(n).add("torch_port_dense6", *range(n - 6, n))


def test_dispatch_raises_for_unplaceable_circuit():
    # a 7-qubit dense core on the top seven qubits: the grid planner and the
    # sweep planner refuse it, and since the wide-core op the segmented
    # engine takes it (a 14-bit block holds 7 + 7 bits); before, its op
    # table raised NotImplementedError
    from tpu_qsim_torch.gates import GATE_ARITY, register_gate
    from tpu_qsim_torch.kernels.sweeps import SweepProgram

    rng = np.random.default_rng(2)
    m = rng.standard_normal((128, 128)) + 1j * rng.standard_normal((128, 128))
    if "torch_port_dense7" not in GATE_ARITY:
        register_gate("torch_port_dense7", np.linalg.qr(m)[0])
    c = tq.Circuit(22).add("torch_port_dense7", *range(15, 22))
    with pytest.raises(ValueError):
        tgs.GridSweepProgram(c)
    with pytest.raises(ValueError):
        SweepProgram(c)
    engine, prog = dispatch._plan_piece(c, "grid_sweep")     # the row's engines
    assert engine == "segmented" and prog.local_bits == fc.MAX_BLOCK_BITS
    assert max(s.table.max_core for s in prog.steps) == 7
    # from 22q the route cuts at the refused gate instead of the segments
    # (dispatch.GRID_CUTS): here the circuit is that one gate, a pass
    engine, prog = dispatch.plan_run(c, np.float32, torch.device("cuda"))
    assert engine == "dense_pass" and prog.steps[0].targets == tuple(range(15, 22))


def test_dispatch_routes_unplaceable_circuit_to_segmented():
    # the grid planner refuses the circuit; the row's engines route it to
    # the segmented engine, the JAX package's final fallback up to 26q, and
    # from 22q the route cuts at the refused gate instead (the split beat
    # the segments there, dispatch.GRID_CUTS): a pass, its core widened
    c = _unplaceable(22)
    with pytest.raises(ValueError):
        tgs.GridSweepProgram(c)
    engine, prog = dispatch._plan_piece(c, "grid_sweep")
    assert engine == "segmented" and prog.num_segments >= 1
    assert prog.local_bits >= 13                 # room for 6 relocated qubits
    engine, prog = dispatch.plan_run(c, np.float32, torch.device("cuda"))
    assert engine == "dense_pass" and prog.steps[0].targets == (0, *range(16, 22))


def test_dispatch_unplaceable_above_segmented_range_takes_torch_engine():
    # above 26q the JAX package takes its XLA engine, and so did the port's
    # row (its torch engine) until the grid row cut at refused gates: the
    # row's engines alone still give the circuit to the torch engine, and
    # the route runs the gate as a dense pass (its 6-qubit core widened)
    c = _unplaceable(28)
    assert dispatch._plan_piece(c, "grid_sweep") == ("torch", None)
    engine, prog = dispatch.plan_run(c, np.float32, torch.device("cuda"))
    assert engine == "dense_pass" and prog.engines == ["dense_pass"]
    assert prog.steps[0].targets == (0, *range(22, 28))


@pytest.mark.parametrize("n,engine", [
    (9, "torch"), (10, "whole_circuit"), (13, "whole_circuit"), (18, "whole_circuit"),
    (19, "segmented"), (20, "grid_sweep"), (22, "grid_sweep"),
])
def test_dispatch_plans_the_engine_of_the_table(n, engine):
    from tpu_qsim_torch.kernels.fused_circuit import WholeCircuitProgram
    from tpu_qsim_torch.kernels.segmented import SegmentedProgram

    got, prog = dispatch.plan_run(tq.ghz_circuit(n), np.float32, torch.device("cuda"))
    assert got == engine
    kind = {"torch": type(None), "whole_circuit": WholeCircuitProgram,
            "segmented": SegmentedProgram, "grid_sweep": tgs.GridSweepProgram}[engine]
    assert isinstance(prog, kind)
    got, prog = dispatch.plan_run(tq.ghz_circuit(n), np.float32, torch.device("cpu"))
    assert (got, prog) == ("torch", None)
