"""Dense cores wider than six qubits in every kernel of the port, and the
grid-fallback routes they open.

* ``build_op_table`` takes cores of up to ``MAX_DENSE_QUBITS`` = 11 qubits,
  those of 5 and more column-major for ops.cuh's tiled op; a wider core, or
  one that a kernel's block cannot hold, is refused, naming the limit. The tables, executed by the numpy mirrors of the
  whole-circuit, grid-sweep, segment and sweep kernels, agree with the JAX
  package's complex128 oracle within 1e-5, a controlled wide core included.
* Dispatch plans every circuit that the JAX package plans with such a gate
  (sweeps, grid sweep or segmented), and raises a ValueError naming each
  refusal for a circuit that no engine in reach takes (one the JAX package
  cannot run either).
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.circuit import Gate
from tpu_qsim_torch.kernels import dispatch
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import segmented as seg
from tpu_qsim_torch.kernels import sweeps as ts

from conftest import random_state
from test_torch_gridsweeps import emulate_sweep as emulate_grid_sweep
from test_torch_segmented import emulate_segments
from test_torch_sweeps import register_both, emulate_sweep, jax_oracle
from test_torch_whole_circuit import emulate_whole_circuit
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-5
CUDA = torch.device("cuda")


def _dense(k: int, controls: int = 0) -> str:
    """A random k-qubit unitary under ``controls`` MSB controls, registered
    in both packages."""
    name = f"torch_wide_dense{k}" + (f"_c{controls}" if controls else "")
    if name in tq.gates.GATE_ARITY:     # registered in both (register_both)
        return name
    rng = np.random.default_rng(100 + 10 * k + controls)
    m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
    u = np.eye(1 << (k + controls), dtype=np.complex128)
    u[-(1 << k):, -(1 << k):] = np.linalg.qr(m)[0]
    register_both(name, u)
    return name


def _between_random(n: int, *gates, seed: int = 3) -> tq.Circuit:
    """``gates`` ((name, qubits) pairs) between two random layers."""
    c = tq.random_circuit(n, 30, seed=seed)
    for name, qubits in gates:
        c.add(name, *qubits)
    for g in tq.random_circuit(n, 30, seed=seed + 1).gates:
        c.append(g)
    return c


# ---------------------------------------------------------------------------
# the op table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [7, 8])
def test_op_table_takes_wide_cores_column_major(k):
    lay = fc.BlockLayout(12, 12, ())
    qubits = (11, 0, 7, 3, 9, 1, 5, 2)[:k]
    u = tq.gates.gate_matrix(_dense(k))
    t = fc.build_op_table(fc.as_pgates([(u, qubits)]), lay, max_bits=12)
    op = t.ints[fc.SWEEP_HEADER:fc.SWEEP_HEADER + fc.OP_HEADER]
    assert op[0] == fc.KIND_DENSE and op[1] == k and t.max_core == k
    assert list(op[8:8 + k]) == list(qubits) and list(op[24:24 + k]) == sorted(qubits)
    np.testing.assert_allclose(t.coef[:, 0] + 1j * t.coef[:, 1], u.T.reshape(-1), atol=1e-7)
    assert t.ints[fc.HEADER_MAX_CORE] == k


@pytest.mark.parametrize("case", ["core9", "core10", "segments", "controls", "core12"])
def test_core_past_the_limit_raises_naming_it(case):
    # since the tiled op, cores of 9 and 10 qubits plan on the whole-circuit
    # kernel at 12 qubits and match the JAX package's oracle (planned
    # directly: the route by width sends a 10-qubit core to the dense
    # pass); what is refused, naming the limit, is a core wider than a
    # kernel's block (a segment keeps 5 of its at most 14 bits in place)
    assert fc.MAX_DENSE_QUBITS == 11
    n = 12
    if case in ("core9", "core10"):
        k, qubits = {"core9": (9, (11, 0, 7, 3, 9, 1, 5, 2, 10)),
                     "core10": (10, tuple(range(2, 12)))}[case]
        c = _between_random(n, (_dense(k), qubits))
        prog = fc.WholeCircuitProgram(c)
        assert prog.table.max_core == k
        psi = random_state(n, np.random.default_rng(k))
        np.testing.assert_allclose(emulate_whole_circuit(psi, prog), jax_oracle(c, psi),
                                   atol=TOL, rtol=0)
    elif case == "segments":
        wide = tq.Circuit(15).add(_dense(10), *range(5, 15))
        with pytest.raises(ValueError, match="a 10-qubit gate needs local_bits >= 15"):
            seg.SegmentedProgram(wide)
    elif case == "controls":
        # controls peel off: a 9-qubit gate with an 8-qubit core is taken
        ok = tq.Circuit(n).add(_dense(8, controls=1), *range(9))
        engine, prog = dispatch.plan_run(ok, np.float32, CUDA)
        assert engine == "whole_circuit" and prog.table.max_core == 8
    else:
        # a 12-qubit core on qubits 0-11 of 16 (the JAX package runs it with
        # _emit_gate_generic): the tiled op streams whole columns of the core
        # through a 16 KB panel, so the op table refuses cores wider than
        # MAX_DENSE_QUBITS = 11, and dispatch splits the circuit there: the
        # gate is a whole-state dense pass between whole-circuit launches, and
        # the run matches the oracle (the core a product of random 1-qubit
        # unitaries: dense, and cheaper to make than a QR; carried inline,
        # since a registry's unitarity check of 4096 x 4096 takes seconds)
        rng = np.random.default_rng(12)
        u12 = np.ones((1, 1), np.complex128)
        for _ in range(12):
            m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
            u12 = np.kron(u12, np.linalg.qr(m)[0])
        wide12 = tq.random_circuit(16, 30, seed=3)
        wide12.append(Gate("torch_wide_kron12", tuple(range(12)), matrix_bytes=u12.tobytes()))
        wide12.extend(tq.random_circuit(16, 30, seed=4).gates)
        with pytest.raises(ValueError, match="at most MAX_DENSE_QUBITS = 11"):
            fc.build_op_table(fc.as_pgates(wide12.gates), fc.BlockLayout(16, 16, ()),
                              max_bits=16)
        engine, prog = dispatch.plan_run(wide12, np.float32, CUDA)
        assert engine == "whole_circuit+dense_pass"
        assert prog.engines == ["whole_circuit", "dense_pass", "whole_circuit"]
        psi = random_state(16, np.random.default_rng(16))
        got = tq.apply.to_complex(prog.run(tq.apply.from_complex(psi, np.float32, "cpu")))
        np.testing.assert_allclose(got, jax_oracle(wide12, psi), atol=TOL, rtol=0)


def test_whole_circuit_refuses_a_cluster_wider_than_the_core_groups():
    # an 8-qubit core at 10 qubits has 4 groups; the tiled op deals its tiles
    # to the launch's CTAs in turn, so 2 CTAs of 2^9-slot tiles take it (a
    # CTA without a tile waits at the barrier), each with the 64 threads the
    # core's tile needs, twice the tile's 32. The cluster kernel that could
    # be placed wider than the groups is gone; what is refused now is a
    # geometry outside the register program (tiles of 2^9..2^14 slots) or a
    # CTA count that is not a power of two
    c = _between_random(10, (_dense(8), tuple(range(8))))
    prog = fc.WholeCircuitProgram(c, tile_bits=9, ctas=2)
    assert prog.table.max_core == 8 and (prog.ctas, prog.threads) == (2, 64)
    psi = random_state(10, np.random.default_rng(8))
    np.testing.assert_allclose(emulate_whole_circuit(psi, prog), jax_oracle(c, psi),
                               atol=TOL, rtol=0)
    for t, ctas in ((8, 2), (9, 3)):
        with pytest.raises(ValueError, match="power of two"):
            fc.WholeCircuitProgram(c, tile_bits=t, ctas=ctas)


# ---------------------------------------------------------------------------
# the tables through each kernel's numpy mirror
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile_bits,ctas", [(11, 1), (9, 4)])
@pytest.mark.parametrize("k,controls", [(7, 0), (8, 0), (7, 1)])
def test_whole_circuit_emulation(k, controls, tile_bits, ctas):
    n = 11
    qubits = (10, 2, 9, 0, 5, 8, 1, 4, 6)[:k + controls]
    c = _between_random(n, (_dense(k, controls), qubits))
    prog = fc.WholeCircuitProgram(c, tile_bits=tile_bits, ctas=ctas)
    assert prog.table.max_core == k and any(st.kind == "unit" for st in prog.stages)
    psi = random_state(n, np.random.default_rng(k))
    np.testing.assert_allclose(emulate_whole_circuit(psi, prog), jax_oracle(c, psi),
                               atol=TOL, rtol=0)


# the parent's whole-circuit route (a cluster of CTAs of these threads) took
# cores of up to min(n, 11, log2(4 x threads)) qubits
PARENT_THREADS = {10: 512, 11: 512, 12: 512, 13: 512, 14: 256, 15: 256, 16: 512,
                  17: 1024, 18: 1024}


@pytest.mark.parametrize("n", sorted(PARENT_THREADS))
def test_whole_circuit_takes_every_core_it_took(n):
    # every core width the cluster kernel's geometry took still plans, on the
    # lowest and the highest qubits, as a unit stage whose CTAs have the
    # threads its tiled op needs (the program planned directly: the route by
    # width sends cores of 10 and 11 qubits to the dense pass); at 10 qubits
    # the widest run through the mirror against the oracle
    from tpu_qsim_torch.kernels.time_run import kron_gate

    kmax = min(n, fc.MAX_DENSE_QUBITS, (4 * PARENT_THREADS[n]).bit_length() - 1)
    for k in range(fc.TILE_CORE, kmax + 1):
        for lo in (0, n - k):
            gate = kron_gate(tuple(range(lo, lo + k)), seed=k)
            c = tq.Circuit(n).h(0).cnot(0, n - 1).append(gate).h(n - 1)
            prog = fc.WholeCircuitProgram(c)
            assert prog.table.max_core == k
            assert (1 << k) <= 4 * prog.threads <= 4 * ts.WIDE_THREADS
            assert [st.kind for st in prog.stages].count("unit") == 1
            if n == 10 and k >= 9 and lo == 0:
                assert prog.threads > 1 << (prog.tile_bits - 4)     # spare threads
                psi = random_state(n, np.random.default_rng(k))
                ref = tq.CPUReferenceSimulator(n)
                ref.set_state(psi)
                ref.run(c)
                np.testing.assert_allclose(emulate_whole_circuit(psi, prog), ref.state,
                                           atol=TOL, rtol=0)


@pytest.mark.parametrize("k,controls,lo", [(7, 0, 0), (8, 0, 0), (7, 1, 1)])
def test_grid_sweep_emulation(k, controls, lo):
    # the core on the block bits 0..7, a control on a high bit (12)
    n = 13
    qubits = ((12,) if controls else ()) + tuple(range(lo, lo + k))
    c = _between_random(n, (_dense(k, controls), qubits))
    prog = tgs.GridSweepProgram(c)
    assert max(t.max_core for t in prog.tables) == k
    psi = random_state(n, np.random.default_rng(k + 1))
    re, im = psi.real.copy(), psi.imag.copy()
    for table in prog.tables:
        emulate_grid_sweep(re, im, table)
    np.testing.assert_allclose(re + 1j * im, jax_oracle(c, psi), atol=TOL, rtol=0)


@pytest.mark.parametrize("qubits", [(14, 3, 12, 0, 9, 7, 13), (8, 9, 10, 11, 12, 13, 14)])
def test_segment_emulation(qubits):
    # a 7-qubit gate needs a block of SWAP_MIN + 7 = 14 bits, the most a
    # segment holds (the planner makes every qubit of a gate local, controls
    # too): 15 qubits give two blocks
    n = 15
    c = _between_random(n, (_dense(7), qubits))
    prog = seg.SegmentedProgram(c)
    assert prog.local_bits == fc.MAX_BLOCK_BITS
    assert max(s.table.max_core for s in prog.steps) == 7
    psi = random_state(n, np.random.default_rng(7))
    np.testing.assert_allclose(emulate_segments(psi, prog), jax_oracle(c, psi), atol=TOL, rtol=0)


def test_segments_hold_no_core_wider_than_seven():
    # by default a plan keeps 7 low bits in place; a gate wider than the rest
    # of the block lowers that to as few as 5, so since the fault-1 repair a
    # segment holds cores of up to 9 qubits: an 8-qubit core on 7-14 of 15
    # keeps 6 bits in place and matches the oracle
    n = 15
    assert seg.SegmentedProgram(tq.random_circuit(n, 30, seed=1)).swap_min == 7
    c = _between_random(n, (_dense(8), tuple(range(7, 15))))
    prog = seg.SegmentedProgram(c)
    assert (prog.local_bits, prog.swap_min) == (14, 6)
    assert max(s.table.max_core for s in prog.steps) == 8
    psi = random_state(n, np.random.default_rng(8))
    np.testing.assert_allclose(emulate_segments(psi, prog), jax_oracle(c, psi), atol=TOL, rtol=0)


@pytest.mark.parametrize("group_bits", [0, 1])
@pytest.mark.parametrize("k,controls", [(7, 0), (8, 0), (7, 1)])
def test_sweep_emulation(k, controls, group_bits):
    # SweepParams(2, 2): low block bits 0..9, high block 0..8 + tops 10, 11;
    # the core on low bits, a control on a top bit (11)
    n = 12
    qubits = ((11,) if controls else ()) + (8, 1, 6, 0, 5, 2, 7, 4)[:k]
    c = _between_random(n, (_dense(k, controls), qubits), ("h", (11,)), ("cnot", (10, 3)))
    prog = ts.SweepProgram(c, ts.SweepParams(k_bits=2, rb_bits=2))
    assert max(t.max_core for t in prog.tables) == k
    psi = random_state(n, np.random.default_rng(k + 2))
    re, im = psi.real.copy(), psi.imag.copy()
    for table in prog.tables:
        emulate_sweep(re, im, table, group_bits)
    np.testing.assert_allclose(re + 1j * im, jax_oracle(c, psi), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# dispatch: each row of the fault's table, now planned
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,lo,engine", [
    (22, 6, 8, "sweeps"),        # the port's grid (blk 8, 5 active bits) refuses
    (22, 7, 8, "sweeps"),
    (24, 7, 12, "sweeps"),       # low + high sweeps
    (26, 8, 10, "sweeps"),
    (26, 7, 0, "grid_sweep"),    # the core on block bits, the wide instance
    (22, 7, 15, "segmented"),    # grid and sweeps refuse (mid + top)
])
def test_dispatch_plans_wide_core_circuits(n, k, lo, engine):
    # the row's engines plan the whole circuit; the route cuts it instead
    # where the grid row's split measured faster (dispatch.GRID_CUTS: a
    # 7-qubit core the grid takes, and a gate it refuses in place of the
    # segments, from 22q)
    c = tq.Circuit(n).h(0).add(_dense(k), *range(lo, lo + k)).cnot(0, n - 1)
    route, _ = dispatch.plan_run(c, np.float32, CUDA)
    assert route == (engine if engine == "sweeps" else "grid_sweep+dense_pass")
    got, prog = dispatch._plan_piece(c, dispatch.engine_for_size(n))
    assert got == engine
    kind = {"sweeps": ts.SweepProgram, "grid_sweep": tgs.GridSweepProgram,
            "segmented": seg.SegmentedProgram}[engine]
    assert isinstance(prog, kind)
    tables = [s.table for s in prog.steps] if engine == "segmented" else prog.tables
    assert max(t.max_core for t in tables) == k


def test_dispatch_raises_when_every_engine_refuses():
    """Fault 1 repaired: an 8-qubit core on qubits 14-21 of 22 (8 high qubits
    for the grid, a mid and a top qubit for the sweeps) now takes the
    segmented engine, whose plan keeps 6 low bits in place instead of 7, and
    matches the complex128 oracle. (The JAX package's own segmented planner
    spins on this circuit: at 16 block bits its stage_min of 12 admits at
    most 4 incoming qubits per segment, and the gate brings 6.)

    Refused until the route by width, naming each engine's refusal: a
    10-qubit core on qubits 12-21 of 22, wider than any segment's 14 - 5 = 9
    bits (the JAX package cannot run it either: its grid and sweep planners
    refuse it, and its segmented planner spins, 10 qubits > 16 - 7). Since
    the grid and segmented rows send cores of 10 qubits and more to the
    dense pass, it runs: the pieces on their engines (the 8-qubit core's on
    segments), the core as a pass, against the oracle. Since the grid row's
    cuts (dispatch.GRID_CUTS) the route cuts at the refused 8-qubit gate
    too, in place of the segments."""
    n = 22
    c = tq.Circuit(n).h(0).add(_dense(8), *range(14, 22)).cnot(0, n - 1)
    # the route cuts at the refused gate from 22q (dispatch.GRID_CUTS);
    # the row's engines still take the circuit whole on the segments
    engine, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert prog.engines == ["grid_sweep", "dense_pass", "grid_sweep"]
    engine, prog = dispatch._plan_piece(c, "grid_sweep")
    assert engine == "segmented" and isinstance(prog, seg.SegmentedProgram)
    assert (prog.local_bits, prog.swap_min) == (fc.MAX_BLOCK_BITS, 6)
    assert max(s.table.max_core for s in prog.steps) == 8
    psi = random_state(n, np.random.default_rng(22))
    np.testing.assert_allclose(emulate_segments(psi, prog), jax_oracle(c, psi), atol=TOL, rtol=0)

    c10 = tq.Circuit(n).h(0).add(_dense(8), *range(14, 22)).add(_dense(10), *range(12, 22))
    c10.cnot(0, n - 1)
    with pytest.raises(ValueError) as err:   # the rows' engines, without the split
        dispatch._plan_piece(c10, "grid_sweep")
    msg = str(err.value)
    for name in ("grid_sweep:", "sweeps:", "segmented:"):
        assert name in msg
    engine, prog = dispatch.plan_split(c10, "grid_sweep")     # the cut at 10+ only
    assert engine == "segmented+dense_pass+grid_sweep"
    assert prog.engines == ["segmented", "dense_pass", "grid_sweep"]
    assert prog.steps[1].k == 10
    x = tq.apply.from_complex(psi, np.float32, "cpu")
    want = jax_oracle(c10, psi)
    np.testing.assert_allclose(tq.apply.to_complex(prog.run_plain(x)), want, atol=TOL, rtol=0)
    # the route cuts at the refused 8-qubit gate too
    engine, prog = dispatch.plan_run(c10, np.float32, CUDA)
    assert prog.engines == ["grid_sweep", "dense_pass", "dense_pass", "grid_sweep"]
    assert [s.k for s in prog.steps[1:3]] == [8, 10]
    np.testing.assert_allclose(tq.apply.to_complex(prog.run_plain(x)), want, atol=TOL, rtol=0)
    # above the segmented engine's range the row's engines give it to the
    # torch engine; the grid row cuts at the refused gate there instead
    c28 = tq.Circuit(28).add(_dense(8), *range(20, 28))
    assert dispatch._plan_piece(c28, "grid_sweep") == ("torch", None)
    engine, prog = dispatch.plan_run(c28, np.float32, CUDA)
    assert engine == "dense_pass" and prog.steps[0].targets == tuple(range(20, 28))
