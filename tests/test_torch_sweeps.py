"""Sweeps engine of the port against the JAX package's.

* The port's ``plan_sweeps`` gives the JAX planner's plans sweep by sweep
  (kind, gates, active tops) at the default geometry at 22, 24 and 26
  qubits (host planning only) and at the shrunk geometry
  ``SweepParams(k_bits=2, rb_bits=2)`` of ``tests/test_sweeps.py``, SWAP
  decomposition and both refusals included.
* The op tables over the sweeps' block layouts, executed by a numpy mirror of
  ``csrc/sweep.cu`` (:func:`emulate_sweep`: unit by unit, each op split over
  a group's CTAs, slots at ``GlobalSlots``' state index), agree with the
  complex128 oracle within 1e-6.
* ``SweepProgram.run`` on the CPU (its plain version) agrees with the JAX
  sweep engine in Pallas interpret mode and with the oracle at 12-13 qubits
  within 1e-5 (two float32 engines; amplitudes <= 1, ~1e-7 rounding per
  gate). The CUDA kernels run only on the card (tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.apply as jap
import tpu_qsim.gates as jgates
from tpu_qsim.kernels import sweeps as js

import tpu_qsim_torch as tq
import tpu_qsim_torch.gates as tgates
from tpu_qsim_torch.convert import circuit_from_jax
from tpu_qsim_torch.kernels import LAUNCHES, reset_launches
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import dense_pass as dp
from tpu_qsim_torch.kernels import sweeps as ts

from conftest import random_state
from test_torch_gridsweeps import core_matrix, emulate_block
from torch_threads import one_blas_thread  # noqa: F401

P_JAX = js.SweepParams(k_bits=2, rb_bits=2)     # blk_bits 9, 4 parts
P = ts.SweepParams(k_bits=2, rb_bits=2)


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def register_both(name: str, u: np.ndarray) -> None:
    for mod in (jgates, tgates):
        if name not in mod.GATE_ARITY:
            mod.register_gate(name, u)


def _unitary(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
    return np.linalg.qr(m)[0]


def _external_bits_circuit(n: int = 12) -> "jq.Circuit":
    """Every flavour of out-of-block resolution under P (tops n-2, n-1; mid
    9..n-3): diagonals on two external qubits, external controls, split
    toffoli controls, a swap across the regions."""
    c = jq.Circuit(n)
    c.h(0).h(n - 1).cz(n - 2, n - 1).cp(9, n - 1, 0.4).cnot(n - 1, 2).cnot(9, 3)
    c.toffoli(n - 1, 4, 8).cry(n - 2, 2, 0.6).crz(n - 1, 1, 0.2)
    c.swap(8, n - 1).rz(n - 2, 0.9).x(9).h(n - 2).swap(9, n - 1)
    return c


CIRCUITS = {
    "random": lambda n: jq.random_circuit(n, 100, seed=42),
    "qft": lambda n: jq.qft_circuit(n),
    "ghz": lambda n: jq.ghz_circuit(n),
}


# ---------------------------------------------------------------------------
# planner parity
# ---------------------------------------------------------------------------


def _assert_same_plan(port_plan, jax_plan):
    assert len(port_plan) == len(jax_plan)
    for ps, js_ in zip(port_plan, jax_plan):
        assert ps.kind == js_.kind and ps.tops == js_.tops
        assert [(g.name, g.qubits, g.param, g.matrix_bytes) for g in ps.gates] == [
            (g.name, g.qubits, g.param, g.matrix_bytes) for g in js_.gates]


@pytest.mark.parametrize("name", sorted(CIRCUITS))
@pytest.mark.parametrize("n", [22, 24, 26])
def test_plan_matches_jax_planner_default_geometry(n, name):
    c = CIRCUITS[name](n)
    _assert_same_plan(ts.plan_sweeps(circuit_from_jax(c), n), js.plan_sweeps(c, n))


@pytest.mark.parametrize("n,seed", [(12, 0), (12, 1), (13, 2), (13, 3), (14, 4)])
def test_plan_matches_jax_planner_shrunk_geometry(n, seed):
    c = jq.random_circuit(n, 120, seed=seed)
    _assert_same_plan(ts.plan_sweeps(circuit_from_jax(c), n, P), js.plan_sweeps(c, n, P_JAX))


@pytest.mark.parametrize("name", ["qft", "ghz", "external"])
def test_plan_matches_jax_planner_structured(name):
    c = _external_bits_circuit() if name == "external" else CIRCUITS[name](12)
    _assert_same_plan(ts.plan_sweeps(circuit_from_jax(c), 12, P), js.plan_sweeps(c, 12, P_JAX))


def test_gate_cap_matches_jax():
    c = jq.Circuit(12)
    for i in range(3 * ts.MAX_SWEEP_GATES):
        c.h(i % 8)
    plan = ts.plan_sweeps(circuit_from_jax(c), 12, P)
    _assert_same_plan(plan, js.plan_sweeps(c, 12, P_JAX))
    assert all(len(s.gates) <= ts.MAX_SWEEP_GATES for s in plan)


def test_swap_across_regions_decomposes_in_both_planners():
    c = jq.Circuit(12).swap(9, 11)          # mid 9 <-> top 11
    plan = ts.plan_sweeps(circuit_from_jax(c), 12, P)
    _assert_same_plan(plan, js.plan_sweeps(c, 12, P_JAX))
    names = [g.name for s in plan for g in s.gates]
    assert names == ["cnot"] * 3
    assert [g.qubits for s in plan for g in s.gates] == [(9, 11), (11, 9), (9, 11)]


def test_mid_and_top_gate_raises_in_both_planners():
    theta = 0.3
    u = np.kron(
        np.array([[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]),
        np.array([[np.cos(theta), 1j * np.sin(theta)], [1j * np.sin(theta), np.cos(theta)]]),
    )
    register_both("torch_sweep_dense2", u)
    c = jq.Circuit(12).add("torch_sweep_dense2", 10, 9)   # top 10 + mid 9
    with pytest.raises(ValueError, match="mid and a top"):
        js.plan_sweeps(c, 12, P_JAX)
    with pytest.raises(ValueError, match="mid and a top"):
        ts.plan_sweeps(circuit_from_jax(c), 12, P)


def test_too_many_tops_raises_in_both_planners():
    x5 = np.array([[1.0]])
    for _ in range(5):
        x5 = np.kron(x5, np.array([[0.0, 1.0], [1.0, 0.0]]))
    register_both("torch_sweep_dense5", x5)
    c = jq.Circuit(15).add("torch_sweep_dense5", 14, 13, 12, 11, 10)
    with pytest.raises(ValueError, match="top qubits"):
        js.plan_sweeps(c, 15, js.SweepParams(k_bits=5, rb_bits=2))
    with pytest.raises(ValueError, match="top qubits"):
        ts.plan_sweeps(circuit_from_jax(c), 15, ts.SweepParams(k_bits=5, rb_bits=2))


def test_layouts_are_the_jax_relabelings():
    n = 12
    c = _external_bits_circuit(n)
    plan = js.plan_sweeps(c, n, P_JAX)
    for s in plan:
        if s.kind == "low":
            lay = ts.low_layout(n, P)
            want = js._relabel_low(s.gates, n, P_JAX)
        else:
            lay = ts.high_layout(ts.Sweep(s.kind, [], set(s.tops)), n, P)
            active = sorted(lay.active)
            assert set(s.tops) <= set(active) and len(active) == min(js.MAX_ACTIVE_TOPS, P.k_bits)
            want = js._relabel_high(s.gates, n, active, P_JAX)
        for g, w in zip(s.gates, want):
            codes = [lay.code(q) for q in g.qubits]
            assert [k if k < fc.EXT else k - fc.EXT + js._EXT_BASE for k in codes] == list(w.qubits)


# ---------------------------------------------------------------------------
# the op tables, executed by a numpy mirror of csrc/sweep.cu
# ---------------------------------------------------------------------------


RING_GROUPS = 16   # ops.cuh's TILE_RING_GROUPS


def tiled_bases(op: np.ndarray, kbits: int, parts: int, cap: int, ring: bool = False) -> list:
    """Per CTA of a Part of ``parts``, the group bases a tiled core's op
    (ops.cuh's ``apply_dense_tiled``) takes: its groups enumerated with zeros
    at the target and control bits and the controls' values ORed in, cut
    into tiles of min(cap / 2^m, groups) groups (``cap`` the kernel's scratch
    in float2: 32 x threads in the sweep kernel, a block's worth in the
    grid sweep and the segments; half of it where the slots lie in device
    memory, ``ring``, and half holds RING_GROUPS groups or more: two tiles
    in turn, the next one's copies in flight), CTA r taking tiles r, r +
    parts, ... in turn."""
    m = int(op[1])
    assert 2 << m <= cap, "a tile holds two groups or more"
    if ring and cap >> (m + 1) >= RING_GROUPS:
        cap //= 2
    fixed = sum(1 << int(c) for c in op[8:8 + m]) | int(op[3])
    base = np.arange(1 << (kbits - bin(fixed).count("1")), dtype=np.int64)
    tg = min(cap >> m, base.size)
    for p in range(kbits):                  # insert a 0 at each fixed bit
        if (fixed >> p) & 1:
            base = ((base >> p) << (p + 1)) | (base & ((1 << p) - 1))
    base |= int(op[4])
    tiles = [base[t:t + tg] for t in range(0, base.size, tg)]
    return [np.concatenate(tiles[r::parts] or [base[:0]]) for r in range(parts)]


def emulate_sweep(
    re: np.ndarray, im: np.ndarray, table: fc.OpTable, group_bits: int = 0,
    threads: int | None = None,
) -> None:
    """Apply one sweep's table (``ts.sweep_table``) to the flat planes in
    place, as sweep.cu does: unit by unit (the inactive bits' assignments: a
    low sweep's parts, a high sweep's steps; the whole-circuit route's one
    unit, the whole state), stage by stage, on CTAs of ``threads`` threads
    (None: 16 amplitudes of a tile each; more only where a unit stage's
    tiled op needs them, the others idle in the tile stages). A tile stage's
    register table runs tile by tile (CTA r of a group of ``2^group_bits``
    taking tiles r, r + 2^group_bits, ...), each tile at the unit's share of
    the global index OR the tile index deposited at the unit's bits outside
    the tile, through the grid sweep's block mirror (:func:`emulate_block`).
    A unit stage's wide core runs over the unit, its tiles dealt to the
    group's CTAs in turn, slot l at ``GlobalSlots``' state index ``cta_g |
    (l & (2^blk - 1)) | hi_off[l >> blk]``, its product as the tensor cores
    take it (``test_torch_dense_op.emulate_tiled_op``)."""
    from test_torch_dense_op import emulate_tiled_op

    ints = table.ints
    n_stages, blk, a, n_inact = (int(v) for v in ints[:4])
    tile_bits = int(ints[ts.HEADER_TILE_BITS])
    tile_threads = 1 << (tile_bits - tgs.REG_BITS)
    threads = tile_threads if threads is None else threads
    assert threads >= tile_threads and not threads & (threads - 1)
    active = [int(p) for p in ints[16:16 + a]]
    inact = [int(p) for p in ints[32:32 + n_inact]]
    kbits = blk + a
    unit_mask = sum(1 << p for p in [*range(blk), *active])
    hi_off = np.array([sum(1 << active[j] for j in range(a) if (h >> j) & 1)
                       for h in range(1 << a)], dtype=np.int64)
    desc = ints[fc.SWEEP_HEADER:fc.SWEEP_HEADER + n_stages * ts.STAGE_WORDS]
    desc = desc.reshape(n_stages, ts.STAGE_WORDS)
    ends = [*(int(d[1]) for d in desc[1:]), ints.size]
    cends = [*(int(d[2]) for d in desc[1:]), len(table.coef)]
    assert int(ints[fc.HEADER_MAX_CORE]) == table.max_core
    members = 1 << group_bits
    for u in range(1 << n_inact):
        cta_g = sum(1 << p for b, p in enumerate(inact) if (u >> b) & 1)

        def index(ls):
            return cta_g | (ls & ((1 << blk) - 1)) | hi_off[ls >> blk]

        for d, end, cend in zip(desc, ends, cends):
            kind, ioff, coff, outside, n_out = (int(v) for v in d[:5])
            assert not any(d[5:])
            sub = fc.OpTable(ints[ioff:end], table.coef[coff:cend], 0.0, 0)
            if kind == ts.STAGE_TILE:
                assert int(sub.ints[1]) + int(sub.ints[2]) == tile_bits
                assert outside & ~unit_mask == 0 and bin(outside).count("1") == n_out
                for r in range(members):
                    for t in range(r, 1 << n_out, members):
                        tile_g = cta_g
                        for b, p in enumerate(q for q in range(32) if (outside >> q) & 1):
                            tile_g |= ((t >> b) & 1) << p
                        emulate_block(re, im, sub, tile_g)
                continue
            assert kind == ts.STAGE_UNIT and int(sub.ints[0]) == 1
            op = sub.ints[fc.SWEEP_HEADER:][: fc.OP_HEADER]
            if (cta_g & int(op[5])) != int(op[6]):
                continue
            m, off = int(op[1]), int(op[2])
            assert op[0] == fc.KIND_DENSE and m >= fc.TILE_CORE
            codes = [int(x) for x in op[8:8 + m]]
            assert max(codes) < kbits
            offs = [sum(1 << codes[i] for i in range(m) if (j >> (m - 1 - i)) & 1)
                    for j in range(1 << m)]
            w = sub.coef[:, 0].astype(np.complex128) + 1j * sub.coef[:, 1]
            core = core_matrix(w, off, m)
            for base in tiled_bases(op, kbits, members, 32 * threads, ring=True):
                gs = [index(base | dd) for dd in offs]
                y = emulate_tiled_op(core, np.stack([re[g] + 1j * im[g] for g in gs]))
                for j, g in enumerate(gs):
                    re[g], im[g] = y[j].real, y[j].imag


def to_jax(c: tq.Circuit) -> "jq.Circuit":
    """The JAX package's copy of a port circuit (its gates registered in
    both packages, as :func:`register_both` does)."""
    out = jq.Circuit(c.num_qubits)
    for g in c.gates:
        out.append(jq.Gate(g.name, g.qubits, g.param, g.matrix_bytes))
    return out


def jax_oracle(c: tq.Circuit, psi: np.ndarray) -> np.ndarray:
    """``psi`` after the port circuit ``c``, by the JAX package's complex128
    oracle."""
    ref = jq.CPUReferenceSimulator(c.num_qubits)
    ref.set_state(psi.astype(np.complex128))
    ref.run(to_jax(c))
    return ref.get_state()


def _wide_sweep_circuit(n: int) -> "jq.Circuit":
    """A 7-qubit core under a control outside every block (top n-1), an
    8-qubit core with a controlled 7-qubit core inside it, on low bits, and
    a 3-qubit core on the top bits, among random gates."""
    register_both("torch_sweep_dense7", _unitary(7, 7))
    register_both("torch_sweep_dense8", _unitary(8, 8))
    cu = np.eye(256, dtype=np.complex128)
    cu[128:, 128:] = _unitary(7, 17)
    register_both("torch_sweep_cdense7", cu)
    register_both("torch_sweep_dense3", _unitary(3, 3))
    c = jq.random_circuit(n, 30, seed=n)
    c.add("torch_sweep_dense8", 6, 0, 7, 1, 5, 2, 4, 3)
    c.add("torch_sweep_cdense7", n - 1, 3, 8, 1, 6, 0, 5, 2)
    c.add("torch_sweep_dense3", n - 1, n - 2, 2)
    c.add("torch_sweep_cdense7", 4, 0, 1, 2, 3, 5, 6, 7)
    return c.extend(jq.random_circuit(n, 30, seed=n + 1).gates)


@pytest.mark.parametrize("group_bits", [0, 2])
@pytest.mark.parametrize("name", ["random", "qft", "external", "wide"])
def test_op_table_emulation_matches_oracle(name, group_bits):
    n = 12
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=9),
        "qft": lambda: tq.qft_circuit(n),
        "external": lambda: circuit_from_jax(_external_bits_circuit(n)),
        "wide": lambda: circuit_from_jax(_wide_sweep_circuit(n)),
    }[name]()
    prog = ts.SweepProgram(c, P)
    assert set(prog.sweep_kinds) == {"low", "high"} or name == "wide"
    psi = random_state(n, np.random.default_rng(group_bits))
    re, im = psi.real.copy(), psi.imag.copy()
    for table in prog.tables:
        emulate_sweep(re, im, table, group_bits)
    np.testing.assert_allclose(re + 1j * im, jax_oracle(c, psi), atol=1e-6, rtol=0)


def _main_path_circuit() -> tq.Circuit:
    """The 26q sweeps main path: an 8-qubit core on 10-17 between two random
    layers (the grid planner refuses it)."""
    register_both("torch_sweep_dense8", _unitary(8, 8))
    c = tq.random_circuit(26, 40, seed=42).add("torch_sweep_dense8", *range(10, 18))
    return c.extend(tq.random_circuit(26, 40, seed=43).gates)


@pytest.mark.parametrize("name", ["random26", "main26", "wide12", "external12"])
def test_plan_stages_cut_each_sweep_in_order(name):
    prog = {
        "random26": lambda: ts.SweepProgram(tq.random_circuit(26, 100, seed=42)),
        "main26": lambda: ts.SweepProgram(_main_path_circuit()),
        "wide12": lambda: ts.SweepProgram(circuit_from_jax(_wide_sweep_circuit(12)), P),
        "external12": lambda: ts.SweepProgram(circuit_from_jax(_external_bits_circuit(12)), P),
    }[name]()
    lanes = set(range(tgs.LANE_BITS))
    for gates, stages, lay, t in zip(prog.sweep_gates, prog.stages, prog.layouts, prog.tile_bits):
        # every op in exactly one stage, in order
        assert [id(g) for st in stages for g in st.gates] == [id(g) for g in gates]
        unit = set(range(lay.blk_bits)) | set(lay.active)
        moving = [[set(ts.moving_qubits(g.u, g.qubits)) for g in st.gates] for st in stages]
        for st, mv in zip(stages, moving):
            if st.kind == "unit":     # a core of TILE_CORE qubits or more, alone
                assert len(st.gates) == 1 and len(mv[0]) >= fc.TILE_CORE and st.layout == lay
                continue
            tile = set(range(st.layout.blk_bits)) | set(st.layout.active)
            assert len(tile) == t and lanes <= tile <= unit
            assert all(m <= tile and len(m) < fc.TILE_CORE for m in mv)
            assert st.outside == sum(1 << q for q in unit - tile)
        # a tile stage ends where the next op's moving bits would not fit
        for (a, ma), (b, mb) in zip(zip(stages, moving), zip(stages[1:], moving[1:])):
            if a.kind == b.kind == "tile":
                assert len(lanes.union(*ma, mb[0])) > t
    if name == "random26":      # 59 per-op passes before the stages
        assert [[len(st.gates) for st in sw] for sw in prog.stages] == [[20, 8], [15], [7], [9]]
        assert sum(map(len, prog.stages)) <= 6
    if name == "main26":
        assert [[st.kind for st in sw] for sw in prog.stages] == [
            ["tile"], ["tile", "unit", "tile"], ["tile"], ["tile"]]


@pytest.mark.parametrize("k,lo", [(8, 10), (9, 8), (10, 7), (11, 6), (5, 10), (6, 10)])
def test_main_path_launches(k, lo):
    # the 26q sweeps main path (k = 8 on 10-17), a 5-qubit core and the
    # wider cores: the plan is the parent's, its sweeps' stages cut into
    # launches: each run of tile stages one launch on the instance for
    # narrow cores, the unit stage alone on the wide instance, or from
    # MIN_UNIT_PASS_CORE qubits through the dense pass on the gate's state
    # qubits (planning only)
    from tpu_qsim_torch.kernels.time_run import wide_circuit

    c = _main_path_circuit() if k == 8 else wide_circuit(26, k, lo)
    prog = ts.SweepProgram(c)
    one = ts.SweepProgram(c, _one_launch=True)
    assert prog.sweep_kinds == one.sweep_kinds
    assert [[(st.kind, len(st.gates), st.layout, st.outside) for st in sw] for sw in prog.stages] == [
        [(st.kind, len(st.gates), st.layout, st.outside) for st in sw] for sw in one.stages]
    for stages, launches, table in zip(prog.stages, prog.launches, prog.tables):
        assert [st for ln in launches for st in ln.stages] == stages
        for ln in launches:
            if ln.route == "tile":
                assert ln.table.max_core <= fc.NARROW_CORE
                assert all(st.kind == "tile" for st in ln.stages)
            else:
                (st,) = ln.stages
                assert st.kind == "unit"
                assert (ln.route == "pass") == (k >= ts.MIN_UNIT_PASS_CORE)
                # a pass's core widened to MIN_PASS_CORE qubits
                assert table.max_core == k and ln.max_core == (
                    max(k, dp.MIN_PASS_CORE) if ln.route == "pass" else k)
                if ln.route == "pass":     # the gate's state qubits, not block bits
                    assert ln.step.targets[-k:] == tuple(range(lo, lo + k)) and ln.table is None
        # no two tile launches side by side
        routes = [ln.route for ln in launches]
        assert all(a != b for a, b in zip(routes, routes[1:]))
    if k == 8:
        assert prog.sweep_kinds == ["high", "low", "high", "low"]
        assert [[ln.route for ln in sw] for sw in prog.launches] == [
            ["tile"], ["tile", "pass", "tile"], ["tile"], ["tile"]]
        assert [[ln.route for ln in sw] for sw in one.launches] == [["mixed"]] * 4
    assert ts.MIN_UNIT_PASS_CORE == 6 and ts.MIN_SWEEP_PASS_CORE == 10
    # a sweep in one launch takes its whole table, not a copy
    for sw, table in zip(one.launches, one.tables):
        assert [ln.table for ln in sw] == [table] and sw[0].table is table
    for sw, table in zip(prog.launches, prog.tables):
        assert (sw[0].table is table) == (len(sw) == 1)


def test_sweep_tables_at_full_width():
    # 26 qubits: a low block of 21 bits and a high block of 20, planned only
    c = tq.random_circuit(26, 100, seed=42)
    prog = ts.SweepProgram(c)
    assert prog.sweep_kinds == ["high", "low", "high", "low"]
    for kind, lay, t in zip(prog.sweep_kinds, prog.layouts, prog.tables):
        head = t.ints[:fc.SWEEP_HEADER]
        if kind == "low":
            assert (lay.blk_bits, lay.active) == (21, ())
            assert list(head[1:4]) == [21, 0, 5] and list(head[32:37]) == [21, 22, 23, 24, 25]
        else:
            assert lay.blk_bits == 16 and len(lay.active) == 4 and lay.kbits == 20
            assert list(head[1:4]) == [16, 4, 6]
            assert list(head[32:38]) == [16, 17, 18, 19, 20] + sorted(
                set(range(21, 26)) - set(lay.active))
    with pytest.raises(ValueError, match="exceeds"):
        fc.build_op_table([], ts.low_layout(27), max_bits=fc.MAX_SWEEP_BITS)


# ---------------------------------------------------------------------------
# program against the JAX sweep engine (interpret mode) and the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,n", [("random", 12), ("external", 12), ("qft", 13)])
def test_program_matches_jax_sweep_engine(name, n):
    c = {
        "random": lambda: jq.random_circuit(n, 60, seed=7),
        "external": lambda: _external_bits_circuit(n),
        "qft": lambda: jq.qft_circuit(n),
    }[name]()
    psi = random_state(n, np.random.default_rng(n)).astype(np.complex64)
    jprog = js.build_sweep_run(c, np.float32, interpret=True, params=P_JAX)
    want = jap.to_complex(jprog.run(jap.from_complex(psi, np.float32)))
    prog = ts.build_sweep_run(circuit_from_jax(c), np.float32, params=P, device="cpu")
    assert prog.sweep_kinds == jprog.sweep_kinds
    got = tq.apply.to_complex(prog.run(tq.apply.from_complex(psi, np.float32, "cpu")))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    ora = jq.CPUReferenceSimulator(n)
    ora.set_state(psi.astype(np.complex128))
    ora.run(c)
    np.testing.assert_allclose(got, ora.get_state(), atol=1e-5, rtol=0)


def test_program_with_wide_cores_matches_jax_planner_and_oracle():
    # 7- and 8-qubit cores: the JAX engine's interpret-mode compile of such
    # cores takes minutes here, so its planner and its oracle stand in
    n = 12
    c = _wide_sweep_circuit(n)
    prog = ts.build_sweep_run(circuit_from_jax(c), np.float32, params=P, device="cpu")
    _assert_same_plan(ts.plan_sweeps(circuit_from_jax(c), n, P), js.plan_sweeps(c, n, P_JAX))
    assert prog.sweep_kinds == [s.kind for s in js.plan_sweeps(c, n, P_JAX)]
    assert max(t.max_core for t in prog.tables) == 8
    psi = random_state(n, np.random.default_rng(n)).astype(np.complex64)
    got = tq.apply.to_complex(prog.run(tq.apply.from_complex(psi, np.float32, "cpu")))
    ora = jq.CPUReferenceSimulator(n)
    ora.set_state(psi.astype(np.complex128))
    ora.run(c)
    np.testing.assert_allclose(got, ora.get_state(), atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# program, wrappers and geometry on the CPU
# ---------------------------------------------------------------------------


def test_cpu_program_runs_plain_version_without_launching():
    reset_launches()
    prog = ts.SweepProgram(tq.random_circuit(12, 40, seed=4), P)
    x = tq.apply.initial_state(12, np.float32, device="cpu")
    np.testing.assert_array_equal(prog.run(x).numpy(), prog.run_plain(x).numpy())
    assert LAUNCHES["low_sweep"] == LAUNCHES["high_sweep"] == 0
    ints, coef = prog._tables_on(torch.device("cpu"))[0][0]
    for wrapper in (ts.low_sweep, ts.high_sweep, ts.unit_stage):
        with pytest.raises(ValueError, match="CUDA"):
            wrapper(x, ints, coef, prog.layouts[0])
    with pytest.raises(ValueError, match="float32"):
        prog.run(x.double())
    y = x
    for i in range(prog.num_sweeps):
        y = prog.step_plain(y, i)
    np.testing.assert_array_equal(prog.run_plain(x).numpy(), y.numpy())


def test_build_sweep_run_validates():
    c = tq.random_circuit(12, 5, seed=1)
    with pytest.raises(ValueError, match="22 <= n <= 26"):
        ts.build_sweep_run(c, np.float32, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        ts.build_sweep_run(c, np.float64, params=P, device="cpu")
    with pytest.raises(ValueError, match="exceed"):
        ts.SweepProgram(tq.random_circuit(11, 5, seed=1), P)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.build_sweep_run(c, np.float32, params=P)


def test_program_bytes_and_flops():
    prog = ts.SweepProgram(tq.Circuit(12).h(0).rz(11, 0.3).cnot(0, 11), P)
    assert prog.bytes_moved() == prog.num_sweeps * 16 * (1 << 12)
    # h 6 flops per amplitude, rz 6, cnot (a permutation) 0
    assert prog.flops() == (6 + 6 + 0) * (1 << 12)


@pytest.mark.parametrize("n,in_flight,max_core,want", [
    # a group has no more CTAs than its unit has 2^13-slot tiles (512 threads)
    (26, 1, 1, (1, 8)),         # 528 resident -> 512 CTAs; a 21-bit unit, 2^8 tiles
    (26, 4, 1, (4, 7)),
    (26, 64, 1, (32, 4)),       # no more groups than the low sweep's 32 parts
    (26, 1, 8, (1, 8)),         # a wide core: the same tiles at WIDE_THREADS
    (26, 2, 8, (2, 8)),
    (26, None, 1, (8, 6)),      # 16 MB parts: one fits the L2 budget, 8 at least
    (24, None, 1, (8, 6)),      # 4 MB parts: 6 fit, 8 at least
    (22, None, 1, (16, 4)),     # 1 MB parts of 2^4 tiles
])
def test_launch_grid(n, in_flight, max_core, want):
    lay = ts.low_layout(n)
    got = ts.launch_grid(lay, ts.SweepGeometry(512, in_flight), max_core, 528)
    assert got == want
    high = ts.high_layout(ts.Sweep("high", [], {n - 1}), n)      # 8 MB steps
    assert ts.launch_grid(high, ts.SweepGeometry(512, None), 1, 528)[0] == min(
        ts.MIN_IN_FLIGHT, 1 << (n - 20))
    # a unit no larger than a tile is one tile: one CTA a group; 256 threads
    # make 2^12-slot tiles, twice as many
    small = ts.low_layout(12, P)          # 10 block bits
    assert ts.launch_grid(small, ts.SweepGeometry(512, 1), 8, 528) == (1, 0)
    assert ts.launch_grid(ts.low_layout(26), ts.SweepGeometry(256, 1), 3, 528) == (1, 9)
    # the resident count rounds down to a power of two
    assert ts.launch_grid(ts.low_layout(26), ts.SweepGeometry(512, 1), 1, 300) == (1, 8)
    with pytest.raises(RuntimeError, match="resident"):
        ts.launch_grid(lay, ts.SweepGeometry(512, 1), 1, 0)
