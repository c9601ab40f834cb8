"""The sweep kernel's own CUDA source, run on the CPU: the low and high
sweeps and the whole-circuit route.

``csrc/sweep.cu`` (``sweep_kernel<false/true>``, the spare-warp instance),
with ``block_program.cuh``, ``ops.cuh``, ``tf32.cuh``, ``grid_sync.cuh`` and
``ptx.cuh``, is built by g++ under AddressSanitizer and UBSan and launched
through ``sweep_launch`` (``tests/torch_host_harness.py``) on the tables
``sweeps.sweep_table`` builds, at the geometry ``sweeps.launch_grid`` and
``fused_circuit.whole_circuit`` give for ``sweep_prepare``'s CTAs (the
runtime's device of two multiprocessors: 2-4 CTAs, met at
``grid_sync.cuh``'s barrier between stages). Every case holds the result
against the port's plain version within 1e-6, against the JAX package's
complex128 oracle within 1e-5 and against the numpy mirror
(``test_torch_sweeps.emulate_sweep``, through
``test_torch_dense_op.emulate_tiled_op`` for cores of 5+ qubits) within
1e-6, with no sanitizer report.

The cases cover low and high sweeps; tile stages and unit stages (one
dense core of 5+ qubits over the unit, in device memory through
``GlobalSlots``); the tiled op with its ring of two tiles fed by cp.async
and without it (``ops.cuh``: a ring where each of two tiles takes 16 groups
or more), with 1 to 32 groups a tile; controls inside and outside the unit;
and the whole-circuit route at 10-13 qubits, its spare warps included
(a core whose tiled op needs more threads than a tile has).
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.circuit import Gate
from tpu_qsim_torch.convert import circuit_from_jax
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import sweeps as ts
from tpu_qsim_torch.kernels.gridsweeps import REG_BITS

import torch_host_harness as host
from conftest import random_state
from test_torch_dense_op import dense_unitary
from test_torch_sweeps import (
    RING_GROUPS, _external_bits_circuit, _wide_sweep_circuit, emulate_sweep, jax_oracle,
)
from test_torch_whole_circuit import emulate_whole_circuit

PLAIN_TOL = 1e-6
ORACLE_TOL = 1e-5
MIRROR_TOL = 1e-6
P = ts.SweepParams(k_bits=2, rb_bits=2)      # 4 parts; a high block of bits [0, 9) + 2 tops


def check(got, prog, c, psi, mirror) -> None:
    x = torch.from_numpy(host.planes(psi))
    np.testing.assert_allclose(got, np.asarray(tq.apply.to_complex(prog.run_plain(x))),
                               atol=PLAIN_TOL, rtol=0)
    np.testing.assert_allclose(got, jax_oracle(c, psi), atol=ORACLE_TOL, rtol=0)
    np.testing.assert_allclose(got, mirror, atol=MIRROR_TOL, rtol=0)


def under_control(core: np.ndarray, ctrl: tuple) -> np.ndarray:
    """``core`` under one control (the matrix's MSB) where ``ctrl`` names one."""
    if not ctrl:
        return core
    u = np.eye(2 * len(core), dtype=np.complex128)
    u[len(core):, len(core):] = core
    return u


def tile_shape(op: np.ndarray, kbits: int, cap: int) -> tuple[bool, int]:
    """(ring, groups a tile) of a tiled core's op over slots in device
    memory, as ``ops.cuh::apply_dense_tiled`` sizes them from its scratch of
    ``cap`` float2."""
    m = int(op[1])
    fixed = sum(1 << int(q) for q in op[8:8 + m]) | int(op[3])
    free = bin(((1 << kbits) - 1) & ~fixed).count("1")
    ring = cap >> (m + 1) >= RING_GROUPS
    half = cap // 2 if ring else cap
    return ring, 1 << min(half.bit_length() - 1 - m, free)


def unit_ops(table: fc.OpTable) -> list[np.ndarray]:
    """The op of each unit stage of a sweep table."""
    ints = table.ints
    desc = ints[fc.SWEEP_HEADER:fc.SWEEP_HEADER + int(ints[0]) * ts.STAGE_WORDS]
    return [ints[int(d[1]) + fc.SWEEP_HEADER:][:fc.OP_HEADER]
            for d in desc.reshape(-1, ts.STAGE_WORDS) if d[0] == ts.STAGE_UNIT]


def emulate_launches(prog, psi: np.ndarray) -> np.ndarray:
    """``psi`` after the program's launches as the numpy mirrors run them:
    each table through ``emulate_sweep`` at its launch's group bits, each
    dense pass through ``emulate_dense_pass``."""
    from test_torch_dense_pass import emulate_dense_pass
    from tpu_qsim_torch.kernels.dense_pass import core_operand

    re, im = psi.real.copy(), psi.imag.copy()
    for launches, geometry in zip(prog.launches, host.sweep_geometry(prog)):
        for launch, geo in zip(launches, geometry):
            if launch.table is None:
                step = launch.step
                y = emulate_dense_pass((re + 1j * im).astype(np.complex64),
                                       core_operand(step.core, step.targets), step.tmask,
                                       step.cmask)
                re, im = y.real.astype(np.float64), y.imag.astype(np.float64)
            else:
                emulate_sweep(re, im, launch.table, geo[2])
    return re + 1j * im


def sweeps_case(c: tq.Circuit, params: ts.SweepParams,
                geometry: ts.SweepGeometry = ts.SweepGeometry(), **route):
    """``c`` through the host-built kernels as ``SweepProgram.run`` launches
    them (``route``: ``SweepProgram``'s keywords), against the plain
    version, the oracle and the launches' mirror."""
    prog = ts.SweepProgram(c, params, geometry, **route)
    psi = random_state(c.num_qubits, np.random.default_rng(c.num_qubits + len(c.gates)))
    got = host.run_sweeps(prog, psi)
    check(got, prog, c, psi, emulate_launches(prog, psi))
    return prog


@pytest.mark.parametrize("name", ["random", "qft", "external", "wide"])
@pytest.mark.parametrize("n", [12, 13])
def test_sweeps_circuit(name, n):
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=n),
        "qft": lambda: tq.qft_circuit(n),
        "external": lambda: circuit_from_jax(_external_bits_circuit(n)),
        "wide": lambda: circuit_from_jax(_wide_sweep_circuit(n)),
    }[name]()
    prog = sweeps_case(c, P)
    assert set(prog.sweep_kinds) == {"low", "high"} or name == "wide"
    assert any(unit_ops(t) for t in prog.tables) == (name == "wide")


@pytest.mark.parametrize("core", [0, 6])
@pytest.mark.parametrize("threads,in_flight", [(32, 1), (64, 2), (128, None)])
def test_sweeps_small_tiles(threads, in_flight, core):
    # tiles of 16 x threads slots in 2^12-slot units: several tiles a unit,
    # dealt to a group of several CTAs (fewer units in flight than CTAs)
    # that meet at grid_sync.cuh's barrier between stages; with a 6-qubit
    # core the wide instance streams each CTA's next tile in with cp.async
    # while it runs this one
    n = 14
    c = tq.random_circuit(n, 60, seed=threads)
    if core:
        u = dense_unitary(core, np.random.default_rng(40 + core)).tobytes()
        c.append(Gate("host_small_tile_core", tuple(range(3, 3 + core)), matrix_bytes=u))
        for g in tq.random_circuit(n, 30, seed=threads + 1).gates:
            c.append(g)
    prog = sweeps_case(c, ts.SweepParams(k_bits=2, rb_bits=4),
                       ts.SweepGeometry(threads=threads, in_flight=in_flight))
    geometry = [geo for row in host.sweep_geometry(prog) for geo in row if geo is not None]
    assert max(group_bits for _, _, group_bits in geometry) >= 1
    assert max(lay.kbits - int(t.ints[ts.HEADER_TILE_BITS])
               for t, lay in zip(prog.tables, prog.layouts)) >= 2


# (k, control, ring, groups a tile): one k-qubit core on a low sweep's
# unit, as test_torch_dense_op's low-sweep cases place it (12 qubits, 14
# for k = 9 and 10, where 2^k <= 4 x threads needs a 2^12-slot unit)
SWEEP_CORES = [
    (5, "none", True, 32), (5, "local", True, 16), (5, "ext", True, 32),
    (6, "none", True, 16), (6, "local", True, 8), (6, "ext", True, 16),
    (7, "none", False, 8), (7, "local", False, 4), (7, "ext", False, 8),
    (8, "none", False, 4), (8, "local", False, 2), (8, "ext", False, 4),
    (9, "none", False, 8), (9, "local", False, 4), (9, "ext", False, 8),
    (10, "local", False, 2),
]


@pytest.mark.parametrize("k,control,ring,groups", SWEEP_CORES)
def test_sweeps_one_core(k, control, ring, groups):
    n, rb = (12, 2) if k <= 8 else (14, 4)
    targets = tuple(range(n - 2 - k, n - 2))
    ctrl = {"none": (), "local": (0,), "ext": (n - 1,)}[control]
    u = under_control(dense_unitary(k, np.random.default_rng(600 + k)), ctrl)
    c = tq.Circuit(n).append(Gate(f"host_sweep_core{k}", ctrl + targets, matrix_bytes=u.tobytes()))
    # the wide instance's tiled op at every width, 10 qubits too (the route
    # sends a unit stage of 10+ qubits to the dense pass: the sweep in one
    # launch keeps it on the tiled op)
    prog = sweeps_case(c, ts.SweepParams(k_bits=2, rb_bits=rb), _one_launch=True)
    assert prog.sweep_kinds == ["low"]
    assert [ln.route for ln in prog.launches[0]] == ["mixed"]
    ((threads, _, _),), = host.sweep_geometry(prog)
    (op,) = unit_ops(prog.tables[0])
    assert (bool(op[3]), bool(op[5])) == (control == "local", control == "ext")
    assert tile_shape(op, prog.layouts[0].kbits, 32 * threads) == (ring, groups)


def wide_circuit(n: int) -> tq.Circuit:
    """5- and 6-qubit cores on low and high bits, under controls and not,
    with controls and swaps across the state, among random gates."""
    d5 = dense_unitary(5, np.random.default_rng(805)).tobytes()
    d6 = dense_unitary(6, np.random.default_rng(806)).tobytes()
    c = tq.random_circuit(n, 20, seed=n)
    c.append(Gate("host_wide5", (n - 1, 2, n - 2, 5, 0), matrix_bytes=d5))
    c.toffoli(n - 1, 1, n - 2).cry(2, n - 3, 0.6)
    c.append(Gate("host_wide6", (1, n - 4, 3, n - 1, 4, n - 2), matrix_bytes=d6))
    c.swap(0, n - 1).crz(n - 2, 3, 0.8).cp(n - 1, n - 4, 1.2)
    for g in tq.random_circuit(n, 20, seed=n + 1).gates:
        c.append(g)
    return c


def whole_case(c: tq.Circuit, tile_bits=None, ctas=None):
    prog = fc.WholeCircuitProgram(c, tile_bits, ctas)
    psi = random_state(c.num_qubits, np.random.default_rng(c.num_qubits + len(c.gates)))
    got = host.run_whole_circuit(prog, psi)
    check(got, prog, c, psi, emulate_whole_circuit(psi, prog))
    return prog


@pytest.mark.parametrize("name", ["random", "qft", "wide"])
@pytest.mark.parametrize("n", [10, 11, 12, 13])
def test_whole_circuit(name, n):
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=n),
        "qft": lambda: tq.qft_circuit(n),
        "wide": lambda: wide_circuit(n),
    }[name]()
    prog = whole_case(c)
    assert (prog.tile_bits, prog.ctas) == (min(fc.GEOMETRY[n][0], n), fc.GEOMETRY[n][1])


# (n, k, controlled, spare, ring, groups a tile): one core alone on the
# whole-circuit route; spare: the launch's threads exceed the tile's
WHOLE_CORES = [
    (10, 5, False, False, True, 32),
    (10, 8, True, False, False, 2),
    (10, 9, False, True, False, 2),
    (12, 9, True, False, False, 4),
    (11, 10, True, True, False, 1),
    (12, 10, False, False, False, 4),
]


@pytest.mark.parametrize("n,k,controlled,spare,ring,groups", WHOLE_CORES)
def test_whole_circuit_one_core(n, k, controlled, spare, ring, groups):
    ctrl = (n - 1,) if controlled else ()
    u = under_control(dense_unitary(k, np.random.default_rng(700 + k)), ctrl)
    gate = Gate(f"host_whole_core{k}", ctrl + tuple(range(k)), matrix_bytes=u.tobytes())
    prog = whole_case(tq.Circuit(n).append(gate))
    assert (prog.threads > 1 << (prog.tile_bits - REG_BITS)) == spare
    (op,) = unit_ops(prog.table)
    assert tile_shape(op, n, 32 * prog.threads) == (ring, groups)


# (k, CTAs, ring, groups a tile): one core at 12 qubits in tiles of 2^10
# slots (64 threads: a scratch of 2048 float2), so the tiled op's tiles
# outnumber the CTAs and each CTA takes several in turn: with the ring, the
# next tile's copies stream into the second buffer while this one's product
# runs
TILED_RUNS = [(5, 1, True, 32), (5, 2, True, 32), (6, 1, True, 16), (7, 1, False, 16)]


@pytest.mark.parametrize("k,ctas,ring,groups", TILED_RUNS)
def test_whole_circuit_tiles_in_turn(k, ctas, ring, groups):
    n, tile_bits = 12, 10
    core = dense_unitary(k, np.random.default_rng(750 + k))
    gate = Gate(f"host_turn_core{k}", tuple(range(2, 2 + k)), matrix_bytes=core.tobytes())
    prog = whole_case(tq.Circuit(n).append(gate), tile_bits, ctas)
    assert (prog.threads, prog.ctas) == (64, ctas)
    (op,) = unit_ops(prog.table)
    assert tile_shape(op, n, 32 * prog.threads) == (ring, groups)
    tiles = (1 << (n - k)) // groups
    assert tiles > ctas


# (n, rb_bits, k, lo): a k-qubit core on qubits lo..lo+k-1 (one of them a
# mid bit: a low sweep) between random layers; its unit stage runs alone on
# the wide instance (k < 10) or through the dense pass (k = 10: at 13
# qubits its tiled op would need more threads than the unit's tiles have),
# the tile stages around it on the instance for narrow cores
SPLIT_CASES = [(12, 2, 6, 4), (13, 2, 8, 2), (13, 2, 10, 1)]


@pytest.mark.parametrize("n,rb,k,lo", SPLIT_CASES)
def test_split_launches_match_one_launch_mirror(n, rb, k, lo):
    params = ts.SweepParams(k_bits=2, rb_bits=rb)
    u = dense_unitary(k, np.random.default_rng(900 + k)).tobytes()
    c = tq.random_circuit(n, 30, seed=k)
    c.append(Gate(f"host_split_core{k}", tuple(range(lo, lo + k)), matrix_bytes=u))
    for g in tq.random_circuit(n, 30, seed=k + 1).gates:
        c.append(g)
    prog = ts.SweepProgram(c, params)
    routes = [[ln.route for ln in launches] for launches in prog.launches]
    core_route = "pass" if k >= ts.MIN_SWEEP_PASS_CORE else "unit"
    (i,) = [i for i, r in enumerate(routes) if core_route in r]
    assert prog.sweep_kinds[i] == "low" and "mixed" not in sum(routes, [])
    assert routes[i].count(core_route) == 1 and set(routes[i]) == {"tile", core_route}
    psi = random_state(n, np.random.default_rng(n + k))
    got = host.run_sweeps(prog, psi)
    # the one-launch mirror: each sweep's whole table, every stage in one
    # launch, the unit stage on the tiled op (on as many threads as it needs)
    re, im = psi.real.copy(), psi.imag.copy()
    for table, bits in zip(prog.tables, prog.tile_bits):
        emulate_sweep(re, im, table, 0, max(1 << (bits - REG_BITS), (1 << table.max_core) // 4))
    check(got, prog, c, psi, re + 1j * im)
    np.testing.assert_allclose(got, emulate_launches(prog, psi), atol=MIRROR_TOL, rtol=0)


def test_tile_launches_take_the_tiles_of_a_sweep_with_a_wide_core(monkeypatch):
    # a geometry of more threads than a wide core's launch may take
    # (WIDE_THREADS; on the card 1024 against 512, here 128 against 64): the
    # sweep's tiles are the wide launch's, and the runs of tile stages
    # around its unit stage launch at those threads too (at the geometry's
    # they would trap on the table's tile bits)
    monkeypatch.setattr(ts, "WIDE_THREADS", 64)
    n = 14
    u = dense_unitary(6, np.random.default_rng(960)).tobytes()
    c = tq.random_circuit(n, 30, seed=61)
    c.append(Gate("host_wide_geometry_core6", tuple(range(3, 9)), matrix_bytes=u))
    for g in tq.random_circuit(n, 30, seed=62).gates:
        c.append(g)
    prog = sweeps_case(c, ts.SweepParams(k_bits=2, rb_bits=4),
                       ts.SweepGeometry(threads=128, in_flight=2))
    (i,) = [i for i, sw in enumerate(prog.launches) if any(ln.route == "unit" for ln in sw)]
    assert "tile" in [ln.route for ln in prog.launches[i]]
    assert prog.geometries[i].threads == 64 and prog.tile_bits[i] == 10
    assert {geo[0] for geo in host.sweep_geometry(prog)[i]} == {64}
    assert any(g.threads == 128 for g in prog.geometries)
