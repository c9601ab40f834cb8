"""Segmented engine of the port against the JAX package's.

* The port's ``plan_segments`` and ``plan_blockswap_segments`` give the JAX
  planners' plans: the same segments, gates, ``perm_src`` and restore.
* The port's ``permute_qubits`` agrees with the JAX one exactly (a copy of
  the same values), and with a plain numpy relabeling on the bits the JAX
  one refuses to move.
* ``SegmentedProgram.run_plain`` agrees with the JAX segmented engine in
  Pallas interpret mode at 12 qubits within 5e-5, the tolerance of
  ``tests/test_segmented.py``.
* The program's run table (each segment's register table and host-built
  index maps), executed by a numpy mirror of ``csrc/segment.cu`` (a range
  of segments, two buffers, each block through
  ``test_torch_gridsweeps.emulate_block``), agrees with the complex128
  oracle within 1e-6 at blocks of 2^10 to 2^14 slots, with a 9-qubit gate
  in a 14-bit block, and with the JAX segmented engine. The CUDA kernel
  runs only on the card (tests/test_torch_cuda.py).
"""

import jax
import numpy as np
import pytest
import torch

import tpu_qsim as jq
import tpu_qsim.apply as jap
from tpu_qsim import schedule as jsched
from tpu_qsim.kernels.segmented import build_segmented_run

import tpu_qsim_torch as tq
from tpu_qsim_torch import schedule as tsched
from tpu_qsim_torch.convert import circuit_from_jax
from tpu_qsim_torch.kernels import LAUNCHES, SEGMENT_KINDS, reset_launches
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import segmented as seg

from conftest import random_state
from test_torch_gridsweeps import emulate_block
from torch_threads import one_blas_thread  # noqa: F401

N = 13


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def _mixed_circuit(n: int) -> "jq.Circuit":
    c = jq.Circuit(n)
    c.h(n - 1).h(0).toffoli(n - 1, 3, n - 2).cry(1, n - 1, 0.3)
    c.mcz(0, 5, n - 2, n - 1).swap(n - 2, n - 1).crz(n - 1, 2, 0.7)
    c.cp(n - 2, n - 1, 1.1).swap(0, n - 3).rx(n - 3, 0.4).cz(n - 1, 4)
    c.ry(n - 2, 1.3).cnot(n - 3, n - 1).t(n - 1).s(0).y(n - 2)
    return c


def _same_gate(pg, jg) -> bool:
    return (pg.name, tuple(pg.qubits), pg.param, pg.matrix_bytes) == (
        jg.name, tuple(jg.qubits), jg.param, jg.matrix_bytes)


# ---------------------------------------------------------------------------
# planner parity
# ---------------------------------------------------------------------------


def _low_first(c: "jq.Circuit") -> "jq.Circuit":
    """``c`` behind an h on qubit 0: with ``stage_min`` both planners refuse
    a relocation before the first segment, and spin when no ready gate is
    local, so a staged plan has to open on a local gate."""
    out = jq.Circuit(c.num_qubits).h(0)
    for g in c.gates:
        out.append(g)
    return out


@pytest.mark.parametrize("local_bits,stage_min", [(10, None), (11, None), (12, None), (12, 10)])
@pytest.mark.parametrize("name", ["random0", "random1", "random2", "qft", "mixed"])
def test_plan_segments_matches_jax(name, local_bits, stage_min):
    c = {
        "random0": lambda: jq.random_circuit(N, 120, seed=0),
        "random1": lambda: jq.random_circuit(N, 80, seed=1),
        "random2": lambda: jq.random_circuit(N, 200, seed=2),
        "qft": lambda: jq.qft_circuit(N),
        "mixed": lambda: _mixed_circuit(N),
    }[name]()
    if stage_min is not None:
        c = _low_first(c)
    jsegs, jrest = jsched.plan_segments(c, local_bits, stage_min=stage_min)
    psegs, prest = tsched.plan_segments(circuit_from_jax(c), local_bits, stage_min=stage_min)
    assert prest == jrest
    assert len(psegs) == len(jsegs)
    for ps, js in zip(psegs, jsegs):
        assert ps.perm_src == js.perm_src
        assert len(ps.gates) == len(js.gates)
        assert all(_same_gate(pg, jg) for pg, jg in zip(ps.gates, js.gates))


@pytest.mark.parametrize("device_bits,swap_min", [(1, 7), (2, 3)])
def test_plan_blockswap_segments_matches_jax(device_bits, swap_min):
    c = jq.random_circuit(N, 100, seed=device_bits)
    jsegs, jpos = jsched.plan_blockswap_segments(c, device_bits, swap_min)
    psegs, ppos = tsched.plan_blockswap_segments(circuit_from_jax(c), device_bits, swap_min)
    assert ppos == jpos and len(psegs) == len(jsegs)
    for ps, js in zip(psegs, jsegs):
        assert ps.victims == js.victims
        assert [q for _, q in ps.gates] == [q for _, q in js.gates]
        for (pu, _), (ju, _) in zip(ps.gates, js.gates):
            np.testing.assert_array_equal(pu, ju)


def test_plan_segments_refuses_like_jax():
    c = jq.random_circuit(N, 10, seed=0)
    for mod, circ in ((jsched, c), (tsched, circuit_from_jax(c))):
        with pytest.raises(ValueError, match="whole-circuit"):
            mod.plan_segments(circ, N)
        with pytest.raises(ValueError, match="swap slots"):
            mod.plan_segments(circ, 9)


# ---------------------------------------------------------------------------
# permute_qubits
# ---------------------------------------------------------------------------


def _numpy_permute(psi: np.ndarray, src) -> np.ndarray:
    n = len(src)
    new = np.arange(1 << n)
    old = np.zeros_like(new)
    for i, s in enumerate(src):
        old |= ((new >> i) & 1) << s
    return psi[old]


@pytest.mark.parametrize("seed", range(3))
def test_permute_qubits_matches_jax(seed):
    n = 12
    rng = np.random.default_rng(seed)
    src = tuple(range(7)) + tuple(7 + rng.permutation(n - 7))
    psi = random_state(n, rng)
    want = jap.to_complex(jap.permute_qubits(jap.from_complex(psi, np.float32), src))
    x = tq.apply.from_complex(psi, np.float32, "cpu")
    got = tq.apply.to_complex(tq.apply.permute_qubits(x, src))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_permute_qubits_moves_low_bits(seed):
    n = 9
    rng = np.random.default_rng(seed)
    src = tuple(int(s) for s in rng.permutation(n))
    psi = random_state(n, rng)
    x = tq.apply.from_complex(psi, np.float64, "cpu")
    got = tq.apply.to_complex(tq.apply.permute_qubits(x, src))
    np.testing.assert_array_equal(got, _numpy_permute(psi, src))
    assert tq.apply.permute_qubits(x, tuple(range(n))) is x
    with pytest.raises(ValueError, match="permutation"):
        tq.apply.permute_qubits(x, (0,) * n)


# ---------------------------------------------------------------------------
# program against the JAX segmented engine (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_program_matches_jax_segmented(seed):
    n = 12
    c = jq.random_circuit(n, 80, seed=seed)
    fn = build_segmented_run(c, np.float32, local_bits=10, interpret=True)
    want = jap.to_complex(fn(jap.initial_state(n, np.float32)))
    prog = seg.SegmentedProgram(circuit_from_jax(c), local_bits=10)
    assert prog.local_bits == 10
    got = tq.apply.to_complex(prog.run(tq.apply.initial_state(n, np.float32, device="cpu")))
    np.testing.assert_allclose(got, want, atol=5e-5)
    ora = jq.CPUReferenceSimulator(n)
    ora.run(c)
    np.testing.assert_allclose(got, ora.get_state(), atol=5e-5)
    psi0 = np.zeros(1 << n, np.complex128)
    psi0[0] = 1.0
    np.testing.assert_allclose(emulate_segments(psi0, prog), want, atol=5e-5)


# ---------------------------------------------------------------------------
# the run table, executed by a numpy mirror of csrc/segment.cu
# ---------------------------------------------------------------------------


def map_index(words: np.ndarray, x: np.ndarray) -> np.ndarray:
    """segment.cu's map of indices ``x``: the OR of one lookup per byte."""
    t = words.view(np.uint32).astype(np.int64)
    return (t[x & 255] | t[256 + ((x >> 8) & 255)] | t[512 + ((x >> 16) & 255)]
            | t[768 + (x >> 24)])


def emulate_segments(psi: np.ndarray, prog: seg.SegmentedProgram, first: int = 0,
                     last: int | None = None) -> np.ndarray:
    """``psi`` after segments ``[first, last)`` run as one launch of
    segment.cu, read from the program's run table alone: for each segment
    its descriptor, then each block gathered through the gather map, its
    register table applied (:func:`emulate_block`) and stored through the
    store map, into the other buffer when the segment relabels (every slot
    of it written)."""
    ints, coef = prog.table.ints, prog.table.coef
    n_seg, n, lb, max_core = (int(v) for v in ints[:4])
    assert (n_seg, n, lb) == (prog.num_segments, prog.num_qubits, prog.local_bits)
    assert max_core == prog.table.max_core
    last = n_seg if last is None else last
    cur = psi.astype(np.complex128).copy()
    ls = np.arange(1 << lb, dtype=np.int64)
    for s in range(first, last):
        flags, t_off, c_off, g_off, s_off = (
            int(v) for v in ints[seg.RUN_HEADER + s * seg.SEG_WORDS:][:5])
        assert c_off % 2 == 0               # 16-byte aligned for the tiled op
        sub = fc.OpTable(ints[t_off:g_off], coef[c_off:], 0.0, 0)
        assert (int(sub.ints[1]), int(sub.ints[2])) == (lb, 0)
        assert int(sub.ints[fc.HEADER_MAX_CORE]) <= max_core
        gather = ints[g_off:g_off + seg.MAP_WORDS]
        store = ints[s_off:s_off + seg.MAP_WORDS]
        out = np.full_like(cur, np.nan) if flags & seg.F_RELABEL else cur
        for b in range(1 << (n - lb)):
            new = (b << lb) | ls
            src = map_index(gather, new)
            re, im = cur[src].real.copy(), cur[src].imag.copy()
            emulate_block(re, im, sub, 0)
            out[map_index(store, new)] = re + 1j * im
        assert not np.isnan(out).any()
        cur = out
    return cur


@pytest.mark.parametrize("n,local_bits", [(12, 10), (13, 11), (13, 12), (14, 13), (15, 14)])
@pytest.mark.parametrize("name", ["random", "qft", "mixed"])
def test_maps_emulation_matches_oracle(name, n, local_bits):
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=n + local_bits),
        "qft": lambda: tq.qft_circuit(n),
        "mixed": lambda: circuit_from_jax(_mixed_circuit(n)),
    }[name]()
    prog = seg.SegmentedProgram(c, local_bits=local_bits)
    assert prog.local_bits >= local_bits and prog.threads == 1 << (prog.local_bits - 4)
    psi = random_state(n, np.random.default_rng(local_bits))
    got = emulate_segments(psi, prog)
    ref = tq.CPUReferenceSimulator(n)
    ref.set_state(psi)
    ref.run(c)
    np.testing.assert_allclose(got, ref.state, atol=1e-6, rtol=0)
    x = torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32))
    np.testing.assert_allclose(
        tq.apply.to_complex(prog.run_plain(x)), ref.state, atol=1e-5, rtol=0
    )


def test_lut_map_is_the_relabeling():
    n, lb = 13, 11
    rng = np.random.default_rng(0)
    src = tuple(int(s) for s in rng.permutation(n))
    words = seg.map_words(src)
    assert words.dtype == np.int32 and words.size == seg.MAP_WORDS
    full = map_index(words, np.arange(1 << n, dtype=np.int64))
    psi = random_state(n, rng)
    np.testing.assert_array_equal(psi[full], _numpy_permute(psi, src))
    # linear in the bits: a block's share plus its slots' map is the map
    b = 3
    ls = np.arange(1 << lb, dtype=np.int64)
    np.testing.assert_array_equal(
        map_index(words, np.array([b << lb])) | map_index(words, ls), full[(b << lb) | ls])
    ident = np.arange(1 << 26, dtype=np.int64)[::4099]
    np.testing.assert_array_equal(map_index(seg.map_words(None), ident), ident)
    # the program's table holds each segment's words at its descriptor
    prog = seg.SegmentedProgram(tq.random_circuit(N, 100, seed=5), local_bits=10)
    ints = prog.table.ints
    for i, step in enumerate(prog.steps):
        flags, t_off, _, g_off, s_off = ints[seg.RUN_HEADER + i * seg.SEG_WORDS:][:5]
        assert flags == (0 if step.in_place else seg.F_RELABEL)
        np.testing.assert_array_equal(ints[t_off:g_off], step.table.ints)
        np.testing.assert_array_equal(ints[g_off:s_off], seg.map_words(step.gather_src))
        np.testing.assert_array_equal(ints[s_off:s_off + seg.MAP_WORDS],
                                      seg.map_words(step.scatter_dst))


def test_nine_qubit_gate_in_a_fourteen_bit_block():
    # a 9-qubit gate leaves 14 - 9 = 5 low bits in place, the fewest a plan
    # keeps; its core is a tiled op in shared memory, on 1024 threads
    from tpu_qsim_torch.gates import GATE_ARITY, register_gate

    n = 15
    rng = np.random.default_rng(9)
    m = rng.standard_normal((512, 512)) + 1j * rng.standard_normal((512, 512))
    if "torch_seg_dense9" not in GATE_ARITY:
        register_gate("torch_seg_dense9", np.linalg.qr(m)[0])
    c = tq.random_circuit(n, 30, seed=9).add("torch_seg_dense9", *range(6, 15))
    for g in tq.random_circuit(n, 30, seed=10).gates:
        c.add(g.name, *g.qubits, param=g.param)
    prog = seg.SegmentedProgram(c)
    assert (prog.local_bits, prog.swap_min, prog.threads) == (14, 5, 1024)
    assert prog.table.max_core == 9
    psi = random_state(n, np.random.default_rng(4))
    ref = tq.CPUReferenceSimulator(n)
    ref.set_state(psi)
    ref.run(c)
    np.testing.assert_allclose(emulate_segments(psi, prog), ref.state, atol=1e-6, rtol=0)


@pytest.mark.parametrize("first,last", [(0, 1), (1, 3), (2, 4), (0, 4)])
def test_segment_range_matches_its_plain_version(first, last):
    # a launch of segments [first, last): the mirror and the wrapper's plain
    # version on the CPU against the segments' plain versions one by one
    prog = seg.SegmentedProgram(tq.random_circuit(N, 100, seed=5), local_bits=10)
    assert prog.num_segments >= 4
    psi = random_state(N, np.random.default_rng(first * 10 + last))
    x = torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32))
    want = x
    for i in range(first, last):
        want = prog.step_plain(want, i)
    want = tq.apply.to_complex(want)
    np.testing.assert_allclose(emulate_segments(psi, prog, first, last), want, atol=1e-6, rtol=0)
    reset_launches()
    got = tq.apply.to_complex(prog.launch(x, first, last))
    assert not LAUNCHES and not SEGMENT_KINDS
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# program and wrapper on the CPU
# ---------------------------------------------------------------------------


def test_program_steps_and_restore():
    c = tq.random_circuit(N, 100, seed=5)
    prog = seg.SegmentedProgram(c, local_bits=10)
    segs, restore = tsched.plan_segments(c, 10)
    assert prog.num_segments == len(segs) and prog.restore == restore
    assert [s.gather_src for s in prog.steps] == [s.perm_src for s in segs]
    for step, sg in zip(prog.steps[:-1], segs):
        assert step.in_place == (sg.perm_src is None) and step.kernel == "segment"
    assert restore != tuple(range(N))
    last = prog.steps[-1]
    assert last.kernel == "scatter_segment"
    assert [restore[d] for d in last.scatter_dst] == list(range(N))
    assert all(s.scatter_dst is None for s in prog.steps[:-1])
    assert prog.bytes_moved() == prog.num_segments * 16 * (1 << N)
    assert prog.flops() == sum(s.table.flops_per_amp for s in prog.steps) * (1 << N)


@pytest.mark.parametrize("n,bits", [(14, 12), (19, 12), (20, 13), (21, 14), (26, 14)])
def test_default_block_leaves_128_blocks(n, bits):
    # the largest block (2^12 to 2^14 slots) that leaves 2^7 blocks; a
    # 6-qubit gate on the top qubits, which the grid refuses, takes the
    # default from 21 qubits on instead of the 2^13 its width needs
    assert seg.default_local_bits(n) == bits
    assert bits == seg.DEFAULT_LOCAL_BITS or n - bits >= seg.MIN_BLOCKS_BITS
    if n >= 20:
        from tpu_qsim_torch.gates import GATE_ARITY, register_gate

        rng = np.random.default_rng(1)
        m = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
        if "torch_seg_dense6" not in GATE_ARITY:
            register_gate("torch_seg_dense6", np.linalg.qr(m)[0])
        c = tq.Circuit(n)
        for q in range(n):
            c.h(q)
        c.add("torch_seg_dense6", *range(n - 6, n))
        prog = seg.SegmentedProgram(c)
        assert (prog.local_bits, prog.swap_min) == (bits, 7)


def test_program_widens_block_for_wide_gates():
    from tpu_qsim_torch.gates import GATE_ARITY, register_gate

    rng = np.random.default_rng(1)
    m = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
    if "torch_seg_dense6" not in GATE_ARITY:
        register_gate("torch_seg_dense6", np.linalg.qr(m)[0])
    # 13 qubits: a 6-qubit gate would need a block of 7 + 6 = 13 bits, the
    # whole state; the block stops at 12 and keeps 6 low bits in place
    # instead of 7
    c = tq.random_circuit(N, 30, seed=1).add("torch_seg_dense6", 12, 11, 10, 9, 8, 7)
    prog = seg.SegmentedProgram(c, local_bits=10)
    assert (prog.local_bits, prog.swap_min) == (12, 6)
    psi = random_state(N, np.random.default_rng(3))
    ref = tq.CPUReferenceSimulator(N)
    ref.set_state(psi)
    ref.run(c)
    np.testing.assert_allclose(emulate_segments(psi, prog), ref.state, atol=1e-6, rtol=0)
    # an 8-qubit gate needs 5 + 8 = 13 bits: more than a 13-qubit state's block
    m8 = rng.standard_normal((256, 256)) + 1j * rng.standard_normal((256, 256))
    if "torch_seg_dense8" not in GATE_ARITY:
        register_gate("torch_seg_dense8", np.linalg.qr(m8)[0])
    c8 = tq.random_circuit(N, 30, seed=1).add("torch_seg_dense8", *range(5, 13))
    with pytest.raises(ValueError, match="needs local_bits"):
        seg.SegmentedProgram(c8, local_bits=10)
    c14 = tq.random_circuit(14, 30, seed=1).add("torch_seg_dense6", 13, 12, 11, 10, 9, 8)
    prog = seg.SegmentedProgram(c14, local_bits=10)
    assert (prog.local_bits, prog.swap_min) == (13, 7)
    psi = random_state(14, np.random.default_rng(2))
    ref = tq.CPUReferenceSimulator(14)
    ref.set_state(psi)
    ref.run(c14)
    np.testing.assert_allclose(emulate_segments(psi, prog), ref.state, atol=1e-6, rtol=0)


def test_cpu_program_runs_plain_version_without_launching():
    reset_launches()
    prog = seg.SegmentedProgram(tq.random_circuit(N, 60, seed=3), local_bits=10)
    x = tq.apply.initial_state(N, np.float32, device="cpu")
    np.testing.assert_array_equal(prog.run(x).numpy(), prog.run_plain(x).numpy())
    np.testing.assert_array_equal(prog.launch(x).numpy(), prog.run_plain(x).numpy())
    assert not LAUNCHES and not SEGMENT_KINDS
    with pytest.raises(ValueError, match="no segment kernel"):
        prog.run(x.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        prog.launch(x.to("meta"))
    with pytest.raises(ValueError, match="segments"):
        prog.launch(x, 2, 1)
    with pytest.raises(ValueError, match="float32"):
        prog.run(x.double())
    with pytest.raises(ValueError, match="local_bits"):
        seg.SegmentedProgram(tq.random_circuit(20, 10, seed=3), local_bits=15)
    with pytest.raises(ValueError, match="local_bits=8"):
        seg.SegmentedProgram(tq.Circuit(12).h(0), local_bits=8)
    with pytest.raises(ValueError, match="n <= 26"):
        seg.SegmentedProgram(tq.Circuit(27).h(0))
