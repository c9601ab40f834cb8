"""The tiled dense-core op and the grid sweep's register planner, on the CPU.

* :func:`emulate_tiled_op` mirrors the numerics of ops.cuh's tiled op: the
  product in its real form on the tensor cores, every operand split into
  TF32 parts (``test_torch_dense_pass.tf32_split``), each real product
  hi.lo + lo.hi + hi.hi, chunk by chunk of 32 columns, each chunk's share
  rounded to float32 and added to float32 accumulators. Every kernel's
  mirror multiplies a core of ``TILE_CORE`` qubits or more through it.
* Cores of 5-10 qubits under a control, through the op tables of every
  kernel (whole circuit, grid sweep, segments, low sweep) and each kernel's
  numpy mirror, agree with the JAX package's complex128 oracle within 1e-5:
  the coefficients column-major at an even offset, the groups enumerated
  with the control bits fixed, the tiles dealt to a Part's CTAs in turn.
  One core of 5-11 qubits alone on a random state of at most 14 qubits,
  uncontrolled, under a block-local control and under a control outside
  the block, through each mirror that takes it, agrees with the oracle
  within 1e-6 and with the plain version within 1e-7.
* The grid sweep's register planner (``gridsweeps.register_table``) puts
  every op in a run whose register and lane bits cover its moving qubits;
  the tables with their remaps, through the grid mirror, agree with the
  oracle on ``random_circuit``, the ``mixed`` circuit and a wide-core
  circuit at 12-14 qubits, at r = 3 and r = 4.
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.convert import circuit_from_jax
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import segmented as seg
from tpu_qsim_torch.kernels import sweeps as ts

from conftest import random_state
from test_torch_dense_pass import tf32_split
from test_torch_gridsweeps import _mixed_circuit, emulate_sweep as emulate_grid_sweep
from test_torch_segmented import emulate_segments
from test_torch_sweeps import emulate_sweep, jax_oracle, register_both, tiled_bases
from test_torch_whole_circuit import emulate_whole_circuit
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-5
CHUNK_COLUMNS = 32   # ops.cuh's TILE_CHUNK k8 steps of 4 complex columns


def emulate_tiled_op(u: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Y = U X as ops.cuh's tiled op takes it on the tensor cores: the
    float32 core ``u`` (D x D) and amplitudes ``x`` (D x groups), each plane
    split into its TF32 parts (:func:`tf32_split`, as the kernel splits
    every operand in registers), the real form Yr = Ur Xr - Ui Xi, Yi = Ui Xr
    + Ur Xi with each real product al bh + ah bl + ah bh, chunk by chunk of
    ``CHUNK_COLUMNS`` columns: a chunk's share (summed here in float64; the
    tensor cores' fresh accumulators) rounded to float32 and added to the
    float32 accumulators, rounded to nearest. Returns complex128 holding
    the float32 results."""
    u = np.asarray(u, np.complex128)
    x = np.asarray(x, np.complex128)
    d = u.shape[0]
    assert u.shape == (d, d) and x.shape[0] == d and d % CHUNK_COLUMNS == 0
    urh, url = tf32_split(u.real)
    uih, uil = tf32_split(u.imag)
    xrh, xrl = tf32_split(x.real)
    xih, xil = tf32_split(x.imag)
    yr = np.zeros(x.shape, np.float32)
    yi = np.zeros(x.shape, np.float32)
    for c0 in range(0, d, CHUNK_COLUMNS):
        ch = slice(c0, c0 + CHUNK_COLUMNS)

        def prod(ah, al, bh, bl):
            return al[:, ch] @ bh[ch] + ah[:, ch] @ bl[ch] + ah[:, ch] @ bh[ch]

        yr = yr + (prod(urh, url, xrh, xrl) - prod(uih, uil, xih, xil)).astype(np.float32)
        yi = yi + (prod(uih, uil, xrh, xrl) + prod(urh, url, xih, xil)).astype(np.float32)
    return yr.astype(np.float64) + 1j * yi.astype(np.float64)


def dense_unitary(k: int, rng) -> np.ndarray:
    """A dense k-qubit unitary in O(4^k): a random phase on each column of a
    Kronecker product of random 1-qubit unitaries (every entry nonzero, and
    each qubit's factor different, so a wrong bit order shows)."""
    u = np.ones((1, 1), dtype=np.complex128)
    for _ in range(k):
        m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        u = np.kron(u, np.linalg.qr(m)[0])
    return u * np.exp(2j * np.pi * rng.random(1 << k))[None, :]


def _controlled_dense(k: int) -> str:
    """A random dense k-qubit unitary under one MSB control, in both
    packages."""
    name = f"torch_tiled_dense{k}_c1"
    u = np.eye(2 << k, dtype=np.complex128)
    u[1 << k:, 1 << k:] = dense_unitary(k, np.random.default_rng(200 + k))
    register_both(name, u)
    return name


def _between_random(n: int, name: str, qubits, seed: int = 5) -> tq.Circuit:
    c = tq.random_circuit(n, 20, seed=seed)
    c.add(name, *qubits)
    for g in tq.random_circuit(n, 20, seed=seed + 1).gates:
        c.append(g)
    return c


def test_tiled_bases_cover_every_group_once():
    # a 6-qubit core with two block-local controls in a 12-bit block: 16
    # groups, in tiles of 128 / 64 = 2 groups in a scratch of 128 float2,
    # dealt to the CTAs in turn
    lay = fc.BlockLayout(12, 12, ())
    u = np.eye(1 << 8, dtype=np.complex128)
    rng = np.random.default_rng(0)
    m = rng.standard_normal((64, 64)) + 1j * rng.standard_normal((64, 64))
    u[-64:, -64:] = np.linalg.qr(m)[0]
    t = fc.build_op_table(fc.as_pgates([(u, (11, 3, 0, 9, 5, 7, 2, 4))]), lay, max_bits=12)
    op = t.ints[fc.SWEEP_HEADER:fc.SWEEP_HEADER + fc.OP_HEADER]
    assert op[1] == 6 and op[3] == op[4] == (1 << 11) | (1 << 3)
    assert [p.size for p in tiled_bases(op, 12, 16, 128)] == [2] * 8 + [0] * 8
    parts = tiled_bases(op, 12, 4, 128)
    assert [p.size for p in parts] == [4, 4, 4, 4]
    np.testing.assert_array_equal(parts[1][:2], tiled_bases(op, 12, 1, 128)[0][2:4])
    # the sweep kernel at 256 threads: 32 x 256 float2, 128 groups a tile,
    # more than it has; its ring of two tiles of 64 groups, the same
    assert [p.size for p in tiled_bases(op, 12, 2, 32 * 256)] == [16, 0]
    assert [p.size for p in tiled_bases(op, 12, 2, 32 * 256, ring=True)] == [16, 0]
    # a ring only where each of its two tiles takes 16 groups or more
    assert [p.size for p in tiled_bases(op, 12, 16, 256, ring=True)] == [4] * 4 + [0] * 12
    assert [p.size for p in tiled_bases(op, 12, 16, 1 << 14, ring=True)] == [16] + [0] * 15
    with pytest.raises(AssertionError, match="two groups"):
        tiled_bases(op, 12, 1, 64)
    bases = np.sort(np.concatenate(parts))
    want = [b for b in range(1 << 12)
            if not b & sum(1 << q for q in (0, 9, 5, 7, 2, 4)) and (b >> 11) & 1 and (b >> 3) & 1]
    np.testing.assert_array_equal(bases, want)


# a segment holds gates of at most 14 - 5 = 9 qubits
@pytest.mark.parametrize("kernel,k", [
    (kernel, k) for kernel in ("whole_circuit", "grid_sweep", "segment", "low_sweep")
    for k in range(5, 11) if (kernel, k) != ("segment", 10)
])
def test_tiled_core_through_each_mirror(kernel, k):
    name = _controlled_dense(k)
    if kernel == "whole_circuit":
        n = 12
        qubits = (11,) + tuple(range(10 - k, 10)) if k < 10 else (11,) + tuple(range(10))
        c = _between_random(n, name, qubits)
        prog = fc.WholeCircuitProgram(c)
        assert prog.table.max_core == k and (prog.tile_bits, prog.ctas) == fc.GEOMETRY[n]
        assert prog.threads == max(1 << (prog.tile_bits - 4), (1 << k) // 4)
        psi = random_state(n, np.random.default_rng(k))
        got = emulate_whole_circuit(psi, prog)
    elif kernel == "grid_sweep":
        n = 13
        c = _between_random(n, name, (12,) + tuple(range(k)))
        prog = tgs.GridSweepProgram(c)
        assert max(t.max_core for t in prog.tables) == k
        psi = random_state(n, np.random.default_rng(k))
        re, im = psi.real.copy(), psi.imag.copy()
        for table in prog.tables:
            emulate_grid_sweep(re, im, table)
        got = re + 1j * im
    elif kernel == "segment":
        # every qubit of a gate is made local, its control too: at 9 qubits
        # the core comes without one
        n = 15
        if k == 9:
            name = f"torch_tiled_dense{k}"
            register_both(name, dense_unitary(k, np.random.default_rng(209)))
            c = _between_random(n, name, tuple(range(n - k, n)))
        else:
            c = _between_random(n, name, (0,) + tuple(range(n - k, n)))
        prog = seg.SegmentedProgram(c)
        assert max(s.table.max_core for s in prog.steps) == k
        assert prog.swap_min == max(5, min(7, prog.local_bits - min(k + 1, 9)))
        psi = random_state(n, np.random.default_rng(k))
        got = emulate_segments(psi, prog)
    else:
        # SweepParams(2, 2): low block bits 0..9; the control on a top bit.
        # A sweep's CTA holds one tile of 16 amplitudes a thread, and the
        # tiled op needs 2^k <= 4 x threads: cores of 9 and 10 qubits take
        # a unit of 12 bits or more, SweepParams(2, 4) at 14 qubits
        n, rb = (12, 2) if k <= 8 else (14, 4)
        c = _between_random(n, name, (n - 1,) + tuple(range(n - 2 - k, n - 2)))
        prog = ts.SweepProgram(c, ts.SweepParams(k_bits=2, rb_bits=rb))
        assert max(t.max_core for t in prog.tables) == k
        psi = random_state(n, np.random.default_rng(k))
        re, im = psi.real.copy(), psi.imag.copy()
        for table in prog.tables:
            emulate_sweep(re, im, table, group_bits=1)
        got = re + 1j * im
    np.testing.assert_allclose(got, jax_oracle(c, psi), atol=TOL, rtol=0)


def _dense_ops(ints: np.ndarray, stages: bool) -> list:
    """The op words of every dense op in a register table, or in each stage
    table of a sweep table (``stages``)."""
    if stages:
        n = int(ints[0])
        desc = ints[fc.SWEEP_HEADER:fc.SWEEP_HEADER + n * ts.STAGE_WORDS].reshape(n, ts.STAGE_WORDS)
        return [o for d in desc for o in _dense_ops(ints[int(d[1]):], False)]
    ops = [ints[fc.SWEEP_HEADER + o * fc.OP_HEADER:][:fc.OP_HEADER] for o in range(int(ints[0]))]
    return [o for o in ops if o[0] == fc.KIND_DENSE]


# (kernel, k, control): one k-qubit core alone on a state of at most 14
# qubits through each kernel that takes it there. The control is a block
# bit ("local") or a bit outside the block ("ext": the grid sweep's inactive
# bit, the low sweep's part bit); the whole circuit and the segments have
# no bit outside. An 11-qubit core comes uncontrolled (a controlled one is
# a 4096 x 4096 complex128 matrix).
NUMERICS_CASES = [
    *[("whole_circuit", k, c) for k in range(5, 12) for c in ("none", "local") if (k, c) != (11, "local")],
    *[("grid_sweep", k, c) for k in range(5, 12) for c in ("none", "local", "ext") if k < 11 or c == "none"],
    *[("segment", k, c) for k, c in ((5, "none"), (5, "local"), (6, "none"), (6, "local"),
                                      (7, "none"), (7, "local"), (8, "none"))],
    *[("low_sweep", k, c) for k in range(5, 11) for c in ("none", "local", "ext")],
]


@pytest.mark.parametrize("kernel,k,control", NUMERICS_CASES)
def test_tiled_op_numerics_through_each_mirror(kernel, k, control):
    from tpu_qsim_torch.circuit import Gate

    n = {"whole_circuit": 12, "grid_sweep": 14, "low_sweep": 12 if k <= 8 else 14,
         "segment": {(5, "none"): 12, (5, "local"): 12, (6, "none"): 12, (6, "local"): 13,
                     (7, "none"): 13, (7, "local"): 14, (8, "none"): 14}.get((k, control))}[kernel]
    targets = {"whole_circuit": tuple(range(k)), "grid_sweep": tuple(range(k)),
               "segment": tuple(range(n - k, n)), "low_sweep": tuple(range(n - 2 - k, n - 2))}[kernel]
    ctrl = {"none": (), "local": {"whole_circuit": (n - 1,), "grid_sweep": (k,)}.get(kernel, (0,)),
            "ext": (n - 1,)}[control]
    core = dense_unitary(k, np.random.default_rng(400 + k))
    u = core
    if ctrl:
        u = np.eye(2 << k, dtype=np.complex128)
        u[1 << k:, 1 << k:] = core
    c = tq.Circuit(n).append(Gate(f"tiled{k}", ctrl + targets, matrix_bytes=u.tobytes()))
    psi = random_state(n, np.random.default_rng(n + k))
    if kernel == "whole_circuit":
        prog = fc.WholeCircuitProgram(c)
        ops = _dense_ops(prog.table.ints, True)
        got = emulate_whole_circuit(psi, prog)
    elif kernel == "segment":
        prog = seg.SegmentedProgram(c)
        ops = [o for st in prog.steps for o in _dense_ops(st.table.ints, False)]
        got = emulate_segments(psi, prog)
    else:
        if kernel == "grid_sweep":
            prog = tgs.GridSweepProgram(c)
            ops = [o for t in prog.tables for o in _dense_ops(t.ints, False)]
        else:
            prog = ts.SweepProgram(c, ts.SweepParams(k_bits=2, rb_bits=2 if k <= 8 else 4))
            assert prog.sweep_kinds == ["low"]
            ops = [o for t in prog.tables for o in _dense_ops(t.ints, True)]
        re, im = psi.real.copy(), psi.imag.copy()
        for table in prog.tables:
            (emulate_grid_sweep if kernel == "grid_sweep" else emulate_sweep)(re, im, table)
        got = re + 1j * im
    # the op table holds the core with the control where the case puts it
    (op,) = ops
    assert int(op[1]) == k
    assert (bool(op[3]), bool(op[5])) == (control == "local", control == "ext")
    np.testing.assert_allclose(got, jax_oracle(c, psi), atol=1e-6, rtol=0)
    x = torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32))
    plain = tq.apply.to_complex(prog.run_plain(x))
    np.testing.assert_allclose(got, plain, atol=1e-7, rtol=0)


def test_emulate_tiled_op_is_float32_accurate():
    # an 11-qubit core on 8 groups: the split products, chunk by chunk, stay
    # within float32's reach of the complex128 product of the float32 inputs
    # (TF32 alone, the high parts only, does not)
    rng = np.random.default_rng(11)
    u = dense_unitary(11, rng).astype(np.complex64)
    x = (rng.standard_normal((2048, 8)) + 1j * rng.standard_normal((2048, 8))).astype(np.complex64)
    x /= np.linalg.norm(x, axis=0)
    want = u.astype(np.complex128) @ x.astype(np.complex128)
    got = emulate_tiled_op(u, x)
    assert np.abs(got - want).max() <= 1e-7
    hi_only = (tf32_split(u.real)[0] + 1j * tf32_split(u.imag)[0]) @ (
        tf32_split(x.real)[0] + 1j * tf32_split(x.imag)[0])
    assert np.abs(hi_only - want).max() > 1e-5


# ---------------------------------------------------------------------------
# the grid sweep's register planner
# ---------------------------------------------------------------------------


def _runs_cover_their_ops(table: fc.OpTable) -> dict:
    """Walk a register table as the kernel does; assert that every register
    dense op's targets are register or lane bits of the current run, and
    count the ops in registers, in shared memory and the remaps."""
    ints = table.ints
    r = int(ints[tgs.HEADER_REG_BITS])
    regs = set(int(x) for x in ints[tgs.HEADER_REGS:tgs.HEADER_REGS + r])
    n_ops = int(ints[0])
    flags = ints[fc.SWEEP_HEADER + n_ops * fc.OP_HEADER:][::tgs.DESC_WORDS]
    counts = {"regs": 0, "smem": 0, "remap": 0}
    for o in range(n_ops):
        op = ints[fc.SWEEP_HEADER + o * fc.OP_HEADER:][:fc.OP_HEADER]
        if op[0] == tgs.KIND_REMAP:
            regs = set(int(x) for x in op[8:8 + r])
            counts["remap"] += 1
        elif flags[o] & tgs.D_REG:
            if op[0] != fc.KIND_DIAG:
                assert set(int(c) for c in op[8:8 + int(op[1])]) <= regs | set(range(tgs.LANE_BITS))
            counts["regs"] += 1
        else:
            assert op[0] != fc.KIND_DIAG and op[1] > tgs.REG_CORE
            counts["smem"] += 1
        assert len(regs) == r
    return counts


def _wide_register_circuit(n: int) -> tq.Circuit:
    """3- and 6-qubit cores between random layers: runs of register ops cut
    by shared-memory ops."""
    for k in (3, 6):
        rng = np.random.default_rng(300 + k)
        m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
        register_both(f"torch_reg_dense{k}", np.linalg.qr(m)[0])
    c = tq.random_circuit(n, 30, seed=7)
    c.add("torch_reg_dense3", 6, 1, n - 1)
    for g in tq.random_circuit(n, 20, seed=8).gates:
        c.append(g)
    c.add("torch_reg_dense6", 0, 5, 2, 7, 3, 6)
    for g in tq.random_circuit(n, 20, seed=9).gates:
        c.append(g)
    return c


@pytest.mark.parametrize("blk,a", [(8, 5), (6, 3), (8, 4), (7, 3)])
@pytest.mark.parametrize("n", [12, 13, 14])
@pytest.mark.parametrize("name", ["random", "mixed", "wide"])
def test_register_planner_runs_match_oracle(name, n, blk, a):
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=n),
        "mixed": lambda: circuit_from_jax(_mixed_circuit(n)),
        "wide": lambda: _wide_register_circuit(n),
    }[name]()
    prog = tgs.GridSweepProgram(c, tgs.GridParams(blk, a))
    totals = {"regs": 0, "smem": 0, "remap": 0}
    for table, lay in zip(prog.tables, prog.layouts):
        assert lay.kbits == blk + min(a, n - blk)
        assert int(table.ints[tgs.HEADER_REG_BITS]) == tgs.REG_BITS
        for key, v in _runs_cover_their_ops(table).items():
            totals[key] += v
    assert totals["regs"] > 0 and totals["remap"] <= totals["regs"]
    assert (totals["smem"] > 0) == (name != "random")    # swaps and wide cores
    psi = random_state(n, np.random.default_rng(n + blk))
    re, im = psi.real.copy(), psi.imag.copy()
    for table in prog.tables:
        emulate_grid_sweep(re, im, table)
    np.testing.assert_allclose(re + 1j * im, jax_oracle(c, psi), atol=TOL, rtol=0)


def test_register_table_remaps_greedily():
    # a 13-bit block (lanes 0-4, r = 4 of bits 5-12): the first run takes
    # the first ops' targets in order, then the lowest free bits; after a
    # shared-memory op (a 2-qubit core) the next run is chosen anew from the
    # next ops' targets, then the current bits; a 1-qubit core names its
    # register position or its lane bit
    lay = fc.BlockLayout(13, 8, (8, 9, 10, 11, 12))
    h = tq.gates.gate_matrix("h")
    cn = tq.gates.gate_matrix("cnot").astype(np.complex128)
    u2 = dense_unitary(2, np.random.default_rng(4))
    gates = fc.as_pgates([(h, (5,)), (h, (6,)), (u2, (7, 2)), (h, (12,)),
                          (cn, (0, 11)), (h, (3,)), (h, (10,))])
    t = tgs.register_table(fc.build_op_table(gates, lay))
    ints = t.ints
    assert list(ints[tgs.HEADER_REGS:tgs.HEADER_REGS + 4]) == [5, 6, 7, 8]
    n_ops = int(ints[0])
    ops = ints[fc.SWEEP_HEADER:fc.SWEEP_HEADER + n_ops * fc.OP_HEADER].reshape(-1, fc.OP_HEADER)
    assert [int(o[0]) for o in ops] == [1, 1, 1, tgs.KIND_REMAP, 1, 1, 1, 1]
    assert list(ops[3, 8:12]) == [5, 10, 11, 12]
    # after the ops, one descriptor per op: flags, then (coefficient offset,
    # controls, out-of-block controls, target, diagonal qubits)
    desc = ints[fc.SWEEP_HEADER + n_ops * fc.OP_HEADER:].reshape(n_ops, tgs.DESC_WORDS)
    reg, swap, lane = tgs.D_REG, tgs.D_SWAP, tgs.D_LANE
    assert list(desc[:, 0]) == [reg, reg, 0, tgs.D_REMAP, reg, reg | swap, reg | lane, reg]
    assert desc[0, 6] == 0 and desc[4, 6] == 3          # h on 5, h on 12: positions
    # the cnot: an X core on 11 (register position 2) under the lane control 0
    assert list(desc[5, 1:7]) == [int(ops[5, 2]), 1, 1, 0, 0, 2]
    assert desc[6, 6] == 3                               # h on lane bit 3
    np.testing.assert_array_equal(t.coef, fc.build_op_table(gates, lay).coef)


def test_register_bits_follow_the_geometry():
    # 16 amplitudes a thread: a block of 2^k slots takes 2^(k - 4) threads,
    # one warp at 9 bits to 512 at 13; the planner refuses other blocks
    assert tgs.REG_BITS == 4
    assert [tgs.block_threads(k) for k in range(9, 14)] == [32, 64, 128, 256, 512]
    for bad in (8, 14):
        with pytest.raises(ValueError, match="blocks of"):
            tgs.block_threads(bad)
    with pytest.raises(ValueError, match="blocks of"):
        tgs.GridSweepProgram(tq.random_circuit(10, 20, seed=1), tgs.GridParams(5, 3))
