"""Dense cores of 12 qubits and more: the split route and the dense pass.

* ``dispatch.plan_run`` splits a circuit at each gate whose peeled core is
  wider than ``MAX_DENSE_QUBITS`` (11): the pieces between them plan on the
  table's engine, each such gate becomes a ``DensePass``, in circuit order;
  a circuit without such a gate plans exactly as before.
* :func:`emulate_dense_pass`, a numpy mirror of ``csrc/dense_pass.cu`` (its
  four instances' CTA tiles in their launch order, the stream instance's
  persistent CTAs each walking its group tiles, the gather of X in slot
  order chunk by chunk, U's two row-major planes, the 3xTF32 split of every
  operand, the output tile in slot order, the copy of the groups whose
  controls fail), and the pass's plain version (the torch engine's
  ``apply_unitary`` under the controls) agree with the JAX package's
  complex128 oracle within 1e-6 at 14-16 qubits with a 12-qubit core,
  uncontrolled and with a control peeled, and with 7-qubit cores on the
  large and the medium instance, and 7-9-qubit cores on the stream
  instance (one group tile, several walked by each CTA, a partial one);
  the mirror agrees with the plain version within 1e-7. (float32 planes and coefficients, amplitudes <= 1: a
  4096-term sum rounds at ~1e-8 here, and the split's dropped terms are
  below 2^-21 of each product.)
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.circuit import Gate
from tpu_qsim_torch.kernels import LAUNCHES, dispatch, reset_launches
from tpu_qsim_torch.kernels import dense_pass as dp
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import segmented as seg
from tpu_qsim_torch.kernels import sweeps as ts

from conftest import random_state
from test_torch_sweeps import jax_oracle
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-6
CUDA = torch.device("cuda")


def _kron_unitary(k: int, seed: int) -> np.ndarray:
    """A dense k-qubit unitary: a Kronecker product of random 1-qubit ones
    (cheaper to make than a QR of 2^k x 2^k)."""
    rng = np.random.default_rng(seed)
    u = np.ones((1, 1), np.complex128)
    for _ in range(k):
        m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        u = np.kron(u, np.linalg.qr(m)[0])
    return u


def _gate(qubits: tuple[int, ...], controls: int = 0, seed: int = 0) -> Gate:
    """A gate on ``qubits``: a dense core under its first ``controls``
    qubits as MSB controls, carried inline (a registered gate's unitarity
    check of a 2^13 x 2^13 matrix alone takes tens of seconds here)."""
    k = len(qubits) - controls
    core = _kron_unitary(k, seed)
    if controls:
        u = np.eye(1 << (k + controls), dtype=np.complex128)
        u[-(1 << k):, -(1 << k):] = core
    else:
        u = core
    return Gate(f"kron{k}", tuple(qubits), matrix_bytes=u.tobytes())


def _circuit(n: int, *gates: Gate, seed: int = 5) -> tq.Circuit:
    """``gates`` between two random layers."""
    c = tq.random_circuit(n, 20, seed=seed)
    for g in gates:
        c.append(g)
    return c.extend(tq.random_circuit(n, 20, seed=seed + 1).gates)


# ---------------------------------------------------------------------------
# the split route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,engine", [(14, "whole_circuit"), (22, "grid_sweep")])
def test_split_orders_pieces_and_passes(n, engine):
    c = tq.Circuit(n).append(_gate(tuple(range(12)), seed=1))    # a pass first
    c.extend(tq.random_circuit(n, 30, seed=2).gates)
    c.append(_gate(tuple(range(n - 12, n)), seed=1))   # then a piece, a pass, a piece
    c.extend(tq.random_circuit(n, 10, seed=3).gates)
    parts = dispatch.split_at_wide_cores(c)
    assert [type(p).__name__ for p in parts] == ["PGate", "Circuit", "PGate", "Circuit"]
    assert [len(p.gates) for p in parts[1::2]] == [30, 10]
    got, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert got == f"dense_pass+{engine}"
    assert prog.engines == ["dense_pass", engine, "dense_pass", engine]
    passes = prog.steps[0::2]
    assert all(isinstance(s, dp.DensePass) for s in passes)
    assert [s.tmask for s in passes] == [(1 << 12) - 1, ((1 << 12) - 1) << (n - 12)]
    assert all(s.k == 12 and s.controls == () for s in passes)


@pytest.mark.parametrize("n,engine,kind", [
    (12, "whole_circuit", fc.WholeCircuitProgram),
    (19, "segmented", seg.SegmentedProgram),
    (22, "grid_sweep", tgs.GridSweepProgram),
])
def test_circuit_without_wide_core_plans_as_before(n, engine, kind):
    c = tq.random_circuit(n, 60, seed=n)
    if n == 12:   # a 9-qubit core still rides the op table (10+ take the pass)
        c.append(_gate(tuple(range(9)), seed=11))
    assert dispatch.split_at_wide_cores(c) is None
    got, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert got == engine and type(prog) is kind
    assert dispatch.plan_run(c, np.float64, CUDA) == ("torch", None)
    assert dispatch.plan_run(c, np.float32, torch.device("cpu")) == ("torch", None)


def test_sweeps_route_splits_too():
    # at 22 qubits an 8-qubit core on 8-15 sends the pieces to the sweeps
    # engine (the grid planner refuses them); the 12-qubit gate is a pass
    n = 22
    d8 = _gate(tuple(range(8, 16)), seed=8)
    c = _circuit(n, d8, _gate(tuple(range(12)), seed=2), d8)
    got, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert got == "sweeps+dense_pass"
    assert prog.engines == ["sweeps", "dense_pass", "sweeps"]
    assert isinstance(prog.steps[0], ts.SweepProgram)


def test_pieces_above_the_segmented_range_take_the_torch_engine():
    # at 28 qubits a piece that the grid planner refuses (an 8-qubit core on
    # 20-27) takes the torch engine on the row's engines, as the whole
    # circuit did before; the grid row now cuts at that gate too, so the
    # route runs it as a pass and keeps the torch engine for a refused gate
    # whose core the pass cannot take
    n = 28
    c = tq.Circuit(n).append(_gate(tuple(range(20, 28)), seed=8)).h(0)
    c.append(_gate(tuple(range(12)), seed=2)).h(1)
    parts = dispatch.split_at_wide_cores(c)
    assert dispatch._plan_piece(parts[0], "grid_sweep") == ("torch", None)
    assert [len(p.gates) for p in parts[0::2]] == [2, 1]
    got, prog = dispatch.plan_run(c, np.float32, CUDA)
    assert got == "dense_pass+grid_sweep"
    assert prog.engines == ["dense_pass", "grid_sweep", "dense_pass", "grid_sweep"]
    assert [s.k for s in prog.steps[0::2]] == [8, 12]
    # the torch piece applies its gates through apply.py, as the plain version
    small = tq.random_circuit(6, 20, seed=1)
    piece = dispatch._TorchPiece(small)
    x = tq.apply.from_complex(random_state(6, np.random.default_rng(6)), np.float32, "cpu")
    want = tq.apply.to_complex(fc.apply_pgates(x, fc.as_pgates(small.gates)))
    np.testing.assert_allclose(tq.apply.to_complex(piece.run(x)), want, atol=0, rtol=0)


def test_control_is_peeled_into_the_pass():
    # a 13-qubit gate whose MSB is a control: the pass's core has 12 qubits
    n = 14
    c = tq.Circuit(n).append(_gate((13, *range(12)), controls=1, seed=3))
    (g,) = dispatch.split_at_wide_cores(c)
    step = dp.DensePass(g, n)
    assert (step.controls, step.targets, step.k) == ((13,), tuple(range(12)), 12)
    assert (step.tmask, step.cmask) == ((1 << 12) - 1, 1 << 13)
    assert step.flops() == 8.0 * (1 << 12) * (1 << (n - 1))
    assert step.bytes_moved() == 8 * (1 << 24) + 16 * (1 << n)
    with pytest.raises(ValueError, match="no core wider"):
        dp.DensePass(fc.as_pgates([(np.eye(1 << 12), tuple(range(12)))])[0], n)


# ---------------------------------------------------------------------------
# a numpy mirror of csrc/dense_pass.cu
# ---------------------------------------------------------------------------


def _deposit(x: np.ndarray, mask: int) -> np.ndarray:
    out = np.zeros_like(x)
    b = 0
    for p in range(32):
        if (mask >> p) & 1:
            out |= ((x >> b) & 1) << p
            b += 1
    return out


def _extract(x: np.ndarray, mask: int) -> np.ndarray:
    out = np.zeros_like(x)
    b = 0
    for p in range(32):
        if (mask >> p) & 1:
            out |= ((x >> p) & 1) << b
            b += 1
    return out


def _low_bits(mask: int, count: int) -> int:
    out = 0
    for _ in range(count):
        out |= mask & -mask
        mask &= mask - 1
    return out


# dense_pass.cu's columns a chunk (BK) of each instance: the stream
# instance's stage is one k8 step
INSTANCE_BK = {"small": 128, "medium": 64, "large": 32, "stream": 8}
# the H100's multiprocessors: the stream instance's launcher makes RT x
# min(SMs / RT, group tiles) persistent CTAs, RT = 2^k / 128 row tiles
STREAM_SMS = 132


def instance_walk(instance: str, row_tiles: int, group_tiles: int,
                  sms: int = STREAM_SMS) -> list[tuple[int, int]]:
    """(row tile, group tile) of each CTA tile in dense_pass.cu's order: one
    CTA a tile, the group tiles of a row tile together; for "stream" on a
    device of ``sms`` multiprocessors, each persistent CTA b keeps row tile
    b % RT and walks the group tiles b / RT, b / RT + C / RT, ..."""
    if instance != "stream":
        return [(c // group_tiles, c % group_tiles) for c in range(row_tiles * group_tiles)]
    ctas = row_tiles * max(1, min(sms // row_tiles, group_tiles))
    return [(b % row_tiles, t) for b in range(ctas)
            for t in range(b // row_tiles, group_tiles, ctas // row_tiles)]


def tf32_split(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """dense_pass.cu's split of float32 values into the two TF32 operands
    the tensor cores multiply, as float64: the high part rounded to nearest
    at 10 mantissa bits with ties away from zero (cvt.rna.tf32.f32: add half
    an ulp to the bits, clear the low 13), and the float32 remainder with the
    low 13 bits the tensor cores drop cleared."""
    a = np.ascontiguousarray(a, dtype=np.float32)
    hi = ((a.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)
    lo = (a - hi).astype(np.float32)          # exact: hi is a's nearest TF32
    lo = (lo.view(np.uint32) & np.uint32(0xffffe000)).view(np.float32)
    return hi.astype(np.float64), lo.astype(np.float64)


def emulate_dense_pass(
    x: np.ndarray, u: np.ndarray, tmask: int, cmask: int = 0, instance: str | None = None,
    sms: int = STREAM_SMS,
) -> np.ndarray:
    """The pass as dense_pass.cu computes it, on complex64 amplitudes ``x``
    and the operand ``u`` (``core_operand``'s (2, 2^k, 2^k) float32): tile
    by tile in the order of :func:`instance_walk` (tiles of BM rows x BN
    groups of ``instance``, by default the one the wrapper picks; ``sms``
    multiprocessors for the stream instance's walk), X
    gathered chunk by chunk of BK columns (the lowest log2(BK) targets) in
    slot order, each
    real product hi.hi + hi.lo + lo.hi of the operands' TF32 parts
    (:func:`tf32_split`), summed here in float64, the tile's output written
    in slot order, then the copy of the groups whose controls fail. Slots
    written twice or never fail the test."""
    dim = x.size
    k = bin(tmask).count("1")
    free = (dim - 1) & ~(tmask | cmask)
    log2g = bin(free).count("1")
    instance = instance or dp.pass_instance(k, log2g)
    bm, bn = dp.INSTANCES[instance]
    bk = INSTANCE_BK[instance]
    d = 1 << k
    assert u.shape == (2, d, d) and u.dtype == np.float32
    urh, url = tf32_split(u[0])
    uih, uil = tf32_split(u[1])
    xrh, xrl = tf32_split(x.real)
    xih, xil = tf32_split(x.imag)
    log2tg = min(log2g, bn.bit_length() - 1)
    row_tiles = d // bm
    group_tiles = 1 << (log2g - log2tg)
    tlow = _low_bits(tmask, bk.bit_length() - 1)
    flow = _low_bits(free, log2tg)
    thigh = tmask & ~tlow
    rlow = _low_bits(tmask, bm.bit_length() - 1)
    xe = _deposit(np.arange(bk << log2tg), tlow | flow)
    xc, xg = _extract(xe, tlow), _extract(xe, flow)
    ye = _deposit(np.arange(bm << log2tg), rlow | flow)
    yr, yg = _extract(ye, rlow), _extract(ye, flow)
    out = np.zeros(dim, np.complex128)
    written = np.zeros(dim, np.int64)
    for rt, gt in instance_walk(instance, row_tiles, group_tiles, sms):
        r0, g0 = rt * bm, gt * bn
        gbase = int(_deposit(np.array([g0]), free)[0]) | cmask
        his = gbase | _deposit(np.arange(d // bk), thigh)
        idx = np.zeros((d, 1 << log2tg), np.int64)     # slot of X[c, g]
        for chunk, hi in enumerate(his):
            idx[chunk * bk + xc, xg] = hi | xe
        rows = slice(r0, r0 + bm)

        def prod(ah, al, bh, bl):
            return ah[rows] @ bh[idx] + ah[rows] @ bl[idx] + al[rows] @ bh[idx]

        acc = (prod(urh, url, xrh, xrl) - prod(uih, uil, xih, xil)
               + 1j * (prod(uih, uil, xrh, xrl) + prod(urh, url, xih, xil)))
        slots = gbase | int(_deposit(np.array([r0]), tmask)[0]) | ye
        out[slots] = acc[yr, yg]
        written[slots] += 1
    if cmask:
        idx = np.arange(dim)
        fail = (idx & cmask) != cmask
        out[fail] = x[fail]
        written[fail] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("n,k,controls", [
    (14, 12, 0), (15, 12, 0), (16, 12, 0), (14, 12, 1),   # the small instance
    (14, 7, 0), (14, 7, 1),                   # the large one (forced), the medium one
])
def test_mirror_and_plain_match_oracle(n, k, controls):
    # targets in no order, some on the lane bits; a control on bit 2
    qubits = (2,) * controls + (3, 0, 5, 1, *range(6, 2 + k))
    c = tq.Circuit(n).append(_gate(qubits, controls, seed=n + k))
    (g,) = fc.as_pgates(c.gates)
    ctrls, core, targets = fc._peel_controls(g.u, g.qubits)
    assert len(targets) == k and len(ctrls) == controls
    if k > fc.MAX_DENSE_QUBITS:
        assert dp.pass_core(g)[2] == tuple(targets)
    tmask, cmask = sum(1 << q for q in targets), sum(1 << q for q in ctrls)
    psi = random_state(n, np.random.default_rng(n))
    want = jax_oracle(c, psi)
    x = psi.astype(np.complex64)
    instance = "large" if (k, controls) == (7, 0) else None
    assert dp.pass_instance(k, n - k - controls) == ("small" if k == 12 else "medium")
    got = emulate_dense_pass(x, dp.core_operand(core, tuple(targets)), tmask, cmask, instance)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    plain = dp.apply_controlled(tq.apply.from_complex(psi, np.float32, "cpu"), core,
                                tuple(targets), tuple(ctrls))
    np.testing.assert_allclose(tq.apply.to_complex(plain), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, tq.apply.to_complex(plain), atol=1e-7, rtol=0)


@pytest.mark.parametrize("n,k,controls", [(15, 7, 0), (14, 8, 1), (14, 9, 0), (13, 7, 0)])
def test_stream_mirror_and_plain_match_oracle(n, k, controls):
    # the stream instance forced: targets scrambled, on the lane bits, with
    # a control on bit 2; 15q k = 7: two group tiles, walked by one CTA (a
    # device of one SM); the others part of a 128-group tile
    qubits = (2,) * controls + (3, 0, 5, 1, *range(6, 2 + k))
    c = tq.Circuit(n).append(_gate(qubits, controls, seed=n + k))
    (g,) = fc.as_pgates(c.gates)
    ctrls, core, targets = fc._peel_controls(g.u, g.qubits)
    tmask, cmask = sum(1 << q for q in targets), sum(1 << q for q in ctrls)
    psi = random_state(n, np.random.default_rng(n))
    want = jax_oracle(c, psi)
    got = emulate_dense_pass(psi.astype(np.complex64), dp.core_operand(core, tuple(targets)),
                             tmask, cmask, "stream", sms=1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    plain = dp.apply_controlled(tq.apply.from_complex(psi, np.float32, "cpu"), core,
                                tuple(targets), tuple(ctrls))
    np.testing.assert_allclose(got, tq.apply.to_complex(plain), atol=1e-7, rtol=0)


def test_stream_walk_covers_each_tile_once():
    # persistent CTAs, one an SM: every (row tile, group tile) once, the RT
    # CTAs sharing a group tile at the same step of their walks, on the
    # H100's SMs and on the host check's devices of one and two
    for sms in (1, 2, STREAM_SMS):
        for rt, tiles in ((1, 2), (1, 8192), (2, 1), (2, 4), (4, 1024), (8, 512), (2, 8192),
                          (8, 3)):
            walk = instance_walk("stream", rt, tiles, sms)
            assert sorted(walk) == [(r, t) for r in range(rt) for t in range(tiles)]
            ctas = rt * max(1, min(sms // rt, tiles))
            assert ctas <= max(rt, sms)
            steps = {}
            for b in range(ctas):
                for i, t in enumerate(range(b // rt, tiles, ctas // rt)):
                    steps.setdefault(t, set()).add(i)
            assert all(len(v) == 1 for v in steps.values())


def test_core_operand_orders_bits_and_stores_columns():
    # a 3-qubit core on qubits (5, 1, 3): index MSB qubit 5; the operand's
    # index bit j is the j-th lowest target (1, 3, 5); a real and an
    # imaginary plane, each row-major (a row's columns contiguous), as the
    # tensor cores' A operand
    rng = np.random.default_rng(0)
    core = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
    u = dp.core_operand(core, (5, 1, 3))
    assert u.shape == (2, 8, 8) and u.dtype == np.float32 and u.flags.c_contiguous
    up = u[0] + 1j * u[1]                            # up[row, col]
    for j1 in range(8):
        for j2 in range(8):
            # operand bit 0 -> qubit 1 (matrix bit 1), bit 1 -> qubit 3
            # (matrix bit 0), bit 2 -> qubit 5 (matrix bit 2)
            def src(j):
                return ((j >> 0) & 1) << 1 | ((j >> 1) & 1) << 0 | ((j >> 2) & 1) << 2
            assert up[j1, j2] == np.complex64(core[src(j1), src(j2)])


def test_cpu_pass_runs_plain_version_and_wrapper_refuses_cpu():
    n = 14
    c = tq.Circuit(n).append(_gate(tuple(range(2, 14)), seed=4))
    step = dp.DensePass(fc.as_pgates(c.gates)[0], n)
    reset_launches()
    x = tq.apply.from_complex(random_state(n, np.random.default_rng(1)), np.float32, "cpu")
    np.testing.assert_array_equal(step.run(x).numpy(), step.run_plain(x).numpy())
    assert LAUNCHES["dense_pass"] == 0
    u = torch.from_numpy(dp.core_operand(step.core, step.targets))
    with pytest.raises(ValueError, match="CUDA"):
        dp.dense_pass(x, u, step.tmask)
    with pytest.raises(ValueError, match="float32"):
        step.run(x.double())
    sim = tq.StateVectorSimulator(n, device="cpu").run(c)
    assert sim.engine == "torch"     # the CPU route has no kernel to split for


def test_pass_instance_follows_the_groups():
    # 16 groups or fewer: small; the large tiles when they make 128 CTAs or
    # more (one an SM of the H100's 132); medium between; cores of 7-9
    # qubits take the stream instance where its tiles (2^k / 128 row tiles
    # x group tiles of 128) number 128 or more: k + groups' bits >= 21
    assert [dp.pass_instance(12, g) for g in (0, 2, 4)] == ["small"] * 3
    assert [dp.pass_instance(12, g) for g in (5, 6, 7)] == ["medium"] * 3
    assert [dp.pass_instance(12, g) for g in (8, 10)] == ["large"] * 2
    assert dp.pass_instance(7, 13) == "large" and dp.pass_instance(7, 12) == "medium"
    assert dp.pass_instance(13, 7) == "large" and dp.MIN_PASS_CORE == 7
    assert [dp.pass_instance(7, g) for g in (13, 14, 15, 21)] == ["large"] + ["stream"] * 3
    assert [dp.pass_instance(8, g) for g in (12, 13, 14, 20)] == ["large"] + ["stream"] * 3
    assert [dp.pass_instance(9, g) for g in (11, 12, 13, 19)] == ["large"] + ["stream"] * 3
    assert [dp.pass_instance(10, g) for g in (12, 18)] == ["large"] * 2
    # its tile: 128 rows x 128 groups at every width (U's rows on chip at k
    # = 7, streamed with each stage at 8-9)
    assert dp.STREAM_CORES == (7, 8, 9) and dp.INSTANCES["stream"] == (128, 128)
    assert dp.STREAM_MIN_TILES == 128


def test_tf32_split_recovers_float32():
    # the two parts are TF32 numbers (low 13 bits clear), the high one the
    # nearest with ties away from zero, and together they hold a float32
    # value to 2^-21 of it
    rng = np.random.default_rng(3)
    a = (rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 2, 4096)).astype(np.float32)
    hi, lo = tf32_split(a)
    for part in (hi, lo):
        assert not (part.astype(np.float32).view(np.uint32) & 0x1fff).any()
    assert (np.abs(a - hi) <= np.abs(a) * 2.0 ** -11).all()
    assert (np.abs(a - hi - lo) <= np.abs(a) * 2.0 ** -21).all()
    tie = np.array([1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)], np.float32)
    np.testing.assert_array_equal(tf32_split(tie)[0], [1.0 + 2.0 ** -10, -(1.0 + 2 * 2.0 ** -10)])
