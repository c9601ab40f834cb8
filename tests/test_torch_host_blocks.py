"""The grid-sweep and segment kernels' own CUDA sources, run on the CPU.

``csrc/grid_sweep.cu`` and ``csrc/segment.cu``, with the headers they
include (``block_program.cuh``, ``ops.cuh``, ``tf32.cuh``, ``grid_sync.cuh``,
``ptx.cuh``), are built by g++ under AddressSanitizer and UBSan and run
through their own ``extern "C"`` launchers (``tests/torch_host_harness.py``)
on op tables the port's planners build, as the wrappers launch them on the
card. Every case holds the result against the port's plain version within
1e-6 (max abs, unit-norm states), against the JAX package's complex128
oracle within 1e-5 (two float32 engines over up to ~100 gates), and passes
only with no sanitizer report; the numpy mirrors
(``test_torch_gridsweeps.emulate_sweep``, which multiplies cores of 5+
qubits through ``test_torch_dense_op.emulate_tiled_op``, and
``test_torch_segmented.emulate_segments``) must agree with the host run
within 1e-6 on the same tables, so a kernel changed without its mirror, or
a mirror without its kernel, fails here.

* Grid sweep: ``random_circuit`` at 10-13 qubits (the narrow instance),
  the same with a tiled core between its gates (the wide instance), the
  ``mixed`` circuit and 3- and 6-qubit cores among register ops, and one
  k-qubit core alone for k = 1-11 (k = 1 a register op, 2-4
  ``apply_dense`` in shared memory, 5-11 the tiled op), uncontrolled; up to
  k = 9 also under a block-local control at 13 qubits and under a control
  outside the block at 14.
* Segments: in-place, relabeled and scatter (restore) segments, all of a
  plan in one cooperative launch and a range of it, at 12-13 qubits; a
  9-qubit core in a 2^14-slot block (15 qubits, two CTAs of 1024 threads).
  ``segment.cu`` stores every block through its map (``MapStore``); the
  other store, to the block's own slots (``BlockStore``), is the grid
  sweep's and the sweeps'.
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.circuit import Gate
from tpu_qsim_torch.convert import circuit_from_jax
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import segmented as seg
from tpu_qsim_torch.kernels.fused_circuit import KIND_DENSE, NARROW_CORE, OP_HEADER, SWEEP_HEADER

import torch_host_harness as host
from conftest import random_state
from test_torch_dense_op import _wide_register_circuit, dense_unitary
from test_torch_gridsweeps import _mixed_circuit, emulate_sweep as emulate_grid_sweep
from test_torch_segmented import emulate_segments
from test_torch_sweeps import jax_oracle

PLAIN_TOL = 1e-6
ORACLE_TOL = 1e-5
MIRROR_TOL = 1e-6


def plain_of(prog, psi: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(host.planes(psi))
    return np.asarray(tq.apply.to_complex(prog.run_plain(x)))


def check(got, prog, c, psi) -> None:
    np.testing.assert_allclose(got, plain_of(prog, psi), atol=PLAIN_TOL, rtol=0)
    np.testing.assert_allclose(got, jax_oracle(c, psi), atol=ORACLE_TOL, rtol=0)


def core_gate(k: int, control: str, n: int, targets) -> tuple[Gate, tuple]:
    """A dense k-qubit core (seeded) on ``targets``, with no control, one
    on block bit ``k`` ("local") or one on the top bit ("ext")."""
    core = dense_unitary(k, np.random.default_rng(500 + k))
    ctrl = {"none": (), "local": (k,), "ext": (n - 1,)}[control]
    u = core
    if ctrl:
        u = np.eye(2 << k, dtype=np.complex128)
        u[1 << k:, 1 << k:] = core
    return Gate(f"host_core{k}", ctrl + tuple(targets), matrix_bytes=u.tobytes()), ctrl


def between_random(n: int, gate: Gate, seed: int) -> tq.Circuit:
    c = tq.random_circuit(n, 30, seed=seed).append(gate)
    for g in tq.random_circuit(n, 30, seed=seed + 1).gates:
        c.append(g)
    return c


def grid_case(c: tq.Circuit, params=None):
    prog = tgs.GridSweepProgram(c, params)
    psi = random_state(c.num_qubits, np.random.default_rng(c.num_qubits + len(c.gates)))
    got = host.run_grid_sweep(prog, psi)
    check(got, prog, c, psi)
    re, im = psi.real.copy(), psi.imag.copy()
    for table in prog.tables:
        emulate_grid_sweep(re, im, table)
    np.testing.assert_allclose(got, re + 1j * im, atol=MIRROR_TOL, rtol=0)
    return prog


@pytest.mark.parametrize("n", [10, 11, 12, 13])
@pytest.mark.parametrize("wide", [False, True])
def test_grid_sweep_random_circuit(n, wide):
    if wide:    # an 8-qubit core: blocks of 2^10 slots or more, 64+ threads
        gate, _ = core_gate(8, "none", n, range(1, 9))
        c = between_random(n, gate, seed=n)
    else:
        c = tq.random_circuit(n, 100, seed=n)
    prog = grid_case(c)
    assert (max(t.max_core for t in prog.tables) > NARROW_CORE) == wide


@pytest.mark.parametrize("n", [12, 13])
@pytest.mark.parametrize("blk,a,core", [(6, 3, 0), (7, 2, 0), (7, 2, 5)])
def test_grid_sweep_persistent_ctas(blk, a, core, n):
    # blocks of 2^9 slots: more steps than the 4 resident CTAs, so each CTA
    # takes several in turn, the next one's block streaming in with cp.async
    # while it runs this one (with a 5-qubit core, in the wide instance)
    c = tq.random_circuit(n, 100, seed=blk + a)
    if core:
        gate, _ = core_gate(core, "none", n, range(2, 2 + core))
        c = between_random(n, gate, seed=blk + a)
    prog = grid_case(c, tgs.GridParams(blk, a))
    assert min(len(lay.inactive) for lay in prog.layouts) >= 3
    if core:
        assert max(t.max_core for t in prog.tables) == core


@pytest.mark.parametrize("n", [12, 13])
@pytest.mark.parametrize("name", ["mixed", "wide_register"])
def test_grid_sweep_structured_circuit(name, n):
    c = circuit_from_jax(_mixed_circuit(n)) if name == "mixed" else _wide_register_circuit(n)
    grid_case(c)


# every control placement up to k = 9; one 10- and one 11-qubit core (the
# latter alone takes seconds: 786432 mma collectives on one CTA)
GRID_CORES = [(k, c) for k in range(1, 12) for c in ("none", "local", "ext") if k < 10 or c == "none"]


@pytest.mark.parametrize("k,control", GRID_CORES)
def test_grid_sweep_one_core(k, control):
    # the core on the block's lowest bits (lane, register and warp bits at
    # once from k = 6), alone at 13 qubits, 14 with the control outside the
    # block: blocks of 2^13 slots on 512 threads for a tiled core, the tiled
    # op holding a block as one tile
    n = 14 if control == "ext" else 13
    gate, ctrl = core_gate(k, control, n, range(k))
    prog = grid_case(tq.Circuit(n).append(gate))
    ops = [t.ints[SWEEP_HEADER:SWEEP_HEADER + OP_HEADER * int(t.ints[0])].reshape(-1, OP_HEADER)
           for t in prog.tables]
    (op,) = [o for t in ops for o in t if o[0] == KIND_DENSE]
    assert int(op[1]) == k and (bool(op[3]), bool(op[5])) == (control == "local", control == "ext")


def segment_case(c: tq.Circuit, local_bits=None, first=0, last=None):
    prog = seg.SegmentedProgram(c, local_bits)
    psi = random_state(c.num_qubits, np.random.default_rng(c.num_qubits + 7))
    got = host.run_segments(prog, psi, first, last)
    x = torch.from_numpy(host.planes(psi))
    last = prog.num_segments if last is None else last
    for i in range(first, last):
        x = prog.step_plain(x, i)
    np.testing.assert_allclose(got, np.asarray(tq.apply.to_complex(x)), atol=PLAIN_TOL, rtol=0)
    if (first, last) == (0, prog.num_segments):
        np.testing.assert_allclose(got, jax_oracle(c, psi), atol=ORACLE_TOL, rtol=0)
    np.testing.assert_allclose(got, emulate_segments(psi, prog, first, last), atol=MIRROR_TOL, rtol=0)
    return prog


@pytest.mark.parametrize("n,local_bits", [(12, 10), (12, 11), (13, 10), (13, 12)])
@pytest.mark.parametrize("name", ["random", "qft", "mixed"])
def test_segments_whole_plan(name, n, local_bits):
    c = {"random": lambda: tq.random_circuit(n, 100, seed=n + local_bits),
         "qft": lambda: tq.qft_circuit(n),
         "mixed": lambda: circuit_from_jax(_mixed_circuit(n))}[name]()
    prog = segment_case(c, local_bits)
    kinds = {s.kernel for s in prog.steps}
    assert prog.num_segments >= 1 and kinds <= {"segment", "scatter_segment"}


def test_segments_relabel_and_restore():
    # a plan with relabeled segments and a restore: every store map kind
    c = tq.random_circuit(13, 100, seed=21)
    prog = segment_case(c, 10)
    assert any(not s.in_place for s in prog.steps)
    assert prog.steps[-1].scatter_dst is not None


@pytest.mark.parametrize("first,last", [(0, 1), (1, 3), (2, 4)])
def test_segments_range(first, last):
    c = tq.random_circuit(13, 100, seed=22)
    prog = seg.SegmentedProgram(c, 10)
    assert prog.num_segments >= 4
    segment_case(c, 10, first, last)


@pytest.mark.parametrize("k", [5, 7, 9])
def test_segments_tiled_core(k):
    # a 9-qubit core takes a 2^14-slot block: 15 qubits, two CTAs of 1024
    # threads; narrower ones a 2^13 block at 13 qubits
    n = 15 if k == 9 else 13
    gate, _ = core_gate(k, "none", n, range(n - k, n))
    c = between_random(n, gate, seed=30 + k)
    prog = segment_case(c)
    assert max(s.table.max_core for s in prog.steps) == k
