"""The host harness itself, and the dense-pass and rotation-chain kernels'
own CUDA sources run on the CPU.

``tests/torch_host_harness.py`` builds the port's kernel sources with g++
under AddressSanitizer and UBSan (``-fsanitize=address,undefined
-fno-sanitize-recover=all``) into one executable with a host runtime.

* The harness catches what it is for. Test-only kernels
  (``tests/host_kernels/faults.cu``), each with one fault a switch turns
  on, run clean with the fault off; with it on, a shared-memory write one
  element past the launch's dynamic bytes and a global write one element
  past the state's planes are AddressSanitizer reports, a ``1u << 32`` a
  UBSan report, and a read of a cp.async target before its
  ``cp.async.wait_group`` gives a result that differs from the copy's. Of
  a warpgroup's ``wgmma``: a store into B while the product is in flight
  and a product with no ``wgmma.fence`` trap; a read of the accumulators
  before their ``wgmma.wait_group`` and B stored with no
  ``fence.proxy.async`` after it give a wrong result (NaN). Of a
  cooperative launch of two CTAs: a skipped grid barrier gives the same
  wrong result in every run, and a barrier that waits for a CTA that never
  comes is reported as a deadlock naming each CTA's wait. A cooperative
  launch of more CTAs than the device keeps resident is refused, as on
  the card. The same four ``wgmma`` faults at N = 128 (``wgmma128``). Of an
  mbarrier ring (a producer warp, a consumer warp, two slots): a consumer
  that skips its wait reads a stale slot, a producer that skips its wait
  or an arrival missing is a deadlock naming each thread's wait
  (``mbar``), an arrival on a barrier never initialised and a store over a
  barrier's word trap.
* ``csrc/dense_pass.cu``'s three instances, targets in a scrambled order:
  the two ``mma.sync`` ones (small, medium) uncontrolled and controlled at
  k = 7-10, one of each at 11 and 12 (a 12-qubit pass is 3.1 million mma
  collectives); the ``wgmma`` one (large, forced: ``pass_instance`` takes
  it only at 2^7 tiles and more, n >= 20 at k = 12) uncontrolled and
  controlled at k = 7-10 over 64 groups, over 128 (two group tiles), over
  32 (the tile's other columns computed and never stored) and at k = 11
  (10^5 warpgroup products; the card's ``chip_smoke.py`` runs k = 12); the
  stream one (persistent CTAs, a producer warpgroup and two ``wgmma128``
  warpgroups through an mbarrier ring; forced: ``pass_instance`` takes it
  from 2^7 tiles) at k = 7-9, uncontrolled and controlled, U's rows on
  chip and streamed, a partial tile and several tiles a CTA, also against
  the numpy mirror (``emulate_dense_pass``).
  Each against the plain version (``dense_pass.apply_controlled``) within
  1e-6 and the JAX package's complex128 oracle within 1e-5 (on the
  amplitudes whose controls are 1, the core alone through
  ``CPUReferenceSimulator``; a controlled 12-qubit matrix would be 1 GiB).
* ``csrc/rotation_chain.cu`` at K = 16 and 17: against the plain chain
  within 1e-6 and, within 1e-5, the complex128 product of its float32
  (cos, sin) pairs (``benchmark_floor.run_vpu``, the JAX function, is held
  against the plain chain in ``tests/test_torch_floor.py``).
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.circuit import Gate
from tpu_qsim_torch.kernels import dense_pass as dp
from tpu_qsim_torch.kernels import floor

import torch_host_harness as host
from conftest import random_state
from test_torch_dense_op import dense_unitary
from test_torch_dense_pass import emulate_dense_pass
from test_torch_sweeps import jax_oracle

PLAIN_TOL = 1e-6
ORACLE_TOL = 1e-5
FAULT_THREADS = 32          # faults.cu's one CTA
WGMMA_DIM = 4096            # wgmma_product<64>'s planes: B in, the 64 x 64 D out
WGMMA128_DIM = 8192         # wgmma_product<128>'s: the 64 x 128 D
GRID_DIM = 64               # grid_stages' planes: two CTAs of 32
RING_DIM = 128              # ring's planes: four items of 32


def fault_dim(kind: int) -> int:
    if 4 <= kind <= 7:
        return WGMMA_DIM
    if 10 <= kind <= 13:
        return WGMMA128_DIM
    return {8: GRID_DIM, 9: RING_DIM}.get(kind, FAULT_THREADS)


def fault_input(kind: int) -> np.ndarray:
    return np.arange(2 * fault_dim(kind), dtype=np.float32).reshape(2, -1)


def fault_run(kind: int, arg: int) -> np.ndarray:
    run = host.HostRun()
    state = run.buffer(fault_input(kind))
    run.call("host_fault_launch", kind, state, fault_dim(kind), arg,
             run.buffer(np.zeros(1, np.uint32)))
    host.run_checked(run)
    return run.arrays[state.index]


def fault_free(kind: int) -> np.ndarray:
    """What faults.cu's kernel ``kind`` leaves in its planes with its fault
    off."""
    want = fault_input(kind)
    if kind == 1:               # its one write, at the planes' last element
        want[1, -1] = 0.0
    if kind == 3:               # (1 << 31) >> 31 in each of the first plane's slots
        want[0] = 1.0
    if 4 <= kind <= 7:          # D's row r is B's row r % 8
        want[1] = want[0, :512].reshape(8, 64)[np.arange(64) % 8].ravel()
    if 10 <= kind <= 13:
        want[1] = want[0, :1024].reshape(8, 128)[np.arange(64) % 8].ravel()
    if kind == 9:               # each item through the ring, plus 1
        want[1] = want[0] + 1
    if kind == 8:               # doubled, then the other CTA's half plus 1
        x = want[0].copy()
        want[1] = 2 * x
        want[0] = 2 * np.roll(x, GRID_DIM // 2) + 1
    return want


WRONG = None                # the fault shows as a wrong result, not a report
# (faults.cu kind, switch off, switch on, what the harness reports)
REPORTED = {
    "shared_overrun": (0, 0, 1, "AddressSanitizer: use-after-poison"),
    "global_overrun": (1, 0, 1, "AddressSanitizer: heap-buffer-overflow"),
    "wide_shift": (3, 31, 32, "runtime error: shift exponent 32 is too large"),
    "wgmma_read_before_wait": (4, 0, 1, WRONG),
    "wgmma_operand_written_in_flight": (5, 0, 1, "shared operand of an in-flight wgmma was written"),
    "wgmma_without_proxy_fence": (6, 0, 1, WRONG),
    "wgmma_without_fence": (7, 0, 1, "a wgmma with no wgmma.fence"),
    "grid_barrier_skipped": (8, 0, 1, WRONG),
    "ring_consumer_skips_wait": (9, 0, 1, WRONG),
    "ring_producer_skips_wait": (9, 0, 2, r"deadlock in CTA 0: t0-63:mbar"),
    "mbarrier_arrival_missing": (9, 0, 3, r"deadlock in CTA 0: t0-63:mbar"),
    "mbarrier_not_initialised": (9, 0, 4, "where no mbarrier.init made one"),
    "mbarrier_word_overwritten": (9, 0, 5, "overwritten by a store"),
    "wgmma128_read_before_wait": (10, 0, 1, WRONG),
    "wgmma128_operand_written_in_flight": (11, 0, 1,
                                           "shared operand of an in-flight wgmma was written"),
    "wgmma128_without_proxy_fence": (12, 0, 1, WRONG),
    "wgmma128_without_fence": (13, 0, 1, "a wgmma with no wgmma.fence"),
    "grid_barrier_deadlock": (8, 0, 2, r"deadlock in a cooperative launch of 2 CTAs: "
                                       r"CTA 0 \(word 0x[0-9a-f]+ = 2\): t0:spin t1-31:bar; "
                                       r"CTA 1 \(word 0x[0-9a-f]+ = 2\): t0:spin t1-31:bar;"),
}


@pytest.mark.parametrize("fault", sorted(REPORTED))
def test_fault_is_reported(fault):
    kind, _, on, report = REPORTED[fault]
    if report is WRONG:
        out = fault_run(kind, on)
        assert not np.array_equal(out, fault_free(kind))
        if 4 <= kind <= 7 or 10 <= kind <= 13:   # every element of D read from NaN bytes
            assert np.isnan(out[1]).all()
    else:
        with pytest.raises(host.HostFault, match=report):
            fault_run(kind, on)


@pytest.mark.parametrize("fault", sorted(REPORTED))
def test_kernel_without_its_fault_runs_clean(fault):
    kind, off, _, _ = REPORTED[fault]
    np.testing.assert_array_equal(fault_run(kind, off), fault_free(kind))


def test_ring_consumer_without_its_wait_reads_a_stale_slot():
    # after the barrier that follows mbar_init the threads go on in reverse
    # order: the producer fills items 0 and 1 and waits on slot 0; the
    # consumer reads them, frees slot 0 and, skipping its wait for item 2,
    # reads slot 0 before the producer refills it: item 0 again. (A producer
    # that skips its wait instead runs full[0] two phases ahead of the
    # consumer's wait, which then never passes: reported as a deadlock.)
    out = fault_run(9, 1)
    x = fault_input(9)[0].reshape(4, 32)
    np.testing.assert_array_equal(out[1].reshape(4, 32), x[[0, 1, 0, 3]] + 1)


def test_skipped_grid_barrier_shows_in_every_run():
    # one CTA runs at a time, each to its spin or its end: without the
    # barrier CTA 0 runs both stages before CTA 1 starts, and reads CTA 1's
    # half of the second plane before CTA 1 writes it, in every launch
    run = host.HostRun()
    states = [run.buffer(fault_input(8)) for _ in range(3)]
    for state in states:
        run.call("host_fault_launch", 8, state, GRID_DIM, 1, run.buffer(np.zeros(1, np.uint32)))
    host.run_checked(run)
    want, half = fault_free(8), GRID_DIM // 2
    for state in states:
        out = run.arrays[state.index]
        np.testing.assert_array_equal(out[1], want[1])
        np.testing.assert_array_equal(out[0, half:], want[0, half:])
        np.testing.assert_array_equal(out[0, :half], fault_input(8)[1, half:] + 1)


@pytest.mark.parametrize("early", [False, True])
def test_read_before_cp_async_wait_differs(early):
    # the kernel copies the first plane through shared memory with cp.async:
    # read after the wait it is the copy, read before it is not
    out = fault_run(2, int(early))
    want = np.arange(2 * FAULT_THREADS, dtype=np.float32).reshape(2, -1)
    np.testing.assert_array_equal(out[1], want[1])
    if early:
        assert np.isnan(out[0]).all()
    else:
        np.testing.assert_array_equal(out[0], want[0])


def test_cooperative_launch_past_residency_is_refused():
    # sweep.cu's narrow instance at 512 threads: the device keeps 2 CTAs an
    # SM of its 2 resident; a launch of 8 is refused before it runs
    from tpu_qsim_torch.kernels import sweeps as ts

    c = tq.random_circuit(12, 20, seed=1)
    prog = ts.SweepProgram(c, ts.SweepParams(k_bits=2, rb_bits=2))
    table, lay = prog.tables[0], prog.layouts[0]
    threads = ts.sweep_threads(prog.geometry, table.max_core, lay.kbits)
    assert host.resident("sweep_prepare", threads, 0, 0) == 4
    run = host.HostRun()
    psi = random_state(12, np.random.default_rng(0))
    state = run.buffer(host.planes(psi))
    host.prepare(run, "sweep_prepare", threads, 0, 0)
    for groups in (4, 8):
        run.call("sweep_launch", int(prog.sweep_kinds[0] == "high"), state, 1 << 12,
                 run.buffer(table.ints), run.buffer(table.coef), lay.kbits,
                 run.buffer(np.zeros(groups, np.int32)), groups, 0, threads, table.max_core, 0, None)
    assert run.run() == [0, 0, 720]         # cudaErrorCooperativeLaunchTooLarge


def controlled_oracle(core: np.ndarray, targets, controls, psi: np.ndarray) -> np.ndarray:
    """``psi`` after ``core`` on ``targets`` where every control is 1, by the
    JAX package's complex128 oracle on those amplitudes."""
    n = int(psi.size).bit_length() - 1
    idx = np.arange(psi.size)
    on = np.all([(idx >> q) & 1 for q in controls], axis=0) if controls else np.ones(psi.size, bool)
    inner = tuple(q - sum(c < q for c in controls) for q in targets)
    c = tq.Circuit(n - len(controls)).append(Gate("host_pass", inner, matrix_bytes=core.tobytes()))
    out = psi.copy()
    out[on] = jax_oracle(c, psi[on])
    return out


# (n, k, controls, instance)
DENSE_CASES = [
    (11, 7, (), "small"), (12, 7, (0,), "small"), (13, 7, (), "medium"), (13, 7, (12,), "medium"),
    (13, 8, (), "medium"), (13, 8, (0,), "small"),
    (12, 9, (), "small"), (13, 9, (12,), "small"),
    (12, 10, (), "small"), (12, 10, (11,), "small"),
    (12, 11, (), "small"), (13, 12, (5,), "small"),
]


# (n, k, controls, SMs) of the stream instance, forced: scrambled targets,
# 7-9 qubits, uncontrolled and controlled (a control on bit 0: scalar loads
# and stores), U's rows on chip (k = 7) and streamed (k = 8-9); a full tile
# of 128 groups, tiles of 64, 32 and 8 groups (their other groups computed
# and never stored), and at 15 qubits two group tiles walked by one
# persistent CTA through the ring (a device of one SM)
STREAM_CASES = [
    (15, 7, (), 1), (14, 7, (0,), 2), (14, 7, (), 2), (13, 7, (), 2), (14, 8, (3,), 2),
    (14, 8, (), 1), (14, 9, (), 2), (13, 9, (12,), 2),
]

# (n, k, controls) of the wgmma instance, forced: 64 groups a tile of 128
# rows, uncontrolled and controlled, at k = 7-10; 128 groups (two group
# tiles); 32 groups; k = 11
LARGE_CASES = [
    (13, 7, ()), (14, 7, (13,)), (14, 8, ()), (15, 8, (0,)), (15, 9, ()), (16, 9, (7,)),
    (16, 10, ()), (17, 10, (16,)), (15, 8, ()), (12, 7, ()), (17, 11, ()),
]


@pytest.mark.parametrize("n,k,controls,instance", DENSE_CASES)
def test_dense_pass(n, k, controls, instance):
    assert dp.pass_instance(k, n - k - len(controls)) == instance
    check_dense_pass(n, k, controls, None)


@pytest.mark.parametrize("n,k,controls", LARGE_CASES)
def test_dense_pass_wgmma(n, k, controls):
    check_dense_pass(n, k, controls, "large")


@pytest.mark.parametrize("n,k,controls,sms", STREAM_CASES)
def test_dense_pass_stream(n, k, controls, sms):
    got, psi, core, targets = check_dense_pass(n, k, controls, "stream", sms)
    # the numpy mirror of the instance's tiles and walk agrees too
    tmask, cmask = sum(1 << q for q in targets), sum(1 << q for q in controls)
    mirror = emulate_dense_pass(psi.astype(np.complex64), dp.core_operand(core, targets), tmask,
                                cmask, "stream", sms)
    np.testing.assert_allclose(got, mirror, atol=PLAIN_TOL, rtol=0)


def check_dense_pass(n, k, controls, instance, sms=None):
    rng = np.random.default_rng(900 + 16 * n + k)
    free = [q for q in range(n) if q not in controls]
    targets = tuple(int(q) for q in rng.permutation(free)[:k])
    core = dense_unitary(k, rng)
    psi = random_state(n, rng)
    got = host.run_dense_pass(core, targets, controls, psi, instance, sms)
    plain = dp.apply_controlled(torch.from_numpy(host.planes(psi)), core, targets, controls)
    np.testing.assert_allclose(got, np.asarray(tq.apply.to_complex(plain)), atol=PLAIN_TOL, rtol=0)
    np.testing.assert_allclose(got, controlled_oracle(core, targets, controls, psi),
                               atol=ORACLE_TOL, rtol=0)
    return got, psi, core, targets


@pytest.mark.parametrize("k", [16, 17])
def test_rotation_chain(k):
    # 13 qubits: two CTAs of 512 threads (chain_layout's blk 7 + 5 active)
    n = 13
    psi = random_state(n, np.random.default_rng(k))
    angles = floor.chain_angles(k)
    got = host.run_rotation_chain(psi, angles)
    plain = floor.rotation_chain_plain(torch.from_numpy(host.planes(psi)), angles)
    np.testing.assert_allclose(got, np.asarray(tq.apply.to_complex(plain)), atol=PLAIN_TOL, rtol=0)
    cs = floor.chain_table(angles).astype(np.float64)
    np.testing.assert_allclose(got, psi * np.prod(cs[:, 0] + 1j * cs[:, 1]), atol=ORACLE_TOL, rtol=0)
