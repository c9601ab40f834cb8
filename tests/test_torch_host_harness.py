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
  ``cp.async.wait_group`` gives a result that differs from the copy's. A
  cooperative launch of more CTAs than the device keeps resident is
  refused, as on the card.
* ``csrc/dense_pass.cu``'s two ``mma.sync`` instances (small, medium; the
  ``wgmma`` instance is not in the host build), uncontrolled and controlled
  at k = 7-10, one of each at 11 and 12 (a 12-qubit pass is 3.1 million
  mma collectives), targets in a scrambled order: against the plain version
  (``dense_pass.apply_controlled``) within 1e-6 and the JAX package's
  complex128 oracle within 1e-5 (on the amplitudes whose controls are 1,
  the core alone through ``CPUReferenceSimulator``; a controlled 12-qubit
  matrix would be 1 GiB).
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
from test_torch_sweeps import jax_oracle

PLAIN_TOL = 1e-6
ORACLE_TOL = 1e-5
FAULT_THREADS = 32          # faults.cu's one CTA


def fault_run(kind: int, arg: int) -> np.ndarray:
    run = host.HostRun()
    state = run.buffer(np.arange(2 * FAULT_THREADS, dtype=np.float32).reshape(2, -1))
    run.call("host_fault_launch", kind, state, FAULT_THREADS, arg)
    host.run_checked(run)
    return run.arrays[state.index]


# (faults.cu kind, switch off, switch on, what the sanitizer reports)
REPORTED = {
    "shared_overrun": (0, 0, 1, "AddressSanitizer: use-after-poison"),
    "global_overrun": (1, 0, 1, "AddressSanitizer: heap-buffer-overflow"),
    "wide_shift": (3, 31, 32, "runtime error: shift exponent 32 is too large"),
}


@pytest.mark.parametrize("fault", sorted(REPORTED))
def test_fault_is_reported(fault):
    kind, _, on, report = REPORTED[fault]
    with pytest.raises(host.HostFault, match=report):
        fault_run(kind, on)


@pytest.mark.parametrize("fault", sorted(REPORTED))
def test_kernel_without_its_fault_runs_clean(fault):
    kind, off, _, _ = REPORTED[fault]
    out = fault_run(kind, off)
    want = np.arange(2 * FAULT_THREADS, dtype=np.float32).reshape(2, -1)
    if fault == "global_overrun":   # its one write, at the planes' last element
        want[1, -1] = 0.0
    if fault == "wide_shift":       # (1 << 31) >> 31 in each of the first plane's slots
        want[0] = 1.0
    np.testing.assert_array_equal(out, want)


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


@pytest.mark.parametrize("n,k,controls,instance", DENSE_CASES)
def test_dense_pass(n, k, controls, instance):
    assert dp.pass_instance(k, n - k - len(controls)) == instance
    rng = np.random.default_rng(900 + 16 * n + k)
    free = [q for q in range(n) if q not in controls]
    targets = tuple(int(q) for q in rng.permutation(free)[:k])
    core = dense_unitary(k, rng)
    psi = random_state(n, rng)
    got = host.run_dense_pass(core, targets, controls, psi)
    plain = dp.apply_controlled(torch.from_numpy(host.planes(psi)), core, targets, controls)
    np.testing.assert_allclose(got, np.asarray(tq.apply.to_complex(plain)), atol=PLAIN_TOL, rtol=0)
    np.testing.assert_allclose(got, controlled_oracle(core, targets, controls, psi),
                               atol=ORACLE_TOL, rtol=0)


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
