"""The port's utilities (``tpu_qsim_torch.utils``) against the JAX package's:
the endianness adapters and fidelity metrics give the same values on the
same inputs, ``view_amp_summary`` on flat planes gives the JAX function's
summary of the same amplitudes in the grid engine's view form, the profiler
writes a trace, and ``sync_time`` returns seconds per call."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_qsim import utils as jutils

import tpu_qsim_torch as tq
from tpu_qsim_torch import utils


def _state(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    s = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    return s / np.linalg.norm(s)


@pytest.mark.parametrize("n", [1, 3, 5, 8])
def test_bit_reversal_and_big_endian_equal_jax(n):
    perm = utils.bit_reversal_permutation(n)
    np.testing.assert_array_equal(perm, jutils.bit_reversal_permutation(n))
    np.testing.assert_array_equal(perm[perm], np.arange(1 << n))
    psi = _state(n, n)
    np.testing.assert_array_equal(utils.to_big_endian(psi, n), jutils.to_big_endian(psi, n))
    np.testing.assert_array_equal(utils.from_big_endian(utils.to_big_endian(psi, n), n), psi)


def test_x0_maps_to_big_endian_msb():
    sim = tq.StateVectorSimulator(3, tq.SimConfig(dtype="complex128"), device="cpu")
    sim.run(tq.Circuit(3).x(0))
    assert utils.to_big_endian(sim.get_state(), 3)[4] == 1.0


@pytest.mark.parametrize("case", ["same", "orthogonal", "phase", "different", "zero"])
def test_fidelity_metrics_equal_jax(case):
    a = _state(4, 1)
    b = {
        "same": a,
        "orthogonal": np.roll(np.eye(16)[0], 1).astype(complex),
        "phase": a * np.exp(0.77j),
        "different": _state(4, 2),
        "zero": np.zeros(16, complex),
    }[case]
    if case == "orthogonal":
        a = np.eye(16)[0].astype(complex)
    assert utils.state_fidelity(a, b) == jutils.state_fidelity(a, b)
    for up in (True, False):
        assert utils.max_amplitude_error(a, b, up_to_phase=up) == jutils.max_amplitude_error(
            a, b, up_to_phase=up)


@pytest.mark.parametrize("ends", [1, 2])
@pytest.mark.parametrize("shape", [(2, 4, 8), (2, 2, 2, 4, 8), (2, 2, 2, 2, 2, 2, 4, 8)])
def test_view_amp_summary_equals_jax_view_form(ends, shape):
    # the JAX function reads the grid engine's view form, whose flat order
    # is the plain reshape; the port reads the flat planes
    y = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    got = [float(v) for v in utils.view_amp_summary(torch.from_numpy(y.reshape(2, -1)), ends=ends)]
    want = [float(v) for v in jutils.view_amp_summary(jnp.asarray(y), ends=ends)]
    assert got == pytest.approx(want, abs=0)


def test_view_amp_summary_keeps_mixed_corners_and_refuses_bad_ends():
    y = torch.zeros(2, 16)
    y[0, 0], y[1, 15], y[0, 3] = 1.0, 0.5, -0.25
    a0r, a0i, aNr, aNi, rest = (float(v) for v in utils.view_amp_summary(y, ends=2))
    assert (a0r, a0i, aNr, aNi, rest) == (1.0, 0.0, 0.0, 0.5, 0.25)
    with pytest.raises(ValueError, match="ends"):
        utils.view_amp_summary(y, ends=3)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    sim = tq.StateVectorSimulator(6, device="cpu")
    with utils.profiler_trace(logdir):
        sim.run(tq.random_circuit(6, 20, seed=1))
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)


def test_sync_time_is_seconds_per_call():
    calls = []
    t = utils.sync_time(lambda: calls.append(1), repeats=5)
    assert len(calls) == 5 and 0.0 <= t < 1.0
