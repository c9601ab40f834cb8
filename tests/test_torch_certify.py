"""The port's certification checks (tpu_qsim_torch/certify.py) on the CPU.

On the CPU the grid-sweep program runs its plain version
(``GridSweepProgram.run_plain``); each check must pass there, as the JAX
package's checks pass on its engines (bound 5e-6 of ``tests/test_certify.py``),
and the QFT and diagonal-layer checks also within 1e-4 x 2^(-n/2). The two
packages read the same engine output the same way: fed the same wrong state,
each check reports the same deviation (1e-9). Injected faults that an inverse
round trip cannot see are caught, as the JAX package's tests show for its
engines.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qsim.certify as jcert
import tpu_qsim_torch as tq
import tpu_qsim_torch.certify as tcert
from tpu_qsim_torch import apply as ap
from tpu_qsim_torch.fusion import fuse_circuit
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels.gridsweeps import GridParams
from tpu_qsim_torch.statevector import build_torch_run_fn

P = GridParams(blk_bits=7, a_max=3)
CPU = {"device": "cpu", "grid_params": P}


def test_qft_formula_matches_oracle():
    n = 9
    for k in (0, 1, 300):
        sim = tq.CPUReferenceSimulator(n)
        sim.set_state(np.eye(1, 1 << n, k).ravel().astype(np.complex128))
        sim.run(tq.qft_circuit(n))
        np.testing.assert_allclose(
            sim.get_state(), tcert._qft_reference_amps(n, k, np.arange(1 << n)),
            atol=1e-12,
        )


@pytest.mark.parametrize("n", [10, 12])
def test_checks_pass_on_the_grid_program(n):
    bound = 1e-4 * 2.0 ** (-n / 2)
    qft = tcert.qft_analytic_max_diff(n, **CPU)
    diag = tcert.diag_layer_analytic_max_diff(n, **CPU)
    perm = tcert.permutation_analytic_max_dev(n, **CPU)
    cross = tcert.cross_engine_max_diff(tq.random_circuit(n, 60, seed=4), **CPU)
    assert max(qft, diag, perm, cross) < 5e-6, (qft, diag, perm, cross)
    assert qft <= bound and diag <= bound


def test_checks_pass_on_the_torch_engine():
    n = 11

    def engine(c):
        return build_torch_run_fn(fuse_circuit(c, 5), np.float32)

    qft = tcert.qft_analytic_max_diff(n, run_fn=engine(tq.qft_circuit(n)), device="cpu")
    assert qft < 5e-6


def _identity(x):
    return x


@pytest.mark.parametrize("check", ["qft", "diag", "perm"])
def test_packages_read_the_same_state_the_same_way(check):
    """Fed the same (wrong) state by a do-nothing engine, the port and the
    JAX package report the same deviation, far above the pass bound."""
    n = 11
    fns = {
        "qft": (tcert.qft_analytic_max_diff, jcert.qft_analytic_max_diff),
        "diag": (tcert.diag_layer_analytic_max_diff, jcert.diag_layer_analytic_max_diff),
        "perm": (tcert.permutation_analytic_max_dev, jcert.permutation_analytic_max_dev),
    }[check]
    got = fns[0](n, run_fn=_identity, device="cpu")
    want = fns[1](n, run_fn=lambda x: jnp.asarray(x))
    assert got == pytest.approx(want, abs=1e-9)
    assert got > 1e-2


def test_jax_checks_accept_the_ports_state():
    """The JAX package's QFT check passes on the state the port's grid
    program computed, handed across as planes."""
    n = 10
    k = (0b1011 * ((1 << n) // 16 + 1)) % (1 << n)
    y = tgs.GridSweepProgram(tq.qft_circuit(n), P).run(ap.initial_state(n, np.float32, k, "cpu"))
    d = jcert.qft_analytic_max_diff(n, k, run_fn=lambda x: jnp.asarray(y.numpy()))
    assert d < 5e-6


class _Conjugating:
    """A grid engine that conjugates every gate matrix. From a real initial
    state (every check starts from a basis state) that is conj(U psi0): the
    plain run with its imaginary plane negated. Its inverse would conjugate
    alike, so a round trip would restore the input exactly."""

    def __init__(self, monkeypatch):
        def run(circuit, grid_params):
            prog = tgs.GridSweepProgram(circuit, grid_params)

            def go(x):
                y = prog.run_plain(x)
                return torch.stack([y[0], -y[1]])

            return go

        monkeypatch.setattr(tcert, "_grid_run", run)


@pytest.mark.parametrize("check", ["cross", "qft", "diag"])
def test_conjugation_is_caught(monkeypatch, check):
    n = 11
    run = {
        "cross": lambda: tcert.cross_engine_max_diff(tq.random_circuit(n, 40, seed=6), **CPU),
        "qft": lambda: tcert.qft_analytic_max_diff(n, **CPU),
        "diag": lambda: tcert.diag_layer_analytic_max_diff(n, **CPU),
    }[check]
    healthy = run()
    _Conjugating(monkeypatch)
    buggy = run()
    assert healthy < 5e-6
    assert buggy > 1e-2, f"injected conjugation not caught: {buggy}"


def test_addressing_fault_is_caught(monkeypatch):
    """Every 2-qubit gate with its qubit tuple reversed (CNOT's control and
    target swap): the permutation check sees it."""
    n = 11
    healthy = tcert.permutation_analytic_max_dev(n, **CPU)
    orig = tgs.apply_pgates

    def flipped(state, gates):
        return orig(state, [
            fc.PGate(g.u, g.qubits[::-1], tuple(reversed(tuple(g.classes))))
            if len(g.qubits) == 2 else g
            for g in gates
        ])

    monkeypatch.setattr(tgs, "apply_pgates", flipped)
    buggy = tcert.permutation_analytic_max_dev(n, **CPU)
    assert healthy < 5e-6
    assert buggy > 0.5, f"injected addressing fault not caught: {buggy}"


def test_checks_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcert.qft_analytic_max_diff(10)
