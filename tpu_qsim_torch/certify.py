"""Certification of large states without a second simulator.

The port's counterpart of ``tpu_qsim/certify.py``. An inverse round trip (run
U, then U-dagger) goes through one engine twice, so an adjoint-consistent
fault cancels: an engine that conjugates every gate matrix maps a real
initial state to conj(U psi), and its equally conjugated inverse returns psi.
These checks close that hole at sizes where the complex128 oracle cannot
follow (a 30-qubit state is 8 GiB of float32 planes):

* :func:`cross_engine_max_diff`: the same circuit through the grid-sweep
  kernel and through the torch engine (disjoint code), compared on the
  device; one scalar comes back.
* :func:`qft_analytic_max_diff`, :func:`diag_layer_analytic_max_diff`: the
  engine against closed forms at a deterministic sample of amplitudes; only
  those amplitudes come back.
* :func:`permutation_analytic_max_dev`: a random X/CNOT/SWAP program must
  leave the basis vector a host bit trace predicts; three scalars come back.

By default each check runs the grid-sweep program
(:class:`tpu_qsim_torch.kernels.gridsweeps.GridSweepProgram`: the CUDA kernel
on the card, its plain version on the CPU) on ``device`` (``None`` = the
card); ``run_fn`` takes any planes -> planes engine instead.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import apply as ap
from .circuit import Circuit, qft_circuit

__all__ = [
    "cross_engine_max_diff",
    "qft_analytic_max_diff",
    "diag_layer_analytic_max_diff",
    "permutation_analytic_max_dev",
]


def _grid_run(circuit: Circuit, grid_params):
    from .kernels.gridsweeps import GridSweepProgram

    return GridSweepProgram(circuit, grid_params).run


def _run(circuit: Circuit, x: torch.Tensor, run_fn, grid_params) -> torch.Tensor:
    if run_fn is None:
        run_fn = _grid_run(circuit, grid_params)
    return run_fn(x)


def cross_engine_max_diff(
    circuit: Circuit, *, grid_params=None, device=None,
) -> float:
    """Max |plane difference| between the grid-sweep engine and the torch
    engine (fusion + matmuls; no kernel), each run from |0...0> in float32
    on ``device``. A bound within sqrt(2) of the max amplitude error; at 28q
    the two states are 2 GiB each and one scalar is read back."""
    from .fusion import fuse_circuit
    from .statevector import build_torch_run_fn

    n = circuit.num_qubits
    grid = _grid_run(circuit, grid_params)
    torch_run = build_torch_run_fn(fuse_circuit(circuit, 5), np.float32)
    a = grid(ap.initial_state(n, np.float32, 0, device))
    b = torch_run(ap.initial_state(n, np.float32, 0, device))
    return float(torch.max(torch.abs(a - b)))


def _sample_indices(n: int, num_samples: int) -> np.ndarray:
    step = max(1, (1 << n) // num_samples)
    return np.arange(0, 1 << n, step, dtype=np.int64)


def _amplitudes_at(y: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """The complex128 amplitudes at flat indices ``idx``: only those come
    back from the device."""
    taken = y[:, torch.from_numpy(idx).to(y.device)].double().cpu().numpy()
    return taken[0] + 1j * taken[1]


def _qft_reference_amps(n: int, k: int, idx: np.ndarray) -> np.ndarray:
    """Closed-form QFT amplitudes at flat indices ``idx`` for input |k>:
    :func:`qft_circuit` includes the final bit-reversal swaps, so it realizes
    the DFT matrix in the qubit-q-is-bit-q basis,
    amp_j = exp(2 pi i j k / 2^n) / sqrt(2^n)."""
    phase = 2.0 * math.pi * (idx.astype(np.float64) * float(k)) / float(1 << n)
    return np.exp(1j * phase) / math.sqrt(1 << n)


def qft_analytic_max_diff(
    n: int,
    k: int | None = None,
    *,
    num_samples: int = 4096,
    run_fn=None,
    grid_params=None,
    device=None,
) -> float:
    """Max |amplitude - closed form| over an evenly spaced deterministic
    sample of the QFT-of-|k> state (covering every high-bit region, where
    sign and phase faults of high-bit paths would land)."""
    if k is None:
        k = (0b1011 * ((1 << n) // 16 + 1)) % (1 << n)  # spread-bit input
    x = ap.initial_state(n, np.float32, k, device)
    y = _run(qft_circuit(n), x, run_fn, grid_params)
    idx = _sample_indices(n, num_samples)
    got = _amplitudes_at(y, idx)
    return float(np.max(np.abs(got - _qft_reference_amps(n, k, idx))))


def diag_layer_analytic_max_diff(
    n: int,
    *,
    seed: int = 11,
    num_gates: int = 24,
    num_samples: int = 4096,
    run_fn=None,
    grid_params=None,
    device=None,
) -> float:
    """Max |amplitude - closed form| for an H layer followed by
    ``num_gates`` random diagonal gates (rz / cp / cz / t): the exact state
    is amp_j = 2^(-n/2) * prod_g diag(U_g)[j restricted to g.qubits],
    evaluated on the host in complex128 from the gate tables (qubits[0] =
    matrix-index MSB). Catches phase and sign faults, conjugation included,
    for the cost of n + num_gates gates."""
    from .gates import op_matrix

    rng = np.random.default_rng(seed)
    c = Circuit(n)
    for qb in range(n):
        c.h(qb)
    for _ in range(num_gates):
        kind = int(rng.integers(0, 4))
        if kind == 0:
            c.rz(int(rng.integers(0, n)), float(rng.uniform(0, 2 * math.pi)))
        elif kind == 1:
            a_, b_ = (int(v) for v in rng.choice(n, size=2, replace=False))
            c.cp(a_, b_, float(rng.uniform(0, 2 * math.pi)))
        elif kind == 2:
            a_, b_ = (int(v) for v in rng.choice(n, size=2, replace=False))
            c.cz(a_, b_)
        else:
            c.t(int(rng.integers(0, n)))

    y = _run(c, ap.initial_state(n, np.float32, 0, device), run_fn, grid_params)
    idx = _sample_indices(n, num_samples)
    got = _amplitudes_at(y, idx)
    del y

    want = np.full(idx.shape, 1.0 / math.sqrt(1 << n), dtype=np.complex128)
    for g in list(c)[n:]:
        d = np.diagonal(op_matrix(g))
        kq = len(g.qubits)
        sub = np.zeros(idx.shape, dtype=np.int64)
        for pos, qb in enumerate(g.qubits):
            sub |= ((idx >> qb) & 1) << (kq - 1 - pos)
        want = want * d[sub]
    return float(np.max(np.abs(got - want)))


def permutation_analytic_max_dev(
    n: int,
    *,
    seed: int = 12,
    num_gates: int = 32,
    run_fn=None,
    grid_params=None,
    device=None,
) -> float:
    """Run a random X/CNOT/SWAP program from |0...0> and check that the
    whole state is the basis vector |k*> a host bit trace predicts: returns
    max(|amp[k*] - 1|, max |amp| elsewhere). Exercises the engine's
    amplitude movement at full width; the state is reduced on the device in
    slices, so no full-size temporary is made."""
    rng = np.random.default_rng(seed)
    c = Circuit(n)
    bits = 0
    for _ in range(num_gates):
        kind = int(rng.integers(0, 3))
        if kind == 0:
            qb = int(rng.integers(0, n))
            c.x(qb)
            bits ^= 1 << qb
        elif kind == 1:
            a_, b_ = (int(v) for v in rng.choice(n, size=2, replace=False))
            c.cnot(a_, b_)
            if (bits >> a_) & 1:
                bits ^= 1 << b_
        else:
            a_, b_ = (int(v) for v in rng.choice(n, size=2, replace=False))
            c.swap(a_, b_)
            if ((bits >> a_) & 1) != ((bits >> b_) & 1):
                bits ^= (1 << a_) | (1 << b_)

    y = _run(c, ap.initial_state(n, np.float32, 0, device), run_fn, grid_params)
    ar, ai = (float(v) for v in y[:, bits].double())
    y[:, bits] = 0.0
    step = 1 << 24
    rest = max(
        float(torch.max(torch.abs(y[:, s:s + step])))
        for s in range(0, y.shape[1], step)
    )
    return max(abs(complex(ar, ai) - 1.0), rest)
