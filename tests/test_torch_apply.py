"""Torch engine (tpu_qsim_torch.apply) against tpu_qsim.apply.

Random states (numpy, seeded) and random k-qubit unitaries/diagonals go
through both engines on the CPU: float32 within 1e-6 (two float32 engines
summing in different orders, amplitudes <= 1), float64 within 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_qsim.apply as jap
import tpu_qsim_torch.apply as tap

from conftest import random_state

TOL = {np.float32: 1e-6, np.float64: 1e-12}


@pytest.fixture(autouse=True, scope="module")
def _no_jax_cache_writes():
    """Keep this module's JAX compiles out of the persistent cache."""
    key = "jax_persistent_cache_min_compile_time_secs"
    prev = getattr(jax.config, key)
    jax.config.update(key, 1e9)
    yield
    jax.config.update(key, prev)


def _random_unitary(k: int, rng) -> np.ndarray:
    m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
    q, r = np.linalg.qr(m)
    return q * (np.diagonal(r) / np.abs(np.diagonal(r)))


def _planes(psi: np.ndarray, rdtype) -> np.ndarray:
    return np.stack([psi.real, psi.imag]).astype(rdtype)


def _cases(seed: int):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(4, 10))
    k = int(rng.integers(1, 4))
    qubits = tuple(int(q) for q in rng.choice(n, size=k, replace=False))
    return rng, n, qubits


@pytest.mark.parametrize("rdtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(6))
def test_apply_unitary_matches_jax(rdtype, seed):
    rng, n, qubits = _cases(seed)
    psi = random_state(n, rng)
    u = _random_unitary(len(qubits), rng)
    ur, ui = tap.split_matrix(u, rdtype)
    x = _planes(psi, rdtype)
    want = np.asarray(jap.apply_unitary(jnp.asarray(x), ur, ui, qubits))
    got = tap.apply_unitary(torch.from_numpy(x), ur, ui, qubits).numpy()
    np.testing.assert_allclose(got, want, atol=TOL[rdtype], rtol=0)


@pytest.mark.parametrize("rdtype", [np.float32, np.float64])
def test_apply_real_unitary_matches_jax(rdtype):
    rng = np.random.default_rng(11)
    psi = random_state(7, rng)
    h = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
    u = np.kron(h, np.array([[0, 1], [1, 0]])).astype(np.complex128)
    ur, ui = tap.split_matrix(u, rdtype)
    assert ui is None
    x = _planes(psi, rdtype)
    want = np.asarray(jap.apply_unitary(jnp.asarray(x), ur, ui, (5, 2)))
    got = tap.apply_unitary(torch.from_numpy(x), ur, ui, (5, 2)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL[rdtype], rtol=0)


@pytest.mark.parametrize("rdtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(4))
def test_apply_diagonal_matches_jax(rdtype, seed):
    rng, n, qubits = _cases(100 + seed)
    psi = random_state(n, rng)
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, 1 << len(qubits)))
    dr, di = tap.split_matrix(d, rdtype)
    x = _planes(psi, rdtype)
    want = np.asarray(jap.apply_diagonal(jnp.asarray(x), dr, di, qubits))
    got = tap.apply_diagonal(torch.from_numpy(x), dr, di, qubits).numpy()
    np.testing.assert_allclose(got, want, atol=TOL[rdtype], rtol=0)


@pytest.mark.parametrize("rdtype", [np.float32, np.float64])
def test_readout_primitives_match_jax(rdtype):
    rng = np.random.default_rng(5)
    a, b = _planes(random_state(8, rng), rdtype), _planes(random_state(8, rng), rdtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    tol = TOL[rdtype]
    np.testing.assert_allclose(
        tap.probabilities(ta).numpy(), np.asarray(jap.probabilities(ja)), atol=tol
    )
    assert abs(float(tap.total_probability(ta)) - float(jap.total_probability(ja))) < tol
    (tr, ti), (jr, ji) = tap.inner_product(ta, tb), jap.inner_product(ja, jb)
    assert abs(float(tr) - float(jr)) < tol and abs(float(ti) - float(ji)) < tol
    for q in (0, 3, 7):
        assert abs(
            float(tap.qubit_marginal(ta, q)) - float(jap.qubit_marginal(ja, q))
        ) < tol
        p1 = float(jap.qubit_marginal(ja, q))
        want = np.asarray(
            jap.collapse(ja, q, jnp.asarray(1), jnp.asarray(p1, dtype=ja.dtype))
        )
        got = tap.collapse(ta, q, 1, p1).numpy()
        np.testing.assert_allclose(got, want, atol=10 * tol, rtol=0)


@pytest.mark.parametrize("rdtype", [np.float32, np.float64])
def test_state_conversions_match_jax(rdtype):
    rng = np.random.default_rng(9)
    psi = random_state(6, rng)
    x = tap.from_complex(psi, rdtype, "cpu")
    np.testing.assert_array_equal(x.numpy(), np.asarray(jap.from_complex(psi, rdtype)))
    np.testing.assert_array_equal(tap.to_complex(x), jap.to_complex(jnp.asarray(x.numpy())))
    s0 = tap.initial_state(6, rdtype, 5, device="cpu")
    np.testing.assert_array_equal(s0.numpy(), np.asarray(jap.initial_state(6, rdtype, 5)))


def test_cuda_device_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tap.initial_state(3, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tap.resolve_device("cuda")
    assert tap.resolve_device("cpu").type == "cpu"
