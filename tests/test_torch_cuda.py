"""The CUDA grid-sweep kernel against its plain torch version, on the card.

Every test here needs a CUDA card and skips elsewhere. The file imports
neither JAX nor the JAX package (the machine with the card has no JAX), so
it runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance 1e-6 on max |d amp|: kernel and plain version are two float32
evaluations of the same gate list in different summation orders.
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.gates import GATE_ARITY, register_gate
from tpu_qsim_torch.kernels import LAUNCHES, reset_launches
from tpu_qsim_torch.kernels import gridsweeps as tgs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def _random_planes(n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    return torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32)).to(device)


def _mixed_circuit(n: int) -> tq.Circuit:
    """Controls and diagonals in and out of the block, wide swaps, 3q and 4q
    dense cores."""
    rng = np.random.default_rng(0)
    for k in (3, 4):
        name = f"torch_cuda_dense{k}"
        if name not in GATE_ARITY:
            m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
            register_gate(name, np.linalg.qr(m)[0])
    c = tq.Circuit(n)
    c.h(n - 1).h(0).toffoli(n - 1, 3, n - 2).cry(1, n - 1, 0.3)
    c.mcz(0, 5, n - 2, n - 1).swap(n - 2, n - 1).crz(n - 1, 2, 0.7)
    c.cp(n - 2, n - 1, 1.1).swap(0, n - 3).rx(n - 3, 0.4).cz(n - 1, 4)
    c.add("torch_cuda_dense3", 2, n - 1, 6).add("torch_cuda_dense4", 7, 1, n - 2, 4)
    c.ry(n - 2, 1.3).cnot(n - 3, n - 1).t(n - 1).s(0).y(n - 2)
    return c


@pytest.mark.parametrize("n,name", [(20, "random"), (22, "mixed"), (21, "qft")])
def test_kernel_matches_plain(cuda_device, n, name):
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=42),
        "mixed": lambda: _mixed_circuit(n),
        "qft": lambda: tq.qft_circuit(n),
    }[name]()
    prog = tgs.GridSweepProgram(c)
    x = _random_planes(n, n, cuda_device)
    reset_launches()
    got = prog.run(x.clone())
    torch.cuda.synchronize()
    assert LAUNCHES["grid_sweep"] == prog.num_sweeps
    want = prog.run_plain(x)
    assert float((got - want).abs().max()) <= 1e-6


def test_simulator_routes_through_kernel(cuda_device):
    c = tq.ghz_circuit(20)
    reset_launches()
    sim = tq.StateVectorSimulator(20).run(c)
    assert sim.engine == "grid_sweep" and sim.device.type == "cuda"
    assert LAUNCHES["grid_sweep"] >= 1
    p = sim.probabilities()
    assert abs(float(p[0]) - 0.5) < 1e-6 and abs(float(p[-1]) - 0.5) < 1e-6
    assert set(sim.histogram(1000)) <= {0, (1 << 20) - 1}


def test_wrapper_rejects_bad_inputs(cuda_device):
    prog = tgs.GridSweepProgram(tq.random_circuit(20, 20, seed=1))
    ints, coef = prog._tables_on(cuda_device)[0]
    x = _random_planes(20, 0, cuda_device)
    with pytest.raises(ValueError):
        tgs.grid_sweep(x.double(), ints, coef, prog.layouts[0])
    with pytest.raises(ValueError):
        tgs.grid_sweep(x[:, : 1 << 19], ints, coef, prog.layouts[0])
    with pytest.raises(ValueError):
        tgs.grid_sweep(x, ints.cpu(), coef, prog.layouts[0])
