"""tpu_qsim_torch — the PyTorch/CUDA port of tpu_qsim.

Same circuit IR, same ``(2, 2^n)`` split real/imag planes layout and the
same simulator API as the JAX package ``tpu_qsim``, which stays beside it as
the reference. ``StateVectorSimulator.run`` takes float32 states of 20-30
qubits on an NVIDIA H100 through a hand-written CUDA grid-sweep kernel
(``kernels/csrc/grid_sweep.cu``) and everything else through a torch engine.
Entry points run on the card (``device=None``) unless the caller passes
``device="cpu"``. This package imports neither JAX nor ``tpu_qsim``.
"""

from .circuit import (
    Circuit,
    Gate,
    bell_circuit,
    ghz_circuit,
    hardware_efficient_ansatz,
    qft_circuit,
    random_circuit,
)
from .config import DEFAULT_CONFIG, SimConfig
from .cpu_reference import CPUReferenceSimulator
from .statevector import StateVectorSimulator

__all__ = [
    "Circuit",
    "Gate",
    "bell_circuit",
    "ghz_circuit",
    "qft_circuit",
    "hardware_efficient_ansatz",
    "random_circuit",
    "SimConfig",
    "DEFAULT_CONFIG",
    "CPUReferenceSimulator",
    "StateVectorSimulator",
    "simulate",
]

__version__ = "0.1.0"


def simulate(
    circuit, shots: int | None = None, *, seed: int = 0, device=None,
    **config_kw,
):
    """One-call convenience: run ``circuit`` from |0...0> and return the
    final amplitudes, or a histogram when ``shots`` is given."""
    cfg = DEFAULT_CONFIG.replace(**config_kw) if config_kw else DEFAULT_CONFIG
    sim = StateVectorSimulator(circuit.num_qubits, cfg, seed=seed, device=device)
    sim.run(circuit)
    if shots is None:
        return sim.get_state()
    return sim.histogram(shots)
