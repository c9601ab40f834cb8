"""tpu_qsim_torch — the PyTorch/CUDA port of tpu_qsim.

Same circuit IR, same ``(2, 2^n)`` split real/imag planes layout and the
same simulator API as the JAX package ``tpu_qsim``, which stays beside it as
the reference. ``StateVectorSimulator.run`` takes float32 states of 10-30
qubits on an NVIDIA H100 through hand-written CUDA kernels
(``kernels/csrc/``: whole-circuit at 10-18 qubits, segment and
scatter-segment at 19, grid-sweep at 20-30, and the low- and high-sweep
kernels where the grid planner refuses a circuit of 22-26 qubits) and
everything else through a torch engine. The noisy, batched-trajectory and
density-matrix simulators, parameterized runs with ``torch.autograd``
gradients, certification and the algorithms run on the torch engine (the
JAX package runs them on XLA), certification through the grid-sweep kernel.
The sharded simulators (:mod:`tpu_qsim_torch.parallel`) split a state or a
trajectory batch over the ranks of a ``torch.distributed`` process group and
run each shard's work on the same kernels; ``qasm``, ``stabilizer`` and
``utils`` are host-side copies, and ``python -m tpu_qsim_torch`` is the demo.
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
from .algorithms import (
    amplitude_estimation_circuit,
    classical_shadow,
    estimate_amplitude,
    estimate_phase,
    grover_circuit,
    heisenberg_hamiltonian,
    maxcut_expectation,
    phase_estimation_circuit,
    qaoa_maxcut_circuit,
    qaoa_maxcut_objective,
    shadow_expectation_pauli,
    shadow_reduced_density_matrix,
    tfim_hamiltonian,
    trotter_circuit,
    vqe_minimize,
)
from .config import DEFAULT_CONFIG, SimConfig
from .cpu_reference import CPUReferenceSimulator
from .density import DensityMatrixSimulator
from .noise import NoiseChannel, NoiseModel, NoiseType
from .noisy import BatchedSimulator, NoisySimulator
from .parallel import ShardedBatchedSimulator, ShardedStateVectorSimulator, make_mesh
from .qasm import from_qasm, from_qasm_file, to_qasm
from .stabilizer import CliffordCircuit, StabilizerSimulator
from .statevector import StateVectorSimulator, build_expectation_fn

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
    "build_expectation_fn",
    "NoiseModel",
    "NoiseChannel",
    "NoiseType",
    "NoisySimulator",
    "BatchedSimulator",
    "DensityMatrixSimulator",
    "ShardedStateVectorSimulator",
    "ShardedBatchedSimulator",
    "make_mesh",
    "from_qasm",
    "from_qasm_file",
    "to_qasm",
    "StabilizerSimulator",
    "CliffordCircuit",
    "grover_circuit",
    "qaoa_maxcut_circuit",
    "qaoa_maxcut_objective",
    "maxcut_expectation",
    "phase_estimation_circuit",
    "estimate_phase",
    "amplitude_estimation_circuit",
    "estimate_amplitude",
    "trotter_circuit",
    "classical_shadow",
    "shadow_expectation_pauli",
    "shadow_reduced_density_matrix",
    "tfim_hamiltonian",
    "heisenberg_hamiltonian",
    "vqe_minimize",
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
