"""The Cirq and Qiskit amplitude fixtures (validation/fixtures) on the port.

* The port's corpus (``tpu_qsim_torch.fixture_corpus.corpus``, built with
  the port's factories) is ``validation/generate_cirq_fixtures.py::corpus``,
  case for case, and its names are the packs' keys.
* Every case of both packs (67 each, 4-10 qubits) runs through the port's
  torch engine in complex128 on the CPU and matches the pack within 1e-10
  up to a global phase: the Cirq pack through the bit-reversal adapter
  (``tpu_qsim_torch.utils.to_big_endian``), the Qiskit pack directly (both
  orders put qubit 0 in the least significant bit).
* Three cases padded with idle qubits to 12 qubits run through the
  whole-circuit program's table in the numpy mirror of ``csrc/sweep.cu``
  (``test_torch_whole_circuit.emulate_whole_circuit``) and match within
  1e-5 in float32, the idle qubits left in |0>.

``chip_smoke.py`` phase ``fixtures`` runs every case on the card, at its
own width and padded to 12 qubits.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "validation"))

from generate_cirq_fixtures import FIXTURE_PATH as CIRQ_PATH, corpus as validation_corpus
from generate_qiskit_fixtures import FIXTURE_PATH as QISKIT_PATH

import tpu_qsim_torch as tq
from tpu_qsim_torch.fixture_corpus import corpus
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.utils import max_amplitude_error, to_big_endian

from test_torch_whole_circuit import emulate_whole_circuit

CASES = {name: (n, gates) for name, n, gates in corpus()}
PADDED_QUBITS = 12
PADDED_CASES = ["toffoli-310", "qft-8", "random-10"]


@pytest.fixture(scope="module")
def packs():
    return {"cirq": np.load(CIRQ_PATH), "qiskit": np.load(QISKIT_PATH)}


def fixture_circuit(name: str, num_qubits: int | None = None) -> tq.Circuit:
    """The corpus case ``name`` on ``num_qubits`` qubits (its own width by
    default; more leaves the upper qubits idle)."""
    n, gates = CASES[name]
    c = tq.Circuit(n if num_qubits is None else num_qubits)
    for gname, qubits, param in gates:
        c.add(gname, *qubits, param=param)
    return c


def in_pack_order(state: np.ndarray, pack: str, n: int) -> np.ndarray:
    return to_big_endian(state, n) if pack == "cirq" else state


def test_corpus_is_the_packs():
    assert corpus() == validation_corpus()
    assert len(CASES) == 67
    for path in (CIRQ_PATH, QISKIT_PATH):
        assert set(np.load(path).files) - {"__provenance__"} == set(CASES)


@pytest.mark.parametrize("pack", ["cirq", "qiskit"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_case_on_torch_engine_complex128(packs, pack, name):
    c = fixture_circuit(name)
    n = c.num_qubits
    sim = tq.StateVectorSimulator(n, tq.SimConfig(dtype="complex128"), device="cpu")
    sim.run(c)
    assert sim.engine == "torch"
    got = in_pack_order(sim.get_state(), pack, n)
    assert max_amplitude_error(got, packs[pack][name], up_to_phase=True) < 1e-10


@pytest.mark.parametrize("pack", ["cirq", "qiskit"])
@pytest.mark.parametrize("name", PADDED_CASES)
def test_padded_case_on_whole_circuit_table(packs, pack, name):
    n = CASES[name][0]
    prog = fc.WholeCircuitProgram(fixture_circuit(name, PADDED_QUBITS))
    psi = np.zeros(1 << PADDED_QUBITS, dtype=np.complex128)
    psi[0] = 1.0
    out = emulate_whole_circuit(psi.astype(np.complex64), prog)
    assert np.abs(out[1 << n:]).max() < 1e-5   # the idle qubits stay |0>
    got = in_pack_order(out[:1 << n].astype(np.complex128), pack, n)
    assert max_amplitude_error(got, packs[pack][name], up_to_phase=True) < 1e-5
