"""The port's OpenQASM 2.0 import/export (``tpu_qsim_torch.qasm``) against
the JAX package's: the same text gives the same gate list (names, qubits,
parameters) and the same refusals, the same circuit gives the same text, and
round trips keep the state (the port's complex128 oracle, 1e-12)."""

import math

import numpy as np
import pytest

import tpu_qsim as jq
from tpu_qsim import qasm as jqasm

import tpu_qsim_torch as tq
from tpu_qsim_torch import qasm
from tpu_qsim_torch.convert import circuit_from_jax

SOURCES = {
    "bell": 'OPENQASM 2.0;\ninclude "qelib1.inc";\nqreg q[2];\nh q[0];\ncx q[0],q[1];\n',
    "names": (
        "OPENQASM 2.0; qreg q[3];\n"
        "id q[0]; x q[0]; y q[1]; z q[2]; h q[0]; s q[1]; sdg q[1];\n"
        "t q[2]; tdg q[2]; cz q[0],q[1]; swap q[1],q[2];\n"
        "ccx q[0],q[1],q[2];"
    ),
    "angles": (
        "OPENQASM 2.0; qreg q[2];\n"
        "rx(pi/2) q[0]; ry(-pi/4) q[0]; rz(3*pi/2) q[1];\n"
        "u1(0.25) q[0]; cu1(pi/8) q[0],q[1]; crz(1e-1) q[0],q[1];\n"
        "cry((pi+1)/2) q[0],q[1]; p(-0.5) q[1]; cp(2*pi/3) q[1],q[0];"
    ),
    "qregs": "OPENQASM 2.0; qreg a[2]; qreg b[3];\nx a[1]; x b[0]; cx a[0],b[2];",
    "broadcast": "OPENQASM 2.0; qreg q[4]; h q;",
    "pairwise": "OPENQASM 2.0; qreg a[3]; qreg b[3]; cx a,b;",
    "fixed_control": "OPENQASM 2.0; qreg a[2]; qreg b[2]; cx a[0],b;",
    "barrier": 'OPENQASM 2.0; include "qelib1.inc"; qreg q[2];\nh q[0]; barrier q; cx q[0],q[1];',
    "comments": "// header comment\nOPENQASM 2.0;\nqreg q[1]; // reg\nx q[0]; // gate\n",
    "u3": "OPENQASM 2.0; qreg q[1]; h q[0]; u3(0.7,-0.3,1.9) q[0];",
    "u2": "OPENQASM 2.0; qreg q[1]; u2(0.4,-1.1) q[0];",
    "U": "OPENQASM 2.0;\nqreg q[1];\nU(0.3,0.1,0.2) q[0];\n",
    "creg": "OPENQASM 2.0; qreg q[2]; creg c[2]; h q[0]; cx q[0],q[1];",
}

REJECTED = [
    "OPENQASM 3.0; qreg q[1]; x q[0];",
    "OPENQASM 2.0; qreg q[1]; reset q[0];",
    "OPENQASM 2.0; qreg q[1]; gate foo a { x a; } foo q[0];",
    "OPENQASM 2.0; qreg q[1]; frobnicate q[0];",
    "OPENQASM 2.0; qreg q[1]; x q[3];",
    "OPENQASM 2.0; qreg q[1]; x r[0];",
    "OPENQASM 2.0; qreg q[1]; rx(bad+1) q[0];",
    "OPENQASM 2.0; qreg q[1]; rx() q[0];",
    "OPENQASM 2.0; x q[0];",
    "OPENQASM 2.0; qreg a[2]; qreg b[3]; cx a,b;",
    "OPENQASM 2.0; qreg q[1]; rx(__import__) q[0];",
    "OPENQASM 2.0;",
    "OPENQASM 2.0;\nqreg q[1];\nrx(1/0) q[0];",
    "OPENQASM 2.0; qreg q[1]; creg c[1]; h q[0]; measure q[0] -> c[0];",
]


def _gates(c) -> list:
    return [(g.name, tuple(g.qubits), g.param) for g in c.gates]


def _state(c) -> np.ndarray:
    sim = tq.CPUReferenceSimulator(c.num_qubits)
    sim.run(c)
    return sim.state


def _every_gate(pkg):
    return (
        pkg.Circuit(3)
        .i(0).x(0).y(1).z(2).h(0).s(1).sdg(1).t(2).tdg(2)
        .rx(0, 0.3).ry(1, -0.7).rz(2, 2.5).p(0, 0.9)
        .cnot(0, 1).cz(1, 2).swap(0, 2).cry(0, 1, 0.4).crz(1, 2, -0.2)
        .cp(0, 2, 1.1).toffoli(0, 1, 2)
    )


FACTORIES = {
    "bell": lambda pkg: pkg.bell_circuit(),
    "ghz5": lambda pkg: pkg.ghz_circuit(5),
    "qft4": lambda pkg: pkg.qft_circuit(4),
    "random6": lambda pkg: pkg.random_circuit(6, 40, seed=7),
    "every_gate": _every_gate,
    "mcz3": lambda pkg: pkg.Circuit(3).h(0).h(1).h(2).mcz(0, 1, 2),
    "numpy_param": lambda pkg: pkg.Circuit(1).rx(0, np.float64(0.5)),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_import_equals_jax(name):
    ours, theirs = qasm.from_qasm(SOURCES[name]), jqasm.from_qasm(SOURCES[name])
    assert ours.num_qubits == theirs.num_qubits
    assert _gates(ours) == _gates(theirs)
    np.testing.assert_allclose(_state(ours), _state(circuit_from_jax(theirs)), atol=1e-12)


@pytest.mark.parametrize("src", REJECTED)
def test_refusals_equal_jax(src):
    with pytest.raises(ValueError) as ours:
        qasm.from_qasm(src)
    with pytest.raises(ValueError) as theirs:
        jqasm.from_qasm(src)
    assert str(ours.value) == str(theirs.value)


def test_ignore_measurements_equal_jax():
    src = REJECTED[-1]
    assert _gates(qasm.from_qasm(src, ignore_measurements=True)) == _gates(
        jqasm.from_qasm(src, ignore_measurements=True)) == [("h", (0,), None)]


@pytest.mark.parametrize("name", sorted(FACTORIES))
def test_export_equals_jax_and_round_trips(name):
    ours, theirs = FACTORIES[name](tq), FACTORIES[name](jq)
    text = qasm.to_qasm(ours)
    assert text == jqasm.to_qasm(theirs)
    back = qasm.from_qasm(text)
    np.testing.assert_allclose(_state(back), _state(ours), atol=1e-12)
    if name not in ("mcz3",):
        assert back.signature() == ours.signature()


def test_wide_mcz_has_no_qasm2_form():
    with pytest.raises(ValueError, match="mcz4") as ours:
        qasm.to_qasm(tq.Circuit(4).mcz(0, 1, 2, 3))
    with pytest.raises(ValueError) as theirs:
        jqasm.to_qasm(jq.Circuit(4).mcz(0, 1, 2, 3))
    assert str(ours.value) == str(theirs.value)


def test_u3_matches_qiskit_matrix_up_to_phase():
    theta, phi, lam = 0.7, -0.3, 1.9
    u = np.array([
        [math.cos(theta / 2), -np.exp(1j * lam) * math.sin(theta / 2)],
        [np.exp(1j * phi) * math.sin(theta / 2),
         np.exp(1j * (phi + lam)) * math.cos(theta / 2)],
    ])
    want = u @ (np.array([1.0, 1.0]) / math.sqrt(2))
    got = _state(qasm.from_qasm(SOURCES["u3"]))
    k = int(np.argmax(np.abs(want)))
    np.testing.assert_allclose(got * (want[k] / got[k]), want, atol=1e-12)


def test_file_round_trip_across_packages(tmp_path):
    p = tmp_path / "bell.qasm"
    p.write_text(jqasm.to_qasm(jq.bell_circuit()))
    ours = qasm.from_qasm_file(str(p))
    assert _gates(ours) == _gates(tq.bell_circuit())


def test_qasm_circuit_runs_on_the_port():
    sim = tq.StateVectorSimulator(2, device="cpu").run(qasm.from_qasm(SOURCES["bell"]))
    np.testing.assert_allclose(sim.get_probabilities(), [0.5, 0, 0, 0.5], atol=1e-6)


def test_top_level_exports():
    assert tq.from_qasm is qasm.from_qasm and tq.to_qasm is qasm.to_qasm
    assert tq.from_qasm_file is qasm.from_qasm_file
