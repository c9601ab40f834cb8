"""The Cirq and Qiskit fixture corpus, built with the port's own factories.

``validation/fixtures/cirq_fixtures.npz`` and ``qiskit_fixtures.npz`` hold
the final amplitudes of 67 fixed cases: every library gate at several qubit
positions on a uniform superposition, GHZ 4-10, QFT 4-8, and depth-100
random circuits at 6/8/10 qubits with the gate kinds ``random_circuit``
omits appended. :func:`corpus` lists those cases as pure data,
``(name, num_qubits, [(gate, qubits, param), ...])``, in the packs' order
and with the packs' keys, so a run on the card needs nothing beside the
port to rebuild them.
"""

from __future__ import annotations

from .circuit import Circuit, ghz_circuit, qft_circuit, random_circuit

Case = tuple[str, int, list[tuple[str, tuple[int, ...], float | None]]]


def _superposed(n: int, gate: str, qubits: tuple[int, ...], param: float | None):
    return [("h", (q,), None) for q in range(n)] + [(gate, qubits, param)]


def _gates(c: Circuit) -> list[tuple[str, tuple[int, ...], float | None]]:
    return [(g.name, g.qubits, g.param) for g in c]


def corpus() -> list[Case]:
    cases: list[Case] = []
    for gate in ["i", "x", "y", "z", "h", "s", "sdg", "t", "tdg"]:
        for qb in (0, 1, 3):
            cases.append((f"{gate}-q{qb}", 4, _superposed(4, gate, (qb,), None)))
    for gate in ["rx", "ry", "rz", "p"]:
        for qb, ang in ((0, 0.37), (2, 2.11)):
            cases.append((f"{gate}-q{qb}", 4, _superposed(4, gate, (qb,), ang)))
    for gate in ["cnot", "cz", "swap"]:
        for pair in ((0, 1), (1, 3), (3, 0)):
            cases.append((f"{gate}-{pair[0]}{pair[1]}", 4, _superposed(4, gate, pair, None)))
    for gate in ["cry", "crz", "cp"]:
        for pair, ang in (((0, 2), 0.81), ((3, 1), 1.93)):
            cases.append((f"{gate}-{pair[0]}{pair[1]}", 4, _superposed(4, gate, pair, ang)))
    for triple in ((0, 1, 2), (3, 1, 0)):
        cases.append((f"toffoli-{''.join(map(str, triple))}", 4,
                      _superposed(4, "toffoli", triple, None)))
    for n in range(4, 11):
        cases.append((f"ghz-{n}", n, _gates(ghz_circuit(n))))
    for n in range(4, 9):
        cases.append((f"qft-{n}", n, _gates(qft_circuit(n))))
    for n in (6, 8, 10):
        c = random_circuit(n, 100, seed=n)
        c.s(0).t(1).sdg(2).tdg(3).ry(4, 0.77).p(5, 1.23)
        c.cz(0, 3).swap(1, 4).cry(2, 5, 0.5).crz(5, 0, 0.9).cp(1, 3, 1.7)
        c.toffoli(0, 2, 4)
        cases.append((f"random-{n}", n, _gates(c)))
    return cases
