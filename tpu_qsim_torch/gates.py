"""Canonical gate matrices (Qiskit/Cirq conventions).

The port's own copy of ``tpu_qsim/gates.py`` (same names, arities and
matrices; the port imports nothing of the JAX package). Every backend of
the port (torch engine, CUDA grid-sweep kernel, NumPy oracle) consumes
these matrices, so correctness is pinned in exactly one place.

Conventions
-----------
* Matrices are returned as ``numpy.complex128`` regardless of the simulator's
  runtime dtype; backends downcast at the device boundary. Composing fused
  gate groups in float64 on the host before casting keeps per-group error at
  the single-cast level.
* For a k-qubit gate acting on qubits ``(q0, ..., q_{k-1})`` the matrix index
  uses ``q0`` as the MOST significant bit: basis order for a 2-qubit gate on
  ``(control, target)`` is ``|c t> -> 2*c + t``. This matches Cirq's
  multi-qubit operator convention.
* Bit/endianness convention of the library: qubit ``q`` is bit ``q`` of the
  flat state index (little-endian, Qiskit-like). The reference implementation
  behaves the same way operationally (its gate kernels use ``1 << target``
  directly; see reference src/Gates.cu:19-25) even though its docs claim the
  opposite; we standardize on qubit q <-> bit q *everywhere*, including
  measurement (the reference's StateVector::measure disagreed with its own
  gate kernels — reference src/StateVector.cu:87-88).

Parity notes: the 17-gate set mirrors the reference ``GateType`` enum
(reference include/Circuit.hpp:42-59) and the kernel definitions in
reference src/Gates.cu:31-412.
"""

from __future__ import annotations

import math
import threading
from functools import lru_cache

import numpy as np

# Registration is PROCESS-GLOBAL: names added via register_gate (or lazily by
# multi_controlled_z_name) are visible to every Circuit in the process. The
# registry containers below are mutated in place under this lock and are never
# rebound, so modules that imported them always see the current contents.
_REGISTRY_LOCK = threading.Lock()

INV_SQRT2 = 1.0 / math.sqrt(2.0)

# ---------------------------------------------------------------------------
# Fixed single-qubit gates
# ---------------------------------------------------------------------------

I2 = np.eye(2, dtype=np.complex128)
X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
H = np.array([[1, 1], [1, -1]], dtype=np.complex128) * INV_SQRT2
S = np.array([[1, 0], [0, 1j]], dtype=np.complex128)
SDG = np.array([[1, 0], [0, -1j]], dtype=np.complex128)
T = np.array([[1, 0], [0, np.exp(1j * math.pi / 4)]], dtype=np.complex128)
TDG = np.array([[1, 0], [0, np.exp(-1j * math.pi / 4)]], dtype=np.complex128)


# ---------------------------------------------------------------------------
# Parameterized single-qubit gates (half-angle convention, Qiskit/Cirq)
# ---------------------------------------------------------------------------

def rx(theta: float) -> np.ndarray:
    """Rx(theta) = exp(-i theta X / 2). Reference: src/Gates.cu:168-190."""
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -1j * s], [-1j * s, c]], dtype=np.complex128)


def ry(theta: float) -> np.ndarray:
    """Ry(theta) = exp(-i theta Y / 2). Reference: src/Gates.cu:192-213."""
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rz(theta: float) -> np.ndarray:
    """Rz(theta) = diag(e^{-i theta/2}, e^{i theta/2}).

    Reference: src/Gates.cu:215-242."""
    return np.array(
        [[np.exp(-0.5j * theta), 0], [0, np.exp(0.5j * theta)]],
        dtype=np.complex128,
    )


def phase(lam: float) -> np.ndarray:
    """P(lambda) = diag(1, e^{i lambda}) — S and T generalization."""
    return np.array([[1, 0], [0, np.exp(1j * lam)]], dtype=np.complex128)


def u3(theta: float, phi: float, lam: float) -> np.ndarray:
    """General single-qubit unitary, Qiskit U(theta, phi, lambda)."""
    c, s = math.cos(theta / 2), math.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ],
        dtype=np.complex128,
    )


# ---------------------------------------------------------------------------
# Multi-qubit gates.  Index convention: qubits[0] is the matrix-index MSB.
# ---------------------------------------------------------------------------

def controlled(u: np.ndarray) -> np.ndarray:
    """Controlled-U on (control, target): block-diag(I, U) with control = MSB."""
    k = u.shape[0]
    out = np.eye(2 * k, dtype=np.complex128)
    out[k:, k:] = u
    return out


CNOT = controlled(X)          # reference src/Gates.cu:264-281
CZ = controlled(Z)            # reference src/Gates.cu:283-296
SWAP = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
    dtype=np.complex128,
)                             # reference src/Gates.cu:298-320


def cry(theta: float) -> np.ndarray:
    """Controlled-Ry. Reference: src/Gates.cu:322-352."""
    return controlled(ry(theta))


def crz(theta: float) -> np.ndarray:
    """Controlled-Rz. Reference: src/Gates.cu:354-388."""
    return controlled(rz(theta))


def cp(lam: float) -> np.ndarray:
    """Controlled-phase diag(1,1,1,e^{i lam}) — beyond the reference's gate
    set; required for a correct QFT (CRZ differs by a conditional phase)."""
    return controlled(phase(lam))


TOFFOLI = controlled(CNOT)    # CCX on (c1, c2, t); reference src/Gates.cu:392-412

# Multi-controlled Z: the TPU-native multi-controlled primitive. A C^{k-1}Z
# is DIAGONAL (phase -1 on |1...1> only), which every backend applies as a
# single masked multiply — no Toffoli-ladder decomposition, no ancillas.
# MCX then costs H(t) . MCZ . H(t) (see Circuit.mcx). Capped at 10 qubits
# because gate matrices are materialized dense (2^k x 2^k complex128).
MAX_MCZ_QUBITS = 10


def multi_controlled_z_name(k: int) -> str:
    """Return (registering on first use) the gate name for a k-qubit MCZ."""
    if k == 1:
        return "z"
    if k == 2:
        return "cz"
    if not (3 <= k <= MAX_MCZ_QUBITS):
        raise ValueError(
            f"mcz supports 1..{MAX_MCZ_QUBITS} qubits, got {k}"
        )
    name = f"mcz{k}"
    with _REGISTRY_LOCK:
        if name not in GATE_ARITY:
            d = np.ones(1 << k, dtype=np.complex128)
            d[-1] = -1.0
            _FIXED[name] = np.diag(d)
            GATE_ARITY[name] = k
            DIAGONAL_GATES.add(name)
            GATE_NAMES.add(name)
    return name


# ---------------------------------------------------------------------------
# Name -> matrix dispatch used by the circuit IR
# ---------------------------------------------------------------------------

_FIXED = {
    "i": I2,
    "x": X,
    "y": Y,
    "z": Z,
    "h": H,
    "s": S,
    "sdg": SDG,
    "t": T,
    "tdg": TDG,
    "cnot": CNOT,
    "cz": CZ,
    "swap": SWAP,
    "toffoli": TOFFOLI,
}

_PARAM = {
    "rx": rx,
    "ry": ry,
    "rz": rz,
    "p": phase,
    "cry": cry,
    "crz": crz,
    "cp": cp,
}

# Number of qubits each gate acts on.
GATE_ARITY = {
    "i": 1, "x": 1, "y": 1, "z": 1, "h": 1, "s": 1, "sdg": 1, "t": 1,
    "tdg": 1, "rx": 1, "ry": 1, "rz": 1, "p": 1,
    "cnot": 2, "cz": 2, "swap": 2, "cry": 2, "crz": 2, "cp": 2,
    "toffoli": 3,
}

# Gates whose matrix is diagonal (used by fusion/kernel planners).
# NOTE: these three are plain mutable sets updated IN PLACE by register_gate /
# multi_controlled_z_name (never rebound), so `from .gates import ...` imports
# elsewhere always observe registrations.
DIAGONAL_GATES = {"i", "z", "s", "sdg", "t", "tdg", "rz", "p", "cz", "crz", "cp"}

PARAM_GATES = set(_PARAM)
GATE_NAMES = set(GATE_ARITY)


def register_gate(
    name: str,
    matrix_or_fn,
    *,
    num_qubits: int | None = None,
) -> None:
    """Register a user-defined gate so it can appear in circuits by name.

    ``matrix_or_fn`` is either a fixed (2^k, 2^k) unitary or a callable
    ``param -> matrix`` for a parameterized gate (``num_qubits`` required in
    the callable case). Extensibility hook beyond the reference's closed
    17-member enum (reference include/Circuit.hpp:42-59).

    Registration is process-global and thread-safe: the name becomes valid
    in every Circuit built afterwards, in every thread. There is no
    per-circuit scoping (circuit-local unitaries travel as a Gate's inline
    ``matrix_bytes`` payload instead — see :class:`tpu_qsim_torch.circuit.Gate`).
    """
    with _REGISTRY_LOCK:
        if name in GATE_ARITY:
            raise ValueError(f"gate '{name}' already exists")
        if not name.isidentifier():
            raise ValueError(f"invalid gate name '{name}'")
        if callable(matrix_or_fn):
            if num_qubits is None:
                raise ValueError("num_qubits required for parameterized gates")
            k = int(num_qubits)
            # Probe the builder once so a malformed user gate fails at
            # registration rather than silently corrupting amplitudes later
            # (mirrors the fixed-matrix validation below).
            probe = np.asarray(matrix_or_fn(0.0), dtype=np.complex128)
            if probe.shape != (1 << k, 1 << k):
                raise ValueError(
                    f"gate function returns shape {probe.shape}, expected "
                    f"{(1 << k, 1 << k)} for {k} qubit(s)"
                )
            if not np.allclose(
                probe.conj().T @ probe, np.eye(1 << k), atol=1e-10
            ):
                raise ValueError("gate function does not return a unitary at 0.0")
            _PARAM[name] = matrix_or_fn
            PARAM_GATES.add(name)
        else:
            mat = np.asarray(matrix_or_fn, dtype=np.complex128)
            dim = mat.shape[0]
            if mat.shape != (dim, dim) or dim & (dim - 1):
                raise ValueError("matrix must be square with power-of-2 dimension")
            if not np.allclose(mat.conj().T @ mat, np.eye(dim), atol=1e-10):
                raise ValueError("matrix is not unitary")
            k = dim.bit_length() - 1
            _FIXED[name] = mat
            if np.allclose(mat, np.diag(np.diagonal(mat))):
                DIAGONAL_GATES.add(name)
        GATE_ARITY[name] = k
        GATE_NAMES.add(name)


@lru_cache(maxsize=4096)
def _cached_param_matrix(name: str, param: float) -> np.ndarray:
    return _PARAM[name](param)


def gate_matrix(name: str, param: float | None = None) -> np.ndarray:
    """Return the complex128 unitary for a named gate.

    Parameterized-gate matrices are cached by (name, param) — the analog of
    gate-matrix caching from the Qandle paper, and cheap because circuits
    reuse angles heavily.
    """
    if name in _FIXED:
        return _FIXED[name]
    if name in _PARAM:
        if param is None:
            raise ValueError(f"gate '{name}' requires a parameter")
        return _cached_param_matrix(name, float(param))
    raise ValueError(f"unknown gate '{name}'")


def op_matrix(gate) -> np.ndarray:
    """Complex128 unitary for a circuit :class:`~tpu_qsim_torch.circuit.Gate` op.

    A gate carrying an inline ``matrix_bytes`` payload (circuit-local
    unitaries, e.g. the adjoints Circuit.inverse() builds for registered
    gates) resolves to that payload; every named gate resolves through the
    registry. All execution backends go through this accessor."""
    m = getattr(gate, "matrix", None)
    if m is not None:
        return m
    return gate_matrix(gate.name, gate.param)
