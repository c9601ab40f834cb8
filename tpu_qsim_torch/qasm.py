"""OpenQASM 2.0 import/export for :class:`tpu_qsim_torch.Circuit`.

A host-side copy of ``tpu_qsim/qasm.py``: the same text gives the same gate
list in both packages, and ``to_qasm`` writes the same text. Migration aid: users of the reference simulator (and of Qiskit/Cirq
toolchains generally) carry circuits as OpenQASM 2.0 text; this module
round-trips the subset that maps onto tpu_qsim's gate set, so existing
circuit files run on the CUDA engines unchanged. The reference had no
interchange format at all (circuits existed only as C++ builder calls,
reference include/Circuit.hpp:91-122).

Supported statements
    ``OPENQASM 2.0;`` header, ``include`` (ignored), multiple ``qreg``
    declarations (flattened, in declaration order), ``creg`` declarations
    (accepted and ignored -- a state-vector circuit has no classical
    registers), ``barrier`` (a no-op on a state-vector simulator), gate applications with qelib1 names, and
    whole-register broadcast (``h q;`` applies H to every qubit of ``q``).

Gate-name mapping (qelib1 -> tpu_qsim)
    ``id``->``i``, ``cx``/``CX``->``cnot``, ``ccx``->``toffoli``,
    ``u1``/``p``->``p``, ``cu1``/``cp``->``cp``; ``x y z h s sdg t tdg rx
    ry rz cz swap cry crz`` map to themselves. ``u``/``u3``/``u2`` are
    decomposed into the exact rz-ry-rz Euler sequence: the resulting state
    equals Qiskit's up to a global phase of ``exp(i*(phi+lambda)/2)`` per
    ``u3`` (QASM 2.0's own spec defines U up to global phase; the
    decomposition is physics-exact — all probabilities, expectations and
    interferences agree).

``measure`` statements are rejected by default because a state-vector
circuit has no classical register; pass ``ignore_measurements=True`` to
strip them (the common case: sample the final state with
``sim.histogram(shots)`` instead, which is what the reference's own demo
did with its terminal measurements). ``reset``, ``if`` and custom ``gate``
definitions are outside the subset and raise ``ValueError``.
"""

from __future__ import annotations

import ast
import math
import re

from .circuit import Circuit
from .gates import GATE_ARITY, PARAM_GATES

__all__ = ["from_qasm", "from_qasm_file", "to_qasm"]

# qelib1 spelling -> (tpu_qsim name, number of angle parameters)
_IMPORT = {
    "id": ("i", 0), "x": ("x", 0), "y": ("y", 0), "z": ("z", 0),
    "h": ("h", 0), "s": ("s", 0), "sdg": ("sdg", 0), "t": ("t", 0),
    "tdg": ("tdg", 0), "rx": ("rx", 1), "ry": ("ry", 1), "rz": ("rz", 1),
    "p": ("p", 1), "u1": ("p", 1), "cx": ("cnot", 0), "CX": ("cnot", 0),
    "cz": ("cz", 0), "swap": ("swap", 0), "cry": ("cry", 1),
    "crz": ("crz", 1), "cp": ("cp", 1), "cu1": ("cp", 1),
    "ccx": ("toffoli", 0),
}

# tpu_qsim name -> qelib1 spelling (inverse map where it is not identity)
_EXPORT = {"i": "id", "cnot": "cx", "toffoli": "ccx", "p": "u1", "cp": "cu1"}

_ALLOWED_EXPR = re.compile(r"^[\d\s\.\+\-\*/\(\)eEpi]*$")


def _eval_angle(text: str) -> float:
    """Evaluate a QASM angle expression (numbers, pi, + - * / and parens)."""
    expr = text.strip()
    if not expr or not _ALLOWED_EXPR.match(expr):
        raise ValueError(f"unsupported QASM angle expression: {text!r}")
    try:
        node = ast.parse(expr.replace("pi", f"({math.pi!r})"), mode="eval")
    except SyntaxError as e:
        raise ValueError(f"bad QASM angle expression: {text!r}") from e
    def ev(n):
        if isinstance(n, ast.Expression):
            return ev(n.body)
        if isinstance(n, ast.Constant) and isinstance(n.value, (int, float)):
            return float(n.value)
        if isinstance(n, ast.BinOp) and isinstance(
            n.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)
        ):
            a, b = ev(n.left), ev(n.right)
            if isinstance(n.op, ast.Add):
                return a + b
            if isinstance(n.op, ast.Sub):
                return a - b
            if isinstance(n.op, ast.Mult):
                return a * b
            return a / b
        if isinstance(n, ast.UnaryOp) and isinstance(n.op, (ast.USub, ast.UAdd)):
            v = ev(n.operand)
            return -v if isinstance(n.op, ast.USub) else v
        raise ValueError(f"unsupported QASM angle expression: {text!r}")
    try:
        return ev(node)
    except ZeroDivisionError as e:
        raise ValueError(f"division by zero in QASM angle: {text!r}") from e


_NAME = re.compile(r"^(?P<name>[A-Za-z_][A-Za-z_0-9]*)\s*(?P<rest>.*)$")


def _split_stmt(stmt: str) -> tuple[str, str, str] | None:
    """(name, params, args) with balanced-paren parameter lists."""
    m = _NAME.match(stmt)
    if not m:
        return None
    name, rest = m.group("name"), m.group("rest")
    params = ""
    if rest.startswith("("):
        depth = 0
        for i, ch in enumerate(rest):
            depth += ch == "("
            depth -= ch == ")"
            if depth == 0:
                params, rest = rest[1:i], rest[i + 1 :]
                break
        else:
            return None
    return name, params, rest.strip()
_ARG = re.compile(r"^(?P<reg>[A-Za-z_][A-Za-z_0-9]*)(?:\[(?P<idx>\d+)\])?$")


def from_qasm(text: str, *, ignore_measurements: bool = False) -> Circuit:
    """Parse OpenQASM 2.0 source into a :class:`Circuit`.

    Multiple ``qreg`` declarations are concatenated in declaration order
    (register ``b`` declared after ``qreg a[3]`` starts at qubit 3).
    """
    # strip comments, normalize whitespace, split on ';'
    src = re.sub(r"//[^\n]*", "", text)
    if re.search(r"\bgate\s+[A-Za-z_]", src):
        raise ValueError("custom 'gate' definitions are not supported")
    stmts = [s.strip() for s in src.replace("\n", " ").split(";") if s.strip()]

    regs: dict[str, tuple[int, int]] = {}  # name -> (offset, size)
    total = 0
    ops: list[tuple[str, tuple[int, ...], float | None]] = []

    for stmt in stmts:
        head = stmt.split(None, 1)[0]
        if head == "OPENQASM":
            if "2.0" not in stmt:
                raise ValueError(f"only OpenQASM 2.0 is supported: {stmt!r}")
            continue
        if head == "include":
            continue
        if head in ("qreg", "creg"):
            m = re.match(r"^[qc]reg\s+([A-Za-z_][A-Za-z_0-9]*)\s*\[(\d+)\]$", stmt)
            if not m:
                raise ValueError(f"bad register declaration: {stmt!r}")
            name, size = m.group(1), int(m.group(2))
            if head == "qreg":
                if name in regs:
                    raise ValueError(f"duplicate qreg {name!r}")
                regs[name] = (total, size)
                total += size
            continue
        if head == "barrier":
            continue
        if head == "measure":
            if ignore_measurements:
                continue
            raise ValueError(
                "measure statements are not part of a state-vector circuit; "
                "pass ignore_measurements=True and sample the final state "
                "with sim.histogram(shots) instead"
            )
        if head in ("reset", "if", "opaque"):
            raise ValueError(f"unsupported QASM statement: {stmt!r}")

        parts = _split_stmt(stmt)
        if parts is None:
            raise ValueError(f"cannot parse QASM statement: {stmt!r}")
        qname, raw_params, raw_args = parts
        if qname not in _IMPORT and qname not in ("u", "u2", "u3", "U"):
            raise ValueError(f"unsupported QASM gate: {qname!r}")
        params = [_eval_angle(p) for p in raw_params.split(",") if p.strip()]

        # resolve arguments; a bare register name broadcasts
        arglist = [a.strip() for a in raw_args.split(",") if a.strip()]
        if not arglist:
            raise ValueError(f"gate with no qubit arguments: {stmt!r}")
        resolved: list[list[int]] = []
        bcast = 1
        for a in arglist:
            am = _ARG.match(a)
            if not am or am.group("reg") not in regs:
                raise ValueError(f"unknown qubit argument {a!r} in: {stmt!r}")
            off, size = regs[am.group("reg")]
            if am.group("idx") is None:
                resolved.append([off + i for i in range(size)])
                bcast = max(bcast, size)
            else:
                idx = int(am.group("idx"))
                if idx >= size:
                    raise ValueError(f"index {idx} out of range in: {stmt!r}")
                resolved.append([off + idx])
        cols = [r if len(r) > 1 else r * bcast for r in resolved]
        if any(len(c) != bcast for c in cols):
            raise ValueError(f"mismatched register sizes in: {stmt!r}")

        for qubits in zip(*cols):
            if qname in ("u", "u3", "u2", "U"):
                if qname == "u2":
                    if len(params) != 2:
                        raise ValueError(f"u2 takes 2 parameters: {stmt!r}")
                    theta, (phi, lam) = math.pi / 2, params
                else:
                    if len(params) != 3:
                        raise ValueError(f"{qname} takes 3 parameters: {stmt!r}")
                    theta, phi, lam = params
                (q,) = qubits
                # U(theta, phi, lambda) = e^{i(phi+lambda)/2} rz(phi) ry(theta)
                # rz(lambda)  (global phase dropped; see module docstring)
                ops += [("rz", (q,), lam), ("ry", (q,), theta), ("rz", (q,), phi)]
            else:
                ours, nparams = _IMPORT[qname]
                if len(params) != nparams:
                    raise ValueError(
                        f"{qname} takes {nparams} parameter(s): {stmt!r}"
                    )
                ops.append((ours, qubits, params[0] if params else None))

    if total == 0:
        raise ValueError("QASM source declares no qreg")
    c = Circuit(total)
    for name, qubits, param in ops:
        c.add(name, *qubits, param=param)
    return c


def from_qasm_file(path: str, *, ignore_measurements: bool = False) -> Circuit:
    with open(path) as f:
        return from_qasm(f.read(), ignore_measurements=ignore_measurements)


def to_qasm(circuit: Circuit) -> str:
    """Serialize a :class:`Circuit` as OpenQASM 2.0 (qelib1 gate names).

    Every builder-reachable gate except ``mcz4``..``mcz10`` has a qelib1
    spelling (``mcz3`` exports as its exact ``h``-conjugated ``ccx``
    identity); wider MCZs and matrices added via
    :func:`tpu_qsim_torch.gates.register_gate` have no QASM 2.0 form and raise.
    """
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{circuit.num_qubits}];",
    ]
    for g in circuit.gates:
        args = ",".join(f"q[{q}]" for q in g.qubits)
        if re.fullmatch(r"mcz\d+", g.name):
            if g.name == "mcz3":
                # exact identity: MCZ(a,b,c) = H(c) CCX(a,b,c) H(c)
                a, b, c = g.qubits
                lines += [f"h q[{c}];", f"ccx q[{a}],q[{b}],q[{c}];", f"h q[{c}];"]
                continue
            raise ValueError(f"{g.name} has no OpenQASM 2.0 representation")
        if g.name not in GATE_ARITY or (
            g.name not in _EXPORT
            and g.name not in _IMPORT
        ):
            raise ValueError(f"gate {g.name!r} has no OpenQASM 2.0 spelling")
        spelled = _EXPORT.get(g.name, g.name)
        if g.name in PARAM_GATES:
            # float() strips NumPy scalar types whose repr ('np.float64(x)')
            # is not a QASM expression
            lines.append(f"{spelled}({float(g.param)!r}) {args};")
        else:
            lines.append(f"{spelled} {args};")
    return "\n".join(lines) + "\n"
