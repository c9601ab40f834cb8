"""State-vector simulator: the port's main path.

The counterpart of ``tpu_qsim/statevector.py``. ``run`` routes a circuit
through :mod:`tpu_qsim_torch.kernels.dispatch`: float32 states on the card
go through the hand-written kernels (whole-circuit at 10-18 qubits,
segmented at 19, grid-sweep at 20-30; where the grid planner refuses a
circuit, the sweeps engine at 22-26 qubits, else the segmented engine at
20-21, and from 22 the circuit cut at each refused gate into grid sweeps and
dense passes; ``engine`` names the route, e.g. ``grid_sweep+dense_pass``);
everything else goes through the fused torch engine. Readout is inherited from
:class:`tpu_qsim_torch.base.BaseSimulator`.

Parameterized runs (``run_parameterized``, ``build_expectation_fn``) go
through the torch engine with the parameterized gates built from tensors
(:mod:`tpu_qsim_torch.gates_torch`), as the JAX package runs them on XLA, so
``torch.autograd`` differentiates them and a ``(P, m)`` parameter tensor runs
as a batch of P states.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from . import apply as ap
from .base import BaseSimulator, parse_pauli, pauli_expectation
from .circuit import Circuit
from .config import DEFAULT_CONFIG, SimConfig
from .fusion import FusedGate, fuse_circuit, unfused_circuit
from .kernels import dispatch


def build_torch_run_fn(
    groups: list[FusedGate], rdtype: np.dtype, renorm_every: int = 0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """A planes-state -> planes-state function applying a fused group list
    with the torch engine. Group matrices are host-composed in complex128 and
    split into real/imag at the simulator's real dtype. ``renorm_every``:
    renormalize every N groups (deep-circuit norm-drift mitigation)."""
    consts = []
    for g in groups:
        mat = g.diag if g.diagonal else g.matrix
        ur, ui = ap.split_matrix(mat, rdtype)
        consts.append((g.qubits, g.diagonal, ur, ui))

    def step(state: torch.Tensor) -> torch.Tensor:
        for i, (qubits, diagonal, ur, ui) in enumerate(consts):
            if diagonal:
                state = ap.apply_diagonal(state, ur, ui, qubits)
            else:
                state = ap.apply_unitary(state, ur, ui, qubits)
            if renorm_every and (i + 1) % renorm_every == 0:
                norm = torch.sum(state * state)
                state = state * torch.rsqrt(
                    torch.clamp(norm, min=torch.finfo(state.dtype).tiny)
                )
        return state

    return step


def _param_tensor(params, rdtype, device) -> torch.Tensor:
    """A parameter vector (or a (P, m) batch) as a tensor on ``device``; a
    tensor keeps its autograd graph."""
    dt = ap.torch_dtype(rdtype)
    if isinstance(params, torch.Tensor):
        return params.to(device=device, dtype=dt)
    return torch.as_tensor(np.asarray(params, dtype=np.float64), dtype=dt, device=device)


def build_parameterized_run_fn(
    circuit: Circuit, rdtype: np.dtype, device=None,
) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A (state, params) -> state function for a circuit structure.

    Fixed gates go to ``device`` once, here; parameterized gates build their
    matrices from ``params`` (ordered as ``circuit.params()``) with
    :mod:`tpu_qsim_torch.gates_torch`, so the result is differentiable in
    them. Unfused: the matrices are run-time values. ``params`` of shape
    (P, m) with a (P, 2, 2^n) state runs P parameter vectors as a batch.
    """
    from .gates import DIAGONAL_GATES, op_matrix
    from .gates_torch import TRACED_GATES

    device = ap.resolve_device(device)
    plan = []  # ("const", qubits, diag, ur, ui) | ("param", name, qubits, idx)
    pi = 0
    for g in circuit.gates:
        if g.name in TRACED_GATES:
            plan.append(("param", g.name, g.qubits, pi))
            pi += 1
        elif g.param is not None:
            # folding its value in would desynchronize the params vector from
            # circuit.params() and bake a value into a structure-keyed plan
            raise ValueError(
                f"gate '{g.name}' has no traced-parameter builder; "
                f"run_parameterized supports {sorted(TRACED_GATES)} "
                f"(use run() for circuits with custom parameterized gates)"
            )
        else:
            mat = op_matrix(g)
            diag = g.name in DIAGONAL_GATES
            ur, ui = ap.split_matrix(
                np.ascontiguousarray(np.diagonal(mat)) if diag else mat, rdtype
            )
            plan.append(("const", g.qubits, diag,
                         ap.device_matrix(ur, rdtype, device),
                         ap.device_matrix(ui, rdtype, device)))

    def step(state: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        for op in plan:
            if op[0] == "const":
                _, qubits, diag, ur, ui = op
            else:
                _, name, qubits, idx = op
                builder, diag = TRACED_GATES[name]
                ur, ui = builder(params[..., idx])
            if diag:
                state = ap.apply_diagonal(state, ur, ui, qubits)
            else:
                state = ap.apply_unitary(state, ur, ui, qubits)
        return state

    return step


def build_expectation_fn(
    circuit: Circuit,
    observable,
    rdtype: np.dtype = np.float32,
    device=None,
) -> Callable[[Any], torch.Tensor]:
    """Differentiable ``params -> <psi(params)| H |psi(params)>``.

    ``observable`` is a Pauli string (``"ZZ"``, ``"XIY"``; rightmost
    character on qubit 0) or a weighted Pauli sum ``[(coeff, pauli), ...]``.
    The state is prepared once per evaluation and every term is measured on
    it. The returned function takes the parameter vector (ordered as
    ``circuit.params()``; a tensor that requires a gradient gets one through
    ``torch.autograd``) and returns a 0-d tensor, or, for a (P, m) batch of
    parameter vectors run as one batch of states, a (P,) tensor.
    ``device=None`` means the CUDA card.
    """
    if isinstance(observable, str):
        terms = [(1.0, observable)]
    else:
        terms = [(float(c), p) for c, p in observable]
    n = circuit.num_qubits
    parsed = [(c, parse_pauli(p, n)) for c, p in terms]
    n_params = len(circuit.params())
    device = ap.resolve_device(device)
    run = build_parameterized_run_fn(circuit, np.dtype(rdtype), device)

    def expval(params) -> torch.Tensor:
        params = _param_tensor(params, rdtype, device)
        if params.dim() not in (1, 2) or params.shape[-1] != n_params:
            raise ValueError(
                f"circuit has {n_params} parameters, got {tuple(params.shape)}"
            )
        lead = tuple(params.shape[:-1])
        state = ap.initial_state(n, rdtype, 0, device)
        state = run(state.expand(lead + tuple(state.shape)), params)
        total = torch.zeros(lead, dtype=state.dtype, device=device)
        for coeff, ops in parsed:
            total = total + coeff * (pauli_expectation(state, ops) if ops else 1.0)
        return total

    return expval


class StateVectorSimulator(BaseSimulator):
    """Exact pure-state simulator on ``(2, 2^n)`` planes.

    ``device=None`` means the CUDA card; pass ``device="cpu"`` to run on the
    CPU. ``engine`` names the engine of the last ``run``.
    """

    def __init__(
        self,
        num_qubits: int,
        config: SimConfig = DEFAULT_CONFIG,
        *,
        seed: int = 0,
        device=None,
    ):
        super().__init__(num_qubits, config, seed=seed, device=device)
        self._run_cache: dict[Any, tuple[str, Callable]] = {}
        self._param_cache: dict[Any, Callable] = {}
        self.engine: str | None = None

    # -- circuit execution --------------------------------------------------

    def compiled_run(self, circuit: Circuit) -> tuple[str, Callable]:
        """(engine name, state -> state function) for ``circuit``, cached
        per circuit signature."""
        key = circuit.signature()
        hit = self._run_cache.get(key)
        if hit is None:
            engine, fn = dispatch.plan_run(circuit, self._rdtype, self.device)
            if fn is None:
                groups = (
                    fuse_circuit(circuit, self.config.max_fused_qubits)
                    if self.config.fuse
                    else unfused_circuit(circuit)
                )
                fn = build_torch_run_fn(
                    groups, self._rdtype, self.config.renorm_every
                )
            hit = (engine, fn)
            self._run_cache[key] = hit
        return hit

    def run(self, circuit: Circuit) -> "StateVectorSimulator":
        """Apply every gate of ``circuit`` to the current state.

        Does not reset first (same contract as ``tpu_qsim``'s ``run``).
        Planning is cached per circuit signature.
        """
        if circuit.num_qubits != self.num_qubits:
            raise ValueError(
                f"circuit has {circuit.num_qubits} qubits, simulator has "
                f"{self.num_qubits}"
            )
        self.engine, fn = self.compiled_run(circuit)
        self._state = fn(self._state)
        return self

    def apply_gate(self, name: str, *qubits: int, param: float | None = None) -> None:
        """Single-gate convenience (plans/caches a 1-gate circuit)."""
        c = Circuit(self.num_qubits).add(name, *qubits, param=param)
        self.run(c)

    def apply_matrix(self, matrix: Any, qubits: tuple[int, ...] | list[int]) -> None:
        """Apply an arbitrary k-qubit unitary. ``qubits[0]`` is the
        matrix-index MSB. Unitarity is checked on host (atol 1e-6)."""
        u, qubits = self._checked_unitary(matrix, qubits)
        ur, ui = ap.split_matrix(u, self._rdtype)
        self._state = ap.apply_unitary(self._state, ur, ui, qubits)

    def _checked_unitary(self, matrix: Any, qubits) -> tuple[np.ndarray, tuple[int, ...]]:
        """``apply_matrix``'s arguments checked: a complex128 unitary of
        2^k x 2^k and k distinct qubits in range."""
        qubits = tuple(int(q) for q in qubits)
        for q in qubits:
            self._check_qubit(q)
        if len(set(qubits)) != len(qubits):
            raise ValueError("qubits must be distinct")
        u = np.asarray(matrix, dtype=np.complex128)
        k = len(qubits)
        if u.shape != (1 << k, 1 << k):
            raise ValueError(
                f"matrix shape {u.shape} does not match {k} qubit(s)"
            )
        if not np.allclose(u.conj().T @ u, np.eye(1 << k), atol=1e-6):
            raise ValueError("matrix is not unitary")
        return u, qubits

    # -- parameterized execution (variational workloads) ---------------------

    def run_parameterized(
        self, circuit: Circuit, params: Any | None = None
    ) -> "StateVectorSimulator":
        """Run ``circuit`` with its gate parameters as run-time inputs on the
        torch engine: one plan per circuit **structure**, reused for any
        parameter vector (ordered as ``circuit.params()``; a tensor that
        requires a gradient keeps its graph through the state)."""
        if circuit.num_qubits != self.num_qubits:
            raise ValueError(
                f"circuit has {circuit.num_qubits} qubits, simulator has "
                f"{self.num_qubits}"
            )
        if params is None:
            params = circuit.params()
        params = _param_tensor(params, self._rdtype, self.device)
        expected = len(circuit.params())
        if tuple(params.shape) != (expected,):
            raise ValueError(
                f"circuit has {expected} parameters, got {tuple(params.shape)}"
            )
        key = circuit.structure()
        fn = self._param_cache.get(key)
        if fn is None:
            fn = build_parameterized_run_fn(circuit, self._rdtype, self.device)
            self._param_cache[key] = fn
        self.engine = "torch"
        self._state = fn(self._state, params)
        return self
