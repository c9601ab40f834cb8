"""State-vector simulator: the port's main path.

The counterpart of ``tpu_qsim/statevector.py``. ``run`` routes a circuit
through :mod:`tpu_qsim_torch.kernels.dispatch`: float32 states on the card
go through the hand-written kernels (whole-circuit at 10-18 qubits,
segmented at 19, grid-sweep at 20-30; where the grid planner refuses a
circuit, the sweeps engine at 22-26 qubits and then the segmented engine up
to 26); everything else goes through the fused torch engine. Readout is inherited from
:class:`tpu_qsim_torch.base.BaseSimulator`.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from . import apply as ap
from .base import BaseSimulator
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
        ur, ui = ap.split_matrix(u, self._rdtype)
        self._state = ap.apply_unitary(self._state, ur, ui, qubits)
