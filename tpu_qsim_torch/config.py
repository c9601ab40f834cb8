"""Runtime configuration.

The port's counterpart of ``tpu_qsim/config.py``: a frozen dataclass threaded
through simulator constructors. The JAX package's Pallas knobs
(``use_pallas``, ``pallas_interpret``, ``pallas_whole_circuit_max``,
``donate_state``) have no counterpart here: the engine is chosen by size,
dtype and device in :mod:`tpu_qsim_torch.kernels.dispatch`, and the CUDA
kernel updates the state in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Configuration shared by the simulator backends.

    Attributes:
      dtype: complex dtype name for the state ("complex64" or "complex128").
        complex64 runs as float32 planes and takes the CUDA grid-sweep
        kernel at 20-30 qubits; complex128 runs as float64 planes on the
        torch engine.
      fuse: run the gate-fusion pass before the torch engine applies the
        circuit (one reshape-and-matmul pass per fused group instead of one
        per gate). The grid-sweep kernel plans its own sweeps and ignores it.
      max_fused_qubits: cap on the qubit count of one fused gate group.
      renorm_every: renormalize the state every N gate groups on the torch
        engine (0 = never); the float32 norm drift mitigation of
        ``tpu_qsim/config.py``.
    """

    dtype: str = "complex64"
    fuse: bool = True
    max_fused_qubits: int = 5
    renorm_every: int = 0

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)

    @property
    def real_dtype(self) -> np.dtype:
        return np.dtype("float32" if self.dtype == "complex64" else "float64")

    def replace(self, **kw: Any) -> "SimConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SimConfig()
