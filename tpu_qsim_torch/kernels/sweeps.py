"""Host half of ``tpu_qsim/kernels/sweeps.py`` that the grid-sweep planner uses.

The part-map sweep kernels of that module (``_build_low_sweep``,
``_build_high_sweep``) are not ported yet. Of the names
``tpu_qsim/kernels/gridsweeps.py:59`` imports from it, ``_EXT_BASE`` and
``_VMEM_LIMIT`` are TPU layout and have no counterpart: the CUDA kernel reads
out-of-block bits from the global index, and its block lives in shared
memory sized by the sweep's geometry.
"""

from __future__ import annotations

import numpy as np

from .fused_circuit import _controlled_split, _is_diagonal

# The JAX planner's default per-sweep gate cap (a Mosaic compile bound there);
# kept as plan_grid_sweeps' default so plans compare gate by gate.
MAX_SWEEP_GATES = 56


def moving_qubits(u: np.ndarray, qubits: tuple[int, ...]) -> frozenset[int]:
    """Qubits along which ``u`` actually moves amplitudes: diagonal matrices
    move nothing; a controlled matrix moves only what its inner block moves."""
    if _is_diagonal(u):
        return frozenset()
    v = _controlled_split(u)
    if v is not None:
        return moving_qubits(v, qubits[1:])
    return frozenset(qubits)
