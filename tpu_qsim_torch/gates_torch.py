"""Parameterized gate matrices as functions of torch tensors.

The port's counterpart of ``tpu_qsim/gates_jax.py``: used by
:func:`tpu_qsim_torch.statevector.build_parameterized_run_fn` to plan a
circuit *structure* once and run it with any parameter vector, and to
differentiate through it with ``torch.autograd``.

Each builder takes an angle tensor of shape ``()`` or ``(P,)`` (a batch of
parameter vectors) and returns (real, imag-or-None) planes of shape
``(..., 2^k, 2^k)``; "diagonal" gates return their ``(..., 2^k)`` diagonals.
Conventions identical to :mod:`tpu_qsim_torch.gates`.
"""

from __future__ import annotations

import torch


def _cs(theta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return torch.cos(theta / 2), torch.sin(theta / 2)


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rx(theta: torch.Tensor):
    c, s = _cs(theta)
    z = torch.zeros_like(c)
    return _mat([[c, z], [z, c]]), _mat([[z, -s], [-s, z]])


def ry(theta: torch.Tensor):
    c, s = _cs(theta)
    return _mat([[c, -s], [s, c]]), None


def rz(theta: torch.Tensor):
    c, s = _cs(theta)
    return torch.stack([c, c], dim=-1), torch.stack([-s, s], dim=-1)   # diagonal


def p(lam: torch.Tensor):
    one, zero = torch.ones_like(lam), torch.zeros_like(lam)
    return (torch.stack([one, torch.cos(lam)], dim=-1),
            torch.stack([zero, torch.sin(lam)], dim=-1))                 # diagonal


def crz(theta: torch.Tensor):
    c, s = _cs(theta)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return (torch.stack([one, one, c, c], dim=-1),
            torch.stack([zero, zero, -s, s], dim=-1))                    # diagonal


def cp(lam: torch.Tensor):
    one, zero = torch.ones_like(lam), torch.zeros_like(lam)
    return (torch.stack([one, one, one, torch.cos(lam)], dim=-1),
            torch.stack([zero, zero, zero, torch.sin(lam)], dim=-1))     # diagonal


def cry(theta: torch.Tensor):
    c, s = _cs(theta)
    one, z = torch.ones_like(c), torch.zeros_like(c)
    return _mat([
        [one, z, z, z],
        [z, one, z, z],
        [z, z, c, -s],
        [z, z, s, c],
    ]), None


# name -> (builder, is_diagonal)
TRACED_GATES = {
    "rx": (rx, False),
    "ry": (ry, False),
    "rz": (rz, True),
    "p": (p, True),
    "crz": (crz, True),
    "cp": (cp, True),
    "cry": (cry, False),
}
