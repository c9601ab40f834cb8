"""Block-swap executor for a state sharded over a ``torch.distributed`` group.

The port of ``tpu_qsim/shardmap_engine.py``. Rank ``d`` of the group holds
the amplitudes whose top ``G = log2(D)`` index bits equal ``d``, as
``(2, 2^(n-G))`` planes, and a circuit runs as

* **device-local gates** on each shard: one by one through
  :func:`tpu_qsim_torch.apply.apply_unitary` (``local_engine="apply"``), or
  as one of the port's kernel programs per segment (``"kernels"``: the
  whole-circuit route at 10-18 local qubits, the segmented program at 19,
  the grid sweep at 20-30 with the sweeps and segmented fallbacks, as
  :mod:`tpu_qsim_torch.kernels.dispatch` routes a whole state);
* **block swaps**: one ``torch.distributed.all_to_all_single`` exchanges
  the G device-index bits with the top G local bits; sandwiched between
  local relabelings (:func:`tpu_qsim_torch.apply.permute_qubits`) it moves
  any G qubits onto the device axis (plan:
  :func:`tpu_qsim_torch.schedule.plan_blockswap_segments`).

One exchange per segment that needs nonlocal qubits, plus at most two for
the restore to the canonical placement. The planners here are copies of the
JAX package's and give the same plans. The caller makes the process group;
the exchange rides whatever backend it has (NCCL across cards; gloo, which
stages CUDA tensors through host memory, for several ranks on one card).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from . import apply as ap
from .circuit import Circuit
from .schedule import SWAP_MIN, plan_blockswap_segments


# ---------------------------------------------------------------------------
# Permutation planning (host logic; copies of the JAX package's)
# ---------------------------------------------------------------------------

def _identity(k: int) -> tuple[int, ...]:
    return tuple(range(k))


def _invert(src: tuple[int, ...]) -> tuple[int, ...]:
    inv = [0] * len(src)
    for i, s in enumerate(src):
        inv[s] = i
    return tuple(inv)


def _local_src_for_targets(
    pos: list[int], targets: dict[int, int], local_bits: int
) -> tuple[int, ...]:
    """Local permutation (src[i] = old bit feeding new bit i) sending each
    qubit q in ``targets`` to bit targets[q]; everything else stays put when
    possible. Bits outside [0, local_bits) are untouched by construction."""
    src = [-1] * local_bits
    used_old = set()
    for q, newbit in targets.items():
        src[newbit] = pos[q]
        used_old.add(pos[q])
    # two passes: prefer identity, then fill
    free_old = [b for b in range(local_bits) if b not in used_old]
    free_old_set = set(free_old)
    for i in range(local_bits):
        if src[i] == -1 and i in free_old_set:
            src[i] = i
            free_old_set.remove(i)
    rest = sorted(free_old_set)
    for i in range(local_bits):
        if src[i] == -1:
            src[i] = rest.pop(0)
    return tuple(src)


class _Sim:
    """Placement simulator mirroring what the device ops do to index bits."""

    def __init__(self, pos: tuple[int, ...], n: int, g_bits: int):
        self.n = n
        self.local_bits = n - g_bits
        self.g = g_bits
        self.stage = list(range(self.local_bits - g_bits, self.local_bits))
        self.pos = list(pos)
        self.at = [0] * n
        for q, b in enumerate(self.pos):
            self.at[b] = q

    def local(self, src: tuple[int, ...]) -> None:
        new_at = list(self.at)
        for i, s in enumerate(src):
            new_at[i] = self.at[s]
        self.at = new_at
        for b, q in enumerate(self.at):
            self.pos[q] = b

    def swap(self) -> None:
        for j in range(self.g):
            a, b = self.stage[j], self.local_bits + j
            qa, qb = self.at[a], self.at[b]
            self.at[a], self.at[b] = qb, qa
            self.pos[qa], self.pos[qb] = b, a


def plan_restore_ops(
    pos: tuple[int, ...], n: int, g_bits: int, swap_min: int = SWAP_MIN
) -> list[tuple]:
    """Return ("local", src) / ("swap",) ops mapping ``pos`` to identity.

    Algorithm: (1) if the device block holds any device-destined qubit but
    is not entirely correct, flush it down with a courier swap; (2) stage
    every device-destined qubit at its stage slot and swap up; (3) one local
    cleanup. At most 2 all_to_alls.
    """
    sim = _Sim(pos, n, g_bits)
    L, G = sim.local_bits, g_bits
    ops: list[tuple] = []

    def emit_local(src: tuple[int, ...]) -> None:
        if src != _identity(L):
            sim.local(src)
            ops.append(("local", src))

    def emit_swap() -> None:
        sim.swap()
        ops.append(("swap",))

    dev_destined = list(range(L, n))
    device_correct = all(sim.pos[q] == q for q in dev_destined)
    if not device_correct:
        if any(sim.pos[q] >= L for q in dev_destined):
            # flush: stage couriers (local-destined qubits currently at
            # movable local bits — never bits < swap_min)
            couriers = [
                q for q in range(L) if swap_min <= sim.pos[q] < L
            ][:G]
            assert len(couriers) == G, "not enough courier slots"
            emit_local(
                _local_src_for_targets(
                    sim.pos, {q: sim.stage[j] for j, q in enumerate(couriers)}, L
                )
            )
            emit_swap()
        # now every device-destined qubit is local: stage and swap up
        emit_local(
            _local_src_for_targets(
                sim.pos, {q: sim.stage[j] for j, q in enumerate(dev_destined)}, L
            )
        )
        emit_swap()
    # local cleanup
    if any(sim.pos[q] != q for q in range(L)):
        emit_local(tuple(sim.pos[i] for i in range(L)))
    assert all(sim.pos[q] == q for q in range(n)), f"restore failed: {sim.pos}"
    return ops


def plan_victim_sandwich(
    victims: tuple[int, ...], local_bits: int, g_bits: int
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """(lam, lam_inv) local permutations realizing the planner's relabeling
    sigma = {victim_j <-> device bit L+j} as lam_inv . all_to_all . lam:
    lam sends victim_j's content to stage_j; lam_inv returns everything the
    sandwich displaced. Correct for arbitrary victim/stage overlap."""
    stage = list(range(local_bits - g_bits, local_bits))
    src = [-1] * local_bits
    used = set()
    for v, s in zip(victims, stage):
        src[s] = v
        used.add(v)
    free_old = [b for b in range(local_bits) if b not in used]
    free_set = set(free_old)
    for i in range(local_bits):
        if src[i] == -1 and i in free_set:
            src[i] = i
            free_set.remove(i)
    rest = sorted(free_set)
    for i in range(local_bits):
        if src[i] == -1:
            src[i] = rest.pop(0)
    lam = tuple(src)
    return lam, _invert(lam)


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class _GateLoop:
    """A segment's gates one by one through ``apply_unitary`` (the JAX
    executor's per-gate loop), their matrices on the device once."""

    def __init__(self, gates: list, rdtype, device: torch.device):
        self.gates = []
        for mat, phys in gates:
            ur, ui = ap.split_matrix(mat, rdtype)
            self.gates.append((phys, ap.device_matrix(ur, rdtype, device),
                               ap.device_matrix(ui, rdtype, device)))

    def __call__(self, block: torch.Tensor) -> torch.Tensor:
        for phys, ur, ui in self.gates:
            block = ap.apply_unitary(block, ur, ui, phys)
        return block


def plan_local(circuit: Circuit, rdtype, grid_params=None) -> tuple[str, Callable | None]:
    """(engine, program) for one segment's gates on a ``(2, 2^local)``
    shard, picked by the local size as ``_build_local_kernel`` picks it in
    the JAX package; ``("torch", None)`` where that returns None (float64
    planes, fewer than 10 local qubits, or every engine refuses).
    ``grid_params`` (tests) takes the grid sweep at that geometry wherever
    the shard exceeds its block by two bits."""
    from .kernels import dispatch
    from .kernels.gridsweeps import GridSweepProgram

    n = circuit.num_qubits
    if np.dtype(rdtype) != np.float32:
        return "torch", None
    try:
        if grid_params is not None and n > grid_params.blk_bits + 1:
            return "grid_sweep", GridSweepProgram(circuit, grid_params)
        engine = dispatch.engine_for_size(n)
        if engine != "torch":
            return dispatch.plan_kernels(circuit, engine)
    except ValueError:
        pass
    return "torch", None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ShardMapProgram:
    """A circuit planned for block swaps over ``group``: ``run`` (or a call)
    maps this rank's ``(2, 2^(n-G))`` shard to its shard after the circuit.

    Every rank of ``group`` builds the same program and runs it together.
    ``engines`` names each segment's local engine, ``planned_exchanges`` the
    ``all_to_all`` calls one run makes (segments with victims plus the
    restore's swaps) and ``exchanges`` counts the calls made so far. One send
    and one receive buffer of the shard's size serve every swap of a
    program.
    """

    def __init__(
        self,
        circuit: Circuit,
        group: dist.ProcessGroup | None,
        rdtype,
        *,
        local_engine: str = "apply",
        device=None,
        grid_params=None,
    ):
        n = circuit.num_qubits
        n_dev = dist.get_world_size(group)
        g_bits = n_dev.bit_length() - 1
        if (1 << g_bits) != n_dev:
            raise ValueError(f"device count {n_dev} must be a power of 2")
        local_bits = n - g_bits
        if local_bits < SWAP_MIN + 2 * g_bits:
            raise ValueError("too few local bits for block-swap relabeling")
        if local_engine not in ("apply", "kernels"):
            raise ValueError(f"unknown local_engine {local_engine!r}")
        device = ap.resolve_device(device)
        self.group = group
        self.num_qubits = n
        self.n_dev = n_dev
        self.local_bits = local_bits
        segments, final_pos = plan_blockswap_segments(circuit, g_bits)
        self.restore_ops = plan_restore_ops(final_pos, n, g_bits)
        self.steps: list[tuple] = []
        self.engines: list[str] = []
        named = iter(circuit.gates)   # the segments keep the circuit's order
        for seg in segments:
            engine, prog = "torch", None
            if local_engine == "kernels":
                local = Circuit(local_bits)
                for _, phys in seg.gates:
                    local.append(replace(next(named), qubits=phys))
                engine, prog = plan_local(local, rdtype, grid_params)
            sandwich = (
                plan_victim_sandwich(seg.victims, local_bits, g_bits)
                if seg.victims is not None
                else None
            )
            if prog is None:
                prog = _GateLoop(seg.gates, rdtype, device)
            self.steps.append((sandwich, prog))
            self.engines.append(engine)
        self.planned_exchanges = sum(s is not None for s, _ in self.steps) + sum(
            op[0] == "swap" for op in self.restore_ops
        )
        self.exchanges = 0
        self._buffers: tuple[torch.Tensor, torch.Tensor] | None = None

    def block_swap(self, block: torch.Tensor) -> torch.Tensor:
        """Exchange the top G local bits with the device bits, in place:
        chunk j of the shard (its ``(2, D, L/D)`` view's axis 1) goes to
        rank j, and the chunk from rank j lands at index j, as the JAX
        package's tiled ``all_to_all(split_axis=1, concat_axis=1)``."""
        d = self.n_dev
        view = block.contiguous().view(2, d, -1)
        if self._buffers is None or self._buffers[0].shape[2] != view.shape[2] \
                or self._buffers[0].device != view.device:
            self._buffers = tuple(
                torch.empty((d, 2, view.shape[2]), dtype=view.dtype, device=view.device)
                for _ in range(2)
            )
        send, recv = self._buffers
        send.copy_(view.transpose(0, 1))
        dist.all_to_all_single(recv, send, group=self.group)
        self.exchanges += 1
        view.copy_(recv.transpose(0, 1))
        return view.view(2, -1)

    def run(self, block: torch.Tensor, times: dict | None = None) -> torch.Tensor:
        """The circuit on this rank's shard. With ``times`` (a dict), each
        exchange is timed on the host clock between synchronizations
        (``exchange_ms``) and the local work by CUDA events on a card
        (``local_ms``; the host clock on the CPU); both add to the dict."""
        ident = _identity(self.local_bits)
        events: list = []

        def swap(x: torch.Tensor) -> torch.Tensor:
            if times is None:
                return self.block_swap(x)
            _sync(x.device)
            t0 = time.perf_counter()
            x = self.block_swap(x)
            _sync(x.device)
            times["exchange_ms"] = times.get("exchange_ms", 0.0) + 1e3 * (time.perf_counter() - t0)
            return x

        def local(fn, x: torch.Tensor) -> torch.Tensor:
            if times is None:
                return fn(x)
            if x.is_cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                x = fn(x)
                end.record()
                events.append((start, end))
                return x
            t0 = time.perf_counter()
            x = fn(x)
            times["local_ms"] = times.get("local_ms", 0.0) + 1e3 * (time.perf_counter() - t0)
            return x

        for sandwich, step in self.steps:
            if sandwich is not None:
                lam, lam_inv = sandwich
                if lam != ident:
                    block = local(lambda x: ap.permute_qubits(x, lam), block)
                block = swap(block)
                if lam_inv != ident:
                    block = local(lambda x: ap.permute_qubits(x, lam_inv), block)
            block = local(step, block)
        for op in self.restore_ops:
            if op[0] == "swap":
                block = swap(block)
            else:
                block = local(lambda x, src=op[1]: ap.permute_qubits(x, src), block)
        if events:
            _sync(block.device)
            times["local_ms"] = times.get("local_ms", 0.0) + sum(
                s.elapsed_time(e) for s, e in events
            )
        return block

    __call__ = run


def build_shardmap_run(
    circuit: Circuit,
    group: dist.ProcessGroup | None,
    rdtype,
    *,
    local_engine: str = "apply",
    device=None,
    grid_params=None,
) -> ShardMapProgram:
    """Plan ``circuit`` for block swaps over ``group`` (None: the default
    group): the counterpart of the JAX package's ``build_shardmap_run``.

    ``local_engine="apply"`` runs each segment's device-local gates one by
    one on the torch engine; ``"kernels"`` plans each segment as one of the
    port's kernel programs for the shard's size (on a CPU shard they run
    their plain versions). ``device`` (None: the card) holds the gate
    matrices; ``grid_params`` shrinks the grid-sweep geometry for tests.
    """
    return ShardMapProgram(
        circuit, group, rdtype, local_engine=local_engine, device=device,
        grid_params=grid_params,
    )
