"""Execution over several ranks: qubit-sharded states and data-parallel
trajectories, on ``torch.distributed``.

The port of ``tpu_qsim/parallel.py``. Every rank runs the same program; the
caller starts the process group (``dist.init_process_group(backend, ...)``)
and the port uses the group it is given, over whatever backend it has: NCCL
between cards, or gloo for several ranks on one card (NCCL refuses two ranks
on one device; gloo stages CUDA tensors through host memory).

* **Amplitude (qubit) sharding.** Rank d of a mesh axis holds the amplitudes
  whose top log2(D) index bits equal d, as ``(2, 2^(n - log2 D))`` planes.
  The ``"collective"`` and ``"sweeps"`` engines run the block-swap executor
  (:mod:`tpu_qsim_torch.shardmap_engine`), the latter with the port's
  kernels on every shard. ``"gspmd"`` keeps the JAX package's engine name
  and does what that engine was measured to do there (docs/PERF_NOTES.md
  §15): it gathers the whole state on every rank, runs the single-device
  route of :func:`tpu_qsim_torch.kernels.dispatch.plan_run` on it, and keeps
  this rank's slice, so its memory per rank is the full state.
* **Trajectory batching.** ``ShardedBatchedSimulator`` splits the batch
  over a ``dp`` axis; with a ``tp`` axis each trajectory's amplitudes are
  split as well.

:func:`make_mesh` builds the port's own small mesh from plain
``dist.new_group`` calls (not ``DeviceMesh``: ``init_device_mesh("cuda")``
infers NCCL, which refuses two ranks on one card).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from . import apply as ap
from .base import host_complex, inverse_cdf, parse_pauli, pauli_expectation, reduced_planes
from .circuit import Circuit, Gate
from .config import DEFAULT_CONFIG, SimConfig
from .noise import NoiseModel
from .noisy import BatchedSimulator, collapse_batch
from .shardmap_engine import build_shardmap_run
from .statevector import StateVectorSimulator


class Mesh:
    """The ranks of a process group arranged row-major in ``shape``.

    ``shape`` maps each axis name to its size (as ``jax.sharding.Mesh``);
    ``coords`` maps it to this rank's coordinate and ``groups`` to the
    process group of the ranks that differ from this one only along that
    axis (``None`` for a rank outside the mesh).
    """

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], ranks: list[int]):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        me = dist.get_rank()
        grid = np.array(ranks).reshape(tuple(shape))
        where = np.argwhere(grid == me)
        self.coords = (
            dict(zip(self.axis_names, (int(c) for c in where[0]))) if len(where) else None
        )
        self.groups: dict[str, Any] = {}
        # every rank of the default group makes every subgroup, in one order
        for k, name in enumerate(self.axis_names):
            lines = np.moveaxis(grid, k, -1).reshape(-1, grid.shape[k])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if me in line:
                    self.groups[name] = g

    def group(self, axis: str):
        if self.coords is None:
            raise ValueError(f"rank {dist.get_rank()} is not in this mesh")
        return self.groups[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        self.group(axis)
        return self.coords[axis]


def make_mesh(
    axis_names: Sequence[str] = ("tp",),
    shape: Sequence[int] | None = None,
    group=None,
) -> Mesh:
    """A mesh over the ranks of ``group`` (None: the default group); by
    default all of them on the first axis. Every rank of the default group
    calls it, since each subgroup is made by ``dist.new_group``."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call "
            "torch.distributed.init_process_group(backend, ...) first"
        )
    ranks = list(range(dist.get_world_size())) if group is None else \
        list(dist.get_process_group_ranks(group))
    if shape is None:
        shape = [len(ranks)] + [1] * (len(axis_names) - 1)
    if len(shape) != len(axis_names) or math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {tuple(shape)} does not hold {len(ranks)} ranks")
    return Mesh(axis_names, shape, ranks)


def _all_gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """``x`` of every rank of ``group``, in rank order, joined along ``dim``."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _all_sum(value, group, dtype=torch.float64, device=None) -> torch.Tensor:
    """The sum over ``group`` of a scalar or tensor, as a tensor."""
    t = torch.as_tensor(value, dtype=dtype, device=device).clone()
    dist.all_reduce(t, group=group)
    return t


# Measured on the JAX package's 8-virtual-device mesh (docs/PERF_NOTES.md
# §15): its GSPMD engine all-gathers the full state to every device. The
# port's "gspmd" engine does the same, so above this limit "auto" resolves
# to the block-swap engine (1/D of the state per rank) and an explicit
# engine="gspmd" raises unless ``allow_replication=True``.
GSPMD_REPLICATION_LIMIT_BYTES = 1 << 30


class ShardedStateVectorSimulator(StateVectorSimulator):
    """State-vector simulator with the amplitude axis sharded over a mesh
    axis: ``state_planes`` is this rank's ``(2, 2^(n-G))`` slice (the
    amplitudes whose top G index bits equal its coordinate).

    Every rank of the axis constructs it with the same arguments and makes
    the same calls. Readouts give the same answer on every rank:
    ``get_state`` and ``get_probabilities`` gather; ``total_probability``,
    ``qubit_probability`` and ``expectation_pauli`` reduce local partial
    sums (a Pauli string with X or Y on a device qubit gathers the state);
    ``sample``, ``histogram`` and ``measure_qubit`` draw the same uniforms
    on every rank from the simulator's generator (the same seed everywhere).
    ``device=None`` means the CUDA card.
    """

    def __init__(
        self,
        num_qubits: int,
        mesh: Mesh | None = None,
        axis: str = "tp",
        config: SimConfig = DEFAULT_CONFIG,
        *,
        engine: str = "auto",
        seed: int = 0,
        grid_params=None,
        allow_replication: bool = False,
        device=None,
    ):
        """``engine``: "auto" (default) picks "gspmd" up to
        ``GSPMD_REPLICATION_LIMIT_BYTES`` of planes and "collective" above
        it; "gspmd" gathers the state, runs the single-device route and
        keeps the slice (above the limit only with ``allow_replication``);
        "collective" is the block-swap executor with the torch engine on
        each shard; "sweeps" the same with the port's kernel programs on
        each shard. ``grid_params`` shrinks the grid-sweep geometry for
        tests."""
        if engine not in ("auto", "gspmd", "collective", "sweeps"):
            raise ValueError(f"unknown engine {engine!r}")
        planes_bytes = (1 << num_qubits) * np.dtype(config.dtype).itemsize
        if engine == "auto":
            engine = (
                "gspmd"
                if planes_bytes <= GSPMD_REPLICATION_LIMIT_BYTES
                else "collective"
            )
        elif (
            engine == "gspmd"
            and planes_bytes > GSPMD_REPLICATION_LIMIT_BYTES
            and not allow_replication
        ):
            raise ValueError(
                f"engine='gspmd' at {num_qubits} qubits: the GSPMD "
                f"partitioned program replicates the FULL "
                f"{planes_bytes / 2**30:.1f} GiB state onto every device "
                "(measured: it all-gathers instead of exchanging, "
                "docs/PERF_NOTES.md §15), so per-device memory does NOT "
                "shrink with the mesh. Use engine='collective' or "
                "engine='sweeps' (true 1/D per-device footprint), or pass "
                "allow_replication=True to accept the footprint."
            )
        self.grid_params = grid_params
        self.mesh = mesh if mesh is not None else make_mesh((axis,))
        self.axis = axis
        self.group = self.mesh.group(axis)
        self.n_shards = self.mesh.shape[axis]
        self.shard = self.mesh.index(axis)
        if (1 << num_qubits) % self.n_shards != 0:
            raise ValueError(
                f"2^{num_qubits} amplitudes not divisible by {self.n_shards} shards"
            )
        self.local_dim = (1 << num_qubits) // self.n_shards
        super().__init__(num_qubits, config, seed=seed, device=device)
        self.engine = engine

    # -- state management ----------------------------------------------------

    def _initial_state(self, basis_index: int) -> torch.Tensor:
        state = torch.zeros(
            (2, self.local_dim), dtype=ap.torch_dtype(self._rdtype), device=self.device
        )
        if basis_index // self.local_dim == self.shard:
            state[0, basis_index % self.local_dim] = 1.0
        return state

    def _slice(self, full: torch.Tensor) -> torch.Tensor:
        lo = self.shard * self.local_dim
        return full[..., lo:lo + self.local_dim].contiguous()

    def _gathered(self) -> torch.Tensor:
        return _all_gather(self._state, self.group)

    def set_state(self, amplitudes: Any) -> None:
        """Full amplitudes (the same on every rank); this rank keeps its
        slice."""
        amplitudes = np.asarray(amplitudes)
        if amplitudes.shape != (self.dim,):
            raise ValueError(f"state must have shape ({self.dim},)")
        lo = self.shard * self.local_dim
        self._state = ap.from_complex(
            amplitudes[lo:lo + self.local_dim], self._rdtype, self.device
        )

    # -- execution -------------------------------------------------------------

    def compiled_run(self, circuit: Circuit):
        """(engine, program): the single-device route for "gspmd", else the
        block-swap program, cached per circuit signature."""
        if self.engine == "gspmd":
            return super().compiled_run(circuit)
        key = circuit.signature()
        hit = self._run_cache.get(key)
        if hit is None:
            prog = build_shardmap_run(
                circuit, self.group, self._rdtype,
                local_engine="kernels" if self.engine == "sweeps" else "apply",
                device=self.device, grid_params=self.grid_params,
            )
            hit = (self.engine, prog)
            self._run_cache[key] = hit
        return hit

    def run(self, circuit: Circuit) -> "ShardedStateVectorSimulator":
        if circuit.num_qubits != self.num_qubits:
            raise ValueError(
                f"circuit has {circuit.num_qubits} qubits, simulator has "
                f"{self.num_qubits}"
            )
        _, fn = self.compiled_run(circuit)
        if self.engine == "gspmd":
            self._state = self._slice(fn(self._gathered()))
        else:
            self._state = fn(self._state)
        return self

    def apply_matrix(self, matrix: Any, qubits) -> None:
        """Apply a k-qubit unitary (``qubits[0]`` the matrix-index MSB)
        through the simulator's engine, as a one-gate circuit."""
        u, qubits = self._checked_unitary(matrix, qubits)
        gate = Gate("unitary", qubits, None, np.ascontiguousarray(u).tobytes())
        self.run(Circuit(self.num_qubits).append(gate))

    def run_parameterized(self, circuit: Circuit, params: Any | None = None):
        """The torch engine's parameterized run on the gathered state; this
        rank keeps its slice (the state is replicated while it runs)."""
        self._state = self._gathered()
        try:
            super().run_parameterized(circuit, params)
        finally:
            self._state = self._slice(self._state)
        return self

    # -- readout ---------------------------------------------------------------

    def get_state(self) -> np.ndarray:
        return ap.to_complex(self._gathered())

    def probabilities(self) -> torch.Tensor:
        """All 2^n probabilities, gathered on every rank."""
        return _all_gather(ap.probabilities(self._state), self.group)

    def total_probability(self) -> float:
        return float(_all_sum(ap.total_probability(self._state), self.group,
                              device=self.device))

    def _local_bits(self) -> int:
        return self.local_dim.bit_length() - 1

    def _shard_bit(self, qubit: int) -> int:
        return (self.shard >> (qubit - self._local_bits())) & 1

    def qubit_probability(self, qubit: int) -> float:
        self._check_qubit(qubit)
        if qubit < self._local_bits():
            part = ap.qubit_marginal(self._state, qubit)
        else:
            part = ap.total_probability(self._state) * self._shard_bit(qubit)
        return float(_all_sum(part, self.group, device=self.device))

    def sample(self, shots: int, generator: torch.Generator | None = None) -> torch.Tensor:
        """``shots`` basis indices, the same on every rank: every rank draws
        the same uniforms, resolves those that fall in its shard (by the
        shard masses, gathered) with its local inverse CDF, and the indices
        are summed across ranks."""
        if shots < 1:
            raise ValueError("shots must be >= 1")
        u = torch.rand(shots, generator=self._generator(generator),
                       dtype=torch.float64, device=self.device)
        probs = ap.probabilities(self._state)
        mass = torch.sum(probs, dtype=torch.float64).reshape(1)
        cum = torch.cumsum(_all_gather(mass, self.group), 0)
        target = u * cum[-1]
        below = cum[self.shard] - mass[0]
        mine = (target >= below) & (target < cum[self.shard])
        if self.shard == self.n_shards - 1:
            mine |= target >= cum[-1]
        local_u = ((target - below) / mass[0].clamp(min=1e-300)).clamp(0.0, 1.0 - 1e-16)
        idx = inverse_cdf(probs, local_u) + self.shard * self.local_dim
        idx = torch.where(mine, idx, torch.zeros_like(idx))
        dist.all_reduce(idx, group=self.group)
        return idx

    def measure_qubit(self, qubit: int, generator: torch.Generator | None = None) -> int:
        """Measure one qubit: p1 by a reduction, one draw shared by every
        rank, and the collapse on each shard."""
        self._check_qubit(qubit)
        p1 = min(max(self.qubit_probability(qubit), 0.0), 1.0)
        draw = torch.rand(1, generator=self._generator(generator),
                          dtype=torch.float64, device=self.device)
        outcome = int(draw.item() < p1)
        p_outcome = p1 if outcome else 1.0 - p1
        if qubit < self._local_bits():
            self._state = ap.collapse(self._state, qubit, outcome, p_outcome)
        elif self._shard_bit(qubit) == outcome:
            self._state = self._state / np.sqrt(max(p_outcome, np.finfo(np.float64).tiny))
        else:
            self._state = torch.zeros_like(self._state)
        return outcome

    def expectation_pauli(self, pauli: str) -> float:
        """<psi| P |psi>, the rightmost character on qubit 0. Z on a device
        qubit is this shard's sign and X or Y on a local qubit act on the
        shard, so those strings reduce local partial sums; a string with X
        or Y on a device qubit gathers the state."""
        ops = parse_pauli(pauli, self.num_qubits)
        if not ops:
            return 1.0
        lb = self._local_bits()
        if any(q >= lb and p != "Z" for q, p in ops):
            return float(pauli_expectation(self._gathered(), ops))
        sign = (-1) ** sum(self._shard_bit(q) for q, _ in ops if q >= lb)
        local = tuple((q, p) for q, p in ops if q < lb)
        part = sign * (pauli_expectation(self._state, local) if local
                       else ap.total_probability(self._state))
        return float(_all_sum(part, self.group, device=self.device))

    def reduced_density_matrix(self, qubits) -> np.ndarray:
        """Partial trace onto ``qubits`` of the gathered state."""
        qs = self._validated_subset(qubits)
        return host_complex(*reduced_planes(self._gathered(), qs))

    def fidelity_with(self, other) -> float:
        """|<psi|phi>|^2 against another sharded simulator of the same layout
        (shard by shard), or full ``(2, 2^n)`` planes or a simulator holding
        them (this rank's slice of them); reduced across ranks."""
        if isinstance(other, ShardedStateVectorSimulator):
            if (other.num_qubits, other.n_shards) != (self.num_qubits, self.n_shards):
                raise ValueError("sharded peers must have the same width and shards")
            mine = other.state_planes.to(self._state.device, self._state.dtype)
        else:
            mine = self._slice(self._peer_planes(other, (2, self.dim)))
        re, im = ap.inner_product(self._state, mine)
        both = _all_sum(torch.stack([re, im]).double(), self.group, device=self.device)
        return float(both[0] ** 2 + both[1] ** 2)

    def save_state(self, path: str) -> None:
        """Gather the state and write it, with the JAX package's keys, from
        the mesh's first rank; every rank returns once it is written."""
        planes = self._gathered()
        if self.shard == 0:
            np.savez(path, planes=planes.cpu().numpy(), num_qubits=self.num_qubits,
                     dtype=str(self._rdtype))
        dist.barrier(group=self.group)

    def load_state(self, path: str) -> None:
        """Read a checkpoint of either package; this rank keeps its slice."""
        data = np.load(path)
        if int(data["num_qubits"]) != self.num_qubits:
            raise ValueError(
                f"checkpoint has {int(data['num_qubits'])} qubits, simulator "
                f"has {self.num_qubits}"
            )
        planes = np.asarray(data["planes"], dtype=self._rdtype)
        if planes.shape != (2, self.dim):
            raise ValueError(f"checkpoint shape {planes.shape} mismatch")
        self._state = self._slice(torch.from_numpy(planes)).to(self.device)


class ShardedBatchedSimulator(BatchedSimulator):
    """A trajectory batch split over a ``dp`` mesh axis, and with ``tp_axis``
    each trajectory's amplitudes over that axis as well: ``state_planes`` is
    this rank's ``(batch / dp, 2, 2^n / tp)`` block.

    Every rank draws a run's full ``(batch, n_draws)`` uniforms from the
    simulator's generator (the same seed on every rank) and keeps its rows,
    so it equals ``BatchedSimulator(n, batch, seed=s)`` trajectory for
    trajectory. With ``tp_axis`` a run gathers each trajectory over ``tp``,
    runs the trajectory step and keeps the slice: the replication the JAX
    package's GSPMD program was measured to do (docs/PERF_NOTES.md §15).
    The readouts reduce over both axes and give the same answer on every
    rank.
    """

    def __init__(
        self,
        num_qubits: int,
        batch_size: int,
        noise_model: NoiseModel | None = None,
        mesh: Mesh | None = None,
        dp_axis: str = "dp",
        tp_axis: str | None = None,
        config: SimConfig = DEFAULT_CONFIG,
        *,
        seed: int = 0,
        insertion: str = "all",
        device=None,
    ):
        self.mesh = mesh if mesh is not None else make_mesh((dp_axis,))
        self.dp_axis = dp_axis
        self.tp_axis = tp_axis
        dp = self.mesh.shape[dp_axis]
        if batch_size % dp != 0:
            raise ValueError(
                f"batch_size {batch_size} not divisible by dp={dp} shards"
            )
        tp = self.mesh.shape[tp_axis] if tp_axis is not None else 1
        if (1 << num_qubits) % tp:
            raise ValueError("2^n amplitudes not divisible by tp shards")
        self.dp_group = self.mesh.group(dp_axis)
        self.dp_index = self.mesh.index(dp_axis)
        self.tp_group = self.mesh.group(tp_axis) if tp_axis is not None else None
        self.tp_index = self.mesh.index(tp_axis) if tp_axis is not None else 0
        self.local_batch = batch_size // dp
        self.local_dim = (1 << num_qubits) // tp
        super().__init__(num_qubits, batch_size, noise_model, config, seed=seed,
                         insertion=insertion, device=device)

    # -- layout ------------------------------------------------------------------

    def _initial_state(self, basis_index: int) -> torch.Tensor:
        return self._tp_slice(super()._initial_state(basis_index))

    def _broadcast(self, one: torch.Tensor) -> torch.Tensor:
        return one.expand((self.local_batch,) + tuple(one.shape)).contiguous()

    def _tp_slice(self, full: torch.Tensor) -> torch.Tensor:
        lo = self.tp_index * self.local_dim
        return full[..., lo:lo + self.local_dim].contiguous()

    def _rows(self, full: torch.Tensor) -> torch.Tensor:
        lo = self.dp_index * self.local_batch
        return full[lo:lo + self.local_batch]

    def _tp_gathered(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp_group is None else _all_gather(x, self.tp_group)

    def _all_states(self) -> torch.Tensor:
        """All (batch, 2, 2^n) trajectories, gathered on every rank: the
        readouts that need every amplitude (``get_state``,
        ``trajectory_probabilities``, ``reduced_density_matrix``,
        ``fidelity_with``, ``expectation_pauli``) read them."""
        return _all_gather(self._tp_gathered(self._states), self.dp_group, dim=0)

    # -- execution ---------------------------------------------------------------

    def run(self, circuit: Circuit, generator: torch.Generator | None = None):
        """Advance this rank's trajectories, each with its row of the full
        batch's uniforms."""
        step, n_draws = self._compiled_run(circuit)
        uniforms = self._rows(self._uniforms((self.batch_size, n_draws), generator))
        self._states = self._tp_slice(step(self._tp_gathered(self._states), uniforms))
        return self

    def set_state(self, amplitudes: Any) -> None:
        """Start every trajectory from the given pure state (full amplitudes,
        the same on every rank)."""
        amplitudes = np.asarray(amplitudes)
        if amplitudes.shape != (self.dim,):
            raise ValueError(f"state must have shape ({self.dim},)")
        full = ap.from_complex(amplitudes, self._rdtype, self.device)
        self._states = self._broadcast(self._tp_slice(full))

    # -- readout (reduced over both axes) ----------------------------------------

    def probabilities(self) -> torch.Tensor:
        """Batch-averaged probabilities (2^n,), on every rank."""
        s = self._states
        part = torch.sum(s[:, 0] ** 2 + s[:, 1] ** 2, dim=0)
        dist.all_reduce(part, group=self.dp_group)
        return self._tp_gathered(part / self.batch_size)

    def total_probability(self) -> float:
        part = torch.sum(self._states.double() ** 2)
        for group in (self.dp_group, self.tp_group):
            if group is not None:
                dist.all_reduce(part, group=group)
        return float(part) / self.batch_size

    def sample(self, shots: int, generator: torch.Generator | None = None) -> torch.Tensor:
        """(batch, shots) samples, each trajectory from its own state, the
        same on every rank."""
        if shots < 1:
            raise ValueError("shots must be >= 1")
        u = self._rows(self._uniforms((self.batch_size, shots), generator))
        s = self._tp_gathered(self._states)
        idx = inverse_cdf(s[:, 0] ** 2 + s[:, 1] ** 2, u)
        return _all_gather(idx, self.dp_group, dim=0)

    def measure_qubit(self, qubit: int, generator: torch.Generator | None = None) -> np.ndarray:
        """Per-trajectory measurement with collapse: each trajectory is
        gathered over ``tp`` and takes its row of the batch's uniforms.
        Returns the (batch,) int32 outcomes, on every rank."""
        self._check_qubit(qubit)
        u = self._rows(self._uniforms((self.batch_size,), generator))
        states, outcome = collapse_batch(self._tp_gathered(self._states), qubit, u)
        self._states = self._tp_slice(states)
        return _all_gather(outcome.to(torch.int32), self.dp_group, dim=0).cpu().numpy()

    def save_state(self, path: str) -> None:
        """Gather the batch and write it from the mesh's first rank."""
        planes = self._all_states()
        if self.dp_index == 0 and self.tp_index == 0:
            np.savez(path, planes=planes.cpu().numpy(), num_qubits=self.num_qubits,
                     batch_size=self.batch_size, dtype=str(self._rdtype))
        dist.barrier(group=self.dp_group)
        if self.tp_group is not None:
            dist.barrier(group=self.tp_group)

    def load_state(self, path: str) -> None:
        """Read a batch checkpoint; this rank keeps its block."""
        data = np.load(path)
        if int(data["num_qubits"]) != self.num_qubits:
            raise ValueError("checkpoint qubit count mismatch")
        if int(data.get("batch_size", -1)) != self.batch_size:
            raise ValueError("checkpoint batch size mismatch")
        planes = np.asarray(data["planes"], dtype=self._rdtype)
        if planes.shape != (self.batch_size, 2, self.dim):
            raise ValueError("checkpoint shape mismatch")
        full = torch.from_numpy(planes)
        self._states = self._rows(self._tp_slice(full)).contiguous().to(self.device)
