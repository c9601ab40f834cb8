"""Rank functions for the sharded tests (``tpu_qsim_torch.ranks.run_ranks``).

Each spawned rank imports this module by name, so it imports neither JAX nor
the JAX package: a rank costs a torch import. Every function runs its cases
on every rank in the same order and returns a dict of results; a case's
exception is returned in its place (``("error", traceback)``) so one broken
case fails its own test, not the whole file. A case must not raise on some
ranks only while others wait in a collective.
"""

from __future__ import annotations

import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

N_EXEC = 16
EXEC_WORLDS = (2, 4, 8)


def random_state(num_qubits: int, seed: int = 1234) -> np.ndarray:
    """``conftest.random_state`` of a fresh ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    dim = 1 << num_qubits
    s = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
    return s / np.linalg.norm(s)


def device_bits_circuit(n: int):
    import tpu_qsim_torch as tq

    return (tq.Circuit(n).h(n - 1).x(n - 2).cnot(n - 1, n - 3).rz(n - 2, 0.7)
            .toffoli(n - 1, n - 2, n - 3).swap(n - 3, n - 1).cry(n - 2, n - 1, 1.1))


def _cases(rank: int, cases) -> dict:
    torch.set_num_threads(1)
    out = {}
    for name, fn in cases:
        try:
            out[name] = fn()
        except Exception:
            out[name] = ("error", traceback.format_exc())
    out["imports"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "tpu_qsim"))
    return out


def _full(state: torch.Tensor, group) -> np.ndarray:
    from tpu_qsim_torch import apply as ap

    parts = [torch.empty_like(state) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, state.contiguous(), group=group)
    return ap.to_complex(torch.cat(parts, 1))


def _exec(circuit, group, rank, rdtype, psi0=None, **kw):
    """(full state after the block-swap program, exchanges, planned, engines)
    from ``group``'s ranks; None on a rank outside the group."""
    from tpu_qsim_torch import apply as ap
    from tpu_qsim_torch.shardmap_engine import build_shardmap_run

    if group is None:
        return None
    d = dist.get_world_size(group)
    n = circuit.num_qubits
    local = (1 << n) // d
    prog = build_shardmap_run(circuit, group, rdtype, device="cpu", **kw)
    full = (ap.initial_state(n, rdtype, 0, "cpu") if psi0 is None
            else ap.from_complex(psi0, rdtype, "cpu"))
    me = dist.get_rank(group)
    state = prog(full[:, me * local:(me + 1) * local].contiguous())
    return _full(state, group), prog.exchanges, prog.planned_exchanges, prog.engines


def shardmap_cases(rank: int, world: int) -> dict:
    """The executor at D = 2, 4 and 8 (sub-groups of the 8-rank world)."""
    import tpu_qsim_torch as tq
    from tpu_qsim_torch.kernels.gridsweeps import GridParams

    groups = {}
    for d in (*EXEC_WORLDS, 3):
        g = dist.new_group(list(range(d)))
        groups[d] = g if rank < d else None
    n = N_EXEC
    f64 = np.float64
    circuits = {
        "ghz": (tq.ghz_circuit(n), None),
        **{f"random{s}": (tq.random_circuit(n, 80, seed=s), None) for s in range(3)},
        "device_bits": (device_bits_circuit(n), random_state(n)),
    }
    cases = []
    for d in EXEC_WORLDS:
        for name, (c, psi0) in circuits.items():
            cases.append((f"{name}@{d}", lambda c=c, d=d, p=psi0: _exec(c, groups[d], rank, f64, p)))
        cases.append((f"kernels@{d}", lambda d=d: _exec(
            tq.random_circuit(n, 50, seed=4), groups[d], rank, np.float32,
            local_engine="kernels")))
    # float64 shards take the torch engine (the kernels are float32)
    cases.append(("kernels_f64@8", lambda: _exec(
        tq.random_circuit(n, 40, seed=6), groups[8], rank, f64, local_engine="kernels")))
    for nq, depth in ((16, 60), (18, 100)):
        cases.append((f"perf_notes_{nq}q", lambda nq=nq, depth=depth: _exec(
            tq.random_circuit(nq, depth, seed=11), groups[8], rank, f64)))
    for nq, blk, amax in ((16, 10, 2), (17, 10, 3)):
        cases.append((f"grid_params_{nq}q", lambda nq=nq, blk=blk, amax=amax: _exec(
            tq.random_circuit(nq, 50, seed=4), groups[8], rank, np.float32,
            local_engine="kernels", grid_params=GridParams(blk, amax))))
    cases += [
        ("refuse_three", lambda: _refusal(lambda: _exec(
            tq.ghz_circuit(n), groups[3], rank, f64))),
        ("refuse_local_bits", lambda: _refusal(lambda: _exec(
            tq.ghz_circuit(12), groups[8], rank, f64))),
        ("refuse_engine", lambda: _refusal(lambda: _exec(
            tq.ghz_circuit(n), groups[2], rank, f64, local_engine="bogus"))),
    ]
    return _cases(rank, cases)


def _refusal(fn):
    """("raised", type name, message) for a ValueError or RuntimeError
    (a refusal), ("no error",) otherwise."""
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return ("raised", type(e).__name__, str(e))
    return ("no error",)


def parallel_cases(rank: int, world: int, tmp: str, from_jax: np.ndarray) -> dict:
    """The sharded simulators on the 8-rank world (float64 unless named);
    ``from_jax`` is a JAX sharded simulator's gathered 16-qubit state."""
    import tpu_qsim_torch as tq
    import tpu_qsim_torch.parallel as par
    from tpu_qsim_torch.kernels.gridsweeps import GridParams

    cfg = tq.SimConfig(dtype="complex128")
    mesh = par.make_mesh(("tp",))
    mesh_2x4 = par.make_mesh(("dp", "tp"), (2, 4))

    def sharded(n, config=cfg, **kw):
        return par.ShardedStateVectorSimulator(n, mesh, config=config, device="cpu", **kw)

    def state_of(n, circuit, **kw):
        sim = sharded(n, **kw).run(circuit)
        return sim.engine, sim.get_state(), tuple(sim.state_planes.shape)

    def auto_large():
        old = par.GSPMD_REPLICATION_LIMIT_BYTES
        par.GSPMD_REPLICATION_LIMIT_BYTES = 1 << 10
        try:
            return state_of(16, tq.random_circuit(16, 40, seed=3))
        finally:
            par.GSPMD_REPLICATION_LIMIT_BYTES = old

    def allow_replication():
        old = par.GSPMD_REPLICATION_LIMIT_BYTES
        par.GSPMD_REPLICATION_LIMIT_BYTES = 1 << 10
        try:
            return sharded(10, engine="gspmd", allow_replication=True).engine
        finally:
            par.GSPMD_REPLICATION_LIMIT_BYTES = old

    def measure():
        sim = sharded(10, seed=3).run(tq.ghz_circuit(10))
        s = sim.sample(200).numpy()
        return s, [sim.measure_qubit(q) for q in range(10)]

    def readouts():
        n = 16
        sim = sharded(n, engine="collective", seed=5).run(tq.ghz_circuit(n))
        full = sim.get_state()
        out = {
            "total_probability": sim.total_probability(),
            "probabilities": sim.get_probabilities(),
            "qubit_probability": [sim.qubit_probability(q) for q in (0, 12, 13, 15)],
            "expectation": {p: sim.expectation_pauli(p) for p in PAULIS},
            "rdm": sim.reduced_density_matrix([0, 15]),
            "entropy": sim.entanglement_entropy([14, 15]),
            "fidelity": sim.fidelity_with(np.stack([full.real, full.imag])),
            "histogram": sim.histogram(300),
        }
        path = f"{tmp}/sharded_ghz.npz"
        sim.save_state(path)
        other = sharded(n, engine="collective")
        other.load_state(path)
        out["loaded"] = other.get_state()
        out["peer_fidelity"] = sim.fidelity_with(other)
        out["measure"] = [sim.measure_qubit(15), sim.measure_qubit(3)]
        out["after_measure"] = sim.get_state()
        return out

    def random_state_readouts():
        n = 16
        sim = sharded(n, engine="collective")
        sim.set_state(random_state(n, 7))
        sim.run(tq.random_circuit(n, 30, seed=8))
        return {p: sim.expectation_pauli(p) for p in PAULIS} | {
            "qubit_probability": [sim.qubit_probability(q) for q in range(n)],
            "state": sim.get_state()}

    def matrix_and_params():
        n = 16
        u = np.linalg.qr(np.random.default_rng(3).standard_normal((4, 4))
                         + 1j * np.random.default_rng(4).standard_normal((4, 4)))[0]
        sim = sharded(n, engine="collective").run(tq.ghz_circuit(n))
        sim.apply_matrix(u, (15, 2))
        sim.apply_gate("ry", 14, param=0.3)
        after_matrix = sim.get_state()
        ansatz = tq.hardware_efficient_ansatz(n, 1)
        params = np.linspace(0.1, 1.0, len(ansatz.params()))
        sim.run_parameterized(ansatz, params)
        return after_matrix, sim.get_state(), u, params

    def carried_from_jax():
        sim = sharded(16, engine="collective")
        sim.set_state(from_jax)
        return sim.run(tq.random_circuit(16, 20, seed=10)).get_state()

    def sweeps_engine(n, blk, amax):
        c = tq.random_circuit(n, 50, seed=4)
        return state_of(n, c, engine="sweeps", config=tq.SimConfig(),
                        grid_params=GridParams(blk, amax))

    def batched_same_seed():
        nm = tq.NoiseModel().add_depolarizing(0.1)
        a = par.ShardedBatchedSimulator(3, 16, nm, config=cfg, seed=7, device="cpu")
        a.run(tq.ghz_circuit(3))
        return a.get_state(), a.measure_qubit(1), a.get_state()

    def dp_tp():
        nm = tq.NoiseModel().add_bit_flip(0.05)
        sim = par.ShardedBatchedSimulator(7, 8, nm, mesh=mesh_2x4, tp_axis="tp",
                                          config=cfg, seed=1, device="cpu")
        sim.run(tq.random_circuit(7, 30, seed=4))
        return {
            "shape": tuple(sim.state_planes.shape),
            "total_probability": sim.total_probability(),
            "histogram": sim.histogram(50),
            "state": sim.get_state(),
            "probabilities": sim.average_probabilities(),
            "rdm": sim.reduced_density_matrix([0, 6]),
            "expectation": sim.expectation_pauli("ZIIIIIX"),
        }

    cases = [
        ("ghz10", lambda: state_of(10, tq.ghz_circuit(10))),
        *[(f"random8_{s}", lambda s=s: state_of(8, tq.random_circuit(8, 60, seed=s)))
          for s in range(3)],
        ("auto_large", auto_large),
        ("allow_replication", allow_replication),
        ("indivisible", lambda: _refusal(lambda: sharded(2))),
        ("batch_indivisible", lambda: _refusal(
            lambda: par.ShardedBatchedSimulator(3, 9, None, config=cfg, device="cpu"))),
        # no card here: device=None raises instead of running on the CPU
        ("no_card", lambda: _refusal(
            lambda: par.ShardedStateVectorSimulator(16, mesh, config=cfg))),
        ("no_card_batched", lambda: _refusal(
            lambda: par.ShardedBatchedSimulator(3, 8, None, config=cfg))),
        ("measure", measure),
        ("readouts", readouts),
        ("random_state_readouts", random_state_readouts),
        ("matrix_and_params", matrix_and_params),
        ("carried_from_jax", carried_from_jax),
        ("sweeps_16q", lambda: sweeps_engine(16, 10, 2)),
        ("sweeps_17q", lambda: sweeps_engine(17, 10, 3)),
        ("batched_same_seed", batched_same_seed),
        ("dp_tp", dp_tp),
    ]
    return _cases(rank, cases)


# Pauli strings for the sharded readouts at 16 qubits (3 device bits): Z on
# device bits (a sign per shard), X and Y on local bits, and X / Y on device
# bits (gathered)
PAULIS = (
    "Z" + "I" * 15, "ZZ" + "I" * 14, "Z" + "I" * 14 + "Z", "X" * 16,
    "IIIIIIIIIIIIIXYZ", "YIIIIIIIIIIIIIIY", "IXIIIIIIIIIIIIII", "ZZZ",
)


def cuda_sharded_case(rank: int, world: int, n: int) -> dict:
    """A sharded run on the card with the kernels on each shard, against the
    single-card run of the same circuit (one rank per process, all on
    device 0)."""
    import tpu_qsim_torch as tq
    from tpu_qsim_torch.kernels import LAUNCHES, reset_launches
    from tpu_qsim_torch.parallel import ShardedStateVectorSimulator

    c = tq.random_circuit(n, 100, seed=42)
    sim = ShardedStateVectorSimulator(n, engine="sweeps")
    reset_launches()
    sim.run(c)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    _, prog = sim.compiled_run(c)
    ref = tq.StateVectorSimulator(n).run(c).state_planes
    lo = rank * sim.local_dim
    d = (sim.state_planes.double() - ref[:, lo:lo + sim.local_dim].double())
    err = float(torch.sqrt(d[0] ** 2 + d[1] ** 2).max())
    return {"launches": launches, "engines": prog.engines, "exchanges": prog.exchanges,
            "planned": prog.planned_exchanges, "max_abs_err": err}
