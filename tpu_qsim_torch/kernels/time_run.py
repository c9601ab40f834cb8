"""Time ``StateVectorSimulator.run`` on circuits with one wide dense gate.

    python -m tpu_qsim_torch.kernels.time_run

Each circuit is ``random_circuit(n, 40, seed=42)``, then a random k-qubit
unitary (seeded) on qubits lo..lo+k-1, then ``random_circuit(n, 40,
seed=43)``. For each: plan it as ``run`` does, run it once from |0..0> and
print the engine, the kernels it launched and a fingerprint of the state
(each plane summed against the weights cos(0.7 i), so two checkouts can be
compared), then the median of 7 CUDA-event timings of the planned function
after a warm-up. The module uses only the package's public entry points, so
the same file times an older checkout of the package too. Needs a CUDA card.
"""

from __future__ import annotations

import json
import statistics
import subprocess

import numpy as np
import torch

from tpu_qsim_torch import StateVectorSimulator, random_circuit
from tpu_qsim_torch.gates import GATE_ARITY, register_gate
from tpu_qsim_torch.kernels import LAUNCHES, reset_launches

# name -> (qubits, core width, lowest core qubit)
CIRCUITS = {
    "22q_dense6_on_8": (22, 6, 8),      # the grid refuses it: sweeps or segments
    "26q_dense6_on_0": (26, 6, 0),      # grid sweep, the wide instance
}


def wide_circuit(n: int, k: int, lo: int):
    name = f"time_run_dense{k}"
    if name not in GATE_ARITY:
        rng = np.random.default_rng(k)
        m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
        register_gate(name, np.linalg.qr(m)[0])
    c = random_circuit(n, 40, seed=42)
    c.add(name, *range(lo, lo + k))
    for g in random_circuit(n, 40, seed=43).gates:
        c.append(g)
    return c


def _times_ms(fn, reps: int) -> list[float]:
    fn()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("time_run needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=10, check=True,
    ).stdout.strip()
    print(f"card: {card}", flush=True)
    for name in CIRCUITS:
        n, k, lo = CIRCUITS[name]
        c = wide_circuit(n, k, lo)
        sim = StateVectorSimulator(n)
        reset_launches()
        sim.run(c)
        torch.cuda.synchronize()
        launches = dict(LAUNCHES)
        planes = sim.state_planes
        w = torch.cos(0.7 * torch.arange(planes.shape[1], device=planes.device,
                                         dtype=torch.float64))
        probe = (planes.double() @ w).tolist()
        _, fn = sim.compiled_run(c)
        state = sim.state_planes

        def step():
            nonlocal state
            state = fn(state)

        times = _times_ms(step, 7)
        print(json.dumps({"circuit": name, "card": card, "engine": sim.engine,
                          "launches": launches, "ms": statistics.median(times),
                          "all_ms": times, "probe": probe}), flush=True)
        del sim, state, planes, w


if __name__ == "__main__":
    main()
