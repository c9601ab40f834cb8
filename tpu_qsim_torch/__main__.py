"""Demo: ``python -m tpu_qsim_torch [--device cpu]``.

The port of ``tpu_qsim/__main__.py``: prints the device, the Bell state's
amplitudes and probabilities, the 4-qubit GHZ probabilities, a 1000-shot
Bell histogram, a noisy GHZ-3 trajectory batch and a density matrix's trace
and purity. It runs on the CUDA card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse

import numpy as np


def fmt_basis(i: int, n: int) -> str:
    return "|" + format(i, f"0{n}b") + ">"


def main(argv: list[str] | None = None) -> int:
    import torch

    import tpu_qsim_torch as q
    from tpu_qsim_torch import apply as ap

    parser = argparse.ArgumentParser(prog="python -m tpu_qsim_torch")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    device = ap.resolve_device(parser.parse_args(argv).device)

    print("=" * 60)
    print("tpu_qsim_torch demo")
    print("=" * 60)
    if device.type == "cuda":
        name = torch.cuda.get_device_name(device)
        count = torch.cuda.device_count()
    else:
        name, count = str(device), 1
    print(f"\nDevice: {name} ({device.type}), {count} device(s) visible")

    print("\n-- Bell state: h(0).cnot(0,1) --")
    sim = q.StateVectorSimulator(2, seed=1234, device=device)
    sim.run(q.bell_circuit())
    state = sim.get_state()
    probs = sim.get_probabilities()
    for i in range(4):
        print(f"  {fmt_basis(i, 2)}  amp = {state[i]:+.4f}   "
              f"P = {probs[i]:.4f}")

    print("\n-- GHZ-4 probabilities --")
    sim4 = q.StateVectorSimulator(4, seed=1, device=device)
    sim4.run(q.ghz_circuit(4))
    p4 = sim4.get_probabilities()
    for i in np.nonzero(p4 > 1e-6)[0]:
        print(f"  {fmt_basis(int(i), 4)}  P = {p4[i]:.4f}")

    print("\n-- 1000-shot Bell sampling --")
    hist = sim.histogram(1000)
    for idx, count in sorted(hist.items()):
        bar = "#" * (count // 20)
        print(f"  {fmt_basis(idx, 2)}  {count:4d}  {bar}")

    print("\n-- Noisy GHZ-3 (depolarizing 1%, 500 trajectories) --")
    nm = q.NoiseModel().add_depolarizing(0.01)
    bs = q.BatchedSimulator(3, 500, nm, seed=7, device=device)
    bs.run(q.ghz_circuit(3))
    avg = bs.average_probabilities()
    for i in np.nonzero(avg > 5e-3)[0]:
        print(f"  {fmt_basis(int(i), 3)}  P = {avg[i]:.4f}")

    print("\n-- Exact density matrix: Bell + 5% phase damping --")
    dm = q.DensityMatrixSimulator(
        2, q.NoiseModel().add_phase_damping(0.05), device=device
    )
    dm.run(q.bell_circuit())
    print(f"  trace  = {dm.trace():.6f}")
    print(f"  purity = {dm.purity():.6f}")

    print("\ndone.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
