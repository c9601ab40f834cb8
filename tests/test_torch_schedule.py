"""The port's segment planner refuses, within a second, a circuit whose ready
gates fit no empty segment (it used to spin forever there, as the JAX
planner still does).

Each case plans in a child interpreter under a time limit, so a spin fails
the test instead of hanging the suite; the child times the call itself and
the test requires it under one second.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import tpu_qsim_torch as tq
from tpu_qsim_torch.schedule import plan_segments

ROOT = Path(__file__).resolve().parent.parent

CASES = {
    # a 4-qubit gate with two qubits above the block and one free slot
    "wide4": ("c = tq.Circuit(12).h(0).add(dense(4), 8, 9, 10, 11)", 10, 7, None,
              "sched_dense4 on qubits (8, 9, 10, 11)"),
    # a 5-qubit gate on the high qubits, three relocation slots
    "wide5": ("c = tq.Circuit(13).add(dense(5), 8, 9, 10, 11, 12)", 10, 7, None,
              "sched_dense5 on qubits (8, 9, 10, 11, 12)"),
    # stage_min: the first segment takes no relocation, and the first ready
    # gate needs one
    "staged": ("c = tq.Circuit(12).cnot(11, 10).h(11)", 10, 7, 8,
               "cnot on qubits (11, 10)"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_unfittable_gate_raises_within_a_second(name):
    build, local_bits, swap_min, stage_min, gate = CASES[name]
    code = textwrap.dedent(
        f"""
        import time
        import numpy as np
        import tpu_qsim_torch as tq
        from tpu_qsim_torch.gates import GATE_ARITY, register_gate
        from tpu_qsim_torch.schedule import plan_segments

        def dense(k):
            name = f"sched_dense{{k}}"
            if name not in GATE_ARITY:
                m = np.random.default_rng(k).standard_normal((1 << k, 1 << k))
                register_gate(name, np.linalg.qr(m)[0].astype(complex))
            return name

        {build}
        t0 = time.perf_counter()
        try:
            plan_segments(c, {local_bits}, {swap_min}, {stage_min})
        except ValueError as e:
            print("raised", time.perf_counter() - t0)
            print(e)
        else:
            print("planned")
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=60,
    )
    assert proc.returncode == 0, proc.stderr
    first, message = proc.stdout.splitlines()[:2]
    verdict, seconds = first.split()
    assert verdict == "raised", proc.stdout
    assert float(seconds) < 1.0
    assert f"gate {gate} fits no empty segment" in message
    assert f"local_bits - swap_min = {local_bits - swap_min}" in message


def test_fitting_circuits_still_plan():
    """Circuits that fit still plan: every gate lands in a segment, on
    local bits."""
    c = tq.random_circuit(14, 60, seed=5)
    segments, restore = plan_segments(c, 10)
    assert sum(len(s.gates) for s in segments) == len(c.gates)
    assert all(max(g.qubits) < 10 for s in segments for g in s.gates)
    assert sorted(restore) == list(range(14))
