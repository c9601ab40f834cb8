"""The port's floor certificate (``tpu_qsim_torch/kernels/floor.py``) on the
CPU, against the JAX package's ``benchmarks/benchmark_floor.py``.

``run_vpu`` runs as written, in interpret mode: its ``pallas_call`` gets
``interpret=True``, ``time_chained`` calls the kernel once and keeps its
output, and ``tpu_qsim.apply.initial_state`` returns seeded random
unit-norm planes; the port's plain rotation chain on the same planes and
angles must agree within 1e-6 (two float32 chains of 64 steps, rounded in
the same order). A numpy mirror of ``csrc/rotation_chain.cu``'s (CTA,
thread, register) -> amplitude map pins the kernel's indexing; the
decompose variants, the scale flavors' descriptor flags, the census and the
rate arithmetic are checked against closed forms.
"""

import functools
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import tpu_qsim.apply as jap
from benchmarks import benchmark_floor
from tpu_qsim_torch.circuit import random_circuit
from tpu_qsim_torch.kernels import floor
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels.fused_circuit import BlockLayout, min_flops

from test_torch_gridsweeps import emulate_sweep

ROOT = Path(__file__).resolve().parent.parent


def _unit_planes(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    return np.stack([psi.real, psi.imag]).astype(np.float32)


@pytest.mark.parametrize("n", [16, 20])
def test_plain_chain_matches_jax_run_vpu(monkeypatch, n):
    outputs = []
    planes = _unit_planes(n, seed=n)

    def kept(call, xv, reps=3, trials=5):
        outputs.append(np.asarray(call(xv)).reshape(2, 1 << n))
        return float(len(outputs))

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
    monkeypatch.setattr(benchmark_floor, "time_chained", kept)
    monkeypatch.setattr(jap, "initial_state", lambda m, dtype: jax.numpy.asarray(planes))
    ks = (16, 64)
    benchmark_floor.run_vpu(n, ks=ks)
    assert len(outputs) == len(ks)
    for k, want in zip(ks, outputs):
        angles = [0.1 + 0.001 * i for i in range(k)]    # run_vpu's angles
        np.testing.assert_array_equal(floor.chain_angles(k), angles)
        got = floor.rotation_chain_plain(torch.from_numpy(planes), floor.chain_angles(k))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        # the wrapper on a CPU tensor: the plain version, in place
        x = torch.from_numpy(planes.copy())
        assert floor.rotation_chain(x, floor.chain_angles(k)) is x
        np.testing.assert_array_equal(x.numpy(), got.numpy())


def emulate_chain_slots(layout: BlockLayout) -> np.ndarray:
    """Global index of each (CTA, thread, value) as rotation_chain.cu
    computes it: the CTA's share from blockIdx over the inactive bits, then
    the thread's first slot and each register bit's offset, ORed."""
    n_inact = len(layout.inactive)
    threads = 1 << (layout.kbits - tgs.REG_BITS)

    def global_index(slot: np.ndarray) -> np.ndarray:
        g = slot & ((1 << layout.blk_bits) - 1)
        hi = slot >> layout.blk_bits
        for j, p in enumerate(layout.active):
            g = g | (((hi >> j) & 1) << p)
        return g

    cta = np.arange(1 << n_inact, dtype=np.int64)
    cta_g = np.zeros_like(cta)
    for b, p in enumerate(layout.inactive):
        cta_g |= ((cta >> b) & 1) << p
    t = np.arange(threads, dtype=np.int64)
    lane, warp = t & 31, t >> 5
    gt = cta_g[:, None] | global_index(lane | warp << (tgs.LANE_BITS + tgs.REG_BITS))[None, :]
    gm = [int(global_index(np.int64(1 << (tgs.LANE_BITS + b)))) for b in range(tgs.REG_BITS)]
    off = np.array([sum(gm[b] for b in range(tgs.REG_BITS) if (v >> b) & 1)
                    for v in range(1 << tgs.REG_BITS)], dtype=np.int64)
    return gt[:, :, None] | off[None, None, :]


@pytest.mark.parametrize("n", [9, 10, 11, 12, 13, 16, 20])
def test_kernel_index_map_covers_every_amplitude_once(n):
    layout = floor.chain_layout(n)
    a = min(tgs.A_MAX, n - tgs.BLK_BITS)
    assert layout.blk_bits == tgs.BLK_BITS and layout.active == tuple(range(n - a, n))
    slots = emulate_chain_slots(layout)
    assert slots.shape == (1 << (n - layout.kbits), 1 << (layout.kbits - 4), 16)
    np.testing.assert_array_equal(np.sort(slots.reshape(-1)), np.arange(1 << n))
    # a CTA holds its block: bits 0-6 and the top a bits vary, the rest fixed
    inact_mask = sum(1 << p for p in layout.inactive)
    for cta in (0, slots.shape[0] - 1):
        assert len(np.unique(slots[cta] & inact_mask)) == 1
    # a warp's loads of one value are 32 consecutive amplitudes (128 bytes)
    np.testing.assert_array_equal(slots[0, :32, 0], slots[0, 0, 0] + np.arange(32))


def test_chain_layout_refuses_blocks_below_one_warp():
    with pytest.raises(ValueError, match="at least"):
        floor.chain_layout(8)


@pytest.mark.parametrize("n", [12, 14])
def test_decompose_variants(n):
    progs = floor.decompose_programs(n)
    x = torch.from_numpy(_unit_planes(n, seed=5))
    prod = tgs.GridSweepProgram(random_circuit(n, floor.NUM_GATES, seed=floor.SEED))
    full = progs["full"].run_plain(x.clone())
    np.testing.assert_array_equal(full.numpy(), prod.run_plain(x.clone()).numpy())
    # the zero-gate variant streams the same blocks and changes nothing
    assert progs["zero"].layouts == progs["full"].layouts
    assert all(int(t.ints[0]) == 0 for t in progs["zero"].tables)
    np.testing.assert_array_equal(progs["zero"].run_plain(x.clone()).numpy(), x.numpy())
    re, im = x[0].numpy().astype(np.float64), x[1].numpy().astype(np.float64)
    for table in progs["zero"].tables:
        emulate_sweep(re, im, table)                  # the kernel's reading of it
    np.testing.assert_array_equal(re, x[0].numpy())
    np.testing.assert_array_equal(im, x[1].numpy())
    # the sweeps one after another are the full run
    y = x.clone()
    for p in progs["sweeps"]:
        assert p.num_sweeps == 1
        y = p.run_plain(y)
    np.testing.assert_array_equal(y.numpy(), full.numpy())
    assert sum(len(s.gates) for s in progs["plan"]) == sum(len(g) for g in prod.sweep_gates)


@pytest.mark.parametrize("one_launch", [True, False])
def test_sweeps_streaming_variant(one_launch, monkeypatch):
    # --sweeps: each launch's stages with their ops removed keep the
    # launch's stage count and tile layouts, and the kernel's reading of
    # them (the sweeps mirror) changes nothing; the CPU run times the plain
    # version of every launch
    from tpu_qsim_torch.circuit import Gate
    from tpu_qsim_torch.kernels import sweeps as ts

    from test_torch_dense_op import dense_unitary
    from test_torch_sweeps import emulate_sweep as emulate_sweeps_table

    # the 6-qubit core held in a unit stage (the route's width sends it to
    # the dense pass): this case is a unit launch's streaming variant
    monkeypatch.setattr(ts, "MIN_UNIT_PASS_CORE", 7)
    n, params = 12, ts.SweepParams(k_bits=2, rb_bits=2)
    c = random_circuit(n, 30, seed=1)
    u = dense_unitary(6, np.random.default_rng(6)).tobytes()
    c.append(Gate("floor_sweeps_core6", tuple(range(4, 10)), matrix_bytes=u))
    c.extend(random_circuit(n, 30, seed=2).gates)
    prog = ts.SweepProgram(c, params, _one_launch=one_launch)
    x = _unit_planes(n, seed=7)
    count = 0
    for launches, lay, bits in zip(prog.launches, prog.layouts, prog.tile_bits):
        for ln in launches:
            zero = ts.streaming_stages(ln.stages, lay, bits)
            assert [st.kind for st in zero] == ["tile"] * len(ln.stages)
            assert all(not st.gates for st in zero)
            for a, b in zip(ln.stages, zero):
                if a.kind == "tile":
                    assert (a.layout, a.outside) == (b.layout, b.outside)
            table = ts.sweep_table(zero, lay, bits)
            assert int(table.ints[0]) == len(ln.stages) and table.max_core == 0
            re, im = x[0].astype(np.float64), x[1].astype(np.float64)
            emulate_sweeps_table(re, im, table)
            np.testing.assert_array_equal(re, x[0])
            np.testing.assert_array_equal(im, x[1])
            count += 1
    r = floor.sweeps_decompose(device="cpu", params=params, circuit=c, one_launch=one_launch)
    assert [(row["sweep"], row["launch"], row["route"]) for row in r["launches"]] == [
        (i, j, ln.route) for i, launches in enumerate(prog.launches)
        for j, ln in enumerate(launches)]
    assert len(r["launches"]) == count
    assert ("unit" in {row["route"] for row in r["launches"]}) != one_launch


def test_program_plan_keyword():
    c = random_circuit(12, 40, seed=3)
    prog = tgs.GridSweepProgram(c)
    plan = [tgs.GridSweep(set(a), list(g)) for a, g in zip(prog.active_sets, prog.sweep_gates)]
    same = tgs.GridSweepProgram(c, plan=plan)
    assert same.params == prog.params and same.layouts == prog.layouts
    assert [t.ints.tolist() for t in same.tables] == [t.ints.tolist() for t in prog.tables]
    with pytest.raises(ValueError, match="active bits"):
        tgs.GridSweepProgram(c, plan=[tgs.GridSweep({3})])
    with pytest.raises(ValueError, match="active bits"):
        tgs.GridSweepProgram(c, plan=[tgs.GridSweep(set(range(7, 12)) | {6})])


@pytest.mark.parametrize("flavor", floor.SCALE_FLAVORS)
def test_scale_flavor_flags(flavor):
    n = 14
    for k in floor.SCALE_KS:
        prog = floor.scale_program(n, flavor, k)         # checks the flags itself
        (table,) = prog.tables
        assert int(table.ints[0]) == k                    # no remap, nothing merged
        assert prog.layouts[0].active == tuple(range(7, 12))
    d = floor.descriptors(table)
    assert (d[:, 0] & (tgs.D_REG | tgs.D_SWAP) == tgs.D_REG | tgs.D_SWAP).all()
    assert bool((d[:, 0] & tgs.D_LANE).any()) == (flavor == "lane")
    assert bool(d[:, 4].any()) == (flavor == "extctrl")
    for other in floor.SCALE_FLAVORS:
        if other != flavor:
            with pytest.raises(ValueError, match="descriptor"):
                floor.check_flavor(prog, other)
    # the scale program's gates run as the kernel reads them
    x = torch.from_numpy(_unit_planes(n, seed=9))
    re, im = x[0].numpy().astype(np.float64), x[1].numpy().astype(np.float64)
    emulate_sweep(re, im, table)
    want = prog.run_plain(x.clone()).numpy()
    np.testing.assert_allclose(re, want[0], atol=1e-7, rtol=0)
    np.testing.assert_allclose(im, want[1], atol=1e-7, rtol=0)


def test_scale_refuses_small_states():
    with pytest.raises(ValueError, match="n >= 14"):
        floor.scale_circuit(13, "extctrl", 8)
    with pytest.raises(ValueError, match="flavor"):
        floor.scale_circuit(20, "rowctrl", 8)


CENSUS = {   # per amplitude: FMUL, FFMA, SEL, SHFL; share of CTAs; flops
    "reg": (0, 0, 2, 0, 1.0, 0),
    "lane": (0, 0, 2, 2, 1.0, 0),
    "extctrl": (0, 0, 2, 0, 0.5, 0),
    "dense1": (0, 8, 0, 0, 1.0, 16),
    "dense1_lane": (0, 8, 0, 2, 1.0, 16),
    "diag1": (2, 2, 0, 0, 1.0, 6),
}


def test_census_closed_forms():
    classes = floor.census_classes(16)
    assert set(classes) == set(CENSUS)
    for name, (fmul, ffma, sel, shfl, share, flops) in CENSUS.items():
        c = classes[name]["census"]
        assert (c["FMUL"], c["FFMA"], c["SEL"], c["SHFL"], c["LDS"], c["STS"]) == (
            fmul, ffma, sel, shfl, 0, 0), name
        assert classes[name]["share"] == share
        assert floor.census_flops(c) == flops
        # min_flops: X cores need none, a diagonal's 6 flops are all needed,
        # a general 1-qubit core needs 14 (two of the 16 add a zero)
        assert classes[name]["min_flops"] == {0: 0, 6: 6, 16: 14}[flops]
    # a remap: each value to shared memory and back, both planes
    remap = np.zeros(tgs.DESC_WORDS, np.int32)
    remap[0] = tgs.D_REMAP
    assert floor.op_census(remap) == {"FMUL": 0, "FFMA": 0, "SEL": 0, "SHFL": 0, "LDS": 2, "STS": 2}
    # a shared-memory op (a 2-qubit dense core) is not priced
    assert floor.op_census(np.zeros(tgs.DESC_WORDS, np.int32)) is None
    assert min_flops(np.array([[0, 1], [1, 0]]), diagonal=False) == 0


def test_floor_arithmetic():
    rate = 33.5e12
    amps = 1 << 28
    c = floor.op_census(floor.census_classes(28)["dense1"]["descriptor"])
    assert floor.op_floor_s(c, amps, rate) == pytest.approx(8 * amps / rate)   # float32 issue
    c = floor.op_census(floor.census_classes(28)["lane"]["descriptor"])
    assert floor.op_floor_s(c, amps, rate) == pytest.approx(2 * amps / (rate / 4))  # shuffles
    # selects: half the float32 rate, or (the model's other bound) the full rate
    c = floor.op_census(floor.census_classes(28)["reg"]["descriptor"])
    assert floor.op_floor_s(c, amps, rate) == pytest.approx(4 * amps / rate)
    assert floor.op_floor_s(c, amps, rate, "alu_fast") == pytest.approx(2 * amps / rate)
    r = floor.plan_only(14)
    assert 0 < r["plan_ops_fast_sel_ms"] < r["plan_ops_ms"]
    for c in r["classes"].values():
        assert c["floor_fast_sel_us"] <= c["floor_us"]
    assert r["rate_source"].startswith("data sheet") and r["tinstr_per_s"] == 33.5
    assert floor.plan_only(14, 30.0)["rate_source"].startswith("measured")
    assert r["plan_bytes_ms"] == pytest.approx(len(r["plan"]) * 16 * (1 << 14) / 3.35e12 * 1e3)


def test_loop_census_adds_the_decode():
    # the loop model: the arithmetic census plus each class's decode over a
    # thread's 16 amplitudes, priced with the selects
    rate, amps = 33.5e12, 1 << 28
    decode = {"diag": 16, "swap": 32, "swap_lane": 48, "dense1": 64, "dense1_lane": 80}
    for name, (key, per_amp) in {"reg": ("swap", 2), "lane": ("swap_lane", 3),
                                 "extctrl": ("swap", 2), "dense1": ("dense1", 4),
                                 "dense1_lane": ("dense1_lane", 5), "diag1": ("diag", 1)}.items():
        d = floor.census_classes(16)[name]["descriptor"]
        assert floor.decode_class(d) == key
        c = floor.loop_census(d, decode)
        assert c == {**floor.op_census(d), "INT": per_amp}, name
        assert c["INT"] == decode[key] / 16
    c = floor.loop_census(floor.census_classes(28)["reg"]["descriptor"], decode)
    assert floor.op_floor_s(c, amps, rate) == pytest.approx((2 + 2) * amps / (rate / 2))
    assert floor.op_floor_s(c, amps, rate, "alu_fast") == pytest.approx(4 * amps / rate)
    remap = np.zeros(tgs.DESC_WORDS, np.int32)
    remap[0] = tgs.D_REMAP
    assert floor.decode_class(remap) is None and floor.loop_census(remap)["INT"] == 0
    assert floor.loop_census(np.zeros(tgs.DESC_WORDS, np.int32)) is None
    assert set(floor.DECODE) == set(decode)


def test_plan_bound_and_loop_model():
    # the bound sums each sweep's larger of bytes and ops floor; the loop
    # model the same with the decode, which only adds
    r = floor.plan_only(14)
    for key, ops in (("max_bytes_ops_ms", "ops"), ("loop_model_ms", "loop")):
        assert r[key] == pytest.approx(
            [sum(max(s["bytes_ms"], s[f"{ops}_fast_sel_ms"]) for s in r["plan"]),
             sum(max(s["bytes_ms"], s[f"{ops}_ms"]) for s in r["plan"])])
    assert r["plan_bytes_ms"] <= r["max_bytes_ops_ms"][0] <= r["max_bytes_ops_ms"][1]
    assert r["plan_ops_ms"] < r["plan_loop_ms"] and r["plan_ops_fast_sel_ms"] < r["plan_loop_fast_sel_ms"]
    for c in r["classes"].values():
        assert c["floor_us"] <= c["loop_us"] and c["decode"] > 0
    bare = floor.plan_only(14, decode={k: 0 for k in floor.DECODE})
    assert bare["plan_loop_ms"] == pytest.approx(bare["plan_ops_ms"])
    assert bare["loop_model_ms"] == pytest.approx(bare["max_bytes_ops_ms"])


@pytest.mark.parametrize("k", [1, 17, 256])
def test_folded_rotation_is_the_chain(k):
    # chip_smoke.py times one torch.matmul of it as the chain's library call
    import chip_smoke

    x = torch.from_numpy(_unit_planes(16, seed=k))
    angles = floor.chain_angles(k)
    rot = torch.from_numpy(chip_smoke.folded_rotation(angles))
    want = floor.rotation_chain_plain(x, angles)
    np.testing.assert_allclose(torch.matmul(rot, x).numpy(), want.numpy(), atol=1e-7, rtol=0)


def test_rate_counts_complex_amplitudes_not_plane_elements():
    n, ks, ms = 20, (16, 64, 256), (1.0, 2.0, 6.0)
    rates = floor.chain_rates(n, ks, ms)
    assert [(r["from"], r["to"]) for r in rates] == [(16, 64), (64, 256)]
    # by hand: 6 flops and 4 instructions per complex amplitude per step
    assert rates[0]["tflop_per_s"] * 1e12 == pytest.approx(6 * 2**20 * 48 / 1e-3)
    assert rates[1]["tinstr_per_s"] * 1e12 == pytest.approx(4 * 2**20 * 192 / 4e-3)
    assert rates[1]["us_per_step"] == pytest.approx(4e3 / 192)
    # run_vpu's arithmetic (benchmark_floor.py:376-378) counts both planes'
    # elements at 6 flops each: twice the rate delivered
    jax_rate = 6.0 * (2 * (1 << n)) * 48 / 1e-3
    assert jax_rate == pytest.approx(2 * rates[0]["tflop_per_s"] * 1e12)


def test_chain_bounds_at_28_qubits():
    # 132 SMs x 128 lanes at 1.98 GHz: 33.45 T float32 instructions/s
    rate = floor.peak_instr_per_s(132, 1980)
    assert rate == pytest.approx(33.45e12, rel=1e-3)
    b = [floor.chain_bound(28, k, rate) for k in floor.VPU_KS]
    assert [round(x["issue_ms"], 2) for x in b] == [0.51, 2.05, 8.22]
    assert all(round(x["bytes_ms"], 3) == 1.282 for x in b)
    assert b[0]["bound_by"] == "bytes" and b[2]["bound_by"] == "operations"
    assert b[2]["bound_ms"] == pytest.approx(6 * 256 * 2**28 / 67e12 * 1e3)


def test_module_runs_on_the_cpu():
    def run(*args):
        proc = subprocess.run([sys.executable, "-m", "tpu_qsim_torch.kernels.floor", *args],
                              cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    out = run("--device", "cpu", "--vpu", "12", "--decompose", "12", "--scale", "14",
              "--flavor", "extctrl")
    assert "12q rate [64->256]" in out and "exposed compute" in out
    assert "14q extctrl us/op [16->32]" in out
    out = run("--plan-only")
    assert "data sheet" in out and "28q plan: ops floor" in out and "a model" in out


def test_stamp_summary_splits_a_step_by_op_class():
    # rows as the stamp instance writes them: slot 0 the wait, 1 the first
    # load, 2 + o op o's start, 2 + n_ops the last store's start, 3 + n_ops
    # its end, the last slot the step's share of the global index
    prog = floor.scale_program(14, "extctrl", 8)
    (table,) = prog.tables
    n_ops = int(table.ints[0])
    ext = int(np.bitwise_or.reduce(floor.descriptors(table)[:, 4]))   # both control bits
    rows = np.zeros((2, 3, n_ops + floor.STAMP_EXTRA), np.int64)
    for b in range(2):
        for j in range(2):                      # the third step is never written
            row = rows[b, j]
            row[0], row[1] = 1000, 1100
            t = 1100 + np.cumsum([10 * (o + 1) for o in range(n_ops + 2)])
            row[2:4 + n_ops] = t
            row[-1] = ext if b else 0           # CTA 1's controls pass
    s = floor.stamp_summary(table, rows)
    assert s["steps"] == 4 and s["wait_cycles"] == 100 and s["ops"] == n_ops
    assert s["store_cycles"] == 10 * (n_ops + 2)
    # op o takes 10 (o + 2) cycles; on CTA 0 every op is skipped
    assert s["class_counts"] == {"skipped": 2 * n_ops, "swap_ext": 2 * n_ops}
    assert s["class_cycles"]["swap_ext"] == np.median([10 * (o + 2) for o in range(n_ops)])
    with pytest.raises(ValueError, match="CUDA device"):
        floor.stamps(14, device="cpu")


def test_stamp_summary_splits_a_tiled_op_into_its_phases():
    # a grid sweep holding one 6-qubit op: its row's tile slots (4 + n_ops
    # .. 9 + n_ops) split the op, from its start to the next boundary
    prog = floor.core_program(14, 6)
    (table,) = prog.tables
    n_ops = int(table.ints[0])
    assert floor.op_class(floor.descriptors(table)[n_ops - 1]) == "smem"
    rows = np.zeros((1, 2, n_ops + floor.STAMP_EXTRA), np.int64)
    for j in range(2):
        row = rows[0, j]
        row[0], row[1] = 1000, 1100
        row[2:4 + n_ops] = 1100 + 100 * np.arange(1, n_ops + 3)   # op o: 100 cycles
        start = row[1 + n_ops]                  # the tiled op, the last one
        row[4 + n_ops:10 + n_ops] = start + np.array([5, 10, 30, 60, 100, 150]) + j
        row[3 + n_ops - 1] = start + 200        # the store's start: the op's end
        row[-1] = 0
    s = floor.stamp_summary(table, rows)
    assert s["tile_cycles"] == {"call": 5.5, "tables": 5.0, "stage": 20.0, "publish": 30.0,
                                "product": 40.0, "barrier": 50.0, "after": 49.5}
    rows[..., 4 + n_ops:10 + n_ops] = 0         # no tiled op stamped
    assert floor.stamp_summary(table, rows)["tile_cycles"] == {}


def test_op_class_names_every_register_class():
    names = {name: floor.op_class(cls["descriptor"]) for name, cls in floor.census_classes(16).items()}
    assert names == {"reg": "swap_ctrl", "lane": "swap_lane_ctrl", "extctrl": "swap_ext",
                     "dense1": "dense1", "dense1_lane": "dense1_lane", "diag1": "diag1"}
    remap = np.zeros(tgs.DESC_WORDS, np.int32)
    remap[0] = tgs.D_REMAP
    assert floor.op_class(remap) == "remap"
    assert floor.op_class(np.zeros(tgs.DESC_WORDS, np.int32)) == "smem"


SASS = """
\t\tFunction : _Z6kernelPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   PMTRIG 0x1 ;
        /*0020*/                   LDS.128 R4, [R2] ;
        /*0030*/              @P0 BRA 0xe0 ;
        /*0040*/                   ISETP.NE.AND P1, PT, R4, RZ, PT ;
        /*0050*/                   BRX R8 -0x60 ;
        /*0060*/                   PMTRIG 0x2 ;
        /*0070*/                   FSEL R10, R11, R12, P1 ;
        /*0080*/                   BRA 0x100 ;
        /*0090*/                   PMTRIG 0x20 ;
        /*00a0*/                   STL [R1], R3 ;
        /*00b0*/              @P3 BRA 0xb0 ;
        /*00c0*/                   FMUL R3, R3, R4 ;
        /*00d0*/                   BRA 0x100 ;
        /*00e0*/                   STS [R1], R3 ;
        /*00f0*/                   BRA 0x20 ;
        /*0100*/                   IADD R5, R5, 1 ;
        /*0110*/               @P2 BRA 0x10 ;
        /*0120*/                   EXIT ;
"""


def test_sass_class_census_of_a_listing():
    # the loop's marker (pmevent 0 as the mask 0x1), a swap's (0x2) reached
    # by the jump table, a diagonal's (0x20); the loop's tail is no class's
    from tpu_qsim_torch.kernels import sass_census

    (body,) = sass_census.parse_functions(SASS).values()
    c = sass_census.class_census(body)
    assert set(c) == {"swap", "diag"}
    # the decode: LDS, the untaken branch, ISETP, BRX
    assert c["swap"]["decode"] == [4] and c["swap"]["body"] == [2]
    assert c["diag"]["decode"] == [4] and c["diag"]["body"] == [4]
    assert c["diag"]["local"] == [1] and c["diag"]["opcodes"]["FMUL"] == 1


def test_narrow_decode_reads_the_narrow_instance():
    # classes() of the two marked instances (cores of up to 4 and 11 qubits)
    from tpu_qsim_torch.kernels import sass_census

    def cls(d):
        return {"swap": {"decode": [d + 3, d]}, "diag": {"decode": [d - 30]}}

    got = sass_census.narrow_decode({
        "_ZN12_GLOBAL__N__23grid_sweep_stamp_kernelILi11ENS_5MarksEEEvPfS1_PKiPK6float2T0_": cls(90),
        "_ZN12_GLOBAL__N__23grid_sweep_stamp_kernelILi4ENS_5MarksEEEvPfS1_PKiPK6float2T0_": cls(59)})
    assert got == {"swap": 59, "diag": 29}


def test_marks_match_ignores_markers_and_padding():
    # the marked instance against the main library's instance of its width
    from tpu_qsim_torch.kernels import sass_census

    def listing(ops):
        return [(16 * i, op, "") for i, op in enumerate(ops)]

    def text(name, ops):
        return f"\t\tFunction : {name}\n" + "".join(
            f"        /*{16 * i:04x}*/                   {op} {'0x1' if op == 'PMTRIG' else 'R1'} ;\n"
            for i, op in enumerate(ops))

    class Build:
        main = ["IMAD", "LDG", "FFMA", "STG", "EXIT", "NOP"]

        def sass_listing(self, lib):
            assert lib == "grid_sweep"
            return {"_ZN12_GLOBAL__N__17grid_sweep_kernelILi4EEEvPf": listing(self.main)}

        def sass_text(self, lib):
            assert lib == "grid_sweep_stamps"
            return (text("_ZN12_GLOBAL__N__23grid_sweep_stamp_kernelILi4ENS_5MarksEEEvPf",
                         ["PMTRIG", "IMAD", "LDG", "PMTRIG", "FFMA", "STG", "EXIT", "NOP", "NOP"])
                    + text("_ZN12_GLOBAL__N__23grid_sweep_stamp_kernelILi4ENS_9StampRowsEEEvPf",
                           ["IMAD", "CS2R", "STG", "EXIT"]))

    (m,) = sass_census.marks_match(Build()).values()
    assert m == {"equal": True, "same_order": True, "marked": 5, "main": 5, "nops": [2, 1],
                 "differ": {}}
    Build.main = ["LDG", "IMAD", "FFMA", "FFMA", "STG", "EXIT"]
    (m,) = sass_census.marks_match(Build()).values()
    assert not m["equal"] and not m["same_order"] and m["differ"] == {"FFMA": [1, 2]}
