"""The CUDA kernels against their plain torch versions, on the card.

grid_sweep, whole_circuit, segment, scatter_segment, low_sweep,
high_sweep and dense_pass each run against the plain version of their
program, dense cores of 7 and 8 qubits on each kernel too, the sweeps at
tiles of 2^12 to 2^14 slots, the whole-circuit route (the sweep kernel over
the whole state) at two geometries, and each instance of the dense pass's
3xTF32 product; the simulator's routing (the split at a 12-qubit core
included) and each wrapper's refusals are checked as well. The noisy,
batched, density-matrix and variational paths (the torch engine) and
certify (the grid-sweep kernel) run on the card against the CPU. Two gloo
ranks on the card run a sharded circuit with the grid-sweep (21 qubits) and
the whole-circuit kernel (19) on each shard against the single-card run,
the demo (``python -m tpu_qsim_torch``) runs on the card, and the floor
certificate's rotation-chain kernel runs against its plain version. The
tiled dense op (cores of 5-11 qubits) runs on each kernel that holds it,
also with fewer groups than a warp tile, and its SASS holds tensor-core
products and no float32 FMA. A sweep's launches (tile runs, its unit
stage alone, from 10 qubits the dense pass) run each against the plain
version of its gates: 128 cases.

Every test here needs a CUDA card and skips elsewhere. The file imports
neither JAX nor the JAX package (the machine with the card has no JAX), so
it runs there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Tolerance 1e-6 on max |d amp|: kernel and plain version are two float32
evaluations of the same gate list in different summation orders (1e-5 for
the torch-engine paths' card against CPU, 1e-4 for a 20-term gradient).
"""

import numpy as np
import pytest
import torch

import tpu_qsim_torch as tq
from tpu_qsim_torch.gates import GATE_ARITY, register_gate
from tpu_qsim_torch.kernels import LAUNCHES, SEGMENT_KINDS, reset_launches
from tpu_qsim_torch.kernels import fused_circuit as fc
from tpu_qsim_torch.kernels import gridsweeps as tgs
from tpu_qsim_torch.kernels import segmented as seg
from tpu_qsim_torch.kernels import sweeps as ts

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def _random_planes(n: int, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal(1 << n) + 1j * rng.standard_normal(1 << n)
    psi /= np.linalg.norm(psi)
    return torch.from_numpy(np.stack([psi.real, psi.imag]).astype(np.float32)).to(device)


def _mixed_circuit(n: int) -> tq.Circuit:
    """Controls and diagonals in and out of the block, wide swaps, 3q and 4q
    dense cores."""
    rng = np.random.default_rng(0)
    for k in (3, 4):
        name = f"torch_cuda_dense{k}"
        if name not in GATE_ARITY:
            m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
            register_gate(name, np.linalg.qr(m)[0])
    c = tq.Circuit(n)
    c.h(n - 1).h(0).toffoli(n - 1, 3, n - 2).cry(1, n - 1, 0.3)
    c.mcz(0, 5, n - 2, n - 1).swap(n - 2, n - 1).crz(n - 1, 2, 0.7)
    c.cp(n - 2, n - 1, 1.1).swap(0, n - 3).rx(n - 3, 0.4).cz(n - 1, 4)
    c.add("torch_cuda_dense3", 2, n - 1, 6).add("torch_cuda_dense4", 7, 1, n - 2, 4)
    c.ry(n - 2, 1.3).cnot(n - 3, n - 1).t(n - 1).s(0).y(n - 2)
    return c


@pytest.mark.parametrize("n,name", [(20, "random"), (22, "mixed"), (21, "qft")])
def test_kernel_matches_plain(cuda_device, n, name):
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=42),
        "mixed": lambda: _mixed_circuit(n),
        "qft": lambda: tq.qft_circuit(n),
    }[name]()
    prog = tgs.GridSweepProgram(c)
    x = _random_planes(n, n, cuda_device)
    reset_launches()
    got = prog.run(x.clone())
    torch.cuda.synchronize()
    assert LAUNCHES["grid_sweep"] == prog.num_sweeps
    want = prog.run_plain(x)
    assert float((got - want).abs().max()) <= 1e-6


def test_simulator_routes_through_kernel(cuda_device):
    c = tq.ghz_circuit(20)
    reset_launches()
    sim = tq.StateVectorSimulator(20).run(c)
    assert sim.engine == "grid_sweep" and sim.device.type == "cuda"
    assert LAUNCHES["grid_sweep"] >= 1
    p = sim.probabilities()
    assert abs(float(p[0]) - 0.5) < 1e-6 and abs(float(p[-1]) - 0.5) < 1e-6
    assert set(sim.histogram(1000)) <= {0, (1 << 20) - 1}


def test_wrapper_rejects_bad_inputs(cuda_device):
    prog = tgs.GridSweepProgram(tq.random_circuit(20, 20, seed=1))
    ints, coef = prog._tables_on(cuda_device)[0]
    x = _random_planes(20, 0, cuda_device)
    with pytest.raises(ValueError):
        tgs.grid_sweep(x.double(), ints, coef, prog.layouts[0])
    with pytest.raises(ValueError):
        tgs.grid_sweep(x[:, : 1 << 19], ints, coef, prog.layouts[0])
    with pytest.raises(ValueError):
        tgs.grid_sweep(x, ints.cpu(), coef, prog.layouts[0])


def _dense_gate(k: int) -> str:
    name = f"torch_cuda_dense{k}"
    if name not in GATE_ARITY:
        rng = np.random.default_rng(k)
        m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
        register_gate(name, np.linalg.qr(m)[0])
    return name


def _wide_circuit(n: int, k: int, seed: int = 3) -> tq.Circuit:
    """A k-qubit dense core on the top k qubits between two random layers."""
    c = tq.random_circuit(n, 40, seed=seed)
    c.add(_dense_gate(k), *range(n - k, n))
    for g in tq.random_circuit(n, 40, seed=seed + 1).gates:
        c.add(g.name, *g.qubits, param=g.param)
    return c


@pytest.mark.parametrize("n", [10, 14, 18])
def test_whole_circuit_matches_plain(cuda_device, n):
    prog = fc.WholeCircuitProgram(tq.random_circuit(n, 100, seed=42))
    x = _random_planes(n, n, cuda_device)
    reset_launches()
    got = prog.run(x.clone())
    torch.cuda.synchronize()
    assert LAUNCHES["whole_circuit"] == 1
    want = prog.run_plain(x)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("n,k", [(12, 5), (16, 5), (18, 6)])
def test_whole_circuit_wide_dense_core(cuda_device, n, k):
    prog = fc.WholeCircuitProgram(_wide_circuit(n, k))
    x = _random_planes(n, k, cuda_device)
    got = prog.run(x.clone())
    want = prog.run_plain(x)
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [19, 22])
def test_segments_match_plain(cuda_device, n):
    # the whole plan in one launch, and each segment alone (the same kernel
    # over one segment), against the plain version
    prog = seg.SegmentedProgram(tq.random_circuit(n, 100, seed=42))
    kinds = [s.kernel for s in prog.steps]
    assert kinds[-1] == "scatter_segment" and prog.restore != tuple(range(n))
    x = _random_planes(n, n, cuda_device)
    reset_launches()
    got = prog.run(x.clone())
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"segment": 1}
    assert dict(SEGMENT_KINDS) == {"segment": 1, "scatter_segment": 1}
    want = prog.run_plain(x)
    assert float((got - want).abs().max()) <= 1e-7
    for i, kind in enumerate(kinds):
        reset_launches()
        got = prog.launch(x.clone(), i, i + 1)
        torch.cuda.synchronize()
        assert dict(LAUNCHES) == {"segment": 1} and dict(SEGMENT_KINDS) == {kind: 1}
        want = prog.step_plain(x, i)
        assert float((got - want).abs().max()) <= 1e-7, (i, kind)
        x = want


def test_segments_loop_over_more_blocks_than_resident_ctas(cuda_device):
    # 24 qubits in 2^14-slot blocks (default_local_bits): 1024 blocks of
    # 1024 threads, more than the card keeps resident, so each CTA takes
    # several blocks of every segment
    n = 24
    prog = seg.SegmentedProgram(tq.random_circuit(n, 100, seed=42))
    resident = seg.resident_ctas(cuda_device, prog.local_bits, prog.table.max_core > 4)
    assert 1 << (n - prog.local_bits) > resident
    x = _random_planes(n, 4, cuda_device)
    got = prog.run(x.clone())
    want = prog.run_plain(x)
    assert float((got - want).abs().max()) <= 1e-6


def test_simulator_routes_by_size(cuda_device):
    for n in range(10, 20):
        reset_launches()
        sim = tq.StateVectorSimulator(n).run(tq.ghz_circuit(n))
        want = "whole_circuit" if n <= 18 else "segmented"
        assert sim.engine == want
        assert sum(LAUNCHES.values()) >= 1 and set(LAUNCHES) <= {"whole_circuit", "segment"}
        p = sim.probabilities()
        assert abs(float(p[0]) - 0.5) < 1e-6 and abs(float(p[-1]) - 0.5) < 1e-6
    sim = tq.StateVectorSimulator(9).run(tq.ghz_circuit(9))
    assert sim.engine == "torch"


def test_grid_fallback_routes_to_segments(cuda_device):
    c = _wide_circuit(22, 6)
    reset_launches()
    sim = tq.StateVectorSimulator(22).run(c)
    torch.cuda.synchronize()
    assert sim.engine == "segmented" and dict(LAUNCHES) == {"segment": 1}
    assert dict(SEGMENT_KINDS) == {"segment": 1, "scatter_segment": 1}
    _, prog = sim.compiled_run(c)
    want = prog.run_plain(tq.apply.initial_state(22, np.float32, device=cuda_device))
    assert float((sim.state_planes - want).abs().max()) <= 1e-6


def test_new_wrappers_reject_bad_inputs(cuda_device):
    wprog = fc.WholeCircuitProgram(tq.random_circuit(12, 20, seed=1))
    ints, coef = wprog._tables_on(cuda_device)
    x = _random_planes(12, 0, cuda_device)
    for bad in (x.double(), x.cpu(), x[:, : 1 << 11], x.t().contiguous()):
        with pytest.raises(ValueError):
            fc.whole_circuit(bad, ints, coef, wprog.tile_bits, wprog.threads, wprog.ctas)
    sprog = seg.SegmentedProgram(tq.random_circuit(19, 60, seed=1))
    y = _random_planes(19, 0, cuda_device)
    for bad in (y.double(), y[:, : 1 << 18], y.t().contiguous()):
        with pytest.raises(ValueError):
            sprog.launch(bad)
    with pytest.raises(ValueError, match="other"):
        sprog.launch(y, other=y)
    with pytest.raises(ValueError, match="segments"):
        sprog.launch(y, 0, sprog.num_segments + 1)


@pytest.mark.parametrize("kernel", ["grid_sweep", "whole_circuit", "segment", "sweep"])
def test_narrow_and_wide_instances_agree(cuda_device, kernel):
    # each kernel is built for cores of up to 4 qubits and of up to 11 (the
    # tiled op); on a table of narrow cores both instances give the same
    # amplitudes
    n = {"grid_sweep": 20, "whole_circuit": 16, "segment": 19, "sweep": 22}[kernel]
    c = tq.random_circuit(n, 100, seed=7)
    x = _random_planes(n, 3, cuda_device)
    out = []
    for max_core in (None, 8):
        y = x.clone()
        if kernel == "sweep":
            prog = ts.SweepProgram(c)
            for i, (tables, launches) in enumerate(zip(prog._tables_on(cuda_device),
                                                       prog.launches)):
                for t, ln in zip(tables, launches):
                    assert ln.route == "tile" and ln.max_core <= 4
                    prog.launch_table(y, i, t, max_core or ln.max_core, "tile")
        elif kernel == "grid_sweep":
            prog = tgs.GridSweepProgram(c)
            for (ints, coef), lay, t in zip(prog._tables_on(cuda_device), prog.layouts,
                                            prog.tables):
                assert t.max_core <= 4
                tgs.grid_sweep(y, ints, coef, lay, max_core or t.max_core)
        elif kernel == "whole_circuit":
            prog = fc.WholeCircuitProgram(c)
            ints, coef = prog._tables_on(cuda_device)
            fc.whole_circuit(y, ints, coef, prog.tile_bits, prog.threads, prog.ctas,
                             max_core or prog.table.max_core)
        else:
            prog = seg.SegmentedProgram(c)
            assert prog.table.max_core <= 4
            y = prog.launch(y, max_core=max_core)
        out.append(y)
    torch.cuda.synchronize()
    assert float((out[0] - out[1]).abs().max()) <= 1e-7


def test_wrappers_refuse_cores_wider_than_six(cuda_device):
    # since the tiled op the kernels take cores of up to 11 qubits
    # (MAX_DENSE_QUBITS); a launch for a wider one is refused
    prog = fc.WholeCircuitProgram(tq.random_circuit(12, 20, seed=1))
    ints, coef = prog._tables_on(cuda_device)
    x = _random_planes(12, 0, cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        fc.whole_circuit(x, ints, coef, prog.tile_bits, prog.threads, prog.ctas,
                         fc.MAX_DENSE_QUBITS + 1)


@pytest.mark.parametrize("n", [22, 26])
def test_sweep_kernels_match_plain(cuda_device, n):
    prog = ts.SweepProgram(tq.random_circuit(n, 100, seed=42))
    kinds = prog.sweep_kinds
    assert set(kinds) == {"low", "high"}
    x = _random_planes(n, n, cuda_device)
    reset_launches()
    for i in range(prog.num_sweeps):
        got = prog.launch(x.clone(), i)
        want = prog.step_plain(x, i)
        assert float((got - want).abs().max()) <= 1e-6, (i, kinds[i])
        x = want
    torch.cuda.synchronize()
    assert LAUNCHES["low_sweep"] == kinds.count("low")
    assert LAUNCHES["high_sweep"] == kinds.count("high")


@pytest.mark.parametrize("geometry", [
    ts.SweepGeometry(256, 1), ts.SweepGeometry(512, 4), ts.SweepGeometry(1024, 2),
])
def test_sweep_geometries_agree(cuda_device, geometry):
    c = tq.random_circuit(24, 100, seed=5)
    x = _random_planes(24, 1, cuda_device)
    want = ts.SweepProgram(c).run(x.clone())
    got = ts.SweepProgram(c, geometry=geometry).run(x.clone())
    assert float((got - want).abs().max()) <= 1e-7


@pytest.mark.parametrize("n,k,lo", [(22, 8, 9), (22, 10, 7), (24, 11, 6)])
def test_sweeps_route_launches_match_plain(cuda_device, n, k, lo):
    # a unit stage between tile stages: each launch (tile runs on the narrow
    # instance, the unit stage alone on the wide one, or from
    # MIN_SWEEP_PASS_CORE qubits the dense pass) against the plain version
    # of its gates, and the run against the plan before the split (one
    # launch a sweep, the tiled op)
    c = _dense_core_circuit(n, k, lo)
    prog = ts.SweepProgram(c)
    one = ts.SweepProgram(c, _one_launch=True)
    x = _random_planes(n, k, cuda_device)
    reset_launches()
    y = x.clone()
    for i in range(prog.num_sweeps):
        for j, ln in enumerate(prog.launches[i]):
            got = prog.launch_one(y.clone(), i, j)
            want = prog.launch_plain(y, i, j)
            assert float((got - want).abs().max()) <= 1e-6, (i, j, ln.route)
            y = want
    routes = [ln.route for sw in prog.launches for ln in sw]
    core = "pass" if k >= ts.MIN_SWEEP_PASS_CORE else "unit"
    assert routes.count(core) == 1 and "mixed" not in routes
    assert LAUNCHES["dense_pass"] == int(core == "pass")
    assert LAUNCHES["unit_stage"] == int(core == "unit")
    got = prog.run(x.clone())
    assert float((got - one.run(x.clone())).abs().max()) <= 1e-6
    assert float((got - prog.run_plain(x)).abs().max()) <= 1e-6


def _dense_core_circuit(n: int, k: int, lo: int) -> tq.Circuit:
    """A k-qubit dense gate on qubits lo..lo+k-1 between two random layers."""
    c = tq.random_circuit(n, 40, seed=k)
    c.add(_dense_gate(k), *range(lo, lo + k))
    for g in tq.random_circuit(n, 40, seed=k + 1).gates:
        c.add(g.name, *g.qubits, param=g.param)
    return c


@pytest.mark.parametrize("n,k,lo,engine", [
    (12, 7, 2, "whole_circuit"), (12, 8, 4, "whole_circuit"),
    (12, 9, 3, "whole_circuit"), (12, 10, 2, "whole_circuit"),
    (22, 7, 0, "grid_sweep"), (22, 8, 0, "grid_sweep"),
    (22, 9, 0, "grid_sweep"), (22, 10, 0, "grid_sweep"),
    (22, 7, 15, "segmented"), (22, 8, 14, "segmented"), (22, 9, 13, "segmented"),
    (22, 7, 8, "sweeps"), (24, 7, 12, "sweeps"), (24, 8, 10, "sweeps"),
    (26, 8, 10, "sweeps"), (22, 10, 7, "sweeps"),
])
def test_wide_core_on_each_kernel(cuda_device, n, k, lo, engine):
    c = _dense_core_circuit(n, k, lo)
    reset_launches()
    sim = tq.StateVectorSimulator(n).run(c)
    torch.cuda.synchronize()
    assert sim.engine == engine
    assert sum(LAUNCHES.values()) >= 1
    _, prog = sim.compiled_run(c)
    want = prog.run_plain(tq.apply.initial_state(n, np.float32, device=cuda_device))
    assert float((sim.state_planes - want).abs().max()) <= 1e-6


def _tiled_case(kernel: str, n: int, k: int, qubits: tuple[int, ...], seed: int):
    """One k-qubit core (under the control qubits[0] when qubits holds
    k + 1) alone on a random n-qubit state, through ``kernel``'s program:
    (program, the result of its kernel, the result of its plain version).
    The gate is carried inline (no registry check of a 4096 x 4096
    matrix)."""
    from tpu_qsim_torch.circuit import Gate

    rng = np.random.default_rng(seed)
    m = rng.standard_normal((1 << k, 1 << k)) + 1j * rng.standard_normal((1 << k, 1 << k))
    core = np.linalg.qr(m)[0]
    u = core
    if len(qubits) > k:
        u = np.eye(1 << len(qubits), dtype=np.complex128)
        u[-(1 << k):, -(1 << k):] = core
    c = tq.Circuit(n).append(Gate(f"tiled{k}", tuple(qubits), matrix_bytes=u.tobytes()))
    # the sweeps: the tiled op at every width (the route sends unit stages
    # of MIN_SWEEP_PASS_CORE+ qubits to the dense pass; one launch a sweep
    # keeps them)
    sweeps = lambda c: ts.SweepProgram(c, _one_launch=True)   # noqa: E731
    prog = {"whole_circuit": fc.WholeCircuitProgram, "low_sweep": sweeps,
            "high_sweep": sweeps, "grid_sweep": tgs.GridSweepProgram,
            "segment": seg.SegmentedProgram}[kernel](c)
    if kernel.endswith("_sweep") and kernel != "grid_sweep":
        assert prog.sweep_kinds == [kernel.split("_")[0]]
    x = _random_planes(n, seed, torch.device("cuda"))
    got = prog.run(x.clone())
    want = prog.run_plain(x)
    torch.cuda.synchronize()
    return prog, got, want


def _tiled_qubits(kernel: str, k: int) -> tuple[int, tuple[int, ...]]:
    """(n, qubits) of test_tiled_op_matches_plain's core: under a
    block-local control, but for a segment's 9-qubit core (a segment's gate
    holds at most 9 qubits)."""
    if kernel == "whole_circuit":
        return 12, (11,) + tuple(range(k))
    if kernel == "low_sweep":
        return 22, (0,) + tuple(range(17 - k, 17))
    if kernel == "high_sweep":       # 4 of the top 5 bits and low bits
        return 22, (15, 18, 19, 20, 21) + tuple(range(k - 4))
    if kernel == "grid_sweep":
        return 20, (12,) + tuple(range(1, k + 1))
    return 22, ((0,) if k < 9 else ()) + tuple(range(22 - k, 22))


@pytest.mark.parametrize("kernel,k", [
    (kernel, k) for kernel in ("whole_circuit", "low_sweep", "grid_sweep", "segment", "high_sweep")
    for k in range(5, 12) if kernel != "segment" or k <= 9
])
def test_tiled_op_matches_plain(cuda_device, kernel, k):
    # one k-qubit core under a block-local control, alone in its table, on a
    # random state: the tiled op against the plain version
    n, qubits = _tiled_qubits(kernel, k)
    prog, got, want = _tiled_case(kernel, n, k, qubits, seed=k)
    core = prog.table.max_core if kernel in ("whole_circuit", "segment") else max(
        t.max_core for t in prog.tables)
    assert core == k
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("kernel,n,k,qubits", [
    ("whole_circuit", 11, 10, (10,) + tuple(range(10))),      # 1 group
    ("whole_circuit", 12, 9, (11,) + tuple(range(9))),        # 4
    ("grid_sweep", 20, 11, (12,) + tuple(range(1, 12))),      # 2 in a 2^13 block
    ("grid_sweep", 20, 9, (12,) + tuple(range(1, 10))),       # 8
    ("low_sweep", 22, 11, tuple(range(6, 17))),               # 8 a tile of 2^14 float2
])
def test_tiled_op_with_fewer_groups_than_a_warp_tile(cuda_device, kernel, n, k, qubits):
    # a warp tile takes 16 groups: the columns past the op's groups read
    # duplicates and are never stored
    _, got, want = _tiled_case(kernel, n, k, qubits, seed=n + k)
    assert float((got - want).abs().max()) <= 1e-6


def test_tiled_op_runs_on_the_tensor_cores(cuda_device):
    # every wide instance's tiled op (its own function, after the kernel's
    # code) holds tensor-core products and no float32 FMA
    sass = fc.tiled_op_sass()
    assert sorted(key.split(":")[0] for key in sass) == [
        "grid_sweep", "segment", "sweep", "sweep", "sweep"]  # low, high, low with spare warps
    for key, counts in sass.items():
        assert counts["calls"] >= 1 and counts["kernel_HMMA"] == 0, (key, counts)
        assert counts["HMMA"] > 0 and counts["FFMA"] == 0, (key, counts)


@pytest.mark.parametrize("blk,threads", [(8, 512), (6, 128)])
@pytest.mark.parametrize("n,name", [(20, "random"), (21, "mixed"), (22, "qft"), (22, "dense")])
def test_register_grid_sweep_matches_plain(cuda_device, n, name, blk, threads):
    # the register design in blocks of 2^13 and 2^11 slots, 16 a thread:
    # runs of ops in registers, lane ops through shuffles, remaps, and 3-
    # and 4-qubit cores in shared memory between them
    c = {
        "random": lambda: tq.random_circuit(n, 100, seed=11),
        "mixed": lambda: _mixed_circuit(n),
        "qft": lambda: tq.qft_circuit(n),
        "dense": lambda: _dense_core_circuit(n, 6, 2),
    }[name]()
    prog = tgs.GridSweepProgram(c, tgs.GridParams(blk, 5))
    assert {tgs.block_threads(lay.kbits) for lay in prog.layouts} == {threads}
    x = _random_planes(n, n + 1, cuda_device)
    got = prog.run(x.clone())
    want = prog.run_plain(x)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-6


@pytest.mark.parametrize("threads", [256, 1024])
def test_staged_sweeps_match_plain(cuda_device, threads):
    # tiles of 2^12 and 2^14 slots: each sweep's stages (tile passes, and a
    # unit pass for the 7-qubit core) against the plain version
    c = _dense_core_circuit(24, 7, 12)
    prog = ts.SweepProgram(c, geometry=ts.SweepGeometry(threads, None))
    wide = [t.max_core >= fc.TILE_CORE for t in prog.tables]
    assert prog.tile_bits == [13 if w and threads > 512 else threads.bit_length() + 3
                              for w in wide]
    assert any(st.kind == "unit" for sweep in prog.stages for st in sweep)
    x = _random_planes(24, 4, cuda_device)
    for i in range(prog.num_sweeps):
        got = prog.launch(x.clone(), i)
        want = prog.step_plain(x, i)
        assert float((got - want).abs().max()) <= 1e-6, (i, prog.sweep_kinds[i])
        x = want


def _kron_core(k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    u = np.ones((1, 1), np.complex128)
    for _ in range(k):
        m = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
        u = np.kron(u, np.linalg.qr(m)[0])
    return u


@pytest.mark.parametrize("n,targets,controls", [
    (16, tuple(range(12)), ()),                    # 16 groups: the small instance
    (14, (3, 0, 5, 1, *range(6, 14)), (2,)),       # a control on a low bit
    (22, tuple(range(10, 22)), ()),                # 1024 groups: the large instance
    (14, (13, 2, 9, 0, 7, 5, 11), (4, 12)),        # a 7-qubit core, two controls: medium
])
def test_dense_pass_matches_plain(cuda_device, n, targets, controls):
    from tpu_qsim_torch.kernels import dense_pass as dp

    core = _kron_core(len(targets), n)
    u = torch.from_numpy(dp.core_operand(core, targets)).to(cuda_device)
    x = _random_planes(n, n, cuda_device)
    reset_launches()
    got = dp.dense_pass(x, u, sum(1 << q for q in targets), sum(1 << q for q in controls))
    torch.cuda.synchronize()
    assert LAUNCHES["dense_pass"] == 1
    want = dp.apply_controlled(x, core, targets, controls)
    assert float((got - want).abs().max()) <= 1e-6


def test_simulator_splits_at_a_wide_core(cuda_device):
    from tpu_qsim_torch.circuit import Gate

    n = 16
    core = _kron_core(12, 3)
    c = tq.random_circuit(n, 30, seed=1)
    c.append(Gate("kron12", tuple(range(4, 16)), matrix_bytes=core.tobytes()))
    c.extend(tq.random_circuit(n, 30, seed=2).gates)
    reset_launches()
    sim = tq.StateVectorSimulator(n).run(c)
    torch.cuda.synchronize()
    assert sim.engine == "whole_circuit+dense_pass"
    assert dict(LAUNCHES) == {"whole_circuit": 2, "dense_pass": 1}
    _, prog = sim.compiled_run(c)
    want = prog.run_plain(tq.apply.initial_state(n, np.float32, device=cuda_device))
    assert float((sim.state_planes - want).abs().max()) <= 1e-6


def test_dense_pass_refuses_bad_inputs(cuda_device):
    from tpu_qsim_torch.kernels import dense_pass as dp

    targets = tuple(range(12))
    u = torch.from_numpy(dp.core_operand(_kron_core(12, 0), targets)).to(cuda_device)
    tmask = (1 << 12) - 1
    x = _random_planes(14, 0, cuda_device)
    for bad in (x.double(), x.cpu(), x[:, : 1 << 13], x.t().contiguous()):
        with pytest.raises(ValueError):
            dp.dense_pass(bad, u, tmask)
    with pytest.raises(ValueError):
        dp.dense_pass(x, u[:, : 1 << 11], tmask)              # not 2^12 x 2^12
    with pytest.raises(ValueError):
        dp.dense_pass(x, u.cpu(), tmask)
    with pytest.raises(ValueError):
        dp.dense_pass(x, u, tmask, cmask=1)                   # a control on a target
    with pytest.raises(ValueError):
        dp.dense_pass(x, u, tmask << 3)                       # targets past the state


@pytest.mark.parametrize("n,instance", [(16, "small"), (18, "medium"), (22, "large")])
def test_dense_pass_instances_at_3xtf32(cuda_device, n, instance):
    # a 12-qubit core on qubits 0-11: each instance's 3xTF32 product against
    # the plain version and torch.matmul of the core (TF32 off), within 1e-7
    from tpu_qsim_torch.kernels import dense_pass as dp

    targets = tuple(range(12))
    assert dp.pass_instance(12, n - 12) == instance
    core = _kron_core(12, n)
    u = torch.from_numpy(dp.core_operand(core, targets)).to(cuda_device)
    x = _random_planes(n, n + 2, cuda_device)
    got = dp.dense_pass(x, u, (1 << 12) - 1)
    want = dp.apply_controlled(x, core, targets)
    assert float((got - want).abs().max()) <= 1e-7
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        y = torch.matmul(torch.complex(x[0], x[1]).view(-1, 1 << 12),
                         torch.complex(u[0], u[1]).T).reshape(-1)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    assert float((torch.complex(got[0], got[1]) - y).abs().max()) <= 1e-7


@pytest.mark.parametrize("n,tile_bits,ctas", [(16, 11, 32), (18, 13, 16), (18, 10, 64)])
def test_staged_whole_circuit_geometries(cuda_device, n, tile_bits, ctas):
    # the whole-circuit route at tiles and CTA counts off its table: each
    # CTA takes tiles in turn where there are fewer CTAs than tiles
    prog = fc.WholeCircuitProgram(tq.random_circuit(n, 100, seed=7), tile_bits, ctas)
    assert (prog.tile_bits, prog.ctas) == (tile_bits, ctas) and len(prog.stages) > 1
    x = _random_planes(n, 8, cuda_device)
    reset_launches()
    got = prog.run(x.clone())
    torch.cuda.synchronize()
    assert LAUNCHES["whole_circuit"] == 1
    assert float((got - prog.run_plain(x)).abs().max()) <= 1e-6


@pytest.mark.parametrize("k", [9, 10])
def test_whole_circuit_core_wider_than_its_tile_threads(cuda_device, k):
    # at 10 qubits a tile of 2^10 slots has 64 threads; a 9- or 10-qubit
    # core's tiled op needs 128 or 256: the launch takes that many, the
    # others idle in the tile stages
    c = _dense_core_circuit(10, k, 0)
    prog = fc.WholeCircuitProgram(c)
    assert prog.tile_bits == 10 and prog.threads == (1 << k) // 4
    assert [st.kind for st in prog.stages] == ["tile", "unit", "tile"]
    x = _random_planes(10, k, cuda_device)
    got = prog.run(x.clone())
    torch.cuda.synchronize()
    assert float((got - prog.run_plain(x)).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# noisy, batched, density-matrix and variational paths: card against CPU
# ---------------------------------------------------------------------------


def _noise_model():
    return tq.NoiseModel().add_depolarizing(0.05).add_amplitude_damping(0.1, [0, 3]).add_bit_flip(0.02, 5)


@pytest.mark.parametrize("insertion", ["all", "gate_qubits"])
def test_trajectory_step_card_matches_cpu(cuda_device, insertion):
    from tpu_qsim_torch.noisy import build_trajectory_step

    n, batch = 12, 16
    c = tq.random_circuit(n, 30, seed=3)
    on_card, n_draws = build_trajectory_step(c, _noise_model(), np.float32, insertion, cuda_device)
    on_cpu, _ = build_trajectory_step(c, _noise_model(), np.float32, insertion, "cpu")
    u = torch.rand(batch, n_draws, dtype=torch.float64, generator=torch.Generator().manual_seed(1))
    x = tq.apply.initial_state(n, np.float32, 0, "cpu").expand(batch, 2, 1 << n)
    got = on_card(x.to(cuda_device), u.to(cuda_device))
    want = on_cpu(x, u)
    assert got.is_cuda and float((got.cpu() - want).abs().max()) <= 1e-5
    single = on_card(x[0].to(cuda_device), u[0].to(cuda_device))
    assert float((single - got[0]).abs().max()) <= 1e-6


def test_trajectory_simulators_run_on_the_card(cuda_device, tmp_path):
    n = 10
    c = tq.random_circuit(n, 40, seed=2)
    noisy = tq.NoisySimulator(n, _noise_model(), seed=1).run(c)
    assert noisy.state_planes.is_cuda and noisy.is_normalized(1e-4)
    batched = tq.BatchedSimulator(n, 64, _noise_model(), seed=1).run(c)
    assert batched.state_planes.is_cuda and batched.state_planes.shape == (64, 2, 1 << n)
    assert batched.total_probability() == pytest.approx(1.0, abs=1e-4)
    assert batched.sample(5).shape == (64, 5) and batched.measure_qubit(3).shape == (64,)
    batched.save_state(str(tmp_path / "batch.npz"))
    cpu = tq.BatchedSimulator(n, 64, device="cpu")
    cpu.load_state(str(tmp_path / "batch.npz"))
    np.testing.assert_allclose(batched.reduced_density_matrix([1, 4]),
                               cpu.reduced_density_matrix([1, 4]), atol=1e-5)
    assert batched.expectation_pauli("ZXI") == pytest.approx(cpu.expectation_pauli("ZXI"), abs=1e-5)


@pytest.mark.parametrize("insertion", ["all", "gate_qubits"])
def test_density_matrix_card_matches_cpu(cuda_device, insertion):
    n = 8
    c = tq.random_circuit(n, 30, seed=5).cry(0, 7, 0.4).toffoli(1, 2, 6)
    card = tq.DensityMatrixSimulator(n, _noise_model(), insertion=insertion).run(c)
    cpu = tq.DensityMatrixSimulator(n, _noise_model(), insertion=insertion, device="cpu").run(c)
    assert card.state_planes.is_cuda
    assert float((card.state_planes.cpu() - cpu.state_planes).abs().max()) <= 1e-5
    assert card.purity() == pytest.approx(cpu.purity(), abs=1e-5)
    np.testing.assert_allclose(card.reduced_density_matrix([0, 5]),
                               cpu.reduced_density_matrix([0, 5]), atol=1e-5)
    pure = tq.StateVectorSimulator(n).run(c)
    assert card.fidelity_with(pure) == pytest.approx(
        cpu.fidelity_with(pure.state_planes.cpu()), abs=1e-5)


def test_expectation_and_gradient_card_matches_cpu(cuda_device):
    n = 10
    c = tq.hardware_efficient_ansatz(n, 2, seed=1)
    h = tq.tfim_hamiltonian(n)
    params = torch.tensor(c.params())
    grads = []
    for device in (cuda_device, "cpu"):
        f = tq.build_expectation_fn(c, h, device=device)
        p = params.clone().to(device).requires_grad_(True)
        e = f(p)
        e.backward()
        grads.append((float(e.detach()), p.grad.cpu()))
    assert grads[0][0] == pytest.approx(grads[1][0], abs=1e-4)
    assert float((grads[0][1] - grads[1][1]).abs().max()) <= 1e-4
    batch = tq.build_expectation_fn(c, h)(torch.stack([params, params + 0.1]))
    assert batch.is_cuda and batch.shape == (2,)


def test_certify_runs_the_grid_kernel(cuda_device):
    from tpu_qsim_torch import certify

    n = 22
    reset_launches()
    qft = certify.qft_analytic_max_diff(n)
    diag = certify.diag_layer_analytic_max_diff(n)
    perm = certify.permutation_analytic_max_dev(n)
    cross = certify.cross_engine_max_diff(tq.random_circuit(n, 60, seed=4))
    torch.cuda.synchronize()
    assert LAUNCHES["grid_sweep"] >= 4
    assert max(qft, diag, perm, cross) < 5e-6


def test_new_entry_points_default_to_the_card(cuda_device, monkeypatch):
    assert tq.DensityMatrixSimulator(2).state_planes.is_cuda
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tq.NoisySimulator(4), lambda: tq.BatchedSimulator(4, 2),
                 lambda: tq.DensityMatrixSimulator(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.mark.parametrize("n,engine", [(21, "grid_sweep"), (19, "whole_circuit")])
def test_sharded_run_on_two_ranks_matches_one_card(cuda_device, tmp_path, n, engine):
    # two gloo ranks on the one card (NCCL refuses two ranks on one device),
    # each shard of n - 1 qubits on the kernel its size routes to
    from torch_rank_cases import cuda_sharded_case
    from tpu_qsim_torch.ranks import run_ranks

    results = run_ranks(cuda_sharded_case, 2, (n,), backend="gloo",
                        store_dir=str(tmp_path), timeout=300)
    for r in results:
        assert set(r["engines"]) == {engine}
        launches = r["launches"].get(engine, 0)
        if engine == "whole_circuit":
            assert launches == len(r["engines"])   # one launch a segment
        else:
            assert launches > 0
        assert r["exchanges"] == r["planned"] > 0
        assert r["max_abs_err"] <= 1e-6


def test_demo_runs_on_the_card(cuda_device):
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-m", "tpu_qsim_torch"], capture_output=True,
                          text=True, timeout=180, cwd=Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "|00>  amp = +0.7071+0.0000j   P = 0.5000" in proc.stdout


@pytest.mark.parametrize("n,k", [(9, 16), (12, 0), (14, 5), (16, 16), (18, 17), (20, 64), (22, 256)])
def test_rotation_chain_matches_plain(cuda_device, n, k):
    # blocks of 2^9 (one warp, 2 active bits) to 2^12 (256 threads, 5); K
    # of 5 and 17 run the remainder after the step loop's unrolled copies
    from tpu_qsim_torch.kernels import floor

    x = _random_planes(n, 3, cuda_device)
    angles = floor.chain_angles(k)
    want = floor.rotation_chain_plain(x, angles)
    reset_launches()
    got = floor.rotation_chain(x.clone(), angles)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"rotation_chain": 1}
    assert float((got - want).abs().max()) <= 1e-6


def test_rotation_chain_refuses(cuda_device):
    from tpu_qsim_torch.kernels import floor

    x = _random_planes(12, 3, cuda_device)
    with pytest.raises(ValueError, match="at most"):
        floor.rotation_chain(x, floor.chain_angles(floor.MAX_STEPS + 1))
    with pytest.raises(ValueError, match="float32"):
        floor.rotation_chain(x.double(), floor.chain_angles(4))
