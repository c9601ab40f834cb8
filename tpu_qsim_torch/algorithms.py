"""Algorithms built on the circuit IR: Grover, QAOA, phase and amplitude
estimation, Trotter evolution, VQE and classical shadows.

The port's counterpart of ``tpu_qsim/algorithms.py``. The circuit factories
and the host-side decoders are copies; the variational parts run on
:func:`tpu_qsim_torch.statevector.build_expectation_fn` with
``torch.autograd`` and ``torch.optim.Adam`` (the JAX package: ``jax.grad``
and optax), and the shadow snapshots draw from a seeded ``torch.Generator``
on the state's device (the JAX package: ``jax.random``), so shadows agree
with the JAX package's as estimates, not bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

from .circuit import Circuit


def _multi_controlled_x(c: Circuit, controls: Sequence[int], target: int) -> None:
    c.mcx(*controls, target)


def _multi_controlled_z(c: Circuit, qubits: Sequence[int]) -> None:
    """Phase-flip the all-ones state of ``qubits`` — a single diagonal MCZ
    gate on every backend (see Circuit.mcz)."""
    c.mcz(*qubits)


def grover_circuit(num_qubits: int, marked: int, iterations: int | None = None) -> Circuit:
    """Grover search for basis state ``marked`` over ``num_qubits`` qubits.

    Oracle: phase-flip on |marked> (X-conjugated multi-controlled Z).
    Diffusion: H^n . (phase flip on |0..0>) . H^n. The MCZ primitive is a
    single diagonal gate, so circuits stay shallow at any register size
    (the reference's Grover analog was impossible: no multi-controlled
    gate beyond Toffoli).
    """
    from .gates import MAX_MCZ_QUBITS

    if not (2 <= num_qubits <= MAX_MCZ_QUBITS):
        raise ValueError(f"grover supports 2..{MAX_MCZ_QUBITS} qubits")
    if not (0 <= marked < (1 << num_qubits)):
        raise ValueError("marked state out of range")
    if iterations is None:
        # floor, not round: k rotations give amplitude sin((2k+1)theta);
        # overshooting rotates past the target (n=2: 1 iteration is exact,
        # 2 would land back at uniform)
        iterations = max(1, int(math.pi / 4 * math.sqrt(1 << num_qubits)))

    c = Circuit(num_qubits)
    for q in range(num_qubits):
        c.h(q)
    all_qs = list(range(num_qubits))
    for _ in range(iterations):
        # oracle: flip phase of |marked>
        for q in all_qs:
            if not ((marked >> q) & 1):
                c.x(q)
        _multi_controlled_z(c, all_qs)
        for q in all_qs:
            if not ((marked >> q) & 1):
                c.x(q)
        # diffusion: 2|s><s| - I
        for q in all_qs:
            c.h(q)
            c.x(q)
        _multi_controlled_z(c, all_qs)
        for q in all_qs:
            c.x(q)
            c.h(q)
    return c


def qaoa_maxcut_circuit(
    edges: Sequence[tuple[int, int]],
    num_qubits: int,
    gammas: Sequence[float],
    betas: Sequence[float],
) -> Circuit:
    """QAOA ansatz for MaxCut: |+>^n then alternating cost/mixer layers.

    Cost layer: exp(-i gamma C) with C = sum (1 - Z_a Z_b)/2, realized per
    edge as CNOT-Rz(-gamma)-CNOT (= exp(+i gamma/2 Z_a Z_b), global phase
    dropped). Mixer: Rx(2 beta) on every qubit. Parameterized: run with
    ``StateVectorSimulator.run_parameterized`` to sweep (gammas, betas).
    """
    if len(gammas) != len(betas):
        raise ValueError("gammas and betas must have equal length")
    c = Circuit(num_qubits)
    for q in range(num_qubits):
        c.h(q)
    for gamma, beta in zip(gammas, betas):
        for a, b in edges:
            c.cnot(a, b)
            c.rz(b, -float(gamma))
            c.cnot(a, b)
        for q in range(num_qubits):
            c.rx(q, 2.0 * float(beta))
    return c


def qaoa_maxcut_objective(
    edges: Sequence[tuple[int, int]],
    num_qubits: int,
    depth: int = 1,
    device=None,
):
    """Differentiable QAOA objective: ``(gammas, betas) -> <C>``.

    Builds the depth-``depth`` ansatz once and returns a function of the two
    length-``depth`` angle vectors (tensors that require a gradient get one
    through ``torch.autograd``) that evaluates the MaxCut expectation
    <C> = sum over edges of (1 - <Z_a Z_b>)/2 on one state preparation
    (a weighted Pauli-sum observable). Maximize it with any torch optimizer:

        obj = qaoa_maxcut_objective(edges, n, depth=2)
        angles = torch.zeros(2, 2, requires_grad=True)
        (-obj(angles[0], angles[1])).backward()

    The per-gate parameter vector is rebuilt from the shared (gamma, beta)
    angles layer by layer (per layer: one rz(-gamma) per edge, then one
    rx(2 beta) per qubit), so gradients flow through the sharing.
    ``device=None`` means the CUDA card.
    """
    import torch

    from . import apply as ap
    from .statevector import build_expectation_fn

    device = ap.resolve_device(device)
    circuit = qaoa_maxcut_circuit(
        edges, num_qubits, [0.0] * depth, [0.0] * depth
    )
    terms = [(0.5 * len(edges), "I" * num_qubits)]
    for a, b in edges:
        zz = ["I"] * num_qubits
        zz[num_qubits - 1 - a] = "Z"
        zz[num_qubits - 1 - b] = "Z"
        terms.append((-0.5, "".join(zz)))
    expect_h = build_expectation_fn(circuit, terms, device=device)
    n_edges = len(edges)

    def objective(gammas, betas):
        gammas = torch.as_tensor(gammas, dtype=torch.float32, device=device)
        betas = torch.as_tensor(betas, dtype=torch.float32, device=device)
        layers = [
            torch.cat(
                [
                    (-gammas[layer]).expand(n_edges),
                    (2.0 * betas[layer]).expand(num_qubits),
                ]
            )
            for layer in range(depth)
        ]
        return expect_h(torch.cat(layers))

    return objective


def maxcut_expectation(sim, edges: Sequence[tuple[int, int]]) -> float:
    """<C> = sum over edges of (1 - <Z_a Z_b>) / 2 on the simulator's state."""
    total = 0.0
    n = sim.num_qubits
    for a, b in edges:
        zz = ["I"] * n
        zz[n - 1 - a] = "Z"
        zz[n - 1 - b] = "Z"
        total += 0.5 * (1.0 - sim.expectation_pauli("".join(zz)))
    return total


def phase_estimation_circuit(phase: float, num_ancilla: int) -> Circuit:
    """Textbook quantum phase estimation of U = P(2*pi*phase).

    Layout: qubit 0 is the eigenstate target (prepared |1>, the
    eigenvector of a phase gate with eigenvalue e^{2*pi*i*phase});
    qubits 1..num_ancilla form the readout register, ancilla j (qubit
    1+j) accumulating phase 2^j via controlled-P, followed by the
    inverse QFT on the register. Measuring the register yields
    k ~ round(phase * 2^m) with probability 1 when phase is dyadic and
    >= 4/pi^2 at the nearest k otherwise; decode with
    ``k / 2**num_ancilla`` where k is the register value read LSB-first
    from qubit 1 (``estimate_phase`` does both steps).

    Beyond the reference's factory set: exercises the cp ladder and a
    mapped inverse QFT (Circuit.inverse of the factory QFT) in one
    end-to-end algorithm with an exactly checkable output distribution.
    """
    from .circuit import Gate, qft_circuit

    if num_ancilla < 1:
        raise ValueError("phase estimation needs at least one ancilla")
    m = num_ancilla
    c = Circuit(m + 1)
    c.x(0)                          # |1> eigenstate of the phase gate
    for j in range(m):
        c.h(1 + j)
    for j in range(m):
        # controlled-U^(2^j): one cp with the composed angle
        c.cp(1 + j, 0, (2.0 * math.pi * phase) * (1 << j))
    # inverse QFT on the readout register: invert the factory QFT and
    # shift its qubit ids onto ancillas 1..m (ancilla j = bit j)
    for g in qft_circuit(m).inverse().gates:
        c.append(Gate(g.name, tuple(q + 1 for q in g.qubits), g.param))
    return c


def trotter_circuit(
    terms: Sequence[tuple[float, str]],
    time: float,
    steps: int,
    num_qubits: int | None = None,
    order: int = 1,
) -> Circuit:
    """First- or second-order Trotter circuit for H = sum_j c_j P_j.

    ``order=2`` is the symmetric Suzuki splitting: each step applies the
    term exponentials at dt/2 forward then in reverse order at dt/2,
    cutting the error from O(t^2/steps) to O(t^3/steps^2). The
    palindrome junction (the last term, which would appear twice
    back-to-back at dt/2) is merged into one full-dt exponential, so
    the gate count is ~2x order 1 for many terms and exactly equal for
    a single term (where both orders are exact).

    ``terms`` are (coefficient, Pauli string) pairs read like kets — the
    rightmost character acts on qubit 0, matching
    ``expectation_pauli``/``build_expectation_fn``. The circuit
    approximates e^{-iHt} as (prod_j e^{-i c_j P_j t/steps})^steps, each
    exponential the standard basis-change + CNOT parity ladder + Rz:
    X-axes conjugate by H, Y-axes by S·H (Y = S H Z H S-dagger), the
    folded parity takes Rz(2 c dt). Identity terms contribute only a
    global phase and are skipped (amplitude comparisons against exact
    evolution must mod out e^{-i c_I t}).

    Single-term Hamiltonians (and mutually commuting term sets) are
    exact at any step count; non-commuting sums carry the usual
    O(t^2/steps) first-order error. Pair with ``build_expectation_fn``
    or ``expectation_pauli`` for observable dynamics.
    """
    from .base import parse_pauli as _parse_pauli_term

    if steps < 1:
        raise ValueError("steps must be >= 1")
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    parsed = []
    width = 0
    for coef, pauli in terms:
        involved = _parse_pauli_term(pauli, len(pauli))
        width = max(width, len(pauli))
        if involved:
            parsed.append((float(coef), involved))
    n = num_qubits if num_qubits is not None else max(width, 1)
    if width > n:
        raise ValueError(f"terms span {width} qubits > num_qubits={n}")

    c = Circuit(n)
    dt = time / steps

    def emit_term(coef, involved, frac):
        qs = [qq for qq, _ in involved]
        for qq, p in involved:              # rotate each axis onto Z
            if p == "X":
                c.h(qq)
            elif p == "Y":
                c.sdg(qq)
                c.h(qq)
        for a, b in zip(qs, qs[1:]):        # parity ladder onto the last
            c.cnot(a, b)
        c.rz(qs[-1], 2.0 * coef * dt * frac)
        for a, b in reversed(list(zip(qs, qs[1:]))):
            c.cnot(a, b)
        for qq, p in involved:
            if p == "X":
                c.h(qq)
            elif p == "Y":
                c.h(qq)
                c.s(qq)

    for _ in range(steps):
        if order == 1 or len(parsed) <= 1:
            for coef, involved in parsed:
                emit_term(coef, involved, 1.0)
        else:
            # symmetric sweep with the palindrome junction merged: the
            # last term's two adjacent dt/2 halves emit once at full dt
            for coef, involved in parsed[:-1]:
                emit_term(coef, involved, 0.5)
            emit_term(*parsed[-1], 1.0)
            for coef, involved in reversed(parsed[:-1]):
                emit_term(coef, involved, 0.5)
    return c


def tfim_hamiltonian(
    num_qubits: int, j: float = 1.0, h: float = 1.0
) -> list[tuple[float, str]]:
    """Transverse-field Ising chain (open boundary):
    H = -j * sum ZZ - h * sum X, as ``(coeff, pauli)`` terms compatible
    with ``build_expectation_fn``, ``trotter_circuit``, ``vqe_minimize``."""
    if num_qubits < 2:
        raise ValueError("TFIM needs at least 2 qubits")
    n = num_qubits
    terms = [
        (-j, "I" * (n - 2 - i) + "ZZ" + "I" * i) for i in range(n - 1)
    ]
    terms += [(-h, "I" * (n - 1 - i) + "X" + "I" * i) for i in range(n)]
    return terms


def heisenberg_hamiltonian(
    num_qubits: int,
    jx: float = 1.0,
    jy: float = 1.0,
    jz: float = 1.0,
) -> list[tuple[float, str]]:
    """XYZ Heisenberg chain (open boundary):
    H = sum_i (jx XX + jy YY + jz ZZ) on neighbors, as term pairs."""
    if num_qubits < 2:
        raise ValueError("Heisenberg chain needs at least 2 qubits")
    n = num_qubits
    terms: list[tuple[float, str]] = []
    for i in range(n - 1):
        for coef, p in ((jx, "XX"), (jy, "YY"), (jz, "ZZ")):
            if coef != 0.0:
                terms.append((coef, "I" * (n - 2 - i) + p + "I" * i))
    return terms


def vqe_minimize(
    hamiltonian: Sequence[tuple[float, str]],
    num_qubits: int,
    layers: int = 2,
    steps: int = 100,
    learning_rate: float = 0.1,
    seed: int = 0,
    device=None,
):
    """Variational ground-state search: hardware-efficient ansatz,
    reverse-mode gradients by ``torch.autograd`` and ``torch.optim.Adam``
    (one forward and one backward pass a step, no parameter-shift
    double execution).

    Returns ``(energy, params, history)``: the best energy found, its
    parameter vector (a detached tensor on ``device``), and the per-step
    energy trace. ``device=None`` means the CUDA card.
    """
    import torch

    from . import apply as ap
    from .circuit import hardware_efficient_ansatz
    from .statevector import build_expectation_fn

    device = ap.resolve_device(device)
    ansatz = hardware_efficient_ansatz(num_qubits, layers, seed=seed)
    energy_fn = build_expectation_fn(ansatz, list(hamiltonian), device=device)
    params = torch.tensor(
        ansatz.params(), dtype=torch.float32, device=device, requires_grad=True
    )
    opt = torch.optim.Adam([params], lr=learning_rate)

    history = []
    best_e, best_p = float("inf"), params.detach().clone()
    for _ in range(steps):
        opt.zero_grad()
        energy = energy_fn(params)
        energy.backward()
        e = float(energy.detach())
        history.append(e)
        if e < best_e:
            best_e, best_p = e, params.detach().clone()
        opt.step()
    return best_e, best_p, history


def classical_shadow(
    sim, num_snapshots: int, seed: int = 0, chunk: int = 512
):
    """Random-Pauli-basis classical shadow of the simulator's state.

    Each snapshot draws a per-qubit measurement basis (Z/X/Y), rotates the
    shared prepared state by the matching single-qubit unitaries (I, H,
    H S-dagger) and samples one computational-basis outcome. A chunk of
    snapshots runs as one (chunk, 2, 2^n) batch, each state with its own
    rotations, on the state's device; the draws come from a
    ``torch.Generator`` seeded with ``seed`` there. Returns
    ``(bases, outcomes)`` host arrays: bases[t, q] in {0: Z, 1: X, 2: Y},
    outcomes[t] the sampled basis index. Feed to
    :func:`shadow_expectation_pauli`.

    Memory: a chunk holds (chunk, 2, 2^n) planes (4.3 GB at 20 qubits and
    chunk 512); lower ``chunk`` for wider registers.
    """
    import numpy as np
    import torch

    from . import apply as ap
    from .base import inverse_cdf

    if num_snapshots < 1:
        raise ValueError("num_snapshots must be >= 1")
    if chunk < 1:
        raise ValueError("chunk must be >= 1")
    n = sim.num_qubits
    state = sim.state_planes
    gen = torch.Generator(device=state.device)
    gen.manual_seed(int(seed))
    # every draw before the first chunk, so the record does not depend on
    # the chunk size
    bases = torch.randint(0, 3, (num_snapshots, n), generator=gen, device=state.device)
    u = torch.rand(num_snapshots, 1, generator=gen, dtype=torch.float64, device=state.device)
    rot_r, rot_i = _shadow_rotation_planes(state.device, state.dtype)
    outcomes = []
    for i in range(0, num_snapshots, chunk):
        b = bases[i : i + chunk]
        s = state.expand((b.shape[0],) + tuple(state.shape))
        for qq in range(n):
            s = ap.apply_unitary(s, rot_r[b[:, qq]], rot_i[b[:, qq]], (qq,))
        probs = s[:, 0] ** 2 + s[:, 1] ** 2
        outcomes.append(inverse_cdf(probs, u[i : i + chunk])[:, 0])
        del s, probs
    return bases.cpu().numpy(), torch.cat(outcomes).cpu().numpy()


def shadow_reduced_density_matrix(shadow, qubits) -> "np.ndarray":
    """Reconstruct the reduced density matrix on ``qubits`` from a
    classical shadow: the snapshot average of
    ⊗_q (3 U_q† |b_q><b_q| U_q − I), the inverse-channel single-copy
    estimator. Index convention matches ``reduced_density_matrix``
    (reduced bit j = qubits[j]).

    A measurement-only counterpart of the exact on-device partial
    trace — converges as O(1/sqrt(num_snapshots)) and needs only the
    (bases, outcomes) record, not the state. The returned matrix is
    Hermitian with unit trace by construction but (at finite snapshots)
    not necessarily positive."""
    import numpy as np

    bases, outcomes = shadow
    bases = np.asarray(bases)
    outcomes = np.asarray(outcomes)
    n = bases.shape[1]
    qs = tuple(int(q) for q in qubits)
    for q in qs:
        if not (0 <= q < n):
            raise ValueError(f"qubit {q} out of range for {n}-qubit shadow")
    if len(set(qs)) != len(qs):
        raise ValueError("duplicate qubits in subset")
    if not (1 <= len(qs) <= 8):
        raise ValueError("shadow tomography supports 1..8 qubits")
    rot = _shadow_rotations()
    eye = np.eye(2)
    # per (basis, outcome-bit): 3 U† |b><b| U - I  (the 1q inverse channel)
    single = np.empty((3, 2, 2, 2), dtype=np.complex128)
    for basis in range(3):
        u = rot[basis]
        for bit in range(2):
            proj = np.outer(u.conj().T[:, bit], u[bit, :])
            single[basis, bit] = 3.0 * proj - eye
    # batched kron over snapshot chunks (bounded host memory: the full
    # (T, 2^k, 2^k) stack is 105 GB at k=8, T=1e5): reduced bit j =
    # qs[j], so qs[k-1] is the MSB factor; accumulate the running sum
    k = len(qs)
    total = np.zeros((1 << k, 1 << k), dtype=np.complex128)
    step = 4096
    for i in range(0, bases.shape[0], step):
        b = bases[i : i + step]
        o = outcomes[i : i + step]
        msb = qs[-1]
        acc = single[b[:, msb], (o >> msb) & 1]
        for qq in reversed(qs[:-1]):
            nxt = single[b[:, qq], (o >> qq) & 1]
            d = acc.shape[1]
            acc = np.einsum("tij,tkl->tikjl", acc, nxt).reshape(
                -1, d * 2, d * 2
            )
        total += acc.sum(axis=0)
    return total / bases.shape[0]


@functools.lru_cache(maxsize=1)
def _shadow_rotations():
    """Measurement-basis rotations (Z -> I, X -> H, Y -> H S†), built from
    the library's canonical gate constants — the ONE source of truth
    shared by the snapshot program and the inverse-channel decoder
    (any divergence would silently corrupt shadow estimates)."""
    import numpy as np

    from .gates import gate_matrix

    return (
        np.eye(2, dtype=np.complex128),
        gate_matrix("h"),
        gate_matrix("h") @ gate_matrix("sdg"),
    )


def _shadow_rotation_planes(device, dtype):
    """(3, 2, 2) real and imaginary planes of the basis rotations on
    ``device``."""
    import numpy as np
    import torch

    rot = np.stack(_shadow_rotations())
    return (
        torch.as_tensor(rot.real, dtype=dtype, device=device),
        torch.as_tensor(rot.imag, dtype=dtype, device=device),
    )


def shadow_expectation_pauli(shadow, pauli: str, groups: int = 1) -> float:
    """Estimate <P> from a classical shadow: per-snapshot inverse-channel
    value (3^|support| times the outcome sign when every support qubit
    was measured in P's basis, else 0), averaged — or median-of-means
    over ``groups`` when > 1 (the robust estimator of the shadow
    literature). Pauli convention matches ``expectation_pauli``
    (rightmost character = qubit 0)."""
    import numpy as np

    from .base import parse_pauli as _parse_pauli_term

    bases, outcomes = shadow
    num_snapshots = bases.shape[0]
    if not (1 <= groups <= num_snapshots):
        raise ValueError("groups must be in [1, num_snapshots]")
    ops = _parse_pauli_term(pauli, bases.shape[1])
    code = {"Z": 0, "X": 1, "Y": 2}
    vals = np.ones(num_snapshots)
    for qq, p in ops:
        match = bases[:, qq] == code[p]
        sign = 1 - 2 * ((outcomes >> qq) & 1)
        vals = vals * np.where(match, 3.0 * sign, 0.0)
    if groups == 1:
        return float(vals.mean())
    means = [float(g.mean()) for g in np.array_split(vals, groups)]
    return float(np.median(means))


def amplitude_estimation_circuit(
    num_state_qubits: int,
    marked: Sequence[int],
    num_ancilla: int,
) -> Circuit:
    """Canonical quantum amplitude estimation (quantum counting).

    Estimates a = |marked| / 2^n, the probability that a uniform
    superposition over ``num_state_qubits`` lands in ``marked``: QPE on
    the iterate Q = A·S0·A†·S_good (A = H^n) — this is −G for the
    Grover product G, so its eigenphases sit at 1/2 ± θ/π with
    a = sin²θ (see :func:`estimate_amplitude` for the resulting cos²
    decode). Layout: state qubits 0..n-1, readout ancillas n..n+m-1
    (ancilla j applies Q^(2^j)).

    Controlled-Q needs control only on the two reflections —
    c-(A·S0·A†·Sg) = A·(c-S0)·A†·(c-Sg) since A cancels when the
    reflections are identity — and both reflections are (X-conjugated)
    MCZs, so every controlled power is ancilla-free in this gate set
    (Circuit.mcz). Decode with :func:`estimate_amplitude`.
    """
    from .gates import MAX_MCZ_QUBITS

    n, m = num_state_qubits, num_ancilla
    if n < 1 or m < 1:
        raise ValueError("need at least one state qubit and one ancilla")
    if n + 1 > MAX_MCZ_QUBITS:
        raise ValueError(
            "amplitude estimation reflections need an (n+1)-qubit MCZ: "
            f"num_state_qubits <= {MAX_MCZ_QUBITS - 1}, got {n}"
        )
    marked = sorted(set(marked))
    if marked and not (0 <= marked[0] and marked[-1] < (1 << n)):
        raise ValueError("marked state out of range")

    from .circuit import Gate, qft_circuit

    c = Circuit(n + m)
    state = list(range(n))
    for q in state:
        c.h(q)
    for j in range(m):
        c.h(n + j)

    def flip_state(ctrl: int, basis: int) -> None:
        # phase-flip |basis> on the state register, controlled on ctrl:
        # X-conjugate an (n+1)-qubit MCZ so the all-ones pattern matches
        for q in state:
            if not ((basis >> q) & 1):
                c.x(q)
        c.mcz(ctrl, *state)
        for q in state:
            if not ((basis >> q) & 1):
                c.x(q)

    for j in range(m):
        anc = n + j
        for _ in range(1 << j):       # Q^(2^j) controlled on ancilla j
            for b in marked:          # c-S_good: flip each marked state
                flip_state(anc, b)
            for q in state:           # A† = H^n
                c.h(q)
            flip_state(anc, 0)        # c-S0 (global-phase-free reflection)
            for q in state:           # A
                c.h(q)
    for g in qft_circuit(m).inverse().gates:
        c.append(Gate(g.name, tuple(q + n for q in g.qubits), g.param))
    return c


def estimate_amplitude(
    probabilities, num_state_qubits: int, num_ancilla: int
) -> float:
    """Decode an amplitude-estimation run: argmax over the readout
    register's marginal -> a = cos²(π k / 2^m).

    cos², not the textbook sin²: the circuit's iterate A·S0·A†·S_good
    is −G (G = the Grover diffusion–oracle product), and the global −1
    becomes a *relative* phase under control, shifting every eigenphase
    by 1/2 — θ = π·(k/2^m − 1/2) up to conjugation, so
    sin²θ = cos²(πk/2^m). The conjugate peak 2^m−k decodes to the same
    value, so either maximizer works (verified numerically at a = 0,
    1/8, 1/4, 1/2, 1)."""
    import numpy as np

    n, m = num_state_qubits, num_ancilla
    marg = np.asarray(probabilities).reshape(1 << m, 1 << n).sum(axis=1)
    best_k = int(marg.argmax())
    return math.cos(math.pi * best_k / (1 << m)) ** 2


def estimate_phase(probabilities, num_ancilla: int) -> float:
    """Decode a phase-estimation run: argmax over the readout register's
    marginal distribution -> k / 2^m. ``probabilities`` is the full
    (2^(m+1),) distribution from ``get_probabilities`` (target qubit 0
    is traced out by summing its two values per register assignment)."""
    import numpy as np

    m = num_ancilla
    marg = np.asarray(probabilities).reshape(1 << m, 2).sum(axis=1)
    return int(marg.argmax()) / float(1 << m)
