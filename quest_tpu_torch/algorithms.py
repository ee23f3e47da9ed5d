"""Standard quantum algorithms as :class:`~quest_tpu_torch.circuits.Circuit`
builders.

Counterpart of the JAX package's ``algorithms.py``, on the port's
``Circuit``. The reference ships these as user programs
(`examples/tutorial_example.c`, `examples/bernstein_vazirani_circuit.c`) and
as algorithm-level tests (`tests/algor/QFT.test`); here they are library
functions producing whole-circuit programs, which ``Circuit.compile`` plans
into fused layers like any other. They are also the workloads of the
BASELINE.json configs (QFT-30, Grover-30, random Clifford+T circuits).
"""

from __future__ import annotations

import numpy as np

from .circuits import Circuit

__all__ = [
    "qft",
    "inverse_qft",
    "grover",
    "bernstein_vazirani",
    "ghz",
    "random_circuit",
    "phase_estimation",
    "trotter_evolution",
    "modular_multiplication_unitary",
    "order_finding",
    "order_from_phase",
    "qaoa_maxcut",
    "qaoa_maxcut_terms",
]


def _append_qft(c: Circuit, qubits, inverse: bool = False,
                swap_order: bool = True) -> None:
    """Emit the QFT gate ladder onto ``qubits`` of an existing circuit
    (single source of the gate ordering/angle convention, shared by
    :func:`qft` and :func:`phase_estimation`)."""
    qubits = list(qubits)
    nq = len(qubits)
    ops = []
    for i in range(nq - 1, -1, -1):
        ops.append(("h", qubits[i], None, None))
        for k, j in enumerate(range(i - 1, -1, -1), start=2):
            ops.append(("cphase", qubits[j], qubits[i],
                        2.0 * np.pi / (1 << k)))
    if swap_order:
        for i in range(nq // 2):
            ops.append(("swap", qubits[i], qubits[nq - 1 - i], None))
    if inverse:
        # h and swap are self-inverse; cphase inverts by angle negation
        ops = [(o[0], o[1], o[2], -o[3] if o[0] == "cphase" else None)
               for o in reversed(ops)]
    for kind, a, b, angle in ops:
        if kind == "h":
            c.h(a)
        elif kind == "swap":
            c.swap(a, b)
        else:
            c.cphase(a, b, angle)


def qft(num_qubits: int, swap_order: bool = True) -> Circuit:
    """Quantum Fourier transform (the reference's `tests/algor/QFT.test`
    workload): H + controlled phase ladder, optional bit-reversal swaps."""
    c = Circuit(num_qubits)
    _append_qft(c, range(num_qubits), swap_order=swap_order)
    return c


def inverse_qft(num_qubits: int, swap_order: bool = True) -> Circuit:
    return qft(num_qubits, swap_order).inverse()


def grover(num_qubits: int, marked: int,
           num_iterations: int | None = None) -> Circuit:
    """Grover search for basis state ``marked``: uniform superposition, then
    round(pi/4 sqrt(2^n)) iterations of oracle + diffusion. The oracle is a
    multi-controlled phase flip with flipped controls on the 0-bits of
    ``marked``; diffusion is H^n · (2|0><0| - 1) · H^n."""
    n = num_qubits
    if not 0 <= marked < (1 << n):
        raise ValueError(f"marked state {marked} out of range [0, {1 << n})")
    if num_iterations is None:
        num_iterations = max(1, int(round(np.pi / 4.0 * np.sqrt(1 << n))))
    c = Circuit(n)
    for q in range(n):
        c.h(q)

    def phase_on(index: int):
        """-1 phase on exactly |index>: a 1-qubit phase conditioned on every
        other qubit being at its bit of ``index`` — O(1) memory at any n
        (the reference's multiControlledPhaseFlip with flipped controls)."""
        target_diag = np.array([1.0, -1.0]) if (index >> (n - 1)) & 1 \
            else np.array([-1.0, 1.0])
        controls = tuple(range(n - 1))
        states = tuple((index >> q) & 1 for q in controls)
        c.gate(np.diag(target_diag), (n - 1,), controls, states)

    for _ in range(num_iterations):
        phase_on(marked)
        for q in range(n):
            c.h(q)
        phase_on(0)
        for q in range(n):
            c.h(q)
    return c


def bernstein_vazirani(num_qubits: int, secret: int) -> Circuit:
    """Phase-oracle Bernstein–Vazirani (one query recovers ``secret``), the
    workload of `examples/bernstein_vazirani_circuit.c`: H^n, Z on secret
    bits, H^n — final state = |secret>."""
    c = Circuit(num_qubits)
    for q in range(num_qubits):
        c.h(q)
    for q in range(num_qubits):
        if (secret >> q) & 1:
            c.z(q)
    for q in range(num_qubits):
        c.h(q)
    return c


def ghz(num_qubits: int) -> Circuit:
    c = Circuit(num_qubits)
    c.h(0)
    for q in range(1, num_qubits):
        c.cnot(q - 1, q)
    return c


def random_circuit(num_qubits: int, depth: int, seed: int = 0,
                   gate_set: str = "clifford+t") -> Circuit:
    """Layered random circuit (the BASELINE.json "20-qubit random Clifford+T"
    / "34–38 qubit random circuit" configs): each layer applies a random
    1-qubit gate to every qubit then entangles a random brickwork pairing."""
    rng = np.random.default_rng(seed)
    c = Circuit(num_qubits)
    if gate_set == "clifford+t":
        one_q = ("h", "s", "t", "x", "y", "z")
    elif gate_set == "haar":
        one_q = ("rot",)
    else:
        raise ValueError(f"unknown gate_set {gate_set!r}")
    for _ in range(depth):
        for q in range(num_qubits):
            g = one_q[rng.integers(len(one_q))]
            if g == "rot":
                axis = rng.normal(size=3)
                c.rotate(q, float(rng.uniform(0, 2 * np.pi)), axis)
            else:
                getattr(c, g)(q)
        offset = int(rng.integers(2))
        for q in range(offset, num_qubits - 1, 2):
            if rng.uniform() < 0.5:
                c.cnot(q, q + 1)
            else:
                c.cz(q, q + 1)
    return c


def phase_estimation(num_counting: int, unitary: np.ndarray,
                     num_target: int | None = None) -> Circuit:
    """Quantum phase estimation: ``num_counting`` counting qubits estimate
    the eigenphase of ``unitary`` applied to the high ``num_target`` qubits.

    Layout: qubits ``[0, num_counting)`` are the counting register (the
    estimate ends up bit-reversed-free after the inverse QFT with swaps);
    qubits ``[num_counting, num_counting+num_target)`` hold the eigenstate,
    which the caller prepares before running. Controlled powers ``U^(2^j)``
    are formed by repeated host-side squaring (exact for the matrix sizes
    QPE uses) and applied through the engine's controlled dense path. No
    reference counterpart.
    """
    u = np.asarray(unitary, dtype=np.complex128)
    k = int(np.log2(u.shape[0]))
    if num_target is None:
        num_target = k
    if u.shape != (1 << num_target, 1 << num_target):
        raise ValueError("unitary dimension does not match num_target")
    n = num_counting + num_target
    targets = tuple(range(num_counting, n))
    c = Circuit(n)
    for q in range(num_counting):
        c.h(q)
    u_pow = u
    for j in range(num_counting):
        c.gate(u_pow, targets, controls=(j,))
        u_pow = u_pow @ u_pow
    # inverse QFT on the counting register (phases accumulate as
    # |x> -> e^{2 pi i phi x}, little-endian in counting qubit index)
    _append_qft(c, range(num_counting), inverse=True)
    return c


def trotter_evolution(num_qubits: int, pauli_terms, coeffs, time: float,
                      num_steps: int, order: int = 1) -> Circuit:
    """First- or second-order Trotterised ``exp(-i H t)`` for
    ``H = sum_j coeffs[j] * P_j`` (each ``pauli_terms[j]`` a sequence of
    ``(qubit, code)`` with codes 1=X, 2=Y, 3=Z).

    Each Pauli-product exponential is basis-rotated to Z...Z, applied as a
    parity-phase diagonal (the ``multiRotateZ`` machinery), and rotated
    back: the gate form of :meth:`~quest_tpu_torch.circuits.
    CompiledCircuit.evolve_sweep`, in the same term order. No reference
    counterpart (the reference offers only ``multiRotatePauli`` as the
    single-term primitive).
    """
    terms = []
    for t in pauli_terms:
        term = tuple((int(q), int(code)) for q, code in t
                     if int(code) != 0)      # identity factors drop out
        for q, code in term:
            if code not in (1, 2, 3):
                raise ValueError(f"invalid Pauli code {code} "
                                 "(0=I, 1=X, 2=Y, 3=Z)")
        if not term:
            raise ValueError(
                "an all-identity Pauli term contributes only a global "
                "phase, which a gate circuit cannot represent; fold it "
                "into the observable instead")
        terms.append(term)
    coeffs = [float(x) for x in coeffs]
    if len(terms) != len(coeffs):
        raise ValueError("one coefficient per Pauli term is required")
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    if order not in (1, 2):
        raise ValueError("order must be 1 or 2")
    c = Circuit(num_qubits)

    def apply_term(term, angle):
        if not term:
            return                      # identity term: global phase only
        qubits = [q for q, _ in term]
        # basis rotation: X -> H, Y -> Rx(pi/2), Z -> nothing
        for q, code in term:
            if code == 1:
                c.h(q)
            elif code == 2:
                c.rx(q, np.pi / 2.0)
        c.multi_rotate_z(qubits, angle)
        for q, code in term:
            if code == 1:
                c.h(q)
            elif code == 2:
                c.rx(q, -np.pi / 2.0)

    dt = time / num_steps
    for _ in range(num_steps):
        if order == 1:
            for term, w in zip(terms, coeffs):
                apply_term(term, 2.0 * w * dt)
        else:
            for term, w in zip(terms, coeffs):
                apply_term(term, w * dt)
            for term, w in zip(reversed(terms), reversed(coeffs)):
                apply_term(term, w * dt)
    return c


def modular_multiplication_unitary(a: int, modulus: int,
                                   num_bits: int | None = None) -> np.ndarray:
    """Permutation matrix ``U|y> = |a*y mod modulus>`` (identity for
    ``y >= modulus``) — the arithmetic primitive of Shor order finding.

    Requires ``gcd(a, modulus) == 1`` so the map is a bijection (else it
    is not unitary). ``num_bits`` defaults to ``modulus.bit_length()``.
    """
    import math
    if modulus < 2:
        raise ValueError("modulus must be >= 2")
    a %= modulus
    if math.gcd(a, modulus) != 1:
        raise ValueError(f"gcd({a}, {modulus}) != 1: the modular "
                         "multiplication map is not a permutation")
    if num_bits is None:
        num_bits = modulus.bit_length()
    if (1 << num_bits) < modulus:
        raise ValueError(f"{num_bits} bits cannot hold values mod {modulus}")
    dim = 1 << num_bits
    u = np.zeros((dim, dim), dtype=np.complex128)
    for y in range(dim):
        u[(a * y) % modulus if y < modulus else y, y] = 1.0
    return u


def order_finding(a: int, modulus: int,
                  num_counting: int | None = None) -> Circuit:
    """Shor order finding: QPE over ``U_a`` with eigenstate register |1>.

    Layout: counting qubits ``[0, num_counting)`` (default ``2 *
    modulus.bit_length()``), work register above holding ``|1>`` — an
    equal superposition of the order-r eigenstates of ``U_a``, so the
    measured counting value concentrates on multiples of ``2^nc / r``.
    Feed the measured integer to :func:`order_from_phase`. Controlled
    powers ``U^(2^j)`` come from the shared QPE builder (host-side
    squaring of the permutation matrix — exact, it stays a permutation).
    """
    k = modulus.bit_length()
    if num_counting is None:
        num_counting = 2 * k
    u = modular_multiplication_unitary(a, modulus, k)
    c = Circuit(num_counting + k)
    c.x(num_counting)                      # work register |0..01> = |1>
    return c.extend(phase_estimation(num_counting, u))


def order_from_phase(measured: int, num_counting: int, modulus: int) -> int:
    """Classical post-processing: continued-fraction expansion of the
    measured phase ``measured / 2^num_counting`` with denominator capped
    at ``modulus`` — the order candidate (verify ``a^r = 1 mod N``; re-run
    on failure, as Shor's algorithm prescribes)."""
    from fractions import Fraction
    if not 0 <= measured < (1 << num_counting):
        raise ValueError("measured value outside the counting register")
    if measured == 0:
        return 1
    frac = Fraction(measured, 1 << num_counting).limit_denominator(modulus)
    return frac.denominator


def qaoa_maxcut(num_qubits: int, edges, num_layers: int) -> Circuit:
    """QAOA ansatz for MaxCut on the graph ``edges`` (iterable of
    ``(u, v)`` pairs): uniform superposition, then ``num_layers`` rounds
    of cost phases ``exp(-i gamma_l Z_u Z_v / 2)`` per edge and mixer
    rotations ``Rx(beta_l)`` on every qubit.

    Parameters are registered as ``gamma0..`` / ``beta0..`` — bind them
    at run time and optimise with ``CompiledCircuit.expectation_fn`` (its
    ``.backward()`` is the adjoint walk) or ``value_and_grad_sweep`` over
    the cut Hamiltonian (see :func:`qaoa_maxcut_terms`). The cost phases
    are diagonals (the `multiRotateZ` machinery).
    """
    edges = [(int(u), int(v)) for u, v in edges]
    for u, v in edges:
        if not (0 <= u < num_qubits and 0 <= v < num_qubits) or u == v:
            raise ValueError(f"bad edge ({u}, {v})")
    if num_layers < 1:
        raise ValueError("num_layers must be >= 1")
    c = Circuit(num_qubits)
    for q in range(num_qubits):
        c.h(q)
    for layer in range(num_layers):
        gamma = c.parameter(f"gamma{layer}")
        beta = c.parameter(f"beta{layer}")
        for u, v in edges:
            c.multi_rotate_z([u, v], gamma)
        for q in range(num_qubits):
            c.rx(q, beta)
    return c


def qaoa_maxcut_terms(edges):
    """(pauli_terms, coeffs) of the MaxCut cost ``C = sum_{(u,v)}
    (1 - Z_u Z_v) / 2`` **dropping the constant** |E|/2 term — feed to
    ``CompiledCircuit.expectation_fn`` and MINIMISE (the expectation is
    then -cut_size + |E|/2, so its minimum is the maximum cut)."""
    terms = [[(int(u), 3), (int(v), 3)] for u, v in edges]
    coeffs = [0.5] * len(terms)
    return terms, coeffs
