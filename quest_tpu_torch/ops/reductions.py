"""Compensated reductions for single-precision accuracy parity.

Counterpart of the compensated half of the JAX package's
``ops/reductions.py`` (the reference's Kahan summation,
``QuEST_cpu_distributed.c:87-109``): the ``calc*`` functions use these at
SINGLE precision, where a naive float32 reduction falls ~5 decades short of
the reference's 1e-10 scalar tolerance.

1. **TwoSum cascade** (:func:`sum_pair`): log2(n) halving levels; each level
   recovers the exact rounding error of every pairwise add into a
   correction stream.
2. **Veltkamp split products** (:func:`_split`, :func:`dot_pair`): a*b is
   four exactly representable partial products, so dot products accumulate
   true products, not rounded ones.
3. **Pair return**: the final (sum, err) pair comes back unadded and the
   API layer combines it in host double precision.

PyTorch runs eagerly, so where XLA fused the four product streams away
these functions would materialise them: :func:`dot_pair` walks its input
in chunks (``_CHUNK`` elements) and combines the chunk pairs with one more
TwoSum cascade. The pairing tree differs from the JAX package's; both are
error-free transformations, so the totals agree to the compensated
accuracy, not bit for bit.

The Pauli-sum reductions (``calcExpecPauliSum`` on state vectors and
density registers, the batched engine's ``expectation_sweep``, the
trajectory waves), the Pauli-sum application (``applyPauliSum``, the
adjoint walk's cotangent ``H psi``) and the running (count, mean,
M2) statistics of the trajectory convergence loop follow the JAX package's
``ops/reductions.py`` below.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["sum_compensated", "sum_pair", "dot_pair", "dot_pair_rows",
           "vdot_pair",
           "vdot_compensated", "pauli_masks", "pauli_term_bucket",
           "pauli_sum_operands", "validated_pauli_terms",
           "pauli_terms_operands", "pauli_sum_expvals_sv",
           "pauli_sum_total_sv", "pauli_sum_apply", "pauli_apply_sv",
           "pauli_sum_apply_sv", "pauli_sum_expvals_dm",
           "pauli_sum_total_dm", "welford_wave", "welford_merge",
           "score_surrogate", "welford_stderr"]

# elements of each dot_pair input processed per step: the four product
# streams and the cascade's first level then take 6 * 2^24 values, a few
# hundred MiB at float32, whatever the register size
_CHUNK = 1 << 24
# amplitudes of each row chunk of the compensated Pauli terms: the four
# product streams of a chunk then hold 8 * 2^26 values, 2 GiB at float32
_ROWS_AMPS = 1 << 26


def _two_sum(a, b):
    """Knuth TwoSum: s = fl(a+b) and the exact rounding error e
    (a + b == s + e in exact arithmetic). Branch-free."""
    s = a + b
    b_virtual = s - a
    a_virtual = s - b_virtual
    e = (a - a_virtual) + (b - b_virtual)
    return s, e


def _split(x):
    """Veltkamp split: x == hi + lo with hi, lo each carrying at most half
    of the significand bits, so pairwise products of pieces are exact."""
    bits = 12 if x.dtype == torch.float32 else 27
    c = x * float((1 << bits) + 1)
    hi = c - (c - x)
    return hi, x - hi


def _sum_pair_rows(x):
    """Compensated sum of every row of a real ``(R, M)`` tensor: the
    unadded ``(R,)`` sums and errors."""
    err = x.new_zeros(x.shape[0])
    while x.shape[1] > 1:
        if x.shape[1] % 2:
            x = torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)
        s, e = _two_sum(x[:, 0::2], x[:, 1::2])
        # the e's are O(eps)·|s| each; their naive sum contributes only a
        # second-order O(eps²·n) error to the final result
        err = err + e.sum(1)
        x = s
    return x[:, 0], err


def sum_pair(x):
    """Compensated sum of a real tensor; returns the unadded (sum, err)
    pair of 0-dim tensors so callers can combine at higher precision."""
    s, e = _sum_pair_rows(x.reshape(1, -1))
    return s[0], e[0]


def sum_compensated(x) -> torch.Tensor:
    """Compensated sum of a real tensor."""
    s, e = sum_pair(x)
    return s + e


def dot_pair_rows(a, b):
    """sum(a*b) over every row of two real ``(R, M)`` tensors with exact
    partial products: ``(R,)`` (sum, err) pairs."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return _sum_pair_rows(torch.cat([a_hi * b_hi, a_hi * b_lo,
                                     a_lo * b_hi, a_lo * b_lo], dim=1))


def dot_pair(a, b):
    """sum(a*b) for real tensors with exact partial products: returns the
    (sum, err) pair."""
    a = a.reshape(1, -1)
    b = b.reshape(1, -1)
    sums, errs = [], []
    for lo in range(0, a.shape[1], _CHUNK):
        s, e = dot_pair_rows(a[:, lo:lo + _CHUNK], b[:, lo:lo + _CHUNK])
        sums.append(s[0])
        errs.append(e[0])
    if len(sums) == 1:
        return sums[0], errs[0]
    s, e = sum_pair(torch.stack(sums))
    return s, e + torch.stack(errs).sum()


def vdot_pair(a_planes, b_planes):
    """<a|b> for states given as (2, ...) re/im planes; returns
    ((re, re_err), (im, im_err))."""
    ar, ai = a_planes[0], a_planes[1]
    br, bi = b_planes[0], b_planes[1]
    re_s1, re_e1 = dot_pair(ar, br)
    re_s2, re_e2 = dot_pair(ai, bi)
    im_s1, im_e1 = dot_pair(ar, bi)
    im_s2, im_e2 = dot_pair(ai, br)
    re, re_c = _two_sum(re_s1, re_s2)
    im, im_c = _two_sum(im_s1, -im_s2)
    return (re, re_c + re_e1 + re_e2), (im, im_c + im_e1 - im_e2)


def vdot_compensated(a_planes, b_planes) -> complex:
    """<a|b> with compensated accumulation, combined in host double
    precision."""
    (re, re_e), (im, im_e) = vdot_pair(a_planes, b_planes)
    return complex(float(re) + float(re_e), float(im) + float(im_e))


# ---------------------------------------------------------------------------
# Pauli sums as bit masks
# ---------------------------------------------------------------------------
#
# A Pauli string P = i^|y| X^x Z^(y|z) acts on a basis state by one xor and
# one sign: (P z)[k] = i^popcount(y) (-1)^popcount(j & (y|z)) z[j] with
# j = k ^ (x|y). So <z|P|z> is one gather, one sign and one reduce per
# term: no gate applications and no per-term workspace state.


def pauli_masks(codes_flat, num_qubits: int):
    """Flat pauli codes (term-major, code of qubit q of term t at
    ``codes_flat[t*n + q]``; 0=I 1=X 2=Y 3=Z) -> (xmask, ymask, zmask)
    int64 arrays of shape ``(num_terms,)``. Host-side."""
    codes = np.asarray(codes_flat, dtype=np.int64).reshape(-1, num_qubits)
    bits = np.int64(1) << np.arange(num_qubits, dtype=np.int64)
    return ((codes == 1) @ bits, (codes == 2) @ bits, (codes == 3) @ bits)


def pauli_term_bucket(num_terms: int) -> int:
    """Term-count bucket: next power of two at or above (floor 8). Padding
    terms are all-identity with coefficient zero (their expectation, the
    state norm, is multiplied away exactly)."""
    b = 8
    while b < num_terms:
        b <<= 1
    return b


def pauli_sum_operands(codes_flat, num_qubits: int, coeffs):
    """The operand set of a Pauli-sum reduction: masks from
    :func:`pauli_masks`, term count padded to :func:`pauli_term_bucket`
    with zero-coefficient identity terms. ONE encoder for every consumer,
    so the mask convention cannot desynchronise between call sites.
    Returns ``(xmask, ymask, zmask, coeffs)`` numpy arrays of the bucketed
    length."""
    xm, ym, zm = pauli_masks(codes_flat, num_qubits)
    num_terms = xm.shape[0]
    bucket = pauli_term_bucket(num_terms)
    coeffs = np.pad(np.asarray(coeffs, dtype=np.float64)[:num_terms],
                    (0, bucket - num_terms))
    if bucket > num_terms:
        xm, ym, zm = (np.pad(m, (0, bucket - num_terms))
                      for m in (xm, ym, zm))
    return xm, ym, zm, coeffs


def validated_pauli_terms(pauli_terms, coeffs, num_qubits: int):
    """``(terms, coeffs)`` of a Hamiltonian given as ``(qubit, code)`` pair
    lists, with identity factors dropped AFTER validation (a malformed
    ``(qubit, 0)`` pair still errors)."""
    for t in pauli_terms:
        for q, code in t:
            if not 0 <= int(q) < num_qubits:
                raise ValueError(
                    f"pauli qubit {q} out of range [0, {num_qubits})")
            if int(code) not in (0, 1, 2, 3):
                raise ValueError(f"invalid pauli code {code}")
    terms = [tuple((int(q), int(c)) for q, c in t if int(c) != 0)
             for t in pauli_terms]
    coeffs = np.asarray(coeffs, dtype=np.float64)
    if len(coeffs) != len(terms):
        raise ValueError(f"{len(terms)} pauli terms but {len(coeffs)} "
                         "coefficients")
    return terms, coeffs


def pauli_terms_operands(terms, coeffs, num_qubits: int):
    """Validated ``(qubit, code)`` terms -> the operands of
    :func:`pauli_sum_operands`; no terms at all is one zero-coefficient
    identity term."""
    codes = np.zeros((max(len(terms), 1), num_qubits), np.int64)
    for t, term in enumerate(terms):
        for q, code in term:
            if codes[t, q]:
                raise ValueError(
                    f"pauli term {t} repeats qubit {q} (a product of Paulis "
                    "on one qubit is not a Pauli string)")
            codes[t, q] = code
    coeffs = np.asarray(coeffs, dtype=np.float64) if terms \
        else np.zeros((1,), np.float64)
    return pauli_sum_operands(codes.reshape(-1), num_qubits, coeffs)


def _parity(v: torch.Tensor) -> torch.Tensor:
    """popcount(v) & 1 of a non-negative int64 tensor (xor folding)."""
    for shift in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> shift)
    return v & 1


def _sign_vector(yz: int, xy: int, num_amps: int, dtype,
                 device) -> torch.Tensor:
    """``(-1)^popcount(j & yz)`` with ``j = k ^ xy``, for every ``k <
    num_amps``: ``(-1)^popcount(xy & yz)`` times ``(-1)^popcount(k & yz)``,
    the latter built by doubling up to ``yz``'s top bit and tiled (no
    integer pass over the amplitudes)."""
    s = torch.ones(1, dtype=dtype, device=device)
    for q in range(yz.bit_length()):
        s = torch.cat([s, -s if (yz >> q) & 1 else s])
    if bin(xy & yz).count("1") % 2:
        s = -s
    return s.repeat(num_amps // s.shape[0])


# runs of set bits of an xor mask that one flip takes (each run and each
# gap between runs is an axis of the view; torch caps a view at 25 axes)
_FLIP_RUNS = 10


def _xor_gather(states: torch.Tensor, xy: int) -> torch.Tensor:
    """``states[..., k ^ xy]`` as a fresh tensor: one ``torch.flip`` of a
    view whose axes are the runs of equal bits of ``xy``, high to low
    (xor-ing a run of bits with ones reverses it), or an ``index_select``
    for a mask of more than ``_FLIP_RUNS`` runs."""
    num_amps = states.shape[-1]
    sizes, flip = [], []
    q = num_amps.bit_length() - 1
    while q > 0:
        bit, top = (xy >> (q - 1)) & 1, q
        while q > 0 and (xy >> (q - 1)) & 1 == bit:
            q -= 1
        if bit:
            flip.append(states.dim() - 1 + len(sizes))
        sizes.append(1 << (top - q))
    if len(flip) > _FLIP_RUNS:
        idx = torch.arange(num_amps, device=states.device) ^ xy
        return states.index_select(-1, idx)
    view = states.reshape(*states.shape[:-1], *sizes)
    return torch.flip(view, flip).reshape(states.shape)


def pauli_sum_expvals_sv(states: torch.Tensor, xmask, ymask, zmask,
                         compensated: bool = False) -> torch.Tensor:
    """Per-term ``<z_b|P_t|z_b>`` for a ``(B, 2, N)`` batch of planes and
    host mask arrays of shape ``(T,)``: a real ``(B, T)`` tensor on the
    states' device. The terms run one after another, so the scratch is one
    state batch whatever the term count; each term is one xor-gather pass
    over the batch. A term whose ``i^|y|`` is real needs only the real
    part of the sum, one whose ``i^|y|`` is imaginary only the imaginary
    part (the value of a Hermitian string is real).

    ``compensated=True`` (the SINGLE tier's observables) accumulates each
    term through :func:`dot_pair_rows` instead of a naive reduce: exact
    partial products and a TwoSum cascade, combined once in the plane
    dtype. It walks the batch in chunks of rows so its temporaries (the
    gathered rows, the Veltkamp pieces, the four product streams) stay a
    few GiB whatever the batch: a 24-qubit batch of 64 would otherwise
    make 8 GiB per gathered term and 4 GiB per temporary."""
    num_amps = states.shape[-1]
    rows = max(1, _ROWS_AMPS // num_amps)
    out = []
    for xm, ym, zm in zip(xmask, ymask, zmask):
        xy, yz = int(xm) | int(ym), int(ym) | int(zm)
        # sign(j) = (-1)^parity(j & yz) with j = k ^ xy
        sign = _sign_vector(yz, xy, num_amps, states.dtype, states.device)
        ph = bin(int(ym)).count("1") % 4
        if compensated:
            acc = torch.cat([_term_compensated(states[r:r + rows], xy,
                                               sign, ph % 2)
                             for r in range(0, states.shape[0], rows)])
        else:
            zj = _xor_gather(states, xy) if xy else states
            if ph % 2 == 0:
                # Re sum conj(z) z[j] sign = sum (zr zjr + zi zji) sign
                part = (states * zj).sum(1)
            else:
                # Im sum conj(z) z[j] sign = sum (zr zji - zi zjr) sign
                part = states[:, 0] * zj[:, 1] - states[:, 1] * zj[:, 0]
            acc = torch.matmul(part, sign)
        # i^|y| times the real (ph even) or i times the imaginary part
        out.append(acc if ph in (0, 3) else -acc)
    return torch.stack(out, dim=1)



def _term_compensated(states, xy: int, sign, imag: int):
    """One Pauli term's compensated real (``imag == 0``) or imaginary part
    of ``sum conj(z) z[j] sign`` for each row of a ``(R, 2, N)`` chunk, as
    one :func:`dot_pair_rows` over the stacked planes."""
    zj = _xor_gather(states, xy) if xy else states
    zjs = zj * sign
    if imag:
        # zr zji - zi zjr: negation is exact
        a = torch.cat([states[:, 0], -states[:, 1]], dim=1)
        b = torch.cat([zjs[:, 1], zjs[:, 0]], dim=1)
    else:
        a = states.reshape(states.shape[0], -1)
        b = zjs.reshape(states.shape[0], -1)
    s, e = dot_pair_rows(a, b)
    return s + e


def pauli_sum_total_sv(states: torch.Tensor, xmask, ymask, zmask,
                       coeffs, compensated: bool = False) -> torch.Tensor:
    """``sum_t coeffs[t] * <z_b|P_t|z_b>`` for each state of a ``(B, 2,
    N)`` batch: a ``(B,)`` tensor, on the device. ``compensated`` as in
    :func:`pauli_sum_expvals_sv`."""
    vals = pauli_sum_expvals_sv(states, xmask, ymask, zmask, compensated)
    cf = torch.as_tensor(np.asarray(coeffs, dtype=np.float64),
                         dtype=vals.dtype, device=vals.device)
    return (vals * cf).sum(-1)


# (source plane, sign) of the output's real and imaginary plane for a
# factor i^ph times (re + i im), ph = 0..3
_PHASE_PLANES = (((0, 1.0), (1, 1.0)), ((1, -1.0), (0, 1.0)),
                 ((0, -1.0), (1, -1.0)), ((1, 1.0), (0, -1.0)))


def pauli_term_gather(states: torch.Tensor, xm, ym, zm):
    """One Pauli string's action split in two: ``(gathered, ph)`` with
    ``P|z> = i^ph * gathered`` for every state of a ``(..., 2, N)`` batch,
    ``gathered = (-1)^popcount(j & (y|z)) z[j]`` with ``j = k ^ (x|y)`` (a
    fresh tensor) and ``ph = |y| mod 4``, so a caller folds any complex
    factor into ``ph`` and one real coefficient (:func:`add_phased`)
    instead of materialising ``P|z>``."""
    xy, yz = int(xm) | int(ym), int(ym) | int(zm)
    sign = _sign_vector(yz, xy, states.shape[-1], states.dtype,
                        states.device)
    zj = _xor_gather(states, xy).mul_(sign) if xy else states * sign
    return zj, bin(int(ym)).count("1") % 4


def add_phased(out: torch.Tensor, gathered: torch.Tensor, ph: int,
               c: float) -> torch.Tensor:
    """``out += c * i^ph * gathered`` on ``(..., 2, N)`` planes (``c`` a
    host float), in place."""
    (src_re, s_re), (src_im, s_im) = _PHASE_PLANES[ph % 4]
    out[..., 0, :].add_(gathered[..., src_re, :], alpha=c * s_re)
    out[..., 1, :].add_(gathered[..., src_im, :], alpha=c * s_im)
    return out


def pauli_apply_sv(states: torch.Tensor, xmask, ymask, zmask) -> torch.Tensor:
    """``P|z_b>`` for each state of a ``(B, 2, N)`` batch, for ONE Pauli
    string given as host integer masks: the xor-gather, ``j``-side sign and
    ``i^|y|`` of :func:`pauli_sum_expvals_sv`, returning the transformed
    batch (a fresh tensor) instead of its expectation. One gather pass, no
    per-qubit gate loop; the Trotter and imaginary-time steps
    (``ops/dynamics.py``) build ``exp(-i theta P)`` from it."""
    gathered, ph = pauli_term_gather(states, xmask, ymask, zmask)
    (src_re, s_re), (src_im, s_im) = _PHASE_PLANES[ph]
    return torch.stack([gathered[..., src_re, :] * s_re,
                        gathered[..., src_im, :] * s_im], dim=-2)


def pauli_sum_apply_sv(states: torch.Tensor, xmask, ymask, zmask,
                       coeffs) -> torch.Tensor:
    """``H|z_b> = sum_t coeffs[t] P_t|z_b>`` for each state of a ``(B, 2,
    N)`` batch (a fresh tensor): :func:`pauli_sum_apply`, the Lanczos
    step's matrix-vector product. Masks and coefficients are host data, so
    the term loop reads nothing back from the device."""
    return pauli_sum_apply(states, xmask, ymask, zmask, coeffs)


def pauli_sum_apply(states: torch.Tensor, xmask, ymask, zmask, coeffs,
                    out: torch.Tensor = None) -> torch.Tensor:
    """``sum_t coeffs[t] P_t |z_b>`` for each state of a ``(B, 2, N)``
    batch, with the masks of :func:`pauli_sum_operands` (``P_t`` acts on
    the bits its masks name: on a density register's flat vector, the
    ket half, so this is ``H rho``). The same xor-gather, sign and
    ``i^|y|`` as :func:`pauli_sum_expvals_sv`, one gather per term;
    zero-coefficient terms (the bucket's padding) are skipped. Written into
    ``out`` (a fresh batch by default), which is returned."""
    out = torch.zeros_like(states) if out is None else out.zero_()
    for xm, ym, zm, c in zip(xmask, ymask, zmask, coeffs):
        if float(c) == 0.0:
            continue
        gathered, ph = pauli_term_gather(states, xm, ym, zm)
        add_phased(out, gathered, ph, float(c))
    return out


def pauli_sum_expvals_dm(planes: torch.Tensor, num_qubits: int, xmask,
                         ymask, zmask,
                         compensated: bool = False) -> torch.Tensor:
    """Per-term ``Tr(P_t rho)`` for a density register's flat ``(2,
    4^n)`` planes (``flat[r + c*2^n]``, columns on the high bits), or for a
    ``(B, 2, 4^n)`` batch of them, and host mask arrays of shape ``(T,)``:
    a real ``(T,)`` (or ``(B, T)``) tensor on the planes' device. Each term
    reads only the ``2^n`` entries ``rho[r^m, r]`` of each register (a
    diagonal-sized gather, not a pass over the flat vector).
    ``compensated=True`` sums them through the TwoSum cascade (the entries
    are used unmultiplied, so no split products are needed)."""
    batch = planes.unsqueeze(0) if planes.dim() == 2 else planes
    dim = 1 << num_qubits
    rows = torch.arange(dim, device=planes.device)
    out = []
    for xm, ym, zm in zip(xmask, ymask, zmask):
        xy, yz = int(xm) | int(ym), int(ym) | int(zm)
        j = rows ^ xy                  # r ^ m: the paired row index
        sign = (1 - 2 * _parity(j & yz)).to(planes.dtype)
        # flat index of mat[c = r, r' = r ^ m] = rho[r ^ m, r]
        picked = batch.index_select(-1, rows * dim + j) * sign
        if compensated:
            acc_re, acc_im = (s + e for s, e in (
                _sum_pair_rows(picked[:, p]) for p in (0, 1)))
        else:
            acc_re, acc_im = picked.sum(-1).unbind(-1)
        ph = bin(int(ym)).count("1") % 4
        # i^|y| times the trace: its real part
        out.append((acc_re, -acc_im, -acc_re, acc_im)[ph])
    vals = torch.stack(out, dim=-1)
    return vals[0] if planes.dim() == 2 else vals


def pauli_sum_total_dm(planes: torch.Tensor, num_qubits: int, xmask, ymask,
                       zmask, coeffs,
                       compensated: bool = False) -> torch.Tensor:
    """``sum_t coeffs[t] * Tr(P_t rho)``: a 0-dim tensor for one register's
    ``(2, 4^n)`` planes, a ``(B,)`` one for a batch, on the device."""
    vals = pauli_sum_expvals_dm(planes, num_qubits, xmask, ymask, zmask,
                                compensated)
    cf = torch.as_tensor(np.asarray(coeffs, dtype=np.float64),
                         dtype=vals.dtype, device=vals.device)
    return (vals * cf).sum(-1)


# ---------------------------------------------------------------------------
# running statistics of the trajectory convergence loop
# ---------------------------------------------------------------------------
#
# The trajectory program runs ensembles in WAVES and stops once the
# standard error of the running mean fits the caller's budget. The running
# (count, mean, M2) triple stays on the device; each wave folds its values
# in with Chan's parallel merge, so the only device->host traffic per wave
# is the triple the stop decision reads. Padded wave rows carry weight 0
# and drop out of the statistics exactly.


def welford_wave(vals: torch.Tensor, weights: torch.Tensor):
    """(count, mean, M2) of one wave of per-trajectory values under a 0/1
    ``weights`` mask, reduced over the last axis (``vals`` ``(W,)`` or
    ``(B, W)``)."""
    w = torch.broadcast_to(weights.to(vals.dtype), vals.shape)
    n = w.sum(-1)
    safe = torch.clamp(n, min=1.0)
    mean = (vals * w).sum(-1) / safe
    m2 = (w * (vals - mean[..., None]) ** 2).sum(-1)
    return n, mean, m2


def welford_merge(a, b):
    """Chan's parallel combine of two (count, mean, M2) triples: exact
    pooled statistics, no pass over the underlying samples."""
    na, ma, sa = a
    nb, mb, sb = b
    n = na + nb
    safe = torch.clamp(n, min=1.0)
    delta = mb - ma
    mean = ma + delta * nb / safe
    m2 = sa + sb + delta * delta * na * nb / safe
    return n, mean, m2


def score_surrogate(value, logq, baseline=0.0):
    """The differentiation surrogate of a stochastic-trajectory estimator:
    ``value + (value - baseline) * (logq - logq)`` with the second
    ``value``, the ``baseline`` and the second ``logq`` detached (the JAX
    package's ``stop_gradient``). Its value is ``value``; its gradient is
    the pathwise ``d value`` plus the score-function term ``(value -
    baseline) d logq``, where ``logq`` is the log-probability of every
    channel draw the trajectory took. A trajectory's channels are drawn
    with parameter-dependent probabilities, so the pathwise term alone is
    a biased estimate of ``d E[value]``; with the score term the mean is
    unbiased. A ``baseline`` independent of this draw (the gradient loop's
    running mean of earlier waves) leaves the mean unchanged, since ``E[b
    d logq] = b d sum_j p_j = 0``, and shrinks the score term's variance.

    The trajectory gradient loop (:meth:`quest_tpu_torch.ops.trajectories.
    TrajectoryProgram.expectation_grad`) computes this gradient in closed
    form by an adjoint walk instead; this is its definition, for callers
    that differentiate a trajectory with ``torch.autograd``."""
    def detached(x):
        return x.detach() if isinstance(x, torch.Tensor) else x

    return value + (detached(value) - detached(baseline)) * (
        logq - detached(logq))


def welford_stderr(n, m2):
    """Standard error of the mean from a (count, M2) pair (inf below two
    samples). Host-side, on numpy arrays or scalars."""
    n = np.asarray(n, dtype=np.float64)
    m2 = np.asarray(m2, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        se = np.sqrt(m2 / np.maximum(n - 1.0, 1e-300) / np.maximum(n, 1.0))
    return np.where(n >= 2.0, se, np.inf)
