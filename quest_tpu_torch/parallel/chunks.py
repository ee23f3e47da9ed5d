"""Chunk-wise state functions of an amplitude-sharded register.

The JAX package's ``calc*``, ``init*``, collapse and amplitude reads take a
sharded array and let GSPMD partition the reduction. Here a sharded
register is a list of chunks (:mod:`quest_tpu_torch.parallel.mesh`), so
each function below acts chunk by chunk: the partial sums of each shard
come back as float64 numbers (compensated pairs where the env is
compensated) and are combined on the host exactly (``math.fsum``), the
reference's ``MPI_Allreduce`` of partial sums
(``QuEST_cpu_distributed.c:87-109``). Nothing here gathers a register onto
one device; the two functions that need a PURE state whole beside a
density register's chunks (``init_pure_density``, ``fidelity_density``)
copy that n-qubit state, as the reference replicates it
(``copyVecIntoMatrixPairState``), and each chunk takes its own block of
``|psi><psi|``: whole columns, or part of one column when the chunk is
narrower than a column.

A QUAD register's chunks are ``(4, C)`` double-double planes: the same
functions reduce them in dd arithmetic (``ops/doubledouble.py``), each
shard's partial sum a compensated pair rounded to one float64, combined
exactly on the host.

Positional reads and writes need the canonical qubit layout; the callers
in ``api.py`` restore it first (``Qureg.ensure_canonical``) where the
function reads positions, and skip it where it does not (``total_prob``
of a state vector, and a density register's purity).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.apply import split_shape
from ..core.matrices import PAULI_MATS
from ..ops import doubledouble as ddm
from ..ops import initstates as ist
from ..ops import reductions as red
from ..ops.statevec import set_weighted

__all__ = ["init_chunks", "set_amps", "amp_pair", "total_prob",
           "prob_of_outcome", "inner_product", "density_inner_product",
           "hs_distance", "pauli_expvals", "pauli_total",
           "pauli_sum_apply", "pauli_expvals_dm", "pauli_total_dm",
           "density_identity",
           "init_pure_density", "fidelity_density", "weighted",
           "mix_density", "density_diagonal", "dd_pauli_image",
           "dd_pauli_expval", "dd_pauli_sum_apply"]


def _lt(qureg) -> int:
    return qureg.num_qubits_in_state_vec - (qureg.env.num_devices.bit_length()
                                            - 1)


def _combine(parts) -> float:
    """Exact host sum of per-shard float64 partials."""
    return math.fsum(float(p) for p in parts)


def _dot(a: torch.Tensor, b: torch.Tensor, compensated: bool) -> float:
    if compensated:
        s, e = red.dot_pair(a, b)
        return float(s) + float(e)
    return float(torch.dot(a.reshape(-1), b.reshape(-1)).double())


# -- initialisation ---------------------------------------------------------

def init_chunks(qureg, kind: str, *args) -> None:
    """Fill a sharded register's chunks fresh (the ``init*`` states):
    ``kind`` is ``blank``, ``classical`` (global index), ``plus``
    (amplitude), ``debug`` or ``single`` (qubit, outcome); each chunk made
    by ``ops/initstates.py`` on its shard's device (dd planes on a QUAD
    register)."""
    lt = _lt(qureg)
    C = 1 << lt
    dtype, quad = qureg.real_dtype, qureg.is_quad
    out = []
    for d, dev in enumerate(qureg.env.mesh.devices):
        if kind == "plus":
            c = ist.plus(C, dtype, dev, args[0], quad)
        elif kind == "debug":
            c = ist.debug(C, dtype, dev, quad, start=d * C)
        else:
            c = ist.blank(C, dtype, dev, quad)
        if kind == "classical":
            if int(args[0]) >> lt == d:
                c[0, int(args[0]) & (C - 1)] = 1.0
        elif kind == "single":
            qubit, outcome = int(args[0]), int(args[1])
            amp = 1.0 / math.sqrt(qureg.num_amps_total // 2)
            if qubit >= lt:
                if (d >> (qubit - lt)) & 1 == outcome:
                    ist._fill_real(c, amp, quad)
            else:
                ist._fill_real(c, amp, quad, lambda p: p.view(
                    C >> (qubit + 1), 2, 1 << qubit)[:, outcome, :])
        elif kind not in ("blank", "plus", "debug"):
            raise ValueError(f"unknown init kind {kind!r}")
        out.append(c)
    qureg.chunks = out


def set_amps(qureg, start: int, vals: np.ndarray) -> None:
    """Overwrite amplitudes ``[start, start + len)`` (canonical order) from
    host ``(2, len)`` planes, each shard its own slice."""
    lt = _lt(qureg)
    C = 1 << lt
    stop = start + vals.shape[1]
    for d, c in enumerate(qureg.chunks):
        lo, hi = max(start, d * C), min(stop, (d + 1) * C)
        if lo < hi:
            c[:, lo - d * C:hi - d * C] = torch.as_tensor(
                vals[:, lo - start:hi - start], dtype=c.dtype,
                device=c.device)


def amp_pair(qureg, phys: int) -> tuple:
    """(re, im) of the amplitude at PHYSICAL index ``phys``: read from the
    one shard that holds it (the owner-rank read of
    ``statevec_getRealAmp``, ``QuEST_cpu_distributed.c:195-203``)."""
    lt = _lt(qureg)
    pair = qureg.chunks[phys >> lt][:, phys & ((1 << lt) - 1)]
    p = [float(x) for x in pair.double().cpu()]
    if qureg.is_quad:
        return p[0] + p[1], p[2] + p[3]
    return p[0], p[1]


# -- reductions of state vectors --------------------------------------------

def total_prob(qureg) -> float:
    """sum |amp|^2 over every element (a density register's purity
    Tr(rho^2) too): the order of the elements does not matter, so neither
    does the layout."""
    if qureg.is_quad:
        return _combine(ddm.dd_total_prob(c) for c in qureg.chunks)
    comp = qureg.env.compensated
    return _combine(_dot(c, c, comp) for c in qureg.chunks)


def prob_of_outcome(qureg, phys: int, outcome: int) -> float:
    """P(outcome) of the qubit at PHYSICAL position ``phys`` of a state
    vector: P0 summed over the shards, P1 as 1 - P0 (the reference's
    semantics, ``QuEST_cpu_local.c:279-285``)."""
    lt = _lt(qureg)
    comp = qureg.env.compensated
    parts = []
    for d, c in enumerate(qureg.chunks):
        if phys >= lt:
            if (d >> (phys - lt)) & 1 == 0:
                parts.append(ddm.dd_total_prob(c) if qureg.is_quad
                             else _dot(c, c, comp))
            continue
        if qureg.is_quad:
            parts.append(ddm.dd_prob_zero_sv(c, lt, phys))
            continue
        pre, _, post = split_shape(lt, (phys,))
        half = c.view(2, pre, 2, post)[:, :, 0, :]
        parts.append(_dot(half, half, comp))
    p0 = _combine(parts)
    return p0 if outcome == 0 else 1.0 - p0


def inner_product(bra, ket) -> complex:
    """<bra|ket> over matching chunks (both canonical)."""
    if bra.is_quad:
        parts = [ddm.dd_vdot(a, b.to(a.device))
                 for a, b in zip(bra.chunks, ket.chunks)]
        return complex(_combine(p.real for p in parts),
                       _combine(p.imag for p in parts))
    comp = bra.env.compensated
    re, im = [], []
    for a, b in zip(bra.chunks, ket.chunks):
        b = b.to(a.device)
        re += [_dot(a[0], b[0], comp), _dot(a[1], b[1], comp)]
        im += [_dot(a[0], b[1], comp), -_dot(a[1], b[0], comp)]
    return complex(_combine(re), _combine(im))


def density_inner_product(a, b) -> float:
    if a.is_quad:
        return _combine(ddm.dd_vdot(x, y.to(x.device)).real
                        for x, y in zip(a.chunks, b.chunks))
    comp = a.env.compensated
    return _combine(_dot(x, y.to(x.device), comp)
                    for x, y in zip(a.chunks, b.chunks))


def hs_distance(a, b) -> float:
    comp = a.env.compensated
    parts = []
    for x, y in zip(a.chunks, b.chunks):
        if a.is_quad:
            parts.append(ddm.dd_total_prob(ddm.dd_weighted(
                1.0, x, -1.0, y.to(x.device), 0.0, x)))
            continue
        diff = x - y.to(x.device)
        parts.append(_dot(diff, diff, comp))
    return math.sqrt(max(0.0, _combine(parts)))


def _term_parts(za: torch.Tensor, zb: torch.Tensor, xl: int, yzl: int,
                imag: bool, compensated: bool) -> torch.Tensor:
    """One chunk pair's real (or imaginary) part of ``sum_k conj(za[k])
    s(k) zb[k ^ xl]`` with ``s(k) = (-1)^popcount((k ^ xl) & yzl)``, per
    batch row: a float64 ``(B,)`` tensor."""
    C = za.shape[-1]
    zj = red._xor_gather(zb, xl) if xl else zb
    sign = red._sign_vector(yzl, xl, C, za.dtype, za.device)
    if compensated:
        zjs = zj * sign
        if imag:
            a = torch.cat([za[:, 0], -za[:, 1]], dim=1)
            b = torch.cat([zjs[:, 1], zjs[:, 0]], dim=1)
        else:
            a = za.reshape(za.shape[0], -1)
            b = zjs.reshape(za.shape[0], -1)
        s, e = red.dot_pair_rows(a, b)
        return s.double() + e.double()
    if imag:
        part = za[:, 0] * zj[:, 1] - za[:, 1] * zj[:, 0]
    else:
        part = (za * zj).sum(1)
    return torch.matmul(part, sign).double()


def pauli_expvals(chunks: list, lt: int, xmask, ymask, zmask,
                  compensated: bool = False) -> torch.Tensor:
    """Per-term ``<z_b|P_t|z_b>`` of a state vector (or a ``(B, 2, C)``
    batch) held as canonical chunks: float64 ``(B, T)`` on the first
    chunk's device. A term's X/Y bits on device positions pair chunk ``d``
    with chunk ``d ^ dx``, whose chunk is read beside ``d``'s (copied when
    it lies on another device); the sign of the partner's device bits is
    one factor per pair."""
    batch = [c.unsqueeze(0) if c.dim() == 2 else c for c in chunks]
    mask = (1 << lt) - 1
    home = batch[0].device
    out = []
    for xm, ym, zm in zip(xmask, ymask, zmask):
        xy, yz = int(xm) | int(ym), int(ym) | int(zm)
        ph = bin(int(ym)).count("1") % 4
        dx, xl = xy >> lt, xy & mask
        yzd, yzl = yz >> lt, yz & mask
        acc = None
        for d, za in enumerate(batch):
            partner = d ^ dx
            zb = batch[partner].to(za.device)
            part = _term_parts(za, zb, xl, yzl, bool(ph % 2), compensated)
            if bin(partner & yzd).count("1") % 2:
                part = -part
            part = part.to(home)
            acc = part if acc is None else acc + part
        out.append(acc if ph in (0, 3) else -acc)
    return torch.stack(out, dim=1)


def pauli_sum_apply(chunks: list, lt: int, xmask, ymask, zmask, coeffs,
                    out: list) -> list:
    """``sum_t coeffs[t] P_t |z_b>`` of a batch held as canonical chunks,
    written into the chunks ``out``: for each term, chunk ``d`` gathers
    from chunk ``d ^ dx`` (the term's X/Y bits on device positions), with
    the local sign and the partner's device-bit sign."""
    mask = (1 << lt) - 1
    for o in out:
        o.zero_()
    for xm, ym, zm, c in zip(xmask, ymask, zmask, coeffs):
        if float(c) == 0.0:
            continue
        xy, yz = int(xm) | int(ym), int(ym) | int(zm)
        ph = bin(int(ym)).count("1") % 4
        for d, o in enumerate(out):
            partner = d ^ (xy >> lt)
            gathered, _ = red.pauli_term_gather(
                chunks[partner].to(o.device), int(xm) & mask,
                int(ym) & mask, int(zm) & mask)
            sign = -1.0 if bin(partner & (yz >> lt)).count("1") % 2 else 1.0
            red.add_phased(o, gathered, ph, sign * float(c))
    return out


def pauli_total(chunks: list, lt: int, xmask, ymask, zmask, coeffs,
                compensated: bool = False) -> torch.Tensor:
    """``sum_t coeffs[t] <z_b|P_t|z_b>``: float64 ``(B,)``."""
    vals = pauli_expvals(chunks, lt, xmask, ymask, zmask, compensated)
    cf = torch.as_tensor(np.asarray(coeffs, dtype=np.float64),
                         dtype=vals.dtype, device=vals.device)
    return (vals * cf).sum(-1)


# -- density registers -------------------------------------------------------

def pauli_expvals_dm(chunks: list, lt: int, num_qubits: int, xmask, ymask,
                     zmask, compensated: bool = False) -> torch.Tensor:
    """Per-term ``Tr(P_t rho)`` of density registers (``num_qubits`` each,
    flat ``rho[r, c] = flat[r + c*2^n]``) held as canonical chunks of
    ``lt`` qubits, ``(2, C)`` or ``(B, 2, C)``: float64 ``(B, T)`` on the
    first chunk's device. A term reads the ``2^n`` entries ``rho[r ^ m,
    r]`` (:func:`~quest_tpu_torch.ops.reductions.pauli_sum_expvals_dm`);
    each shard sums those it holds, in the plane dtype (compensated when
    asked), and the partial sums combine in float64 in shard order."""
    batch = [c.unsqueeze(0) if c.dim() == 2 else c for c in chunks]
    dim = 1 << num_qubits
    home = batch[0].device
    rows = np.arange(dim, dtype=np.int64)
    out = []
    for xm, ym, zm in zip(xmask, ymask, zmask):
        xy, yz = int(xm) | int(ym), int(ym) | int(zm)
        j = rows ^ xy
        flat = rows * dim + j
        owner = flat >> lt
        parity = np.zeros(dim, dtype=np.int64)
        for q in range(max(yz.bit_length(), 1)):
            if (yz >> q) & 1:
                parity ^= (j >> q) & 1
        sign = 1.0 - 2.0 * parity
        acc = torch.zeros((batch[0].shape[0], 2), dtype=torch.float64,
                          device=home)
        for d, c in enumerate(batch):
            sel = owner == d
            if not sel.any():
                continue
            idx = torch.as_tensor(flat[sel] - (d << lt), device=c.device)
            picked = c.index_select(-1, idx) * torch.as_tensor(
                sign[sel], dtype=c.dtype, device=c.device)
            if compensated:
                part = torch.stack([s + e for s, e in (
                    red._sum_pair_rows(picked[:, p]) for p in (0, 1))],
                    dim=-1)
            else:
                part = picked.sum(-1)
            acc += part.double().to(home)
        acc_re, acc_im = acc.unbind(-1)
        ph = bin(int(ym)).count("1") % 4
        # i^|y| times the trace: its real part
        out.append((acc_re, -acc_im, -acc_re, acc_im)[ph])
    return torch.stack(out, dim=-1)


def pauli_total_dm(chunks: list, lt: int, num_qubits: int, xmask, ymask,
                   zmask, coeffs, compensated: bool = False) -> torch.Tensor:
    """``sum_t coeffs[t] Tr(P_t rho_b)``: float64 ``(B,)``."""
    vals = pauli_expvals_dm(chunks, lt, num_qubits, xmask, ymask, zmask,
                            compensated)
    cf = torch.as_tensor(np.asarray(coeffs, dtype=np.float64),
                         dtype=vals.dtype, device=vals.device)
    return (vals * cf).sum(-1)


def density_identity(devices, lt: int, num_qubits: int, dtype) -> list:
    """The identity's flat vector (``flat[r + r*2^n] = 1``) as ``(1, 2,
    2^lt)`` chunks, one per device: the density gradient's cotangent is
    ``H`` applied to it (``Tr(H rho) = Re <H_flat, rho_flat>``)."""
    dim = 1 << num_qubits
    C = 1 << lt
    diag = np.arange(dim, dtype=np.int64) * (dim + 1)
    out = []
    for d, dev in enumerate(devices):
        c = torch.zeros((1, 2, C), dtype=dtype, device=dev)
        mine = diag[(diag >> lt) == d] - (d << lt)
        if len(mine):
            c[0, 0, torch.as_tensor(mine, device=dev)] = 1.0
        out.append(c)
    return out


def density_diagonal(chunk: torch.Tensor, d: int, n: int, lt: int,
                     plane: int = 0):
    """``(view, r0)``: the real diagonal entries ``rho[r, r]`` that shard
    ``d``'s chunk holds (``flat[r + r*2^n]``; consecutive outcomes ``r0,
    r0+1, ...``), as a strided view of ``chunk[plane]`` (a QUAD chunk's
    lo plane is 1), or ``(None, None)`` when it holds none."""
    if lt >= n:
        r0 = d << (lt - n)
        return chunk[plane][r0::(1 << n) + 1], r0
    start = d << lt
    c = start >> n
    r_start = start & ((1 << n) - 1)
    if r_start <= c < r_start + (1 << lt):
        return chunk[plane][c - r_start:c - r_start + 1], c
    return None, None


def _diag_parts(chunks: list, n: int, lt: int, quad: bool,
                compensated: bool, qubit: int = -1) -> float:
    """The sum of the diagonal entries the chunks hold (those whose
    outcome has ``qubit`` == 0 when ``qubit >= 0``), each shard's part
    summed in the plane dtype (compensated, or in dd over a QUAD chunk's
    hi and lo planes), combined in float64."""
    parts = []
    for d, c in enumerate(chunks):
        diag, r0 = density_diagonal(c, d, n, lt)
        if diag is None:
            continue
        views = [diag]
        if quad:
            views.append(density_diagonal(c, d, n, lt, plane=1)[0])
        cnt = diag.shape[0]
        if qubit >= 0 and (1 << qubit) >= cnt:
            if (r0 >> qubit) & 1:
                continue
        elif qubit >= 0:
            views = [v.reshape(cnt >> (qubit + 1), 2, 1 << qubit)[:, 0, :]
                     for v in views]
        parts.append(ddm._diag_sum(v.reshape(-1) for v in views) if quad
                     else _sum(views[0], compensated))
    return _combine(parts)


def density_total_prob(qureg) -> float:
    return _diag_parts(qureg.chunks, qureg.num_qubits_represented,
                       _lt(qureg), qureg.is_quad, qureg.env.compensated)


def _sum(x: torch.Tensor, compensated: bool) -> float:
    if compensated:
        s, e = red.sum_pair(x)
        return float(s) + float(e)
    return float(x.sum().double())


def density_prob_of_outcome(qureg, qubit: int, outcome: int) -> float:
    """P(outcome) of ``qubit`` on a canonical density register: the
    diagonal entries whose outcome index has ``qubit`` == 0, summed over
    the shards, complemented for outcome 1."""
    p0 = _diag_parts(qureg.chunks, qureg.num_qubits_represented,
                     _lt(qureg), qureg.is_quad, qureg.env.compensated,
                     qubit)
    return p0 if outcome == 0 else 1.0 - p0


def _pure_whole(pure, device) -> torch.Tensor:
    """A pure state's whole ``(2, 2^n)`` (QUAD: ``(4, 2^n)``) planes on
    ``device``."""
    if pure.is_sharded:
        pure.ensure_canonical()
        return torch.cat([c.to(device) for c in pure.chunks], dim=1)
    return pure.state.to(device)


def _block(d: int, n: int, lt: int) -> tuple:
    """``(c0, cols, r0, rows)``: shard ``d``'s chunk of a density register
    is the block ``rho[r0:r0+rows, c0:c0+cols]``, column by column
    (``flat[r + c*2^n]``): whole columns when a chunk holds at least one,
    else ``2^lt`` rows of one column."""
    if lt >= n:
        cols = 1 << (lt - n)
        return d * cols, cols, 0, 1 << n
    start = d << lt
    return start >> n, 1, start & ((1 << n) - 1), 1 << lt


def init_pure_density(qureg, pure) -> None:
    """rho = |psi><psi| into a density register's chunks: each chunk's
    block ``mat[c, r] = conj(psi_c) psi_r`` by rank-one updates (a dd
    outer product on a QUAD register)."""
    n = qureg.num_qubits_represented
    lt = _lt(qureg)
    out = []
    for d, dev in enumerate(qureg.env.mesh.devices):
        psi = _pure_whole(pure, dev).to(qureg.real_dtype)
        c0, cols, r0, rows = _block(d, n, lt)
        pc, pr = psi[:, c0:c0 + cols], psi[:, r0:r0 + rows]
        if qureg.is_quad:
            out.append(ddm.dd_outer(pr, conj_left=False, cols=pc))
            continue
        c = torch.empty((2, cols, rows), dtype=psi.dtype, device=dev)
        torch.outer(pc[0], pr[0], out=c[0])
        c[0].addr_(pc[1], pr[1])
        torch.outer(pc[0], pr[1], out=c[1])
        c[1].addr_(pc[1], pr[0], alpha=-1.0)
        out.append(c.view(2, -1))
    qureg.chunks = out


def fidelity_density(qureg, pure) -> float:
    """<psi|rho|psi> = Re sum_c psi_c sum_r mat[c, r] conj(psi_r), each
    shard over its own block (a dd dot with the dd outer product's
    weights on a QUAD register)."""
    n = qureg.num_qubits_represented
    lt = _lt(qureg)
    comp = qureg.env.compensated
    parts = []
    for d, c in enumerate(qureg.chunks):
        psi = _pure_whole(pure, c.device).to(c.dtype)
        c0, cols, r0, rows = _block(d, n, lt)
        pc, pr = psi[:, c0:c0 + cols], psi[:, r0:r0 + rows]
        if qureg.is_quad:
            w = ddm.dd_outer(pr, conj_left=True, cols=pc)
            parts.append(ddm.dd_vdot(w, c, conj_a=False).real)
            continue
        m = c.view(2, cols, rows)
        # w_c = sum_r mat[c, r] conj(psi_r)
        wr = torch.mv(m[0], pr[0]) + torch.mv(m[1], pr[1])
        wi = torch.mv(m[1], pr[0]) - torch.mv(m[0], pr[1])
        parts += [_dot(pc[0], wr, comp), -_dot(pc[1], wi, comp)]
    return _combine(parts)


def weighted(fac1, q1, fac2, q2, fac_out, out) -> None:
    """out = fac1 q1 + fac2 q2 + fac_out out, chunk by chunk (all three
    canonical, on one mesh; in dd on QUAD registers)."""
    for a, b, t in zip(q1.chunks, q2.chunks, out.chunks):
        if out.is_quad:
            t.copy_(ddm.dd_weighted(fac1, a.to(t.device), fac2,
                                    b.to(t.device), fac_out, t))
            continue
        set_weighted(fac1, a.to(t.device), fac2, b.to(t.device), fac_out, t)


def mix_density(qureg, other_prob: float, other) -> None:
    """qureg = (1-p) qureg + p other, chunk by chunk."""
    from ..ops.densmatr import mix_density_matrix
    for c, o in zip(qureg.chunks, other.chunks):
        src = o.to(c.device)
        if qureg.is_quad:
            c.copy_(ddm.dd_weighted(1.0 - float(other_prob), c,
                                    float(other_prob), src, 0.0, c))
            continue
        if src.data_ptr() == c.data_ptr():
            src = src.clone()
        mix_density_matrix(c, float(other_prob), src)


# -- QUAD Pauli images -------------------------------------------------------

def dd_pauli_image(chunks: list, lt: int, codes) -> list:
    """``P |z>`` of one Pauli product (``codes[q]`` on qubit ``q``; a
    density register's ket half) on canonical dd chunks: chunk ``d`` of
    the image is the chunk-local Paulis applied to chunk ``d ^ dx`` (``dx``
    the product's X/Y bits on device positions), times ``i^p`` for the
    Y/Z factors of the device bits at ``d`` (``Y|0> = i|1>``, ``Y|1> =
    -i|0>``). Pauli entries are 0, +-1 and +-i, so every step is exact and
    the image equals the one-device image bit for bit."""
    dx = 0
    for q, code in enumerate(codes):
        if code in (1, 2) and q >= lt:
            dx |= 1 << (q - lt)
    out = []
    for d, c in enumerate(chunks):
        phi = chunks[d ^ dx].to(c.device)
        local = False
        power = 0
        for q, code in enumerate(codes):
            if not code:
                continue
            if q < lt:
                phi = ddm.dd_apply_kq(phi, lt, PAULI_MATS[code], (q,))
                local = True
                continue
            bit = (d >> (q - lt)) & 1
            if code == 2:
                power += 1 if bit else 3
            elif code == 3:
                power += 2 * bit
        out.append(ddm.dd_times_i_power(phi if local else phi.clone(),
                                        power))
    return out


def dd_pauli_expval(chunks: list, lt: int, num_qubits: int,
                    density: bool, codes) -> float:
    """``<psi|P|psi>`` (``Tr(P rho)`` of a density register of
    ``num_qubits``) of canonical dd chunks of ``lt`` qubits for one term,
    in dd; one chunk of the whole planes off a mesh."""
    phi = dd_pauli_image(chunks, lt, codes)
    if density:
        return _diag_parts(phi, num_qubits, lt, True, False)
    return _combine(ddm.dd_vdot(a, b).real for a, b in zip(chunks, phi))


def dd_pauli_sum_apply(chunks: list, lt: int, num_qubits: int, codes_flat,
                       coeffs, num_terms: int) -> list:
    """``sum_t coeffs[t] P_t |z>`` of canonical dd chunks, term after term
    in dd: fresh chunks."""
    n = num_qubits
    acc = None
    for t in range(num_terms):
        phi = dd_pauli_image(chunks, lt, codes_flat[t * n:(t + 1) * n])
        c = float(coeffs[t])
        acc = [ddm.dd_weighted(c, p, 0.0, p, 0.0, p) for p in phi] \
            if acc is None else [ddm.dd_weighted(1.0, a, c, p, 0.0, a)
                                 for a, p in zip(acc, phi)]
    return acc
