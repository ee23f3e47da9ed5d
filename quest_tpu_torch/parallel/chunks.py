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
(``copyVecIntoMatrixPairState``).

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
from ..ops import reductions as red
from ..ops.statevec import set_weighted

__all__ = ["init_chunks", "set_amps", "amp_pair", "total_prob",
           "prob_of_outcome", "inner_product", "density_inner_product",
           "hs_distance", "pauli_expvals", "pauli_total",
           "pauli_sum_apply",
           "init_pure_density", "fidelity_density", "weighted",
           "mix_density", "density_diagonal"]


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
    (amplitude), ``debug`` or ``single`` (qubit, outcome)."""
    devs = qureg.env.mesh.devices
    lt = _lt(qureg)
    C = 1 << lt
    dtype = qureg.real_dtype
    out = []
    for d, dev in enumerate(devs):
        c = torch.zeros((2, C), dtype=dtype, device=dev)
        if kind == "classical":
            if int(args[0]) >> lt == d:
                c[0, int(args[0]) & (C - 1)] = 1.0
        elif kind == "plus":
            c[0].fill_(args[0])
        elif kind == "debug":
            # amp[k] = (2k + i(2k+1))/10 with the global k formed in the
            # plane dtype, as ops/initstates.debug forms it
            k = (torch.arange(C, dtype=torch.int64, device=dev)
                 + d * C).to(dtype)
            c = torch.stack([(2.0 * k) / 10.0, (2.0 * k + 1.0) / 10.0])
        elif kind == "single":
            qubit, outcome = int(args[0]), int(args[1])
            amp = 1.0 / math.sqrt(qureg.num_amps_total // 2)
            if qubit >= lt:
                if (d >> (qubit - lt)) & 1 == outcome:
                    c[0].fill_(amp)
            else:
                c[0].view(C >> (qubit + 1), 2, 1 << qubit)[
                    :, outcome, :].fill_(amp)
        elif kind != "blank":
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
    pair = pair.double().cpu()
    return float(pair[0]), float(pair[1])


# -- reductions of state vectors --------------------------------------------

def total_prob(qureg) -> float:
    """sum |amp|^2 over every element (a density register's purity
    Tr(rho^2) too): the order of the elements does not matter, so neither
    does the layout."""
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
                parts.append(_dot(c, c, comp))
            continue
        pre, _, post = split_shape(lt, (phys,))
        half = c.view(2, pre, 2, post)[:, :, 0, :]
        parts.append(_dot(half, half, comp))
    p0 = _combine(parts)
    return p0 if outcome == 0 else 1.0 - p0


def inner_product(bra, ket) -> complex:
    """<bra|ket> over matching chunks (both canonical)."""
    comp = bra.env.compensated
    re, im = [], []
    for a, b in zip(bra.chunks, ket.chunks):
        b = b.to(a.device)
        re += [_dot(a[0], b[0], comp), _dot(a[1], b[1], comp)]
        im += [_dot(a[0], b[1], comp), -_dot(a[1], b[0], comp)]
    return complex(_combine(re), _combine(im))


def density_inner_product(a, b) -> float:
    comp = a.env.compensated
    return _combine(_dot(x, y.to(x.device), comp)
                    for x, y in zip(a.chunks, b.chunks))


def hs_distance(a, b) -> float:
    comp = a.env.compensated
    parts = []
    for x, y in zip(a.chunks, b.chunks):
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

def density_diagonal(chunk: torch.Tensor, d: int, n: int, lt: int):
    """``(view, r0)``: the real diagonal entries ``rho[r, r]`` that shard
    ``d``'s chunk holds (``flat[r + r*2^n]``; consecutive outcomes ``r0,
    r0+1, ...``), as a strided view, or ``(None, None)`` when it holds
    none."""
    if lt >= n:
        r0 = d << (lt - n)
        return chunk[0][r0::(1 << n) + 1], r0
    start = d << lt
    c = start >> n
    r_start = start & ((1 << n) - 1)
    if r_start <= c < r_start + (1 << lt):
        return chunk[0][c - r_start:c - r_start + 1], c
    return None, None


def density_total_prob(qureg) -> float:
    n = qureg.num_qubits_represented
    lt = _lt(qureg)
    parts = []
    for d, c in enumerate(qureg.chunks):
        diag, _ = density_diagonal(c, d, n, lt)
        if diag is not None:
            parts.append(_sum(diag, qureg.env.compensated))
    return _combine(parts)


def _sum(x: torch.Tensor, compensated: bool) -> float:
    if compensated:
        s, e = red.sum_pair(x)
        return float(s) + float(e)
    return float(x.sum().double())


def density_prob_of_outcome(qureg, qubit: int, outcome: int) -> float:
    """P(outcome) of ``qubit`` on a canonical density register: the
    diagonal entries whose outcome index has ``qubit`` == 0, summed over
    the shards, complemented for outcome 1."""
    n = qureg.num_qubits_represented
    lt = _lt(qureg)
    parts = []
    for d, c in enumerate(qureg.chunks):
        diag, r0 = density_diagonal(c, d, n, lt)
        if diag is None:
            continue
        cnt = diag.shape[0]
        if (1 << qubit) >= cnt:
            if (r0 >> qubit) & 1 == 0:
                parts.append(_sum(diag, qureg.env.compensated))
            continue
        half = diag.reshape(cnt >> (qubit + 1), 2, 1 << qubit)[:, 0, :]
        parts.append(_sum(half, qureg.env.compensated))
    p0 = _combine(parts)
    return p0 if outcome == 0 else 1.0 - p0


def _pure_whole(pure, device) -> torch.Tensor:
    """A pure state's whole ``(2, 2^n)`` planes on ``device``."""
    if pure.is_sharded:
        pure.ensure_canonical()
        return torch.cat([c.to(device) for c in pure.chunks], dim=1)
    return pure.state.to(device)


def _column_block(c: torch.Tensor, n: int) -> torch.Tensor:
    """A chunk of whole density columns as ``(2, cols, 2^n)``:
    ``[p, c_local, r] = rho[r, c]``."""
    return c.view(2, -1, 1 << n)


def init_pure_density(qureg, pure) -> None:
    """rho = |psi><psi| into a density register's chunks: each chunk's
    columns ``c`` take ``conj(psi_c) psi_r`` by rank-one updates."""
    n = qureg.num_qubits_represented
    lt = _lt(qureg)
    if lt < n:
        raise qureg._unrouted("initPureState onto chunks narrower than one "
                              "density column")
    cols = 1 << (lt - n)
    out = []
    for d, dev in enumerate(qureg.env.mesh.devices):
        psi = _pure_whole(pure, dev).to(qureg.real_dtype)
        pr, pi = psi[0], psi[1]
        cr, ci = pr[d * cols:(d + 1) * cols], pi[d * cols:(d + 1) * cols]
        c = torch.empty((2, cols, 1 << n), dtype=psi.dtype, device=dev)
        # mat[c, r] = conj(psi_c) psi_r
        torch.outer(cr, pr, out=c[0])
        c[0].addr_(ci, pi)
        torch.outer(cr, pi, out=c[1])
        c[1].addr_(ci, pr, alpha=-1.0)
        out.append(c.view(2, -1))
    qureg.chunks = out


def fidelity_density(qureg, pure) -> float:
    """<psi|rho|psi> = Re sum_c psi_c sum_r mat[c, r] conj(psi_r), each
    shard over its own columns."""
    n = qureg.num_qubits_represented
    lt = _lt(qureg)
    if lt < n:
        raise qureg._unrouted("calcFidelity on chunks narrower than one "
                              "density column")
    cols = 1 << (lt - n)
    parts = []
    for d, c in enumerate(qureg.chunks):
        psi = _pure_whole(pure, c.device).to(c.dtype)
        m = _column_block(c, n)
        # w_c = sum_r mat[c, r] conj(psi_r)
        wr = torch.mv(m[0], psi[0]) + torch.mv(m[1], psi[1])
        wi = torch.mv(m[1], psi[0]) - torch.mv(m[0], psi[1])
        pr = psi[0][d * cols:(d + 1) * cols]
        pi = psi[1][d * cols:(d + 1) * cols]
        comp = qureg.env.compensated
        parts += [_dot(pr, wr, comp), -_dot(pi, wi, comp)]
    return _combine(parts)


def weighted(fac1, q1, fac2, q2, fac_out, out) -> None:
    """out = fac1 q1 + fac2 q2 + fac_out out, chunk by chunk (all three
    canonical, on one mesh)."""
    for a, b, t in zip(q1.chunks, q2.chunks, out.chunks):
        set_weighted(fac1, a.to(t.device), fac2, b.to(t.device), fac_out, t)


def mix_density(qureg, other_prob: float, other) -> None:
    """qureg = (1-p) qureg + p other, chunk by chunk."""
    from ..ops.densmatr import mix_density_matrix
    for c, o in zip(qureg.chunks, other.chunks):
        src = o.to(c.device)
        if src.data_ptr() == c.data_ptr():
            src = src.clone()
        mix_density_matrix(c, float(other_prob), src)
