"""Double-double amplitude arithmetic: the QUAD tier.

Counterpart of the JAX package's ``ops/doubledouble.py``. The reference
offers a quad-precision build (``QuEST_PREC=4``, ``QuEST_precision.h:
53-65``) because deep circuits accumulate per-gate rounding without bound.
Here each amplitude component is an unevaluated sum ``hi + lo`` of two
floats, stored as four planes ``(4, 2^n) = [re_hi, re_lo, im_hi, im_lo]``:
float32 planes (``QUAD``) carry ~48 significand bits, float64 planes
(``QUAD64``) ~106.

Every primitive is a chain of separate elementwise torch ops (the
Dekker/Knuth error-free transformations of ``ops/reductions.py``):

- ``_two_sum``      exact a+b -> (fl(a+b), rounding error)
- ``_two_prod``     exact a*b via Veltkamp split partial products
- ``_dd_add/_dd_mul`` renormalising double-double add / multiply

They are exact only while every ``+``, ``-`` and ``*`` rounds on its own.
So this module uses plain ``*``, ``+`` and ``-`` only: no ``addcmul``, no
``alpha=``, no ``lerp``, no ``torch.compile`` or ``torch.jit``, any of
which may contract a product and a sum into one FMA and lose the lo plane
without an error. Eager torch then runs each op as its own pass over the
planes, on the CPU and on the card alike, so a dd program's planes are
equal bit for bit on both. (The JAX package fused each gate into one XLA
pass and needed optimisation barriers to keep XLA from folding the
transformations; eager ops need neither and pay in passes.)

Planes may carry leading batch axes ``(*lead, 4, 2^n)``: the batched QUAD
rung of :class:`~quest_tpu_torch.circuits.CompiledCircuit` walks ``(B, 4,
2^n)`` with per-row operators ``(B, 4, K, K)``; every other caller passes
one register's ``(4, 2^n)``.

A k-qubit dense gate computes each output row ``r`` as the sum over
columns ``c`` of ``u[r, c] * z[c]`` in the JAX package's order (column 0
first, each product accumulated with ``_dd_add``). The rows, and a group of
columns that fits :data:`_GROUP_ELEMS`, are computed in one op each; the
arithmetic per element is the same as one gate entry at a time.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.apply import permutation_to_sorted_desc, split_shape
from .reductions import _split, _two_sum, sum_pair

__all__ = ["dd_pack", "dd_unpack", "dd_apply_1q", "dd_apply_perm_1q",
           "dd_apply_kq", "dd_apply_diag", "dd_total_prob", "DDProgram",
           "dd_split_traceable", "dd_join_traceable", "dd_split_planes",
           "dd_join_planes", "dd_apply_kq_traced", "dd_apply_diag_traced",
           "dd_relayout", "dd_prob_zero_sv", "dd_prob_zero_dm",
           "dd_total_prob_dm", "dd_collapse", "dd_vdot", "dd_outer",
           "dd_weighted", "dd_times_i_power"]

# elements of one product stream of a dense gate: the columns of a group
# are computed together while rows x group x block stays under this
_GROUP_ELEMS = 1 << 22

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[np.dtype(dtype)]


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return np.dtype(np.float32 if dtype == torch.float32
                        else np.float64)
    return np.dtype(dtype)


# --- error-free transformations ---------------------------------------------

def _quick_two_sum(a, b):
    """Assumes |a| >= |b| (holds for renormalisation: b is an error term)."""
    s = a + b
    return s, b - (s - a)


def _two_prod(a, b):
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _dd_add(xh, xl, yh, yl):
    s, e = _two_sum(xh, yh)
    e = e + (xl + yl)
    return _quick_two_sum(s, e)


def _dd_mul(xh, xl, yh, yl):
    p, e = _two_prod(xh, yh)
    e = e + (xh * yl + xl * yh)
    return _quick_two_sum(p, e)


def _dd_neg(xh, xl):
    return -xh, -xl


# --- packing -----------------------------------------------------------------

def _dd_split_host(z: np.ndarray, dtype=np.float32) -> np.ndarray:
    """complex128 array -> (4, ...) dd planes (host-side)."""
    dtype = _np_dtype(dtype)
    z = np.asarray(z, dtype=np.complex128)
    re_hi = z.real.astype(dtype)
    im_hi = z.imag.astype(dtype)
    return np.stack([re_hi, (z.real - re_hi).astype(dtype),
                     im_hi, (z.imag - im_hi).astype(dtype)])


def dd_pack(z: np.ndarray, dtype=np.float32,
            device: Optional[torch.device] = None) -> torch.Tensor:
    """complex128 host vector -> (4, n) dd planes on ``device`` (the CPU
    when None). A float64 ``hi`` already captures a complex128 input
    exactly, so QUAD64's extra precision shows during gate arithmetic,
    not at packing."""
    planes = torch.from_numpy(_dd_split_host(z, dtype))
    return planes if device is None else planes.to(device)


def dd_unpack(planes) -> np.ndarray:
    """(*lead, 4, n) dd planes -> complex128 host array (*lead, n)."""
    if isinstance(planes, torch.Tensor):
        planes = planes.detach().cpu().numpy()
    p = np.asarray(planes, dtype=np.float64)
    return (p[..., 0, :] + p[..., 1, :]) + 1j * (p[..., 2, :]
                                                 + p[..., 3, :])


def dd_split_planes(re: torch.Tensor, im: torch.Tensor,
                    dtype=torch.float32, dim: int = -2) -> torch.Tensor:
    """Float64 real and imaginary parts -> dd planes stacked at ``dim``.
    The hi/lo split is error-free: ``hi = fl(x)`` and ``lo = x - hi`` is
    exact in float64."""
    dtype = _torch_dtype(dtype)
    rh = re.to(dtype)
    ih = im.to(dtype)
    return torch.stack([rh, (re - rh.to(re.dtype)).to(dtype),
                        ih, (im - ih.to(im.dtype)).to(dtype)], dim=dim)


def dd_split_traceable(z: torch.Tensor, dtype=torch.float32,
                       dim: int = 0) -> torch.Tensor:
    """A complex128 tensor (a bound parameterised matrix, or the batched
    QUAD rung's entry states) -> dd planes stacked at ``dim`` (``(4,
    ...)`` by default, as the JAX package's)."""
    z = z.to(torch.complex128)
    return dd_split_planes(z.real, z.imag, dtype, dim)


def dd_join_planes(planes: torch.Tensor) -> torch.Tensor:
    """(*lead, 4, n) dd planes -> (*lead, 2, n) float64 re/im planes: each
    dd value rounds to its nearest float64 (the engine-boundary exit of the
    QUAD rung, which is why that rung needs a float64 environment)."""
    p = planes.to(torch.float64)
    return torch.stack([p[..., 0, :] + p[..., 1, :],
                        p[..., 2, :] + p[..., 3, :]], dim=-2)


def dd_join_traceable(planes: torch.Tensor) -> torch.Tensor:
    """(4, ...) dd planes -> complex128 (each value rounded to float64)."""
    p = planes.to(torch.float64)
    return torch.complex(p[0] + p[1], p[2] + p[3])


def dd_relayout(planes: torch.Tensor, num_qubits: int, perm_before,
                perm_after) -> torch.Tensor:
    """The layout planner's relayout on dd planes: one per-plane transpose
    of the ``(2,)*n`` view."""
    n = num_qubits
    src = np.empty(n, dtype=np.int64)
    for l in range(n):
        src[n - 1 - int(perm_after[l])] = n - 1 - int(perm_before[l])
    lead = tuple(planes.shape[:-2])
    nl = len(lead)
    out = planes.reshape(lead + (4,) + (2,) * n).permute(
        tuple(range(nl + 1)) + tuple(int(a) + nl + 1 for a in src))
    return out.reshape(lead + (4, 1 << n))


# --- gate kernels ------------------------------------------------------------

def _cplx_mul_acc(acc, u_re, u_im, z):
    """acc += u * z in dd complex arithmetic. ``u_re``/``u_im`` are dd
    pairs, ``z``/``acc`` tuples of 4 dd-plane tensors (re_hi, re_lo, im_hi,
    im_lo); all broadcast."""
    zrh, zrl, zih, zil = z
    # re: ur*zr - ui*zi
    t1 = _dd_mul(u_re[0], u_re[1], zrh, zrl)
    t2 = _dd_mul(u_im[0], u_im[1], zih, zil)
    re = _dd_add(*t1, *_dd_neg(*t2))
    del t1, t2
    # im: ur*zi + ui*zr
    t3 = _dd_mul(u_re[0], u_re[1], zih, zil)
    t4 = _dd_mul(u_im[0], u_im[1], zrh, zrl)
    im = _dd_add(*t3, *t4)
    del t3, t4
    if acc is None:
        return re + im                       # (rh, rl, ih, il)
    arh, arl, aih, ail = acc
    re = _dd_add(arh, arl, *re)
    im = _dd_add(aih, ail, *im)
    return re + im


def _index_bits_cond(num_amps: int, mask: int, pattern: int,
                     device) -> torch.Tensor:
    """(idx & mask) == pattern over [0, num_amps), shape (num_amps,), from
    two int32 index halves (no 64-bit index vector is made)."""
    lo_bits = min(20, max(num_amps.bit_length() - 1, 0))
    nlo = 1 << lo_bits
    nhi = num_amps // nlo
    hi = torch.arange(nhi, dtype=torch.int32, device=device)[:, None]
    lo = torch.arange(nlo, dtype=torch.int32, device=device)[None, :]
    cond = ((hi & (mask >> lo_bits)) == (pattern >> lo_bits)) \
        & ((lo & (mask & (nlo - 1))) == (pattern & (nlo - 1)))
    return cond.reshape(num_amps)


def _masked(out: torch.Tensor, planes: torch.Tensor, ctrl_mask: int,
            flip_mask: int) -> torch.Tensor:
    """Keep ``out`` where the control bits match (a flipped control
    matches 0), else the input."""
    if not ctrl_mask:
        return out
    cond = _index_bits_cond(planes.shape[-1], int(ctrl_mask),
                            int(ctrl_mask) ^ int(flip_mask), planes.device)
    return torch.where(cond, out, planes)


def _dd_apply_kq_body(planes: torch.Tensor, u_dd: torch.Tensor,
                      num_qubits: int, targets_desc) -> torch.Tensor:
    """Dense 2^k x 2^k gate in dd arithmetic. ``planes``: ``(*lead, 4,
    2^n)``; ``u_dd``: ``(4, K, K)`` or ``(*lead, 4, K, K)`` dd-split matrix
    already reordered to sorted-descending bit order."""
    k = len(targets_desc)
    K = 1 << k
    shape = split_shape(num_qubits, targets_desc)
    lead = tuple(planes.shape[:-2])
    nl = len(lead)
    t = planes.reshape(lead + (4,) + shape)
    blocks = shape[0::2]
    nb = len(blocks)

    def column(m: int) -> torch.Tensor:
        idx = [slice(None)] * (nl + 1 + len(shape))
        for i in range(k):
            idx[nl + 2 + 2 * i] = (m >> (k - 1 - i)) & 1
        return t[tuple(idx)]                       # (*lead, 4, *blocks)

    # columns stacked: (K, *lead, 4, *blocks), each component (K, *lead,
    # *blocks)
    cols = torch.stack([column(m) for m in range(K)])
    z = [cols.select(nl + 1, j) for j in range(4)]
    # operator entries as (Kr, Kc, *lead, 1 x blocks)
    ulead = tuple(u_dd.shape[:-3])
    pad = (1,) * (nl - len(ulead))
    coef = []
    for j in range(4):
        c = u_dd[..., j, :, :]
        c = c.permute((c.dim() - 2, c.dim() - 1) + tuple(range(c.dim() - 2)))
        coef.append(c.reshape((K, K) + pad + ulead + (1,) * nb))
    block_elems = cols[0].numel() // 4
    group = max(1, min(K, _GROUP_ELEMS // max(1, K * block_elems)))
    acc = None
    for c0 in range(0, K, group):
        c1 = min(K, c0 + group)
        zc = tuple(z[j][c0:c1].unsqueeze(0) for j in range(4))
        prod = _cplx_mul_acc(None, (coef[0][:, c0:c1], coef[1][:, c0:c1]),
                             (coef[2][:, c0:c1], coef[3][:, c0:c1]), zc)
        del zc
        for c in range(c1 - c0):
            term = tuple(p.select(1, c) for p in prod)
            if acc is None:
                acc = term
            else:
                re = _dd_add(acc[0], acc[1], term[0], term[1])
                im = _dd_add(acc[2], acc[3], term[2], term[3])
                acc = re + im
        del prod
    del cols, z
    # (K, *lead, 4, *blocks) -> (*lead, 4, b0, bit0, ..., bk)
    out = torch.stack(acc, dim=nl + 1).reshape(
        (2,) * k + lead + (4,) + blocks)
    del acc
    perm = list(range(k, k + nl)) + [k + nl]
    for i in range(k):
        perm += [k + nl + 1 + i, i]
    perm.append(k + nl + 1 + k)
    return out.permute(perm).reshape(lead + (4, 1 << num_qubits))


def _sorted_operator(u, targets):
    """``(u, targets_desc)``: ``u`` (user bit order, any leading axes)
    reordered to sorted-descending bit order."""
    perm = permutation_to_sorted_desc(targets)
    if not np.array_equal(perm, np.arange(len(perm))):
        if isinstance(u, torch.Tensor):
            idx = torch.as_tensor(perm, device=u.device)
            u = u.index_select(-2, idx).index_select(-1, idx)
        else:
            u = u[..., perm, :][..., :, perm]
    return u, tuple(sorted(targets, reverse=True))


def dd_apply_kq(planes: torch.Tensor, num_qubits: int, u: np.ndarray,
                targets, ctrl_mask: int = 0,
                flip_mask: int = 0) -> torch.Tensor:
    """Apply a dense k-qubit (controlled) unitary to dd planes. ``u`` is
    host complex128 in user bit order (bit ``j`` of the index addresses
    ``targets[j]``, the ComplexMatrixN convention)."""
    targets = tuple(int(t) for t in targets)
    u, desc = _sorted_operator(np.asarray(u, dtype=np.complex128), targets)
    u_dd = torch.from_numpy(_dd_split_host(u, _np_dtype(planes.dtype))).to(
        planes.device)
    out = _dd_apply_kq_body(planes, u_dd, num_qubits, desc)
    return _masked(out, planes, ctrl_mask, flip_mask)


def dd_apply_kq_traced(planes: torch.Tensor, num_qubits: int,
                       u: torch.Tensor, targets, ctrl_mask: int = 0,
                       flip_mask: int = 0) -> torch.Tensor:
    """Dense k-qubit (controlled) gate on dd planes from a complex128
    tensor ``u`` in user bit order, ``(K, K)`` or one per batch row ``(B,
    K, K)`` (a bound Param gate), dd-split on the planes' device: the
    batched QUAD rung's gate step."""
    targets = tuple(int(t) for t in targets)
    u, desc = _sorted_operator(u.to(torch.complex128), targets)
    u_dd = dd_split_traceable(u, planes.dtype, dim=-3)
    out = _dd_apply_kq_body(planes, u_dd, num_qubits, desc)
    return _masked(out, planes, ctrl_mask, flip_mask)


def dd_apply_1q(planes: torch.Tensor, num_qubits: int, u: np.ndarray,
                target: int) -> torch.Tensor:
    """Apply a 1-qubit unitary (complex128 numpy, dd-split to the planes'
    dtype) to dd planes of shape (4, 2^n)."""
    return dd_apply_kq(planes, num_qubits, u, (int(target),))


def dd_apply_perm_1q(planes: torch.Tensor, num_qubits: int, target: int,
                     control: int = -1) -> torch.Tensor:
    """Error-free permutation gates: X on ``target`` (optionally controlled
    — CNOT). Pure index shuffling, no rounding at all."""
    if control == target:
        raise ValueError("the control qubit must differ from the target")
    pre = 1 << (num_qubits - 1 - target)
    post = 1 << target
    lead = tuple(planes.shape[:-2])
    flipped = planes.reshape(lead + (4, pre, 2, post)).flip(-2).reshape(
        planes.shape)
    if control < 0:
        return flipped
    return _masked(flipped, planes, 1 << control, 0)


def _dd_diag_traced(planes: torch.Tensor, f_dd: torch.Tensor,
                    num_qubits: int, targets_desc) -> torch.Tensor:
    """Multiply by a diagonal factor tensor (axis i indexed by the bit of
    ``targets_desc[i]``, qubits sorted descending). ``f_dd``: ``(4, 2^k)``
    or ``(*lead, 4, 2^k)`` dd-split factors; each amplitude meets its
    factor by broadcasting over the split view."""
    k = len(targets_desc)
    shape = split_shape(num_qubits, targets_desc)
    lead = tuple(planes.shape[:-2])
    flead = tuple(f_dd.shape[:-2])
    pad = (1,) * (len(lead) - len(flead))
    fshape = [1] * len(shape)
    for i in range(k):
        fshape[2 * i + 1] = 2
    f = f_dd.reshape(flead + (4,) + (2,) * k).reshape(
        pad + flead + (4,) + tuple(fshape))
    t = planes.reshape(lead + (4,) + shape)
    nl = len(lead)
    fc = [f.select(nl, j) for j in range(4)]
    zc = [t.select(nl, j) for j in range(4)]
    out = _cplx_mul_acc(None, (fc[0], fc[1]), (fc[2], fc[3]), tuple(zc))
    return torch.stack(out, dim=nl).reshape(planes.shape)


def dd_apply_diag(planes: torch.Tensor, num_qubits: int,
                  factors: np.ndarray, targets_desc) -> torch.Tensor:
    """Apply a static diagonal factor tensor in dd arithmetic (factors
    dd-split to the planes' dtype)."""
    f_dd = torch.from_numpy(_dd_split_host(
        np.asarray(factors, np.complex128).reshape(-1),
        _np_dtype(planes.dtype))).to(planes.device)
    return _dd_diag_traced(planes, f_dd, num_qubits,
                           tuple(int(q) for q in targets_desc))


def dd_apply_diag_traced(planes: torch.Tensor, num_qubits: int,
                         factors: torch.Tensor,
                         targets_desc) -> torch.Tensor:
    """Diagonal factor on dd planes from a complex tensor of shape
    ``(2,)*k`` or one per batch row ``(B,) + (2,)*k`` (framework axis
    order, qubits sorted descending)."""
    k = len(targets_desc)
    lead = tuple(factors.shape[:factors.dim() - k])
    f_dd = dd_split_traceable(factors.reshape(lead + (1 << k,)),
                              planes.dtype, dim=-2)
    return _dd_diag_traced(planes, f_dd, num_qubits,
                           tuple(int(q) for q in targets_desc))


# --- reductions and register operations ---------------------------------------

def _dd_scalar(x: float, dtype) -> tuple[float, float]:
    hi = _np_dtype(dtype).type(x)
    return float(hi), float(np.float64(x) - np.float64(hi))


def _scalar_tensor(pairs, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(pairs, dtype=like.dtype, device=like.device)


def _square_pairs(planes_hi_lo) -> float:
    """sum of (h + l)^2 over the given (h, l) pairs: per-element dd square
    streams, compensated reductions, combined in host double precision."""
    vals, errs = [], []
    for h, l in planes_hi_lo:
        p, e = _two_prod(h, h)
        e = e + 2.0 * h * l + l * l
        vals.append(p.reshape(-1))
        errs.append(e.reshape(-1))
    s, se = sum_pair(torch.cat(vals))
    t, te = sum_pair(torch.cat(errs))
    return (float(s) + float(se)) + (float(t) + float(te))


def dd_total_prob(planes: torch.Tensor) -> float:
    """sum |amp|^2 combined in host double precision: per-element dd
    square streams + compensated reduction — error ~2^-49 relative."""
    return _square_pairs(((planes[0], planes[1]), (planes[2], planes[3])))


def dd_prob_zero_sv(planes: torch.Tensor, num_qubits: int,
                    qubit: int) -> float:
    pre = 1 << (num_qubits - 1 - qubit)
    post = 1 << qubit
    s = planes.reshape(4, pre, 2, post)[:, :, 0, :]
    return _square_pairs(((s[0], s[1]), (s[2], s[3])))


def _diag_sum(parts) -> float:
    (s, se), (t, te) = (sum_pair(p) for p in parts)
    return (float(s) + float(se)) + (float(t) + float(te))


def dd_total_prob_dm(planes: torch.Tensor, num_qubits: int) -> float:
    """Trace of a dd flat density vector (real diagonal sum)."""
    dim = 1 << num_qubits
    return _diag_sum(planes[i].reshape(dim, dim).diagonal()
                     for i in (0, 1))


def dd_prob_zero_dm(planes: torch.Tensor, num_qubits: int,
                    qubit: int) -> float:
    dim = 1 << num_qubits
    pre = 1 << (num_qubits - 1 - qubit)
    post = 1 << qubit
    return _diag_sum(planes[i].reshape(dim, dim).diagonal().reshape(
        pre, 2, post)[:, 0, :] for i in (0, 1))


def dd_collapse(planes: torch.Tensor, num_qubits: int, qubit: int,
                outcome: int, prob: float,
                density: bool = False) -> torch.Tensor:
    """Collapse-to-known-prob in dd: statevector renorm 1/sqrt(p)
    (``QuEST_cpu.c:3346``), density renorm 1/p with row AND column
    projection (``QuEST_cpu.c:790``). ``num_qubits`` counts the planes'
    qubits (2n for a density register)."""
    if density:
        n = num_qubits // 2
        mask = (1 << qubit) | (1 << (qubit + n))
        pattern = outcome * mask
        scale = 1.0 / prob
    else:
        mask = 1 << qubit
        pattern = outcome << qubit
        scale = 1.0 / np.sqrt(prob)
    sh, sl = _scalar_tensor(_dd_scalar(scale, planes.dtype), planes)
    out = []
    for h, l in ((planes[0], planes[1]), (planes[2], planes[3])):
        out.extend(_dd_mul(h, l, sh, sl))
    scaled = torch.stack(out)
    cond = _index_bits_cond(planes.shape[1], mask, pattern, planes.device)
    return torch.where(cond, scaled, torch.zeros_like(planes))


def dd_vdot(a_planes: torch.Tensor, b_planes: torch.Tensor,
            conj_a: bool = True) -> complex:
    """sum conj(a) * b (or plain a*b) in dd, each dd stream reduced
    compensated and combined in host double precision."""
    sign = -1.0 if conj_a else 1.0
    a, b = a_planes, b_planes
    arh, arl, aih, ail = a[0], a[1], sign * a[2], sign * a[3]
    brh, brl, bih, bil = b[0], b[1], b[2], b[3]
    re = _dd_add(*_dd_mul(arh, arl, brh, brl),
                 *_dd_neg(*_dd_mul(aih, ail, bih, bil)))
    im = _dd_add(*_dd_mul(arh, arl, bih, bil),
                 *_dd_mul(aih, ail, brh, brl))
    return complex(_diag_sum(p.reshape(-1) for p in re),
                   _diag_sum(p.reshape(-1) for p in im))


def dd_outer(planes: torch.Tensor, conj_left: bool = False,
             cols: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(4, dim) psi -> (4, dim^2) outer-product flat vector with
    ``flat[r + c*dim] = left(psi_r) * right(psi_c)``, where ``conj_left``
    selects ``conj(psi_r) * psi_c`` (fidelity weights) over ``psi_r *
    conj(psi_c)`` (|psi><psi| in the register's flat layout). Full dd
    arithmetic: the lo planes survive, so QUAD64 keeps its envelope.
    ``cols`` gives the ``psi_c`` of a block of columns (``planes`` then
    holds the block's ``psi_r``): a shard's chunk of the flat vector."""
    cp = planes if cols is None else cols
    rh, rl, ih, il = planes[0], planes[1], planes[2], planes[3]
    ls = -1.0 if conj_left else 1.0
    rs = 1.0 if conj_left else -1.0
    # r varies fastest in the flat index: r is the LAST axis
    u_re = (cp[0][:, None], cp[1][:, None])           # c axis first
    u_im = (rs * cp[2][:, None], rs * cp[3][:, None])
    z = (rh[None, :], rl[None, :], ls * ih[None, :], ls * il[None, :])
    out = _cplx_mul_acc(None, u_re, u_im, z)          # (dim_c, dim_r) each
    return torch.stack([p.reshape(-1) for p in out])


def dd_times_i_power(planes: torch.Tensor, power: int) -> torch.Tensor:
    """``i^power`` times dd planes ``(..., 4, n)``, IN PLACE where it
    moves anything: swaps and negations of the planes, exact."""
    p = power % 4
    if p == 0:
        return planes
    rh, rl, ih, il = (planes[..., j, :] for j in range(4))
    if p == 2:
        return planes.neg_()
    re = torch.stack([rh, rl], dim=-2)
    im = torch.stack([ih, il], dim=-2)
    if p == 1:                       # (re, im) -> (-im, re)
        planes[..., 0:2, :] = -im
        planes[..., 2:4, :] = re
    else:                            # (re, im) -> (im, -re)
        planes[..., 0:2, :] = im
        planes[..., 2:4, :] = -re
    return planes


def dd_weighted(fac1, s1: torch.Tensor, fac2, s2: torch.Tensor, fac3,
                s3: torch.Tensor) -> torch.Tensor:
    """f1*s1 + f2*s2 + f3*s3 in dd complex arithmetic (the
    setWeightedQureg / mixDensityMatrix analogue), as fresh planes."""
    acc = None
    for f, s in ((fac1, s1), (fac2, s2), (fac3, s3)):
        f = complex(f)
        re = _scalar_tensor(_dd_scalar(f.real, s1.dtype), s1)
        im = _scalar_tensor(_dd_scalar(f.imag, s1.dtype), s1)
        acc = _cplx_mul_acc(acc, (re[0], re[1]), (im[0], im[1]),
                            (s[0], s[1], s[2], s[3]))
    return torch.stack(acc)


# --- compiled dd programs -------------------------------------------------------

_SWAP_MAT = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)
_X_MAT = np.array([[0, 1], [1, 0]], dtype=np.complex128)


class DDProgram:
    """A gate program compiled to the double-double amplitude path: the
    reference's quad-precision build analogue (``QuEST_precision.h:
    60-65``), as a list of dd steps run eagerly on ``(4, 2^n)`` planes.

    Supported ops (``ValueError`` at build time otherwise): static
    single-target dense gates with any control mask (X with at most one
    control lowers to the error-free permutation kernel), static diagonal
    gates on any qubit set (the phase family), and SWAP (three CNOT
    permutations — exact). Parameterised gates and multi-target dense
    gates run in the batched engine's QUAD rung instead.

    With a ``mesh`` (:class:`~quest_tpu_torch.parallel.mesh.Mesh`) the
    planes are sharded on the amplitude axis as every register's are: a
    state is a list of ``(4, 2^(n-s))`` chunks, one per shard. The program
    is scheduled by the layout planner (``parallel/layout.py``): a dense
    step on a sharded qubit waits for a relayout that makes it local
    (``parallel/exchange.py``, the four planes of a chunk moving
    together), a control on a device bit skips whole shards, a diagonal's
    device-bit axes are sliced per shard, and a final relayout restores
    the canonical order. Every step does per element what it does on one
    device, so the planes equal one device's bit for bit.

    Built by :meth:`quest_tpu_torch.circuits.Circuit.compile_dd`, on the
    environment's device or mesh. Constructed directly, it runs on
    ``cuda:0`` unless ``device`` names another device.
    """

    def __init__(self, ops, num_qubits: int, dtype=np.float32,
                 device=None, mesh=None):
        from ..env import _resolve_device
        self.num_qubits = num_qubits
        self.dtype = _np_dtype(dtype)
        self.mesh = mesh
        self.device = _resolve_device(device) if mesh is None \
            else mesh.devices[0]
        plan = []
        if mesh is None:
            for op in ops:
                plan.extend(self._lower(op))
        else:
            for op in ops:
                self._lower(op)          # the same subset is refused
            plan = self._lower_mesh(list(ops))
        self._plan = plan

    def _host_planes(self, z, device=None) -> torch.Tensor:
        return torch.from_numpy(_dd_split_host(z, self.dtype)).to(
            self.device if device is None else device)

    def _lower(self, op):
        n = self.num_qubits
        if not op.is_static:
            raise ValueError(
                "parameterised gates are not supported in dd mode")
        if op.kind == "diag":
            f_dd = self._host_planes(
                np.asarray(op.diag, np.complex128).reshape(-1))
            return [lambda p, f=f_dd, d=tuple(op.targets): _dd_diag_traced(
                p, f, n, d)]
        if op.kind != "u":
            raise ValueError(f"op kind {op.kind!r} unsupported in dd mode")
        if _is_swap(op):
            a, b = op.targets
            return [lambda p, t=t, c=c: dd_apply_perm_1q(p, n, t, c)
                    for t, c in ((a, b), (b, a), (a, b))]
        if len(op.targets) != 1:
            raise ValueError(
                "multi-target dense gates are not supported in dd mode")
        target = op.targets[0]
        if _is_perm_x(op):
            ctrl = op.ctrl_mask.bit_length() - 1 if op.ctrl_mask else -1
            return [lambda p, t=target, c=ctrl: dd_apply_perm_1q(p, n, t, c)]
        u_dd = self._host_planes(op.mat)
        cm, fm = op.ctrl_mask, op.flip_mask
        return [lambda p, u=u_dd, t=(target,), c=cm, f=fm: _masked(
            _dd_apply_kq_body(p, u, n, t), p, c, f)]

    def _lower_mesh(self, ops) -> list:
        """The mesh plan's items as steps on a list of chunks (each step
        replaces the entries it changes)."""
        from ..parallel.exchange import plan_exchange, run_exchange
        from ..parallel.layout import plan_layout
        n = self.num_qubits
        s = self.mesh.shard_bits
        lt = n - s
        devs = self.mesh.devices
        plan = plan_layout(ops, n, s)
        self.layout_plan = plan
        steps = []
        for item in plan.items:
            if item[0] == "relayout":
                ex = plan_exchange(n, s, tuple(int(p) for p in item[1]),
                                   tuple(int(p) for p in item[2]))
                steps.append(lambda ch, ex=ex: run_exchange(ch, ex))
                continue
            _, i, targets, cm, fm, axis_order = item
            op = ops[i]
            dev_c, loc_c = cm >> lt, cm & ((1 << lt) - 1)
            want, loc_f = dev_c & ~(fm >> lt), fm & ((1 << lt) - 1)
            shards = [d for d in range(len(devs))
                      if not dev_c or (d & dev_c) == want]
            if op.kind == "diag":
                f = np.transpose(np.asarray(op.diag, np.complex128),
                                 axis_order)
                dev_pos = [p for p in targets if p >= lt]
                loc_pos = tuple(p for p in targets if p < lt)
                per = [self._host_planes(f[tuple(
                    (d >> (p - lt)) & 1 for p in dev_pos)].reshape(-1),
                    devs[d]) for d in range(len(devs))]
                fns = {d: (lambda c, f=per[d], q=loc_pos: _dd_diag_traced(
                    c, f, lt, q)) for d in shards}
            elif _is_swap(op):
                a, b = targets
                fns = {d: (lambda c, a=a, b=b: dd_apply_perm_1q(
                    dd_apply_perm_1q(dd_apply_perm_1q(c, lt, a, b), lt, b,
                                     a), lt, a, b)) for d in shards}
            elif _is_perm_x(op):
                ctrl = loc_c.bit_length() - 1 if loc_c else -1
                fns = {d: (lambda c, t=targets[0], k=ctrl: dd_apply_perm_1q(
                    c, lt, t, k)) for d in shards}
            else:
                u_dd = {dev: self._host_planes(op.mat, dev)
                        for dev in set(devs)}
                fns = {d: (lambda c, u=u_dd[devs[d]], t=targets, lc=loc_c,
                           lf=loc_f: _masked(_dd_apply_kq_body(c, u, lt, t),
                                             c, lc, lf))
                       for d in shards}
            steps.append(lambda ch, fns=fns: [
                ch.__setitem__(d, fn(ch[d])) for d, fn in fns.items()])
        return steps

    @property
    def num_steps(self) -> int:
        """dd steps the program runs (a SWAP is three; on a mesh, one per
        plan item, a relayout included)."""
        return len(self._plan)

    # -- execution --------------------------------------------------------

    def _split_host(self, host: np.ndarray):
        """Host dd planes ``(4, 2^n)`` as the program's planes: one tensor,
        or on a mesh one chunk per shard."""
        if self.mesh is None:
            return torch.from_numpy(host).to(self.device)
        per = host.shape[1] // self.mesh.size
        return [torch.from_numpy(np.ascontiguousarray(
            host[:, d * per:(d + 1) * per])).to(dev)
            for d, dev in enumerate(self.mesh.devices)]

    def init_zero(self):
        if self.mesh is not None:
            per = (1 << self.num_qubits) // self.mesh.size
            chunks = [torch.zeros((4, per), dtype=_torch_dtype(self.dtype),
                                  device=dev) for dev in self.mesh.devices]
            chunks[0][0, 0] = 1.0
            return chunks
        planes = torch.zeros((4, 1 << self.num_qubits),
                             dtype=_torch_dtype(self.dtype),
                             device=self.device)
        planes[0, 0] = 1.0
        return planes

    def pack(self, host_state: np.ndarray):
        return self._split_host(_dd_split_host(
            np.asarray(host_state, np.complex128), self.dtype))

    def unpack(self, planes) -> np.ndarray:
        if isinstance(planes, (list, tuple)):
            planes = np.concatenate([c.cpu().numpy() for c in planes],
                                    axis=-1)
        return dd_unpack(planes)

    def run(self, planes):
        """Run every step on ``planes`` and return the result (fresh
        planes: the input is released once the first step has read it,
        when the caller keeps no reference; on a mesh a new list of
        chunks, in canonical order)."""
        if self.mesh is not None:
            chunks = list(planes)
            for step in self._plan:
                step(chunks)
            return chunks
        for step in self._plan:
            planes = step(planes)
        return planes

    def total_prob(self, planes) -> float:
        if isinstance(planes, (list, tuple)):
            import math
            return math.fsum(dd_total_prob(c) for c in planes)
        return dd_total_prob(planes)


def _is_swap(op) -> bool:
    return len(op.targets) == 2 and np.array_equal(op.mat, _SWAP_MAT) \
        and not op.ctrl_mask


def _is_perm_x(op) -> bool:
    """X with at most one control: the error-free permutation kernel."""
    return len(op.targets) == 1 and np.array_equal(op.mat, _X_MAT) \
        and not op.flip_mask and bin(op.ctrl_mask).count("1") <= 1
