"""Core gate-application engine on split re/im planes.

Counterpart of the JAX package's ``core/apply.py``. A register of ``N``
qubits is one ``(2, 2^N)`` float tensor (re plane, im plane) where bit ``q``
of the amplitude index is qubit ``q``. Viewed as ``(2,)*N`` in C order,
qubit ``q`` is axis ``N-1-q`` of each plane.

A complex ``2^k x 2^k`` operator ``u`` acts on the planes as the real
``2^(k+1)`` block operator ``[[Re u, -Im u], [Im u, Re u]]`` over the
stacked (plane, target) index, so every contraction is a real matmul and
no complex tensor is ever formed. The steps of the generic path:

1. view each plane with the target (and control) axes split out, with the
   plane axis treated as one more axis;
2. permute the control, plane and target axes to the front (a view);
3. index the controlled subspace (a view: only it is touched, the
   reference's ctrlMask skip, ``QuEST_cpu.c:2146-2210``);
4. one real matmul of the block operator with that subspace, copied back
   into the planes IN PLACE.

Two permute-free fast paths (the JAX package's ``core/apply.py:157-182``)
cover uncontrolled gates on the lowest ``k`` qubits (a right-matmul on the
``(rest, 2^k)`` view) and on a contiguous block of qubits (a batched
left-matmul on the ``(pre, 2^k, post)`` view). Both stay ``torch.matmul``
calls, as the JAX package leaves them to XLA.

Diagonal operators never pair amplitudes; :func:`apply_diagonal` is a
broadcast complex multiply, in place.

Both functions also take a BATCH of states, ``(B, 2, 2^N)`` planes: the
batched ensemble engine's form of the JAX package's ``jax.vmap`` over a
plan segment (``circuits.py:2600-2623``). The operator is then shared,
``(d, d)``, or one per state, ``(B, d, d)`` (a bound parameter per row);
the batch is a leading tensor dimension of every view and matmul, never a
Python loop, and the two fast paths stay permute-free.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "apply_unitary",
    "apply_diagonal",
    "bitmask",
    "permutation_to_order",
    "permutation_to_sorted_desc",
    "split_shape",
]


def bitmask(qubits: Sequence[int]) -> int:
    """OR of ``1 << q`` (the reference's ``getQubitBitMask``,
    ``QuEST_common.c:43-51``)."""
    m = 0
    for q in qubits:
        m |= 1 << int(q)
    return m


def split_shape(num_qubits: int,
                positions_desc: Sequence[int]) -> tuple[int, ...]:
    """Shape that splits the flat amplitude axis at each qubit position.

    ``positions_desc`` must be strictly descending qubit indices. The
    returned shape interleaves block axes with the 2-sized qubit axes; the
    axis of the i-th position is ``2*i + 1``.
    """
    shape = []
    upper = num_qubits
    for p in positions_desc:
        shape.append(1 << (upper - p - 1))
        shape.append(2)
        upper = p
    shape.append(1 << upper)
    return tuple(shape)


def permutation_to_order(targets: Sequence[int],
                         order: Sequence[int]) -> np.ndarray:
    """Index permutation re-expressing a gate matrix in a new bit order.

    The input matrix indexes bit ``j`` by ``targets[j]``; the output
    indexes bit ``i`` by ``order[i]`` (same qubit set).
    ``perm[m_new] = m_old``.
    """
    targets = tuple(targets)
    k = len(targets)
    perm = np.zeros(1 << k, dtype=np.int64)
    for mp in range(1 << k):
        m = 0
        for i, q in enumerate(order):
            if (mp >> i) & 1:
                m |= 1 << targets.index(q)
        perm[mp] = m
    return perm


def permutation_to_sorted_desc(targets: Sequence[int]) -> np.ndarray:
    """Index permutation mapping sorted-descending bit order to user
    order: ``perm[m_sorted] = m_user`` (the engine flattens target axes
    with the highest qubit as the most significant bit)."""
    targets = tuple(targets)
    k = len(targets)
    desc = sorted(targets, reverse=True)
    perm = np.zeros(1 << k, dtype=np.int64)
    for mp in range(1 << k):
        m = 0
        for i, q in enumerate(desc):
            if (mp >> (k - 1 - i)) & 1:
                m |= 1 << targets.index(q)
        perm[mp] = m
    return perm


def _operator(u, planes: torch.Tensor):
    """``(re, im)`` of a ``(d, d)`` or ``(B, d, d)`` operator — numpy, or a
    (complex) tensor already on the device — in the planes' dtype and on
    their device."""
    if isinstance(u, torch.Tensor):
        return (u.real.to(planes.dtype, copy=False),
                u.imag.to(planes.dtype, copy=False)) if u.is_complex() \
            else (u.to(planes.dtype), torch.zeros_like(u, dtype=planes.dtype))
    u = np.asarray(u, dtype=np.complex128)
    return tuple(torch.as_tensor(np.ascontiguousarray(p), dtype=planes.dtype,
                                 device=planes.device)
                 for p in (u.real, u.imag))


def _permuted(ur, ui, perm: np.ndarray):
    """Re-index both operator axes by ``perm`` (``u[perm][:, perm]``)."""
    idx = torch.as_tensor(perm, device=ur.device)
    return (ur.index_select(-2, idx).index_select(-1, idx),
            ui.index_select(-2, idx).index_select(-1, idx))


def _as_batch(planes: torch.Tensor, num_qubits: int):
    """``(B, 2, 2^N)`` view of one register's ``(2, 2^N)`` planes or of a
    batch."""
    if planes.dim() == 2:
        planes = planes.unsqueeze(0)
    if planes.dim() != 3 or tuple(planes.shape[1:]) != (2, 1 << num_qubits):
        raise ValueError(f"planes have shape {tuple(planes.shape)}; expected "
                         f"(2, {1 << num_qubits}) or (B, 2, "
                         f"{1 << num_qubits})")
    return planes


def apply_unitary(planes: torch.Tensor, num_qubits: int, u,
                  targets: Sequence[int], ctrl_mask: int = 0,
                  flip_mask: int = 0,
                  precision: Optional[str] = None) -> torch.Tensor:
    """Apply a ``2^k x 2^k`` operator to target qubits, IN PLACE on the
    ``(2, 2^N)`` planes or ``(B, 2, 2^N)`` batch (which is also returned).

    ``u`` is a ``(d, d)`` operator shared by the batch or a ``(B, d, d)``
    stack with one per state, as numpy or as a (complex) device tensor
    (bit ``j`` of its index addresses ``targets[j]``, the reference's
    ComplexMatrixN convention). ``ctrl_mask`` selects control qubits; a
    control conditions on bit value 1 unless its bit is also set in
    ``flip_mask`` (then on 0) — the mask semantics of
    ``statevec_multiControlledUnitary`` (``QuEST_cpu.c:2146``).

    ``precision`` is the tier's matmul precision, ``"highest"`` (the
    default) or ``"default"`` (the FAST tier). Both run full float32
    products here: the FAST tier's reduced-precision inputs live in the
    fused layers' dense stages (``ops/layer_kernel.py``), and the plain
    gate path keeps the precision the environment pins
    (``allow_tf32 = False``, ``env.py``), well inside the tier's budget.
    """
    if precision not in (None, "highest", "default"):
        raise ValueError(f"unknown matmul precision {precision!r}; expected "
                         "'highest' or 'default'")
    x = _as_batch(planes, num_qubits)
    batch = x.shape[0]
    targets = tuple(int(t) for t in targets)
    k = len(targets)
    d = 1 << k
    ur, ui = _operator(u, x)
    if ur.dim() == 3 and ur.shape[0] != batch:
        raise ValueError(f"{ur.shape[0]} operators for a batch of {batch}")
    per_row = ur.dim() == 3
    controls = tuple(q for q in range(num_qubits) if (ctrl_mask >> q) & 1)

    # --- no-permute fast paths (uncontrolled, contiguous targets) --------
    if not controls and set(targets) == set(range(k)):
        # lowest k qubits: right-matmul on the (B, rest, 2^k) view
        if targets != tuple(range(k)):
            ur, ui = _permuted(ur, ui,
                               permutation_to_order(targets, tuple(range(k))))
        ur_t, ui_t = ur.transpose(-1, -2), ui.transpose(-1, -2)
        v = x.view(batch, 2, -1, d)
        re, im = v[:, 0], v[:, 1]
        if per_row:
            new_re = torch.bmm(re, ur_t)
            new_re.baddbmm_(im, ui_t, alpha=-1.0)
            new_im = torch.bmm(re, ui_t)
            new_im.baddbmm_(im, ur_t)
        else:
            # one (B * rest, 2^k) matrix (a view when B == 1)
            re2, im2 = re.reshape(-1, d), im.reshape(-1, d)
            new_re = torch.matmul(re2, ur_t)
            new_re.addmm_(im2, ui_t, alpha=-1.0)
            new_im = torch.matmul(re2, ui_t)
            new_im.addmm_(im2, ur_t)
            new_re, new_im = new_re.view(re.shape), new_im.view(im.shape)
        re.copy_(new_re)
        im.copy_(new_im)
        return planes
    lo = min(targets) if targets else 0
    if not controls and set(targets) == set(range(lo, lo + k)):
        # contiguous block [lo, lo+k): batched left-matmul on the
        # (B, pre, 2^k, post) view — bit i of the middle index is qubit
        # lo+i; a per-state operator broadcasts over pre as (B, 1, d, d)
        order = tuple(range(lo, lo + k))
        if targets != order:
            ur, ui = _permuted(ur, ui, permutation_to_order(targets, order))
        if per_row:
            ur, ui = ur.unsqueeze(1), ui.unsqueeze(1)
        v = x.view(batch, 2, -1, d, 1 << lo)
        re, im = v[:, 0], v[:, 1]
        new_re = torch.matmul(ur, re)
        new_re.sub_(torch.matmul(ui, im))
        new_im = torch.matmul(ui, re)
        new_im.add_(torch.matmul(ur, im))
        re.copy_(new_re)
        im.copy_(new_im)
        return planes

    pos_desc = tuple(sorted(targets + controls, reverse=True))
    # axes 0 and 1 are the batch and plane axes; each plane splits as
    # split_shape
    shape = (batch, 2) + split_shape(num_qubits, pos_desc)
    axis_of = {p: 2 * i + 3 for i, p in enumerate(pos_desc)}
    ctrl_axes = [axis_of[c] for c in controls]
    targ_axes = [axis_of[t] for t in sorted(targets, reverse=True)]
    moved = set(ctrl_axes) | set(targ_axes)
    rest_axes = [ax for ax in range(2, len(shape)) if ax not in moved]
    perm = ctrl_axes + [0, 1] + targ_axes + rest_axes

    arr = x.view(shape).permute(perm)
    ctrl_idx = tuple(0 if (flip_mask >> c) & 1 else 1 for c in controls)
    sub = arr[ctrl_idx] if controls else arr

    row_perm = permutation_to_sorted_desc(targets)
    if not np.array_equal(row_perm, np.arange(d)):
        ur, ui = _permuted(ur, ui, row_perm)
    block = torch.cat([torch.cat([ur, -ui], -1), torch.cat([ui, ur], -1)],
                      -2)
    new = torch.matmul(block, sub.reshape(batch, 2 * d, -1))
    sub.copy_(new.view(sub.shape))
    return planes


def apply_diagonal(planes: torch.Tensor, num_qubits: int,
                   qubits: Sequence[int], diag_tensor) -> torch.Tensor:
    """Multiply amplitudes by a per-bit-pattern factor, IN PLACE on the
    ``(2, 2^N)`` planes or ``(B, 2, 2^N)`` batch.

    ``diag_tensor`` has shape ``(2,)*k`` (shared) or ``(B,) + (2,)*k`` (one
    per state); axis ``i`` of the factor is indexed by the bit of the i-th
    qubit of ``qubits`` *sorted descending*. One pass, no amplitude
    pairing — every phase-family gate.
    """
    x = _as_batch(planes, num_qubits)
    batch = x.shape[0]
    pos_desc = tuple(sorted((int(q) for q in qubits), reverse=True))
    k = len(pos_desc)
    shape = split_shape(num_qubits, pos_desc)
    dr, di = _operator(diag_tensor, x)
    lead = dr.shape[0] if dr.dim() == k + 1 else 1
    if lead not in (1, batch):
        raise ValueError(f"{lead} diagonal factors for a batch of {batch}")
    bshape = [lead] + [1] * len(shape)
    for i in range(k):
        bshape[2 * i + 2] = 2
    dr, di = dr.reshape(bshape), di.reshape(bshape)
    re = x[:, 0].view((batch,) + shape)
    im = x[:, 1].view((batch,) + shape)
    t = re * di
    re.mul_(dr).sub_(im * di)
    im.mul_(dr).add_(t)
    return planes
