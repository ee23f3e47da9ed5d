"""Fused gate-layer kernel: one HBM pass for many gates.

Counterpart of the JAX package's ``ops/pallas_kernels.py`` layer kernel
(``_layer_kernel`` via ``apply_layer``). A *layer* of gates whose targets
fall inside one tile of the state is a linear map acting tile-locally, so
one kernel can stream the state through on-chip memory once and apply the
whole layer: an L-gate layer costs one memory pass instead of L.

Qubit classes, with the state viewed as ``(rows, 128)`` float planes:

- **lane qubits** (0..6): bits inside the 128-wide row. Any static gate
  whose targets all live here is a 128x128 matrix on the lane axis;
  runs of them multiply into one matrix (``lane``; ``clane`` applies it
  only to rows whose global row index matches a control mask).
- **row qubits** (>= 7): bits of the row index. Dense gates whose target
  bits lie inside the tile pair or group rows (``row``, ``rowk``);
  diagonal factors over up to three row bits become per-row factor tables
  (``rowdiag``); a dense uncontrolled gate may also run as one packed
  ``(2^j * 128)``-dim contraction over the lanes plus ``j`` row bits
  (``rowmxu``).

A layer is an ordered list of stages (:class:`LayerOp`), collected by
``circuits._collect_layers_plan``. On a CUDA tensor :func:`apply_layer`
launches the hand-written kernel in ``csrc/layer_kernel.cu`` (built with
``nvcc`` at first use, ``ops/cuda_build.py``); on a CPU tensor it runs
:func:`apply_layer_plain`, a plain PyTorch version of the same function. A
CUDA tensor never reaches the plain version: the kernel launches or the
call raises. :func:`apply_layer_batched` applies one layer to every state
of a ``(B, 2, 2^n)`` batch in one launch of the same kernel (the TPU
kernel's batch grid, ``pallas_kernels.apply_layer_batched``); row
coordinates stay per state, and :func:`apply_layer_batched_plain` is its
plain version. A layer of ``rowdiag`` stages only needs no tile (each
amplitude's factors depend on its own row and lane): it takes the kernel's
streaming entry, one pass over the planes straight from HBM, counted in
``diag_launches`` too (:func:`launch_entry`).

The tile height comes from Hopper's shared memory, not from TPU VMEM: one
block holds a ``tile_rows x 128`` tile of both planes (128 KiB at either
dtype: 128 rows of float32, 64 of float64), and beside it the ring through
which the full-precision lane stage streams its operator
(:func:`lane_scratch_bytes`, 64 KiB). ``max_mid_qubit(tile_rows)``
bounds which row bits a dense stage may target, and the collector reads it
through :func:`tile_rows_for`, so the CPU and the card plan one plan.

``fast=True`` is the FAST precision tier (the TPU kernel's ``fast`` flag,
``pallas_kernels.py:237-260, 339-355``): the dense stages (``lane``,
``clane``, ``rowmxu``) split the state into ``hi = bf16(v)`` and ``lo =
bf16(v - hi)``, round the operator to bf16 and take the four real products
for each part with float32 accumulation, combined as ``(rr_h - ii_h) +
(rr_l - ii_l)`` and ``(ri_h + ir_h) + (ri_l + ir_l)``. On the card these
products run on the bf16 tensor cores; ``row``, ``rowk`` and ``rowdiag``
stay full float32. FAST planes are float32, and the FAST kernel keeps the
float32 tile of 128 rows: a dense stage holds its outputs in registers and
streams its bf16 operator (packed by :func:`fast_operator_slabs`) and its
bf16 inputs through a two-stage ring beside the tile
(:func:`fast_scratch_bytes`, at most 72 KiB; see ``csrc/dense_stage.cuh``).
:func:`apply_mxu_tile` is the standalone form of one ``rowmxu`` stage
(``pallas_kernels.apply_mxu_tile``), at either precision.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from collections import OrderedDict
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import matrices as mats
from ..core.apply import split_shape
from . import cuda_build

LANE_QUBITS = 7          # 2^7 = 128 lanes
LANES = 1 << LANE_QUBITS

# rows of one kernel tile per plane dtype: 2 planes x rows x 128 x itemsize
# = 128 KiB of dynamic shared memory per block at either dtype
TILE_ROWS = {torch.float32: 128, torch.float64: 64}
# Hopper's per-block shared-memory ceiling (227 KiB, opt-in above 48 KiB)
SMEM_LIMIT_BYTES = 232448

# descriptor layout shared with csrc/layer_kernel.cu: one int64 row per
# stage, [tag, k_or_j, packed_bits, pool_offset, lane_mask, lane_want,
# row_mask, row_want]; packed_bits holds bit i of the stage in byte i
DESC_WIDTH = 8
TAG_DENSE, TAG_ROWK, TAG_ROWDIAG = 0, 1, 2
# the kernel's template instances: dense stages over the lanes plus
# 0..2 row bits (the collector's MXU_ROW_CAP), rowk on 1..3 row bits
MAX_DENSE_ROW_BITS, MAX_ROWK_BITS = 2, 3
# the FAST dense stage (csrc/dense_stage.cuh stage_dense_fast): inputs per
# K slab, one mma.m16n8k16 k-step
FAST_K = 16
# the full-precision lane stage (csrc/dense_stage.cuh stage_dense_lane):
# inputs per K slab by plane itemsize, 16 KiB of each operator plane
LANE_K = {4: 32, 8: 16}
# the streaming entry for rowdiag-only layers (csrc/layer_kernel.cu
# kDiagTableCap): tables up to this many bytes sit in shared memory, 7
# stages x 8 x 128 complex float64
DIAG_TABLE_CAP = 112 * 1024

__all__ = ["LANE_QUBITS", "TILE_ROWS", "LayerOp", "adjoint_layer",
           "embed_lane_matrix",
           "lane_diag_matrix", "lane_diag_vector", "max_mid_qubit",
           "tile_rows_for", "mxu_group_matrix", "mxu_expand",
           "layer_kernel_plan", "shared_memory_bytes", "fast_scratch_bytes",
           "lane_scratch_bytes", "is_diagonal_layer", "launch_entry",
           "mark_rowdiag_runs", "fast_operator_slabs", "apply_layer",
           "apply_layer_plain", "apply_layer_batched",
           "apply_layer_batched_plain", "apply_mxu_tile",
           "apply_mxu_tile_plain", "build_library", "pack_layer",
           "is_packed", "packed_operands", "install_packed"]


def embed_lane_matrix(u: np.ndarray, targets: Sequence[int],
                      ctrl_mask: int = 0, flip_mask: int = 0) -> np.ndarray:
    """Embed a gate on lane qubits into the full 128x128 lane operator
    (bit ``j`` of the gate's index addresses ``targets[j]``, the
    ComplexMatrixN convention; controls condition on 1 unless flipped)."""
    k = len(targets)
    dim = LANES
    full = np.zeros((dim, dim), dtype=np.complex128)
    t_mask = 0
    for t in targets:
        t_mask |= 1 << t
    want = ctrl_mask & ~flip_mask
    for col in range(dim):
        if (col & ctrl_mask) != want:
            full[col, col] = 1.0
            continue
        m = 0
        for j, t in enumerate(targets):
            if (col >> t) & 1:
                m |= 1 << j
        base = col & ~t_mask
        for m2 in range(1 << k):
            row = base
            for j, t in enumerate(targets):
                if (m2 >> j) & 1:
                    row |= 1 << t
            full[row, col] += u[m2, m]
    return full


def lane_diag_vector(tensor: np.ndarray,
                     qubits_desc: Sequence[int]) -> np.ndarray:
    """Evaluate a diagonal factor tensor ((2,)*k, axes = lane qubits sorted
    desc) into a per-lane factor vector of length 128."""
    d = np.ones(LANES, dtype=np.complex128)
    k = len(qubits_desc)
    for lane in range(LANES):
        idx = tuple((lane >> q) & 1 for q in qubits_desc)
        d[lane] = tensor[idx] if k else tensor[()] if tensor.ndim == 0 \
            else 1.0
    return d


def lane_diag_matrix(tensor: np.ndarray,
                     qubits_desc: Sequence[int]) -> np.ndarray:
    """Embed a diagonal factor tensor over lane qubits as a diagonal
    128x128 operator."""
    return np.diag(lane_diag_vector(tensor, qubits_desc))


def max_mid_qubit(tile_rows: int) -> int:
    """Highest qubit a dense (row-pairing) stage can target for a given
    tile height. Controls and diagonal factors address ANY row bit (they
    read the global row index), so this bounds targets only."""
    return LANE_QUBITS + int(np.log2(tile_rows)) - 1


def tile_rows_for(dtype: torch.dtype) -> int:
    """The kernel's tile height for a plane dtype."""
    try:
        return TILE_ROWS[dtype]
    except KeyError:
        raise ValueError(f"layer kernel planes must be float32 or float64, "
                         f"got {dtype}") from None


def mxu_group_matrix(u: np.ndarray, targets: Sequence[int],
                     row_bits_asc: Sequence[int]) -> np.ndarray:
    """Embed a dense (uncontrolled) gate into the packed contraction
    operator over ``(lane qubits 0..6) + (row bits + 7)``: a
    ``(2^j * 128)``-square matrix whose index bit ``l < 7`` is lane bit
    ``l`` and bit ``7 + m`` is row bit ``row_bits_asc[m]`` — the flat
    ``b * 128 + lane`` axis the ``rowmxu`` stage contracts."""
    sup = tuple(range(LANE_QUBITS)) + tuple(
        int(b) + LANE_QUBITS for b in row_bits_asc)
    return mats.embed_in_support(np.asarray(u, np.complex128), targets, sup)


def mxu_expand(m: np.ndarray, prev_bits: Sequence[int],
               union_bits: Sequence[int]) -> np.ndarray:
    """Expand a packed operator over ``(lanes + prev_bits)`` to the
    superset support ``(lanes + union_bits)`` (identity on the new row
    bits)."""
    prev_bits = tuple(int(b) for b in prev_bits)
    union_bits = tuple(int(b) for b in union_bits)
    dim_u = (1 << len(union_bits)) * LANES
    idx = np.arange(dim_u)
    a_p = idx & (LANES - 1)
    a_e = np.zeros_like(idx)
    e = 0
    for mpos, b in enumerate(union_bits):
        bit = (idx >> (LANE_QUBITS + mpos)) & 1
        if b in prev_bits:
            a_p = a_p | (bit << (LANE_QUBITS + prev_bits.index(b)))
        else:
            a_e = a_e | (bit << e)
            e += 1
    return np.asarray(m)[a_p[:, None], a_p[None, :]] \
        * (a_e[:, None] == a_e[None, :])


class LayerOp:
    """A fused layer: an ordered list of stages applied in one HBM pass.

    Stage forms (bit positions are physical qubit positions; row masks and
    row bits are in row-bit coordinates, bit ``p`` = qubit ``p+7``):

    - ``("lane", M)`` — 128x128 complex matrix on the lane axis;
    - ``("clane", M, row_mask, row_want)`` — lane matrix applied only to
      rows with ``(row & row_mask) == row_want``;
    - ``("row", q, u2x2, lane_mask, lane_want, row_mask, row_want)`` —
      dense 2x2 on row-bit target ``q`` (>= 7) under lane and row
      controls;
    - ``("rowk", bits, u, lane_mask, lane_want, row_mask, row_want)`` —
      dense ``2^k x 2^k`` gate (k <= 3) on ascending row bits ``bits``;
      gate-index bit ``j`` addresses ``bits[j]``;
    - ``("rowdiag", table, row_bits)`` — per-amplitude factor from the
      complex ``(2^k, 128)`` table row picked by the global row index's
      bits at ``row_bits`` (ascending);
    - ``("rowmxu", row_bits, M)`` — packed contraction: the ``j`` row bits
      pack with the lanes into one ``(2^j * 128)``-dim axis and ``M`` is
      the complex operator over it (see :func:`mxu_group_matrix`).

    Quacks enough like ``circuits._Op`` for the executor
    (kind/targets/masks/is_static).
    """

    kind = "layer"
    ctrl_mask = 0
    flip_mask = 0
    is_static = True
    mat_fn = None
    diag_fn = None

    def __init__(self, num_qubits: int, members: int, stages: list,
                 support: Optional[set] = None):
        self.num_qubits = num_qubits
        self.members = members            # how many recorded ops were fused
        self.stages = stages
        # device operands of this layer, packed once per (dtype, device)
        self._packed: dict = {}
        if support is None:
            support = set()
            for st in stages:
                if st[0] in ("lane", "clane"):
                    support |= set(range(min(LANE_QUBITS, num_qubits)))
                elif st[0] == "row":
                    support.add(st[1])
                elif st[0] in ("rowk", "rowmxu"):
                    if st[0] == "rowmxu":
                        support |= set(range(min(LANE_QUBITS,
                                                 num_qubits)))
                    support |= {b + LANE_QUBITS for b in st[1]}
                else:
                    support |= {b + LANE_QUBITS for b in st[2]}
        self.targets = tuple(sorted(support))


def adjoint_layer(layer: LayerOp) -> LayerOp:
    """The layer's adjoint: its stages in reverse order, each stage's
    operator conjugate-transposed (a ``rowdiag`` table conjugated), every
    mask and row bit as it was. A unitary layer's adjoint undoes it. It is
    a layer like any other: packed once for its device (FAST slabs too)
    and launched by :func:`apply_layer` / :func:`apply_layer_batched`,
    whose plain versions take it on the CPU."""
    def dagger(m):
        return np.ascontiguousarray(np.conj(np.asarray(m)).T)

    stages = []
    for st in reversed(layer.stages):
        tag = st[0]
        if tag in ("lane", "clane"):
            stages.append((tag, dagger(st[1])) + tuple(st[2:]))
        elif tag in ("row", "rowk", "rowmxu"):
            stages.append((tag, st[1], dagger(st[2])) + tuple(st[3:]))
        else:
            stages.append(("rowdiag", np.conj(np.asarray(st[1])), st[2]))
    return LayerOp(layer.num_qubits, layer.members, stages,
                   support=set(layer.targets))


def layer_kernel_plan(layer: LayerOp, num_qubits: int, tile_rows: int):
    """The static kernel plan for one fused layer: validated stage
    descriptors plus the matrix/table operands, in the JAX package's
    ``layer_kernel_plan`` form so the two compare stage by stage.

    Returns ``(kstages, mats, tables, xmats, tile_rows, total_rows)``;
    ``tile_rows`` is clipped to the register's row count.
    """
    total_rows = (1 << num_qubits) // LANES
    if total_rows < 1:
        raise ValueError("fused layers need at least 7 qubits")
    tile_rows = min(tile_rows, total_rows)
    hi = max_mid_qubit(tile_rows)

    lane_mats: list[np.ndarray] = []
    tables: list[np.ndarray] = []
    xmats: list[np.ndarray] = []
    kstages: list[tuple] = []
    for st in layer.stages:
        if st[0] in ("lane", "clane"):
            if st[0] == "lane":
                m, row_mask, row_want = st[1], 0, 0
            else:
                _, m, row_mask, row_want = st
            kstages.append(("lane", len(lane_mats), int(row_mask),
                            int(row_want)))
            lane_mats.append(np.ascontiguousarray(m))
        elif st[0] == "row":
            _, q, u, lane_mask, lane_want, row_mask, row_want = st
            if not LANE_QUBITS <= q <= hi:
                raise ValueError(
                    f"row-gate target {q} outside [{LANE_QUBITS}, {hi}]")
            u = np.asarray(u)
            kstages.append((
                "row", 1 << (q - LANE_QUBITS),
                (float(u[0, 0].real), float(u[0, 0].imag),
                 float(u[0, 1].real), float(u[0, 1].imag),
                 float(u[1, 0].real), float(u[1, 0].imag),
                 float(u[1, 1].real), float(u[1, 1].imag)),
                int(lane_mask), int(lane_want),
                int(row_mask), int(row_want)))
        elif st[0] == "rowk":
            _, bits, u, lane_mask, lane_want, row_mask, row_want = st
            bits = tuple(int(b) for b in bits)
            if bits and bits[-1] + LANE_QUBITS > hi:
                raise ValueError(
                    f"rowk bit {bits[-1]} outside tile row range")
            u = np.asarray(u)
            kstages.append((
                "rowk", bits,
                tuple((float(z.real), float(z.imag)) for z in u.reshape(-1)),
                int(lane_mask), int(lane_want),
                int(row_mask), int(row_want)))
        elif st[0] == "rowmxu":
            _, bits, m = st
            bits = tuple(int(b) for b in bits)
            if bits and bits[-1] + LANE_QUBITS > hi:
                raise ValueError(
                    f"rowmxu bit {bits[-1]} outside tile row range")
            m = np.asarray(m)
            dim = (1 << len(bits)) * LANES
            if m.shape != (dim, dim):
                raise ValueError(
                    f"rowmxu matrix shape {m.shape} != {(dim, dim)}")
            kstages.append(("rowmxu", bits, len(xmats), dim))
            xmats.append(np.ascontiguousarray(m))
        else:
            _, table, bits = st
            kstages.append(("rowdiag", len(tables),
                            tuple(int(b) for b in bits)))
            tables.extend(np.asarray(table))
    return kstages, lane_mats, tables, xmats, tile_rows, total_rows


def fast_scratch_bytes(max_j: int) -> int:
    """Shared memory of the FAST dense stage's ring beside the tile, for a
    layer whose widest dense stage packs ``max_j`` row bits: two stages of
    the largest (operator slab + A slab) a dense stage on ``0..max_j`` row
    bits needs. Mirrors ``fast_scratch_bytes`` in
    ``csrc/dense_stage.cuh``."""
    if not 0 <= max_j <= MAX_DENSE_ROW_BITS:
        raise ValueError(f"max_j {max_j} outside [0, {MAX_DENSE_ROW_BITS}]")
    rows = TILE_ROWS[torch.float32]

    def stage(j: int) -> int:
        op_slab = FAST_K * 2 * (LANES << j) * 2     # (re, im) x bf16
        a_slab = (rows >> j) * FAST_K * 4 * 2       # (hi, lo) x (re, im)
        return op_slab + a_slab
    return 2 * max(stage(j) for j in range(max_j + 1))


def lane_scratch_bytes(itemsize: int) -> int:
    """Shared memory of the full-precision lane stage's ring beside the
    tile: two stages of one K slab of both operator planes (``LANE_K``
    inputs x 128 outputs x (re, im)), 64 KiB at either dtype. Mirrors
    ``lane_scratch_bytes`` in ``csrc/dense_stage.cuh``."""
    if itemsize not in LANE_K:
        raise ValueError(f"planes of {itemsize}-byte values have no lane "
                         f"stage; itemsize is one of {sorted(LANE_K)}")
    return 2 * LANE_K[itemsize] * LANES * 2 * itemsize


def shared_memory_bytes(tile_rows: int, itemsize: int,
                        fast_max_j: Optional[int] = None) -> int:
    """Dynamic shared memory one block needs: the tile of both planes,
    plus the ring of its dense stages: with ``fast_max_j`` (a FAST
    launch) :func:`fast_scratch_bytes`, else (every full-precision launch
    of the layer kernel, and the Kraus kernel) the lane stage's
    :func:`lane_scratch_bytes`. Every stage updates the tile in place
    (through registers), so the need does not grow with the stage count —
    the TPU kernel's VMEM working-set estimate has no counterpart here."""
    need = 2 * tile_rows * LANES * itemsize
    if fast_max_j is None:
        need += lane_scratch_bytes(itemsize)
    else:
        need += fast_scratch_bytes(fast_max_j)
    if need > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"a {tile_rows}-row tile needs {need} B of shared memory; "
            f"Hopper allows {SMEM_LIMIT_BYTES} B per block")
    return need


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path, and the card-side reference)
# ---------------------------------------------------------------------------

def _u2(coefs) -> np.ndarray:
    ar, ai, br, bi, cr, ci, dr, di = coefs
    return np.array([[ar + 1j * ai, br + 1j * bi],
                     [cr + 1j * ci, dr + 1j * di]])


def _block(u: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    u = np.asarray(u, dtype=np.complex128)
    return torch.as_tensor(np.block([[u.real, -u.imag], [u.imag, u.real]]),
                           dtype=like.dtype, device=like.device)


def _grouped(x: torch.Tensor, rlog: int, bits: tuple, with_lanes: bool):
    """Permuted view of the (B, 2, rows, 128) planes bringing the batch and
    plane axes, the row-bit axes ``bits`` (descending, so bit m of the
    combined index is ``bits[m]``) and optionally the lane axis to the
    front. Returns ``(view, rest_row_axes)``."""
    desc = tuple(sorted(bits, reverse=True))
    shape = (x.shape[0], 2) + split_shape(rlog, desc) + (LANES,)
    lane_axis = len(shape) - 1
    targ = [2 * i + 3 for i in range(len(desc))]
    rest = [a for a in range(2, lane_axis) if a not in targ]
    front = [0, 1] + targ + ([lane_axis] if with_lanes else [])
    back = rest + ([] if with_lanes else [lane_axis])
    return x.view(shape).permute(front + back), desc


def _row_index_rest(total_rows: int, desc: tuple, device) -> torch.Tensor:
    """Row index (within the state) of each group's first row (target bits
    zero), in the order of the rest axes of :func:`_grouped`."""
    rlog = total_rows.bit_length() - 1
    g = torch.arange(total_rows, device=device).view(split_shape(rlog, desc))
    return g[tuple(slice(None) if a % 2 == 0 else 0
                   for a in range(g.dim()))]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and back: the value a bf16 operand of
    the tensor cores (or of the TPU's matrix unit) holds."""
    return t.to(torch.bfloat16).to(t.dtype)


def _complex_product(a_re, a_im, b_re, b_im, fast: bool, left: bool):
    """``(a_re + i a_im)`` times ``(b_re + i b_im)`` as real matmuls: the
    state ``a`` on the left (``left=False``: ``v @ M^T``, the lane stage)
    or the operator ``b`` on the left (``left=True``: ``M @ v``, the
    grouped stages). ``fast`` takes the FAST function of the TPU kernel's
    ``_mxu_matmuls``: bf16 hi and lo parts of the state, a bf16 operator,
    four float32-accumulated products for each part, combined as
    ``(rr_h - ii_h) + (rr_l - ii_l)``, ``(ri_h + ir_h) + (ri_l + ir_l)``."""
    def mm(v, w):
        return torch.matmul(w, v) if left else torch.matmul(v, w)

    if not fast:
        new_re = mm(a_re, b_re)
        new_re.sub_(mm(a_im, b_im))
        new_im = mm(a_re, b_im)
        new_im.add_(mm(a_im, b_re))
        return new_re, new_im
    # in-place sums in the order of the expressions above, so a 30-qubit
    # state's temporaries stay a few planes
    b_re, b_im = _bf16(b_re), _bf16(b_im)
    h_re, h_im = _bf16(a_re), _bf16(a_im)
    new_re = mm(h_re, b_re).sub_(mm(h_im, b_im))
    new_im = mm(h_re, b_im).add_(mm(h_im, b_re))
    l_re = _bf16(a_re - h_re)
    del h_re
    l_im = _bf16(a_im - h_im)
    del h_im
    new_re.add_(mm(l_re, b_re).sub_(mm(l_im, b_im)))
    new_im.add_(mm(l_re, b_im).add_(mm(l_im, b_re)))
    return new_re, new_im


def _dense_plain(x, total_rows, bits, m, row_mask=0, row_want=0,
                 fast=False):
    """out = M v over the packed (row bits, lanes) axis; ``bits == ()`` is
    the lane stage, run permute-free on the (B, rows, 128) views. ``fast``
    as in :func:`_complex_product`."""
    if not bits:
        re, im = x[:, 0], x[:, 1]
        mr_t, mi_t = (torch.as_tensor(np.ascontiguousarray(p.T),
                                      dtype=x.dtype, device=x.device)
                      for p in (m.real, m.imag))
        new_re, new_im = _complex_product(re, im, mr_t, mi_t, fast,
                                          left=False)
        if row_mask:
            g = torch.arange(total_rows, device=x.device).view(-1, 1)
            cond = (g & row_mask) == row_want
            new_re = torch.where(cond, new_re, re)
            new_im = torch.where(cond, new_im, im)
        re.copy_(new_re)
        im.copy_(new_im)
        return
    rlog = total_rows.bit_length() - 1
    sub, _ = _grouped(x, rlog, bits, with_lanes=True)
    dim = (1 << len(bits)) * LANES
    if not fast:
        new = torch.matmul(_block(m, x),
                           sub.reshape(x.shape[0], 2 * dim, -1))
        sub.copy_(new.view(sub.shape))
        return
    v = sub.reshape(x.shape[0], 2, dim, -1)
    mr, mi = (torch.as_tensor(np.ascontiguousarray(p), dtype=x.dtype,
                              device=x.device) for p in (m.real, m.imag))
    new_re, new_im = _complex_product(v[:, 0], v[:, 1], mr, mi, fast,
                                      left=True)
    sub[:, 0].copy_(new_re.view(sub[:, 0].shape))
    sub[:, 1].copy_(new_im.view(sub[:, 1].shape))


def _rowk_plain(x, total_rows, bits, u, lane_mask, lane_want, row_mask,
                row_want):
    rlog = total_rows.bit_length() - 1
    sub, desc = _grouped(x, rlog, bits, with_lanes=False)
    dim = 1 << len(bits)
    flat = sub.reshape(x.shape[0], 2 * dim, -1)
    new = torch.matmul(_block(u, x), flat)
    if lane_mask or row_mask:
        rest_shape = sub.shape[2 + len(bits):]
        cond = torch.ones(rest_shape, dtype=torch.bool, device=x.device)
        if row_mask:
            g0 = _row_index_rest(total_rows, desc, x.device)
            cond = cond & ((g0 & row_mask) == row_want).unsqueeze(-1)
        if lane_mask:
            lane = torch.arange(LANES, device=x.device)
            cond = cond & ((lane & lane_mask) == lane_want)
        new = torch.where(cond.reshape(1, 1, -1), new, flat)
    sub.copy_(new.view(sub.shape))


def _rowdiag_plain(x, total_rows, table, bits):
    g = torch.arange(total_rows, device=x.device)
    cfg = torch.zeros_like(g)
    for j, b in enumerate(bits):
        cfg |= ((g >> b) & 1) << j
    t = np.asarray(table)
    fr = torch.as_tensor(t.real, dtype=x.dtype, device=x.device)[cfg]
    fi = torch.as_tensor(t.imag, dtype=x.dtype, device=x.device)[cfg]
    re, im = x[:, 0], x[:, 1]
    new_re = re * fr - im * fi
    im.mul_(fr).add_(re * fi)
    re.copy_(new_re)


def apply_layer_batched_plain(states: torch.Tensor, num_qubits: int,
                              layer: LayerOp,
                              fast: bool = False) -> torch.Tensor:
    """The fused layer as plain PyTorch tensor ops on every state of a
    ``(B, 2, 2^n)`` batch, stage after stage over the whole states, IN
    PLACE. It computes what the kernel computes (the same plan, the same
    ``hi``; rows counted within each state) and is the reference the
    kernel is held against. ``fast`` runs the dense stages as the FAST
    tier's bf16-split products (float32 planes only)."""
    if fast:
        _check_fast_dtype(states.dtype, "apply_layer_batched_plain")
    kstages, lane_mats, tables, xmats, _, total_rows = layer_kernel_plan(
        layer, num_qubits, tile_rows_for(states.dtype))
    x = states.view(states.shape[0], 2, total_rows, LANES)
    for st in kstages:
        tag = st[0]
        if tag == "lane":
            _, mi, row_mask, row_want = st
            _dense_plain(x, total_rows, (), lane_mats[mi], row_mask,
                         row_want, fast)
        elif tag == "rowmxu":
            _, bits, xi, _ = st
            _dense_plain(x, total_rows, bits, xmats[xi], fast=fast)
        elif tag == "row":
            _, stride, coefs, lm, lw, rm, rw = st
            _rowk_plain(x, total_rows, (stride.bit_length() - 1,),
                        _u2(coefs), lm, lw, rm, rw)
        elif tag == "rowk":
            _, bits, pairs, lm, lw, rm, rw = st
            d = 1 << len(bits)
            u = np.array([complex(a, b) for a, b in pairs]).reshape(d, d)
            _rowk_plain(x, total_rows, bits, u, lm, lw, rm, rw)
        else:
            _, toff, bits = st
            _rowdiag_plain(x, total_rows,
                           np.stack(tables[toff:toff + (1 << len(bits))]),
                           bits)
    return states


def apply_layer_plain(planes: torch.Tensor, num_qubits: int,
                      layer: LayerOp, fast: bool = False) -> torch.Tensor:
    """The fused layer as plain PyTorch tensor ops on ``(2, 2^n)`` planes,
    IN PLACE: :func:`apply_layer_batched_plain` on a batch of one."""
    apply_layer_batched_plain(planes.unsqueeze(0), num_qubits, layer, fast)
    return planes


def _mxu_tile_layer(num_qubits: int, u, targets: Sequence[int],
                    dtype: torch.dtype) -> LayerOp:
    """The one-stage layer of :func:`apply_mxu_tile`: the gate embedded
    over (lanes + its row bits), validated against the kernel's tile."""
    targets = tuple(int(t) for t in targets)
    if len(set(targets)) != len(targets) or not targets or any(
            not 0 <= t < num_qubits for t in targets):
        raise ValueError(f"targets {targets} must be distinct qubits in "
                         f"[0, {num_qubits})")
    bits = tuple(sorted(t - LANE_QUBITS for t in targets
                        if t >= LANE_QUBITS))
    total_rows = (1 << num_qubits) // LANES
    tile_rows = min(tile_rows_for(dtype), total_rows)
    if bits and bits[-1] + LANE_QUBITS > max_mid_qubit(tile_rows):
        raise ValueError(
            f"row target {bits[-1] + LANE_QUBITS} outside the "
            f"{tile_rows}-row tile range")
    if len(bits) > MAX_DENSE_ROW_BITS:
        raise ValueError(f"an MXU tile packs at most {MAX_DENSE_ROW_BITS} "
                         f"row bits with the lanes, got {len(bits)}")
    m = mxu_group_matrix(np.asarray(u, dtype=np.complex128), targets, bits)
    return LayerOp(num_qubits, 1, [("rowmxu", bits, m)])


def apply_mxu_tile_plain(planes: torch.Tensor, num_qubits: int, u,
                         targets: Sequence[int],
                         fast: bool = False) -> torch.Tensor:
    """:func:`apply_mxu_tile` as plain PyTorch tensor ops, IN PLACE."""
    _check_states(planes, num_qubits, False, "apply_mxu_tile_plain")
    layer = _mxu_tile_layer(num_qubits, u, targets, planes.dtype)
    return apply_layer_plain(planes, num_qubits, layer, fast)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, operands, launch
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def build_library() -> tuple:
    """Build (all of the port's kernels, ``ops/cuda_build.py``) and load
    ``csrc/layer_kernel.cu``. Returns ``(ctypes.CDLL, path,
    compiler_output)``."""
    lib, path, log = cuda_build.library("layer_kernel")
    argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p]
    for name in ("quest_layer_apply_f32", "quest_layer_apply_f64"):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # the FAST entry adds the bf16 operand pool and the widest dense
    # stage's row-bit count after the float32 pool
    lib.quest_layer_apply_fast_f32.argtypes = (
        argtypes[:5] + [ctypes.c_void_p, ctypes.c_int] + argtypes[5:])
    lib.quest_layer_apply_fast_f32.restype = ctypes.c_int
    # the streaming entry for rowdiag-only layers: no tile height, and the
    # pool's value count after the pool
    for name in ("quest_layer_diag_f32", "quest_layer_diag_f64"):
        fn = getattr(lib, name)
        fn.argtypes = argtypes[:5] + [ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_longlong, ctypes.c_longlong,
                                      ctypes.c_void_p]
        fn.restype = ctypes.c_int
    # the MXU tile: pool (and for FAST the bf16 pool and max_j), the index
    # map and its length, the gate's values on the device, then the launch
    # geometry
    mxu = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_longlong, ctypes.c_void_p])
    for name in ("quest_mxu_tile_f32", "quest_mxu_tile_f64"):
        getattr(lib, name).argtypes = mxu[:4] + mxu[5:]
        getattr(lib, name).restype = ctypes.c_int
    lib.quest_mxu_tile_fast_f32.argtypes = mxu[:5] + [ctypes.c_int] \
        + mxu[5:]
    lib.quest_mxu_tile_fast_f32.restype = ctypes.c_int
    lib.quest_layer_diag_table_cap.argtypes = []
    lib.quest_layer_diag_table_cap.restype = ctypes.c_longlong
    for name in ("quest_layer_fast_scratch_bytes",
                 "quest_layer_lane_scratch_bytes"):
        getattr(lib, name).argtypes = [ctypes.c_int]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.quest_layer_error_string.argtypes = [ctypes.c_int]
    lib.quest_layer_error_string.restype = ctypes.c_char_p
    return lib, path, log


def fast_operator_slabs(m: np.ndarray) -> np.ndarray:
    """The FAST dense stage's operator ``M`` (``dim x dim``, outputs by
    inputs; not ``M^T``) as the kernel reads it: a flat real vector of
    ``2 * dim^2`` values (rounded to bf16 by the caller).

    Element ``(((k * dim / 8 + t) * 32 + lane) * 4 + w) * 2 + p`` is
    ``part[8 t + lane // 4][16 k + 8 h + 2 (lane % 4) + p]`` with ``part =
    (M.real, M.imag)[w // 2]`` and ``h = w % 2``: K slab ``k`` (inputs
    ``[16k, 16k + 16)``) is one contiguous block, within it n-tile ``t``
    (outputs ``[8t, 8t + 8)``), within that each lane's 16 bytes are its
    ``mma.m16n8k16`` B fragments ``{re b0, re b1, im b0, im b1}``."""
    m = np.asarray(m, dtype=np.complex128)
    dim = m.shape[0]
    # axes (part, t, gid, k, h, q, p): output 8t + gid, input 16k + 8h + 2q + p
    parts = np.stack([m.real, m.imag]).reshape(
        2, dim // 8, 8, dim // FAST_K, 2, 4, 2)
    # -> (k, t, gid, q, part, h, p): lane = 4 gid + q, word = 2 part + h
    return np.ascontiguousarray(
        parts.transpose(3, 1, 2, 5, 0, 4, 6)).reshape(-1)


def mark_rowdiag_runs(desc: np.ndarray) -> np.ndarray:
    """Write into each ``rowdiag`` descriptor's free slot (column 4, the
    lane mask the stage does not have) the stages left in its run of
    consecutive ``rowdiag`` stages, itself included: the tile kernel
    applies the whole run in one pass over the tile and skips the stages
    it consumed. In place; returns ``desc``."""
    run = 0
    for row in desc[::-1]:
        run = run + 1 if row[0] == TAG_ROWDIAG else 0
        if run:
            row[4] = run
    return desc


def is_diagonal_layer(layer: LayerOp) -> bool:
    """Whether every stage of the layer is ``rowdiag``: such a layer takes
    the kernel's streaming entry (no tile)."""
    return bool(layer.stages) and all(st[0] == "rowdiag"
                                      for st in layer.stages)


def launch_entry(layer: LayerOp, dtype: torch.dtype, fast: bool) -> str:
    """The C entry point of ``csrc/layer_kernel.cu`` a launch of ``layer``
    on planes of ``dtype`` takes: the streaming entry for a layer of
    ``rowdiag`` stages only (float32 at FAST, whose ``rowdiag`` stages are
    float32), else the tile kernel at its precision."""
    suffix = "f64" if dtype == torch.float64 and not fast else "f32"
    if is_diagonal_layer(layer):
        return f"quest_layer_diag_{suffix}"
    return f"quest_layer_apply_{'fast_' if fast else ''}{suffix}"


def _pack_bits(bits) -> int:
    packed = 0
    for i, b in enumerate(bits):
        packed |= int(b) << (8 * i)
    return packed


def _device_operands(layer: LayerOp, num_qubits: int, dtype: torch.dtype,
                     device: torch.device):
    """Stage descriptors (int64, ``(stages, DESC_WIDTH)``) and the operand
    pool (one plane-dtype vector) for the kernel, cached on the layer:
    ``(desc, pool, tile_rows, total_rows)``.

    Pool layout per operand: the real part then the imaginary part, each
    row-major. Dense operators are stored transposed (``M^T``), so the
    threads of a warp read neighbouring output columns."""
    desc, pool, _, _, tile_rows, total_rows = _operands(
        layer, num_qubits, dtype, device, fast=False)
    return desc, pool, tile_rows, total_rows


def _fast_operands(layer: LayerOp, num_qubits: int, device: torch.device):
    """The FAST launch's operands, cached on the layer: ``(desc, pool,
    fast_pool, max_j, tile_rows, total_rows)``. The dense stages' ``M``
    live in ``fast_pool``, rounded to bf16 and laid out by
    :func:`fast_operator_slabs` (their descriptors' offsets index it); the
    other stages' operands stay in the float32 ``pool``. ``max_j`` is the
    widest dense stage's row-bit count (it sizes the kernel's ring)."""
    return _operands(layer, num_qubits, torch.float32, device, fast=True)


def pack_layer(layer: LayerOp, num_qubits: int, dtype: torch.dtype,
               device, fast: bool = False) -> None:
    """Pack the layer's descriptors and operand pools for a launch on
    planes of ``dtype`` on ``device`` (with ``fast``, the FAST kernel's,
    whose planes are float32) ahead of its first launch
    (``CompiledCircuit.precompile``); cached on the layer, where the
    launch finds them."""
    _operands(layer, num_qubits, torch.float32 if fast else dtype,
              torch.device(device), fast)


def is_packed(layer: LayerOp, num_qubits: int, dtype: torch.dtype,
              device, fast: bool = False) -> bool:
    """Whether :func:`pack_layer` (or a launch) packed the layer for these
    planes."""
    return (num_qubits, torch.float32 if fast else dtype,
            torch.device(device), fast) in layer._packed


def packed_operands(layer: LayerOp, num_qubits: int, dtype: torch.dtype,
                    device, fast: bool = False) -> tuple:
    """What :func:`pack_layer` cached for these planes: ``(desc, pool,
    fast_pool, max_j, tile_rows, total_rows)`` (``fast_pool`` None at full
    precision). Raises ``KeyError`` when the layer is not packed."""
    return layer._packed[(num_qubits, torch.float32 if fast else dtype,
                          torch.device(device), fast)]


def install_packed(layer: LayerOp, num_qubits: int, dtype: torch.dtype,
                   device, fast: bool, packed: tuple) -> None:
    """Install operands packed earlier (the warm cache's artifact,
    :func:`packed_operands`' tuple) where a launch on these planes finds
    them: the layer then packs nothing."""
    layer._packed[(num_qubits, torch.float32 if fast else dtype,
                   torch.device(device), fast)] = tuple(packed)


def _operands(layer: LayerOp, num_qubits: int, dtype: torch.dtype,
              device: torch.device, fast: bool):
    # the key is_packed reads
    key = (num_qubits, dtype, device, fast)
    if key in layer._packed:
        return layer._packed[key]
    _operands.packs += 1
    kstages, lane_mats, tables, xmats, tile_rows, total_rows = \
        layer_kernel_plan(layer, num_qubits, tile_rows_for(dtype))
    itemsize = dtype.itemsize
    pools: dict = {False: [], True: []}
    sizes = {False: 0, True: 0}

    def put(c: np.ndarray) -> int:
        c = np.asarray(c, dtype=np.complex128)
        off = sizes[False]
        pools[False].extend([c.real.reshape(-1), c.imag.reshape(-1)])
        sizes[False] += 2 * c.size
        return off

    def put_dense(m: np.ndarray) -> int:
        # full precision: M^T, so a warp's threads read neighbouring
        # outputs; FAST: M in the bf16 pool, in the kernel's slab order.
        # Every FAST operator is 2 * dim^2 values, a multiple of 8, so each
        # offset is 16-byte aligned, as cp.async needs
        if not fast:
            off = put(np.asarray(m).T)
            # the lane stage copies its operator with cp.async too; every
            # operand before it is a multiple of 8 values
            if off * itemsize % 16:
                raise ValueError(f"dense operand at pool offset {off} is "
                                 "not 16-byte aligned")
            return off
        off = sizes[True]
        pools[True].append(fast_operator_slabs(m))
        sizes[True] += 2 * np.asarray(m).size
        return off

    desc = []
    max_j = 0
    for st in kstages:
        tag = st[0]
        if tag == "lane":
            _, mi, row_mask, row_want = st
            desc.append([TAG_DENSE, 0, 0, put_dense(lane_mats[mi]), 0, 0,
                         row_mask, row_want])
        elif tag == "rowmxu":
            _, bits, xi, _ = st
            if len(bits) > MAX_DENSE_ROW_BITS:
                raise ValueError(f"the layer kernel packs at most "
                                 f"{MAX_DENSE_ROW_BITS} row bits into a "
                                 f"rowmxu stage, got {len(bits)}")
            max_j = max(max_j, len(bits))
            desc.append([TAG_DENSE, len(bits), _pack_bits(bits),
                         put_dense(xmats[xi]), 0, 0, 0, 0])
        elif tag == "row":
            _, stride, coefs, lm, lw, rm, rw = st
            desc.append([TAG_ROWK, 1, stride.bit_length() - 1,
                         put(_u2(coefs)), lm, lw, rm, rw])
        elif tag == "rowk":
            _, bits, pairs, lm, lw, rm, rw = st
            if not 1 <= len(bits) <= MAX_ROWK_BITS:
                raise ValueError(f"the layer kernel takes rowk stages on 1 to "
                                 f"{MAX_ROWK_BITS} row bits, got {len(bits)}")
            u = np.array([complex(a, b) for a, b in pairs])
            desc.append([TAG_ROWK, len(bits), _pack_bits(bits), put(u),
                         lm, lw, rm, rw])
        else:
            _, toff, bits = st
            table = np.stack(tables[toff:toff + (1 << len(bits))])
            off = put(table)
            # the kernels read each table row as 16-byte vectors
            if off * itemsize % 16:
                raise ValueError(f"rowdiag table at pool offset {off} is "
                                 "not 16-byte aligned")
            desc.append([TAG_ROWDIAG, len(bits), _pack_bits(bits), off,
                         0, 0, 0, 0])
    desc = np.asarray(desc, dtype=np.int64).reshape(-1, DESC_WIDTH)
    mark_rowdiag_runs(desc)
    desc_t = torch.as_tensor(desc, device=device)

    def as_pool(parts, pool_dtype):
        return torch.as_tensor(np.concatenate(parts) if parts
                               else np.zeros(1), dtype=pool_dtype,
                               device=device)

    # the bf16 operators round through float32, as the plain version's do
    packed = (desc_t, as_pool(pools[False], dtype),
              as_pool(pools[True], torch.float32).to(torch.bfloat16)
              if fast else None, max_j, tile_rows, total_rows)
    layer._packed[key] = packed
    return packed


_operands.packs = 0     # layers packed: a precompiled run adds none


def _check_fast_dtype(dtype: torch.dtype, where: str) -> None:
    if dtype != torch.float32:
        raise ValueError(f"{where}: FAST planes are float32, got {dtype} "
                         "(the circuit engine casts a FAST dispatch in and "
                         "out)")


def _check_states(states: torch.Tensor, num_qubits: int, batched: bool,
                  where: str) -> None:
    if not isinstance(states, torch.Tensor):
        raise TypeError(f"{where}: planes must be a torch.Tensor")
    if num_qubits < LANE_QUBITS:
        raise ValueError("fused layers need at least 7 qubits")
    want = "(B, 2, {})" if batched else "(2, {})"
    got = tuple(states.shape[1:]) if batched and states.dim() == 3 \
        else tuple(states.shape) if not batched else None
    if got != (2, 1 << num_qubits):
        raise ValueError(f"{where}: planes have shape {tuple(states.shape)}, "
                         f"expected {want.format(1 << num_qubits)}")
    if states.dtype not in TILE_ROWS:
        raise ValueError(f"{where}: planes must be float32 or float64, "
                         f"got {states.dtype}")
    if not states.is_contiguous():
        raise ValueError(f"{where}: planes must be contiguous")


def _launch(states: torch.Tensor, num_qubits: int, layer: LayerOp,
            where: str, fast: bool = False) -> bool:
    """One launch of the layer kernel over the ``(B, 2, 2^n)`` batch: the
    full-precision kernel, or with ``fast`` the FAST one (bf16 tensor
    cores in the dense stages). A layer of ``rowdiag`` stages only takes
    the streaming entry instead (at float32 for FAST: its ``rowdiag``
    stages are float32); returns whether it did."""
    if states.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {states.device}")
    if fast:
        _check_fast_dtype(states.dtype, where)
        desc, pool, fast_pool, max_j, tile_rows, total_rows = \
            _fast_operands(layer, num_qubits, states.device)
    else:
        desc, pool, tile_rows, total_rows = _device_operands(
            layer, num_qubits, states.dtype, states.device)
        fast_pool, max_j = None, None
    entry = launch_entry(layer, states.dtype, fast)
    diagonal = entry.startswith("quest_layer_diag")
    if not diagonal:
        shared_memory_bytes(tile_rows, states.element_size(), max_j)
    if states.data_ptr() % 16:
        raise ValueError(f"{where}: planes must be 16-byte aligned")
    lib = build_library()[0]
    fn = getattr(lib, entry)
    num_amps = 1 << num_qubits
    re_ptr = states.data_ptr()
    im_ptr = re_ptr + num_amps * states.element_size()
    head = (re_ptr, im_ptr, desc.data_ptr(), desc.shape[0], pool.data_ptr())
    tail = (states.shape[0], 2 * num_amps)
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        if diagonal:
            err = fn(*head, pool.numel(), total_rows, *tail, stream)
        elif fast:
            err = fn(*head, fast_pool.data_ptr(), max_j, total_rows,
                     tile_rows, *tail, stream)
        else:
            err = fn(*head, total_rows, tile_rows, *tail, stream)
    if err != 0:
        raise cuda_build.KernelLaunchError(
            "layer kernel launch failed: "
            + lib.quest_layer_error_string(err).decode())
    return diagonal


def apply_layer(planes: torch.Tensor, num_qubits: int, layer: LayerOp,
                fast: bool = False) -> torch.Tensor:
    """Apply a fused layer IN PLACE to the ``(2, 2^n)`` planes (returned).

    A CUDA tensor launches the hand-written kernel and counts the launch
    in ``apply_layer.launches`` (``apply_layer.fast_launches`` for the
    FAST kernel, ``fast=True``: float32 planes, bf16 tensor cores in the
    dense stages), and a layer of ``rowdiag`` stages only, which takes the
    kernel's streaming entry, in ``apply_layer.diag_launches`` too; a CPU
    tensor runs :func:`apply_layer_plain`."""
    _check_states(planes, num_qubits, False, "apply_layer")
    if fast:
        _check_fast_dtype(planes.dtype, "apply_layer")
    if layer.num_qubits != num_qubits:
        raise ValueError(f"layer was collected for {layer.num_qubits} "
                         f"qubits, planes hold {num_qubits}")
    if planes.device.type == "cpu":
        return apply_layer_plain(planes, num_qubits, layer, fast)
    if _launch(planes.unsqueeze(0), num_qubits, layer, "apply_layer", fast):
        apply_layer.diag_launches += 1
    if fast:
        apply_layer.fast_launches += 1
    else:
        apply_layer.launches += 1
    return planes


apply_layer.launches = 0
apply_layer.fast_launches = 0
apply_layer.diag_launches = 0


def apply_layer_batched(states: torch.Tensor, num_qubits: int,
                        layer: LayerOp, fast: bool = False) -> torch.Tensor:
    """Apply a fused layer IN PLACE to every state of a ``(B, 2, 2^n)``
    batch (returned) in ONE launch: the kernel's grid grows the batch
    (block x = b * tiles + tile), one descriptor and operand upload serves
    every state, and row masks, wants and ``rowdiag`` tables address rows
    within each state.

    A CUDA tensor launches the kernel and counts the launch in
    ``apply_layer_batched.launches`` (``.fast_launches`` with ``fast``,
    ``.diag_launches`` too for the streaming entry, as in
    :func:`apply_layer`); a CPU tensor runs
    :func:`apply_layer_batched_plain`."""
    _check_states(states, num_qubits, True, "apply_layer_batched")
    if fast:
        _check_fast_dtype(states.dtype, "apply_layer_batched")
    if layer.num_qubits != num_qubits:
        raise ValueError(f"layer was collected for {layer.num_qubits} "
                         f"qubits, planes hold {num_qubits}")
    if states.device.type == "cpu":
        return apply_layer_batched_plain(states, num_qubits, layer, fast)
    if _launch(states, num_qubits, layer, "apply_layer_batched", fast):
        apply_layer_batched.diag_launches += 1
    if fast:
        apply_layer_batched.fast_launches += 1
    else:
        apply_layer_batched.launches += 1
    return states


apply_layer_batched.launches = 0
apply_layer_batched.fast_launches = 0
apply_layer_batched.diag_launches = 0


# geometries of apply_mxu_tile kept packed on their device (the JAX
# package's _MXU_EXEC bound)
MXU_TILE_CACHE_SIZE = 16
_MXU_TILES: "OrderedDict[tuple, _MxuTile]" = OrderedDict()
_MXU_TILES_LOCK = threading.Lock()


class _MxuTile:
    """One geometry of :func:`apply_mxu_tile` (qubits, targets, plane dtype,
    FAST, device, stream), packed once. ``index`` (int32, on the device)
    maps each value of the operator pool's layout (``M^T``'s real then
    imaginary part, or for FAST the :func:`fast_operator_slabs` order) to
    its source in the gate's :meth:`values` ``[0, Re u, Im u]``; 0 is the
    embedding's structural zero. A call on the card uploads the values to
    ``source`` and gathers them into the operator pool (``pool``, or
    ``fast_pool`` in bf16 for FAST) inside its one C call
    (``quest_mxu_tile_*``); :meth:`fill` is that gather's plain version. Calls on one stream reuse the buffers in stream order; the
    stream is part of the key, so no two streams share them."""

    __slots__ = ("dim", "operands", "index", "source", "target",
                 "value_dtype")

    def __init__(self, num_qubits: int, targets: tuple, dtype: torch.dtype,
                 fast: bool, device: torch.device):
        d = 1 << len(targets)
        # a probe gate whose entry (i, j) is 1 + (i d + j) embeds into the
        # index map (and is validated against the tile on the way)
        probe = _mxu_tile_layer(num_qubits,
                                np.arange(1, d * d + 1).reshape(d, d),
                                targets, dtype)
        embed = probe.stages[0][2].real.astype(np.int64)
        both = embed + 1j * np.where(embed > 0, embed + d * d, 0)
        if fast:
            index = fast_operator_slabs(both)
        else:
            index = np.concatenate([both.T.real.reshape(-1),
                                    both.T.imag.reshape(-1)])
        desc, pool, fast_pool, max_j, tile_rows, total_rows = _operands(
            probe, num_qubits, dtype, torch.device("cpu"), fast)
        self.dim = d
        self.index = torch.as_tensor(index.astype(np.int32), device=device)
        # the gate's values as the per-layer pack rounds them: float64, or
        # float32 (FAST: bf16 through float32, in the gather)
        wide = dtype == torch.float64 and not fast
        self.value_dtype = np.float64 if wide else np.float32
        self.source = torch.empty(1 + 2 * d * d, device=device,
                                  dtype=torch.float64 if wide
                                  else torch.float32)
        pool, fast_pool = (torch.zeros_like(t, device=device)
                           if t is not None else None
                           for t in (pool, fast_pool))
        self.target = fast_pool if fast else pool
        self.operands = (desc.to(device), pool, fast_pool, max_j, tile_rows,
                         total_rows)

    def _gate(self, u) -> np.ndarray:
        u = np.asarray(u, dtype=np.complex128)
        if u.shape != (self.dim, self.dim):
            raise ValueError(f"apply_mxu_tile: gate has shape {u.shape}, "
                             f"expected {(self.dim, self.dim)} for its "
                             "targets")
        # + 0.0 as the embedding adds each value to a zero (so a -0.0
        # becomes 0.0 there too)
        return (u + 0.0).reshape(-1)

    def values(self, u) -> np.ndarray:
        """The gather's source ``[0, Re u, Im u]`` (row-major), rounded to
        the pool's value dtype as the per-layer pack rounds it."""
        g = self._gate(u)
        return np.concatenate([np.zeros(1), g.real, g.imag]).astype(
            self.value_dtype)

    def fill(self, u) -> None:
        """The plain version of the card's gather: the pool (bf16 for
        FAST, rounded from the float32 values) from gate ``u``."""
        src = torch.from_numpy(self.values(u)).to(self.source.device)
        self.target.copy_(src[self.index.long()])


def _mxu_tile(num_qubits: int, targets: Sequence[int], dtype: torch.dtype,
              fast: bool, device: torch.device,
              stream: Optional[int] = None) -> _MxuTile:
    """The packed geometry of :func:`apply_mxu_tile`, made at its first use
    and kept in a bounded LRU (:data:`MXU_TILE_CACHE_SIZE` entries)."""
    targets = tuple(int(t) for t in targets)
    key = (num_qubits, targets, dtype, fast, device, stream)
    with _MXU_TILES_LOCK:
        tile = _MXU_TILES.get(key)
        if tile is not None:
            _MXU_TILES.move_to_end(key)
            return tile
    tile = _MxuTile(num_qubits, targets, dtype, fast, device)
    with _MXU_TILES_LOCK:
        _MXU_TILES[key] = tile
        while len(_MXU_TILES) > MXU_TILE_CACHE_SIZE:
            _MXU_TILES.popitem(last=False)
    return tile


def apply_mxu_tile(planes: torch.Tensor, num_qubits: int, u,
                   targets: Sequence[int], fast: bool = False) -> torch.Tensor:
    """Apply ONE dense uncontrolled gate IN PLACE to ``(2, 2^n)`` planes
    as a packed contraction (returned): the gate (any mix of lane targets
    and up to two row targets inside the tile) embeds over (lane qubits +
    its row bits) into a ``(2^j * 128)``-square operator
    (:func:`mxu_group_matrix`) and runs as one ``rowmxu`` stage of the
    layer kernel in one pass — the standalone form of the stage compiled
    programs get through the layer collector (``pallas_kernels.
    apply_mxu_tile``). ``fast`` selects the FAST bf16-split form.

    A CUDA tensor launches the layer kernel and counts the launch in
    ``apply_mxu_tile.launches``; a CPU tensor runs
    :func:`apply_mxu_tile_plain`. A row target outside the tile raises
    ``ValueError``. The embedding and packing are done once per geometry
    (:func:`_mxu_tile`), so a call costs the gate's upload, one
    gather and the launch."""
    _check_states(planes, num_qubits, False, "apply_mxu_tile")
    if fast:
        _check_fast_dtype(planes.dtype, "apply_mxu_tile")
    if planes.device.type == "cpu":
        return apply_mxu_tile_plain(planes, num_qubits, u, targets, fast)
    lib = build_library()[0]     # a missing toolkit raises before packing
    if planes.data_ptr() % 16:
        raise ValueError("apply_mxu_tile: planes must be 16-byte aligned")
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        tile = _mxu_tile(num_qubits, targets, planes.dtype, fast,
                         planes.device, stream)
        # staged in pinned memory: the caching host allocator keeps the
        # block from reuse until its copy has run
        staged = torch.from_numpy(tile.values(u)).pin_memory()
        tile.source.copy_(staged, non_blocking=True)
        desc, pool, fast_pool, max_j, tile_rows, total_rows = tile.operands
        head = (planes.data_ptr(),
                planes.data_ptr() + planes.shape[1] * planes.element_size(),
                desc.data_ptr(), pool.data_ptr())
        tail = (tile.index.data_ptr(), tile.index.numel(),
                tile.source.data_ptr(), total_rows, tile_rows,
                2 * planes.shape[1], stream)
        if fast:
            err = lib.quest_mxu_tile_fast_f32(*head, fast_pool.data_ptr(),
                                              max_j, *tail)
        elif planes.dtype == torch.float32:
            err = lib.quest_mxu_tile_f32(*head, *tail)
        else:
            err = lib.quest_mxu_tile_f64(*head, *tail)
    if err != 0:
        raise cuda_build.KernelLaunchError(
            "MXU-tile launch failed: "
            + lib.quest_layer_error_string(err).decode())
    apply_mxu_tile.launches += 1
    return planes


apply_mxu_tile.launches = 0
