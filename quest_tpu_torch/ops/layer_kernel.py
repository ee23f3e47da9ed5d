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
plain version.

The tile height comes from Hopper's shared memory, not from TPU VMEM: one
block holds a ``tile_rows x 128`` tile of both planes (128 KiB at either
dtype: 128 rows of float32, 64 of float64). ``max_mid_qubit(tile_rows)``
bounds which row bits a dense stage may target, and the collector reads it
through :func:`tile_rows_for`, so the CPU and the card plan one plan.
"""

from __future__ import annotations

import ctypes
import functools
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

__all__ = ["LANE_QUBITS", "TILE_ROWS", "LayerOp", "embed_lane_matrix",
           "lane_diag_matrix", "lane_diag_vector", "max_mid_qubit",
           "tile_rows_for", "mxu_group_matrix", "mxu_expand",
           "layer_kernel_plan", "shared_memory_bytes", "apply_layer",
           "apply_layer_plain", "apply_layer_batched",
           "apply_layer_batched_plain", "build_library"]


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


def shared_memory_bytes(tile_rows: int, itemsize: int) -> int:
    """Dynamic shared memory one block needs: the tile of both planes.
    Every stage updates the tile in place (through registers), so the
    need does not grow with the stage count — the TPU kernel's VMEM
    working-set estimate has no counterpart here."""
    need = 2 * tile_rows * LANES * itemsize
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


def _dense_plain(x, total_rows, bits, m, row_mask=0, row_want=0):
    """out = M v over the packed (row bits, lanes) axis; ``bits == ()`` is
    the lane stage, run permute-free on the (B, rows, 128) views."""
    if not bits:
        re, im = x[:, 0], x[:, 1]
        mr_t, mi_t = (torch.as_tensor(np.ascontiguousarray(p.T),
                                      dtype=x.dtype, device=x.device)
                      for p in (m.real, m.imag))
        new_re = torch.matmul(re, mr_t)
        new_re.sub_(torch.matmul(im, mi_t))
        new_im = torch.matmul(re, mi_t)
        new_im.add_(torch.matmul(im, mr_t))
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
    new = torch.matmul(_block(m, x), sub.reshape(x.shape[0], 2 * dim, -1))
    sub.copy_(new.view(sub.shape))


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
                              layer: LayerOp) -> torch.Tensor:
    """The fused layer as plain PyTorch tensor ops on every state of a
    ``(B, 2, 2^n)`` batch, stage after stage over the whole states, IN
    PLACE. It computes what the kernel computes (the same plan, the same
    ``hi``; rows counted within each state) and is the reference the
    kernel is held against."""
    kstages, lane_mats, tables, xmats, _, total_rows = layer_kernel_plan(
        layer, num_qubits, tile_rows_for(states.dtype))
    x = states.view(states.shape[0], 2, total_rows, LANES)
    for st in kstages:
        tag = st[0]
        if tag == "lane":
            _, mi, row_mask, row_want = st
            _dense_plain(x, total_rows, (), lane_mats[mi], row_mask,
                         row_want)
        elif tag == "rowmxu":
            _, bits, xi, _ = st
            _dense_plain(x, total_rows, bits, xmats[xi])
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
                      layer: LayerOp) -> torch.Tensor:
    """The fused layer as plain PyTorch tensor ops on ``(2, 2^n)`` planes,
    IN PLACE: :func:`apply_layer_batched_plain` on a batch of one."""
    apply_layer_batched_plain(planes.unsqueeze(0), num_qubits, layer)
    return planes


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
    lib.quest_layer_error_string.argtypes = [ctypes.c_int]
    lib.quest_layer_error_string.restype = ctypes.c_char_p
    return lib, path, log


def _pack_bits(bits) -> int:
    packed = 0
    for i, b in enumerate(bits):
        packed |= int(b) << (8 * i)
    return packed


def _device_operands(layer: LayerOp, num_qubits: int, dtype: torch.dtype,
                     device: torch.device):
    """Stage descriptors (int64, ``(stages, DESC_WIDTH)``) and the operand
    pool (one plane-dtype vector) for the kernel, cached on the layer.

    Pool layout per operand: the real part then the imaginary part, each
    row-major. Dense operators are stored transposed (``M^T``), so the
    threads of a warp read neighbouring output columns."""
    key = (num_qubits, dtype, device)
    if key in layer._packed:
        return layer._packed[key]
    kstages, lane_mats, tables, xmats, tile_rows, total_rows = \
        layer_kernel_plan(layer, num_qubits, tile_rows_for(dtype))
    pool: list[np.ndarray] = []
    size = 0

    def put(c: np.ndarray) -> int:
        nonlocal size
        c = np.asarray(c, dtype=np.complex128)
        off = size
        pool.extend([c.real.reshape(-1), c.imag.reshape(-1)])
        size += 2 * c.size
        return off

    desc = []
    for st in kstages:
        tag = st[0]
        if tag == "lane":
            _, mi, row_mask, row_want = st
            desc.append([TAG_DENSE, 0, 0, put(lane_mats[mi].T), 0, 0,
                         row_mask, row_want])
        elif tag == "rowmxu":
            _, bits, xi, _ = st
            if len(bits) > MAX_DENSE_ROW_BITS:
                raise ValueError(f"the layer kernel packs at most "
                                 f"{MAX_DENSE_ROW_BITS} row bits into a "
                                 f"rowmxu stage, got {len(bits)}")
            desc.append([TAG_DENSE, len(bits), _pack_bits(bits),
                         put(xmats[xi].T), 0, 0, 0, 0])
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
            desc.append([TAG_ROWDIAG, len(bits), _pack_bits(bits),
                         put(table), 0, 0, 0, 0])
    desc_t = torch.as_tensor(np.asarray(desc, dtype=np.int64).reshape(
        -1, DESC_WIDTH), device=device)
    pool_t = torch.as_tensor(np.concatenate(pool) if pool
                             else np.zeros(1), dtype=dtype, device=device)
    packed = (desc_t, pool_t, tile_rows, total_rows)
    layer._packed[key] = packed
    return packed


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
            where: str) -> None:
    """One launch of the layer kernel over the ``(B, 2, 2^n)`` batch."""
    if states.device.type != "cuda":
        raise ValueError(f"{where}: unsupported device {states.device}")
    desc, pool, tile_rows, total_rows = _device_operands(
        layer, num_qubits, states.dtype, states.device)
    shared_memory_bytes(tile_rows, states.element_size())
    if states.data_ptr() % 16:
        raise ValueError(f"{where}: planes must be 16-byte aligned")
    lib = build_library()[0]
    fn = lib.quest_layer_apply_f32 if states.dtype == torch.float32 \
        else lib.quest_layer_apply_f64
    num_amps = 1 << num_qubits
    with torch.cuda.device(states.device):
        stream = torch.cuda.current_stream(states.device).cuda_stream
        err = fn(states.data_ptr(),
                 states.data_ptr() + num_amps * states.element_size(),
                 desc.data_ptr(), desc.shape[0], pool.data_ptr(),
                 total_rows, tile_rows, states.shape[0], 2 * num_amps,
                 stream)
    if err != 0:
        raise RuntimeError("layer kernel launch failed: "
                           + lib.quest_layer_error_string(err).decode())


def apply_layer(planes: torch.Tensor, num_qubits: int, layer: LayerOp,
                fast: bool = False) -> torch.Tensor:
    """Apply a fused layer IN PLACE to the ``(2, 2^n)`` planes (returned).

    A CUDA tensor launches the hand-written kernel and counts the launch
    in ``apply_layer.launches``; a CPU tensor runs
    :func:`apply_layer_plain`. ``fast=True`` (the FAST tier's reduced-
    precision inputs) belongs to a later slice and raises."""
    _check_states(planes, num_qubits, False, "apply_layer")
    if fast:
        raise NotImplementedError(
            "apply_layer: the FAST tier's layer kernel is not ported yet")
    if layer.num_qubits != num_qubits:
        raise ValueError(f"layer was collected for {layer.num_qubits} "
                         f"qubits, planes hold {num_qubits}")
    if planes.device.type == "cpu":
        return apply_layer_plain(planes, num_qubits, layer)
    _launch(planes.unsqueeze(0), num_qubits, layer, "apply_layer")
    apply_layer.launches += 1
    return planes


apply_layer.launches = 0


def apply_layer_batched(states: torch.Tensor, num_qubits: int,
                        layer: LayerOp) -> torch.Tensor:
    """Apply a fused layer IN PLACE to every state of a ``(B, 2, 2^n)``
    batch (returned) in ONE launch: the kernel's grid grows the batch
    (block x = b * tiles + tile), one descriptor and operand upload serves
    every state, and row masks, wants and ``rowdiag`` tables address rows
    within each state.

    A CUDA tensor launches the kernel and counts the launch in
    ``apply_layer_batched.launches``; a CPU tensor runs
    :func:`apply_layer_batched_plain`."""
    _check_states(states, num_qubits, True, "apply_layer_batched")
    if layer.num_qubits != num_qubits:
        raise ValueError(f"layer was collected for {layer.num_qubits} "
                         f"qubits, planes hold {num_qubits}")
    if states.device.type == "cpu":
        return apply_layer_batched_plain(states, num_qubits, layer)
    _launch(states, num_qubits, layer, "apply_layer_batched")
    apply_layer_batched.launches += 1
    return states


apply_layer_batched.launches = 0
