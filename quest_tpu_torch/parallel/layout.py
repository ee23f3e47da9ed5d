"""Layout plan for one device, and the dense-contraction crossover.

Counterpart of the single-device part of the JAX package's
``parallel/layout.py``. With no mesh, every qubit is local and the plan is
the identity placement (its ``plan_layout`` at ``shard_bits == 0``): one
``("op", ...)`` item per op, physical positions equal to logical ones.

:func:`choose_mxu_contraction` keeps the JAX package's decision rule (pick
the packed ``rowmxu`` contraction only when its modeled time is no worse
than the row path's) with the H100's rates in place of the TPU's: the
packed product runs on the CUDA cores at full precision and on the bf16
tensor cores at the FAST tier.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

__all__ = ["LayoutPlan", "plan_layout", "choose_mxu_contraction",
           "MXU_ROW_CAP", "HBM_BYTES_PER_S", "CUDA_CORE_FLOPS",
           "BF16_TENSOR_FLOPS"]


@dataclasses.dataclass
class LayoutPlan:
    """The scheduled program: ``("op", op_index, phys_targets,
    phys_ctrl_mask, phys_flip_mask, diag_axis_order)`` items — run op
    ``op_index`` at those physical positions."""
    items: list
    num_qubits: int


def _phys_diag_order(op_targets_desc_logical: tuple[int, ...],
                     perm: np.ndarray):
    """Map a diag op's sorted-desc logical qubits to physical positions and
    the axis order its tensor must be transposed by."""
    phys = tuple(int(perm[q]) for q in op_targets_desc_logical)
    order = tuple(np.argsort(phys)[::-1])  # positions sorted desc
    phys_desc = tuple(phys[i] for i in order)
    return phys_desc, order


def _phys_masks_of(op, perm: np.ndarray) -> tuple[int, int]:
    ctrl_mask = 0
    flip_mask = 0
    m = op.ctrl_mask
    q = 0
    while m:
        if m & 1:
            ctrl_mask |= 1 << int(perm[q])
            if (op.flip_mask >> q) & 1:
                flip_mask |= 1 << int(perm[q])
        m >>= 1
        q += 1
    return ctrl_mask, flip_mask


def _op_item(i: int, op, perm: np.ndarray):
    if op.kind == "u":
        phys_targets = tuple(int(perm[t]) for t in op.targets)
        ctrl_mask, flip_mask = _phys_masks_of(op, perm)
        return ("op", i, phys_targets, ctrl_mask, flip_mask, None)
    phys_desc, axis_order = _phys_diag_order(op.targets, perm)
    return ("op", i, phys_desc, 0, 0, axis_order)


def plan_layout(ops: Sequence, num_qubits: int) -> LayoutPlan:
    """Schedule ``ops`` on one device: the identity placement."""
    ident = np.arange(num_qubits)
    return LayoutPlan([_op_item(i, op, ident) for i, op in enumerate(ops)],
                      num_qubits)


# ---------------------------------------------------------------------------
# dense-contraction crossover (the rowmxu selection rule)
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3; 67 TFLOP/s float32 and
# 34 TFLOP/s float64 on the CUDA cores; 989 TFLOP/s dense bf16 on the
# tensor cores. At full precision the layer kernel runs every stage — the
# packed rowmxu product included — as FMA loops on the CUDA cores, so both
# sides of the crossover take the CUDA-core rate of the plane dtype. At
# the FAST tier the dense stages run on the bf16 tensor cores, and the
# packed side takes that rate.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_FLOPS = {4: 67.0e12, 8: 34.0e12}
BF16_TENSOR_FLOPS = 989.0e12

# Row-bit budget for one packed contraction: j row bits pack with the
# 128-lane axis into a (2^j * 128)-dim operator, 512 x 512 at the cap.
MXU_ROW_CAP = 2


def choose_mxu_contraction(num_row_bits: int, gate_qubits: int,
                           itemsize: int = 4,
                           force: Optional[bool] = None,
                           fast: bool = False) -> dict:
    """The modeled flops-vs-bytes crossover for ONE dense gate inside a
    fused layer: the packed ``rowmxu`` contraction (``8 * 2^j * 128`` real
    flops per amplitude, at the bf16 tensor-core rate when ``fast`` — the
    FAST tier — else at the CUDA-core rate) against the ``row``/``rowk``
    path (``8 * 2^gate_qubits`` at the CUDA-core rate). Both stream the
    state once, so each side's time is ``max(flop_time, memory_time)``,
    and the packed form wins only when it is no slower. ``force`` pins the
    decision (tests); None lets the model decide.

    Returns ``{"use_mxu", "mxu_seconds", "alt_seconds", "mem_seconds",
    "source"}`` in modeled seconds per amplitude.
    """
    # one pass over split re/im planes: read + write, 4 * itemsize/amp
    mem_s = 4.0 * itemsize / HBM_BYTES_PER_S
    rate = CUDA_CORE_FLOPS[itemsize]
    dim = (1 << max(int(num_row_bits), 0)) * 128
    mxu_s = max(8.0 * dim / (BF16_TENSOR_FLOPS if fast else rate), mem_s)
    alt_s = max(8.0 * (1 << max(int(gate_qubits), 0)) / rate, mem_s)
    if force is None:
        use, source = mxu_s <= alt_s, "modeled"
    else:
        use, source = bool(force), "forced"
    return {"use_mxu": use, "mxu_seconds": mxu_s, "alt_seconds": alt_s,
            "mem_seconds": mem_s, "source": source}
