"""Precision configuration.

Counterpart of the JAX package's ``config.py``: precision is a runtime
property of the environment (the reference's compile-time ``QuEST_PREC``
switch, ``QuEST_precision.h:28-65``). The port carries the JAX package's
four register formats: SINGLE (float32 planes, the default on the card),
DOUBLE (float64 planes), and the double-double QUAD (float32 hi/lo planes)
and QUAD64 (float64 hi/lo planes) registers of ``ops/doubledouble.py``.

Beside the register formats stands the precision-tier ladder: a tier is a
per-request EXECUTION mode (FAST, SINGLE, DOUBLE, QUAD), chosen at compile
time or per dispatch, directly or from an error budget
(:func:`quest_tpu_torch.profiling.choose_tier`). QUAD is a per-dispatch
rung only (``sweep``/``expectation_sweep``/``sample_sweep``), as in the JAX
package: a compile-time tier pins ``run``/``apply`` too, which have no dd
form.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Precision", "SINGLE", "DOUBLE", "QUAD", "QUAD64",
           "default_precision", "PrecisionTier", "FAST_TIER",
           "SINGLE_TIER", "DOUBLE_TIER", "QUAD_TIER", "TIER_LADDER",
           "tier_by_name"]


@dataclasses.dataclass(frozen=True)
class Precision:
    """Numeric precision bundle (mirrors qreal/REAL_EPS of the reference)."""

    quest_prec: int  # 1=single, 2=double, 4=quad (reference QuEST_PREC)
    real_dtype: torch.dtype
    complex_dtype: torch.dtype
    # REAL_EPS analogue (QuEST_precision.h: 1e-5 single / 1e-13 double /
    # 1e-14 quad)
    eps: float

    @property
    def name(self) -> str:
        if self.quest_prec == 4:
            # the two dd formats keep incompatible plane dtypes
            return "quad" if self.real_dtype == torch.float32 else "quad64"
        return {1: "single", 2: "double"}[self.quest_prec]


SINGLE = Precision(1, torch.float32, torch.complex64, 1e-5)
DOUBLE = Precision(2, torch.float64, torch.complex128, 1e-13)
# QUAD: registers hold DOUBLE-DOUBLE amplitudes, four float32 planes
# ``(4, 2^n) = [re_hi, re_lo, im_hi, im_lo]`` (~48-bit significand;
# ops/doubledouble.py). ``real_dtype`` is the plane dtype; host-visible
# amplitudes combine to complex128.
QUAD = Precision(4, torch.float32, torch.complex128, 1e-13)
# QUAD64: dd over float64 planes (~106-bit significand), the reference's
# quad-precision build analogue (``QuEST_precision.h:53-65``).
QUAD64 = Precision(4, torch.float64, torch.complex128, 1e-14)


def default_precision() -> Precision:
    """SINGLE: float32 planes are the card's native format."""
    return SINGLE


# ---------------------------------------------------------------------------
# precision tiers (the per-request performance dial)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PrecisionTier:
    """One rung of the execution-precision ladder.

    Where :class:`Precision` is the REGISTER's storage format, a tier is a
    per-request EXECUTION mode: the precision of the fused layers' dense
    products, whether observable reductions take the compensated pair path,
    and the plane dtype the engine computes in. Higher ``rank`` is more
    accurate and slower; the budget API picks the lowest rank whose modeled
    error fits a caller's budget.

    ``drift_per_gate`` seeds the tier error model: the worst-case max
    amplitude deviation one gate pass adds at this tier (the JAX package's
    measured constants, its ``docs/accuracy.md``).
    """

    name: str                # "fast" | "single" | "double" | "quad"
    rank: int                # ladder position (0 = fastest)
    drift_per_gate: float    # seed error-model constant
    matmul_precision: str    # "default" (bf16 inputs) | "highest"
    compensated: bool        # compensated (pair-path) reductions
    real_dtype: torch.dtype  # plane dtype the tier executes in


# FAST: the fused layers' dense stages (lane, clane, rowmxu) take bf16
# inputs on the tensor cores, with the state split error-free into a bf16
# hi part and a bf16-rounded residual and float32 accumulation
# (ops/layer_kernel.py). Plain gates outside the layers stay full float32
# in this port. The seed is the JAX package's (5e-4 per gate), which
# covers the operator's bf16 rounding.
FAST_TIER = PrecisionTier("fast", 0, 5e-4, "default", False, torch.float32)
# SINGLE-compensated: full float32 products plus the compensated pair-path
# reductions (ops/reductions.py) for scalar observables.
SINGLE_TIER = PrecisionTier("single", 1, 1e-7, "highest", True,
                            torch.float32)
# DOUBLE: float64 planes (an f64-storage environment only).
DOUBLE_TIER = PrecisionTier("double", 2, 1e-15, "highest", False,
                            torch.float64)
# QUAD: double-double planes (ops/doubledouble.py; the JAX package's
# seed, ~1e-17 per gate). Rides the batched engine's dd walk per dispatch
# (float32 hi/lo planes from a float64 environment's states).
QUAD_TIER = PrecisionTier("quad", 3, 1e-17, "highest", True, torch.float32)

TIER_LADDER = (FAST_TIER, SINGLE_TIER, DOUBLE_TIER, QUAD_TIER)


def tier_by_name(name) -> PrecisionTier:
    """Resolve a tier by its name (accepts a PrecisionTier unchanged)."""
    if isinstance(name, PrecisionTier):
        return name
    for t in TIER_LADDER:
        if t.name == str(name).lower():
            return t
    raise ValueError(f"unknown precision tier {name!r}; expected one of "
                     f"{[t.name for t in TIER_LADDER]}")
