"""Precision configuration.

Counterpart of the JAX package's ``config.py``: precision is a runtime
property of the environment (the reference's compile-time ``QuEST_PREC``
switch, ``QuEST_precision.h:28-65``). This slice carries the two register
formats a CUDA card holds natively: SINGLE (float32 planes, the default on
the card) and DOUBLE (float64 planes). The FAST tier, QUAD and the tier
ladder belong to a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["Precision", "SINGLE", "DOUBLE", "default_precision"]


@dataclasses.dataclass(frozen=True)
class Precision:
    """Numeric precision bundle (mirrors qreal/REAL_EPS of the reference)."""

    quest_prec: int  # 1=single, 2=double (reference QuEST_PREC)
    real_dtype: torch.dtype
    complex_dtype: torch.dtype
    # REAL_EPS analogue (QuEST_precision.h: 1e-5 single / 1e-13 double)
    eps: float

    @property
    def name(self) -> str:
        return {1: "single", 2: "double"}[self.quest_prec]


SINGLE = Precision(1, torch.float32, torch.complex64, 1e-5)
DOUBLE = Precision(2, torch.float64, torch.complex128, 1e-13)


def default_precision() -> Precision:
    """SINGLE: float32 planes are the card's native format."""
    return SINGLE
