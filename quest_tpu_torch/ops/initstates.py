"""Device-side state initialisation.

Counterpart of the JAX package's ``ops/initstates.py``: every canned state
is built directly on the register's device, so no O(2^n) host array exists
at any point (the reference fills each chunk in place,
``QuEST_cpu.c:1372-1597``). Each function returns a fresh ``(2, 2^n)``
plane tensor. A density register takes the same functions over its flat
2n-qubit vector: zero and debug as they are, plus with amplitude
``1/2^n`` and classical at flat index ``s * (2^n + 1)`` (the API layer
passes both); a pure state's ``|psi><psi|`` is
``ops/densmatr.py`` ``init_pure_state``.

``quad=True`` builds the QUAD registers' ``(4, 2^n)`` double-double planes
``[re_hi, re_lo, im_hi, im_lo]`` (``ops/doubledouble.py``) instead, with
dd-split constants, so the lo planes carry the part of each amplitude the
plane dtype cannot.
"""

from __future__ import annotations

import math

import torch

from .doubledouble import _dd_add, _dd_mul, _dd_scalar

__all__ = ["blank", "zero", "plus", "classical", "debug",
           "single_qubit_outcome"]


def blank(num_amps: int, dtype: torch.dtype, device: torch.device,
          quad: bool = False) -> torch.Tensor:
    return torch.zeros((4 if quad else 2, num_amps), dtype=dtype,
                       device=device)


def zero(num_amps: int, dtype: torch.dtype, device: torch.device,
         quad: bool = False) -> torch.Tensor:
    return classical(num_amps, dtype, device, 0, quad)


def _fill_real(planes: torch.Tensor, amp: float, quad: bool, where=None):
    """Set the real part to ``amp`` (dd-split on QUAD planes) on
    ``where``'s view of each real plane (all amplitudes when None)."""
    view = (lambda p: p) if where is None else where
    if not quad:
        view(planes[0]).fill_(amp)
        return
    hi, lo = _dd_scalar(amp, planes.dtype)
    view(planes[0]).fill_(hi)
    view(planes[1]).fill_(lo)


def plus(num_amps: int, dtype: torch.dtype, device: torch.device,
         amp: float, quad: bool = False) -> torch.Tensor:
    planes = blank(num_amps, dtype, device, quad)
    _fill_real(planes, amp, quad)
    return planes


def classical(num_amps: int, dtype: torch.dtype, device: torch.device,
              index: int, quad: bool = False) -> torch.Tensor:
    planes = blank(num_amps, dtype, device, quad)
    planes[0, index] = 1.0
    return planes


def debug(num_amps: int, dtype: torch.dtype, device: torch.device,
          quad: bool = False, start: int = 0) -> torch.Tensor:
    """amp[k] = (2k + i(2k+1))/10 (``QuEST_cpu.c:1591-1593``), with k
    formed in the plane dtype as the JAX package forms it. On QUAD planes
    re = k * dd(0.2) and im = re + dd(0.1), as the JAX package forms them:
    the constants carry the bits 1/10 loses in the plane dtype. ``start``
    is the first k (a shard's chunk of a larger register)."""
    k = torch.arange(start, start + num_amps, dtype=torch.int64,
                     device=device).to(dtype)
    if not quad:
        return torch.stack([(2.0 * k) / 10.0, (2.0 * k + 1.0) / 10.0])
    c2h, c2l = _dd_scalar(0.2, dtype)
    c1h, c1l = _dd_scalar(0.1, dtype)
    zero_lo = torch.zeros_like(k)
    re_h, re_l = _dd_mul(k, zero_lo, torch.full_like(k, c2h),
                         torch.full_like(k, c2l))
    im_h, im_l = _dd_add(re_h, re_l, torch.full_like(k, c1h),
                         torch.full_like(k, c1l))
    return torch.stack([re_h, re_l, im_h, im_l])


def single_qubit_outcome(num_amps: int, dtype: torch.dtype,
                         device: torch.device, qubit: int,
                         outcome: int, quad: bool = False) -> torch.Tensor:
    planes = blank(num_amps, dtype, device, quad)
    pre = num_amps >> (qubit + 1)
    post = 1 << qubit
    _fill_real(planes, 1.0 / math.sqrt(num_amps // 2), quad,
               lambda p: p.view(pre, 2, post)[:, outcome, :])
    return planes
