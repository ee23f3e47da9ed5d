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
"""

from __future__ import annotations

import math

import torch

__all__ = ["blank", "zero", "plus", "classical", "debug",
           "single_qubit_outcome"]


def blank(num_amps: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    return torch.zeros((2, num_amps), dtype=dtype, device=device)


def zero(num_amps: int, dtype: torch.dtype,
         device: torch.device) -> torch.Tensor:
    return classical(num_amps, dtype, device, 0)


def plus(num_amps: int, dtype: torch.dtype, device: torch.device,
         amp: float) -> torch.Tensor:
    planes = blank(num_amps, dtype, device)
    planes[0].fill_(amp)
    return planes


def classical(num_amps: int, dtype: torch.dtype, device: torch.device,
              index: int) -> torch.Tensor:
    planes = blank(num_amps, dtype, device)
    planes[0, index] = 1.0
    return planes


def debug(num_amps: int, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """amp[k] = (2k + i(2k+1))/10 (``QuEST_cpu.c:1591-1593``), with k
    formed in the plane dtype as the JAX package forms it."""
    k = torch.arange(num_amps, dtype=torch.int64, device=device).to(dtype)
    return torch.stack([(2.0 * k) / 10.0, (2.0 * k + 1.0) / 10.0])


def single_qubit_outcome(num_amps: int, dtype: torch.dtype,
                         device: torch.device, qubit: int,
                         outcome: int) -> torch.Tensor:
    planes = blank(num_amps, dtype, device)
    pre = num_amps >> (qubit + 1)
    post = 1 << qubit
    planes[0].view(pre, 2, post)[:, outcome, :] = \
        1.0 / math.sqrt(num_amps // 2)
    return planes
