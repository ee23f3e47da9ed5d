"""Split real/imag state representation.

A register's state is a float tensor of shape ``(2, 2^N)``: a real plane and
an imaginary plane, the reference's split ``stateVec.real`` /
``stateVec.imag`` storage (``QuEST_cpu.c:1284-1320``) and the JAX package's
layout (its ``core/packing.py``), so the two packages' states compare array
for array. Gate application works on the planes directly (``core/apply.py``
and the layer kernel); complex tensors appear only at the host boundary.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack", "unpack", "pack_host", "unpack_host"]


def unpack(planes: torch.Tensor) -> torch.Tensor:
    """(2, ...) float planes -> complex tensor (a copy)."""
    return torch.complex(planes[0], planes[1])


def pack(z: torch.Tensor) -> torch.Tensor:
    """complex tensor -> (2, ...) float planes (a copy)."""
    return torch.stack([z.real, z.imag])


def pack_host(z: np.ndarray, real_dtype) -> np.ndarray:
    z = np.asarray(z)
    return np.stack([np.real(z), np.imag(z)]).astype(real_dtype)


def unpack_host(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f)
    cdtype = np.complex64 if f.dtype == np.float32 else np.complex128
    return (f[0] + 1j * f[1]).astype(cdtype)
