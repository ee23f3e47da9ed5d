"""Carrying registers and circuits across from the JAX package.

A simulator's "weights" are its register and its circuit. These helpers
take the JAX package's host-side forms — the ``(2, 2^N)`` numpy planes of a
register (``np.asarray(jax_qureg.state)``; a density register's are the
flat ``(2, 4^n)`` vector, ``flat[r + c*2^n] = rho[r, c]``, in both
packages) and plain records of a circuit's ops — so one state or one
random circuit runs through both packages with exactly the same numbers. Nothing here imports the JAX package.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np
import torch

from .circuits import Circuit, _Op
from .env import QuESTEnv
from .qureg import Qureg

__all__ = ["qureg_from_planes", "planes_of", "circuit_from_records"]


def qureg_from_planes(np_planes: np.ndarray, env: QuESTEnv,
                      is_density: bool = False) -> Qureg:
    """A register holding the given ``(2, 2^N)`` planes, cast to the env's
    precision and placed on its device: a state vector of N qubits, or
    with ``is_density`` a density register of N/2 qubits whose planes are
    the flat vector."""
    planes = np.asarray(np_planes)
    if planes.ndim != 2 or planes.shape[0] != 2:
        raise ValueError(f"expected (2, 2^N) planes, got {planes.shape}")
    num_amps = planes.shape[1]
    n = num_amps.bit_length() - 1
    if num_amps != 1 << n:
        raise ValueError(f"{num_amps} amplitudes is not a power of two")
    if is_density and n % 2:
        raise ValueError(f"{num_amps} amplitudes is not a square density "
                         "matrix (2^(2n) flat entries)")
    q = Qureg(n // 2 if is_density else n, env, is_density=is_density)
    if q.is_sharded:
        # each shard takes its slice of the planes (copied)
        per = num_amps // env.num_devices
        q.chunks = [torch.as_tensor(np.array(planes[:, d * per:(d + 1) * per]),
                                    dtype=env.precision.real_dtype,
                                    device=dev)
                    for d, dev in enumerate(env.mesh.devices)]
        return q
    # np.array copies: the register never aliases the caller's array
    q.state = torch.as_tensor(np.array(planes), dtype=env.precision.real_dtype,
                              device=env.device)
    return q


def planes_of(qureg: Qureg) -> np.ndarray:
    """The register's ``(2, 2^N)`` planes as a host numpy array (a density
    register's flat vector); a sharded register's chunks are put in
    canonical order and gathered on the host."""
    if qureg.is_sharded:
        qureg.ensure_canonical()
        return np.concatenate([c.detach().cpu().numpy()
                               for c in qureg.chunks], axis=1)
    return qureg.state.detach().cpu().numpy()


def circuit_from_records(num_qubits: int, records: Iterable) -> Circuit:
    """Rebuild a circuit from ``(kind, targets, ctrl_mask, flip_mask,
    mat_or_diag)`` records: ``kind`` is ``"u"`` (a dense matrix, bit ``j``
    of its index addressing ``targets[j]``) or ``"diag"`` (a ``(2,)*k``
    factor tensor whose axes follow ``targets`` sorted descending) — the
    field layout of a recorded op in either package."""
    c = Circuit(num_qubits)
    for kind, targets, ctrl_mask, flip_mask, data in records:
        targets = tuple(int(t) for t in targets)
        c._check(targets + tuple(q for q in range(num_qubits)
                                 if (int(ctrl_mask) >> q) & 1))
        data = np.array(data, dtype=np.complex128)
        if kind == "u":
            dim = 1 << len(targets)
            if data.shape != (dim, dim):
                raise ValueError(f"matrix shape {data.shape} != "
                                 f"{(dim, dim)}")
            c.ops.append(_Op("u", targets, int(ctrl_mask), int(flip_mask),
                             mat=data))
        elif kind == "diag":
            if tuple(targets) != tuple(sorted(targets, reverse=True)):
                raise ValueError("diagonal targets must be sorted "
                                 "descending")
            if data.shape != (2,) * len(targets):
                raise ValueError(f"diagonal tensor shape {data.shape} != "
                                 f"{(2,) * len(targets)}")
            c.ops.append(_Op("diag", targets, diag=data))
        else:
            raise ValueError(f"unknown op kind {kind!r}")
    return c
