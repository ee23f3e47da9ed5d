"""What the batched programs on a mesh share: ``batch`` mode's one-device
twins and its pad-and-mask split of a batch's rows, and ``amp`` mode's
shared start planes as the mesh's chunks.

Used by :class:`~quest_tpu_torch.circuits.CompiledCircuit` (sweeps) and
:class:`~quest_tpu_torch.ops.trajectories.TrajectoryProgram` (trajectory
waves). An owner is a program on a mesh env that holds ``_stats_lock`` and
``_warned_nondivisible``.
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["shard_twin", "split_rows", "start_chunks"]


def shard_twin(owner, d: int, reset: Callable[[object], None]):
    """``owner`` as it runs on shard ``d``'s device alone: a shallow copy
    (sharing its plans, items and packed layers) whose env is a one-device
    env on that device with the same precision, generator and
    compensation. ``reset(twin)`` clears what the twin must not share with
    its owner. Built once per shard."""
    twins = owner.__dict__.setdefault("_twins", {})
    if d not in twins:
        tw = copy.copy(owner)
        tw.env = dataclasses.replace(owner.env, mesh=None,
                                     device=owner.env.mesh.devices[d])
        tw._twins = {}
        reset(tw)
        twins[d] = tw
    return twins[d]


def _padded(rows, pad: int):
    if isinstance(rows, torch.Tensor):
        return torch.cat([rows] + [rows[:1]] * pad)
    return np.concatenate([rows] + [rows[:1]] * pad)


def split_rows(owner, what: str, num: int, *rows) -> tuple:
    """``batch`` mode's split of ``num`` rows over the owner's mesh:
    ``(per, rows)``, the rows each shard takes and ``rows`` (numpy arrays
    or tensors of ``num`` rows each) padded to a multiple of the mesh with
    copies of their first row, whose results the caller drops
    (pad-and-mask, as the JAX package does). The first ``num`` rows stay
    the caller's. One warning per owner."""
    devices = owner.env.num_devices
    pad = (-num) % devices
    if pad:
        with owner._stats_lock:
            warn_now = not owner._warned_nondivisible
            owner._warned_nondivisible = True
        if warn_now:
            warnings.warn(
                f"{what} of {num} is not divisible by the {devices}-device "
                f"mesh; padding to {num + pad} and masking the {pad} extra "
                "rows", UserWarning, stacklevel=5)
        rows = tuple(_padded(r, pad) for r in rows)
    return (num + pad) // devices, rows


def start_chunks(planes: torch.Tensor, devices: Sequence[torch.device],
                 local: int, batch: Optional[int] = None,
                 dtype: Optional[torch.dtype] = None) -> list:
    """Shared ``(2, 2^n)`` start planes as the mesh's chunks, each on its
    shard's device in ``dtype`` (default the planes'): ``(2, 2^local)``
    each, or with ``batch`` fresh ``(batch, 2, 2^local)`` copies."""
    C = 1 << local
    dtype = planes.dtype if dtype is None else dtype
    out = []
    for d, dev in enumerate(devices):
        c = planes[:, d * C:(d + 1) * C].to(device=dev, dtype=dtype)
        out.append(c.contiguous() if batch is None else c.expand(
            batch, 2, C).clone(memory_format=torch.contiguous_format))
    return out
