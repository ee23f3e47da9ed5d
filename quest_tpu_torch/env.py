"""Execution environment: device, precision, randomness.

Counterpart of the JAX package's ``env.py`` for one CUDA device. One
environment object carries

- an explicit :class:`torch.device`, ``cuda:0`` unless the caller names
  another (the tests pass ``"cpu"``). There is no silent drop to the CPU:
  asking for the default device on a machine without CUDA raises;
- the numeric :class:`~quest_tpu_torch.config.Precision`;
- one :class:`torch.Generator` that every measurement draw comes from —
  the analogue of the reference's seeded mt19937 stream
  (``QuEST_common.c:154-213``). Its numbers differ from the JAX package's
  threefry stream for the same seed, so measurement parity between the
  packages is checked through ``collapseToOutcome``, never through draws;
- ``compensated``: error-compensated scalar reductions
  (``ops/reductions.py``), on by default at SINGLE.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from .config import Precision, default_precision

__all__ = ["QuESTEnv", "create_quest_env", "destroy_quest_env",
           "default_compensated"]


@dataclasses.dataclass
class QuESTEnv:
    """Runtime environment handle (device + precision + RNG)."""

    precision: Precision
    device: torch.device
    generator: torch.Generator = None  # type: ignore[assignment]
    compensated: bool = False

    # one device, one process: the reference's mesh fields as constants
    # until the port shards (ROADMAP Queue 1 item 8)

    @property
    def num_devices(self) -> int:
        return 1

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_ranks(self) -> int:
        return 1

    @property
    def is_multihost(self) -> bool:
        return False

    def seed(self, seeds: Sequence[int]) -> None:
        """Re-seed the measurement RNG (``seedQuEST`` ``QuEST.h:1858``):
        every seed word contributes, as the reference's key array does."""
        words = [int(s) & 0xFFFFFFFF for s in seeds]
        state = np.random.SeedSequence(words).generate_state(1, np.uint64)
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(int(state[0]) & ((1 << 63) - 1))

    def seed_default(self) -> None:
        """Seed from time and pid (``seedQuESTDefault``
        ``QuEST_common.c:181-213``)."""
        self.seed([int(time.time() * 1e6) & 0xFFFFFFFF, os.getpid()])

    def uniform(self) -> float:
        """One draw in [0, 1) from the env stream (host-side: a measurement
        needs one number, and drawing it on the host costs no device
        round trip)."""
        return float(torch.rand((), generator=self.generator,
                                dtype=torch.float64))

    def sync(self) -> None:
        """Barrier analogue (``syncQuESTEnv``): wait for queued device
        work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def report(self) -> str:
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return "\n".join([
            "QuEST-torch execution environment:",
            f"  device: {self.device} ({name})",
            f"  precision: {self.precision.name} "
            f"({self.precision.complex_dtype})",
        ])


def default_compensated(precision: Precision) -> bool:
    """The compensated-reductions default: on for single precision (where
    naive float32 accumulation falls ~5 decades short of the reference's
    1e-10 scalar tolerance), off for double and the double-double QUAD
    formats (their reductions are compensated by construction). QUAD64's
    float64 planes need no guard: torch never narrows them."""
    return precision.quest_prec == 1


def _resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "createQuESTEnv: no CUDA device is available; pass "
                "device='cpu' to run on the host explicitly")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"createQuESTEnv: {device} requested but "
                               "CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def create_quest_env(num_devices: Optional[int] = None,
                     precision: Optional[Precision] = None,
                     seed: Optional[Sequence[int]] = None,
                     compensated: Optional[bool] = None,
                     device: Union[None, str, torch.device] = None
                     ) -> QuESTEnv:
    """Create the execution environment (``createQuESTEnv``
    ``QuEST.h:785``). ``num_devices`` of None or 1 is one device; more
    raise ``NotImplementedError`` until the port shards (ROADMAP Queue 1
    item 8). ``device=None`` selects ``cuda:0`` and raises where there is
    no CUDA device."""
    if num_devices is not None and int(num_devices) != 1:
        raise NotImplementedError(
            f"createQuESTEnv(num_devices={num_devices}): the port runs on "
            "one device; multi-device environments wait for ROADMAP "
            "Queue 1 item 8")
    dev = _resolve_device(device)
    precision = precision or default_precision()
    if compensated is None:
        compensated = default_compensated(precision)
    if dev.type == "cuda":
        # float32 matmuls of the per-gate engine must run in full fp32:
        # TF32 tensor-core inputs keep ~10 mantissa bits and would cost
        # ~1e-3 per gate — the same trap as the TPU MXU's bf16 default
        # that the JAX package's core/apply.py pins HIGHEST against
        torch.backends.cuda.matmul.allow_tf32 = False
    env = QuESTEnv(precision=precision, device=dev, compensated=compensated)
    if seed is not None:
        env.seed(seed)
    else:
        env.seed_default()
    return env


def destroy_quest_env(env: QuESTEnv) -> None:
    """No-op (tensors are reference-counted); kept for API parity
    (``destroyQuESTEnv`` ``QuEST.h:795``)."""
