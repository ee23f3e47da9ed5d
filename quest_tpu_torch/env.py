"""Execution environment: device or mesh, precision, randomness.

Counterpart of the JAX package's ``env.py``. One environment object
carries

- an explicit :class:`torch.device`, ``cuda:0`` unless the caller names
  another (the tests pass ``"cpu"``). There is no silent drop to the CPU:
  asking for the default device on a machine without CUDA raises;
- with ``num_devices > 1`` (or ``devices=``), a
  :class:`~quest_tpu_torch.parallel.mesh.Mesh` of amplitude shards driven
  by this one process, the single-controller model of the JAX package's
  mesh: the first ``n`` CUDA devices, ``n`` host shards with
  ``device="cpu"`` (the CPU tests), or an explicit list, repeats allowed
  (``devices=["cuda:0"] * 4`` puts four shards on one card). ``device``
  is then the first shard's;
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
from .parallel.mesh import AMP_AXIS, ChunkSharding, Mesh

__all__ = ["QuESTEnv", "create_quest_env", "destroy_quest_env",
           "default_compensated", "AMP_AXIS"]


@dataclasses.dataclass
class QuESTEnv:
    """Runtime environment handle (device or mesh + precision + RNG)."""

    precision: Precision
    mesh: Optional[Mesh] = None
    generator: torch.Generator = None  # type: ignore[assignment]
    compensated: bool = False
    device: torch.device = None  # type: ignore[assignment]

    def __post_init__(self):
        if self.device is None and self.mesh is not None:
            self.device = self.mesh.devices[0]

    @property
    def num_devices(self) -> int:
        return self.mesh.size if self.mesh is not None else 1

    # one process drives the whole mesh (the single controller, as
    # jax.process_index() is 0 on one host): the reference's rank fields
    # as constants

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_ranks(self) -> int:
        return 1

    @property
    def is_multihost(self) -> bool:
        return False

    def sharding(self, sharded: bool = True) -> Optional[ChunkSharding]:
        """The chunk layout of a ``(2, 2^N)`` register on the mesh (None
        off a mesh): the amplitude axis split on its leading (high-qubit)
        bits, shard index ``amp >> (N - s)`` (``QuEST.h:169-177``)."""
        if self.mesh is None:
            return None
        return ChunkSharding(self.mesh, sharded)

    def sharding_flat(self) -> Optional[ChunkSharding]:
        """The same layout for a flat ``(2^N,)`` amplitude vector."""
        return self.sharding()

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
        work on every device of the env."""
        devs = self.mesh.devices if self.mesh is not None else (self.device,)
        for dev in sorted(set(devs), key=str):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def report(self) -> str:
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        mesh = "none (single device)" if self.mesh is None else (
            f"{self.mesh.shape} over "
            f"{', '.join(str(d) for d in self.mesh.devices)}")
        return "\n".join([
            "QuEST-torch execution environment:",
            f"  device: {self.device} ({name})",
            f"  mesh: {mesh}",
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


def _mesh_devices(num_devices: Optional[int], device,
                  devices) -> Optional[list]:
    """The shard devices a mesh env takes, or None for one device."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if num_devices is not None and int(num_devices) != len(devs):
            raise ValueError(f"num_devices={num_devices} but {len(devs)} "
                             "devices were named")
        for d in devs:
            _resolve_device(d)
        if len(devs) < 1:
            raise ValueError("devices must name at least one device")
    else:
        n = 1 if num_devices is None else int(num_devices)
        if n < 1:
            raise ValueError(f"num_devices must be >= 1, got {n}")
        if n == 1:
            return None
        kind = torch.device(device).type if device is not None else "cuda"
        if kind == "cpu":
            devs = [torch.device("cpu")] * n
        elif kind == "cuda":
            have = torch.cuda.device_count() if torch.cuda.is_available() \
                else 0
            if n > have:
                raise ValueError(f"requested {n} devices but only {have} "
                                 "available")
            devs = [torch.device("cuda", i) for i in range(n)]
        else:
            raise ValueError(f"unsupported device {device}")
    if len(devs) & (len(devs) - 1):
        raise ValueError("the device count must be a power of 2 "
                         "(amplitude sharding halves per device)")
    return devs if len(devs) > 1 else None


def create_quest_env(num_devices: Optional[int] = None,
                     precision: Optional[Precision] = None,
                     seed: Optional[Sequence[int]] = None,
                     compensated: Optional[bool] = None,
                     device: Union[None, str, torch.device] = None,
                     devices: Optional[Sequence] = None) -> QuESTEnv:
    """Create the execution environment (``createQuESTEnv``
    ``QuEST.h:785``). ``num_devices`` of None or 1 is one device,
    ``device=None`` selecting ``cuda:0`` (raising where there is no CUDA
    device). ``num_devices=n > 1`` builds a mesh of the first ``n`` CUDA
    devices (``ValueError`` when fewer exist or ``n`` is not a power of
    2, as in the JAX package), or of ``n`` host shards with
    ``device="cpu"``; ``devices=`` names the shards explicitly, repeats
    allowed. Nothing falls back to fewer shards or to the CPU."""
    precision = precision or default_precision()
    if compensated is None:
        compensated = default_compensated(precision)
    mesh_devs = _mesh_devices(num_devices, device, devices)
    if mesh_devs is not None:
        devs = [_resolve_device(d) for d in mesh_devs]
        mesh = Mesh(devs)
        dev = devs[0]
    else:
        mesh = None
        dev = _resolve_device(devices[0] if devices else device)
    if any(d.type == "cuda" for d in ([dev] if mesh is None
                                      else mesh.devices)):
        # float32 matmuls of the per-gate engine must run in full fp32:
        # TF32 tensor-core inputs keep ~10 mantissa bits and would cost
        # ~1e-3 per gate — the same trap as the TPU MXU's bf16 default
        # that the JAX package's core/apply.py pins HIGHEST against
        torch.backends.cuda.matmul.allow_tf32 = False
    env = QuESTEnv(precision=precision, mesh=mesh, compensated=compensated,
                   device=dev)
    if seed is not None:
        env.seed(seed)
    else:
        env.seed_default()
    return env


def destroy_quest_env(env: QuESTEnv) -> None:
    """No-op (tensors are reference-counted); kept for API parity
    (``destroyQuESTEnv`` ``QuEST.h:795``)."""
