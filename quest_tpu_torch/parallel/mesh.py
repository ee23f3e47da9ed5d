"""The single-controller mesh of amplitude shards.

Counterpart of the ``jax.sharding.Mesh`` the JAX package's env holds
(``env.py``): one process drives ``2^s`` shards, each a ``torch.device``.
Shards may be distinct cards, the host (the CPU tests' counterpart of the
JAX package's virtual CPU devices), or several on one card
(``devices=["cuda:0"] * 4``); every data movement between them is an
explicit copy between shard tensors (``parallel/exchange.py``).

Amplitude layout follows the reference's chunk model (``QuEST.h:169-177``):
with ``n`` qubits over ``2^s`` shards, shard ``d`` holds amplitudes
``[d * 2^(n-s), (d+1) * 2^(n-s))``, i.e. the shard index is ``amp >> (n-s)``
and shard bit ``j`` is physical qubit position ``(n-s)+j``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

__all__ = ["AMP_AXIS", "Mesh", "ChunkSharding"]

AMP_AXIS = "amps"


class Mesh:
    """An ordered tuple of shard devices over the amplitude axis."""

    def __init__(self, devices: Sequence, axis_name: str = AMP_AXIS):
        devs = tuple(torch.device(d) for d in devices)
        size = len(devs)
        if size < 1 or size & (size - 1):
            raise ValueError("the device count must be a power of 2 "
                             "(amplitude sharding halves per device)")
        self.devices = devs
        self.axis_name = axis_name

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shard_bits(self) -> int:
        return self.size.bit_length() - 1

    @property
    def shape(self) -> dict:
        return {self.axis_name: self.size}

    def __repr__(self) -> str:
        devices = ", ".join(str(d) for d in self.devices)
        return f"Mesh({self.axis_name}={self.size}, devices=[{devices}])"


@dataclasses.dataclass(frozen=True)
class ChunkSharding:
    """The port's description of a register's chunk layout on a mesh (the
    JAX package's ``NamedSharding``): ``sharded`` splits the amplitude
    axis on its leading (high-qubit) bits over the mesh, else every shard
    would hold the whole array."""

    mesh: Mesh
    sharded: bool = True

    def shard_of(self, amp: int, num_qubits: int) -> int:
        """Index of the shard holding amplitude ``amp`` of an
        ``num_qubits``-qubit register: ``amp >> (n - s)``."""
        if not self.sharded:
            return 0
        return int(amp) >> (num_qubits - self.mesh.shard_bits)
