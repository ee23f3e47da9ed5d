"""Host topology of a mesh, as the layout planner sees it.

Counterpart of the planning half of the JAX package's
``parallel/multihost.py``: which amplitude-sharding device bits cross a
host boundary, so the planner (:mod:`quest_tpu_torch.parallel.layout`)
prices each collective at the tier it rides. The port's mesh is driven by
one process, so a mesh spans one host unless ``QUEST_TPU_FORCE_HOSTS=H``
(or ``num_hosts=``) asks the planner to plan as if it spanned ``H``.
Joining a multi-process run (the JAX package's ``bootstrap``) waits for
ROADMAP Queue 1 item 8's remainder.

Bit geometry: with ``D = 2^s`` devices and ``H = 2^h`` hosts of ``D/H``
devices each, a device's host index is its device index's top ``h`` bits,
so the top ``h`` physical positions ``n-h .. n-1`` are the inter-host
positions.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["HostTopology", "SINGLE_HOST", "host_topology",
           "inter_host_positions"]


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Process grouping of one device mesh, as the planner sees it."""

    num_hosts: int        # controller processes the mesh spans
    num_devices: int      # devices in the mesh
    host_bits: int        # device-index bits selecting the host (top bits)

    @property
    def devices_per_host(self) -> int:
        return self.num_devices // max(self.num_hosts, 1)

    @property
    def is_multihost(self) -> bool:
        return self.host_bits > 0

    def inter_positions(self, num_qubits: int) -> tuple[int, ...]:
        """The physical qubit positions whose exchange crosses hosts."""
        return inter_host_positions(num_qubits, self.host_bits,
                                    self.host_bits)


SINGLE_HOST = HostTopology(num_hosts=1, num_devices=1, host_bits=0)


def _forced_hosts() -> Optional[int]:
    raw = os.environ.get("QUEST_TPU_FORCE_HOSTS")
    if not raw:
        return None
    try:
        h = int(raw)
    except ValueError:
        return None
    return h if h >= 1 else None


def host_topology(mesh, num_hosts: Optional[int] = None) -> HostTopology:
    """The :class:`HostTopology` of ``mesh`` (a
    :class:`~quest_tpu_torch.parallel.mesh.Mesh`, or None).

    ``num_hosts`` overrides detection (``QUEST_TPU_FORCE_HOSTS`` does the
    same from the environment; the explicit argument wins); otherwise one
    process drives the mesh, so it spans one host. A non-power-of-two host
    count degrades to every device bit priced at the inter-host tier
    (``host_bits`` = shard bits), as in the JAX package: pessimistic
    pricing, never a wrong plan."""
    if mesh is None:
        return SINGLE_HOST
    n_dev = mesh.size
    if num_hosts is None:
        num_hosts = _forced_hosts()
    if num_hosts is None:
        num_hosts = 1
    num_hosts = max(1, min(int(num_hosts), n_dev))
    if num_hosts & (num_hosts - 1):
        return HostTopology(num_hosts=num_hosts, num_devices=n_dev,
                            host_bits=max(n_dev.bit_length() - 1, 0))
    return HostTopology(num_hosts=num_hosts, num_devices=n_dev,
                        host_bits=num_hosts.bit_length() - 1)


def inter_host_positions(num_qubits: int, shard_bits: int,
                         host_bits: int) -> tuple[int, ...]:
    """Physical positions priced at the inter-host tier: the top
    ``host_bits`` of the ``shard_bits`` device positions."""
    h = max(0, min(host_bits, shard_bits))
    return tuple(range(num_qubits - h, num_qubits))
