"""Distribution machinery: qubit-layout planning and the shard exchange.

The reference decides per gate whether a target is chunk-local or needs an
MPI pair exchange (``QuEST_cpu_distributed.c``). Here, as in the JAX
package, that is a compile-time layout plan (:mod:`.layout`: a lazily
tracked logical->physical qubit permutation with batched relayouts), and
one process drives a mesh of shards (:mod:`.mesh`) whose every data
movement is an explicit copy between shard chunks (:mod:`.exchange`).
"""

from .layout import LayoutPlan, apply_relayout, plan_layout
from .multihost import HostTopology, host_topology

__all__ = ["LayoutPlan", "plan_layout", "apply_relayout",
           "HostTopology", "host_topology"]
