"""Opt-in gate fusion for the imperative per-gate path.

Counterpart of the fusion buffer of the JAX package's ``parallel/pergate.py``.
The sharded per-gate engine of that module (lazy qubit layout, pair
exchanges) waits for the port's multi-device slice (ROADMAP Queue 1 item
8); on one device every fused group is one call of the gate engine. QUAD
registers never take it: ``api.startGateFusion`` raises on them, as the
JAX package's does (their double-double gates dispatch eagerly).
"""

from __future__ import annotations

import numpy as np

__all__ = ["GateFusionBuffer"]


class GateFusionBuffer:
    """Opt-in gate fusion for the imperative per-gate path.

    Activated by ``api.startGateFusion`` (or the ``fusedGates`` context
    manager): gate calls append LOGICAL op records here instead of
    dispatching, and :meth:`flush` contracts them through the same fusion
    engine as the compiled pipeline (:mod:`quest_tpu_torch.core.fusion`)
    before dispatching each fused group once, so a run of L adjacent small
    gates costs one pass over the state instead of L.

    Flushing is automatic at every state read: ``Qureg.state`` and
    ``Qureg.ensure_canonical`` drain the buffer first, so measurements,
    reductions, channels, compiled-circuit runs and host reads always see
    the up-to-date state. A full state overwrite (``init*``) discards
    pending gates, which is what applying them first would have produced.
    """

    def __init__(self, qureg, max_k: int = 3):
        from ..core.fusion import resolve_fusion_k
        lt = qureg.num_qubits_in_state_vec
        # density registers lift a k-qubit gate to 2k state-vector
        # targets; halving the budget keeps every fused group on the
        # one-pass lifted path. The same halving bounds folded diagonals:
        # a u-qubit folded factor lifts to a 2^(2u)-entry superfactor
        local = lt // 2 if qureg.is_density_matrix else lt
        self.qureg = qureg
        self.max_k = resolve_fusion_k(max_k, max(local, 1))
        self.diag_max = min(12, max(local, 1))
        self.ops: list = []
        self.flushing = False
        self.gates_in = 0
        self.kernels_out = 0

    @property
    def pending(self) -> bool:
        return bool(self.ops)

    def add_gate(self, u, targets: tuple, ctrl_mask: int,
                 flip_mask: int) -> None:
        from ..circuits import _Op
        self.ops.append(_Op("u", tuple(int(t) for t in targets),
                            ctrl_mask, flip_mask,
                            mat=np.asarray(u, dtype=np.complex128)))

    def add_diag(self, tensor, qs_desc: tuple) -> None:
        from ..circuits import _Op
        self.ops.append(_Op("diag", tuple(int(q) for q in qs_desc),
                            diag=np.asarray(tensor, dtype=np.complex128)))

    def flush(self) -> None:
        """Contract and dispatch everything pending (reentrancy-safe: the
        dispatched gates read and write ``qureg.state`` themselves)."""
        if not self.ops or self.flushing:
            return
        ops, self.ops = self.ops, []
        self.flushing = True
        try:
            from ..core.fusion import fuse_ops
            from .. import api
            fused, stats = fuse_ops(ops, max_k=self.max_k,
                                    diag_max=self.diag_max)
            self.gates_in += stats.gates_in
            self.kernels_out += stats.kernels_out
            for op in fused:
                api._dispatch_fused_op(self.qureg, op)
        finally:
            self.flushing = False

    def discard(self) -> None:
        """Drop pending gates (the register state was fully overwritten)."""
        self.ops.clear()
