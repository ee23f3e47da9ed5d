"""Per-gate sharded execution with a lazy qubit layout, and the opt-in
imperative gate fusion.

Counterpart of the JAX package's ``parallel/pergate.py``. On a mesh the
reference routes every imperative gate at run time and pays physical SWAPs
both ways for a non-local multi-qubit target
(``QuEST_cpu_distributed.c:1420-1461``). Here the register carries a lazy
logical->physical permutation (``Qureg.layout``), so:

- ``swapGate`` on a mesh register is METADATA ONLY: no data moves;
- a dense 1q gate on a sharded position runs as the role-split pair
  exchange (:func:`~quest_tpu_torch.parallel.exchange.
  apply_1q_cross_shard`; layout unchanged);
- a k>=2-qubit dense gate with sharded targets triggers ONE relayout that
  swaps its targets onto the exchange's staging slots and leaves them
  there: the swap-back waits until a reader needs canonical order
  (``Qureg.ensure_canonical``);
- diagonal gates and controls run at any position with no communication;
- a dense gate with more targets than a chunk has local positions (a
  lifted density channel on a small register over many shards) brings
  as many targets local as there are free local positions, then runs on
  groups of the ``2^g`` chunks that differ in the ``g`` device bits left
  among its targets (``exchange.apply_op_grouped``).

Every step acts on the register's chunks through
:mod:`quest_tpu_torch.parallel.exchange`. A QUAD register's ``(4,
2^(N-s))`` double-double chunks take the same steps, its relayouts moving
the hi and lo planes together; its gates run through the dd kernels, and
a 1q gate on a device bit as a group of two chunks (no role-split combine
exists in dd arithmetic).
"""

from __future__ import annotations

import os

import numpy as np

from ..resilience import faults as _faults
from ..telemetry import profile as _profile
from ..telemetry.tracing import dispatch_annotation
from .exchange import (apply_1q_cross_shard, apply_op_grouped,
                       apply_op_local, overlap_eligible, plan_exchange,
                       run_exchange, run_exchange_overlapped)

__all__ = ["use_lazy", "phys_targets", "localise_targets",
           "canonicalise", "sharded_unitary", "sharded_diag",
           "metadata_swap", "phys_index", "GateFusionBuffer",
           "overlap_enabled"]

# relayout exchanges actually run (the lazy layout keeps this far below
# the count of gates that touch sharded qubits)
RELAYOUT_COUNT = 0


def _maybe_inject(qureg, site: str) -> None:
    """Fault-injection boundary of the imperative sharded path
    (:mod:`quest_tpu_torch.resilience.faults`; a no-op unless an injector
    is installed): a drawn output fault corrupts the input chunks, and
    the dispatch carries it on as a bad kernel output would."""
    poison = _faults.fire(site)
    if poison:
        chunks = qureg._chunks
        for d in range(len(chunks)):
            chunks[d] = _faults.poison_output(poison, chunks[d])


def _chunk_bytes(qureg) -> float:
    c = qureg._chunks[0]
    return float(c.numel() * c.element_size() * len(qureg._chunks))


def _profiled(qureg, site: str, kind: str, form: str, run) -> None:
    """Run one sharded dispatch inside its profile span, fault boundary
    and trace range."""
    sp = _profile.profile_dispatch(site)
    _maybe_inject(qureg, site)
    with dispatch_annotation(f"quest_tpu_torch.{site}:{form}"):
        run()
    if sp is not None:
        sp.done(None, program="pergate", kind=kind, bucket=1,
                dtype=str(qureg.real_dtype).replace("torch.", ""),
                sharding=form, bytes_per_pass=2.0 * _chunk_bytes(qureg))


def overlap_enabled() -> bool:
    """Opt-in comm/compute overlap for the per-gate path
    (``QUEST_TPU_OVERLAP=1``): a swap-to-local relayout and the gate it
    serves run as one slab double-buffered step
    (``exchange.run_exchange_overlapped``), the imperative analogue of
    ``compile(overlap=True)``. Read per call."""
    return os.environ.get("QUEST_TPU_OVERLAP", "0") not in ("0", "", "off")


def use_lazy(qureg) -> bool:
    """True when the register runs the sharded per-gate path: a mesh env
    and a register at least as large as the mesh."""
    return qureg.env.mesh is not None and qureg.sharding() is not None


def _shard_bits(qureg) -> int:
    return qureg.env.num_devices.bit_length() - 1


def _perm(qureg) -> np.ndarray:
    if qureg.layout is None:
        return np.arange(qureg.num_qubits_in_state_vec)
    return qureg.layout


def phys_index(qureg, index: int) -> int:
    """Physical amplitude index of logical basis index ``index`` (bit q of
    the logical index lives at physical bit ``layout[q]``)."""
    if qureg.layout is None:
        return int(index)
    out = 0
    for q, p in enumerate(qureg.layout):
        if (int(index) >> q) & 1:
            out |= 1 << int(p)
    return out


def phys_targets(qureg, qubits) -> tuple:
    perm = _perm(qureg)
    return tuple(int(perm[q]) for q in qubits)


def _phys_masks(perm, ctrl_mask: int, flip_mask: int) -> tuple[int, int]:
    cm = fm = 0
    m, q = ctrl_mask, 0
    while m:
        if m & 1:
            cm |= 1 << int(perm[q])
            if (flip_mask >> q) & 1:
                fm |= 1 << int(perm[q])
        m >>= 1
        q += 1
    return cm, fm


def _relayout(qureg, before, after) -> None:
    global RELAYOUT_COUNT
    n = qureg.num_qubits_in_state_vec
    plan = plan_exchange(n, _shard_bits(qureg), tuple(int(p) for p in before),
                         tuple(int(p) for p in after))
    RELAYOUT_COUNT += 1
    _profiled(qureg, "pergate.relayout", "relayout", "amp",
              lambda: run_exchange(qureg._chunks, plan))


def canonicalise(qureg) -> None:
    """Restore the identity layout (one exchange), if needed."""
    lay = qureg.layout
    if lay is None:
        return
    if not np.array_equal(lay, np.arange(len(lay))):
        _relayout(qureg, lay, range(len(lay)))
    qureg.layout = None


def _localise_perm(qureg, targets, partial: bool = False):
    """The permutation a swap-to-local relayout realises: every sharded
    logical target lands on a staging slot (with ``partial``, as many as
    there are local positions the gate does not use). Returns ``(perm,
    new_perm)``, ``new_perm`` None when nothing moves."""
    n = qureg.num_qubits_in_state_vec
    lt = n - _shard_bits(qureg)
    perm = _perm(qureg)
    sharded = [t for t in targets if perm[t] >= lt]
    if not sharded:
        return perm, None
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    # victims: the qubits on the staging slots themselves (a direct swap),
    # skipping the gate's own qubits
    stages = []
    for p in range(lt - 1, -1, -1):
        if int(inv[p]) in targets:
            continue
        stages.append(p)
        if len(stages) == len(sharded):
            break
    if partial:
        sharded = sharded[:len(stages)]
        if not sharded:
            return perm, None
    if len(stages) < len(sharded):
        raise ValueError(
            f"a {len(targets)}-qubit unitary cannot be localised with "
            f"{lt} local qubit positions")
    new_perm = perm.copy()
    for q, stage in zip(sharded, stages):
        victim = int(inv[stage])
        new_perm[victim] = new_perm[q]
        new_perm[q] = stage
        inv[stage] = q
        inv[new_perm[victim]] = victim
    return perm, new_perm


def localise_targets(qureg, targets, partial: bool = False) -> np.ndarray:
    """Bring every logical target (with ``partial``, as many as fit) to a
    local position with at most ONE relayout (the swap-to-local of
    ``QuEST_cpu_distributed.c:1426-1448``, batched, its swap-back
    deferred). Returns the active permutation."""
    perm, new_perm = _localise_perm(qureg, targets, partial)
    if new_perm is None:
        return perm
    _relayout(qureg, perm, new_perm)
    qureg.layout = new_perm
    return new_perm


def sharded_unitary(qureg, u, targets, ctrl_mask: int,
                    flip_mask: int) -> None:
    """Apply a dense (controlled) unitary ``u`` (complex numpy) on LOGICAL
    targets: local positions -> each chunk; one sharded 1q target -> the
    role-split pair exchange (on dd chunks, a group of two); sharded
    multi-qubit targets -> one swap-to-local relayout, then each chunk;
    more targets than local positions -> the grouped pass. Controls never
    move."""
    n = qureg.num_qubits_in_state_vec
    s = _shard_bits(qureg)
    lt = n - s
    chunks = qureg.chunks
    perm = _perm(qureg)
    dd = qureg.is_quad
    targets = tuple(int(t) for t in targets)
    phys_t = tuple(int(perm[t]) for t in targets)
    wide = len(targets) > lt
    if wide or (dd and len(targets) == 1 and phys_t[0] >= lt):
        if wide:
            perm = localise_targets(qureg, targets, partial=True)
            phys_t = tuple(int(perm[t]) for t in targets)
        cmask, fmask = _phys_masks(perm, ctrl_mask, flip_mask)
        _profiled(qureg, "pergate.gate", "gate", "group",
                  lambda: apply_op_grouped(chunks, u, phys_t, cmask, fmask,
                                           lt, s, dd=dd))
        return
    if len(targets) == 1 and phys_t[0] >= lt:
        cmask, fmask = _phys_masks(perm, ctrl_mask, flip_mask)
        _profiled(qureg, "pergate.gate", "gate", "xshard",
                  lambda: apply_1q_cross_shard(chunks, u, phys_t[0], lt, s,
                                               cmask, fmask))
        return
    if any(p >= lt for p in phys_t):
        if overlap_enabled() and not dd:
            old_perm, new_perm = _localise_perm(qureg, targets)
            phys_new = tuple(int(new_perm[t]) for t in targets)
            cmask, fmask = _phys_masks(new_perm, ctrl_mask, flip_mask)
            expl = plan_exchange(n, s, tuple(int(p) for p in old_perm),
                                 tuple(int(p) for p in new_perm))
            if overlap_eligible(expl, phys_new, cmask):
                global RELAYOUT_COUNT
                RELAYOUT_COUNT += 1
                _profiled(qureg, "pergate.gate", "gate", "overlap",
                          lambda: run_exchange_overlapped(
                              chunks, expl, u, phys_new, cmask, fmask))
                qureg.layout = new_perm
                return
        perm = localise_targets(qureg, targets)
        phys_t = tuple(int(perm[t]) for t in targets)
    cmask, fmask = _phys_masks(perm, ctrl_mask, flip_mask)
    _profiled(qureg, "pergate.gate", "gate", "local",
              lambda: apply_op_local(chunks, "u", u, phys_t, cmask, fmask,
                                     lt, dd=dd))


def sharded_diag(qureg, tensor_np, qs_desc) -> None:
    """Apply a diagonal factor on LOGICAL qubits (any position, no
    communication). ``tensor_np``'s axes follow ``qs_desc`` (logical,
    sorted descending); they are reordered to physical descending
    here."""
    n = qureg.num_qubits_in_state_vec
    lt = n - _shard_bits(qureg)
    perm = _perm(qureg)
    phys = tuple(int(perm[q]) for q in qs_desc)
    order = tuple(int(i) for i in np.argsort(phys)[::-1])
    phys_desc = tuple(phys[i] for i in order)
    t = np.ascontiguousarray(np.transpose(np.asarray(tensor_np), order))
    apply_op_local(qureg.chunks, "diag", t, phys_desc, 0, 0, lt,
                   dd=qureg.is_quad)


def metadata_swap(qureg, q1: int, q2: int) -> None:
    """swapGate as bookkeeping: exchange the physical positions of two
    logical qubits (the reference moves amplitudes,
    ``statevec_swapQubitAmps``, ``QuEST_cpu_distributed.c:1355-1371``)."""
    perm = _perm(qureg).copy()
    perm[q1], perm[q2] = perm[q2], perm[q1]
    qureg.layout = perm


class GateFusionBuffer:
    """Opt-in gate fusion for the imperative per-gate path.

    Activated by ``api.startGateFusion`` (or the ``fusedGates`` context
    manager): gate calls append LOGICAL op records here instead of
    dispatching, and :meth:`flush` contracts them through the same fusion
    engine as the compiled pipeline (:mod:`quest_tpu_torch.core.fusion`)
    before dispatching each fused group once, so a run of L adjacent small
    gates costs one pass over the state (and, on a mesh, at most one
    relayout) instead of L.

    Flushing is automatic at every state read: ``Qureg.state``,
    ``Qureg.chunks`` and ``Qureg.ensure_canonical`` drain the buffer
    first, so measurements, reductions, channels, compiled-circuit runs
    and host reads always see the up-to-date state. A full state
    overwrite (``init*``) discards pending gates, which is what applying
    them first would have produced.
    """

    def __init__(self, qureg, max_k: int = 3):
        from ..core.fusion import resolve_fusion_k
        lt = qureg.num_qubits_in_state_vec - (
            _shard_bits(qureg) if use_lazy(qureg) else 0)
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
        dispatched gates read and write the register themselves)."""
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
