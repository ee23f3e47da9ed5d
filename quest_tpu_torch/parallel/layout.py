"""Lazy qubit-layout planning for sharded execution, and the
dense-contraction crossover.

Counterpart of the JAX package's ``parallel/layout.py``; the planner is a
copy of its pure-numpy code, so for every input a plan here equals the JAX
package's item for item (``tests/test_torch_mesh_plan.py``).

Amplitudes are sharded on the HIGH qubit axes: with ``D = 2^S`` shards,
physical positions ``n-S .. n-1`` index the shard, so a paired
(non-diagonal) gate on one of them couples amplitudes on different shards.
The whole circuit is known at compile time, so layout is a planning
problem:

- a logical->physical permutation is tracked through the program; gates
  are rewritten to their physical positions and run wherever their qubits
  live;
- when a paired gate targets a sharded position, the planner emits ONE
  relayout that pulls every sharded qubit the next ``lookahead`` gates
  need into local positions, evicting the local qubits whose next paired
  use is farthest away (Belady's rule);
- diagonal gates never pair amplitudes and run at any position;
- one final relayout restores the identity permutation.

With a ``cost_model`` (:class:`quest_tpu_torch.profiling.CommCostModel`)
the planner prices every movement in modeled seconds: an uncontrolled
static SWAP is absorbed into the permutation, a lone sharded 1q gate rides
the role-split pair exchange (an ``("xshard", ...)`` item) when that is
cheaper than the localise+restore pair, and adjacent relayouts compose
into one exchange when the composition is no slower. ``host_bits > 0``
prices the top device positions at the inter-host tier and re-pairs
evicted qubits so the coldest takes the most-inter-host slot.

How the items move data is :mod:`quest_tpu_torch.parallel.exchange`.

:func:`choose_mxu_contraction` keeps the JAX package's decision rule (pick
the packed ``rowmxu`` contraction only when its modeled time is no worse
than the row path's) with the H100's rates in place of the TPU's: the
packed product runs on the CUDA cores at full precision and on the bf16
tensor cores at the FAST tier.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["LayoutPlan", "plan_layout", "apply_relayout", "is_swap_op",
           "plan_comm_stats", "relayout_comm", "relayout_comm_tiered",
           "reorder_plan_score", "choose_batch_sharding",
           "permute_positions", "choose_mxu_contraction", "MXU_ROW_CAP",
           "HBM_BYTES_PER_S", "CUDA_CORE_FLOPS", "BF16_TENSOR_FLOPS"]

_SWAP_MAT = np.array([[1, 0, 0, 0], [0, 0, 1, 0],
                      [0, 1, 0, 0], [0, 0, 0, 1]], dtype=np.complex128)


def is_swap_op(op) -> bool:
    """True for a static, uncontrolled 2-qubit SWAP gate — the ops the
    communication-aware planner absorbs into the layout permutation."""
    return (getattr(op, "kind", None) == "u"
            and getattr(op, "mat", None) is not None
            and getattr(op, "mat_fn", None) is None
            and op.ctrl_mask == 0 and len(op.targets) == 2
            and op.mat.shape == (4, 4)
            and bool(np.abs(op.mat - _SWAP_MAT).max() <= 1e-12))


@dataclasses.dataclass
class LayoutPlan:
    """The scheduled program: items are either

    - ``("op", op_index, phys_targets, phys_ctrl_mask, phys_flip_mask,
       diag_axis_order)`` — run op ``op_index`` at physical positions;
    - ``("relayout", perm_before, perm_after)`` — transpose the state so the
      qubit at physical position ``perm_before[l]`` moves to
      ``perm_after[l]`` for each logical qubit ``l``;
    - ``("xshard", op_index, (phys_position,), phys_ctrl_mask,
       phys_flip_mask, None)`` — run 1q op ``op_index`` on a device-index
      bit via the role-split pair exchange (communication-aware mode
      only; ``parallel/exchange.py:apply_1q_cross_shard``).
    """
    items: list
    num_qubits: int
    shard_bits: int
    num_relayouts: int
    num_xshard: int = 0          # cross-shard 1q pair-exchange items
    swaps_absorbed: int = 0      # SWAP gates folded into the permutation
    collectives_fused: int = 0   # relayout pairs merged into one exchange

    @property
    def num_kernels(self) -> int:
        """Op kernels the plan dispatches per execution. With the
        gate-fusion pass on (core/fusion.py) each op item is a fused
        GROUP, so this — not the recorded gate count — is the unit the
        planner batches relayouts against (and what
        ``CompiledCircuit.dispatch_stats`` reports as kernels_out)."""
        return sum(1 for it in self.items if it[0] == "op")

    @property
    def num_dispatches(self) -> int:
        """Kernels plus relayout/pair exchanges — total device dispatches."""
        return self.num_kernels + self.num_relayouts + self.num_xshard


def _phys_diag_order(op_targets_desc_logical: tuple[int, ...],
                     perm: np.ndarray):
    """Map a diag op's sorted-desc logical qubits to physical positions and
    the axis order its tensor must be transposed by.

    Returns (phys_sorted_desc, axes) where ``axes[i]`` is the index into the
    op's stored (logical-sorted-desc) tensor axes for the i-th physical-desc
    axis.
    """
    phys = tuple(int(perm[q]) for q in op_targets_desc_logical)
    order = tuple(np.argsort(phys)[::-1])  # positions sorted desc
    phys_desc = tuple(phys[i] for i in order)
    return phys_desc, order


def plan_layout(ops: Sequence, num_qubits: int, shard_bits: int = 0,
                lookahead: int = 32, cost_model=None,
                chunk_bytes: float = 0.0, host_bits: int = 0,
                reorder: bool = True) -> LayoutPlan:
    """Schedule ``ops`` (quest_tpu_torch.circuits._Op sequence) over a mesh
    that
    shards the top ``shard_bits`` physical positions.

    Paired ("u") ops must have all targets below ``num_qubits - shard_bits``;
    the planner guarantees it by emitting relayouts. Controls and diagonal
    ops are position-indifferent.

    The op stream is whatever the compile pipeline hands over — after the
    gate-fusion pass (core/fusion.py) each op is a fused GROUP, so
    relayout decisions (and the ``lookahead`` window) are group-granular:
    one all-to-all serves every source gate inside the groups it
    localises.

    ``cost_model`` (a :class:`quest_tpu_torch.profiling.CommCostModel`) switches
    on the communication-aware mode (see module docstring): SWAP
    absorption, cross-shard 1q pair-exchange items, and collective
    composition, each priced in modeled seconds against ``chunk_bytes``
    (the per-device chunk payload; defaults to 16 B/amplitude when not
    given). ``cost_model=None`` reproduces the count-based planner
    bit-for-bit.

    ``host_bits`` marks the top device positions as inter-host (two-tier
    pricing; see module docstring) and ``reorder`` enables the
    hot-qubit-local eviction re-pairing on that mesh shape — both inert
    at ``host_bits=0``.
    """
    n = num_qubits
    local_top = n - shard_bits  # phys positions >= local_top are sharded
    comm_aware = cost_model is not None and shard_bits > 0
    host_bits = max(0, min(int(host_bits), shard_bits)) if comm_aware else 0
    inter_lo = n - host_bits          # positions >= inter_lo cross hosts
    reorder_on = comm_aware and host_bits > 0 and reorder
    if comm_aware and chunk_bytes <= 0.0:
        chunk_bytes = 16.0 * (1 << local_top)
    if shard_bits == 0:
        items = []
        ident = np.arange(n)
        for i, op in enumerate(ops):
            items.append(_op_item(i, op, ident))
        return LayoutPlan(items, n, 0, 0)

    absorbable = [comm_aware and is_swap_op(op) for op in ops]

    max_k = max((len(op.targets) for i, op in enumerate(ops)
                 if op.kind == "u" and not absorbable[i]), default=0)
    if max_k > local_top:
        raise ValueError(
            f"a {max_k}-qubit unitary cannot be localised with "
            f"{local_top} local qubit positions "
            f"(2^{max_k} amplitudes per gather > local shard)")

    def used_qubits(op) -> tuple[int, ...]:
        """Qubits a paired op needs local: its targets only. Controls are
        position-free — the executor turns a control on a device-index bit
        into a per-shard skip (zero communication;
        ``parallel/exchange.py:apply_op_local``), the distributed
        control-skip of ``QuEST_cpu_distributed.c:888-908``."""
        if op.kind != "u":
            return ()
        return op.targets

    # next use index (as a target of a paired op) per logical qubit;
    # absorbed SWAPs never demand locality, so they are not uses
    INF = len(ops) + 1
    next_use = np.full((len(ops) + 1, n), INF, dtype=np.int64)
    for i in range(len(ops) - 1, -1, -1):
        next_use[i] = next_use[i + 1]
        if not absorbable[i]:
            for q in used_qubits(ops[i]):
                next_use[i, q] = i

    # upcoming-use counts (the reordering pass's hotness metric,
    # mpiQulacs §IV): rem_uses[i, q] = paired uses of q at ops >= i
    rem_uses = None
    if reorder_on:
        rem_uses = np.zeros((len(ops) + 1, n), dtype=np.int64)
        for i in range(len(ops) - 1, -1, -1):
            rem_uses[i] = rem_uses[i + 1]
            if not absorbable[i]:
                for q in used_qubits(ops[i]):
                    rem_uses[i, q] += 1

    perm = np.arange(n)  # perm[logical] = physical
    items: list = []
    n_relayouts = 0
    n_xshard = 0
    n_absorbed = 0

    for i, op in enumerate(ops):
        if absorbable[i]:
            # SWAP = pure relabeling: exchange the two physical positions
            # in the bookkeeping, move zero amplitudes. The data movement
            # (if any is ever needed) rides the next planned relayout.
            a, b = op.targets
            perm[a], perm[b] = perm[b], perm[a]
            n_absorbed += 1
            continue
        used = used_qubits(op)
        if (comm_aware and op.kind == "u" and len(op.targets) == 1
                and perm[op.targets[0]] >= local_top):
            # lone sharded 1q gate: one whole-chunk ppermute (role-split
            # combine) vs the localise+restore relayout pair it would
            # otherwise cost. Worth it only when this gate is the SOLE
            # sharded demand inside the lookahead window — any other
            # sharded use there means a relayout is coming anyway and
            # amortizes over everything the window prefetches, making the
            # marginal cost of localising this qubit ~chunk/2^(k+1)
            # instead of a whole-chunk ppermute.
            t = op.targets[0]
            wend = min(i + lookahead, len(ops))
            sole = True
            # scan under a SCRATCH perm that applies the window's
            # absorbed SWAPs as they pass: a later gate's locality is
            # decided by where its label will sit THEN, not now
            wp = perm.copy()
            for j in range(i, wend):
                if absorbable[j]:
                    a2, b2 = ops[j].targets
                    wp[a2], wp[b2] = wp[b2], wp[a2]
                    continue
                for q in used_qubits(ops[j]):
                    if wp[q] >= local_top and (j != i or q != t):
                        sole = False
                        break
                if not sole:
                    break
            # both candidates ride the same device bit, so both price at
            # that bit's tier (inter when the position crosses hosts)
            x_inter = host_bits > 0 and int(perm[t]) >= inter_lo
            if (sole and cost_model.ppermute_seconds(chunk_bytes,
                                                     inter=x_inter)
                    <= 2.0 * cost_model.all_to_all_seconds(
                        chunk_bytes, 1, inter=x_inter)):
                cm, fm = _phys_masks_of(op, perm)
                items.append(("xshard", i, (int(perm[t]),), cm, fm, None))
                n_xshard += 1
                continue
        if used and any(perm[q] >= local_top for q in used):
            # everything this op needs now (its sharded targets)
            need_now = [t for t in op.targets if perm[t] >= local_top]
            # plus sharded DATA used in the lookahead window (prefetch).
            # The scan runs under a scratch perm that applies absorbed
            # SWAPs as they pass: a gate at j needs its label local THEN,
            # and the data serving it is whatever CURRENT label occupies
            # that future position (inv[wp[q]]) — with no absorbable ops
            # this reduces exactly to the label itself with serving index
            # next_use[i, q], i.e. the legacy scan bit-for-bit.
            window_hot = []               # (current label, serving index)
            wp = perm.copy()
            inv = np.empty(n, dtype=np.int64)
            inv[perm] = np.arange(n)
            seen = set(need_now)
            for j in range(i, min(i + lookahead, len(ops))):
                if absorbable[j]:
                    a2, b2 = ops[j].targets
                    wp[a2], wp[b2] = wp[b2], wp[a2]
                    continue
                for q in used_qubits(ops[j]):
                    if wp[q] >= local_top:
                        hot = int(inv[wp[q]])
                        if hot not in seen:
                            window_hot.append((hot, j))
                            seen.add(hot)
            # victims: local positions not used by this op, farthest next
            # use first (Belady)
            locals_ = [(int(next_use[i, l]), l)
                       for l in range(n)
                       if perm[l] < local_top and l not in used]
            locals_.sort(reverse=True)
            need_set = set(need_now)
            new_perm = perm.copy()
            pairs_sel = []       # (incoming qubit, victim) in stage order
            for q, nu_q in [(q, -1) for q in need_now] + window_hot:
                if len(pairs_sel) >= len(locals_):
                    break
                nu_victim, victim = locals_[len(pairs_sel)]
                # window prefetches must not evict a sooner-used qubit
                if q not in need_set and nu_q >= nu_victim:
                    continue
                pairs_sel.append((q, victim))
            # device-slot assignment for the evicted victims: by default
            # victim i takes the slot its incoming qubit vacates; the
            # hot-qubit reordering pass re-pairs so the COLDEST victim
            # (fewest remaining paired uses, then farthest next use)
            # takes the most-inter-host slot — zero extra bytes, and the
            # soonest-returning qubits stay off the DCN tier
            vacated = [int(perm[q]) for q, _ in pairs_sel]
            dest = {v: s for (_, v), s in zip(pairs_sel, vacated)}
            if reorder_on and len(pairs_sel) > 1:
                cold_first = sorted(
                    (v for _, v in pairs_sel),
                    key=lambda v: (int(rem_uses[i, v]),
                                   -int(next_use[i, v]), v))
                dest = dict(zip(cold_first, sorted(vacated, reverse=True)))
            for vi, (q, victim) in enumerate(pairs_sel):
                # three-way rotation landing the incoming qubit at a TOP
                # local position (the all_to_all staging slot,
                # parallel/exchange.py): q -> stage, the qubit at stage ->
                # the victim's slot, victim -> its assigned device
                # position. Landing at the staging slot makes the
                # exchange's post-transpose vanish — one local pass per
                # relayout instead of two.
                stage = local_top - 1 - vi
                x = int(np.nonzero(new_perm == stage)[0][0])
                vic_pos = new_perm[victim]
                new_perm[q] = stage
                if x != victim:
                    new_perm[x] = vic_pos
                new_perm[victim] = dest[victim]
            items.append(("relayout", perm.copy(), new_perm.copy()))
            n_relayouts += 1
            perm = new_perm
        items.append(_op_item(i, op, perm))

    if not np.array_equal(perm, np.arange(n)):
        items.append(("relayout", perm.copy(), np.arange(n)))
        n_relayouts += 1

    n_fused = 0
    if comm_aware:
        items, n_merged, n_dropped = _compose_relayouts(
            items, n, local_top, cost_model, chunk_bytes,
            host_bits=host_bits)
        n_relayouts -= n_dropped
        n_fused = n_merged

    return LayoutPlan(items, n, shard_bits, n_relayouts,
                      num_xshard=n_xshard, swaps_absorbed=n_absorbed,
                      collectives_fused=n_fused)


def _phys_masks_of(op, perm: np.ndarray) -> tuple[int, int]:
    ctrl_mask = 0
    flip_mask = 0
    m = op.ctrl_mask
    q = 0
    while m:
        if m & 1:
            ctrl_mask |= 1 << int(perm[q])
            if (op.flip_mask >> q) & 1:
                flip_mask |= 1 << int(perm[q])
        m >>= 1
        q += 1
    return ctrl_mask, flip_mask


def _op_item(i: int, op, perm: np.ndarray):
    if op.kind == "u":
        phys_targets = tuple(int(perm[t]) for t in op.targets)
        ctrl_mask, flip_mask = _phys_masks_of(op, perm)
        return ("op", i, phys_targets, ctrl_mask, flip_mask, None)
    phys_desc, axis_order = _phys_diag_order(op.targets, perm)
    return ("op", i, phys_desc, 0, 0, axis_order)


def permute_positions(x: torch.Tensor, num_bits: int,
                      pos_map) -> torch.Tensor:
    """Move amplitude-index bit ``p`` to bit ``pos_map[p]`` along the last
    axis (``2^num_bits`` long) of ``x``, leading axes kept: one transpose,
    returned as a new contiguous tensor (``x`` itself when ``pos_map`` is
    the identity). Runs of bits that move together are one axis of the
    view, so a relayout of a few bits is a transpose of a few axes whatever
    ``num_bits`` is."""
    n = int(num_bits)
    inv = [0] * n
    for p, q in enumerate(pos_map):
        inv[int(q)] = p
    if inv == list(range(n)):
        return x
    # input axis (high bit first) feeding each output axis
    src_axes = [n - 1 - inv[n - 1 - b] for b in range(n)]
    groups: list = []
    for a in src_axes:
        if groups and groups[-1][0] + groups[-1][1] == a:
            groups[-1][1] += 1
        else:
            groups.append([a, 1])
    order_in = sorted(range(len(groups)), key=lambda g: groups[g][0])
    rank = {g: i for i, g in enumerate(order_in)}
    lead = tuple(x.shape[:-1])
    nl = len(lead)
    y = x.reshape(*lead, *[1 << groups[g][1] for g in order_in])
    y = y.permute(*range(nl), *[nl + rank[g] for g in range(len(groups))])
    return y.reshape(*lead, -1)


def apply_relayout(state: torch.Tensor, num_qubits: int,
                   perm_before: np.ndarray,
                   perm_after: np.ndarray) -> torch.Tensor:
    """Move the qubit at physical position ``perm_before[l]`` to
    ``perm_after[l]`` on whole ``(..., 2^n)`` planes: one transpose. On a
    mesh the same movement is :func:`quest_tpu_torch.parallel.exchange.
    run_exchange` over the shards' chunks."""
    pos_map = [0] * num_qubits
    for b, a in zip(perm_before, perm_after):
        pos_map[int(b)] = int(a)
    return permute_positions(state, num_qubits, pos_map)


# ---------------------------------------------------------------------------
# communication accounting + collective composition (cost-aware mode)
# ---------------------------------------------------------------------------

def _relayout_sigma(perm_before, perm_after, n: int) -> np.ndarray:
    """The physical permutation a relayout realizes: position
    ``perm_before[l]`` moves to ``perm_after[l]``."""
    sigma = np.empty(n, dtype=np.int64)
    for b, a in zip(perm_before, perm_after):
        sigma[int(b)] = int(a)
    return sigma


def relayout_comm_tiered(sigma: np.ndarray, local_top: int,
                         chunk_bytes: float, cost_model,
                         host_bits: int = 0) -> dict:
    """Full two-tier accounting for one relayout realizing physical
    permutation ``sigma``, under the closed-form choreography of
    :func:`quest_tpu_torch.parallel.exchange.plan_exchange`: one ``all_to_all``
    over the ``k`` exchanged bits plus a whole-chunk ``ppermute`` iff a
    residual device-bit permutation remains (a staying device bit moves,
    or an exchanged bit cannot land in its destined slot —
    ``sigma(sigma(p))`` still a device bit).

    A collective crosses hosts — inter tier — when it involves any of
    the top ``host_bits`` device positions: the ``all_to_all`` iff an
    exchanged device slot is inter-host; the residual ``ppermute``
    (conservatively) iff ANY inter-host slot participates in the
    relayout at all. Returns ``{"seconds", "bytes", "inter_bytes",
    "launches", "inter_launches"}`` (per-device bytes)."""
    n = len(sigma)
    lt = local_top
    inter_lo = n - max(0, min(host_bits, n - lt))
    A = [p for p in range(lt) if sigma[p] >= lt]
    k = len(A)
    xbits = [p for p in range(lt, n) if sigma[p] < lt]
    residual = any(sigma[d] != d and sigma[d] >= lt
                   for d in range(lt, n) if sigma[d] >= lt) \
        or any(sigma[sigma[p]] >= lt for p in A)
    a2a_inter = host_bits > 0 and any(p >= inter_lo for p in xbits)
    res_inter = host_bits > 0 and any(
        sigma[p] != p for p in range(inter_lo, n))
    seconds = nbytes = inter_bytes = 0.0
    launches = inter_launches = 0
    if k:
        seconds += cost_model.all_to_all_seconds(chunk_bytes, k,
                                                 inter=a2a_inter)
        b = cost_model.all_to_all_bytes(chunk_bytes, k)
        nbytes += b
        launches += 1
        if a2a_inter:
            inter_bytes += b
            inter_launches += 1
    if residual:
        seconds += cost_model.ppermute_seconds(chunk_bytes,
                                               inter=res_inter)
        b = cost_model.ppermute_bytes(chunk_bytes)
        nbytes += b
        launches += 1
        if res_inter:
            inter_bytes += b
            inter_launches += 1
    return {"seconds": seconds, "bytes": nbytes,
            "inter_bytes": inter_bytes, "launches": launches,
            "inter_launches": inter_launches}


def reorder_plan_score(plan, chunk_bytes: float, cost_model,
                       host_bits: int) -> tuple:
    """The best-of-both reorder selection's ordering key for one plan:
    (modeled comm seconds, inter-host bytes, collective launches) —
    shared by ``circuits._schedule`` and the post-supergate replan so
    the 'reorder=True never models slower' invariant holds on every
    path."""
    s = plan_comm_stats(plan, chunk_bytes, cost_model,
                        host_bits=host_bits)
    return (s["seconds"], s["inter_bytes"], s["launches"])


def relayout_comm(sigma: np.ndarray, local_top: int,
                  chunk_bytes: float, cost_model,
                  host_bits: int = 0) -> tuple[float, float, int]:
    """(seconds, per-device bytes, collective launches) for one relayout
    — the single-total view of :func:`relayout_comm_tiered`."""
    t = relayout_comm_tiered(sigma, local_top, chunk_bytes, cost_model,
                             host_bits=host_bits)
    return t["seconds"], t["bytes"], t["launches"]


def _remap_mask(mask: int, delta: np.ndarray) -> int:
    out = 0
    p = 0
    while mask:
        if mask & 1:
            out |= 1 << int(delta[p])
        mask >>= 1
        p += 1
    return out


def _remap_item(item, delta: np.ndarray):
    """Rewrite an op/xshard item's physical coordinates through the
    physical permutation ``delta`` (applied early by a composed
    relayout)."""
    kind, i, phys, cm, fm, axis_order = item
    if kind == "xshard" or axis_order is None:
        new_phys = tuple(int(delta[p]) for p in phys)
        return (kind, i, new_phys, _remap_mask(cm, delta),
                _remap_mask(fm, delta), axis_order)
    # diagonal: remap positions, re-sort descending, compose axis order
    pairs = sorted(((int(delta[p]), ao) for p, ao in zip(phys, axis_order)),
                   reverse=True)
    return (kind, i, tuple(p for p, _ in pairs), 0, 0,
            tuple(ao for _, ao in pairs))


def _compose_relayouts(items: list, n: int, local_top: int,
                       cost_model, chunk_bytes: float,
                       host_bits: int = 0):
    """Merge adjacent relayouts: for each consecutive pair (R1, R2), R2's
    permutation ``delta`` is applied early (composed into R1) when every
    item between stays executable under ``delta`` — dense targets stay
    chunk-local, pair-exchange positions stay device bits, diagonals run
    anywhere — and the composed collective is modeled no slower than the
    pair (each leg priced at its interconnect tier when ``host_bits``
    marks inter-host positions: merging two intra exchanges into one
    host-crossing exchange must pay its way at DCN prices). A
    composition that cancels to the identity drops the relayout
    entirely. Returns ``(items, merges, relayouts_removed)``."""
    merges = 0
    removed = 0
    changed = True
    while changed:
        changed = False
        idxs = [j for j, it in enumerate(items) if it[0] == "relayout"]
        for a, b in zip(idxs, idxs[1:]):
            delta = _relayout_sigma(items[b][1], items[b][2], n)
            ok = True
            for j in range(a + 1, b):
                it = items[j]
                if it[0] == "op":
                    if it[5] is None and any(int(delta[p]) >= local_top
                                             for p in it[2]):
                        ok = False
                        break
                elif it[0] == "xshard":
                    if int(delta[it[2][0]]) < local_top:
                        ok = False
                        break
                else:               # unexpected item kind: leave untouched
                    ok = False
                    break
            if not ok:
                continue
            before = np.asarray(items[a][1], dtype=np.int64)
            after = np.asarray(items[a][2], dtype=np.int64)
            new_after = np.array([int(delta[p]) for p in after],
                                 dtype=np.int64)
            s1 = _relayout_sigma(before, after, n)
            sc = _relayout_sigma(before, new_after, n)
            c1 = relayout_comm(s1, local_top, chunk_bytes, cost_model,
                               host_bits)[0]
            c2 = relayout_comm(delta, local_top, chunk_bytes, cost_model,
                               host_bits)[0]
            cc = relayout_comm(sc, local_top, chunk_bytes, cost_model,
                               host_bits)[0]
            if cc > c1 + c2:
                continue
            mid = [_remap_item(items[j], delta) for j in range(a + 1, b)]
            if np.array_equal(before, new_after):
                head = []           # composition cancelled: pure identity
                removed += 2
            else:
                head = [("relayout", before, new_after)]
                removed += 1
            items = items[:a] + head + mid + items[b + 1:]
            merges += 1
            changed = True
            break
    return items, merges, removed


def plan_comm_stats(plan: LayoutPlan, chunk_bytes: float, cost_model,
                    num_devices: Optional[int] = None,
                    host_bits: int = 0) -> dict:
    """Modeled communication totals for a plan: per-execution collective
    bytes (mesh-total when ``num_devices`` given, else per-device),
    modeled seconds, collective launch count, and — under a two-tier
    mesh (``host_bits > 0``) — the inter-host share of both bytes and
    launches (the reordering pass's primary observable)."""
    if plan.shard_bits == 0:
        return {"bytes": 0.0, "seconds": 0.0, "launches": 0,
                "inter_bytes": 0.0, "inter_launches": 0}
    n = plan.num_qubits
    lt = n - plan.shard_bits
    host_bits = max(0, min(host_bits, plan.shard_bits))
    inter_lo = n - host_bits
    total_b = total_s = inter_b = 0.0
    launches = inter_launches = 0
    for it in plan.items:
        if it[0] == "relayout":
            sigma = _relayout_sigma(it[1], it[2], n)
            t = relayout_comm_tiered(sigma, lt, chunk_bytes, cost_model,
                                     host_bits=host_bits)
            total_s += t["seconds"]
            total_b += t["bytes"]
            inter_b += t["inter_bytes"]
            launches += t["launches"]
            inter_launches += t["inter_launches"]
        elif it[0] == "xshard":
            x_inter = host_bits > 0 and int(it[2][0]) >= inter_lo
            total_s += cost_model.ppermute_seconds(chunk_bytes,
                                                   inter=x_inter)
            b = cost_model.ppermute_bytes(chunk_bytes)
            total_b += b
            launches += 1
            if x_inter:
                inter_b += b
                inter_launches += 1
    scale = num_devices if num_devices else 1
    return {"bytes": total_b * scale, "seconds": total_s,
            "launches": launches, "inter_bytes": inter_b * scale,
            "inter_launches": inter_launches}


# Per-device working-set budget for the batch-parallel mode's feasibility
# check (overridable via QUEST_TPU_BATCH_MEM_BYTES). The JAX package's
# 2 GiB floor, kept so both packages choose the same mode for the same
# sweep; it sits far inside an H100's 80 GB.
DEFAULT_BATCH_MEM_BYTES = 2 << 30


def choose_batch_sharding(num_qubits: int, batch: int, num_devices: int,
                          itemsize: int, num_relayouts: int,
                          cost_model=None,
                          mem_limit_bytes: Optional[int] = None,
                          host_bits: int = 0,
                          mem_factor: float = 1.0) -> dict:
    """Pick the batched ensemble engine's sharding axis on a mesh.

    An ensemble of ``batch`` independent states can shard the BATCH axis
    (each device runs whole states, zero collectives) or the AMPLITUDE
    axis (each state spans the mesh, every planned relayout becomes a
    real collective — per batch element). The two modes do identical
    arithmetic, so the decision is priced entirely in memory and modeled
    collective seconds (:class:`quest_tpu_torch.profiling.CommCostModel`):

    - batch-parallel needs ``ceil(batch/D) * 2 * state_bytes`` resident
      per device (input + output planes; the factor 2 is headroom for
      the engine's temporaries) and spends 0 s on the wire;
    - amplitude-sharded needs only ``2 * state_bytes / D`` per device but
      pays ``batch * num_relayouts`` all-to-all exchanges of the
      ``state_bytes / D`` chunk.

    Modeled comm time of the amp mode is >= 0 always, so batch-parallel
    wins WHENEVER IT FITS — the crossover is the per-device memory wall,
    and the cost model quantifies what crossing it costs (the returned
    ``amp_comm_seconds``).

    ``host_bits > 0`` (the mesh spans controller processes): the amp
    mode's relayout all-to-alls span the whole mesh — host boundary
    included — so they price at the cost model's INTER tier; the batch
    mode keeps whole states per device and stays collective-free even
    when the batch axis spans processes.

    ``mem_factor`` scales the batch-parallel mode's per-device working
    set for executables that hold more than the forward pass's two
    plane sets: reverse-mode GRADIENT sweeps
    (:meth:`~quest_tpu_torch.circuits.CompiledCircuit.value_and_grad_sweep`)
    keep the primal state and the cotangent live simultaneously
    through the backward walk, so they price at ``mem_factor=2.0`` —
    the crossover to amplitude sharding arrives one batch doubling
    earlier than the forward sweep's, never later.

    Returns ``{"mode": "none"|"batch"|"amp", "amp_comm_seconds": float,
    "per_device_bytes": float}``.
    """
    if num_devices <= 1 or batch < 1:
        return {"mode": "none", "amp_comm_seconds": 0.0,
                "per_device_bytes": 2.0 * itemsize * (1 << num_qubits)}
    if mem_limit_bytes is None:
        mem_limit_bytes = int(os.environ.get("QUEST_TPU_BATCH_MEM_BYTES",
                                             DEFAULT_BATCH_MEM_BYTES))
    if cost_model is None:
        from ..profiling import DEFAULT_COMM_MODEL
        cost_model = DEFAULT_COMM_MODEL
    state_bytes = 2.0 * itemsize * (1 << num_qubits)    # split re/im planes
    shard_bits = max(num_devices.bit_length() - 1, 1)
    per_dev_batch = -(-batch // num_devices)
    batch_mode_bytes = per_dev_batch * 2.0 * state_bytes \
        * max(float(mem_factor), 1.0)
    amp_comm = (batch * num_relayouts
                * cost_model.all_to_all_seconds(state_bytes / num_devices,
                                                shard_bits,
                                                inter=host_bits > 0))
    if batch_mode_bytes <= mem_limit_bytes:
        return {"mode": "batch", "amp_comm_seconds": amp_comm,
                "per_device_bytes": batch_mode_bytes}
    return {"mode": "amp", "amp_comm_seconds": amp_comm,
            "per_device_bytes": 2.0 * state_bytes / num_devices}




# ---------------------------------------------------------------------------
# dense-contraction crossover (the rowmxu selection rule)
# ---------------------------------------------------------------------------

# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3; 67 TFLOP/s float32 and
# 34 TFLOP/s float64 on the CUDA cores; 989 TFLOP/s dense bf16 on the
# tensor cores. At full precision the layer kernel runs every stage — the
# packed rowmxu product included — as FMA loops on the CUDA cores, so both
# sides of the crossover take the CUDA-core rate of the plane dtype. At
# the FAST tier the dense stages run on the bf16 tensor cores, and the
# packed side takes that rate.
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_FLOPS = {4: 67.0e12, 8: 34.0e12}
BF16_TENSOR_FLOPS = 989.0e12

# Row-bit budget for one packed contraction: j row bits pack with the
# 128-lane axis into a (2^j * 128)-dim operator, 512 x 512 at the cap.
MXU_ROW_CAP = 2


def choose_mxu_contraction(num_row_bits: int, gate_qubits: int,
                           itemsize: int = 4,
                           force: Optional[bool] = None,
                           fast: bool = False) -> dict:
    """The modeled flops-vs-bytes crossover for ONE dense gate inside a
    fused layer: the packed ``rowmxu`` contraction (``8 * 2^j * 128`` real
    flops per amplitude, at the bf16 tensor-core rate when ``fast`` — the
    FAST tier — else at the CUDA-core rate) against the ``row``/``rowk``
    path (``8 * 2^gate_qubits`` at the CUDA-core rate). Both stream the
    state once, so each side's time is ``max(flop_time, memory_time)``,
    and the packed form wins only when it is no slower. ``force`` pins the
    decision (tests); None lets the model decide.

    Returns ``{"use_mxu", "mxu_seconds", "alt_seconds", "mem_seconds",
    "source"}`` in modeled seconds per amplitude.
    """
    # one pass over split re/im planes: read + write, 4 * itemsize/amp
    mem_s = 4.0 * itemsize / HBM_BYTES_PER_S
    rate = CUDA_CORE_FLOPS[itemsize]
    dim = (1 << max(int(num_row_bits), 0)) * 128
    mxu_s = max(8.0 * dim / (BF16_TENSOR_FLOPS if fast else rate), mem_s)
    alt_s = max(8.0 * (1 << max(int(gate_qubits), 0)) / rate, mem_s)
    if force is None:
        use, source = mxu_s <= alt_s, "modeled"
    else:
        use, source = bool(force), "forced"
    return {"use_mxu": use, "mxu_seconds": mxu_s, "alt_seconds": alt_s,
            "mem_seconds": mem_s, "source": source}
