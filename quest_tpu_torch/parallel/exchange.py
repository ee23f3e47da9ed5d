"""Relayouts and cross-shard gates as explicit copies between shard chunks.

Counterpart of the JAX package's ``parallel/exchange.py``. The planner
(:mod:`quest_tpu_torch.parallel.layout`) schedules WHAT moves; this module
is HOW it moves, on a mesh driven by one process
(:mod:`quest_tpu_torch.parallel.mesh`): a register is a list of chunks,
chunk ``d`` the ``(..., 2, 2^(n-s))`` planes of shard ``d`` (a leading
batch axis is allowed everywhere), and every collective of the JAX
package's ``shard_map`` program becomes copies between shard tensors:

- a **relayout** (``k`` device-index bits trading places with ``k``
  chunk-local bits) is a local pre-transpose of each chunk, then the
  all-to-all over groups of ``2^k`` shards as pairwise block swaps (block
  ``j`` of member ``m`` trades places with block ``m`` of member ``j``;
  one block of scratch), then the residual device-bit permutation (a
  relabelling of the chunk list when every shard lies on one device, else
  a cycle of chunk copies through one chunk of scratch), then a local
  post-transpose. This is the reference's chunk-pair exchange
  (``exchangeStateVectors``, ``QuEST_cpu_distributed.c:478-506``)
  generalised to ``k`` bits;
- a **cross-shard 1q gate** is the reference's role-split combine
  (``statevec_compactUnitaryDistributed``, ``QuEST_cpu.c:1975-2016``):
  each pair ``(v, v ^ 2^j)`` combines slab by slab, the partner's slab
  copied beside this shard's;
- gates on chunk-local targets run on each chunk through the gate engine
  (``core/apply.py``) or the layer kernel; a control on a device bit is a
  per-shard skip (``QuEST_cpu_distributed.c:888-908``) and a diagonal
  factor indexed by device bits is sliced per shard.

No step holds more than one chunk of scratch beside the register.
:data:`COUNTS` counts exchanges, launches of each collective and the bytes
copied between shards; :func:`start_log` records each exchange's kind,
bytes and time (CUDA events on the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core.apply import apply_diagonal, apply_unitary, split_shape
from .layout import permute_positions

__all__ = ["ExchangePlan", "plan_exchange", "run_exchange",
           "apply_op_local", "apply_1q_cross_shard", "overlap_eligible",
           "run_exchange_overlapped", "slab_remap", "COUNTS",
           "reset_counts", "start_log", "stop_log"]

# exchanges run, collective launches and bytes copied between shards
COUNTS = {"relayouts": 0, "all_to_all": 0, "ppermute": 0, "xshard": 0,
          "overlapped": 0, "bytes": 0}
_LOG: Optional[list] = None

# amplitudes per slab of the cross-shard combine: its scratch stays two
# slabs whatever the chunk
_SLAB_AMPS = 1 << 22


def reset_counts() -> None:
    for key in COUNTS:
        COUNTS[key] = 0


def start_log() -> None:
    """Record every exchange from now on (kind, bits, bytes, time)."""
    global _LOG
    _LOG = []


def stop_log() -> list:
    """Stop recording; the records, each ``{"kind", "k", "bytes",
    "ms"}`` (device time between CUDA events on the card, host time on
    the CPU)."""
    global _LOG
    log, _LOG = _LOG or [], None
    out = []
    for rec in log:
        rec = dict(rec)
        t = rec.pop("_t")
        if isinstance(t, tuple):
            t[1].synchronize()
            rec["ms"] = float(t[0].elapsed_time(t[1]))
        else:
            rec["ms"] = t
        out.append(rec)
    return out


class _Timed:
    """Times one exchange into the log (no-op while the log is off)."""

    def __init__(self, chunks, kind: str, k: int = 0):
        self.on = _LOG is not None
        self.rec = {"kind": kind, "k": int(k), "bytes": 0}
        if not self.on:
            return
        dev = chunks[0].device
        if dev.type == "cuda":
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record(torch.cuda.current_stream(dev))
        else:
            self.t0 = time.perf_counter()
        self.dev = dev

    def add_bytes(self, nbytes: int) -> None:
        COUNTS["bytes"] += int(nbytes)
        self.rec["bytes"] += int(nbytes)

    def done(self) -> None:
        if not self.on:
            return
        if self.dev.type == "cuda":
            self.ev[1].record(torch.cuda.current_stream(self.dev))
            self.rec["_t"] = self.ev
        else:
            self.rec["_t"] = (time.perf_counter() - self.t0) * 1e3
        if _LOG is not None:
            _LOG.append(self.rec)


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Static choreography for one relayout on a ``2^s``-shard mesh."""
    local_top: int                      # n - s: positions below are local
    k: int                              # device<->local bits exchanged
    pre_map: Optional[tuple]            # local position map before
    groups: Optional[tuple]             # all-to-all shard groups
    device_perm: Optional[tuple]        # residual (src, dst) shard pairs
    post_map: Optional[tuple]           # local position map after


def _position_map(pos_map: np.ndarray) -> Optional[tuple]:
    """``pos_map`` as a tuple, None for the identity."""
    if np.array_equal(pos_map, np.arange(len(pos_map))):
        return None
    return tuple(int(p) for p in pos_map)


def plan_exchange(n: int, shard_bits: int,
                  perm_before: Sequence[int],
                  perm_after: Sequence[int]) -> ExchangePlan:
    """Decompose 'qubit at position perm_before[l] moves to perm_after[l]'
    into the local and cross-shard steps of :func:`run_exchange` (the JAX
    package's choreography, step for step)."""
    s = shard_bits
    lt = n - s
    sigma = np.empty(n, dtype=np.int64)
    for b, a in zip(perm_before, perm_after):
        sigma[int(b)] = int(a)

    A = [p for p in range(lt) if sigma[p] >= lt]          # local -> device
    B = [p for p in range(lt, n) if sigma[p] < lt]        # device -> local
    k = len(A)
    if len(B) != k:
        raise ValueError("malformed relayout permutation")

    # each outgoing local bit takes a vacated device slot, its destined
    # one when free (then no residual permutation remains)
    slots = list(B)
    assign: dict[int, int] = {}
    leftovers = []
    for a in A:
        if int(sigma[a]) in slots:
            assign[a] = int(sigma[a])
            slots.remove(int(sigma[a]))
        else:
            leftovers.append(a)
    for a, b in zip(leftovers, slots):
        assign[a] = b
    # pair order = ascending destination of the incoming bit: device bit
    # b_i lands on staging slot lt-k+i
    pairs = sorted(((b, a) for a, b in assign.items()),
                   key=lambda ba: int(sigma[ba[0]]))
    b_list = [b for b, _ in pairs]
    a_list = [a for _, a in pairs]

    # local pre-permutation: the outgoing bit of pair i goes to staging
    # position lt-k+i; staying locals go straight to their final position
    # when it is free
    psi = np.full(lt, -1, dtype=np.int64)
    taken = set()
    for i, a in enumerate(a_list):
        psi[a] = lt - k + i
        taken.add(lt - k + i)
    rest = [p for p in range(lt) if p not in a_list]
    deferred = []
    for p in rest:
        dest = int(sigma[p])
        if dest not in taken:
            psi[p] = dest
            taken.add(dest)
        else:
            deferred.append(p)
    free = [q for q in range(lt) if q not in taken]
    for p, q in zip(deferred, free):
        psi[p] = q
    pre_map = _position_map(psi)

    phi = np.empty(lt, dtype=np.int64)
    for i, b in enumerate(b_list):
        phi[lt - k + i] = sigma[b]
    for p in rest:
        phi[psi[p]] = sigma[p]
    post_map = _position_map(phi)

    groups = None
    if k:
        j_list = [b - lt for b in b_list]
        others = [j for j in range(s) if j not in j_list]
        gs = []
        for ov in range(1 << len(others)):
            base = 0
            for t, j in enumerate(others):
                if (ov >> t) & 1:
                    base |= 1 << j
            gs.append(tuple(
                base | sum(((m >> i) & 1) << j for i, j in enumerate(j_list))
                for m in range(1 << k)))
        groups = tuple(gs)

    mu = {b: int(sigma[a]) for b, a in zip(b_list, a_list)}
    for d in range(lt, n):
        if d not in mu:
            mu[d] = int(sigma[d])
    device_perm = None
    if any(p != q for p, q in mu.items()):
        pp = []
        for v in range(1 << s):
            w = 0
            for p, q in mu.items():
                if (v >> (p - lt)) & 1:
                    w |= 1 << (q - lt)
            pp.append((v, w))
        device_perm = tuple(pp)

    return ExchangePlan(lt, k, pre_map, groups, device_perm, post_map)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _transpose_chunks(chunks: list, lt: int, pos_map,
                      inplace: bool = False) -> None:
    """Apply a local position map to every chunk, one at a time (one chunk
    of scratch); ``inplace`` copies each result back into its chunk."""
    for d in range(len(chunks)):
        moved = permute_positions(chunks[d], lt, pos_map)
        if inplace:
            chunks[d].copy_(moved)
        else:
            chunks[d] = moved


def _blocks(chunk: torch.Tensor, k: int) -> torch.Tensor:
    """``(..., 2, 2^k, cols)`` view: block ``j`` holds the amplitudes
    whose top ``k`` local bits are ``j``."""
    return chunk.view(*chunk.shape[:-1], 1 << k, -1)


def _swap(a: torch.Tensor, b: torch.Tensor, timer: _Timed) -> None:
    tmp = a.clone()
    a.copy_(b)
    b.copy_(tmp)
    timer.add_bytes(2 * _nbytes(tmp))


def _all_to_all(views: list, groups, k: int, timer: _Timed) -> None:
    """The tiled all-to-all over each group of ``2^k`` shards on
    ``(..., 2, 2^k, cols)`` views: member ``m``'s block ``j`` trades
    places with member ``j``'s block ``m``."""
    for g in groups:
        for m in range(1 << k):
            for j in range(m + 1, 1 << k):
                _swap(views[g[m]][..., j, :], views[g[j]][..., m, :], timer)


def _ppermute(chunks: list, pairs, timer: _Timed,
              copy: Optional[bool] = None) -> None:
    """``new[dst] = old[src]`` for the ``(src, dst)`` pairs: a relabelling
    when every chunk lies on one device, else each cycle of the
    permutation copied through one chunk of scratch (``copy`` forces
    either)."""
    src_of = {int(dst): int(src) for src, dst in pairs}
    if copy is None:
        copy = len({c.device for c in chunks}) > 1
    if not copy:
        old = list(chunks)
        for d in range(len(chunks)):
            chunks[d] = old[src_of[d]]
        return
    seen = set()
    for start in range(len(chunks)):
        if start in seen or src_of[start] == start:
            continue
        cycle = [start]
        seen.add(start)
        d = src_of[start]
        while d != start:
            cycle.append(d)
            seen.add(d)
            d = src_of[d]
        # cycle[i] takes cycle[i+1]'s chunk
        buf = chunks[cycle[0]].clone()
        for i in range(len(cycle) - 1):
            chunks[cycle[i]].copy_(chunks[cycle[i + 1]])
            timer.add_bytes(_nbytes(buf))
        chunks[cycle[-1]].copy_(buf)
        timer.add_bytes(_nbytes(buf))


def run_exchange(chunks: list, plan: ExchangePlan,
                 inplace: bool = False) -> list:
    """Execute one relayout on the mesh register's chunks, IN PLACE on the
    list (its entries are replaced, or with ``inplace`` written back into
    the same tensors); returns it."""
    COUNTS["relayouts"] += 1
    lt = plan.local_top
    timer = _Timed(chunks, "relayout", plan.k)
    if plan.pre_map is not None:
        _transpose_chunks(chunks, lt, plan.pre_map, inplace)
    if plan.k:
        COUNTS["all_to_all"] += 1
        _all_to_all([_blocks(c, plan.k) for c in chunks], plan.groups,
                    plan.k, timer)
    if plan.device_perm is not None:
        COUNTS["ppermute"] += 1
        _ppermute(chunks, plan.device_perm, timer,
                  copy=True if inplace else None)
    if plan.post_map is not None:
        _transpose_chunks(chunks, lt, plan.post_map, inplace)
    timer.done()
    return chunks


def _on(operand, device: torch.device, cache: dict):
    """A tensor operand moved to ``device`` once per call."""
    if not isinstance(operand, torch.Tensor) or operand.device == device:
        return operand
    if device not in cache:
        cache[device] = operand.to(device)
    return cache[device]


def apply_op_local(chunks: list, kind: str, operand, phys_targets: tuple,
                   ctrl_mask: int, flip_mask: int, local_top: int,
                   precision=None, shard_ids: Optional[Sequence[int]] = None
                   ) -> list:
    """Apply one planned op to every chunk, IN PLACE.

    Dense targets must be chunk-local (< local_top); the planner
    guarantees it. A control on a device bit skips the shards whose index
    does not match; a diagonal's device-bit axes (its leading axes, the
    positions being sorted descending) are indexed with each shard's bits.
    ``operand`` is numpy or a tensor, shared or one per batch row.
    ``shard_ids[i]`` is the shard index ``chunks[i]`` stands for (default
    ``i``)."""
    lt = local_top
    ids = range(len(chunks)) if shard_ids is None else shard_ids
    moved: dict = {}
    if kind == "u":
        dev_c = ctrl_mask >> lt
        want = dev_c & ~(flip_mask >> lt)
        loc_c = ctrl_mask & ((1 << lt) - 1)
        loc_f = flip_mask & ((1 << lt) - 1)
        for c, d in zip(chunks, ids):
            if dev_c and (d & dev_c) != want:
                continue
            apply_unitary(c, lt, _on(operand, c.device, moved),
                          phys_targets, loc_c, loc_f, precision=precision)
        return chunks
    dev_pos = tuple(p for p in phys_targets if p >= lt)
    loc_pos = tuple(p for p in phys_targets if p < lt)
    for c, d in zip(chunks, ids):
        op = _on(operand, c.device, moved)
        if dev_pos:
            lead = op.ndim - len(phys_targets)
            sel = tuple((d >> (p - lt)) & 1 for p in dev_pos)
            op = op[(slice(None),) * lead + sel]
        apply_diagonal(c, lt, loc_pos, op)
    return chunks


def _combine_pair(a: torch.Tensor, b: torch.Tensor, u, lt: int,
                  loc_c: int, loc_f: int, precision, timer) -> None:
    """``(a, b) <- U (a, b)`` where ``a`` holds role bit 0 and ``b`` role
    bit 1 of the target, both ``(..., 2, 2^lt)``, restricted to the local
    control pattern. Slab by slab: the two slabs side by side are a
    register of one more qubit, on which U acts on the top bit."""
    S = min(1 << lt, _SLAB_AMPS)
    sb = S.bit_length() - 1
    hi_c, hi_f = loc_c >> sb, loc_f >> sb
    hi_want = hi_c & ~hi_f
    lo_c, lo_f = loc_c & (S - 1), loc_f & (S - 1)
    for r in range((1 << lt) // S):
        if hi_c and (r & hi_c) != hi_want:
            continue
        sa = a[..., r * S:(r + 1) * S]
        sbv = b[..., r * S:(r + 1) * S]
        # the partner's slab crosses over and its new values go back
        x = torch.cat([sa, sbv.to(a.device)], dim=-1)
        timer.add_bytes(2 * _nbytes(sbv))
        apply_unitary(x, sb + 1, u, (sb,), lo_c, lo_f, precision=precision)
        sa.copy_(x[..., :S])
        sbv.copy_(x[..., S:])


def apply_1q_cross_shard(chunks: list, u, position: int, local_top: int,
                         shard_bits: int, ctrl_mask: int = 0,
                         flip_mask: int = 0, precision=None) -> list:
    """Role-split pair exchange for a 1q gate on a device-index bit, IN
    PLACE: for each pair of shards ``(v, v ^ 2^j)`` (``v`` with bit ``j``
    clear holds role 0), the new amplitudes are ``U[r, 0] a + U[r, 1] b``.
    Local controls restrict the combine; device controls skip the pair
    (both members agree: the target bit is not a control). ``u`` is
    ``(2, 2)`` or one per batch row."""
    COUNTS["xshard"] += 1
    lt = local_top
    j = position - lt
    bit = 1 << j
    dev_c = ctrl_mask >> lt
    want = dev_c & ~(flip_mask >> lt)
    loc_c = ctrl_mask & ((1 << lt) - 1)
    loc_f = flip_mask & ((1 << lt) - 1)
    timer = _Timed(chunks, "xshard", 1)
    moved: dict = {}
    for v in range(1 << shard_bits):
        if v & bit:
            continue
        if dev_c and (v & dev_c) != want:
            continue
        a, b = chunks[v], chunks[v ^ bit]
        _combine_pair(a, b, _on(u, a.device, moved), lt, loc_c, loc_f,
                      precision, timer)
    timer.done()
    return chunks


def overlap_eligible(plan: ExchangePlan, phys_targets: tuple,
                     ctrl_mask: int, slab_bits: int = 1) -> bool:
    """True when a relayout and the dense gate after it can run as the
    slab double-buffered pipeline of :func:`run_exchange_overlapped`: the
    exchange moves data (``k >= 1``) and leaves no post-transpose, at
    least one column bit remains below the slab, and the gate neither
    targets nor conditions on the slab positions ``[lt-k-slab_bits,
    lt-k)``."""
    lt = plan.local_top
    k = plan.k
    if k < 1 or plan.post_map is not None:
        return False
    if lt - k - slab_bits <= 0:
        return False
    slab_lo, slab_hi = lt - k - slab_bits, lt - k
    if any(slab_lo <= p < slab_hi for p in phys_targets):
        return False
    if any((ctrl_mask >> p) & 1 for p in range(slab_lo, slab_hi)):
        return False
    return True


def slab_remap(pos: int, lt: int, k: int, slab_bits: int = 1) -> int:
    """Physical position inside one slab's ``lt - slab_bits``-qubit
    coordinates: low column bits keep their position, staging and device
    bits shift down by the slab bits."""
    return pos - slab_bits if pos >= lt - k else pos


def _slab_mask(mask: int, lt: int, k: int, slab_bits: int) -> int:
    out = 0
    p = 0
    m = mask
    while m:
        if m & 1:
            out |= 1 << slab_remap(p, lt, k, slab_bits)
        m >>= 1
        p += 1
    return out


def run_exchange_overlapped(chunks: list, plan: ExchangePlan, u,
                            phys_targets: tuple, ctrl_mask: int,
                            flip_mask: int, slab_bits: int = 1,
                            precision=None) -> list:
    """One relayout fused with the dense gate it serves, IN PLACE,
    double-buffered over ``2^slab_bits`` slabs of each chunk: slab ``i``'s
    block swaps are independent of slab ``i-1``'s gate. When every chunk
    lies on one CUDA device the swaps run on a side stream and each
    slab's gate waits for its swaps' event, so the copy of slab ``i+1``
    overlaps the gate on slab ``i``; elsewhere the slabs run in turn.
    The caller checked :func:`overlap_eligible`."""
    COUNTS["relayouts"] += 1
    COUNTS["all_to_all"] += 1
    COUNTS["overlapped"] += 1
    lt = plan.local_top
    k = plan.k
    timer = _Timed(chunks, "relayout+gate", k)
    if plan.pre_map is not None:
        _transpose_chunks(chunks, lt, plan.pre_map)
    views = [_blocks(c, k) for c in chunks]
    cols = views[0].shape[-1]
    nslabs = 1 << slab_bits
    m = cols // nslabs
    lt_slab = lt - slab_bits
    tgt = tuple(slab_remap(p, lt, k, slab_bits) for p in phys_targets)
    cm = _slab_mask(ctrl_mask, lt, k, slab_bits)
    fm = _slab_mask(flip_mask, lt, k, slab_bits)
    # the data shard d ends with after the residual permutation is
    # chunk src(d)'s now; the gate conditions on d
    src_of = {int(dst): int(src) for src, dst in plan.device_perm} \
        if plan.device_perm is not None else None
    order = [src_of[d] for d in range(len(chunks))] if src_of \
        else list(range(len(chunks)))
    dev = chunks[0].device
    side = None
    if dev.type == "cuda" and len({c.device for c in chunks}) == 1:
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
    events = []
    for j in range(nslabs):
        slabs = [v[..., j * m:(j + 1) * m] for v in views]
        if side is not None:
            with torch.cuda.stream(side):
                _all_to_all(slabs, plan.groups, k, timer)
                ev = torch.cuda.Event()
                ev.record(side)
            events.append(ev)
        else:
            _all_to_all(slabs, plan.groups, k, timer)
    for j in range(nslabs):
        if side is not None:
            torch.cuda.current_stream(dev).wait_event(events[j])
        for d in range(len(chunks)):
            sl = views[order[d]][..., j * m:(j + 1) * m]
            buf = sl.reshape(*sl.shape[:-2], -1)       # a contiguous copy
            apply_op_local([buf], "u", u, tgt, cm, fm, lt_slab,
                           precision=precision, shard_ids=[d])
            sl.copy_(buf.view(sl.shape))
    if side is not None:
        torch.cuda.current_stream(dev).wait_stream(side)
    if plan.device_perm is not None:
        COUNTS["ppermute"] += 1
        _ppermute(chunks, plan.device_perm, timer)
    timer.done()
    return chunks
