"""Circuit-level gate fusion: runs of adjacent gates collapse into one kernel.

The reference applies every gate as its own full-state pass
(``QuEST_gpu.cu:722-728``: one kernel launch per gate); distributed
simulators in the mpiQulacs lineage (2203.16044) win by merging runs of
adjacent gates whose combined support stays small into single dense
unitaries, so one data move — and one kernel — serves many gates. This
module is that pass for the compiled pipeline: it rewrites the recorded
op stream BETWEEN recording and layout planning, so the layout planner
(:mod:`quest_tpu_torch.parallel.layout`) chooses relayouts per fused *group*
rather than per gate, and the device receives one fat contraction where it used
to receive a ladder of thin ones.

Three rewrites, in one linear scan:

1. **dense fusion** — consecutive static gates (dense or diagonal) whose
   combined support (targets + controls) fits in ``max_k`` qubits compose
   into ONE ``2^k x 2^k`` unitary (`embed_in_support` per member, matrix
   product in program order);
2. **diagonal folding** — runs of diagonal/phase gates merge into one
   elementwise factor over the union of their qubits (never densified:
   a diagonal run of any length stays one broadcast multiply);
3. **diagonal commuting** — a diagonal that would overflow an open dense
   run is *deferred* past it instead of breaking it: diagonals commute
   with each other always and with dense gates on disjoint qubits, so
   the deferred factor simply re-emerges after the run (or seeds the
   next one). Phase ladders (QFT's bulk) therefore never fence dense
   fusion.

Soundness of the reorder: a deferred factor is only carried past ops
that join a group *after* its defer point, and every such dense join is
gated on disjointness from all deferred supports (diagonal joins need no
gate — diagonals commute pairwise). Ops already in a group at defer time
keep their original order relative to the factor, because the group is
emitted before it.

Ops are :class:`quest_tpu_torch.circuits._Op` records; the pass is agnostic to
that class (it rebuilds merged ops with :func:`dataclasses.replace`, so
any dataclass with the same field protocol works). Parameterized ops,
channels, and anything matching ``barrier`` flush all pending state and
pass through unchanged — fusion never reorders across them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from . import matrices as mats

__all__ = ["FusionStats", "fuse_ops", "op_support", "resolve_fusion_k",
           "compose_in_support"]


def compose_in_support(members: Sequence, sup: tuple) -> np.ndarray:
    """Left-to-right product of static ops embedded over ``sup`` (bit j
    of the result indexes ``sup[j]``) — the one place the group-collapse
    math lives, shared by this pass and the post-plan super-gate
    grouping (``circuits._group_supergates``)."""
    m = np.eye(1 << len(sup), dtype=np.complex128)
    for op in members:
        if op.kind == "u":
            e = mats.embed_in_support(op.mat, op.targets, sup,
                                      op.ctrl_mask, op.flip_mask)
        else:
            e = mats.diag_in_support(np.asarray(op.diag), op.targets, sup)
        m = e @ m
    return m


@dataclasses.dataclass
class FusionStats:
    """Per-pass fusion accounting, surfaced through
    :meth:`CompiledCircuit.dispatch_stats` (``profiling.DispatchStats``
    owns the serialized form)."""
    gates_in: int = 0            # ops entering the pass
    kernels_out: int = 0         # ops leaving the pass
    fused_groups: int = 0        # dense groups of >= 2 members emitted
    diag_folds: int = 0          # diagonal ops merged into a factor
    commuted_diagonals: int = 0  # diagonals deferred past an open group
    group_sizes: list = dataclasses.field(default_factory=list)

    @property
    def max_group_gates(self) -> int:
        return max(self.group_sizes, default=0)


def op_support(op) -> frozenset:
    """Qubits a dense op occupies: targets plus control bits."""
    qs = set(op.targets)
    m, q = op.ctrl_mask, 0
    while m:
        if m & 1:
            qs.add(q)
        m >>= 1
        q += 1
    return frozenset(qs)


def resolve_fusion_k(fusion, num_local: int, default: int = 3) -> int:
    """Resolve the user-facing ``fusion=`` knob to an effective support
    cap: ``None``/``True`` -> the default k, ``False``/``0`` -> off, an
    int -> that k — always clamped to the chunk-local qubit count
    (``num_local``) so a
    fused gate never outgrows what one device can gather locally (the
    ``fits_local`` predicate of the JAX package's ``parallel/pergate.py``,
    mirroring ``validateMultiQubitMatrixFitsInNode``)."""
    if fusion is None or fusion is True:
        k = default
    elif fusion is False:
        k = 0
    else:
        k = int(fusion)
    return min(k, num_local)


@dataclasses.dataclass
class _DiagChunk:
    """One deferred (or accumulating) diagonal factor: axes of ``tensor``
    follow ``support`` sorted descending. ``template`` is a source op the
    emitted record is rebuilt from (field protocol, not content)."""
    tensor: np.ndarray
    support: frozenset
    template: object
    n_src: int = 1

    @property
    def union_desc(self) -> tuple:
        return tuple(sorted(self.support, reverse=True))

    def merged(self, tensor: np.ndarray, qubits_desc: tuple,
               n_src: int = 1) -> "_DiagChunk":
        support = self.support | frozenset(qubits_desc)
        union = tuple(sorted(support, reverse=True))

        def expand(t, qs):
            shape = tuple(2 if q in qs else 1 for q in union)
            return np.asarray(t).reshape(shape)

        return _DiagChunk(expand(self.tensor, self.union_desc)
                          * expand(tensor, qubits_desc),
                          support, self.template, self.n_src + n_src)


def fuse_ops(ops: Sequence, max_k: int = 3, diag_max: int = 12,
             diag_row_cap: int = -1,
             barrier: Optional[Callable] = None):
    """Fuse an op stream; returns ``(fused_ops, FusionStats)``.

    ``max_k``: support cap for dense groups (gates + absorbed diagonals
    compose into one ``2^max_k``-dim unitary at most). ``diag_max`` caps
    the qubit union of a folded diagonal factor — a folded factor is ONE
    elementwise pass whatever its union, so the cap is generous (2^12
    tensor entries; measured on QFT-18/8dev: raising it from 6 to 12
    cut kernels 39 -> 20 and took the fusion speedup from 1.15x to
    ~1.75x median). ``diag_row_cap >= 0`` additionally caps its row-bit
    count
    (qubits >= 7) so folded factors stay eligible for the Pallas layer
    kernel (see ``Circuit._fused_ops``). ``barrier(op) -> True`` fences
    an op from fusion entirely (used to keep Pallas-layer-eligible runs
    intact).
    """
    stats = FusionStats(gates_in=len(ops))
    if max_k < 2:
        out = list(ops)
        stats.kernels_out = len(out)
        return out, stats

    out: list = []
    group: list = []                  # ops / chunks, in program order
    gsupport: frozenset = frozenset()
    gsrc = 0                          # source gates inside the group
    trailing: list[_DiagChunk] = []   # deferred diag factors, defer order

    def diag_fits(support: frozenset) -> bool:
        if len(support) > diag_max:
            return False
        if diag_row_cap >= 0 and sum(q >= 7 for q in support) > diag_row_cap:
            return False
        return True

    def chunk_op(chunk: _DiagChunk):
        return dataclasses.replace(
            chunk.template, kind="diag", targets=chunk.union_desc,
            ctrl_mask=0, flip_mask=0, mat=None, mat_fn=None,
            diag=chunk.tensor, diag_fn=None, kraus=None)

    def emit_group():
        nonlocal group, gsupport, gsrc
        if not group:
            return
        if len(group) == 1:
            m = group[0]
            out.append(chunk_op(m) if isinstance(m, _DiagChunk) else m)
        else:
            sup = tuple(sorted(gsupport))
            members = [chunk_op(g) if isinstance(g, _DiagChunk) else g
                       for g in group]
            m = compose_in_support(members, sup)
            out.append(dataclasses.replace(
                members[0], kind="u", targets=sup, ctrl_mask=0,
                flip_mask=0, mat=m, mat_fn=None, diag=None, diag_fn=None,
                kraus=None))
            stats.fused_groups += 1
            stats.group_sizes.append(gsrc)
        group = []
        gsupport = frozenset()
        gsrc = 0

    def emit_chunks(chunks):
        out.extend(chunk_op(c) for c in chunks)

    def flush_all():
        nonlocal trailing
        emit_group()
        emit_chunks(trailing)
        trailing = []

    for op in ops:
        kind = getattr(op, "kind", None)
        if (kind not in ("u", "diag") or not op.is_static
                or (barrier is not None and barrier(op))):
            flush_all()
            out.append(op)
            continue

        if kind == "diag":
            ds = frozenset(op.targets)
            # absorbing into the open dense run keeps the factor ahead of
            # every deferred chunk — valid: diagonals commute pairwise
            if group and len(gsupport | ds) <= max_k:
                group.append(op)
                gsupport |= ds
                gsrc += 1
                continue
            tensor = np.asarray(op.diag)
            # best-fit fold: diagonals commute pairwise, so ANY deferred
            # chunk is a valid home — pick the one whose union grows
            # least (fewest standalone factor passes at flush time)
            best, best_grow = None, None
            for ci, c in enumerate(trailing):
                u = c.support | ds
                if diag_fits(u):
                    grow = len(u) - len(c.support)
                    if best is None or grow < best_grow:
                        best, best_grow = ci, grow
            if best is not None:
                trailing[best] = trailing[best].merged(tensor, op.targets)
                stats.diag_folds += 1
            else:
                trailing.append(_DiagChunk(tensor, ds, op))
                if group:
                    stats.commuted_diagonals += 1
            continue

        # dense static op
        qs = op_support(op)
        if len(qs) > max_k:
            flush_all()
            out.append(op)
            continue
        tsupport = frozenset().union(*(c.support for c in trailing)) \
            if trailing else frozenset()
        if group and len(gsupport | qs) <= max_k and not (qs & tsupport):
            group.append(op)
            gsupport |= qs
            gsrc += 1
            continue
        # close the open run; deferred chunks overlapping this gate must
        # land before it — as leading members of the NEXT run when they
        # fit, standalone factors otherwise. Disjoint chunks stay
        # deferred across the boundary (the "commute" in the module doc).
        emit_group()
        overlapping = [c for c in trailing if c.support & qs]
        disjoint = [c for c in trailing if not (c.support & qs)]
        seed_support = qs.union(*(c.support for c in overlapping))
        if overlapping and len(seed_support) <= max_k:
            group = list(overlapping) + [op]
            gsupport = seed_support
            gsrc = sum(c.n_src for c in overlapping) + 1
        else:
            emit_chunks(overlapping)
            group = [op]
            gsupport = qs
            gsrc = 1
        trailing = disjoint

    flush_all()
    stats.kernels_out = len(out)
    return out, stats
