"""Plan items on a batch, and gradients by an adjoint walk over them.

The batched engine (``CompiledCircuit.sweep`` and its kin) applies a
compiled plan item by item to a ``(B, 2, N)`` batch, one parameter binding
per row (:func:`item_operator`, :func:`apply_item`). Gradient sweeps
(``CompiledCircuit.value_and_grad_sweep``, the counterpart of the JAX
package's ``circuits.py:3631``) walk the same plan backwards.

The JAX package runs ``jax.value_and_grad`` over a layer-free twin of the
plan (``_xla_only``, ``_grad_fn``). Reverse mode of that kind keeps every
op's input: ~100 batches of planes for a 96-parameter ansatz, which one
card cannot hold at 24 qubits and batch 64. :class:`AdjointWalk` is the
adjoint method instead (Jones & Gacon, arXiv:2009.02823), which needs a
fixed handful of batches whatever the depth:

1. forward: run the plan on the batch ``psi``, keeping the state that enters
   each non-unitary item (a channel's superoperator) while a memory cap
   allows; then the values and the cotangent ``lam``: ``H psi`` for a state
   vector (``<psi|H|psi>``), and for a density program the flat ``H``
   itself, since ``Tr(H rho) = Re <H_flat, rho_flat>``;
2. reverse: ``psi`` and ``lam`` are the two halves of one ``(2B, 2, N)``
   stack, so a unitary item's adjoint is one batched call on both (a layer
   one launch of its adjoint layer over 2B states,
   :func:`~quest_tpu_torch.ops.layer_kernel.adjoint_layer`). A parametrised
   item first adds, for each parameter it reads, ``f Re <lam, dU psi_in>``
   to that parameter's column (``f`` = 2 for ``<psi|H|psi>``, 1 for the
   linear ``Tr(H rho)``); for a unitary item ``dU psi_in = (dU U^dag)
   psi_out``, so it needs no state but the current one. A non-unitary item
   cannot be un-computed: ``psi_in`` is its stored state, or past the cap
   is recomputed from the nearest stored state (or the start), and ``lam``
   takes the item's adjoint ``M^dag`` either way.

Layers are parameter-free (the collector admits static ops only), so the
only derivatives are the parametrised ops', taken from their one torch
definition by :func:`bind_with_derivatives`.

On a mesh the batch may instead span the shards (the batched engine's
``amp`` mode): :func:`apply_chunk_item` applies a plan item to a list of
``(B, 2, 2^(n-s))`` chunks, and :class:`ShardedAdjointWalk` walks the mesh
plan over them, a relayout's adjoint being the inverse relayout.
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.apply import apply_diagonal, apply_unitary
from . import layer_kernel as lk

__all__ = ["UNITARY_TOL", "bind_rows", "bind_with_derivatives",
           "item_operator", "apply_item", "apply_chunk_item",
           "unitary_matrix", "unit_modulus", "is_unitary", "AdjointWalk",
           "ShardedAdjointWalk"]

# largest |U^dag U - I| (or ||d| - 1| for a diagonal) of an item the walk
# un-computes by its adjoint; any other static item is treated as a channel
UNITARY_TOL = 1e-10


def _complex(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.complex128)


def _row_params(names: Sequence[str], row: torch.Tensor) -> dict:
    """A parameter row as the dict a parametrised callable reads: each
    name bound to a 0-dim float64 tensor (a row's slice under vmap)."""
    return {nm: row[i] for i, nm in enumerate(names)}


def bind_rows(fn: Callable, names: Sequence[str], pm: np.ndarray,
              what: str = "a parameter callable"):
    """Evaluate a ``params -> operator`` function for the rows of a ``(B,
    P)`` host parameter matrix: once, shared by the batch, when every row
    binds the same values, else over the rows with ``torch.func.vmap``
    into ``(B, ...)`` (moved to the device once by the gate engine). A
    callable the batch binds row by row must be torch-traceable, as the
    JAX package's must be jnp-traceable; one that is not raises
    ``TypeError`` naming ``what``."""
    rows = torch.as_tensor(pm, dtype=torch.float64)
    if pm.shape[0] == 1 or not (pm != pm[0]).any():
        return np.asarray(fn(_row_params(names, rows[0])),
                          dtype=np.complex128)
    try:
        out = torch.func.vmap(
            lambda row: _complex(fn(_row_params(names, row))))(rows)
    except (RuntimeError, TypeError) as exc:
        raise TypeError(
            f"{what} is not torch-traceable: the batched engine binds its "
            f"rows with torch.func.vmap ({exc})") from exc
    return out.resolve_conj().numpy()


class _Reads(dict):
    """A parameter dict that records the names a callable reads."""

    def __init__(self, values):
        super().__init__(values)
        self.read = set()

    def __getitem__(self, name):
        self.read.add(name)
        return super().__getitem__(name)

    def get(self, name, default=None):
        self.read.add(name)
        return super().get(name, default)


# serializes forward-mode AD across threads (see bind_with_derivatives)
_FORWARD_AD = threading.Lock()


def bind_with_derivatives(fn: Callable, names: Sequence[str],
                          pm: np.ndarray, what: str):
    """A parametrised op's operator bound for every row of ``pm`` and its
    derivative in each parameter it reads, from its one torch definition:
    ``(values, [(column, derivative), ...])``, complex128 numpy arrays of
    shape ``(B, ...)``. The columns are those the callable reads when
    called once on the host; each derivative is one forward-mode
    ``torch.func.jvp``, vmapped over the rows. A callable that is not
    torch-traceable (a numpy one) raises ``TypeError`` naming ``what``,
    never a silent zero."""
    rows = torch.as_tensor(pm, dtype=torch.float64)
    probe = _Reads(_row_params(names, rows[0]))
    fn(probe)
    cols = [i for i, nm in enumerate(names) if nm in probe.read]
    chosen = rows[:, cols]

    def at(theta, row):
        params = _row_params(names, row)
        params.update({names[c]: theta[j] for j, c in enumerate(cols)})
        return _complex(fn(params))

    try:
        values = torch.func.vmap(at)(chosen, rows)
        derivs = []
        # torch's forward-AD dual level is one per process, not per
        # thread: a jvp on one thread (a gradient dispatch) and on another
        # (a warm, an optimizer loop) would each exit the other's level
        with _FORWARD_AD:
            for j, c in enumerate(cols):
                tangent = torch.zeros(len(cols), dtype=torch.float64)
                tangent[j] = 1.0
                _, d = torch.func.vmap(
                    lambda t, r, e=tangent: torch.func.jvp(
                        lambda tt: at(tt, r), (t,), (e,)))(chosen, rows)
                derivs.append((c, d.resolve_conj().numpy()))
    except (RuntimeError, TypeError) as exc:
        raise TypeError(
            f"{what} is not torch-traceable, so it cannot be "
            f"differentiated: a parametrised callable must build its "
            f"operator with torch ops ({exc})") from exc
    return values.resolve_conj().numpy(), derivs


def _what(op) -> str:
    return f"the parameter op on qubits {tuple(op.targets)}"


def item_operator(op, names: Sequence[str], pm: np.ndarray):
    """The operator a plan item applies to the batch: its static matrix or
    diagonal tensor, or a parametrised op's bound per row (shared when
    every row binds the same values); None for a layer or a relayout."""
    if op.kind in ("layer", "relayout"):
        return None
    what = _what(op)
    if op.kind == "u":
        return op.mat if op.mat_fn is None \
            else bind_rows(op.mat_fn, names, pm, what)
    return np.asarray(op.diag) if op.diag_fn is None \
        else bind_rows(op.diag_fn, names, pm, what)


def apply_item(states: torch.Tensor, num_qubits: int, op, item, operator,
               precision, fast: bool) -> torch.Tensor:
    """Apply one plan item IN PLACE to a ``(B, 2, N)`` batch: a layer in one
    launch of the batched layer kernel, a gate or a diagonal with
    ``operator`` (:func:`item_operator`'s, shared or one per row, or any
    other operator on the item's targets) through the gate engine."""
    _, _, targets, cmask, fmask, axis_order = item
    if op.kind == "layer":
        return lk.apply_layer_batched(states, num_qubits, op, fast=fast)
    if op.kind == "u":
        return apply_unitary(states, num_qubits, operator, targets, cmask,
                             fmask, precision=precision)
    return apply_diagonal(states, num_qubits, targets,
                          _diag_in_plan_order(operator, targets, axis_order))


def _diag_in_plan_order(operator, targets, axis_order) -> np.ndarray:
    """A diagonal's (shared or per-row) factor tensor with its qubit axes
    in the plan item's physical order."""
    d = np.asarray(operator)
    lead = d.ndim - len(targets)
    return np.ascontiguousarray(np.transpose(d, tuple(range(lead)) + tuple(
        lead + a for a in axis_order)))


class RelayoutOp:
    """A mesh plan's relayout item as a walk step: ``plan`` the exchange
    that realises it (``parallel.exchange.plan_exchange``)."""

    kind = "relayout"
    is_static = True
    channel = False

    def __init__(self, plan):
        self.plan = plan


def apply_chunk_item(chunks: list, num_qubits: int, shard_bits: int, op,
                     item, operator, precision, fast: bool,
                     inplace: bool = False) -> list:
    """Apply one mesh-plan item IN PLACE to a batch held as shard chunks,
    ``(B, 2, 2^(n-s))`` each (the batched engine's ``amp`` mode): a
    relayout (``op`` a :class:`RelayoutOp`) through the exchange, a
    cross-shard item through the role-split combine, a layer as one
    batched-kernel launch per chunk, a gate or a diagonal on each chunk
    (``parallel/exchange.py``). ``inplace`` keeps each list entry the
    same tensor (the walk's chunks are views of its stacked pair)."""
    from ..parallel import exchange as ex
    lt = num_qubits - shard_bits
    if item[0] == "relayout":
        return ex.run_exchange(chunks, op.plan, inplace=inplace)
    _, _, targets, cmask, fmask, axis_order = item
    if op.kind == "layer":
        for c in chunks:
            lk.apply_layer_batched(c, lt, op, fast=fast)
        return chunks
    if item[0] == "xshard":
        return ex.apply_1q_cross_shard(chunks, operator, targets[0], lt,
                                       shard_bits, cmask, fmask,
                                       precision=precision)
    if op.kind == "u":
        return ex.apply_op_local(chunks, "u", operator, targets, cmask,
                                 fmask, lt, precision=precision)
    return ex.apply_op_local(
        chunks, "diag", _diag_in_plan_order(operator, targets, axis_order),
        targets, 0, 0, lt)


def unitary_matrix(m) -> bool:
    """Whether ``m`` is unitary to :data:`UNITARY_TOL`."""
    m = np.asarray(m, dtype=np.complex128)
    return float(np.abs(m.conj().T @ m - np.eye(m.shape[0])).max()) \
        <= UNITARY_TOL


def unit_modulus(d) -> bool:
    """Whether every entry of ``d`` has modulus 1 to :data:`UNITARY_TOL`."""
    return float(np.abs(np.abs(np.asarray(d)) - 1.0).max()) <= UNITARY_TOL


def is_unitary(op) -> bool:
    """Whether the walk may un-compute a plan item by its adjoint: a
    parametrised op unless it is a channel's superoperator (``op.channel``),
    a static gate or diagonal by its matrix, a layer by every stage, a
    relayout always (a permutation)."""
    if op.kind == "relayout":
        return True
    if op.kind == "layer":
        return all(unit_modulus(st[1]) if st[0] == "rowdiag"
                   else unitary_matrix(st[1] if st[0] in ("lane", "clane")
                                       else st[2])
                   for st in op.stages)
    if not op.is_static:
        return not op.channel
    return unitary_matrix(op.mat) if op.kind == "u" \
        else unit_modulus(op.diag)


def _adjoint_operator(op, operator):
    if op.kind in ("layer", "relayout"):
        return None
    if op.kind == "u":
        return np.conj(np.swapaxes(np.asarray(operator), -1, -2))
    return np.conj(np.asarray(operator))


def _per_row(op, item, operator) -> bool:
    base = 2 if op.kind == "u" else len(item[2])
    return np.asarray(operator).ndim > base


def _rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Re <a_b|b_b>`` for each row of two ``(B, 2, N)`` batches, as one
    batched product (no batch-sized temporary)."""
    rows = a.shape[0]
    return torch.bmm(a.reshape(rows, 1, -1),
                     b.reshape(rows, -1, 1)).view(rows)


class AdjointWalk:
    """The adjoint walk over one plan: ``steps`` are the plan's ``(op,
    item)`` pairs in program order. Built once per plan: every item
    classified on the host (:func:`is_unitary`) and every layer's adjoint
    made (and later packed) once. ``density`` selects the linear form
    ``Tr(H rho)`` (gradient factor 1) over ``<psi|H|psi>`` (factor 2)."""

    def __init__(self, num_qubits: int, steps: Sequence, names: Sequence[str],
                 precision, fast: bool, density: bool):
        self.num_qubits = num_qubits
        self.steps = list(steps)
        self.names = tuple(names)
        self.precision = precision
        self.fast = fast
        self.factor = 1.0 if density else 2.0
        self.unitary = [is_unitary(op) for op, _ in self.steps]
        self.adjoints = {id(op): lk.adjoint_layer(op)
                         for op, _ in self.steps if op.kind == "layer"}

    def _apply(self, states, op, item, operator) -> None:
        apply_item(states, self.num_qubits, op, item, operator,
                   self.precision, self.fast)

    def _forward(self, states, k: int, pm) -> None:
        op, item = self.steps[k]
        self._apply(states, op, item, item_operator(op, self.names, pm))

    # the batch primitives (ShardedAdjointWalk holds a batch as chunks)

    @staticmethod
    def _new_pair(start, batch: int):
        """The ``(2B, 2, N)`` stack and its halves ``psi`` and ``lam``."""
        pair = start.new_empty((2 * batch,) + tuple(start.shape))
        return pair, pair[:batch], pair[batch:]

    @staticmethod
    def _copy(dst, src) -> None:
        dst.copy_(src)

    @staticmethod
    def _clone(x):
        return x.clone()

    @staticmethod
    def _nbytes(x) -> int:
        return x.numel() * x.element_size()

    @staticmethod
    def _dot(a, b) -> torch.Tensor:
        return _rows_dot(a, b)

    @staticmethod
    def _device(x) -> torch.device:
        return x.device

    def _restore(self, psi, k: int, stored: dict, start, pm) -> None:
        """``psi`` <- the state entering item ``k``: its stored copy, or
        recomputed from the nearest stored state before it (or the
        start)."""
        if k in stored:
            self._copy(psi, stored.pop(k))
            return
        base = max((j for j in stored if j < k), default=None)
        self._copy(psi, start if base is None else stored[base])
        for j in range(0 if base is None else base, k):
            self._forward(psi, j, pm)

    def _accumulate(self, grads, col: int, source, lam, op, item,
                    generator) -> None:
        """``grads[:, col] += f Re <lam, G source>``. A controlled item's
        derivative vanishes off its control subspace, where the gate
        engine applies the identity, so it applies ``G + I`` there and
        takes ``Re <lam, source>`` off again."""
        mu = self._clone(source)
        controlled = op.kind == "u" and item[3] != 0
        if controlled:
            generator = generator + np.eye(generator.shape[-1])
        self._apply(mu, op, item, generator)
        dot = self._dot(lam, mu)
        if controlled:
            dot = dot - self._dot(lam, source)
        grads[:, col] += self.factor * dot.to(torch.float64)

    def run(self, pm: np.ndarray, start: torch.Tensor,
            energies: Callable, cotangent: Callable, store_bytes: int):
        """Values and gradients for the rows of the ``(B, P)`` parameter
        matrix ``pm`` from the shared ``(2, N)`` start planes ``start`` (in
        the walk's plane dtype, on its device): ``energies(psi)`` gives the
        ``(B,)`` values of the final batch and ``cotangent(psi, lam)``
        writes its cotangent into ``lam``. States entering non-unitary
        items are kept while they fit in ``store_bytes``. Returns ``(values,
        grads)``, a ``(B,)`` tensor and a float64 ``(B, P)`` one, on the
        device."""
        batch = pm.shape[0]
        pair, psi, lam = self._new_pair(start, batch)
        self._copy(psi, start)
        state_bytes = self._nbytes(psi)
        stored: dict = {}
        for k in range(len(self.steps)):
            if not self.unitary[k] \
                    and (len(stored) + 1) * state_bytes <= store_bytes:
                stored[k] = self._clone(psi)
            self._forward(psi, k, pm)
        values = energies(psi)
        cotangent(psi, lam)
        grads = torch.zeros((batch, len(self.names)), dtype=torch.float64,
                            device=self._device(psi))
        for k in reversed(range(len(self.steps))):
            op, item = self.steps[k]
            derivs = []
            if op.kind != "layer" and not op.is_static:
                fn = op.mat_fn if op.kind == "u" else op.diag_fn
                operator, derivs = bind_with_derivatives(
                    fn, self.names, pm, _what(op))
            else:
                operator = item_operator(op, self.names, pm)
            adj_op = self.adjoints.get(id(op), op)
            adjoint = _adjoint_operator(op, operator)
            if not self.unitary[k]:
                self._restore(psi, k, stored, start, pm)
                for col, d in derivs:
                    self._accumulate(grads, col, psi, lam, op, item, d)
                self._apply(lam, adj_op, item, adjoint)
                continue
            for col, d in derivs:
                # dU psi_in = (dU U^dag) psi_out
                g = d @ adjoint if op.kind == "u" else d * adjoint
                self._accumulate(grads, col, psi, lam, op, item, g)
            if adjoint is not None and _per_row(op, item, adjoint):
                adjoint = np.concatenate([adjoint, adjoint])
            self._apply(pair, adj_op, item, adjoint)
        return values, grads


class ShardedAdjointWalk(AdjointWalk):
    """The adjoint walk over a MESH plan with the batch held as shard
    chunks (``amp`` mode): ``psi`` and ``lam`` are lists of views into the
    stacked pair's chunks, items apply through :func:`apply_chunk_item`
    with every exchange in place (so the views stay the pair's halves),
    a relayout is unitary and its adjoint the inverse relayout, and a dot
    product sums its shards' partial dots."""

    def __init__(self, num_qubits: int, shard_bits: int, steps: Sequence,
                 names: Sequence[str], precision, fast: bool,
                 density: bool):
        from ..parallel.exchange import plan_exchange
        self.shard_bits = shard_bits
        inverse = {}
        resolved = []
        for op, item in steps:
            if item[0] == "relayout":
                before, after = item[1], item[2]
                op = RelayoutOp(plan_exchange(num_qubits, shard_bits,
                                              before, after))
                inverse[id(op)] = RelayoutOp(plan_exchange(
                    num_qubits, shard_bits, after, before))
            resolved.append((op, item))
        super().__init__(num_qubits, resolved, names, precision, fast,
                         density)
        self.adjoints.update(inverse)

    def _apply(self, states, op, item, operator) -> None:
        apply_chunk_item(states, self.num_qubits, self.shard_bits, op, item,
                         operator, self.precision, self.fast, inplace=True)

    @staticmethod
    def _new_pair(start, batch: int):
        pair = [c.new_empty((2 * batch,) + tuple(c.shape)) for c in start]
        return (pair, [p[:batch] for p in pair],
                [p[batch:] for p in pair])

    @staticmethod
    def _copy(dst, src) -> None:
        for d, s in zip(dst, src):
            d.copy_(s)

    @staticmethod
    def _clone(x):
        return [c.clone() for c in x]

    @staticmethod
    def _nbytes(x) -> int:
        return sum(c.numel() * c.element_size() for c in x)

    @staticmethod
    def _dot(a, b) -> torch.Tensor:
        home = a[0].device
        return sum(_rows_dot(x, y).to(home) for x, y in zip(a, b))

    @staticmethod
    def _device(x) -> torch.device:
        return x[0].device
