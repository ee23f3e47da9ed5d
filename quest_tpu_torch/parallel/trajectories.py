"""Trajectory waves that span the shards (the ``amp`` mode of a trajectory
program on a mesh).

Counterpart of the JAX package's amplitude-sharded trajectory executables
(``ops/trajectories.py`` under ``_resolve_mode(...) == "amp"``, GSPMD's
partition of the vmapped walker). Every trajectory of a wave is held as the
mesh's chunks, ``(T, 2, 2^(n-s))`` per shard, and the program runs as a walk
of steps (:class:`TrajectoryWalk`):

- the static and parametrised gates between two channels are one segment,
  planned for the mesh as a compiled circuit is (relayouts between layers
  on the chunk's qubits, the batched layer kernel on each chunk,
  ``ops/adjoint.py`` :func:`~quest_tpu_torch.ops.adjoint.apply_chunk_item`);
  each segment ends in the canonical layout;
- a channel is one step. A target on a sharded position first trades
  places with a free local position through one relayout of the whole wave
  (``parallel/exchange.py``), and trades back after. Each trajectory's
  branch probabilities are the sum over the chunks of each chunk's partial
  traces against the effects ``E_j = K_j^dag K_j``, each reduced in
  float64 as one device reduces them, summed in shard order. With those
  totals every chunk draws the same branch from the trajectory's uniform: a
  channel on lane positions (< 7) through one launch of the fused Kraus
  kernel per chunk (the kernel draws from the probabilities it is given,
  so a chunk needs no other entry), any other through the same
  inverse-CDF rule and the gate engine, as one device runs it.

The walk is built once per program and holds only what every call
shares (the steps, their adjoints, the swap plans and lane stacks). A call
runs on its own :meth:`TrajectoryWalk.wave`, which holds that call's
uniforms and the branches it draws, so calls on several threads never
share a draw.

The gradient walk (:meth:`TrajectoryWalk.run_wave`) is
:class:`~quest_tpu_torch.ops.adjoint.ShardedAdjointWalk` over these steps:
a channel is non-unitary, so its input is stored or replayed with the
recorded branches, and its adjoint applies each trajectory's recorded
``(K_j / sqrt(p_j))^dag`` to the cotangent.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional

import numpy as np
import torch

from ..core.apply import apply_unitary
from ..ops import kraus_kernel as kk
from ..ops import layer_kernel as lk
from ..ops.adjoint import ShardedAdjointWalk, bind_with_derivatives
from ..ops.trajectories import (_PROB_BLOCK_BITS, _branch_operators,
                                _drawn, _one_hot, _stacked)
from . import exchange as ex
from .shards import start_chunks

__all__ = ["ChannelStep", "TrajectoryWalk", "build_walk"]


class ChannelStep:
    """A channel of the program as one step of the walk: ``item`` is the
    trajectory program's ``("kraus" | "kraus_fn", targets, data, idx)``
    tuple. Non-unitary (``channel``), so the gradient walk keeps or
    replays its input."""

    kind = "chan"
    is_static = False
    channel = True

    def __init__(self, item):
        self.item = item


def build_walk(program, pallas=None) -> "TrajectoryWalk":
    """The mesh walk of a :class:`~quest_tpu_torch.ops.trajectories.
    TrajectoryProgram` on its mesh env: the program's peephole-fused ops
    split at its channels, each gate segment compiled for the mesh at the
    env precision, without the k-qubit fusion and super-gates one
    device's walker does not make either."""
    from ..circuits import Circuit, _peephole_fused
    circuit = program.circuit
    env = program.env
    fused = _peephole_fused(circuit.ops)
    steps = []
    segment = []

    def flush():
        if not segment:
            return
        sub = Circuit(circuit.num_qubits)
        sub.ops = list(segment)
        sub._params = list(circuit.param_names)
        # no k-qubit fusion and no super-gates: the segment's layers are
        # collected from the ops one device's walker collects them from
        cc = sub.compile(env, pallas=pallas, fusion=False, supergate_k=1)
        steps.extend((cc._ops[it[1]] if it[0] != "relayout" else None, it)
                     for it in cc.plan.items)
        segment.clear()

    for op, item in zip(fused, program._ops):
        if op.kind == "kraus":
            flush()
            steps.append((ChannelStep(item), ("chan",)))
        else:
            segment.append(op)
    flush()
    # trajectory programs run at the env precision: no tier, no FAST mode
    return TrajectoryWalk(program, env.num_devices.bit_length() - 1, steps,
                          None, False)


def _swap_plan(n: int, s: int, targets) -> tuple:
    """``(plan, physical targets)``: the relayout that trades each target
    on a sharded position with the lowest local position no target uses
    (None when every target is local), and the targets' positions after
    it. The swap is its own inverse."""
    lt = n - s
    sharded = [t for t in targets if t >= lt]
    if not sharded:
        return None, tuple(targets)
    free = [p for p in range(lt) if p not in targets]
    after = list(range(n))
    moved = dict(zip(sharded, free))
    for t, p in moved.items():
        after[t], after[p] = p, t
    return (ex.plan_exchange(n, s, list(range(n)), after),
            tuple(moved.get(t, t) for t in targets))


class TrajectoryWalk(ShardedAdjointWalk):
    """The walk of a trajectory program over the mesh's chunks: gate steps
    as :class:`~quest_tpu_torch.ops.adjoint.ShardedAdjointWalk` runs them,
    :class:`ChannelStep` s drawn from the wave's uniforms (and recorded, so
    a replay or the reverse never draws twice). Runs only as a
    :meth:`wave`, which holds one call's uniforms and draws."""

    def __init__(self, program, shard_bits: int, steps, precision,
                 fast: bool):
        super().__init__(program.num_qubits, shard_bits, steps,
                         program.param_names, precision, fast, False)
        self.program = program
        self.local = program.num_qubits - shard_bits
        # one call's (T, C) uniforms and recorded branches: set on a wave
        self.uniforms: Optional[torch.Tensor] = None
        self.draws: Optional[dict] = None
        self._swaps: dict = {}
        self._lane: dict = {}

    def wave(self, uniforms: torch.Tensor) -> "TrajectoryWalk":
        """This walk for one call: a shallow copy sharing the steps and
        the caches, with the call's ``(T, C)`` uniforms (plane dtype, on
        the first shard's device) and its own record of the branches it
        draws (``draws``, by channel number, readable after the run)."""
        w = copy.copy(self)
        w.uniforms = uniforms
        w.draws = {}
        return w

    @staticmethod
    def _dot(a, b) -> torch.Tensor:
        """``Re <a_t|b_t>`` summed over the chunks in float64, each chunk's
        rows reduced over blocks of ``2^_PROB_BLOCK_BITS`` amplitudes in
        the plane dtype and the blocks summed in float64, as the one-device
        walk's cross densities are."""
        home = a[0].device
        total = None
        for x, y in zip(a, b):
            rows = x.shape[0]
            size = min(1 << _PROB_BLOCK_BITS, x[0].numel())
            part = (x.reshape(rows, -1, 1, size)
                    @ y.reshape(rows, -1, size, 1)).double().sum(
                (1, 2, 3)).to(home)
            total = part if total is None else total + part
        return total

    # -- channels --------------------------------------------------------

    def _swap(self, item):
        targets = tuple(item[1])
        if targets not in self._swaps:
            self._swaps[targets] = _swap_plan(self.num_qubits,
                                              self.shard_bits, targets)
        return self._swaps[targets]

    def _lane_stack(self, item, phys, adjoint: bool = False):
        """A static channel's lane-embedded stack on its physical targets
        (``K_k``, or ``K_k^dag`` for the reverse), or None when a target
        is not a lane position or the channel is parametrised."""
        if item[0] != "kraus" or self.local < lk.LANE_QUBITS \
                or any(q >= lk.LANE_QUBITS for q in phys):
            return None
        key = (item[3], phys, adjoint)
        if key not in self._lane:
            stack = item[2][0]
            if adjoint:
                stack = np.conj(stack).transpose(0, 2, 1)
            self._lane[key] = np.ascontiguousarray(np.stack(
                [lk.embed_lane_matrix(k, phys) for k in stack]))
        return self._lane[key]

    def _probs(self, chunks, phys, es) -> torch.Tensor:
        """Each trajectory's ``(T, K)`` branch probabilities: every chunk's
        float64 partial traces, summed in shard order, returned in the
        plane dtype on the first chunk's device."""
        home = chunks[0].device
        total = None
        for c in chunks:
            part = self.program._channel_probs(
                c, phys, es.to(c.device), self.local, exact=True).to(home)
            total = part if total is None else total + part
        return total.to(chunks[0].dtype)

    def _apply_branches(self, chunks, item, phys, ks, j, scale,
                        adjoint: bool = False) -> None:
        """Each trajectory's operator ``K_j * scale`` (or its adjoint) on
        every chunk through the gate engine."""
        ops = _branch_operators(ks, j, scale)
        if adjoint:
            ops = ops.conj().transpose(-1, -2).resolve_conj()
        cache = {}
        for c in chunks:
            if c.device not in cache:
                cache[c.device] = ops.to(c.device)
            apply_unitary(c, self.local, cache[c.device], phys)

    def _channel(self, chunks, step: ChannelStep, pm) -> None:
        """The channel on the wave: drawn from the uniforms' column (and
        recorded) at its first application, its recorded branches on a
        replay."""
        item = step.item
        idx = item[3]
        plan, phys = self._swap(item)
        if plan is not None:
            ex.run_exchange(chunks, plan, inplace=True)
        ks, es = self.program._operators(item[2], item[0], pm)
        kemb = self._lane_stack(item, phys)
        if idx in self.draws:
            j, psel, scale = self.draws[idx]
            if kemb is not None:
                self._fused(chunks, kemb, _one_hot(psel, j, len(kemb)),
                            torch.zeros_like(psel))
            else:
                self._apply_branches(chunks, item, phys, ks, j, scale)
        else:
            probs = self._probs(chunks, phys, es)
            u = self.uniforms[:, idx].to(probs.device).contiguous()
            if kemb is not None:
                index = torch.empty(probs.shape[0], dtype=torch.int32,
                                    device=probs.device)
                self._fused(chunks, kemb, probs, u, index)
                self.draws[idx] = _drawn(probs, index.long())
            else:
                j, scale = kk.draw_plain(probs, u)
                self.draws[idx] = (j, probs.gather(1, j[:, None])[:, 0],
                                   scale)
                self._apply_branches(chunks, item, phys, ks, j, scale)
        if plan is not None:
            ex.run_exchange(chunks, plan, inplace=True)

    def _fused(self, chunks, kemb, probs, u, index=None) -> None:
        """One launch of the fused Kraus kernel per chunk, every chunk with
        the wave's probabilities and uniforms (so every chunk draws the
        same branch); the first writes the drawn indices."""
        cache = {}
        for d, c in enumerate(chunks):
            if c.device not in cache:
                cache[c.device] = (probs.to(c.device), u.to(c.device))
            p, uu = cache[c.device]
            kk.fused_kraus_apply_batched(c, self.local, kemb, p, uu,
                                         index if d == 0 else None)

    def _forward(self, states, k: int, pm) -> None:
        op, _ = self.steps[k]
        if op.kind == "chan":
            self._channel(states, op, pm)
        else:
            super()._forward(states, k, pm)

    def _reverse(self, k: int, pair, psi, lam, grads, pm, stored: dict,
                 start) -> None:
        op, _ = self.steps[k]
        if op.kind != "chan":
            super()._reverse(k, pair, psi, lam, grads, pm, stored, start)
            return
        self._restore(psi, k, stored, start, pm)
        item = op.item
        j, psel, scale = self.draws[item[3]]
        plan, phys = self._swap(item)
        if plan is not None:
            ex.run_exchange(pair, plan, inplace=True)
        ks, _ = self.program._operators(item[2], item[0], pm)
        if item[0] == "kraus_fn":
            # 2 Re <lam, (dK_j / sqrt(p_j)) psi_in> per parameter it reads
            _, derivs = bind_with_derivatives(
                _stacked(item[2]), self.names, pm,
                f"the parameter channel on qubits {tuple(item[1])}")
            for col, d in derivs:
                dk = torch.as_tensor(d, dtype=ks.dtype, device=ks.device)
                mu = self._clone(psi)
                self._apply_branches(mu, item, phys, dk, j, scale)
                grads[:, col] += self.factor * self._dot(lam, mu).to(
                    torch.float64)
        kadj = self._lane_stack(item, phys, adjoint=True)
        if kadj is not None:
            self._fused(lam, kadj, _one_hot(psel, j, len(kadj)),
                        torch.zeros_like(psel))
        else:
            self._apply_branches(lam, item, phys, ks, j, scale,
                                 adjoint=True)
        if plan is not None:
            ex.run_exchange(pair, plan, inplace=True)

    # -- waves -----------------------------------------------------------

    def run_rows(self, start: torch.Tensor, pm: np.ndarray) -> list:
        """On a :meth:`wave`: its ``T`` trajectories from the shared ``(2,
        2^n)`` planes ``start`` with ``(T, P)`` parameter rows, the final
        ``(T, 2, 2^(n-s))`` chunks."""
        chunks = start_chunks(start, self.program.env.mesh.devices,
                              self.local, pm.shape[0])
        for k in range(len(self.steps)):
            self._forward(chunks, k, pm)
        return chunks

    def run_wave(self, start: torch.Tensor, pm: np.ndarray,
                 values: Callable, cotangent: Callable, store_bytes: int):
        """On a :meth:`wave`, a gradient wave: :meth:`ShardedAdjointWalk.
        run` with the channels drawn from the wave's uniforms on the
        forward and replayed with their recorded branches wherever an
        input is recomputed. Returns ``(values, grads)``."""
        return self.run(pm, start_chunks(start,
                                         self.program.env.mesh.devices,
                                         self.local),
                        values, cotangent, store_bytes)

