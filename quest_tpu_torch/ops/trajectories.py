"""Quantum-trajectory (Monte-Carlo wavefunction) unraveling of noisy
circuits: channels applied stochastically to STATE VECTORS.

Counterpart of the JAX package's ``ops/trajectories.py``. The reference
simulates noise only on density matrices, 2^(2n) amplitudes per register
(``QuEST_common.c:540-604``). A trajectory program runs the same channels
on an ensemble of 2^n-amplitude pure states: at each Kraus channel one
operator ``K_j`` is drawn with the physical probability ``p_j = <psi| K_j^dag
K_j |psi>`` and applied with renormalisation. Averaging ``|psi><psi|`` over
trajectories converges to the density evolution at O(1/sqrt(T)).

The trajectory axis is a batch axis: a ``(T, 2, 2^n)`` batch advances item
by item (:meth:`TrajectoryProgram._apply_batch`, the JAX package's Pallas
wave walker) —

- static gate runs between channels are fused layers, applied to the whole
  batch by ``ops.layer_kernel.apply_layer_batched`` (the batched layer
  kernel on the card);
- a static channel whose targets are all lane qubits (< 7) goes through
  ``ops.kraus_kernel.fused_kraus_apply_batched`` (the fused Kraus kernel);
- every other op goes through the gate engine's batched form, a channel
  with the same draw rule as the fused kernel.

Channel probabilities come from the targets' reduced density, reduced by
``torch.matmul`` in float64 (:meth:`_channel_probs`), work the JAX package
leaves to XLA.

Randomness. Every channel's uniform is drawn up front: a ``(T,
num_channels)`` float64 block from a :class:`torch.Generator` on the CPU
(the env's, or one seeded by ``seed=``), moved to the device in the plane
dtype, so the card and the CPU draw the same numbers for the same seed.
Every channel, fused or not, is drawn by the fused kernel's inverse-CDF rule
(``pallas_kernels.py:901-919``, :func:`quest_tpu_torch.ops.kraus_kernel.
draw_plain`). The JAX package's XLA path draws categorically instead
(``trajectories.py:329-335``), so bitwise parity with the JAX package holds
only against its Pallas walker given the same uniforms; elsewhere the parity
is statistical. ``trajectory_sweep``, ``expectation`` and ``sample`` take
``uniforms=`` to feed a caller's block.

Gradients (:meth:`TrajectoryProgram.expectation_grad`, the counterpart of
the JAX package's score-corrected wave loop, ``trajectories.py:688``). The
JAX package differentiates every trajectory with ``jax.value_and_grad``
through :func:`~quest_tpu_torch.ops.reductions.score_surrogate`, whose
gradient is ``dv + (v - b) dlogq``: ``v = <psi|H|psi>`` of the normalised
final state, ``logq`` the log-probability of the drawn branches and ``b``
the row's running mean over earlier waves. Once the branches are drawn that
gradient has a closed form. With ``psi~`` the chain of gates and drawn
``K_j`` without their ``1/sqrt(p_j)``, ``N = |psi~|^2`` is the product of
the drawn ``p_j`` (so ``logq = log N`` for trace-preserving channels), and
``v = <psi~|H|psi~>/N``, so

    dv + (v - b) dlogq = 2 Re <(H - b) psi, d psi~> / sqrt(N).

That is the adjoint walk of ``ops/adjoint.py`` (factor 2) over the chain
of RECORDED operators ``K_j / sqrt(p_j)``, their scale held at its drawn
value, from the cotangent ``(H - b) psi`` (:meth:`TrajectoryProgram.
_grad_rows`). The forward is the value path itself, which records each
trajectory's branch (the fused Kraus kernel writes the index it drew) and
keeps the state entering each channel while a memory cap allows; the
reverse runs on the ``(2T, 2, 2^n)`` stack of states and cotangents, a
layer's adjoint in one launch of the batched layer kernel over ``2T``, a
lane channel's adjoint in one launch of the fused Kraus kernel over the
cotangents with the conjugate-transposed stack and one-hot probabilities
(its draw then picks the recorded branch and scales by the recorded
``1/sqrt(p_j)``). A channel's input past the cap is recomputed by replaying
the recorded branches, never by a second draw. The gradient loop draws the
value loop's uniform block, so its value column is ``expectation``'s mean
bit for bit.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

import numpy as np
import torch

from .. import validation as val
from ..core.apply import apply_diagonal, apply_unitary
from . import kraus_kernel as kk
from . import layer_kernel as lk
from . import reductions as red
from .adjoint import (bind_rows, bind_with_derivatives, is_unitary,
                      unit_modulus, unitary_matrix)

__all__ = ["TrajectoryProgram", "DensityMaterialisationError",
           "plan_waves", "DENSITY_DEBUG_QUBITS_ENV"]

DENSITY_DEBUG_QUBITS_ENV = "QUEST_TPU_DENSITY_DEBUG_QUBITS"
_DENSITY_DEBUG_DEFAULT = 14
# the rows of one group of the walker's batch-count-sensitive work (the
# channel probabilities' reductions, the gate engine's GEMMs), and the
# qubits of one block of a probability reduction (each block's products are
# one small float64 GEMM)
_ROW_GROUP = 8
_PROB_BLOCK_BITS = 12


class DensityMaterialisationError(ValueError):
    """``average_density`` was asked to materialise a 2^n x 2^n matrix past
    the debug-scale bound (``QUEST_TPU_DENSITY_DEBUG_QUBITS``, default 14).
    :meth:`TrajectoryProgram.expectation` (observables) and
    :meth:`TrajectoryProgram.trajectory_sweep` (the raw ensemble) stay at
    state-vector cost."""


def plan_waves(max_trajectories: int, wave_size: int,
               device_multiple: int = 1):
    """The wave schedule of one convergence loop: ``(start, live)`` slices
    of the up-front uniform block, every wave run at the same padded
    bucket (``wave_size`` rounded up to ``device_multiple``); padded rows
    are masked out of the statistics exactly. Returns ``(waves,
    bucket)``."""
    if max_trajectories < 1:
        raise ValueError("max_trajectories must be >= 1")
    if wave_size < 1:
        raise ValueError("wave_size must be >= 1")
    mult = max(1, int(device_multiple))
    bucket = -(-int(wave_size) // mult) * mult
    waves = []
    start = 0
    while start < max_trajectories:
        live = min(bucket, max_trajectories - start)
        waves.append((start, live))
        start += live
    return waves, bucket


def _kraus_stack(ops) -> np.ndarray:
    return np.stack([np.asarray(m, dtype=np.complex128) for m in ops])


def _effect_stack(stack: np.ndarray) -> np.ndarray:
    """``E_j = K_j^dag K_j`` for a ``(..., K, d, d)`` stack."""
    return np.einsum("...kba,...kbc->...kac", stack.conj(), stack)


def _gate_item(op) -> tuple:
    """The walker's tuple for a recorded gate: ``(kind, targets, matrix or
    params -> matrix, masks)``, kinds ``u``/``u_fn``/``diag``/``diag_fn``."""
    if op.kind == "u":
        if op.mat_fn is not None:
            return ("u_fn", op.targets, op.mat_fn,
                    (op.ctrl_mask, op.flip_mask))
        return ("u", op.targets, op.mat, (op.ctrl_mask, op.flip_mask))
    if op.diag_fn is not None:
        return ("diag_fn", op.targets, op.diag_fn, None)
    return ("diag", op.targets, op.diag, None)


def _stacked(kraus_fn):
    """A parameterized channel's ``params -> [K_k]`` as ``params -> (K, d,
    d)`` complex128 tensor."""
    return lambda p: torch.stack([torch.as_tensor(m, dtype=torch.complex128)
                                  for m in kraus_fn(p)])


def _branch_operators(ks: torch.Tensor, j: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Each trajectory's drawn operator times its scale: ``(T, d, d)`` from
    a ``(K, d, d)`` stack shared by the batch or a ``(T, K, d, d)`` one."""
    rows = torch.arange(j.shape[0], device=j.device)
    sel = ks[j] if ks.dim() == 3 else ks[rows, j]
    return sel * scale[:, None, None].to(sel.dtype)


def _drawn(probs: torch.Tensor, j: torch.Tensor) -> tuple:
    """``(j, p_j, 1/sqrt(p_j))`` of every trajectory, the scale by the
    draw's rule (:func:`~quest_tpu_torch.ops.kraus_kernel.draw_plain`)."""
    psel = probs.gather(1, j[:, None])[:, 0]
    tiny = torch.finfo(psel.dtype).tiny
    return j, psel, 1.0 / torch.sqrt(torch.clamp(psel, min=tiny))


def _one_hot(psel: torch.Tensor, j: torch.Tensor, num_ops: int):
    """``(T, K)`` probabilities holding each trajectory's recorded ``p_j``
    at its branch and 0 elsewhere. The fused Kraus kernel's draw at ``u =
    0`` then skips the leading zeros and stops at ``j`` (``cum = p_j > 0
    = uu``), and scales by ``1/sqrt(p_j)``: the recorded operator,
    replayed with no second draw."""
    p = torch.zeros((psel.shape[0], num_ops), dtype=psel.dtype,
                    device=psel.device)
    return p.scatter_(1, j[:, None], psel[:, None])


def _rows_unitary(states: torch.Tensor, num_qubits: int, u, targets,
                  ctrl_mask: int = 0, flip_mask: int = 0) -> None:
    """:func:`~quest_tpu_torch.core.apply.apply_unitary` on the batch IN
    PLACE, in groups of ``_ROW_GROUP`` rows (a ``(T, d, d)`` operator
    stack split with them). The gate engine's GEMMs pick their kernel, and
    so their rounding, by the batch count: in fixed groups a row's result
    does not depend on how many rows run, so a mesh shard's sub-batch
    gives one device's planes bit for bit."""
    if not isinstance(u, torch.Tensor):
        # on the device once for every group
        cdtype = torch.complex64 if states.dtype == torch.float32 \
            else torch.complex128
        u = torch.as_tensor(np.asarray(u, dtype=np.complex128)).to(
            device=states.device, dtype=cdtype)
    per_row = u.dim() == 3
    for r0 in range(0, states.shape[0], _ROW_GROUP):
        g = slice(r0, r0 + _ROW_GROUP)
        apply_unitary(states[g], num_qubits, u[g] if per_row else u,
                      targets, ctrl_mask, flip_mask)


def _cross_density(lam: torch.Tensor, psi: torch.Tensor, num_qubits: int,
                   targets, ctrl_mask: int = 0, flip_mask: int = 0):
    """``M[t, a, b] = sum conj(lam_t[a, r]) psi_t[b, r]`` over the other
    qubits ``r`` (inside the control subspace of ``ctrl_mask``/``flip_mask``,
    whose semantics are the gate engine's), ``a`` and ``b`` indexing the
    targets (bit ``j`` is ``targets[j]``): the ``(T, d, d)`` real and
    imaginary parts of the targets' cross density of two ``(T, 2, 2^n)``
    batches, in float64. ``Re <lam, G_ctrl psi> = Re sum_ab G_ab M_ab``
    for any operator ``G`` on the targets, so one such pass gives every
    derivative of an item. Reduced as :meth:`TrajectoryProgram.
    _channel_probs` reduces: by groups of rows and blocks of the lowest
    other qubits, the blocks summed in float64 (one float32 reduction over
    a 22-qubit state leaves ~1e-5 of a gradient's largest component to
    rounding)."""
    n = num_qubits
    k = len(targets)
    num_traj = psi.shape[0]
    controls = [q for q in range(n) if (ctrl_mask >> q) & 1]
    front = [2 + n - 1 - targets[j] for j in reversed(range(k))]
    ctrl = [2 + n - 1 - c for c in controls]
    rest = [2 + a for a in range(n) if 2 + a not in front + ctrl]
    pick = tuple(0 if (flip_mask >> c) & 1 else 1 for c in controls)
    low = min(_PROB_BLOCK_BITS, len(rest))
    high = rest[:len(rest) - low]
    order = [0] + high + [1] + ctrl + front + rest[len(rest) - low:]
    d = 1 << k

    def gathered(x, g):
        v = x[g].view((-1, 2) + (2,) * n).permute(order)
        if controls:
            v = v[(slice(None),) * (len(high) + 2) + pick]
        return v.reshape(v.shape[0], 1 << len(high), 2 * d, 1 << low)

    m_re, m_im = [], []
    for r0 in range(0, num_traj, _ROW_GROUP):
        g = slice(r0, r0 + _ROW_GROUP)
        # one batched product over both planes: blocks [[ar br, ar bi],
        # [ai br, ai bi]], and conj(a) b = ar br + ai bi + i (ar bi - ai br)
        blocks = torch.matmul(gathered(lam, g), gathered(psi, g)
                              .transpose(-1, -2)).double().sum(1)
        m_re.append(blocks[:, :d, :d] + blocks[:, d:, d:])
        m_im.append(blocks[:, :d, d:] - blocks[:, d:, :d])
    return torch.cat(m_re), torch.cat(m_im)


def _add_derivative(grads: torch.Tensor, col: int, g, m) -> None:
    """``grads[:, col] += 2 Re sum_ab G_ab M_ab`` (:func:`_cross_density`'s
    ``M``; ``G`` shared ``(d, d)`` or ``(T, d, d)``, numpy or a device
    tensor): the score-corrected gradient's ``2 Re <lam, G psi>``."""
    m_re, m_im = m
    g = torch.as_tensor(g)
    g_re = g.real.to(device=m_re.device, dtype=torch.float64)
    g_im = g.imag.to(device=m_re.device, dtype=torch.float64)
    dot = (g_re * m_re.double()).sum((-2, -1)) \
        - (g_im * m_im.double()).sum((-2, -1))
    grads[:, col] += 2.0 * dot


class _Tape:
    """What the gradient walk's forward keeps for its reverse: per channel
    (by channel number) each trajectory's ``(j, p_j, 1/sqrt(p_j))``, and the
    states entering the non-unitary items (by item index) while they fit
    in ``store_bytes``."""

    def __init__(self, store_bytes: int):
        self.store_bytes = store_bytes
        self.draws: dict = {}
        self.stored: dict = {}

    def keep(self, k: int, states: torch.Tensor) -> None:
        size = states.numel() * states.element_size()
        if (len(self.stored) + 1) * size <= self.store_bytes:
            self.stored[k] = states.clone()


def _reset_trajectory_twin(tw) -> None:
    """A shard's twin runs its rows as one device runs them and keeps its
    own dispatch record."""
    tw._walk = None
    tw._batch_stats = {}


class TrajectoryProgram:
    """A recorded circuit lowered to a stochastic pure-state program.

    Unitary and diagonal ops apply as in the deterministic path; each Kraus
    channel consumes one uniform per trajectory. Parameterized gates and
    channels (Param strengths, callable Kraus sets) bind at call time.
    Batch with :meth:`trajectory_sweep` / :meth:`run_batch`; estimate
    observables with :meth:`expectation` (waves, early stopping). On a
    mesh env the waves shard by the priced policy (:meth:`_policy`): whole
    states per shard, or every trajectory spanning the shards' chunks
    (:mod:`quest_tpu_torch.parallel.trajectories`).
    """

    tier = None          # trajectory dispatches run at the env precision
    is_density = False   # pure states at statevector cost

    def __init__(self, circuit, env, pallas=None):
        """``pallas`` as in ``Circuit.compile``: None or True runs static
        gate runs through the batched layer kernel and lane channels
        through the fused Kraus kernel; False runs every item through the
        plain walker; ``"interpret"`` the kernels' plain versions on a CPU
        env (it raises on the card)."""
        from ..circuits import _layers_on, _peephole_fused

        self.env = env
        self.circuit = circuit
        self.num_qubits = circuit.num_qubits
        self.param_names = tuple(circuit.param_names)
        self._pallas = pallas
        fused = _peephole_fused(circuit.ops)
        ops = []
        n_channels = 0
        for op in fused:
            if op.kind == "kraus":
                if callable(op.kraus):
                    # built from the bound strengths at run time; no CPTP
                    # validation is possible for a function
                    ops.append(("kraus_fn", op.targets, op.kraus,
                                n_channels))
                else:
                    val.validate_kraus_ops(op.kraus, len(op.targets),
                                           "TrajectoryProgram",
                                           env.precision.eps)
                    stack = _kraus_stack(op.kraus)
                    ops.append(("kraus", op.targets,
                                (stack, _effect_stack(stack)), n_channels))
                n_channels += 1
            else:
                ops.append(_gate_item(op))
        self._ops = ops
        self.num_channels = n_channels
        self._items = self._build_kernel_items(fused) \
            if self.num_qubits >= lk.LANE_QUBITS and _layers_on(pallas, env) \
            else list(ops)
        # the gradient walk un-computes these items by their adjoints;
        # channels (and any non-unitary gate) take their stored input
        self._unitary = [self._item_unitary(item) for item in self._items]
        self._adjoint_ops: Optional[dict] = None
        self._last_traj_stats: dict = {}
        self._batch_stats: dict = {}
        # the mesh: the priced policy's comm model (made at its first
        # use), the walk over the chunks (amp mode) and the pad-and-mask
        # warning latch (parallel/shards.py)
        self._stats_lock = threading.Lock()
        self._warned_nondivisible = False
        self._cost_model_cached = False
        self._cost_model = None
        self._host_bits = 0
        self._walk = None
        if self._on_mesh:
            from ..parallel.multihost import host_topology
            topo = host_topology(env.mesh)
            shard_bits = env.num_devices.bit_length() - 1
            self._host_bits = min(topo.host_bits, shard_bits) if topo \
                else 0

    def _build_kernel_items(self, fused_ops):
        """The item stream of the batched walker: ``("layer", LayerOp)`` for
        fused static runs, ``("kraus_fused", targets, (stack, estack,
        lane-embedded stack), idx)`` for static channels on lane qubits,
        the plain op tuples otherwise. Channel order (and so the column of
        each channel's uniforms) is the order of ``self._ops``."""
        from ..circuits import _collect_layers
        n = self.num_qubits
        layered = _collect_layers(list(fused_ops), n, lk.tile_rows_for(
            self.env.precision.real_dtype))
        channels = iter(t for t in self._ops
                        if t[0] in ("kraus", "kraus_fn"))
        items = []
        for op in layered:
            if op.kind == "layer":
                items.append(("layer", op))
            elif op.kind == "kraus":
                t = next(channels)
                if t[0] == "kraus" and all(q < lk.LANE_QUBITS
                                           for q in t[1]):
                    stack, estack = t[2]
                    kemb = np.stack([lk.embed_lane_matrix(k, t[1])
                                     for k in stack])
                    items.append(("kraus_fused", t[1],
                                  (stack, estack, kemb), t[3]))
                else:
                    items.append(t)
            else:
                items.append(_gate_item(op))
        return items

    # -- the batched walker --------------------------------------------------

    def _channel_probs(self, states: torch.Tensor, targets,
                       estack: torch.Tensor, num_qubits: Optional[int] = None,
                       exact: bool = False) -> torch.Tensor:
        """``p_j = <psi| E_j |psi> = tr(E_j rho_T)`` for every trajectory:
        each trajectory's ``2^t x 2^t`` reduced density of the targets (a
        ``torch.matmul``), then every probability a small trace against
        the ``E_j`` stack (``(K, d, d)``, or ``(T, K, d, d)`` for a per-row
        channel). ``(T, K)`` in the plane dtype, or (``exact``) in float64
        unrounded. ``num_qubits``: the qubits ``states`` hold (a chunk's
        local qubits on a mesh, whose call is one chunk's partial sum;
        default the program's).

        The reductions run in fixed groups of rows, each over blocks of
        the ``_PROB_BLOCK_BITS`` lowest other qubits in the plane dtype
        (one batched GEMM of short reductions), the blocks summed in
        float64. A float32 reduction over a whole 22-qubit state would
        leave its result ~1e-6 to rounding, which moved with the card's
        choice of GEMM kernel (by batch count and reduction length). With
        fixed groups of rows a mesh shard's sub-batch reduces as one
        device does. A state held as chunks keeps one device's blocks
        while its targets are local; a sharded target swapped onto a low
        local position (``parallel/trajectories.py``) moves a qubit out of
        the blocks, so its blocks group the amplitudes otherwise and its
        probabilities can differ from one device's by an ulp: the draws
        are then equal except where a uniform falls within that ulp of a
        branch boundary."""
        n = self.num_qubits if num_qubits is None else num_qubits
        k = len(targets)
        num_traj = states.shape[0]
        # bit j of the gathered index is targets[j]
        front = [2 + n - 1 - targets[j] for j in reversed(range(k))]
        rest = [2 + a for a in range(n) if 2 + a not in front]
        # the other qubits split into blocks of the lowest ones, the same
        # blocks whether the state is whole or a mesh's chunk: (row,
        # block, plane, target index, in-block index)
        low = min(_PROB_BLOCK_BITS, len(rest))
        view = states.view((num_traj, 2) + (2,) * n).permute(
            [0] + rest[:len(rest) - low] + [1] + front
            + rest[len(rest) - low:])
        blocks = 1 << (len(rest) - low)
        er = estack.real.to(torch.float64)
        ei = estack.imag.to(torch.float64)
        shared = estack.dim() == 3
        eq = "kab,tba->tk" if shared else "tkab,tba->tk"
        parts = []
        for r0 in range(0, num_traj, _ROW_GROUP):
            g = slice(r0, r0 + _ROW_GROUP)
            a = view[g].reshape(-1, blocks, 2, 1 << k, 1 << low)
            ar, ai = a[:, :, 0], a[:, :, 1]
            ar_t, ai_t = ar.transpose(-1, -2), ai.transpose(-1, -2)
            # each block's reduced density, then the blocks summed in
            # float64
            rho_r = (torch.matmul(ar, ar_t)
                     + torch.matmul(ai, ai_t)).double().sum(1)
            rho_i = (torch.matmul(ai, ar_t)
                     - torch.matmul(ar, ai_t)).double().sum(1)
            del a, ar, ai, ar_t, ai_t
            parts.append(
                torch.einsum(eq, er if shared else er[g], rho_r)
                - torch.einsum(eq, ei if shared else ei[g], rho_i))
        probs = torch.cat(parts)
        return probs if exact else probs.to(states.dtype)

    def _operators(self, data, kind, pm: np.ndarray):
        """The channel's Kraus stack and effect stack as complex device
        tensors: ``(K, d, d)``, or ``(T, K, d, d)`` when a parameterized
        channel binds differently per row."""
        if kind == "kraus":
            stack, estack = data[0], data[1]
        else:
            stack = bind_rows(_stacked(data), self.param_names, pm)
            estack = _effect_stack(stack)
        cdtype = self.env.precision.complex_dtype
        return (torch.as_tensor(stack, dtype=cdtype, device=self.env.device),
                torch.as_tensor(estack, dtype=cdtype,
                                device=self.env.device))

    def _apply_batch(self, states: torch.Tensor, uniforms: torch.Tensor,
                     pm: np.ndarray, tape: Optional[_Tape] = None
                     ) -> torch.Tensor:
        """Advance the ``(T, 2, 2^n)`` batch through the program IN PLACE.
        ``uniforms``: ``(T, num_channels)`` in the plane dtype on the
        device; ``pm``: the ``(T, P)`` host parameter rows. A ``tape``
        (the gradient walk's forward) records every channel's branches and
        keeps the states entering the non-unitary items."""
        for k, item in enumerate(self._items):
            if tape is not None and not self._unitary[k]:
                tape.keep(k, states)
            drawn = self._apply_item(states, item, uniforms, pm,
                                     tape is not None)
            if drawn is not None:
                tape.draws[item[3]] = drawn
        return states

    def _apply_item(self, states: torch.Tensor, item, uniforms, pm,
                    record: bool = False):
        """One item of the program on the batch, in place; a channel
        draws from its column of ``uniforms`` and, when ``record``, returns
        the branches it drew (:func:`_drawn`)."""
        n = self.num_qubits
        kind = item[0]
        if kind == "layer":
            lk.apply_layer_batched(states, n, item[1])
        elif kind == "kraus_fused":
            _, targets, (_, estack, kemb), idx = item
            es = torch.as_tensor(estack,
                                 dtype=self.env.precision.complex_dtype,
                                 device=states.device)
            probs = self._channel_probs(states, targets, es)
            index = torch.empty(states.shape[0], dtype=torch.int32,
                                device=states.device) if record else None
            kk.fused_kraus_apply_batched(
                states, n, kemb, probs, uniforms[:, idx].contiguous(), index)
            if record:
                return _drawn(probs, index.long())
        elif kind in ("kraus", "kraus_fn"):
            _, targets, data, idx = item
            ks, es = self._operators(data, kind, pm)
            probs = self._channel_probs(states, targets, es)
            j, scale = kk.draw_plain(probs, uniforms[:, idx])
            _rows_unitary(states, n, _branch_operators(ks, j, scale), targets)
            if record:
                return j, probs.gather(1, j[:, None])[:, 0], scale
        elif kind in ("u", "u_fn"):
            _, targets, data, (cmask, fmask) = item
            u = data if kind == "u" else bind_rows(data, self.param_names, pm)
            _rows_unitary(states, n, u, targets, cmask, fmask)
        else:
            _, targets, data, _ = item
            d = data if kind == "diag" \
                else bind_rows(data, self.param_names, pm)
            apply_diagonal(states, n, targets, d)
        return None

    def _replay(self, states: torch.Tensor, pm: np.ndarray, draws: dict,
                first: int = 0, stop: Optional[int] = None) -> torch.Tensor:
        """Items ``first`` to ``stop`` of the program on the batch, IN
        PLACE, every channel applying its RECORDED operator ``K_j /
        sqrt(p_j)`` from ``draws`` (a tape's): a fused channel through the
        fused Kraus kernel with one-hot probabilities (:func:`_one_hot`),
        any other through the gate engine. Nothing is drawn."""
        n = self.num_qubits
        for item in self._items[first:stop]:
            kind = item[0]
            if kind not in ("kraus_fused", "kraus", "kraus_fn"):
                self._apply_item(states, item, None, pm)
                continue
            _, targets, data, idx = item
            j, psel, scale = draws[idx]
            if kind == "kraus_fused":
                kk.fused_kraus_apply_batched(
                    states, n, data[2], _one_hot(psel, j, len(data[2])),
                    torch.zeros_like(psel))
            else:
                ks, _ = self._operators(data, kind, pm)
                _rows_unitary(states, n, _branch_operators(ks, j, scale),
                              targets)
        return states

    # -- the gradient walk ---------------------------------------------------

    @staticmethod
    def _item_unitary(item) -> bool:
        kind = item[0]
        if kind == "layer":
            return is_unitary(item[1])
        if kind == "u":
            return unitary_matrix(item[2])
        if kind == "diag":
            return unit_modulus(item[2])
        return kind in ("u_fn", "diag_fn")

    def _adjoints(self) -> dict:
        """Per item index, what the reverse applies for a static item: a
        layer's adjoint layer (packed at its first launch), a gate's
        conjugate transpose, a diagonal's conjugate, a fused channel's
        lane-embedded stack of ``K_k^dag``. Made once, at the first
        gradient wave."""
        if self._adjoint_ops is None:
            ops = {}
            for k, item in enumerate(self._items):
                kind = item[0]
                if kind == "layer":
                    ops[k] = lk.adjoint_layer(item[1])
                elif kind == "u":
                    ops[k] = np.conj(np.asarray(item[2],
                                                dtype=np.complex128)).T
                elif kind == "diag":
                    ops[k] = np.conj(np.asarray(item[2]))
                elif kind == "kraus_fused":
                    ops[k] = np.ascontiguousarray(
                        np.conj(item[2][2]).transpose(0, 2, 1))
            self._adjoint_ops = ops
        return self._adjoint_ops

    # the bytes of states a gradient wave may keep at the inputs of its
    # channels; None sizes it from the device's free memory
    _grad_store_bytes: Optional[int] = None
    # the host's share when the walk runs on the CPU
    _CPU_STORE_BYTES = 4 << 30

    def _store_bytes(self, num_traj: int, dtype: torch.dtype) -> int:
        """What a gradient wave of ``num_traj`` trajectories may keep of
        the states entering its channels: on the card its free memory less
        eight batches (the stacked pair, a derivative batch and the gate
        engine's temporaries on the pair), on the CPU a fixed share."""
        if self._grad_store_bytes is not None:
            return int(self._grad_store_bytes)
        device = self.env.device
        if device.type != "cuda":
            return self._CPU_STORE_BYTES
        free = torch.cuda.mem_get_info(device)[0] \
            + torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        state = num_traj * 2 * (1 << self.num_qubits) * dtype.itemsize
        return max(0, free - 8 * state)

    def _derivatives(self, fn, pm: np.ndarray, what: str):
        """``fn`` (a parametrised op's ``params -> operator``) and its
        derivative in each parameter it reads
        (:func:`~quest_tpu_torch.ops.adjoint.bind_with_derivatives`), bound
        once per distinct row of ``pm``: ``(values, [(column,
        derivative)], shared)``, one array for the batch when every row
        binds the same values (``shared``), else one per row."""
        uniq, inverse = np.unique(pm, axis=0, return_inverse=True)
        values, derivs = bind_with_derivatives(fn, self.param_names, uniq,
                                               what)
        shared = len(uniq) == 1
        rows = 0 if shared else np.reshape(inverse, -1)
        return values[rows], [(c, d[rows]) for c, d in derivs], shared

    def _restore(self, psi: torch.Tensor, k: int, tape: _Tape,
                 start: torch.Tensor, pm: np.ndarray) -> None:
        """``psi`` <- the states entering item ``k``: its stored copy, or
        replayed with the recorded branches from the nearest stored state
        before it (or the start)."""
        if k in tape.stored:
            psi.copy_(tape.stored.pop(k))
            return
        base = max((i for i in tape.stored if i < k), default=None)
        psi.copy_(start if base is None else tape.stored[base])
        self._replay(psi, pm, tape.draws, 0 if base is None else base, k)

    def _reverse_param_gate(self, item, pair: torch.Tensor, grads,
                            pm: np.ndarray) -> None:
        """A ``u_fn``/``diag_fn`` item backwards: for each parameter it
        reads, ``grads[:, col] += 2 Re <lam, dU psi_in>`` with ``dU psi_in
        = (dU U^dag) psi_out``; then ``U^dag`` on states and cotangents."""
        n = self.num_qubits
        num_traj = grads.shape[0]
        psi, lam = pair[:num_traj], pair[num_traj:]
        kind, targets, fn, masks = item
        values, derivs, shared = self._derivatives(
            fn, pm, f"the parameter op on qubits {tuple(targets)}")
        if kind == "u_fn":
            cmask, fmask = masks
            adjoint = np.conj(np.swapaxes(values, -1, -2))

            def apply(states, m):
                apply_unitary(states, n, m, targets, cmask, fmask)
        else:
            cmask = 0
            adjoint = np.conj(values)

            def apply(states, m):
                apply_diagonal(states, n, targets, m)
        if derivs:
            # the targets ordered as the operator's axes: a diagonal's
            # axis i is the i-th qubit sorted descending, so its flat index
            # has the largest qubit as its top bit
            order = targets if kind == "u_fn" else sorted(targets)
            m = _cross_density(lam, psi, n, order, cmask,
                               masks[1] if kind == "u_fn" else 0)
        for col, d in derivs:
            # dU psi_in = (dU U^dag) psi_out
            if kind == "u_fn":
                g = d @ adjoint
            else:
                g = d * adjoint
                g = np.einsum("...i,ij->...ij", g.reshape(
                    g.shape[:g.ndim - len(targets)] + (-1,)),
                    np.eye(1 << len(targets)))
            _add_derivative(grads, col, g, m)
        apply(pair, adjoint if shared else np.concatenate([adjoint, adjoint]))

    def _reverse_channel(self, k: int, item, pair: torch.Tensor, grads,
                         pm: np.ndarray, tape: _Tape) -> None:
        """A channel backwards, its input restored in ``psi``: a
        parameterized channel adds ``2 Re <lam, (dK_j / sqrt(p_j))
        psi_in>`` per parameter it reads, then ``lam <- (K_j /
        sqrt(p_j))^dag lam`` per trajectory — for a fused channel one
        launch of the fused Kraus kernel over the cotangents with the
        stack of ``K_k^dag`` and one-hot probabilities."""
        n = self.num_qubits
        num_traj = grads.shape[0]
        psi, lam = pair[:num_traj], pair[num_traj:]
        kind, targets, data, idx = item
        j, psel, scale = tape.draws[idx]
        if kind == "kraus_fused":
            kk.fused_kraus_apply_batched(
                lam, n, self._adjoints()[k], _one_hot(psel, j, len(data[2])),
                torch.zeros_like(psel))
            return
        ks, _ = self._operators(data, kind, pm)

        if kind == "kraus_fn":
            _, derivs, _ = self._derivatives(
                _stacked(data), pm,
                f"the parameter channel on qubits {tuple(targets)}")
            m = _cross_density(lam, psi, n, targets) if derivs else None
            for col, d in derivs:
                dk = torch.as_tensor(d, dtype=ks.dtype, device=ks.device)
                _add_derivative(grads, col, _branch_operators(dk, j, scale),
                                m)
        op = _branch_operators(ks, j, scale)
        apply_unitary(lam, n, op.conj().transpose(-1, -2).resolve_conj(),
                      targets)

    def _grad_rows(self, start: torch.Tensor, uniforms: torch.Tensor,
                   pm: np.ndarray, baseline: torch.Tensor, operands):
        """One gradient wave of ``T`` trajectories from the shared ``(2,
        2^n)`` start planes, with ``(T, C)`` uniforms, ``(T, P)`` host
        parameter rows, a ``(T,)`` baseline ``b`` in the plane dtype and
        the Pauli sum's operands (:func:`~quest_tpu_torch.ops.reductions.
        pauli_terms_operands`). Returns ``(values, grads, tape)``: the
        ``(T,)`` values, bit for bit the value path's; the float64 ``(T,
        P)`` gradients ``2 Re <(H - b) psi, d psi~> / sqrt(N)``, each
        trajectory's score-corrected gradient; and the forward's
        :class:`_Tape` (its branches)."""
        num_traj = pm.shape[0]
        xm, ym, zm, cf = operands
        tape = _Tape(self._store_bytes(num_traj, start.dtype))
        pair = start.new_empty((2 * num_traj,) + tuple(start.shape))
        psi, lam = pair[:num_traj], pair[num_traj:]
        psi.copy_(start)
        self._apply_batch(psi, uniforms.to(device=start.device,
                                           dtype=start.dtype), pm, tape)
        values = red.pauli_sum_total_sv(psi, xm, ym, zm, cf)
        red.pauli_sum_apply(psi, xm, ym, zm, cf, out=lam)
        lam.addcmul_(psi, baseline.view(-1, 1, 1), value=-1.0)
        grads = torch.zeros((num_traj, len(self.param_names)),
                            dtype=torch.float64, device=start.device)
        adjoints = self._adjoints()
        n = self.num_qubits
        for k in reversed(range(len(self._items))):
            item = self._items[k]
            kind = item[0]
            if not self._unitary[k]:
                self._restore(psi, k, tape, start, pm)
            target = pair if self._unitary[k] else lam
            if kind == "layer":
                lk.apply_layer_batched(target, n, adjoints[k])
            elif kind == "u":
                _, targets, _, (cmask, fmask) = item
                apply_unitary(target, n, adjoints[k], targets, cmask, fmask)
            elif kind == "diag":
                apply_diagonal(target, n, item[1], adjoints[k])
            elif kind in ("u_fn", "diag_fn"):
                self._reverse_param_gate(item, pair, grads, pm)
            else:
                self._reverse_channel(k, item, pair, grads, pm, tape)
        return values, grads, tape

    # -- the mesh: sharding policy and modes ---------------------------------

    @property
    def _on_mesh(self) -> bool:
        return self.env.mesh is not None and self.env.num_devices > 1

    def _comm_model(self):
        if not self._cost_model_cached:
            from ..profiling import comm_model
            self._cost_model = comm_model(self.env) if self._on_mesh \
                else None
            self._cost_model_cached = True
        return self._cost_model

    def _policy(self, batch: int, mem_factor: float = 1.0) -> dict:
        """The priced sharding decision for a ``batch``-trajectory wave
        (:func:`quest_tpu_torch.parallel.layout.choose_batch_sharding`):
        trajectory-parallel while the replicated working set fits,
        amplitude-sharded past the wall, with the amp mode's exchanges
        counted by :func:`~quest_tpu_torch.parallel.layout.
        traj_cross_shard_ops`. ``mem_factor=2.0`` is the gradient waves'
        pricing (the state and the cotangent live together through the
        reverse walk)."""
        if not self._on_mesh:
            return {"mode": "none"}
        from ..parallel.layout import (choose_batch_sharding,
                                       traj_cross_shard_ops)
        paired = [targets for kind, targets, _, _ in self._ops
                  if not kind.startswith("diag")]
        est = traj_cross_shard_ops(paired, self.num_qubits,
                                   self.env.num_devices)
        return choose_batch_sharding(
            self.num_qubits, batch, self.env.num_devices,
            self.env.precision.real_dtype.itemsize, est,
            cost_model=self._comm_model(), host_bits=self._host_bits,
            mem_factor=mem_factor)

    def _device_multiple(self) -> int:
        return self.env.num_devices if self._on_mesh else 1

    def _resolve_mode(self, batch: int, shard_trajectories,
                      mem_factor: float = 1.0) -> str:
        """``shard_trajectories``: None -> the priced policy; True -> force
        trajectory-parallel (a mesh is required); False -> force unsharded
        (the first shard's device runs the whole wave)."""
        if shard_trajectories is True:
            if not self._on_mesh:
                raise ValueError(
                    "shard_trajectories needs a multi-device mesh env")
            return "batch"
        if shard_trajectories is False:
            return "none"
        mode = self._policy(batch, mem_factor=mem_factor)["mode"]
        if mode == "amp" and (1 << self.num_qubits) < self.env.num_devices:
            raise ValueError(
                f"a {self.num_qubits}-qubit state cannot span the "
                f"{self.env.num_devices}-shard mesh")
        return mode

    def _shard_twin(self, d: int) -> "TrajectoryProgram":
        """This program as it runs on shard ``d``'s device alone (``batch``
        mode, :func:`~quest_tpu_torch.parallel.shards.shard_twin`): it
        shares the program's items and their packed layers."""
        from ..parallel.shards import shard_twin
        return shard_twin(self, d, _reset_trajectory_twin)

    def _mesh_walk(self):
        """The walk over the mesh's chunks (``amp`` mode), built at its
        first use (:func:`quest_tpu_torch.parallel.trajectories.
        build_walk`)."""
        if self._walk is None:
            from ..parallel.trajectories import build_walk
            self._walk = build_walk(self, self._pallas)
        return self._walk

    def _on_shards(self, run, start: torch.Tensor, uniforms: torch.Tensor,
                   pm_rows: np.ndarray, *per_row):
        """``batch`` mode: the wave's rows split over the shards in shard
        order, ``run(twin, start, uniforms, pm_rows, *per_row)`` on each
        shard's one-device twin (the start planes and every ``per_row``
        tensor on its device), and the outputs (a tensor or a tuple of
        them) joined on the env's device. A wave the mesh does not divide
        is padded by :func:`~quest_tpu_torch.parallel.shards.split_rows`
        and the extra rows' results dropped: the first ``T`` rows are the
        caller's, so every draw is the one the unpadded wave makes."""
        from ..parallel.shards import split_rows
        num = pm_rows.shape[0]
        per, (uniforms, pm_rows, *per_row) = split_rows(
            self, "trajectory batch", num, uniforms, pm_rows, *per_row)
        outs = []
        for d in range(self.env.num_devices):
            tw = self._shard_twin(d)
            dev = tw.env.device
            rows = slice(d * per, (d + 1) * per)
            out = run(tw, start.to(dev), uniforms[rows], pm_rows[rows],
                      *(t[rows].to(dev) for t in per_row))
            outs.append(out if isinstance(out, tuple) else (out,))
        joined = tuple(torch.cat([o[k].to(start.device) for o in outs])[:num]
                       for k in range(len(outs[0])))
        return joined if len(joined) > 1 else joined[0]

    def _run_mode(self, mode: str, start: torch.Tensor,
                  uniforms: torch.Tensor, pm_rows: np.ndarray):
        """The ``(T, 2, 2^n)`` planes of a wave in ``mode`` on the env's
        device: whole states per shard (``batch``), the mesh's chunks
        joined (``amp``), or one device (``none``)."""
        if mode == "none":
            return self._run_rows(start, uniforms, pm_rows)
        if mode == "amp":
            u = uniforms.to(device=start.device, dtype=start.dtype)
            return torch.cat([c.to(start.device) for c in
                              self._mesh_walk().wave(u).run_rows(start,
                                                                 pm_rows)],
                             dim=-1)
        return self._on_shards(
            lambda tw, *args: tw._run_rows(*args), start, uniforms, pm_rows)

    def _wave_values(self, mode: str, start: torch.Tensor,
                     uniforms: torch.Tensor, pm_rows: np.ndarray,
                     operands) -> torch.Tensor:
        """The ``(T,)`` Pauli-sum values of one wave in ``mode``, in the
        plane dtype on the env's device: each shard reduces its own rows
        (``batch``), the chunks' partial sums combine in float64 (``amp``)."""
        xm, ym, zm, cf = operands
        if mode == "amp":
            from ..parallel import chunks as chk
            u = uniforms.to(device=start.device, dtype=start.dtype)
            walk = self._mesh_walk()
            states = walk.wave(u).run_rows(start, pm_rows)
            return chk.pauli_total(states, walk.local, xm, ym, zm,
                                   cf).to(start.device, start.dtype)

        def values(tw, *args):
            return red.pauli_sum_total_sv(tw._run_rows(*args), xm, ym, zm,
                                          cf)

        if mode == "none":
            return values(self, start, uniforms, pm_rows)
        return self._on_shards(values, start, uniforms, pm_rows)

    def _wave_grads(self, mode: str, start: torch.Tensor,
                    uniforms: torch.Tensor, pm_rows: np.ndarray,
                    baseline: torch.Tensor, operands):
        """One gradient wave in ``mode``: ``(values, grads)`` as
        :meth:`_grad_rows` returns them, each shard walking its own rows
        (``batch``) or every trajectory spanning the chunks (``amp``, the
        adjoint walk of :class:`~quest_tpu_torch.parallel.trajectories.
        TrajectoryWalk`)."""
        if mode == "amp":
            from ..parallel import chunks as chk
            xm, ym, zm, cf = operands
            walk = self._mesh_walk()
            lt = walk.local

            def cotangent(psi, lam):
                chk.pauli_sum_apply(psi, lt, xm, ym, zm, cf, lam)
                for p, q in zip(psi, lam):
                    q.addcmul_(p, baseline.to(p.device).view(-1, 1, 1),
                               value=-1.0)

            vals, grads = walk.wave(
                uniforms.to(device=start.device, dtype=start.dtype)
            ).run_wave(
                start, pm_rows,
                lambda psi: chk.pauli_total(psi, lt, xm, ym, zm, cf),
                cotangent,
                self._store_bytes(pm_rows.shape[0], start.dtype))
            return vals.to(start.device, start.dtype), grads

        def wave(tw, start_d, u, rows, b):
            return tw._grad_rows(start_d, u, rows, b, operands)[:2]

        if mode == "none":
            return wave(self, start, uniforms, pm_rows, baseline)
        return self._on_shards(wave, start, uniforms, pm_rows, baseline)

    def _record_batch_stats(self, batch: int, mode: str,
                            host_syncs_avoided: int) -> None:
        with self._stats_lock:
            self._batch_stats = {"batch_size": batch,
                                 "batch_sharding_mode": mode,
                                 "host_syncs_avoided": host_syncs_avoided}

    # -- inputs --------------------------------------------------------------

    def _param_matrix(self, params) -> np.ndarray:
        """Name->value dict (or ordered vector) -> the ``(1, P)`` host
        parameter row; every declared name must bind."""
        if params is not None and not isinstance(params, dict):
            vec = np.asarray(params, dtype=np.float64)
            if vec.shape != (len(self.param_names),):
                raise ValueError(
                    f"parameter vector has shape {vec.shape}; expected "
                    f"({len(self.param_names)},) ordered like "
                    f"{list(self.param_names)}")
            return vec[None]
        params = params or {}
        missing = [p for p in self.param_names if p not in params]
        if missing:
            raise ValueError(f"missing circuit parameters: {missing}")
        return np.asarray([[float(params[nm]) for nm in self.param_names]],
                          dtype=np.float64).reshape(1, -1)

    def _start(self, state_f) -> torch.Tensor:
        """The ``(2, 2^n)`` start planes on the env's device: |0..0> or the
        caller's."""
        n = self.num_qubits
        dtype, device = self.env.precision.real_dtype, self.env.device
        if state_f is None:
            planes = torch.zeros((2, 1 << n), dtype=dtype, device=device)
            planes[0, 0] = 1.0
            return planes
        planes = torch.as_tensor(state_f).to(device=device, dtype=dtype)
        if tuple(planes.shape) != (2, 1 << n):
            raise ValueError(f"state_f must be (2, {1 << n}) planes; got "
                             f"{tuple(planes.shape)}")
        return planes

    def _generator(self, seed) -> torch.Generator:
        if seed is None:
            return self.env.generator
        g = torch.Generator(device="cpu")
        g.manual_seed(int(seed))
        return g

    def _draw_uniforms(self, generator: torch.Generator,
                       shape: tuple) -> torch.Tensor:
        """The up-front float64 block of channel uniforms, on the CPU."""
        return torch.rand(shape, generator=generator, dtype=torch.float64)

    def _given_uniforms(self, uniforms, shape: tuple) -> torch.Tensor:
        u = torch.as_tensor(np.asarray(uniforms, dtype=np.float64))
        if tuple(u.shape) != shape:
            raise ValueError(f"uniforms must have shape {shape} (trajectory, "
                             f"channel); got {tuple(u.shape)}")
        return u

    def _row_uniforms(self, uniforms) -> torch.Tensor:
        """One trajectory's uniforms (``(num_channels,)``, or the env's
        generator's when None) as the ``(1, num_channels)`` block."""
        shape = (1, self.num_channels)
        if uniforms is None:
            return self._draw_uniforms(self.env.generator, shape)
        u = np.asarray(uniforms, dtype=np.float64)
        if u.size != self.num_channels:
            raise ValueError(f"uniforms must hold one value per channel, "
                             f"({self.num_channels},); got shape {u.shape}")
        return self._given_uniforms(u.reshape(shape), shape)

    def _run_rows(self, start: torch.Tensor, uniforms: torch.Tensor,
                  pm_rows: np.ndarray) -> torch.Tensor:
        """Fresh ``(T, 2, 2^n)`` copies of ``start`` walked through the
        program with ``(T, C)`` uniforms and ``(T, P)`` parameter rows."""
        num_traj = pm_rows.shape[0]
        # a copy even for one trajectory, where contiguous() would alias
        states = start.expand(num_traj, 2, start.shape[1]).clone(
            memory_format=torch.contiguous_format)
        u = uniforms.to(device=states.device, dtype=states.dtype)
        return self._apply_batch(states, u, pm_rows)

    # -- execution -----------------------------------------------------------

    def apply(self, state_f, uniforms=None, params=None) -> torch.Tensor:
        """Pure form: ``(2, 2^n)`` packed planes -> new planes, one
        trajectory (the input is not changed). ``uniforms`` is its
        ``(num_channels,)`` row (default: drawn from the env's generator);
        ``params`` binds the circuit's Param gates and channels."""
        return self._run_rows(self._start(state_f),
                              self._row_uniforms(uniforms),
                              self._param_matrix(params))[0]

    def trajectory_sweep(self, num_trajectories: int, params=None,
                         state_f=None, uniforms=None,
                         shard_trajectories: Optional[bool] = None
                         ) -> torch.Tensor:
        """``num_trajectories`` independent draws from one start state
        (default |0..0>): the ``(T, 2, 2^n)`` planes on the env's device.
        ``uniforms``: the ``(T, num_channels)`` block to draw with (default:
        drawn from the env's generator).

        On a mesh env the trajectories shard by the priced policy
        (:meth:`_policy`): whole states per shard (``batch``) while the
        per-shard working set fits, every state spanning the shards'
        chunks (``amp``) past it. The uniforms decide every draw: each mode
        draws what one device draws, up to a uniform within an ulp of a
        branch boundary in ``amp`` mode (:meth:`_channel_probs`). A count the mesh does not divide
        is padded and masked, with one warning. ``shard_trajectories``
        overrides the policy (True forces ``batch``, False one device)."""
        num_traj = int(num_trajectories)
        if num_traj < 1:
            raise ValueError("num_trajectories must be >= 1")
        mode = self._resolve_mode(num_traj, shard_trajectories)
        pm = self._param_matrix(params)
        shape = (num_traj, self.num_channels)
        u = self._given_uniforms(uniforms, shape) if uniforms is not None \
            else self._draw_uniforms(self.env.generator, shape)
        out = self._run_mode(mode, self._start(state_f), u,
                             np.repeat(pm, num_traj, axis=0))
        self._record_batch_stats(num_traj, mode, num_traj - 1)
        return out

    def run_batch(self, state_f, num_trajectories: int, uniforms=None,
                  shard_trajectories: Optional[bool] = None,
                  params=None) -> torch.Tensor:
        """:meth:`trajectory_sweep` with the start state first."""
        return self.trajectory_sweep(num_trajectories, params=params,
                                     state_f=state_f, uniforms=uniforms,
                                     shard_trajectories=shard_trajectories)

    def run(self, qureg, params=None, uniforms=None) -> None:
        """One trajectory, in place on a state-vector register;
        ``uniforms`` is its ``(num_channels,)`` row (default: drawn from
        the env's generator)."""
        if qureg.is_density_matrix:
            raise ValueError("trajectory programs run on state-vector "
                             "registers")
        if qureg.num_qubits_represented != self.num_qubits:
            raise ValueError(
                f"program has {self.num_qubits} qubits; register has "
                f"{qureg.num_qubits_represented}")
        pm = self._param_matrix(params)
        u = self._row_uniforms(uniforms)
        states = qureg.state.unsqueeze(0)
        self._apply_batch(states, u.to(device=states.device,
                                       dtype=states.dtype), pm)

    # -- observables with early stopping --------------------------------------

    def expectation(self, pauli_terms, coeffs, state_f=None,
                    num_trajectories: int = None, *, params=None,
                    sampling_budget: Optional[float] = None,
                    wave_size: Optional[int] = None,
                    shard_trajectories: Optional[bool] = None,
                    seed: Optional[int] = None,
                    uniforms=None) -> tuple[float, float]:
        """Monte-Carlo estimate of ``<H>`` under the noisy evolution,
        ``H = sum_j coeffs[j] * prod Pauli`` (terms as ``(qubit, code)``
        pairs, codes 1=X 2=Y 3=Z). Returns ``(mean, stderr)``.

        The ensemble runs in WAVES of ``wave_size`` trajectories (default
        ``min(T, max(32, D))`` on a ``D``-shard mesh, rounded up to a
        multiple of ``D``; ``min(T, 32)`` off one); each wave's values
        fold into a device-resident running (count, mean, M2), and the
        wave's ONE device-to-host transfer is that triple.
        ``sampling_budget`` (a target standard
        error) stops the loop at the first wave that meets it. The uniforms
        are drawn up front from ``seed``'s generator (default the env's),
        or given as a ``(T, num_channels)`` block, so the stop decision is
        a function of the seed. The accounting lands in
        :attr:`last_traj_stats`. ``shard_trajectories`` as in
        :meth:`trajectory_sweep`."""
        if num_trajectories is None or int(num_trajectories) < 2:
            raise ValueError("expectation needs >= 2 trajectories for a "
                             "standard error")
        if sampling_budget is not None and sampling_budget <= 0.0:
            raise ValueError("sampling_budget is a target standard error "
                             "and must be > 0")
        terms = []
        for t in pauli_terms:
            term = tuple((int(q), int(code)) for q, code in t)
            for q, _ in term:
                val.validate_target(self.num_qubits, q,
                                    "TrajectoryProgram.expectation")
            val.validate_pauli_codes([code for _, code in term],
                                     "TrajectoryProgram.expectation")
            terms.append(tuple((q, c) for q, c in term if c != 0))
        if len(coeffs) != len(terms):
            raise ValueError(f"{len(terms)} pauli terms but {len(coeffs)} "
                             "coefficients")
        num_traj = int(num_trajectories)
        if uniforms is not None:
            uniforms = self._given_uniforms(
                uniforms, (num_traj, self.num_channels))[None]
        means, errs, _ = self._converge(
            self._param_matrix(params), terms, [float(c) for c in coeffs],
            state_f, num_traj, self._generator(seed), uniforms,
            sampling_budget=sampling_budget, wave_size=wave_size,
            shard_trajectories=shard_trajectories)
        return float(means[0]), float(errs[0])

    def expectation_batch(self, param_matrix, hamiltonian,
                          num_trajectories: int, *,
                          sampling_budget: Optional[float] = None,
                          wave_size: Optional[int] = None,
                          live_rows: Optional[int] = None, state_f=None,
                          progress=None, seed: Optional[int] = None):
        """The ``(B, T)`` form: one ensemble per parameter row, all rows
        advancing through shared waves (the serving runtime's
        ``kind="trajectory"`` dispatch). Early stopping waits for every
        live row (``live_rows`` leaves padded rows out of the decision).
        ``progress``, when given, is called after every wave with
        ``{"wave", "trajectories_run", "max_trajectories", "max_stderr"}``
        from the wave's existing host snapshot (no extra transfer); an
        exception it raises is swallowed. Returns ``(means, stderrs,
        info)`` with ``(B,)`` arrays."""
        pm = np.asarray(param_matrix, dtype=np.float64)
        if pm.ndim != 2 or pm.shape[1] != len(self.param_names):
            raise ValueError(
                f"param_matrix must be (batch, {len(self.param_names)}); "
                f"got {pm.shape}")
        if int(num_trajectories) < 2:
            raise ValueError("expectation needs >= 2 trajectories for a "
                             "standard error")
        terms, coeffs = red.validated_pauli_terms(*hamiltonian,
                                                  self.num_qubits)
        return self._converge(pm, terms, coeffs,
                              state_f, int(num_trajectories),
                              self._generator(seed), None,
                              sampling_budget=sampling_budget,
                              wave_size=wave_size, live_rows=live_rows,
                              progress=progress)

    _NO_PARAMS = ("this circuit declares no parameters; there is nothing "
                  "to differentiate (record angles via Circuit.parameter "
                  "/ Param placeholders)")

    def expectation_grad(self, pauli_terms, coeffs, state_f=None,
                         num_trajectories: int = None, *, params=None,
                         sampling_budget: Optional[float] = None,
                         wave_size: Optional[int] = None,
                         shard_trajectories: Optional[bool] = None,
                         seed: Optional[int] = None, uniforms=None):
        """Monte-Carlo estimate of ``<H>`` AND its parameter gradient under
        the noisy evolution, from one wave loop. Returns ``(value, grad,
        stderr)``: the energy, the ``(P,)`` gradient and the ``(P + 1,)``
        standard errors (component 0 the value's).

        Every trajectory's gradient carries the score-function correction
        (:func:`~quest_tpu_torch.ops.reductions.score_surrogate`, with the
        row's running mean over earlier waves as baseline), so the mean
        converges to the density-path gradient; it is computed by an
        adjoint walk over the wave (the module's docstring).
        ``sampling_budget`` stops the loop at the first wave where EVERY
        component's standard error fits. The uniforms are ``expectation``'s
        (``seed``, or a ``(T, num_channels)`` block), so the value is its
        mean bit for bit. On a mesh the waves are priced at twice the
        value path's memory (``mem_factor=2``); ``shard_trajectories`` as
        in :meth:`trajectory_sweep`."""
        if num_trajectories is None or int(num_trajectories) < 2:
            raise ValueError("expectation_grad needs >= 2 trajectories "
                             "for a standard error")
        if not self.param_names:
            raise ValueError(self._NO_PARAMS)
        terms, cfs = red.validated_pauli_terms(pauli_terms, coeffs,
                                               self.num_qubits)
        num_traj = int(num_trajectories)
        if uniforms is not None:
            uniforms = self._given_uniforms(
                uniforms, (num_traj, self.num_channels))[None]
        means, errs, _ = self._converge(
            self._param_matrix(params), terms, cfs, state_f, num_traj,
            self._generator(seed), uniforms, sampling_budget=sampling_budget,
            wave_size=wave_size, shard_trajectories=shard_trajectories,
            grad=True)
        return float(means[0, 0]), means[0, 1:], errs[0]

    def expectation_grad_batch(self, param_matrix, hamiltonian,
                               num_trajectories: int, *,
                               sampling_budget: Optional[float] = None,
                               wave_size: Optional[int] = None,
                               live_rows: Optional[int] = None,
                               state_f=None, progress=None,
                               seed: Optional[int] = None):
        """The ``(B, T)`` gradient form: one ensemble per parameter row,
        every row's value and gradient advancing through shared gradient
        waves; early stopping waits for every component of every live row.
        ``progress`` as in :meth:`expectation_batch`. Returns ``(values,
        grads, stderrs, info)``: ``(B,)``, ``(B, P)``,
        ``(B, P + 1)`` arrays and the loop's accounting (``info["kind"] ==
        "gradient"``)."""
        if not self.param_names:
            # before the shape check, which would report a (batch, 0) shape
            raise ValueError(self._NO_PARAMS)
        pm = np.asarray(param_matrix, dtype=np.float64)
        if pm.ndim != 2 or pm.shape[1] != len(self.param_names):
            raise ValueError(
                f"param_matrix must be (batch, {len(self.param_names)}); "
                f"got {pm.shape}")
        if int(num_trajectories) < 2:
            raise ValueError("expectation_grad needs >= 2 trajectories "
                             "for a standard error")
        terms, coeffs = red.validated_pauli_terms(*hamiltonian,
                                                  self.num_qubits)
        means, errs, info = self._converge(
            pm, terms, coeffs, state_f, int(num_trajectories),
            self._generator(seed), None, sampling_budget=sampling_budget,
            wave_size=wave_size, live_rows=live_rows, grad=True,
            progress=progress)
        return means[:, 0], means[:, 1:], errs, info

    def _converge(self, pm: np.ndarray, terms, coeffs, state_f,
                  max_trajectories: int, generator: torch.Generator,
                  uniforms, sampling_budget=None, wave_size=None,
                  live_rows=None, shard_trajectories=None,
                  grad: bool = False, progress=None):
        """The shared wave loop over ``(B, P)`` parameter rows. Row ``b``'s
        trajectory ``t`` uses uniform row ``uniforms[b, t]`` of one block
        drawn up front, so wave boundaries never change a draw.
        ``grad=True`` runs gradient waves (:meth:`_grad_rows`): a second
        running triple holds the ``P`` gradient components beside the
        value's, the stop decision needs every component's standard error
        to fit, and the returned means and stderrs are ``(B, P + 1)``.
        The value's triple is folded exactly as the value loop folds it.
        On a mesh every wave runs in the mode :meth:`_resolve_mode` picks
        for ``B * bucket`` rows (``mem_factor=2`` for gradients), the
        bucket a multiple of the mesh."""
        rows = pm.shape[0]
        live = rows if live_rows is None else max(1, min(int(live_rows),
                                                         rows))
        xm, ym, zm, cf = red.pauli_terms_operands(terms, coeffs,
                                                  self.num_qubits)
        num_channels = self.num_channels
        if uniforms is None:
            uniforms = self._draw_uniforms(
                generator, (rows, max_trajectories, num_channels))
        mult = self._device_multiple()
        wave = int(wave_size) if wave_size \
            else min(max_trajectories, max(32, mult))
        waves, bucket = plan_waves(max_trajectories, wave, mult)
        mode = self._resolve_mode(rows * bucket, shard_trajectories,
                                  mem_factor=2.0 if grad else 1.0)
        start = self._start(state_f)
        dtype, device = start.dtype, start.device
        pm_rows = np.repeat(pm, bucket, axis=0)
        num_params = len(self.param_names)
        carry = torch.zeros((3, rows), dtype=dtype, device=device)
        gcarry = torch.zeros((3, rows, num_params), dtype=dtype,
                             device=device) if grad else None
        run = 0
        waves_run = 0
        early = False
        snap = None
        stderr = np.full((rows, num_params + 1) if grad else (rows,), np.inf)
        for first, live_w in waves:
            u = uniforms[:, first:first + live_w]
            if live_w < bucket:
                # padded rows repeat the wave's first draw; the mask drops
                # them from the statistics
                u = torch.cat([u] + [u[:, :1]] * (bucket - live_w), dim=1)
            mask = torch.zeros((bucket,), dtype=dtype, device=device)
            mask[:live_w] = 1.0
            u = u.reshape(rows * bucket, num_channels)
            if grad:
                # the baseline: each row's running mean over earlier waves
                # (0 on the first), independent of this wave's draws
                vals, grads = self._wave_grads(
                    mode, start, u, pm_rows,
                    carry[1].repeat_interleave(bucket), (xm, ym, zm, cf))
            else:
                vals = self._wave_values(mode, start, u, pm_rows,
                                         (xm, ym, zm, cf))
            wave_stats = red.welford_wave(vals.view(rows, bucket), mask)
            carry = torch.stack(red.welford_merge(
                (carry[0], carry[1], carry[2]), wave_stats))
            if grad:
                g = grads.to(dtype).view(rows, bucket, num_params)
                gcarry = torch.stack(red.welford_merge(
                    (gcarry[0], gcarry[1], gcarry[2]),
                    red.welford_wave(g.transpose(1, 2), mask)))
                del grads, g
                both = torch.cat([carry.unsqueeze(-1), gcarry], dim=-1)
            run += live_w
            waves_run += 1
            # the wave's ONE transfer
            snap = (both if grad else carry).cpu().numpy()
            stderr = red.welford_stderr(snap[0], snap[2])
            if progress is not None:
                # the per-wave signal, from the wave's host snapshot
                try:
                    progress({"wave": int(waves_run),
                              "trajectories_run": int(run),
                              "max_trajectories": int(max_trajectories),
                              "max_stderr": float(np.max(stderr[:live]))})
                # a listener is caller code: one that fails must never
                # end the wave loop
                except Exception:
                    pass
            if sampling_budget is not None and \
                    np.all(snap[0][:live] >= 2.0) and \
                    np.all(stderr[:live] <= float(sampling_budget)):
                early = run < max_trajectories
                break
        info = {
            "max_trajectories": int(max_trajectories),
            "trajectories_run": int(run),
            "early_stopped": bool(early),
            "waves": int(waves_run),
            "wave_size": int(bucket),
            "batch_rows": int(rows),
            "sampling_budget": (float(sampling_budget)
                                if sampling_budget is not None else None),
            "max_stderr": float(np.max(stderr[:live])),
            "num_terms": len(terms),
            "kind": "gradient" if grad else "value",
        }
        self._last_traj_stats = dict(info)
        # one device-to-host transfer per wave, where a loop over the
        # trajectories would make one each
        self._record_batch_stats(rows * run, mode, rows * run - waves_run)
        return (np.asarray(snap[1], dtype=np.float64),
                np.asarray(stderr, dtype=np.float64), info)

    @property
    def last_traj_stats(self) -> dict:
        """Accounting of the most recent wave loop (``trajectories_run``,
        ``early_stopped``, waves, stderr, ``kind``)."""
        return dict(self._last_traj_stats)

    _digest_cached = None   # lazy program_digest (content-addressed)

    @property
    def program_digest(self) -> str:
        """Stable content digest of the recorded circuit
        (:func:`quest_tpu_torch.serve.warmcache.circuit_digest`, shared with
        :attr:`CompiledCircuit.program_digest`); for a static circuit it
        equals the JAX package's. A process-local id token when an op
        resists content addressing."""
        if self._digest_cached is None:
            from ..serve.warmcache import circuit_digest
            d = circuit_digest(self.circuit, False)
            self._digest_cached = d or f"id-{id(self):x}"
        return self._digest_cached

    def dispatch_stats(self):
        """Dispatch accounting (:class:`quest_tpu_torch.profiling.
        DispatchStats`): recorded ops in, program items out (after the
        peephole fusion), and the last batched call's trajectories and
        host transfers avoided (one per wave, not one per trajectory), and
        its sharding mode on a mesh (``"none"`` off one). The port keeps
        no executable cache, so its fields keep their defaults."""
        from ..profiling import DispatchStats
        with self._stats_lock:
            bs = dict(self._batch_stats)
        return DispatchStats(
            gates_in=len(self.circuit.ops),
            kernels_out=len(self._ops),
            relayouts=0,
            batch_size=bs.get("batch_size", 0),
            host_syncs_avoided=bs.get("host_syncs_avoided", 0),
            batch_sharding_mode=bs.get("batch_sharding_mode", "none"))

    # -- sampling / debug -----------------------------------------------------

    def sample(self, num_shots: int, num_trajectories: int, params=None,
               state_f=None, seed: Optional[int] = None, uniforms=None):
        """Basis samples from the noisy output MIXTURE: run the ensemble
        once, then draw ``num_shots`` outcomes stratified evenly over the
        trajectories (:func:`quest_tpu_torch.parallel.sampling.
        sample_mixture`). The channel uniforms are drawn first, then the
        shots, both from ``seed``'s generator (default the env's). Returns
        ``(indices int64 (num_shots,), totals (T,))``."""
        from ..parallel.sampling import sample_mixture
        if int(num_shots) < 1:
            raise ValueError("num_shots must be >= 1")
        num_traj = int(num_trajectories)
        generator = self._generator(seed)
        shape = (num_traj, self.num_channels)
        u = self._given_uniforms(uniforms, shape) if uniforms is not None \
            else self._draw_uniforms(generator, shape)
        planes = self.trajectory_sweep(num_traj, params=params,
                                       state_f=state_f, uniforms=u)
        return sample_mixture(planes, generator, int(num_shots))

    def average_density(self, state_f, num_trajectories: int, params=None,
                        uniforms=None) -> np.ndarray:
        """Monte-Carlo estimate of the channel-evolved density matrix, the
        mean of |psi><psi| over trajectories, MATERIALISED on the host
        (debug scale). Refuses above ``QUEST_TPU_DENSITY_DEBUG_QUBITS``
        (default 14) qubits with :class:`DensityMaterialisationError`."""
        limit = int(os.environ.get(DENSITY_DEBUG_QUBITS_ENV,
                                   str(_DENSITY_DEBUG_DEFAULT)))
        if self.num_qubits > limit:
            raise DensityMaterialisationError(
                f"average_density would materialise a "
                f"2^{2 * self.num_qubits}-amplitude density matrix "
                f"({self.num_qubits} qubits > the "
                f"{DENSITY_DEBUG_QUBITS_ENV}={limit} debug bound); use "
                "expectation() for observables or trajectory_sweep() for "
                "the raw state-vector ensemble")
        batch = self.run_batch(state_f, num_trajectories, params=params,
                               uniforms=uniforms).cpu().numpy()
        psis = batch[:, 0].astype(np.float64) + 1j * batch[:, 1]
        return np.einsum("ti,tj->ij", psis, psis.conj()) / len(psis)
