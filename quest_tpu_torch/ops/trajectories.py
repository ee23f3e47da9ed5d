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

Channel probabilities come from the targets' reduced density, one
``torch.matmul`` per channel at full precision (:meth:`_channel_probs`), work
the JAX package leaves to XLA.

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
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .. import validation as val
from ..core.apply import apply_diagonal, apply_unitary
from . import kraus_kernel as kk
from . import layer_kernel as lk
from . import reductions as red
from .adjoint import bind_rows

__all__ = ["TrajectoryProgram", "DensityMaterialisationError",
           "plan_waves", "DENSITY_DEBUG_QUBITS_ENV"]

DENSITY_DEBUG_QUBITS_ENV = "QUEST_TPU_DENSITY_DEBUG_QUBITS"
_DENSITY_DEBUG_DEFAULT = 14


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


class TrajectoryProgram:
    """A recorded circuit lowered to a stochastic pure-state program.

    Unitary and diagonal ops apply as in the deterministic path; each Kraus
    channel consumes one uniform per trajectory. Parameterized gates and
    channels (Param strengths, callable Kraus sets) bind at call time.
    Batch with :meth:`trajectory_sweep` / :meth:`run_batch`; estimate
    observables with :meth:`expectation` (waves, early stopping).
    """

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
        self._last_traj_stats: dict = {}

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
                       estack: torch.Tensor) -> torch.Tensor:
        """``p_j = <psi| E_j |psi> = tr(E_j rho_T)`` for every trajectory:
        one pass over the batch builds each trajectory's ``2^t x 2^t``
        reduced density of the targets (a ``torch.matmul``), then every
        probability is a small trace against the ``E_j`` stack (``(K, d,
        d)``, or ``(T, K, d, d)`` for a per-row channel). ``(T, K)`` in the
        plane dtype."""
        n = self.num_qubits
        k = len(targets)
        num_traj = states.shape[0]
        # bit j of the gathered index is targets[j]
        front = [2 + n - 1 - targets[j] for j in reversed(range(k))]
        rest = [2 + a for a in range(n) if 2 + a not in front]
        a = states.view((num_traj, 2) + (2,) * n).permute(
            [0, 1] + front + rest).reshape(num_traj, 2, 1 << k, -1)
        ar, ai = a[:, 0], a[:, 1]
        ar_t, ai_t = ar.transpose(1, 2), ai.transpose(1, 2)
        rho_r = torch.matmul(ar, ar_t) + torch.matmul(ai, ai_t)
        rho_i = torch.matmul(ai, ar_t) - torch.matmul(ar, ai_t)
        er = estack.real.to(states.dtype)
        ei = estack.imag.to(states.dtype)
        eq = "kab,tba->tk" if estack.dim() == 3 else "tkab,tba->tk"
        return torch.einsum(eq, er, rho_r) - torch.einsum(eq, ei, rho_i)

    def _operators(self, data, kind, pm: np.ndarray):
        """The channel's Kraus stack and effect stack as complex device
        tensors: ``(K, d, d)``, or ``(T, K, d, d)`` when a parameterized
        channel binds differently per row."""
        if kind == "kraus":
            stack, estack = data[0], data[1]
        else:
            stack = bind_rows(lambda p: torch.stack(
                [torch.as_tensor(m, dtype=torch.complex128)
                 for m in data(p)]), self.param_names, pm)
            estack = _effect_stack(stack)
        cdtype = self.env.precision.complex_dtype
        return (torch.as_tensor(stack, dtype=cdtype, device=self.env.device),
                torch.as_tensor(estack, dtype=cdtype,
                                device=self.env.device))

    def _apply_batch(self, states: torch.Tensor, uniforms: torch.Tensor,
                     pm: np.ndarray) -> torch.Tensor:
        """Advance the ``(T, 2, 2^n)`` batch through the program IN PLACE.
        ``uniforms``: ``(T, num_channels)`` in the plane dtype on the
        device; ``pm``: the ``(T, P)`` host parameter rows."""
        n = self.num_qubits
        names = self.param_names
        for item in self._items:
            kind = item[0]
            if kind == "layer":
                lk.apply_layer_batched(states, n, item[1])
            elif kind == "kraus_fused":
                _, targets, (_, estack, kemb), idx = item
                es = torch.as_tensor(estack,
                                     dtype=self.env.precision.complex_dtype,
                                     device=states.device)
                probs = self._channel_probs(states, targets, es)
                kk.fused_kraus_apply_batched(
                    states, n, kemb, probs, uniforms[:, idx].contiguous())
            elif kind in ("kraus", "kraus_fn"):
                _, targets, data, idx = item
                ks, es = self._operators(data, kind, pm)
                probs = self._channel_probs(states, targets, es)
                j, scale = kk.draw_plain(probs, uniforms[:, idx])
                rows = torch.arange(states.shape[0], device=states.device)
                sel = ks[j] if ks.dim() == 3 else ks[rows, j]
                apply_unitary(states, n, sel * scale[:, None, None].to(
                    sel.dtype), targets)
            elif kind in ("u", "u_fn"):
                _, targets, data, (cmask, fmask) = item
                u = data if kind == "u" else bind_rows(data, names, pm)
                apply_unitary(states, n, u, targets, cmask, fmask)
            else:
                _, targets, data, _ = item
                d = data if kind == "diag" else bind_rows(data, names, pm)
                apply_diagonal(states, n, targets, d)
        return states

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

    def _run_rows(self, start: torch.Tensor, uniforms: torch.Tensor,
                  pm_rows: np.ndarray) -> torch.Tensor:
        """Fresh ``(T, 2, 2^n)`` copies of ``start`` walked through the
        program with ``(T, C)`` uniforms and ``(T, P)`` parameter rows."""
        num_traj = pm_rows.shape[0]
        states = start.expand(num_traj, 2, start.shape[1]).contiguous()
        u = uniforms.to(device=states.device, dtype=states.dtype)
        return self._apply_batch(states, u, pm_rows)

    # -- execution -----------------------------------------------------------

    def trajectory_sweep(self, num_trajectories: int, params=None,
                         state_f=None, uniforms=None) -> torch.Tensor:
        """``num_trajectories`` independent draws from one start state
        (default |0..0>): the ``(T, 2, 2^n)`` planes on the env's device.
        ``uniforms``: the ``(T, num_channels)`` block to draw with (default:
        drawn from the env's generator)."""
        num_traj = int(num_trajectories)
        if num_traj < 1:
            raise ValueError("num_trajectories must be >= 1")
        pm = self._param_matrix(params)
        shape = (num_traj, self.num_channels)
        u = self._given_uniforms(uniforms, shape) if uniforms is not None \
            else self._draw_uniforms(self.env.generator, shape)
        return self._run_rows(self._start(state_f), u,
                              np.repeat(pm, num_traj, axis=0))

    def run_batch(self, state_f, num_trajectories: int, params=None,
                  uniforms=None) -> torch.Tensor:
        """:meth:`trajectory_sweep` with the start state first."""
        return self.trajectory_sweep(num_trajectories, params=params,
                                     state_f=state_f, uniforms=uniforms)

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
        shape = (1, self.num_channels)
        u = self._given_uniforms(np.reshape(uniforms, shape), shape) \
            if uniforms is not None \
            else self._draw_uniforms(self.env.generator, shape)
        states = qureg.state.unsqueeze(0)
        self._apply_batch(states, u.to(device=states.device,
                                       dtype=states.dtype), pm)

    # -- observables with early stopping --------------------------------------

    def expectation(self, pauli_terms, coeffs, state_f=None,
                    num_trajectories: int = None, *, params=None,
                    sampling_budget: Optional[float] = None,
                    wave_size: Optional[int] = None,
                    seed: Optional[int] = None,
                    uniforms=None) -> tuple[float, float]:
        """Monte-Carlo estimate of ``<H>`` under the noisy evolution,
        ``H = sum_j coeffs[j] * prod Pauli`` (terms as ``(qubit, code)``
        pairs, codes 1=X 2=Y 3=Z). Returns ``(mean, stderr)``.

        The ensemble runs in WAVES of ``wave_size`` trajectories (default
        ``min(T, 32)``); each wave's values fold into a device-resident
        running (count, mean, M2), and the wave's ONE device-to-host
        transfer is that triple. ``sampling_budget`` (a target standard
        error) stops the loop at the first wave that meets it. The uniforms
        are drawn up front from ``seed``'s generator (default the env's),
        or given as a ``(T, num_channels)`` block, so the stop decision is
        a function of the seed. The accounting lands in
        :attr:`last_traj_stats`."""
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
            sampling_budget=sampling_budget, wave_size=wave_size)
        return float(means[0]), float(errs[0])

    def expectation_batch(self, param_matrix, hamiltonian,
                          num_trajectories: int, *,
                          sampling_budget: Optional[float] = None,
                          wave_size: Optional[int] = None,
                          live_rows: Optional[int] = None, state_f=None,
                          seed: Optional[int] = None):
        """The ``(B, T)`` form: one ensemble per parameter row, all rows
        advancing through shared waves. Early stopping waits for every live
        row (``live_rows`` leaves padded rows out of the decision). Returns
        ``(means, stderrs, info)`` with ``(B,)`` arrays."""
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
                              wave_size=wave_size, live_rows=live_rows)

    def _converge(self, pm: np.ndarray, terms, coeffs, state_f,
                  max_trajectories: int, generator: torch.Generator,
                  uniforms, sampling_budget=None, wave_size=None,
                  live_rows=None):
        """The shared wave loop over ``(B, P)`` parameter rows. Row ``b``'s
        trajectory ``t`` uses uniform row ``uniforms[b, t]`` of one block
        drawn up front, so wave boundaries never change a draw."""
        rows = pm.shape[0]
        live = rows if live_rows is None else max(1, min(int(live_rows),
                                                         rows))
        xm, ym, zm, cf = red.pauli_terms_operands(terms, coeffs,
                                                  self.num_qubits)
        num_channels = self.num_channels
        if uniforms is None:
            uniforms = self._draw_uniforms(
                generator, (rows, max_trajectories, num_channels))
        wave = int(wave_size) if wave_size else min(max_trajectories, 32)
        waves, bucket = plan_waves(max_trajectories, wave)
        start = self._start(state_f)
        dtype, device = start.dtype, start.device
        pm_rows = np.repeat(pm, bucket, axis=0)
        carry = torch.zeros((3, rows), dtype=dtype, device=device)
        run = 0
        waves_run = 0
        early = False
        snap = None
        stderr = np.full((rows,), np.inf)
        for first, live_w in waves:
            u = uniforms[:, first:first + live_w]
            if live_w < bucket:
                # padded rows repeat the wave's first draw; the mask drops
                # them from the statistics
                u = torch.cat([u] + [u[:, :1]] * (bucket - live_w), dim=1)
            mask = torch.zeros((bucket,), dtype=dtype, device=device)
            mask[:live_w] = 1.0
            states = self._run_rows(start, u.reshape(rows * bucket,
                                                     num_channels), pm_rows)
            vals = red.pauli_sum_total_sv(states, xm, ym, zm, cf)
            del states
            wave_stats = red.welford_wave(vals.view(rows, bucket), mask)
            carry = torch.stack(red.welford_merge(
                (carry[0], carry[1], carry[2]), wave_stats))
            run += live_w
            waves_run += 1
            snap = carry.cpu().numpy()          # the wave's ONE transfer
            stderr = red.welford_stderr(snap[0], snap[2])
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
        }
        self._last_traj_stats = dict(info)
        return (np.asarray(snap[1], dtype=np.float64),
                np.asarray(stderr, dtype=np.float64), info)

    @property
    def last_traj_stats(self) -> dict:
        """Accounting of the most recent wave loop (``trajectories_run``,
        ``early_stopped``, waves, stderr)."""
        return dict(self._last_traj_stats)

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
