"""Optimizer-in-the-loop serving: submit a variational PROBLEM, stream
back converging iterates.

Variational traffic (VQE / QAOA / noise-model fitting) is not a bag of
independent requests — it is a LOOP: evaluate the gradient at x_k, step
the optimizer, evaluate again. Leaving that loop on the client means
every iterate pays a full client round trip and the service sees an
opaque request stream it cannot coalesce, prioritise, or resume. This
module moves the loop INSIDE the serving layer:

- :class:`VariationalProblem` names the problem once — circuit,
  Pauli-sum objective, initial point, and (for noisy objectives) the
  trajectory/sampling-budget contract;
- :func:`run_optimization` (surfaced as ``SimulationService.optimize``
  and ``ServiceRouter.optimize``) drives the loop on a background
  thread: each iterate is ONE ``gradient=True`` submission — a
  coalesced, tier-keyed, failover-safe value-and-grad dispatch through
  the batched engine (on the card the batched layer kernel; a
  trajectory objective's ``expectation_grad_batch`` also launches the
  fused Kraus kernel) — followed by a host-side optimizer step
  (:class:`GradientDescent` / :class:`Adam`, or any object with the
  same ``init``/``update`` surface);
- the returned :class:`OptimizationHandle` STREAMS iterates as
  incremental results (:meth:`OptimizationHandle.iterates` yields each
  ``{iteration, value, grad_norm, x, converged}`` as it lands) and
  resolves a final
  summary via :meth:`OptimizationHandle.result`;
- every completed iterate checkpoints atomically
  (:func:`quest_tpu_torch.resilience.segments.opt_progress_save`), so a
  killed run RESUMES from its last good iterate (``resume=True``,
  digest-guarded: a checkpoint from a different problem or optimizer
  configuration is ignored, never silently continued);
- faults classify through the standard recovery taxonomy
  (:mod:`quest_tpu_torch.resilience.recovery`): transient iterate failures
  re-execute the step within a bounded restart budget, fatal errors
  (caller errors; on the card a kernel that failed to build or launch)
  fail the handle with the original exception.

A copy of the JAX package's module: :meth:`VariationalProblem.digest` is
its digest byte for byte, so a progress file written by one package
resumes in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import queue
import threading
import time
from typing import Optional, Sequence, Union

import numpy as np

from ..resilience import faults as _faults
from ..resilience.recovery import FATAL, classify
from ..telemetry import profile as _profile
from ..telemetry.tracing import dispatch_annotation

__all__ = ["VariationalProblem", "GradientDescent", "Adam",
           "OptimizationHandle", "resolve_optimizer",
           "run_optimization"]


@dataclasses.dataclass
class VariationalProblem:
    """One variational workload, stated once.

    ``circuit`` is a recorded :class:`~quest_tpu_torch.circuits.Circuit`
    (recommended — it routes through a :class:`~quest_tpu_torch.serve.router.
    ServiceRouter` and survives replica failover), a
    ``CompiledCircuit``, or (noisy objectives) a recorded circuit with
    channels / a ``TrajectoryProgram``. ``observables`` is the
    ``(pauli_terms, coeffs)`` objective. ``x0`` is the starting point —
    a name->angle dict or a vector ordered like the circuit's
    ``param_names``. ``trajectories``/``sampling_budget`` select the
    stochastic-unraveling gradient (each iterate a differentiable wave
    loop with early stopping); ``tier`` pins the deterministic
    gradient's precision rung (QUAD rejects typed — not
    differentiable)."""

    circuit: object
    observables: tuple
    x0: Union[dict, Sequence[float]]
    trajectories: Optional[int] = None
    sampling_budget: Optional[float] = None
    tier: object = None

    @property
    def param_names(self) -> tuple:
        return tuple(self.circuit.param_names)

    def x0_vector(self) -> np.ndarray:
        names = self.param_names
        if isinstance(self.x0, dict):
            missing = [nm for nm in names if nm not in self.x0]
            if missing:
                raise ValueError(
                    f"x0 is missing circuit parameters: {missing}")
            return np.asarray([float(self.x0[nm]) for nm in names],
                              dtype=np.float64)
        vec = np.asarray(self.x0, dtype=np.float64)
        if vec.shape != (len(names),):
            raise ValueError(
                f"x0 has shape {vec.shape}; expected ({len(names)},) "
                f"ordered like {list(names)}")
        return vec

    def digest(self, extra: str = "") -> str:
        """Content digest of the problem + optimizer configuration —
        the checkpoint guard: a resumed run must be THIS problem under
        THIS optimizer FROM this starting point (x0 is part of the
        digest: re-running with a different x0 is a different basin
        exploration and must start clean, not silently continue the
        old run's trajectory), or the saved iterates belong to a
        different energy surface."""
        from .warmcache import circuit_digest
        circ = getattr(self.circuit, "circuit", self.circuit)
        cd = circuit_digest(circ, False) or f"id-{id(self.circuit):x}"
        terms, coeffs = self.observables
        h = hashlib.sha256()
        h.update(cd.encode())
        h.update(repr([tuple(t) for t in terms]).encode())
        h.update(np.asarray(coeffs, dtype=np.float64).tobytes())
        h.update(self.x0_vector().tobytes())
        h.update(repr((self.trajectories, self.sampling_budget,
                       getattr(self.tier, "name", self.tier),
                       extra)).encode())
        return h.hexdigest()


class GradientDescent:
    """Plain gradient descent, ``x <- x - lr * g``. Monotone on a
    locally convex objective at a small enough step — the reference
    optimizer for the convergence tests."""

    name = "gd"

    def __init__(self, learning_rate: float = 0.1):
        if not (learning_rate > 0.0):
            raise ValueError("learning_rate must be > 0")
        self.learning_rate = float(learning_rate)

    def config(self) -> str:
        return f"gd:{self.learning_rate!r}"

    def init(self, x: np.ndarray) -> dict:
        return {}

    def update(self, x, g, state: dict, k: int):
        return x - self.learning_rate * g, state


class Adam:
    """Adam (Kingma & Ba) with bias-corrected moments; the state dict
    round-trips through the iterate checkpoints."""

    name = "adam"

    def __init__(self, learning_rate: float = 0.05, beta1: float = 0.9,
                 beta2: float = 0.999, eps: float = 1e-8):
        if not (learning_rate > 0.0):
            raise ValueError("learning_rate must be > 0")
        self.learning_rate = float(learning_rate)
        self.beta1, self.beta2, self.eps = (float(beta1), float(beta2),
                                            float(eps))

    def config(self) -> str:
        return (f"adam:{self.learning_rate!r}:{self.beta1!r}:"
                f"{self.beta2!r}:{self.eps!r}")

    def init(self, x: np.ndarray) -> dict:
        return {"m": np.zeros_like(x), "v": np.zeros_like(x),
                "t": np.asarray(0.0)}

    def update(self, x, g, state: dict, k: int):
        t = float(state["t"]) + 1.0
        m = self.beta1 * state["m"] + (1.0 - self.beta1) * g
        v = self.beta2 * state["v"] + (1.0 - self.beta2) * g * g
        mh = m / (1.0 - self.beta1 ** t)
        vh = v / (1.0 - self.beta2 ** t)
        x = x - self.learning_rate * mh / (np.sqrt(vh) + self.eps)
        return x, {"m": m, "v": v, "t": np.asarray(t)}


def resolve_optimizer(optimizer, learning_rate: Optional[float] = None):
    """``"gd"`` / ``"adam"`` / an object with ``init``/``update`` (and
    optionally ``config``) -> the optimizer instance."""
    if isinstance(optimizer, str):
        kwargs = {} if learning_rate is None \
            else {"learning_rate": float(learning_rate)}
        if optimizer == "gd":
            return GradientDescent(**kwargs)
        if optimizer == "adam":
            return Adam(**kwargs)
        raise ValueError(f"unknown optimizer {optimizer!r} "
                         "(built-ins: 'gd', 'adam')")
    if not (hasattr(optimizer, "init") and hasattr(optimizer, "update")):
        raise TypeError(
            "an optimizer is 'gd'/'adam' or an object with "
            "init(x)->state and update(x, g, state, k)->(x, state)")
    return optimizer


_DONE = object()


class OptimizationHandle:
    """A running optimization: a background loop of coalesced gradient
    submissions + optimizer steps, streamed back as iterates.

    - :meth:`iterates` yields each iterate dict as it completes
      (``iteration``, ``value``, ``grad_norm``, ``x``, ``converged``;
      trajectory problems add ``stderr``) — the incremental-result
      stream;
    - :meth:`result` blocks for the final summary
      (``{"x", "value", "iterations", "converged", "restarts",
      "resumed_from"}``), re-raising the loop's failure if it died;
    - :meth:`cancel` stops after the in-flight iterate;
    - :attr:`done` / :attr:`exception` poll without blocking.
    """

    def __init__(self, target, problem: VariationalProblem, optimizer,
                 *, max_iters: int, tol: float,
                 checkpoint_path: Optional[str], resume: bool,
                 max_restarts: int, step_timeout_s: float,
                 tenant: str = "default",
                 yield_to_interactive: bool = True,
                 preempt_hold_s: float = 5.0):
        self._target = target
        self._problem = problem
        self._opt = optimizer
        self._max_iters = int(max_iters)
        self._tol = float(tol)
        self._ckpt = checkpoint_path
        self._resume = bool(resume)
        self._max_restarts = int(max_restarts)
        self._step_timeout = float(step_timeout_s)
        self._tenant = str(tenant)
        self._yield_to_interactive = bool(yield_to_interactive)
        self._preempt_hold = float(preempt_hold_s)
        self._digest = problem.digest(
            extra=getattr(optimizer, "config", lambda: repr(optimizer))())
        if checkpoint_path:
            from .warmcache import circuit_digest
            circ = getattr(problem.circuit, "circuit", problem.circuit)
            if circuit_digest(circ, False) is None:
                # the digest fell back to an object-identity token:
                # same-process restarts still resume (the id is
                # stable), but a NEW process gets a different token
                # and silently starts clean — say so up front
                import warnings
                warnings.warn(
                    "optimize() checkpoint resume is PROCESS-LOCAL "
                    "for this problem: the circuit is not "
                    "content-addressable (a Kraus or gate callable "
                    "resists hashing), so the progress "
                    "digest uses an object-identity token and a "
                    "restarted process will start from x0",
                    UserWarning, stacklevel=3)
        self._q: queue.Queue = queue.Queue()
        self._history: list = []
        self._final: Optional[dict] = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"quest-tpu-torch-optimize-{id(self):x}")
        self._thread.start()

    # -- consumption -------------------------------------------------------

    def iterates(self):
        """Yield iterate dicts as they land; returns when the loop
        finishes (converged, exhausted, cancelled, or failed — check
        :meth:`result` / :attr:`exception` for the outcome). Safe to
        call again after exhaustion (the terminator is re-posted, so a
        later or concurrent consumer returns instead of blocking
        forever on the drained queue); already-yielded iterates are in
        :attr:`history`, not replayed here."""
        while True:
            item = self._q.get()
            if item is _DONE:
                self._q.put(_DONE)
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> dict:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("optimization still running")
        if self._exc is not None:
            raise self._exc
        return dict(self._final or {})

    def cancel(self) -> None:
        self._cancelled = True

    @property
    def done(self) -> bool:
        return not self._thread.is_alive()

    @property
    def exception(self) -> Optional[BaseException]:
        return self._exc

    @property
    def history(self) -> list:
        """Iterates recorded so far (snapshot copy)."""
        return list(self._history)

    # -- internals ---------------------------------------------------------

    def _incr(self, name: str, k: int = 1) -> None:
        metrics = getattr(self._target, "metrics", None)
        if metrics is None:
            return
        try:
            metrics.incr(name, k)
        except KeyError:
            # both ServiceMetrics and RouterMetrics carry the
            # optimizer counters; this guards duck-typed custom
            # targets whose registries don't
            pass

    def _event(self, name: str, **detail) -> None:
        ev = getattr(self._target, "_event", None)
        if ev is not None:
            ev(name, **detail)

    def _maybe_yield(self, k: int) -> None:
        """Cooperative preemption at the iterate boundary: when the
        target reports queued interactive (priority-0) work, hold the
        NEXT gradient dispatch until the burst drains (bounded by
        ``preempt_hold_s``). The iterate boundary is exactly the
        digest-guarded checkpoint boundary, so a preempted run that is
        killed mid-hold resumes bit-exactly — yielding the device never
        creates a new failure mode, only latency for the batch tier."""
        if not self._yield_to_interactive:
            return
        pressure = getattr(self._target, "interactive_pressure", None)
        if pressure is None or not pressure():
            return
        # the profile span, fault hook and annotation of the preemption
        # boundary: injected faults here land inside the restart budget
        # like any other iterate fault, and the hold shows up in device
        # profiles as its own annotated span
        sp = _profile.profile_dispatch("serve.preempt")
        _faults.fire("serve.preempt")
        self._incr("preemptions")
        metrics = getattr(self._target, "metrics", None)
        if metrics is not None and hasattr(metrics, "incr_tenant"):
            metrics.incr_tenant(self._tenant, "preemptions")
        self._event("optimizer_preempted", iteration=k)
        t0 = time.monotonic()
        with dispatch_annotation(f"quest_tpu_torch.serve.preempt:k{k}"):
            while (time.monotonic() - t0 < self._preempt_hold
                   and not self._cancelled and pressure()):
                time.sleep(2e-3)
        if sp is not None:
            sp.done(None, program=self._digest[:16], kind="preempt",
                    bucket=1, tier="env", dtype="float64",
                    sharding="none")

    def _step(self, k: int, x: np.ndarray):
        """One optimizer iterate: ONE coalesced gradient submission
        through the serving stack, wall-to-result. Returns ``(value,
        grad, stderr_or_None)``."""
        p = self._problem
        # the profile span opens before the fault hook so injected
        # stalls land inside the measured step time
        sp = _profile.profile_dispatch("serve.optimize")
        poison = _faults.fire("serve.optimize")
        with dispatch_annotation(
                f"quest_tpu_torch.serve.optimize:k{k}:"
                f"p{len(p.param_names)}"):
            fut = self._target.submit(
                p.circuit, x, observables=p.observables, gradient=True,
                trajectories=p.trajectories,
                sampling_budget=p.sampling_budget,
                **({"tier": p.tier} if p.tier is not None else {}),
                **({"tenant": self._tenant}
                   if self._tenant != "default" else {}))
            res = fut.result(timeout=self._step_timeout)
        value = res[0]
        # the gradient future resolved to host arrays: shaping only
        grad = np.asarray(res[1], dtype=np.float64)
        stderr = np.asarray(res[2], dtype=np.float64) \
            if p.trajectories is not None and len(res) > 2 else None
        block = np.concatenate([[value], grad])
        block = _faults.poison_output(poison, block)
        if sp is not None:
            sp.done(None, program=self._digest[:16], kind="optimize",
                    bucket=1,
                    tier=getattr(p.tier, "name", None) or "env",
                    dtype="float64", sharding="none")
        if not np.all(np.isfinite(block)):
            from ..resilience.health import NumericalFault
            raise NumericalFault(
                f"optimizer iterate {k} produced a non-finite "
                "value/gradient", kind="nan", rows=(0,))
        return float(block[0]), block[1:], stderr

    def _run(self) -> None:
        from ..resilience.segments import (opt_progress_load,
                                           opt_progress_save)
        p = self._problem
        try:
            x = p.x0_vector()
            state = self._opt.init(x)
            k0 = 0
            prev_value = None
            resumed_from = None
            if self._ckpt and self._resume:
                saved = opt_progress_load(self._ckpt, self._digest)
                if saved is not None:
                    x = saved["x"]
                    state = saved["opt_state"] or self._opt.init(x)
                    k0 = saved["iteration"] + 1
                    prev_value = saved["value"]
                    resumed_from = saved["iteration"]
                    self._incr("optimizer_resumes")
                    self._event("optimizer_resume",
                                iteration=saved["iteration"])
            self._incr("optimizer_runs")
            restarts = 0
            converged = False
            value = prev_value
            k = k0
            while k < self._max_iters and not self._cancelled:
                try:
                    self._maybe_yield(k)
                    value, grad, stderr = self._step(k, x)
                # quest: allow-broad-except(classified barrier:
                # classify() re-raises FATAL with the caller's original
                # error; transient/poison faults re-execute the iterate
                # within the bounded restart budget)
                except Exception as e:
                    if classify(e) == FATAL \
                            or restarts >= self._max_restarts:
                        raise
                    restarts += 1
                    self._event("optimizer_restart", iteration=k,
                                error=type(e).__name__)
                    continue            # re-execute this iterate
                gnorm = float(np.linalg.norm(grad))
                converged = (prev_value is not None
                             and abs(value - prev_value) <= self._tol)
                it = {"iteration": k, "value": value,
                      "grad_norm": gnorm, "x": np.array(x),
                      "converged": converged}
                if stderr is not None:
                    it["stderr"] = stderr
                prev_value = value
                x, state = self._opt.update(x, grad, state, k)
                self._incr("optimizer_iterations")
                if self._ckpt:
                    # checkpoint the POST-update x: a resumed run must
                    # evaluate the NEXT point, not re-measure the
                    # iterate-k point (a zero delta there would fake
                    # convergence at whatever value the crash left)
                    opt_progress_save(
                        self._ckpt, digest=self._digest, iteration=k,
                        x=x, value=value,
                        opt_state={kk: np.asarray(vv)
                                   for kk, vv in state.items()})
                self._history.append(it)
                self._q.put(it)
                k += 1
                if converged:
                    self._incr("optimizer_converged")
                    self._event("optimizer_converged", iteration=k - 1,
                                value=value)
                    break
            self._final = {
                "x": (np.array(self._history[-1]["x"])
                      if self._history else np.array(x)),
                "value": value,
                "iterations": len(self._history),
                "converged": converged,
                "restarts": restarts,
                "resumed_from": resumed_from,
            }
        # quest: allow-broad-except(thread boundary: the loop's failure
        # must resolve the handle typed — an escaped exception would
        # strand every consumer blocked on iterates()/result())
        except Exception as e:
            self._exc = e
            self._event("optimizer_failed", error=type(e).__name__)
        finally:
            self._q.put(_DONE)


def run_optimization(target, problem: VariationalProblem,
                     optimizer="adam", *, max_iters: int = 100,
                     tol: float = 1e-6,
                     learning_rate: Optional[float] = None,
                     checkpoint_path: Optional[str] = None,
                     resume: bool = True, max_restarts: int = 3,
                     step_timeout_s: Optional[float] = None,
                     tenant: str = "default",
                     yield_to_interactive: bool = True,
                     preempt_hold_s: float = 5.0
                     ) -> OptimizationHandle:
    """Start the optimizer-in-the-loop run against ``target`` (a
    :class:`~quest_tpu_torch.serve.SimulationService` or
    :class:`~quest_tpu_torch.serve.router.ServiceRouter`) and return its
    streaming :class:`OptimizationHandle`. See
    ``SimulationService.optimize`` for the caller-facing contract.

    ``tenant`` attributes every gradient submission (and preemption)
    to a WFQ tenant. ``yield_to_interactive`` enables cooperative
    preemption: before each iterate the loop checks the target's
    ``interactive_pressure()`` and, when priority-0 work is queued,
    holds the next dispatch until the burst drains (at most
    ``preempt_hold_s`` per preemption). Because the hold sits exactly
    on the checkpoint boundary, a preempted run resumes bit-exactly."""
    if max_iters < 1:
        raise ValueError("max_iters must be >= 1")
    if not (tol >= 0.0):
        raise ValueError("tol must be >= 0")
    if not isinstance(problem, VariationalProblem):
        raise TypeError("problem must be a VariationalProblem")
    if not problem.param_names:
        raise ValueError(
            "the problem's circuit declares no parameters; there is "
            "nothing to optimize")
    opt = resolve_optimizer(optimizer, learning_rate)
    if step_timeout_s is None:
        step_timeout_s = 4.0 * float(
            getattr(target, "request_timeout_s", 60.0))
    return OptimizationHandle(
        target, problem, opt, max_iters=max_iters, tol=tol,
        checkpoint_path=checkpoint_path, resume=resume,
        max_restarts=max_restarts, step_timeout_s=step_timeout_s,
        tenant=tenant, yield_to_interactive=yield_to_interactive,
        preempt_hold_s=preempt_hold_s)
