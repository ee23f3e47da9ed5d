"""Hamiltonian dynamics in the serving layer: submit an evolution (or
ground-state search) PROBLEM, stream back converging segments.

Time evolution and imaginary-time ground-state search are LOOPS, not
bags of requests: step the state, read an observable, step again.
Leaving the loop on the client costs one dispatch + one device->host
transfer PER STEP; :mod:`quest_tpu_torch.ops.dynamics` already runs a
whole segment's step loop in one dispatch with one packed result. This
module is the serving half of that contract:

- :class:`DynamicsProblem` names the run once — a state-prep circuit,
  the Pauli-sum Hamiltonian, an :class:`~quest_tpu_torch.ops.dynamics.
  EvolveSpec` or :class:`~quest_tpu_torch.ops.dynamics.GroundSpec`, and
  optionally fixed prep parameters / an explicit start state / a
  precision tier;
- :func:`run_dynamics` (surfaced as ``SimulationService.evolve`` and
  ``SimulationService.ground_state``) drives the loop on a background
  thread. Each SEGMENT is ONE coalesced ``evolve=`` / ``ground_state=``
  submission through the batched engine (``evolve_sweep`` /
  ``ground_sweep``: the prep program through the batched layer kernel
  on the card, then the whole step loop), and exactly one packed
  ``(B, W)`` block comes back per segment (per-step energies, the
  Welford carry, and the final state planes the next segment seeds
  from);
- segments after the first submit an IDENTITY prep circuit with
  ``init_state`` set to the previous segment's planes, so the prep
  program executes exactly once per run and continuation segments of
  one run (and of every concurrent run) share one coalescing class;
- the returned :class:`DynamicsHandle` streams one iterate dict per
  segment (:meth:`DynamicsHandle.iterates`) and resolves a final
  summary via :meth:`DynamicsHandle.result`;
- every completed segment checkpoints atomically
  (:func:`quest_tpu_torch.resilience.segments.dyn_progress_save`,
  digest-guarded), so a killed or preempted run resumes BIT-EXACTLY:
  segment boundaries are the only host-visible points of the whole
  evolution, and the planes stored there are the exact resume state;
- faults classify through the standard recovery taxonomy: transient
  segment failures re-execute within a bounded restart budget, fatal
  caller errors fail the handle with the original exception; queued
  priority-0 work preempts the loop cooperatively at the segment
  (= checkpoint) boundary, exactly like :mod:`.optimize`.

A copy of the JAX package's module: the run digest, the Welford merge and
the progress files are its own, so a run checkpointed by one package
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

from ..ops import dynamics as _dyn
from ..resilience import faults as _faults
from ..resilience.recovery import FATAL, classify
from ..telemetry import profile as _profile
from ..telemetry.tracing import dispatch_annotation

__all__ = ["DynamicsProblem", "DynamicsHandle", "run_dynamics"]


@dataclasses.dataclass
class DynamicsProblem:
    """One Hamiltonian-dynamics workload, stated once.

    ``circuit`` prepares the start state (a recorded
    :class:`~quest_tpu_torch.circuits.Circuit` or a ``CompiledCircuit``; an
    empty circuit means "evolve ``init_state`` / |0...0> directly").
    ``hamiltonian`` is the ``(pauli_terms, coeffs)`` Pauli sum — both
    the generator of the dynamics and the streamed observable.
    ``spec`` is the dynamics contract: an
    :class:`~quest_tpu_torch.ops.dynamics.EvolveSpec` (real time, ``t`` in
    ``steps`` Trotter steps of ``order``) or a
    :class:`~quest_tpu_torch.ops.dynamics.GroundSpec` (imaginary-time power
    iteration / Lanczos, ``steps`` iterations per segment until the
    residual crosses ``tol``). ``params`` binds the prep circuit's
    parameters (name->angle dict or a vector ordered like
    ``param_names``; None for a parameterless prep). ``init_state`` is
    an optional explicit ``(2, 2^n)`` start-state plane pair the prep
    circuit applies to. ``tier`` pins the precision rung (QUAD rejects
    typed: the dynamics step loop has no double-double form)."""

    circuit: object
    hamiltonian: tuple
    spec: object
    params: Union[dict, Sequence[float], None] = None
    init_state: Optional[np.ndarray] = None
    tier: object = None

    def __post_init__(self):
        if not isinstance(self.spec, (_dyn.EvolveSpec, _dyn.GroundSpec)):
            raise TypeError(
                "spec must be an ops.dynamics.EvolveSpec or GroundSpec")

    @property
    def kind(self) -> str:
        return "evolve" if isinstance(self.spec, _dyn.EvolveSpec) \
            else "ground"

    @property
    def param_names(self) -> tuple:
        return tuple(self.circuit.param_names)

    def params_vector(self) -> np.ndarray:
        names = self.param_names
        if self.params is None:
            if names:
                raise ValueError(
                    f"the prep circuit declares parameters {list(names)} "
                    "but the problem binds none")
            return np.zeros((0,), dtype=np.float64)
        if isinstance(self.params, dict):
            missing = [nm for nm in names if nm not in self.params]
            if missing:
                raise ValueError(
                    f"params is missing circuit parameters: {missing}")
            return np.asarray([float(self.params[nm]) for nm in names],
                              dtype=np.float64)
        vec = np.asarray(self.params, dtype=np.float64)
        if vec.shape != (len(names),):
            raise ValueError(
                f"params has shape {vec.shape}; expected "
                f"({len(names)},) ordered like {list(names)}")
        return vec

    def digest(self, extra: str = "") -> str:
        """Content digest of the whole run — the checkpoint guard: a
        resumed run must be THIS Hamiltonian under THIS spec contract
        from THIS prepared start state (prep params and any explicit
        ``init_state`` are part of the digest), segmented the SAME way
        (``extra`` carries the segmentation knobs — a saved segment
        index is meaningless under a different segment size)."""
        from .warmcache import circuit_digest
        circ = getattr(self.circuit, "circuit", self.circuit)
        cd = circuit_digest(circ, False) or f"id-{id(self.circuit):x}"
        terms, coeffs = self.hamiltonian
        h = hashlib.sha256()
        h.update(cd.encode())
        h.update(repr([tuple(t) for t in terms]).encode())
        h.update(np.asarray(coeffs, dtype=np.float64).tobytes())
        h.update(repr((self.kind,) + self.spec.contract()).encode())
        h.update(self.params_vector().tobytes())
        if self.init_state is not None:
            h.update(np.ascontiguousarray(
                self.init_state, dtype=np.float64).tobytes())
        h.update(repr((getattr(self.tier, "name", self.tier),
                       extra)).encode())
        return h.hexdigest()


def _welford_merge_host(a, b):
    """Chan's pairwise combine of two host ``(count, mean, M2)``
    triples — pools the device-folded per-segment Welford carries into
    one run-level moment estimate without another device round trip."""
    na, ma, sa = float(a[0]), float(a[1]), float(a[2])
    nb, mb, sb = float(b[0]), float(b[1]), float(b[2])
    n = na + nb
    if n == 0.0:
        return np.zeros((3,), dtype=np.float64)
    d = mb - ma
    return np.asarray(
        [n, ma + d * (nb / n), sa + sb + d * d * (na * nb / n)],
        dtype=np.float64)


_DONE = object()


class DynamicsHandle:
    """A running evolution / ground-state search: a background loop of
    coalesced one-dispatch segment submissions, streamed back.

    - :meth:`iterates` yields one dict per completed segment
      (``segment``, ``steps_done``, ``energy``, ``energies``,
      ``welford``, ``converged``; ground runs add ``residual``) — the
      incremental-result stream;
    - :meth:`result` blocks for the final summary (``{"energy",
      "energies", "planes", "welford", "segments", "steps",
      "converged", "restarts", "resumed_from"}``; ground runs add
      ``"residual"``), re-raising the loop's failure if it died;
    - :meth:`cancel` stops after the in-flight segment;
    - :attr:`done` / :attr:`exception` poll without blocking.
    """

    def __init__(self, target, problem: DynamicsProblem, *,
                 segment_steps: int, max_segments: int,
                 checkpoint_path: Optional[str], resume: bool,
                 max_restarts: int, step_timeout_s: float,
                 tenant: str = "default",
                 yield_to_interactive: bool = True,
                 preempt_hold_s: float = 5.0):
        self._target = target
        self._problem = problem
        self._kind = problem.kind
        self._segment_steps = int(segment_steps)
        self._max_segments = int(max_segments)
        self._ckpt = checkpoint_path
        self._resume = bool(resume)
        self._max_restarts = int(max_restarts)
        self._step_timeout = float(step_timeout_s)
        self._tenant = str(tenant)
        self._yield_to_interactive = bool(yield_to_interactive)
        self._preempt_hold = float(preempt_hold_s)
        # segment_steps is segmentation GEOMETRY (a saved segment index
        # is meaningless under a different evolve slice size);
        # max_segments is only a stopping bound, so — like optimize()'s
        # max_iters — it stays out of the digest and a resumed run may
        # extend or shorten the search
        self._digest = problem.digest(
            extra=repr((self._segment_steps,)))
        self._num_qubits = int(
            getattr(problem.circuit, "num_qubits"))
        self._cont_cc = None    # lazily-compiled identity prep
        if checkpoint_path:
            from .warmcache import circuit_digest
            circ = getattr(problem.circuit, "circuit", problem.circuit)
            if circuit_digest(circ, False) is None:
                # same caveat as optimize(): an identity-token digest
                # resumes within this process but a NEW process gets a
                # different token and silently starts clean
                import warnings
                warnings.warn(
                    "dynamics checkpoint resume is PROCESS-LOCAL for "
                    "this problem: the prep circuit is not "
                    "content-addressable, so the progress digest uses "
                    "an object-identity token and a restarted process "
                    "will start from the prep state",
                    UserWarning, stacklevel=3)
        self._q: queue.Queue = queue.Queue()
        self._history: list = []
        self._final: Optional[dict] = None
        self._exc: Optional[BaseException] = None
        self._cancelled = False
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"quest-tpu-torch-dynamics-{id(self):x}")
        self._thread.start()

    # -- consumption -------------------------------------------------------

    def iterates(self):
        """Yield segment dicts as they land; returns when the loop
        finishes (converged, exhausted, cancelled, or failed — check
        :meth:`result` / :attr:`exception` for the outcome). Safe to
        call again after exhaustion (the terminator is re-posted);
        already-yielded segments are in :attr:`history`."""
        while True:
            item = self._q.get()
            if item is _DONE:
                self._q.put(_DONE)
                return
            yield item

    def result(self, timeout: Optional[float] = None) -> dict:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("dynamics run still running")
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
        """Segment iterates recorded so far (snapshot copy)."""
        return list(self._history)

    # -- internals ---------------------------------------------------------

    def _incr(self, name: str, k: int = 1) -> None:
        metrics = getattr(self._target, "metrics", None)
        if metrics is None:
            return
        try:
            metrics.incr(name, k)
        except KeyError:
            # guards duck-typed custom targets whose counter
            # registries don't carry the dynamics names
            pass

    def _event(self, name: str, **detail) -> None:
        ev = getattr(self._target, "_event", None)
        if ev is not None:
            ev(name, **detail)

    def _maybe_yield(self, k: int) -> None:
        """Cooperative preemption at the segment boundary: when the
        target reports queued interactive (priority-0) work, hold the
        NEXT segment dispatch until the burst drains (bounded by
        ``preempt_hold_s``). The segment boundary is exactly the
        digest-guarded checkpoint boundary, so a preempted run that is
        killed mid-hold resumes bit-exactly — yielding the device never
        creates a new failure mode, only latency for the batch tier."""
        if not self._yield_to_interactive:
            return
        pressure = getattr(self._target, "interactive_pressure", None)
        if pressure is None or not pressure():
            return
        # the preemption boundary's profile span and fault hook, shared
        # with the optimizer loop: injected faults here land inside the
        # restart budget like any other segment fault
        sp = _profile.profile_dispatch("serve.preempt")
        _faults.fire("serve.preempt")
        self._incr("preemptions")
        metrics = getattr(self._target, "metrics", None)
        if metrics is not None and hasattr(metrics, "incr_tenant"):
            metrics.incr_tenant(self._tenant, "preemptions")
        self._event("dynamics_preempted", segment=k)
        t0 = time.monotonic()
        with dispatch_annotation(f"quest_tpu_torch.serve.preempt:k{k}"):
            while (time.monotonic() - t0 < self._preempt_hold
                   and not self._cancelled and pressure()):
                time.sleep(2e-3)
        if sp is not None:
            sp.done(None, program=self._digest[:16], kind="preempt",
                    bucket=1, tier="env", dtype="float64",
                    sharding="none")

    def _continuation_circuit(self):
        """The identity prep every segment after the first submits: an
        empty compiled circuit over the same qubit count, so the
        (spec-homogeneous) continuation segments of one run — and of
        every concurrent run on this handle's target — share one
        coalescing class."""
        if self._cont_cc is None:
            from ..circuits import Circuit
            env = getattr(self._target, "env", None)
            if env is None:
                raise TypeError(
                    "run_dynamics needs a target with an .env to "
                    "compile the identity continuation prep "
                    "(SimulationService; routers front one)")
            self._cont_cc = Circuit(self._num_qubits).compile(env)
        return self._cont_cc

    def _segment_spec(self, k: int, nseg: int):
        """The per-segment dynamics contract. Ground segments reuse the
        problem spec verbatim (``spec.steps`` iterations each); evolve
        segments carve ``segment_steps``-sized slices out of the total
        Trotter schedule at the SAME dt, so every full-size segment
        runs at the same step and the physics is identical to the
        unsegmented run."""
        p = self._problem
        if self._kind == "ground":
            return p.spec, int(p.spec.steps)
        total = int(p.spec.steps)
        ns = min(self._segment_steps, total - k * self._segment_steps)
        return _dyn.EvolveSpec(t=p.spec.dt * ns, steps=ns,
                               order=p.spec.order), ns

    def _segment(self, k: int, planes: Optional[np.ndarray],
                 spec, steps: int) -> dict:
        """One segment: ONE coalesced dynamics submission through the
        serving stack, wall-to-result; the entire ``steps``-long device
        loop and its observable stream come back as one packed row."""
        p = self._problem
        first = planes is None
        circuit = p.circuit if first else self._continuation_circuit()
        params = p.params_vector() if first else None
        state_f = p.init_state if first else planes
        # the profile span opens before the fault hook so injected
        # stalls land inside the measured segment time
        sp = _profile.profile_dispatch("serve.evolve")
        poison = _faults.fire("serve.evolve")
        with dispatch_annotation(
                f"quest_tpu_torch.serve.evolve:{self._kind}:k{k}:s{steps}"):
            fut = self._target.submit(
                circuit, params, observables=p.hamiltonian,
                **({"evolve": spec} if self._kind == "evolve"
                   else {"ground_state": spec}),
                **({"init_state": state_f}
                   if state_f is not None else {}),
                **({"tier": p.tier} if p.tier is not None else {}),
                **({"tenant": self._tenant}
                   if self._tenant != "default" else {}))
            # the future resolved to ONE packed host row per segment
            row = np.asarray(fut.result(timeout=self._step_timeout),
                             dtype=np.float64)
        row = _faults.poison_output(poison, row)
        if sp is not None:
            sp.done(None, program=self._digest[:16], kind=self._kind,
                    bucket=1,
                    tier=getattr(p.tier, "name", None) or "env",
                    dtype="float64", sharding="none")
        if not np.all(np.isfinite(row)):
            from ..resilience.health import NumericalFault
            raise NumericalFault(
                f"dynamics segment {k} produced a non-finite packed "
                "block", kind="nan", rows=(0,))
        n = self._num_qubits
        if self._kind == "evolve":
            out = _dyn.unpack_evolve_block(row[None, :], n, steps)
            residual = None
        else:
            out = _dyn.unpack_ground_block(row[None, :], n, steps)
            residual = float(out["residual"][0])
        return {"energies": np.asarray(out["energies"][0]),
                "welford": np.asarray(out["welford"][0]),
                "planes": np.asarray(out["planes"][0]),
                "residual": residual}

    def _run(self) -> None:
        from ..resilience.segments import (dyn_progress_load,
                                           dyn_progress_save)
        p = self._problem
        try:
            nseg = self._max_segments if self._kind == "ground" else \
                -(-int(p.spec.steps) // self._segment_steps)
            planes = None
            energies: list = []
            welford = np.zeros((3,), dtype=np.float64)
            residual = None
            k0 = 0
            resumed_from = None
            if self._ckpt and self._resume:
                saved = dyn_progress_load(self._ckpt, self._digest)
                if saved is not None:
                    planes = saved["planes"]
                    energies = list(saved["energies"])
                    welford = saved["welford"]
                    residual = saved["residual"]
                    k0 = saved["segment"] + 1
                    resumed_from = saved["segment"]
                    self._incr("dynamics_resumes")
                    self._event("dynamics_resume",
                                segment=saved["segment"])
            self._incr("dynamics_runs")
            restarts = 0
            # a resumed ground run that had already crossed tol must
            # resolve immediately, not re-measure a converged state
            converged = (self._kind == "ground"
                         and residual is not None
                         and residual <= float(p.spec.tol))
            k = k0
            while k < nseg and not converged and not self._cancelled:
                spec, steps = self._segment_spec(k, nseg)
                try:
                    self._maybe_yield(k)
                    seg = self._segment(k, planes, spec, steps)
                # quest: allow-broad-except(classified barrier:
                # classify() re-raises FATAL with the caller's original
                # error; transient/poison faults re-execute the segment
                # within the bounded restart budget)
                except Exception as e:
                    if classify(e) == FATAL \
                            or restarts >= self._max_restarts:
                        raise
                    restarts += 1
                    self._event("dynamics_restart", segment=k,
                                error=type(e).__name__)
                    continue            # re-execute this segment
                planes = seg["planes"]
                energies.extend(float(v) for v in seg["energies"])
                welford = _welford_merge_host(welford, seg["welford"])
                residual = seg["residual"]
                converged = (self._kind == "ground"
                             and residual is not None
                             and residual <= float(p.spec.tol))
                it = {"segment": k, "steps_done": len(energies),
                      "energy": float(energies[-1]),
                      "energies": np.asarray(seg["energies"]),
                      "welford": np.array(welford),
                      "converged": converged}
                if residual is not None:
                    it["residual"] = residual
                if self._ckpt:
                    # checkpoint AFTER folding the segment in: the
                    # saved planes are this segment's exit state, so a
                    # resumed run seeds the NEXT segment bit-exactly
                    dyn_progress_save(
                        self._ckpt, digest=self._digest, segment=k,
                        planes=planes,
                        energies=np.asarray(energies,
                                            dtype=np.float64),
                        welford=welford, residual=residual)
                self._history.append(it)
                self._q.put(it)
                k += 1
                if converged:
                    self._incr("ground_converged")
                    self._event("dynamics_converged", segment=k - 1,
                                residual=residual)
                    break
            self._final = {
                "energy": (float(energies[-1]) if energies else None),
                "energies": np.asarray(energies, dtype=np.float64),
                "planes": (np.array(planes)
                           if planes is not None else None),
                "welford": np.array(welford),
                "segments": len(self._history),
                "steps": len(energies),
                "converged": converged,
                "restarts": restarts,
                "resumed_from": resumed_from,
            }
            if self._kind == "ground":
                self._final["residual"] = residual
        # quest: allow-broad-except(thread boundary: the loop's failure
        # must resolve the handle typed — an escaped exception would
        # strand every consumer blocked on iterates()/result())
        except Exception as e:
            self._exc = e
            self._event("dynamics_failed", error=type(e).__name__)
        finally:
            self._q.put(_DONE)


def run_dynamics(target, problem: DynamicsProblem, *,
                 segment_steps: int = 64, max_segments: int = 64,
                 checkpoint_path: Optional[str] = None,
                 resume: bool = True, max_restarts: int = 3,
                 step_timeout_s: Optional[float] = None,
                 tenant: str = "default",
                 yield_to_interactive: bool = True,
                 preempt_hold_s: float = 5.0) -> DynamicsHandle:
    """Start the dynamics run against ``target`` (a
    :class:`~quest_tpu_torch.serve.SimulationService`) and return its
    streaming :class:`DynamicsHandle`. See ``SimulationService.evolve``
    / ``SimulationService.ground_state`` for the caller-facing
    contract.

    ``segment_steps`` sizes evolve segments (ground segments are sized
    by ``spec.steps``); ``max_segments`` bounds ground-state searches
    that never cross ``spec.tol``. ``tenant`` attributes every segment
    submission (and preemption) to a WFQ tenant;
    ``yield_to_interactive`` holds the next segment while priority-0
    work is queued (at most ``preempt_hold_s`` per preemption) —
    because the hold sits exactly on the checkpoint boundary, a
    preempted run resumes bit-exactly."""
    if not isinstance(problem, DynamicsProblem):
        raise TypeError("problem must be a DynamicsProblem")
    if segment_steps < 1:
        raise ValueError("segment_steps must be >= 1")
    if max_segments < 1:
        raise ValueError("max_segments must be >= 1")
    if step_timeout_s is None:
        step_timeout_s = 4.0 * float(
            getattr(target, "request_timeout_s", 60.0))
    return DynamicsHandle(
        target, problem, segment_steps=segment_steps,
        max_segments=max_segments, checkpoint_path=checkpoint_path,
        resume=resume, max_restarts=max_restarts,
        step_timeout_s=step_timeout_s, tenant=tenant,
        yield_to_interactive=yield_to_interactive,
        preempt_hold_s=preempt_hold_s)
