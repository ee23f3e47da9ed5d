"""Request coalescing: many small submissions -> few well-shaped batches.

The batched engine (:meth:`quest_tpu_torch.circuits.CompiledCircuit.sweep` /
``expectation_sweep`` / ``sample_sweep``) is fast exactly when it runs
LARGE batches of the SAME executable form; independent callers produce
neither. This module is the policy layer that closes the gap:

- **compatibility** — two requests may share a dispatch only when they
  would hit the same compiled executable: same :class:`CompiledCircuit`
  object (same program, env, dtype), same request kind
  (state / expectation / sample), same observable masks, and the same
  power-of-two shot bucket (:func:`quest_tpu_torch.parallel.sampling.
  shot_bucket`). :func:`coalesce_key` encodes exactly that.
- **padded batch buckets** — a live batch of B requests executes at
  :func:`batch_bucket`\\ (B) rows (next power of two; the floor is the
  device count, 1 on one card), with the throwaway rows zero-parameter
  bindings the fan-out slices off. On the card a batch shape packs its
  layer operands and sizes its temporaries once, so bucketing keeps that
  to ~log2(max_batch) shapes per form instead of one per distinct batch
  size (and keeps the schedule the JAX package's).
- **bounded wait** — a group dispatches when it reaches
  ``max_batch`` requests ("full") or when its OLDEST member has waited
  ``max_wait_s`` ("max_wait"), so thin traffic pays at most one
  max-wait of extra latency and a burst coalesces completely.

:func:`split_ready` is the live dispatcher's decision function;
:func:`plan_schedule` replays the same policy over a timed arrival
trace with no device work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from ..parallel.sampling import shot_bucket

__all__ = ["KIND_STATE", "KIND_EXPECTATION", "KIND_SAMPLE",
           "KIND_TRAJECTORY", "KIND_GRADIENT", "KIND_EVOLVE",
           "KIND_GROUND", "batch_bucket",
           "coalesce_key", "CoalescePolicy", "split_ready",
           "plan_schedule"]

KIND_STATE = "state"
KIND_EXPECTATION = "expectation"
KIND_SAMPLE = "sample"
# stochastic-unraveling expectation requests (TrajectoryProgram): the
# observable key additionally carries (max_trajectories,
# sampling_budget), so a group is homogeneous in its convergence
# contract and executes as ONE (B, T) wave loop
KIND_TRAJECTORY = "trajectory"
# value-and-gradient requests (``submit(..., gradient=True)``): the
# observable key carries the Pauli masks PLUS the program's parameter
# count, so a group is homogeneous in its gradient width and executes
# as ONE (B, P) reverse pass — one executable, one (B, P+1) transfer
# (``CompiledCircuit.value_and_grad_sweep``); trajectory-program
# gradients additionally carry the (max_T, budget) convergence
# contract and run one gradient wave loop
KIND_GRADIENT = "gradient"
# device-resident Hamiltonian dynamics (``submit(..., evolve=spec)`` /
# ``submit(..., ground_state=spec)``): the observable key carries the
# Hamiltonian's Pauli masks PLUS the spec contract — (t, steps, order)
# for Trotter evolution, (steps, tau, method, tol) for the ground-state
# segment — and the start-state digest, so a coalesced group agrees on
# the WHOLE evolution (one keyed executable, the step loop inside it,
# ONE packed (B, W) transfer per segment)
KIND_EVOLVE = "evolve"
KIND_GROUND = "ground_state"


def batch_bucket(n: int, floor: int = 1) -> int:
    """The padded batch size a ``n``-request dispatch executes at: the
    next power of two at or above ``n``, floored at ``floor`` (the mesh
    device count, so batch-parallel dispatches never trigger the
    engine's own non-divisible pad-and-mask warning)."""
    if n < 1:
        raise ValueError("batch bucket needs at least one request")
    b = 1
    while b < n:
        b <<= 1
    return max(b, int(floor))


def coalesce_key(compiled, kind: str, obs_key=(), shots: int = 0,
                 tier=None, tenant: str = "default") -> tuple:
    """The compatibility class of one request: requests sharing this key
    dispatch through one executable. ``obs_key`` is the canonical
    hashable Hamiltonian form (terms + coeffs); shots enter via their
    power-of-two bucket, not the raw count; ``tier`` is the request's
    precision tier (:class:`~quest_tpu_torch.config.PrecisionTier` or None) —
    a FAST sweep must never pad into (or share an executable with) a
    batch compiled at another tier, so the tier is a full coalescing
    dimension, not a dispatch-time detail. ``tenant`` is the submitting
    tenant (:mod:`quest_tpu_torch.serve.sched`): batches stay
    single-tenant so the WFQ scheduler can order and account whole
    batches per tenant — two tenants running the same executable form
    still dispatch separately."""
    from ..circuits import CompiledCircuit
    return (id(compiled), kind, obs_key,
            shot_bucket(int(shots)) if kind == KIND_SAMPLE else 0,
            CompiledCircuit._dtype_token(compiled.env.precision.real_dtype),
            # the SAME token that keys the executable/warm caches — one
            # definition, so coalescing and executable isolation can
            # never disagree about what counts as "the same tier"
            CompiledCircuit._tier_token(tier),
            str(tenant))


@dataclasses.dataclass(frozen=True)
class CoalescePolicy:
    """The two serving knobs.

    ``max_batch`` caps requests per dispatch (the engine's sweet-spot
    batch; also the tail-latency bound for the requests that joined a
    batch first). ``max_wait_s`` bounds how long a lone request waits
    for company — the latency/occupancy trade: 0 disables coalescing
    benefits under thin traffic, large values batch everything but add
    queueing latency. ``bucket_batches=False`` disables padding (every
    distinct live batch size compiles its own executable — only useful
    for measurement)."""

    max_batch: int = 64
    max_wait_s: float = 2e-3
    bucket_batches: bool = True

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if not (self.max_wait_s >= 0.0 and math.isfinite(self.max_wait_s)):
            raise ValueError("max_wait_s must be finite and >= 0")

    def bucket_size(self, n: int, device_multiple: int = 1) -> int:
        if not self.bucket_batches:
            return n
        return batch_bucket(n, floor=device_multiple)


def split_ready(pending: list, now: float, policy: CoalescePolicy,
                drain: bool = False):
    """Split one compatibility group's FIFO ``pending`` list (objects
    with a ``submit_t`` attribute, oldest first) into dispatchable
    batches. Returns ``(batches, rest, next_deadline)``: full batches
    always dispatch; a partial batch dispatches when its oldest member
    has aged past ``max_wait_s`` (or unconditionally when ``drain``);
    ``next_deadline`` is when the surviving partial batch matures
    (None if nothing survives)."""
    batches = []
    while len(pending) >= policy.max_batch:
        batches.append(pending[:policy.max_batch])
        pending = pending[policy.max_batch:]
    if pending and (drain
                    or now - pending[0].submit_t >= policy.max_wait_s):
        batches.append(pending)
        pending = []
    next_deadline = (pending[0].submit_t + policy.max_wait_s) \
        if pending else None
    return batches, pending, next_deadline


@dataclasses.dataclass
class _SimArrival:
    submit_t: float
    index: int


def plan_schedule(arrivals: Sequence[tuple], policy: CoalescePolicy,
                  device_multiple: int = 1) -> list:
    """Replay the coalescing policy over a timed trace, no device work.

    ``arrivals``: ``(t, key)`` pairs (any hashable ``key`` — the
    compatibility class), in arrival order. Returns one event dict per
    dispatch the live dispatcher would have made: dispatch time,
    group key, live size, padded bucket, per-request waits, and the
    trigger (``"full"`` | ``"max_wait"``). The simulation is exact for
    an idle executor (dispatch latency zero); a busy executor only
    delays dispatches further, which can merge groups, never split
    them — so the schedule is a lower bound on achievable occupancy.
    """
    events = []
    pending: dict = {}

    def flush(key, group, t, reason):
        bucket = policy.bucket_size(len(group), device_multiple)
        waits = [t - a.submit_t for a in group]
        events.append({
            "t": round(t, 9), "key": key, "size": len(group),
            "bucket": bucket, "padded_rows": bucket - len(group),
            "reason": reason,
            "requests": [a.index for a in group],
            "max_wait_s": round(max(waits), 9),
            "mean_wait_s": round(sum(waits) / len(waits), 9),
        })

    def mature(key, horizon: Optional[float]):
        """Flush max-wait-expired batches of ``key`` strictly before
        ``horizon`` (None = end of trace: flush everything)."""
        group = pending.get(key, [])
        while group:
            due = group[0].submit_t + policy.max_wait_s
            if horizon is not None and due > horizon:
                break
            # at time `due` the dispatcher takes whatever had arrived
            take = [a for a in group if a.submit_t <= due]
            group = group[len(take):]
            flush(key, take, due, "max_wait")
        pending[key] = group

    for i, (t, key) in enumerate(arrivals):
        for k in list(pending):
            mature(k, float(t))
        group = pending.setdefault(key, [])
        group.append(_SimArrival(float(t), i))
        if len(group) >= policy.max_batch:
            flush(key, group[:policy.max_batch], float(t), "full")
            pending[key] = group[policy.max_batch:]
    for k in list(pending):
        mature(k, None)
    events.sort(key=lambda e: (e["t"], e["requests"][0]))
    return events
