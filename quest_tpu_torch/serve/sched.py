"""Multi-tenant weighted-fair scheduling for the serving runtime.

The coalescer groups compatible requests into batches; a dispatcher
that drained those batches strictly FIFO would let one heavy
gradient/optimize tenant starve interactive callers for the full depth
of its backlog. This module is the scheduling layer on top:

- :class:`TenantPolicy` — the per-tenant contract (WFQ weight,
  priority class, inflight/queued quotas).
- :class:`WFQScheduler` — virtual-time weighted fair queueing
  (start-time fair queueing over batch *cost*, with strict priority
  classes above the fair-share tier). The live dispatcher uses it to
  order ready batches; cost is rows x the per-program request-seconds
  estimate seeded from the :class:`~quest_tpu_torch.telemetry.PerfLedger`,
  so a tenant's share is measured in projected mesh seconds, not
  request counts.
- :func:`plan_wfq_schedule` — a pure host-side discrete-event replay
  of the full scheduling stack (coalesce -> WFQ dequeue -> segment
  preemption -> ledger-driven autoscale), with no device work.

Everything here is plain-Python policy: the scheduler holds no locks
(the service mutates it under its dispatch condition variable) and
performs no host syncs.
"""

from __future__ import annotations

import dataclasses

__all__ = ["DEFAULT_TENANT", "TenantPolicy", "WFQScheduler",
           "plan_wfq_schedule"]

#: Tenant every request lands in when ``submit`` is not given one.
DEFAULT_TENANT = "default"

# a zero/negative weight would stall the virtual clock; clamp far below
# any sane configuration instead of dividing by zero
_MIN_WEIGHT = 1e-12


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """The scheduling contract for one tenant.

    ``weight``
        WFQ share within a priority class: a weight-3 tenant drains
        three projected mesh-seconds for every one a weight-1 tenant
        drains while both are backlogged.
    ``priority``
        Strict class, lower is more urgent. Class 0 is the interactive
        tier: its queued work defines ``interactive_pressure`` (what
        checkpointed ``optimize()`` runs yield the mesh to), and it
        dispatches ahead of every higher class regardless of weights.
    ``max_inflight`` / ``max_queued``
        Hard per-tenant caps. ``max_queued`` rejects at ``submit``
        with :class:`~quest_tpu_torch.serve.engine.QuotaExceeded`;
        ``max_inflight`` defers a ready batch back to pending until
        the tenant's in-flight rows drop below the cap.
    """

    weight: float = 1.0
    priority: int = 1
    max_inflight: int | None = None
    max_queued: int | None = None

    def __post_init__(self):
        if not self.weight > 0.0:
            raise ValueError(f"weight must be > 0, got {self.weight}")
        if self.priority < 0:
            raise ValueError(
                f"priority must be >= 0, got {self.priority}")
        for name in ("max_inflight", "max_queued"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")


class WFQScheduler:
    """Virtual-time weighted fair queueing over ready batches.

    Start-time fair queueing: each dispatched batch advances its
    tenant's virtual finish tag by ``cost / weight``; the global
    virtual clock tracks the start tag of the last dispatched work so
    an idle tenant re-enters at the current clock (it earns no credit
    for sitting out). Strict priority classes sit above the fair
    share: class 0 always dequeues before class 1 and so on, and WFQ
    arbitrates *within* a class.

    Not thread-safe on its own — the service drives it under its
    dispatch condition lock.
    """

    def __init__(self, tenants=None, default: TenantPolicy = None):
        self._tenants = dict(tenants or {})
        for name, pol in self._tenants.items():
            if not isinstance(pol, TenantPolicy):
                raise TypeError(
                    f"tenant {name!r}: expected TenantPolicy, got "
                    f"{type(pol).__name__}")
        self._default = default if default is not None else TenantPolicy()
        self._vclock = 0.0
        self._vtime = {}

    def policy_for(self, tenant: str) -> TenantPolicy:
        """The tenant's policy, or the default contract."""
        return self._tenants.get(tenant, self._default)

    def set_policy(self, tenant: str, policy: TenantPolicy) -> None:
        if not isinstance(policy, TenantPolicy):
            raise TypeError("policy must be a TenantPolicy")
        self._tenants[tenant] = policy

    def tenants(self) -> dict:
        return dict(self._tenants)

    def _start_tag(self, vtime: dict, tenant: str) -> float:
        start = vtime.get(tenant, self._vclock)
        return start if start > self._vclock else self._vclock

    def order(self, entries) -> list:
        """One dispatch cycle's weighted-fair order.

        ``entries`` is ``[(tenant, cost, payload), ...]`` over the
        cycle's ready batches. Returns the same triples reordered:
        strict priority class first, then ascending virtual finish
        tag, advancing a *tentative* per-tenant clock as each entry is
        picked so a heavy tenant's second batch queues behind a light
        tenant's first. Virtual time is NOT committed here — the
        caller calls :meth:`charge` per batch it actually dispatches
        (quota-deferred batches are never charged).
        """
        vt = dict(self._vtime)
        remaining = list(entries)
        out = []
        while remaining:
            best_i = 0
            best_key = None
            for i, (tenant, cost, _payload) in enumerate(remaining):
                pol = self.policy_for(tenant)
                start = self._start_tag(vt, tenant)
                finish = start + cost / max(pol.weight, _MIN_WEIGHT)
                key = (pol.priority, finish, i)
                if best_key is None or key < best_key:
                    best_key = key
                    best_i = i
            tenant, cost, payload = remaining.pop(best_i)
            pol = self.policy_for(tenant)
            start = self._start_tag(vt, tenant)
            vt[tenant] = start + cost / max(pol.weight, _MIN_WEIGHT)
            out.append((tenant, cost, payload))
        return out

    def charge(self, tenant: str, cost: float) -> float:
        """Commit the virtual-time advance for dispatched work and
        return the tenant's new finish tag."""
        pol = self.policy_for(tenant)
        start = self._start_tag(self._vtime, tenant)
        finish = start + cost / max(pol.weight, _MIN_WEIGHT)
        self._vtime[tenant] = finish
        if start > self._vclock:
            self._vclock = start
        return finish

    def snapshot(self) -> dict:
        """JSON-ready scheduler state for ``dispatch_stats``."""
        return {
            "vclock": self._vclock,
            "tenants": {
                name: {"weight": pol.weight, "priority": pol.priority,
                       "max_inflight": pol.max_inflight,
                       "max_queued": pol.max_queued,
                       "vtime": self._vtime.get(name, 0.0)}
                for name, pol in sorted(self._tenants.items())
            },
        }


def plan_wfq_schedule(arrivals, policy, tenants=None, *,
                      device_multiple: int = 1,
                      request_cost_s: float = 1e-3,
                      num_replicas: int = 1,
                      segment_s: float = None,
                      autoscale=None,
                      scale_ready_s: float = 0.25) -> dict:
    """Replay a timed multi-tenant trace through the full scheduling
    stack, host-side, and return every decision it makes.

    ``arrivals`` is ``[(t, tenant, class_key), ...]``. Requests
    coalesce per ``(tenant, class_key)`` group under ``policy``
    (:class:`~quest_tpu_torch.serve.coalesce.CoalescePolicy`, same maturity
    rules as the live dispatcher), then mature batches drain through a
    pool of ``num_replicas`` modeled replicas in WFQ order. A batch
    occupies its replica for ``bucket_rows * request_cost_s`` seconds.

    ``segment_s`` models checkpointed long work: a non-interactive
    batch (priority > 0) runs in ``segment_s`` slices and yields its
    replica at the next boundary when interactive (priority-0) work is
    queued — the remaining slices re-enter the backlog as a resumed
    batch. ``autoscale`` (a
    :class:`~quest_tpu_torch.resilience.recovery.AutoscalePolicy`) is
    evaluated at every decision instant against the modeled backlog;
    a grown replica becomes schedulable ``scale_ready_s`` later.

    Returns ``{"events", "tenants", "totals"}`` — events are the
    time-ordered dispatch/preempt/scale decisions; per-tenant stats
    carry wait percentiles and the share-of-mesh seconds the fairness
    index is computed from.
    """
    from .coalesce import plan_schedule
    from .metrics import ServiceMetrics

    sched = WFQScheduler(tenants)
    keyed = [(t, (tenant, cls)) for (t, tenant, cls) in arrivals]
    batches = plan_schedule(keyed, policy,
                            device_multiple=device_multiple)
    work = []
    for b in batches:
        tenant, cls = b["key"]
        work.append({"ready_t": b["t"], "tenant": tenant, "cls": cls,
                     "size": b["size"], "bucket": b["bucket"],
                     "cost": b["bucket"] * request_cost_s,
                     "resumed": False})
    work.sort(key=lambda w: w["ready_t"])

    events = []
    backlog = []
    servers = [{"free_t": 0.0, "job": None} for _ in range(num_replicas)]
    waits = {}
    busy_s = {}
    dispatches = {}
    preemptions = {}
    wi = 0
    now = 0.0
    last_scale_t = -1e30
    idle_since = 0.0
    guard = 0

    def _priority(tenant):
        return sched.policy_for(tenant).priority

    while wi < len(work) or backlog or any(s["job"] for s in servers):
        guard += 1
        if guard > 16 * len(work) + 4096:   # modeling bug backstop
            events.append({"t": now, "type": "error",
                           "detail": "simulation did not converge"})
            break
        ticks = []
        if wi < len(work):
            ticks.append(work[wi]["ready_t"])
        busy = [s["free_t"] for s in servers if s["job"]]
        if busy:
            ticks.append(min(busy))
        if (autoscale is not None and idle_since is not None
                and len(servers) > autoscale.min_replicas):
            # an idle pool generates no arrival/retire ticks of its
            # own; without this the shrink instant is never visited
            ticks.append(max(idle_since + autoscale.scale_down_idle_s,
                             last_scale_t + autoscale.cooldown_s))
        if ticks:
            t_next = min(ticks)
            if t_next > now:
                now = t_next

        # ingest batches that have matured by now (BEFORE the segment
        # boundaries below look for queued interactive pressure)
        while wi < len(work) and work[wi]["ready_t"] <= now + 1e-12:
            backlog.append(work[wi])
            wi += 1

        # retire finished jobs; a checkpointed job at a segment
        # boundary yields only under live interactive pressure, else
        # it rolls straight into its next segment
        for s in servers:
            job = s["job"]
            if job is None or s["free_t"] > now + 1e-12:
                continue
            if job.get("warmup"):
                s["job"] = None
                continue
            rem = job.get("remaining", 0.0)
            if rem > 1e-12:
                if any(_priority(q["tenant"]) == 0 for q in backlog):
                    s["job"] = None
                    events.append({"t": now, "type": "preempt",
                                   "tenant": job["tenant"],
                                   "cls": job["cls"],
                                   "remaining_s": rem})
                    preemptions[job["tenant"]] = \
                        preemptions.get(job["tenant"], 0) + 1
                    backlog.append({"ready_t": now,
                                    "tenant": job["tenant"],
                                    "cls": job["cls"],
                                    "size": job["size"],
                                    "bucket": job["bucket"],
                                    "cost": rem, "resumed": True})
                else:
                    run_s = min(segment_s, rem)
                    job["remaining"] = rem - run_s
                    s["free_t"] = now + run_s
                continue
            s["job"] = None

        # ledger-driven elasticity: price the backlog in mesh seconds
        if autoscale is not None:
            n_busy = sum(1 for s in servers if s["job"])
            if backlog or n_busy:
                idle_since = None
            elif idle_since is None:
                idle_since = now
            delta = autoscale.decide(
                now=now, replicas=len(servers),
                backlog=sum(w["size"] for w in backlog),
                inflight=n_busy, mean_request_s=request_cost_s,
                last_scale_t=last_scale_t, idle_since=idle_since)
            if delta > 0:
                for _ in range(delta):
                    servers.append({"free_t": now + scale_ready_s,
                                    "job": {"warmup": True}})
                last_scale_t = now
                events.append({"t": now, "type": "scale_up",
                               "replicas": len(servers),
                               "ready_t": now + scale_ready_s})
            elif delta < 0:
                for _ in range(-delta):
                    for i in range(len(servers) - 1, -1, -1):
                        if servers[i]["job"] is None:
                            servers.pop(i)
                            break
                last_scale_t = now
                events.append({"t": now, "type": "scale_down",
                               "replicas": len(servers)})

        # WFQ dequeue onto free replicas
        free = [s for s in servers if s["job"] is None]
        if free and backlog:
            ordered = sched.order(
                [(w["tenant"], w["cost"], w) for w in backlog])
            for tenant, cost, w in ordered:
                if not free:
                    break
                s = free.pop(0)
                backlog.remove(w)
                sched.charge(tenant, cost)
                wait = now - w["ready_t"]
                waits.setdefault(tenant, []).append(wait)
                busy_s[tenant] = busy_s.get(tenant, 0.0) + cost
                dispatches[tenant] = dispatches.get(tenant, 0) + 1
                run_s = cost
                remaining = 0.0
                if (segment_s is not None and _priority(tenant) > 0
                        and cost > segment_s):
                    # checkpointed long work runs one segment at a
                    # time; each boundary re-checks interactive
                    # pressure and yields the replica if any is queued
                    run_s = segment_s
                    remaining = cost - segment_s
                s["job"] = {"tenant": tenant, "cls": w["cls"],
                            "size": w["size"], "bucket": w["bucket"],
                            "remaining": remaining}
                s["free_t"] = now + run_s
                events.append({"t": now, "type": "dispatch",
                               "tenant": tenant, "cls": w["cls"],
                               "size": w["size"], "bucket": w["bucket"],
                               "wait_s": wait, "service_s": run_s,
                               "resumed": w["resumed"],
                               "preempt_scheduled": remaining > 1e-12})

    pct = ServiceMetrics._pct
    shares = {t: busy_s.get(t, 0.0) for t in waits}
    total_share = sum(shares.values())
    per_tenant = {}
    for tenant in sorted(waits):
        ws = sorted(waits[tenant])
        per_tenant[tenant] = {
            "dispatches": dispatches.get(tenant, 0),
            "requests": sum(e["size"] for e in events
                            if e["type"] == "dispatch"
                            and e["tenant"] == tenant
                            and not e["resumed"]),
            "p50_wait_s": pct(ws, 50.0),
            "p99_wait_s": pct(ws, 99.0),
            "mesh_share": (shares[tenant] / total_share
                           if total_share > 0 else 0.0),
            "preemptions": preemptions.get(tenant, 0),
            "priority": _priority(tenant),
            "weight": sched.policy_for(tenant).weight,
        }
    vals = [v["mesh_share"] for v in per_tenant.values()]
    jain = (sum(vals) ** 2 / (len(vals) * sum(v * v for v in vals))
            if vals and sum(v * v for v in vals) > 0 else 1.0)
    return {
        "events": events,
        "tenants": per_tenant,
        "totals": {
            "requests": len(arrivals),
            "batches": len(batches),
            "dispatches": sum(dispatches.values()),
            "preemptions": sum(preemptions.values()),
            "scale_ups": sum(1 for e in events
                             if e["type"] == "scale_up"),
            "scale_downs": sum(1 for e in events
                               if e["type"] == "scale_down"),
            "final_replicas": len(servers),
            "jain_fairness": jain,
            "makespan_s": now,
        },
    }
