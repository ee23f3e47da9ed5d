"""Model-vs-measured dispatch profiling and cost-model drift detection.

The precision ladder selects tiers off the :class:`~quest_tpu_torch.
profiling.TierErrorModel` and the scheduler prices batches off measured
request seconds; this module closes the loop against what the card did:

- :class:`DispatchProfiler` — a process-global, deterministic-stride
  sampler (the ``trace_sample_rate`` pattern: default OFF, one float
  compare per dispatch). A sampled dispatch is timed from its entry to
  the completion of its device work: on a card by a pair of CUDA events
  on the dispatch's stream (the end event is waited on, so the time is
  device completion, not the asynchronous enqueue), on the CPU by the
  host clock. Samples are keyed by ``(site, program digest, kind, batch
  bucket, tier, dtype, sharding mode, replica)`` into fixed-bucket
  histograms. Every site passes the plan's bytes per pass, so each key
  derives a live achieved-bytes/s and ``roofline_frac`` against the
  card's HBM rate (:func:`platform_peak_bytes_per_s`).
- :class:`DriftMonitor` — compares modeled vs measured wherever a model
  exists (on one card: ``tier_error``, the tier error model's bound vs
  the fidelity monitor's observed norm drift). The two are different
  units of the same decision, so the monitor tracks the LOG-RATIO
  against a per-model baseline locked from the first ``baseline_n``
  samples: a stable model-to-hardware offset is calibration, a RATIO
  that moves is drift. When ``|log2(measured / modeled) - baseline|``
  exceeds ``threshold_log2`` (``QUEST_TPU_DRIFT_LOG2``, default 1.0 = a
  2x departure), a unified-schema ``model_drift`` event is recorded and
  the per-model ``drift_ratio`` gauge moves off 1.0 (visible in
  :func:`~quest_tpu_torch.telemetry.export.prometheus_text` through the
  registered ``dispatch_profiler`` provider).

The profiler is enabled with :func:`configure` (or
``QUEST_TPU_PROFILE=1`` / ``QUEST_TPU_PROFILE_RATE=<rate>`` in the
environment); :data:`DEFAULT_PROFILE_RATE` is the default stride when
enabled without an explicit rate. Snapshots surface as
``dispatch_stats()["profile"]`` on services and persist across process
restarts through :class:`~quest_tpu_torch.telemetry.ledger.PerfLedger`.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from typing import Optional

from .events import make_event
from .metrics import LATENCY_BUCKETS_S, Histogram, metrics_registry

__all__ = ["DEFAULT_PROFILE_RATE", "DispatchProfiler", "DriftMonitor",
           "profiler", "configure", "profile_dispatch", "record_model",
           "enable_recalibration", "platform_peak_bytes_per_s"]

# the default sampling stride when profiling is enabled without an
# explicit rate: every 8th dispatch. A sampled dispatch waits for its
# device work (which serving dispatches pay anyway, copying results to
# the host) plus ~microseconds of bookkeeping.
DEFAULT_PROFILE_RATE = 0.125

# peak memory-bandwidth models per device kind (B/s) for roofline_frac:
# the H100's data-sheet HBM3 rate (SXM part); the host entry is a nominal
# 2-channel DDR4 model, labeled as a model
_PEAK_BW_MODELS = (
    ("h100", 3.35e12),
)
_HOST_PEAK_BW = 4.2e10


def platform_peak_bytes_per_s() -> tuple:
    """``(model_name, peak B/s)`` for the card the process uses (the
    host model without one) — ``QUEST_TPU_PEAK_BW`` (B/s) overrides the
    table. A card the table does not name is priced as the H100 the port
    is written for."""
    env = os.environ.get("QUEST_TPU_PEAK_BW", "").strip()
    if env:
        try:
            return ("env-override", float(env))
        except ValueError:
            pass
    import torch
    if not torch.cuda.is_available():
        return ("host model", _HOST_PEAK_BW)
    kind = torch.cuda.get_device_name(0).lower()
    for name, bw in _PEAK_BW_MODELS:
        if name in kind:
            return (name, bw)
    return _PEAK_BW_MODELS[0]


class DriftMonitor:
    """Per-model modeled-vs-measured drift tracking.

    :meth:`record` takes one ``(modeled, measured)`` pair of POSITIVE
    quantities in the same decision (seconds vs seconds, error vs
    error). The first ``baseline_n`` samples of a model lock its
    baseline log-ratio — the systematic model-to-hardware offset, which
    is expected (modeled comm seconds price only the wire; measured
    dispatch time includes compute) and is NOT drift. After the lock,
    ``drift_log2 = log2(measured/modeled) - baseline``; when its
    absolute value exceeds ``threshold_log2`` a ``model_drift`` event
    (unified schema, :mod:`quest_tpu_torch.telemetry.events`) is recorded and
    the optional recalibration hook fires. ``drift_ratio`` (the gauge)
    is ``2**drift_log2`` — 1.0 means the model still predicts what it
    predicted at baseline.
    """

    def __init__(self, threshold_log2: Optional[float] = None,
                 baseline_n: int = 4, max_events: int = 256):
        if threshold_log2 is None:
            try:
                threshold_log2 = float(os.environ.get(
                    "QUEST_TPU_DRIFT_LOG2", "1.0"))
            except ValueError:
                threshold_log2 = 1.0
        self.threshold_log2 = float(threshold_log2)
        self.baseline_n = max(1, int(baseline_n))
        self._lock = threading.Lock()
        self._models: dict = {}
        self._t0 = time.monotonic()
        self._recalibrate = None
        self.events: collections.deque = collections.deque(
            maxlen=max(1, int(max_events)))

    def set_recalibrate(self, fn) -> None:
        """Opt-in hook ``fn(model_name)`` invoked (outside the monitor
        lock) whenever a drift event fires for ``model_name``."""
        self._recalibrate = fn

    def reset(self, model: Optional[str] = None) -> None:
        """Drop a model's baseline (all models when ``model`` is None)
        so the next samples re-establish it — the post-recalibration
        step."""
        with self._lock:
            if model is None:
                self._models.clear()
            else:
                self._models.pop(model, None)

    def record(self, model: str, modeled: float, measured: float) -> None:
        """One modeled-vs-measured observation (non-positive values are
        ignored: a zero model prices nothing to compare)."""
        if not (modeled > 0.0 and measured > 0.0):
            return
        log2r = math.log2(measured / modeled)
        fired = None
        with self._lock:
            st = self._models.get(model)
            if st is None:
                st = {"samples": 0, "baseline": None, "_bsum": 0.0,
                      "_bn": 0, "drift_log2": 0.0, "drift_ratio": 1.0,
                      "drift_events": 0, "last_log2_ratio": 0.0}
                self._models[model] = st
            st["samples"] += 1
            st["last_log2_ratio"] = log2r
            if st["baseline"] is None:
                st["_bsum"] += log2r
                st["_bn"] += 1
                if st["_bn"] >= self.baseline_n:
                    st["baseline"] = st["_bsum"] / st["_bn"]
                dev = 0.0
            else:
                dev = log2r - st["baseline"]
            st["drift_log2"] = dev
            st["drift_ratio"] = 2.0 ** dev
            if abs(dev) > self.threshold_log2:
                st["drift_events"] += 1
                ev = make_event(
                    "model_drift", self._t0, model=model,
                    drift_ratio=round(2.0 ** dev, 6),
                    drift_log2=round(dev, 4),
                    modeled=float(modeled), measured=float(measured),
                    threshold_log2=self.threshold_log2)
                self.events.append(ev)
                fired = model
            recal = self._recalibrate
        if fired is not None and recal is not None:
            try:
                recal(fired)
            except (RuntimeError, ValueError, OSError, TypeError):
                pass    # recalibration is best-effort; drift is recorded

    def snapshot(self) -> dict:
        with self._lock:
            models = {name: {k: v for k, v in st.items()
                             if not k.startswith("_")}
                      for name, st in self._models.items()}
            for st in models.values():
                if st["baseline"] is None:
                    st["baseline"] = 0.0
                    st["baseline_locked"] = False
                else:
                    st["baseline_locked"] = True
            return {"threshold_log2": self.threshold_log2,
                    "baseline_n": self.baseline_n,
                    "models": models,
                    "events": list(self.events)}


class _KeyStats:
    """One profile key's accumulated device-time distribution."""

    __slots__ = ("fields", "hist", "bytes_per_pass")

    def __init__(self, fields: dict):
        self.fields = fields
        self.hist = Histogram("dispatch_s", buckets=LATENCY_BUCKETS_S)
        self.bytes_per_pass = 0.0


class _Sample:
    """One sampled dispatch: created at dispatch entry (so injected
    stalls and the whole dispatch land inside the span), closed by
    :meth:`done` with the full key once the dispatch's mode/bucket are
    known. On a card the span is a pair of CUDA events on the current
    stream; ``start`` is the first, recorded here."""

    __slots__ = ("_profiler", "site", "t0", "start")

    def __init__(self, profiler_: "DispatchProfiler", site: str,
                 t0: float):
        self._profiler = profiler_
        self.site = site
        self.t0 = t0
        self.start = None
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()

    def done(self, out=None, *, program: str = "", kind: str = "",
             bucket: int = 0, tier: str = "env", dtype: str = "",
             sharding: str = "none", replica: str = "",
             bytes_per_pass: float = 0.0, models: Optional[dict] = None
             ) -> float:
        """Close the span at device completion: on a card an end event
        is recorded on the same stream and waited on, and the time is
        the events' interval, so the measured time covers the device
        work, not the asynchronous enqueue (``out``, the dispatch's
        results, is accepted for the JAX package's call form; the stream
        order covers it); on the CPU the host clock. ``models`` maps
        drift-model names to their modeled quantity for this dispatch.
        Returns the measured seconds."""
        if self.start is not None:
            import torch
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self.start.elapsed_time(end) / 1e3
        else:
            dt = time.monotonic() - self.t0
        self._profiler._record(
            self.site, dt, program=program, kind=kind, bucket=bucket,
            tier=tier, dtype=dtype, sharding=sharding, replica=replica,
            bytes_per_pass=bytes_per_pass, models=models)
        return dt


class DispatchProfiler:
    """Deterministic-stride dispatch profiler + drift monitor.

    ``sample_rate`` in [0, 1] gates :meth:`start` exactly like
    :class:`~quest_tpu_torch.telemetry.tracing.Tracer`: rate 0 (the default)
    costs one float compare per dispatch; a positive rate samples
    ``floor(N * rate)`` of every ``N`` dispatches on a reproducible
    stride (never a random draw — replayed incidents must profile the
    same dispatches). ``max_keys`` bounds the per-key histogram map; a
    workload cycling more distinct keys keeps its existing keys and
    counts the drops.
    """

    def __init__(self, sample_rate: float = 0.0, max_keys: int = 256,
                 name: str = "dispatch_profiler",
                 drift_threshold_log2: Optional[float] = None,
                 drift_baseline_n: int = 4):
        if not (0.0 <= sample_rate <= 1.0):
            raise ValueError(
                f"profile sample rate must be in [0, 1], got "
                f"{sample_rate!r}")
        self.name = name
        self.sample_rate = float(sample_rate)
        self.max_keys = max(1, int(max_keys))
        self._lock = threading.Lock()
        self._seen = 0
        self._sampled = 0
        self._keys_dropped = 0
        self._keys: dict = {}
        self.drift = DriftMonitor(threshold_log2=drift_threshold_log2,
                                  baseline_n=drift_baseline_n)
        self._peak = None       # (name, B/s), resolved lazily
        metrics_registry().register(name, self.snapshot,
                                    kind="profiler", owner=self)

    # -- sampling ----------------------------------------------------------

    def start(self, site: str) -> Optional[_Sample]:
        """A new sampled dispatch span, or None (unsampled / disabled).
        Rate 0 returns before touching the lock."""
        rate = self.sample_rate
        if rate <= 0.0:
            return None
        with self._lock:
            self._seen += 1
            take = int(self._seen * rate) > int((self._seen - 1) * rate)
            if not take:
                return None
            self._sampled += 1
        return _Sample(self, site, time.monotonic())

    def _record(self, site: str, dt: float, *, program: str, kind: str,
                bucket: int, tier: str, dtype: str, sharding: str,
                replica: str, bytes_per_pass: float,
                models: Optional[dict]) -> None:
        fields = {"site": site, "program": str(program)[:16],
                  "kind": kind, "bucket": int(bucket), "tier": tier,
                  "dtype": dtype, "sharding": sharding,
                  "replica": replica}
        keystr = "|".join((site, fields["program"], kind,
                           f"b{int(bucket)}", tier, dtype, sharding,
                           replica))
        with self._lock:
            ks = self._keys.get(keystr)
            if ks is None:
                if len(self._keys) >= self.max_keys:
                    self._keys_dropped += 1
                    ks = None
                else:
                    ks = _KeyStats(fields)
                    self._keys[keystr] = ks
        if ks is not None:
            # the histogram carries its own lock; observing outside the
            # profiler lock keeps the acquisition graph a simple chain
            ks.hist.observe(dt)
            if bytes_per_pass > 0.0:
                ks.bytes_per_pass = float(bytes_per_pass)
        for model, modeled in (models or {}).items():
            self.drift.record(model, float(modeled), dt)

    # -- reading -----------------------------------------------------------

    def _peak_bw(self) -> tuple:
        if self._peak is None:
            self._peak = platform_peak_bytes_per_s()
        return self._peak

    @staticmethod
    def _render_keys(items, peak_bw: float) -> dict:
        """Per-key percentile/roofline documents from ``(keystr,
        _KeyStats)`` pairs — shared by :meth:`snapshot` (live view) and
        :meth:`flush_to_ledger` (drained view)."""
        keys = {}
        for keystr, ks in items:
            count = ks.hist.count
            total = ks.hist.sum
            mean = total / count if count else 0.0
            achieved = ks.bytes_per_pass / mean \
                if (mean > 0.0 and ks.bytes_per_pass > 0.0) else 0.0
            keys[keystr] = {
                **ks.fields,
                "count": count,
                "mean_s": mean,
                "p50_s": ks.hist.percentile(50.0),
                "p99_s": ks.hist.percentile(99.0),
                "bytes_per_pass": ks.bytes_per_pass,
                "achieved_bytes_per_s": achieved,
                "roofline_frac": achieved / peak_bw if peak_bw else 0.0,
            }
        return keys

    def snapshot(self) -> dict:
        """The profiler's full state as a plain dict: counters, per-key
        device-time percentiles + achieved bytes/s + roofline_frac, and
        the drift monitor's per-model gauges/events."""
        peak_name, peak_bw = self._peak_bw()
        with self._lock:
            items = list(self._keys.items())
            out = {"sample_rate": self.sample_rate,
                   "dispatches_seen": self._seen,
                   "dispatches_sampled": self._sampled,
                   "keys_dropped": self._keys_dropped,
                   "roofline_model": peak_name,
                   "peak_bytes_per_s": peak_bw}
        out["keys"] = self._render_keys(items, peak_bw)
        out["drift"] = self.drift.snapshot()
        return out

    stats = snapshot

    def reset(self) -> None:
        with self._lock:
            self._seen = 0
            self._sampled = 0
            self._keys_dropped = 0
            self._keys.clear()
        self.drift.reset()
        self.drift.events.clear()

    def flush_to_ledger(self, ledger) -> int:
        """DRAIN the accumulated per-key aggregates into a
        :class:`~quest_tpu_torch.telemetry.ledger.PerfLedger`. The key map is
        SWAPPED OUT under the lock before anything is rendered, so two
        flushing owners (every closing service flushes) each persist a
        disjoint set of measurements — never the same one twice — and a
        dispatch recorded mid-flush lands in the fresh map rather than
        being erased. Returns the number of ledger keys written."""
        with self._lock:
            drained = self._keys
            self._keys = {}
        if not drained:
            return 0
        _, peak_bw = self._peak_bw()
        return ledger.record_profile(
            {"keys": self._render_keys(list(drained.items()), peak_bw)})


# ---------------------------------------------------------------------------
# the process-global profiler (the instance every dispatch site records
# into; the exporters scrape it through the metrics registry)
# ---------------------------------------------------------------------------

def _env_rate() -> float:
    raw = os.environ.get("QUEST_TPU_PROFILE_RATE", "").strip()
    if raw:
        try:
            return min(max(float(raw), 0.0), 1.0)
        except ValueError:
            return 0.0
    if os.environ.get("QUEST_TPU_PROFILE", "") not in ("", "0", "off"):
        return DEFAULT_PROFILE_RATE
    return 0.0


_PROFILER = DispatchProfiler(sample_rate=_env_rate())


def profiler() -> DispatchProfiler:
    """The process-global :class:`DispatchProfiler` (default off —
    enable with :func:`configure` or ``QUEST_TPU_PROFILE[_RATE]``)."""
    return _PROFILER


def configure(sample_rate: Optional[float] = None,
              drift_threshold_log2: Optional[float] = None,
              reset: bool = False) -> DispatchProfiler:
    """(Re)configure the global profiler. ``reset=True`` clears the
    accumulated keys, counters, drift baselines, and events first."""
    if reset:
        _PROFILER.reset()
    if sample_rate is not None:
        if not (0.0 <= float(sample_rate) <= 1.0):
            raise ValueError(
                f"profile sample rate must be in [0, 1], got "
                f"{sample_rate!r}")
        _PROFILER.sample_rate = float(sample_rate)
    if drift_threshold_log2 is not None:
        _PROFILER.drift.threshold_log2 = float(drift_threshold_log2)
    return _PROFILER


def profile_dispatch(site: str) -> Optional[_Sample]:
    """The dispatch-site hook: a :class:`_Sample` for this dispatch, or
    None (disabled / unsampled — ONE float compare). Create it BEFORE
    the fault hook fires so injected stalls land inside the measured
    span; close it with ``sample.done(out, **key)`` once the dispatch's
    bucket/tier/sharding are known. Every fault-hooked dispatch boundary
    carries a trace annotation AND this hook."""
    p = _PROFILER
    if p.sample_rate <= 0.0:
        return None
    return p.start(site)


def record_model(model: str, modeled: float, measured: float) -> None:
    """Feed one modeled-vs-measured pair to the global drift monitor
    (no-op while profiling is disabled — the monitor's baselines should
    only accumulate when the operator asked for the loop)."""
    p = _PROFILER
    if p.sample_rate <= 0.0:
        return
    p.drift.record(model, modeled, measured)


def enable_recalibration() -> None:
    """Opt in to recalibration on drift: a ``model_drift`` event resets
    that model's drift baseline so the next samples are judged fresh.
    Also enabled by ``QUEST_TPU_DRIFT_RECALIBRATE=1``. (The JAX package
    also refits its collective-cost model here; one card has none.)"""

    def _recal(model: str) -> None:
        _PROFILER.drift.reset(model)

    _PROFILER.drift.set_recalibrate(_recal)


if os.environ.get("QUEST_TPU_DRIFT_RECALIBRATE", "") not in ("", "0",
                                                             "off"):
    enable_recalibration()
