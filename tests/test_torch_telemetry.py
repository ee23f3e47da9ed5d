"""The port's telemetry against the JAX package's, on equal inputs.

- ``telemetry/metrics.py``: histogram percentiles and snapshots, counters,
  gauges, the provider registry (weak owners pruned, failing providers
  skipped);
- ``telemetry/events.py``: the event record and ``read_timeline``'s
  warning for a disabled ring;
- ``telemetry/tracing.py``: the deterministic sampling stride, the JSON and
  Chrome trace documents, ``dispatch_annotation`` as a named range;
- ``telemetry/profile.py``: the dispatch profiler's stride and its per-key
  percentiles, bytes/s and ``roofline_frac``; ``DriftMonitor``; the peak
  table (the H100 only, the env override kept);
- ``telemetry/export.py`` and ``endpoints.py``: Prometheus text and the JSON
  snapshot equal for equal providers, the loopback HTTP exporter;
- ``telemetry/ledger.py``: ``PerfLedger`` in ``tmp_path``, its records
  equal to the JAX package's.
"""

import json
import math
import os
import urllib.request

import numpy as np
import pytest
import torch

from quest_tpu.telemetry import endpoints as jend
from quest_tpu.telemetry import events as jev
from quest_tpu.telemetry import export as jexp
from quest_tpu.telemetry import ledger as jled
from quest_tpu.telemetry import metrics as jmet
from quest_tpu.telemetry import profile as jprof
from quest_tpu.telemetry import tracing as jtr
from quest_tpu_torch.telemetry import endpoints as tend
from quest_tpu_torch.telemetry import events as tev
from quest_tpu_torch.telemetry import export as texp
from quest_tpu_torch.telemetry import ledger as tled
from quest_tpu_torch.telemetry import metrics as tmet
from quest_tpu_torch.telemetry import profile as tprof
from quest_tpu_torch.telemetry import tracing as ttr
from torch_threads import one_blas_thread  # noqa: F401

PAIRS = ((jmet, tmet), (jev, tev), (jtr, ttr), (jprof, tprof),
         (jled, tled), (jexp, texp), (jend, tend))


def test_public_names_and_schemas():
    for jmod, tmod in PAIRS:
        assert tmod.__all__ == jmod.__all__, tmod.__name__
    assert tev.EVENT_SCHEMA == jev.EVENT_SCHEMA
    assert ttr.TRACE_SCHEMA == jtr.TRACE_SCHEMA
    assert texp.METRICS_SCHEMA == jexp.METRICS_SCHEMA
    assert tled.PERF_SCHEMA == jled.PERF_SCHEMA
    assert tmet.LATENCY_BUCKETS_S == jmet.LATENCY_BUCKETS_S


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_percentiles_and_snapshot(seed):
    rng = np.random.default_rng(seed)
    values = np.concatenate([rng.lognormal(-6, 2, size=500), [np.nan, 0.0,
                                                                500.0]])
    hs = [mod.Histogram("lat", "seconds") for mod in (jmet, tmet)]
    for h in hs:
        assert h.percentile(50.0) == 0.0
        for v in values:
            h.observe(v)
    for p in (0.0, 1.0, 25.0, 50.0, 90.0, 99.0, 99.9, 100.0):
        assert hs[1].percentile(p) == hs[0].percentile(p), p
    assert hs[1].snapshot() == hs[0].snapshot()
    assert hs[1].count == 502
    with pytest.raises(ValueError):
        tmet.Histogram("x", buckets=(2.0, 1.0))


def test_counter_gauge_and_registry():
    c = tmet.Counter("n")
    c.inc()
    c.inc(4)
    assert c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    g = tmet.Gauge("g")
    g.set(2.5)
    assert g.value == 2.5
    assert tmet.Gauge("f", fn=lambda: 1 / 0).value == 0.0

    class Owner:
        def stats(self):
            return {"a": 1}

    reg = tmet.MetricsRegistry()
    owner = Owner()
    reg.register("svc", owner.stats, kind="service")
    reg.register("sick", lambda: 1 / 0)
    assert [s["name"] for s in reg.collect()] == ["svc"]
    del owner
    assert reg.collect() == [] and reg.names() == ["sick"]
    assert reg.unique_name("service") == "service-1"


def test_events_and_timeline():
    ev = tev.make_event("fault", 0.0, trace_id="abc", rows=[1])
    jevt = jev.make_event("fault", 0.0, trace_id="abc", rows=[1])
    assert list(ev) == list(jevt) and ev["event"] == "fault"
    assert ev["trace"] == "abc" and ev["rows"] == [1]

    class Source:
        def __init__(self, n):
            import collections
            self.events = collections.deque([ev], maxlen=n)

    assert tev.read_timeline(Source(4)) == [ev]
    tev._warned_eventless = False
    with pytest.warns(RuntimeWarning, match="record_events=0"):
        assert tev.read_timeline(Source(0)) == []


def test_tracer_stride_and_documents():
    picks = []
    for mod in (jtr, ttr):
        tracer = mod.Tracer(sample_rate=0.3, max_traces=2, name="t")
        picks.append([tracer.start(k=i) is not None for i in range(40)])
    assert picks[0] == picks[1] and sum(picks[1]) == 12
    docs = []
    for mod in (jtr, ttr):
        tracer = mod.Tracer(sample_rate=1.0, name="svc")
        ctx = tracer.start(service="svc")
        ctx.add("submit", kind="expectation")
        q = ctx.begin("queue")
        ctx.end(q, queue_wait_s=0.001)
        ctx.begin("dispatch", batch=4)
        ctx.finish("ok")
        ctx.finish("late")                    # idempotent
        doc = ctx.to_dict()
        chrome = ctx.chrome_trace()
        docs.append((
            doc["schema"], doc["status"], doc["attrs"],
            [(s["name"], s["span_id"], s["parent_id"], s["status"],
              s["attrs"]) for s in doc["spans"]],
            [(e["name"], e["ph"], e["cat"]) for e in chrome["traceEvents"]],
            tracer.stats(), len(tracer.export_chrome()["traceEvents"])))
    assert docs[0] == docs[1]
    with pytest.raises(ValueError):
        ttr.Tracer(sample_rate=1.5)


def test_dispatch_annotation_is_a_named_range():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with ttr.dispatch_annotation("quest_tpu_torch.serve.dispatch:x"):
            torch.ones(4).sum()
    assert any(e.name == "quest_tpu_torch.serve.dispatch:x"
               for e in prof.events())


def _profiled(mod, peak):
    p = mod.DispatchProfiler(sample_rate=0.5, max_keys=2,
                             name=f"test-profiler-{mod.__name__}",
                             drift_threshold_log2=1.0, drift_baseline_n=2)
    p._peak = ("model", peak)
    taken = [p.start("serve.execute") is not None for _ in range(10)]
    rng = np.random.default_rng(4)
    for i in range(30):
        p._record("serve.execute", float(rng.uniform(1e-3, 3e-2)),
                  program="0123456789abcdef-tail", kind="expectation",
                  bucket=64, tier="env", dtype="float32",
                  sharding="none", replica="svc", bytes_per_pass=1e9,
                  models={"tier_error": 1e-4})
        p._record("serve.execute", 2e-3 * (1 + i % 3), program="p2",
                  kind=f"k{i % 3}", bucket=1, tier="fast", dtype="float32",
                  sharding="none", replica="svc", bytes_per_pass=0.0,
                  models=None)
    return taken, p.snapshot()


def test_profiler_stride_keys_and_roofline():
    jt, js = _profiled(jprof, 3.35e12)
    tt, ts = _profiled(tprof, 3.35e12)
    assert tt == jt and sum(tt) == 5
    for snap in (js, ts):
        for ev in snap["drift"]["events"]:
            ev.pop("t"), ev.pop("wall")
    assert ts == js
    key = ts["keys"]["serve.execute|0123456789abcdef|expectation|b64|env|" +
                     "float32|none|svc"]
    assert key["roofline_frac"] == pytest.approx(
        key["achieved_bytes_per_s"] / 3.35e12)
    assert ts["keys_dropped"] == 20          # keys k1 and k2, 10 each


def test_profiler_sample_times_the_dispatch_on_the_host():
    p = tprof.DispatchProfiler(sample_rate=1.0, name="test-host-timing")
    sp = p.start("circuits.run")
    assert sp.start is None                  # no card: the host clock
    dt = sp.done(None, program="x", kind="run", bucket=1)
    assert dt >= 0.0 and p.snapshot()["dispatches_sampled"] == 1


def test_drift_monitor():
    outs = []
    for mod in (jprof, tprof):
        fired = []
        m = mod.DriftMonitor(threshold_log2=1.0, baseline_n=3)
        m.set_recalibrate(fired.append)
        for modeled, measured in ((1.0, 2.0), (1.0, 2.1), (1.0, 1.9),
                                  (1.0, 2.0), (1.0, 9.0), (0.0, 1.0),
                                  (2.0, 1.0)):
            m.record("tier_error", modeled, measured)
        snap = m.snapshot()
        for ev in snap["events"]:
            ev.pop("t"), ev.pop("wall")
        outs.append((snap, fired))
        m.reset()
        assert m.snapshot()["models"] == {}
    assert outs[0] == outs[1]
    assert outs[1][1] == ["tier_error", "tier_error"]


def test_peak_table(monkeypatch):
    monkeypatch.delenv("QUEST_TPU_PEAK_BW", raising=False)
    assert tprof._PEAK_BW_MODELS == (("h100", 3.35e12),)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tprof.platform_peak_bytes_per_s() == ("host model", 4.2e10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert tprof.platform_peak_bytes_per_s() == ("h100", 3.35e12)
    monkeypatch.setenv("QUEST_TPU_PEAK_BW", "1e12")
    assert tprof.platform_peak_bytes_per_s() == ("env-override", 1e12)


def _provider_doc():
    return {"service": {"completed": 12, "p99_latency_s": 0.0125,
                        "alive": True, "name": "svc-1", "rows": [1, 2],
                        "tenants": {"a b": {"busy_s": 1.5}},
                        "inf": math.inf, "nan": math.nan},
            "gates_in": 40, "batch_sharding_mode": "none"}


def test_prometheus_text_and_json_snapshot():
    docs = []
    for mod, emod in ((jmet, jexp), (tmet, texp)):
        reg = mod.MetricsRegistry()
        reg.register("svc-1", _provider_doc, kind="service",
                     labels={"replica": "r\"0"})
        text = emod.prometheus_text(reg)
        snap = emod.json_snapshot(reg)
        snap.pop("generated_wall")
        docs.append((text, json.dumps(snap, default=str, sort_keys=True)))
        assert emod.validate_prometheus_text(text) == []
    assert docs[0] == docs[1]
    assert 'quest_tpu_service_completed{replica="r_0",source="svc-1"} 12' \
        in docs[1][0]


def test_write_snapshot_and_endpoints(tmp_path):
    reg = tmet.MetricsRegistry()
    reg.register("svc-1", _provider_doc)
    path = texp.write_snapshot(str(tmp_path / "m.prom"), "prom", reg)
    assert open(path).read() == texp.prometheus_text(reg)
    with pytest.raises(ValueError):
        texp.write_snapshot(str(tmp_path / "x"), "xml", reg)

    class Health:
        def dispatch_stats(self):
            return {"alive": True}

    outs = []
    for mod, mreg in ((jend, jmet.MetricsRegistry()), (tend, reg)):
        ep = mod.ObservabilityEndpoints(mreg, Health(),
                                        readiness=lambda: {"ready": False})
        outs.append([ep.resolve(p)[:2] if ep.resolve(p) else None
                     for p in ("/healthz", "/healthz/live", "/healthz/ready",
                               "/metrics", "/metrics.json", "/other")])
    assert outs[0] == outs[1]
    assert tend.health_summary({"replicas": [{"state": "ready"},
                                             {"state": "down"}]}) \
        == jend.health_summary({"replicas": [{"state": "ready"},
                                             {"state": "down"}]})


def test_loopback_http_exporter():
    reg = tmet.MetricsRegistry()
    reg.register("svc-1", _provider_doc)
    with texp.start_http_exporter(port=0, registry=reg) as server:
        assert server.host == "127.0.0.1"
        with urllib.request.urlopen(server.url, timeout=10) as resp:
            body = resp.read().decode()
        with urllib.request.urlopen(server.url + ".json", timeout=10) as r:
            doc = json.loads(r.read())
    assert body == texp.prometheus_text(reg)
    assert doc["sources"][0]["name"] == "svc-1"


def _ledger_run(mod, root):
    led = mod.PerfLedger(root)
    led.record_program("digest-a", requests=10, total_request_s=0.5,
                       buckets={64: 3, 8: 1}, tiers={"env": 4})
    led.record_program("digest-a", requests=6, total_request_s=0.1,
                       buckets={8: 5}, tiers={"fast": 1})
    led.record_program("digest-b", requests=2, total_request_s=1.0)
    assert not led.record_program("", requests=1)
    written = led.record_profile({"keys": {
        "serve.execute|p|expectation|b64|env|float32|none|svc": {
            "site": "serve.execute", "program": "p", "count": 4,
            "mean_s": 0.25, "bytes_per_pass": 1e9, "roofline_frac": 0.1},
        "empty": {"count": 0}}})
    led.append_bench({"metric": "m", "value": 1.5})
    strip = lambda docs: [{k: v for k, v in d.items() if k != "updated_wall"}
                          for d in docs]
    return (strip(led.programs()), strip(led.profiles()), led.bench_rows(),
            led.warm_buckets("digest-a"), led.mean_request_s("digest-a"),
            led.mean_request_s(), written, led.program("missing"))


def test_perf_ledger(tmp_path, monkeypatch):
    j = _ledger_run(jled, str(tmp_path / "jax"))
    t = _ledger_run(tled, str(tmp_path / "torch"))
    assert t == j
    assert t[3] == (8, 64)
    monkeypatch.delenv(tled.PERF_LEDGER_ENV, raising=False)
    assert tled.PerfLedger.from_env() is None
    monkeypatch.setenv(tled.PERF_LEDGER_ENV, str(tmp_path / "env"))
    led = tled.PerfLedger.from_env()
    assert led.root == str(tmp_path / "env") and os.path.isdir(led.root)
