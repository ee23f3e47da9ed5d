"""The port's persistent warm-start cache against the JAX package's, on the
CPU.

``env_fingerprint`` names its fields; a change of any of them is a miss
(so is an artifact of the JAX package in the same directory); a torn
artifact, or one that describes another plan, counts an error and is
rebuilt; a cold miss is followed by warm hits that pack nothing, whose
installed operands equal a fresh pack bit for bit and whose results equal
a fresh program's; ``lower_batched``'s ``(form, shapes)`` are the JAX
package's for ``sweep``, ``energy`` and ``grad``; and a service's
``warm()`` counts ``warm_cache_hits``/``warm_cache_misses`` as the JAX
package's does. Programs of 8 qubits, so the plans hold fused layers.
"""

import json
import os

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.serve.warmcache import WarmCache as JWarmCache
import quest_tpu_torch as tq
from quest_tpu_torch.ops import cuda_build
from quest_tpu_torch.ops import layer_kernel as lk
from quest_tpu_torch.serve import warmcache as wc
from quest_tpu_torch.serve.warmcache import WarmCache, env_fingerprint
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

N = 8
TIMEOUT = 30


def hea(C, n=N, layers=2):
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n - 1):
            c.cnot(q, q + 1)
    c.h(0).t(1).swap(2, 5)
    return c


def ham(n=N):
    return ([[(q, 3)] for q in range(n)] + [[(0, 1), (n - 1, 1)]],
            [1.0] * n + [0.5])


def tenv(precision=None):
    return tq.createQuESTEnv(device="cpu", precision=precision or tq.DOUBLE,
                             seed=[4])


def packs():
    return lk._operands.packs


def test_fingerprint_fields():
    env = tenv()
    fields = env_fingerprint(env).split("|")
    assert fields == ["quest_tpu_torch", torch.__version__,
                      str(torch.version.cuda or "none"), "cpu", "cpu", "1",
                      "1", "double", "float64", cuda_build.sources_key()]
    assert env_fingerprint(tenv(tq.SINGLE)).split("|")[7:9] == \
        ["single", "float32"]


@pytest.mark.parametrize("field", ["torch", "cuda", "device", "count",
                                   "precision", "sources"])
def test_each_mismatched_field_is_a_miss(field, tmp_path, monkeypatch):
    cache = WarmCache(str(tmp_path))
    c = hea(tq.Circuit)
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "miss"
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "hit"
    env = tenv()
    if field == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    elif field == "cuda":
        monkeypatch.setattr(torch.version, "cuda", "99.9")
    elif field == "device":
        monkeypatch.setattr(wc, "_device_identity",
                            lambda dev: ("NVIDIA H100 80GB HBM3", 1))
    elif field == "count":
        monkeypatch.setattr(wc, "_device_identity", lambda dev: ("cpu", 2))
    elif field == "precision":
        env = tenv(tq.SINGLE)
    else:
        monkeypatch.setattr(cuda_build, "sources_key", lambda: "0" * 16)
    assert cache.warm_form(c.compile(env), "sweep", 4) == "miss"
    st = cache.stats()
    assert (st["hits"], st["misses"], st["errors"]) == (1, 2, 0)


def test_a_jax_artifact_in_the_same_directory_is_a_miss(tmp_path):
    """The JAX package's artifact for the same circuit and form never
    loads in the port: a miss, no error, and the JAX file is left as it
    was."""
    root = str(tmp_path)
    jcache = JWarmCache(root, install_xla_cache=False)
    jcc = hea(jq.Circuit).compile(
        jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[4]))
    jcache.warm_form(jcc, "energy", 4, hamiltonian=ham())
    before = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
              for d, _, fs in os.walk(root) for f in fs}
    cache = WarmCache(root)
    assert cache.warm_form(hea(tq.Circuit).compile(tenv()), "energy", 4,
                           hamiltonian=ham()) == "miss"
    assert cache.stats()["errors"] == 0
    for path, blob in before.items():
        assert open(path, "rb").read() == blob
    assert cache.warm_form(hea(tq.Circuit).compile(tenv()), "energy", 4,
                           hamiltonian=ham()) == "hit"


def _artifact_path(root):
    found = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
             if f.endswith(".warm.pt")]
    assert len(found) == 1
    return found[0]


def test_a_torn_artifact_counts_an_error_and_is_rebuilt(tmp_path):
    cache = WarmCache(str(tmp_path))
    c = hea(tq.Circuit)
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "miss"
    path = _artifact_path(str(tmp_path))
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 3])
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "miss"
    st = cache.stats()
    assert (st["errors"], st["misses"], st["stores"]) == (1, 2, 2)
    assert open(path, "rb").read() == blob          # the slot overwritten
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "hit"


def test_an_artifact_of_another_plan_counts_an_error(tmp_path):
    cache = WarmCache(str(tmp_path))
    c = hea(tq.Circuit)
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "miss"
    path = _artifact_path(str(tmp_path))
    doc = torch.load(path, weights_only=True)
    desc = json.loads(doc["description"])
    desc["items"][0][1] = [99]
    doc["description"] = json.dumps(desc)
    torch.save(doc, path)
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "miss"
    assert cache.stats()["errors"] == 1
    assert cache.warm_form(c.compile(tenv()), "sweep", 4) == "hit"


@pytest.mark.parametrize("kind", ["sweep", "energy", "grad"])
def test_cold_miss_then_warm_hit_packs_nothing(kind, tmp_path):
    """A miss packs every layer the form launches; a hit on a fresh
    program packs none, installs operands equal to a fresh pack bit for
    bit, and the program's results equal a fresh program's."""
    cache = WarmCache(str(tmp_path))
    c = hea(tq.Circuit)
    h = ham() if kind != "sweep" else None
    cold = c.compile(tenv())
    p0 = packs()
    assert cache.warm_form(cold, kind, 4, hamiltonian=h) == "miss"
    layers = cold._form_layers(cold.lower_batched(kind, 4, h, False)[0],
                               None)
    assert layers and packs() - p0 == len(layers)
    assert len(layers) == cold.num_layers * (2 if kind == "grad" else 1)
    warm = c.compile(tenv())
    p0 = packs()
    assert cache.warm_form(warm, kind, 4, hamiltonian=h) == "hit"
    assert packs() == p0
    form = warm.lower_batched(kind, 4, h, False)[0]
    dt, dev = torch.float64, torch.device("cpu")
    for (name, got), (_, want) in zip(warm._form_layers(form, None),
                                      cold._form_layers(form, None)):
        g = lk.packed_operands(got, N, dt, dev)
        w = lk.packed_operands(want, N, dt, dev)
        assert torch.equal(g[0], w[0]) and g[3:] == w[3:], name
        assert torch.equal(g[1].view(torch.int64), w[1].view(torch.int64))
    assert set(warm._dev_operators) == set(cold._dev_operators)
    for key, t in cold._dev_operators.items():
        assert torch.equal(warm._dev_operators[key], t)
    rng = np.random.default_rng(3)
    pm = rng.uniform(0, 2 * np.pi, size=(4, len(c.param_names)))
    fresh = c.compile(tenv())
    if kind == "sweep":
        assert torch.equal(warm.sweep(pm), fresh.sweep(pm))
    elif kind == "energy":
        assert np.array_equal(warm.expectation_sweep(pm, h),
                              fresh.expectation_sweep(pm, h))
    else:
        for a, b in zip(warm.value_and_grad_sweep(pm, h),
                        fresh.value_and_grad_sweep(pm, h)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    assert packs() == p0


@pytest.mark.parametrize("kind", ["sweep", "energy", "grad"])
@pytest.mark.parametrize("batch", [1, 8])
def test_lower_batched_coordinates_match_jax(kind, batch):
    h = ham() if kind != "sweep" else None
    tcc = hea(tq.Circuit).compile(tenv())
    jcc = hea(jq.Circuit).compile(
        jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[4]))
    t_form, t_shapes, t_art = tcc.lower_batched(kind, batch, h, lower=False)
    j_form, j_shapes, _ = jcc.lower_batched(kind, batch, h, lower=False)
    assert t_art is None
    assert t_form == j_form
    assert t_shapes == tuple(tuple(s) for s in j_shapes)
    t_form, _, _ = tcc.lower_batched(kind, batch, h, lower=False,
                                     tier="fast")
    j_form, _, _ = jcc.lower_batched(kind, batch, h, lower=False,
                                     tier="fast")
    assert t_form == j_form


def test_lower_batched_refuses_what_jax_refuses():
    tcc = hea(tq.Circuit).compile(tenv())
    with pytest.raises(ValueError, match="batch"):
        tcc.lower_batched("sweep", 0)
    with pytest.raises(ValueError, match="hamiltonian"):
        tcc.lower_batched("energy", 2)
    with pytest.raises(ValueError, match="unknown warm form"):
        tcc.lower_batched("nope", 2, ham())
    static = tq.Circuit(N)
    static.h(0)
    with pytest.raises(ValueError, match="parameterised"):
        static.compile(tenv()).lower_batched("grad", 2, ham())


def test_service_warm_counts_hits_and_misses_like_jax(tmp_path):
    """A restarted service with a populated directory warms from disk:
    hits where the cold service had misses, and nothing packed."""
    c = hea(tq.Circuit)
    cache = WarmCache(str(tmp_path))
    with tq.createSimulationService(tenv(), warm_cache=cache,
                                    max_batch=8) as svc:
        svc.warm(c, batch_sizes=(1, 3, 8), observables=ham())
        cold = svc.dispatch_stats()["service"]
    assert (cold["warm_cache_misses"], cold["warm_cache_hits"]) == (3, 0)
    p0 = packs()
    with tq.createSimulationService(tenv(), warm_cache=WarmCache(
            str(tmp_path)), max_batch=8) as svc:
        svc.warm(c, batch_sizes=(1, 3, 8), observables=ham())
        warm = svc.dispatch_stats()
        pm = np.random.default_rng(5).uniform(
            0, 2 * np.pi, size=(3, len(c.param_names)))
        futs = [svc.submit(c, row, observables=ham()) for row in pm]
        got = [f.result(timeout=TIMEOUT) for f in futs]
    assert (warm["service"]["warm_cache_hits"],
            warm["service"]["warm_cache_misses"]) == (3, 0)
    assert warm["warm_cache"]["hits"] == 3
    assert packs() == p0
    want = c.compile(tenv()).expectation_sweep(pm, ham())
    np.testing.assert_allclose(got, want, atol=1e-12)


def test_from_env_and_off_switch(tmp_path, monkeypatch):
    monkeypatch.delenv(wc.WARM_CACHE_ENV, raising=False)
    assert WarmCache.from_env() is None
    with tq.createSimulationService(tenv()) as svc:
        assert svc.warm_cache is None
    monkeypatch.setenv(wc.WARM_CACHE_ENV, str(tmp_path / "ambient"))
    with tq.createSimulationService(tenv()) as svc:
        assert svc.warm_cache.root == str(tmp_path / "ambient")
    with tq.createSimulationService(tenv(), warm_cache=False) as svc:
        assert svc.warm_cache is None
