"""Serving on mesh envs against the JAX package's, on the CPU.

A :class:`SimulationService` over a mesh env pads each batch bucket to a
multiple of the mesh's shards (``_device_multiple``), as the JAX
package's service does over its virtual devices, so a batch-sharded
dispatch splits evenly. Replicas of ``k`` shards (``replica_envs(
devices_per_replica=k)``: host shards here, the card repeated on the card)
serve behind one router, mirroring ``tests/test_router.py``'s
``TestReplicaEnvs`` and ``TestRouterOracle``; the warm cache refuses the
mesh forms the JAX package's refuses and keeps ``num_devices`` in its
fingerprint. Every ``result()`` has a timeout.
"""

import threading

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.serve.engine import SimulationService as JService
from quest_tpu.serve.warmcache import WarmCache as JWarmCache
import quest_tpu_torch as tq
from quest_tpu_torch.resilience import SupervisorPolicy
from quest_tpu_torch.serve import (ServiceRouter, SimulationService,
                                   WarmCache, replica_envs)
from quest_tpu_torch.serve.warmcache import env_fingerprint
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

TOL = 1e-12
TIMEOUT = 60


def hea(C, n, layers=1):
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n - 1):
            c.cnot(q, q + 1)
    return c


def z_ham(n):
    return ([[(q, 3)] for q in range(n)], [1.0] * n)


def oracle(c, pm, ham):
    env = tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[99])
    return c.compile(env).expectation_sweep(np.asarray(pm), ham)


def results(futs):
    return [f.result(timeout=TIMEOUT) for f in futs]


def test_device_multiple_matches_jax():
    n = 5
    for shards in (1, 4, 8):
        jenv = jq.createQuESTEnv(num_devices=shards, precision=jq.DOUBLE,
                                 seed=[1])
        tenv = tq.createQuESTEnv(num_devices=shards, precision=tq.DOUBLE,
                                 seed=[1], device="cpu")
        jm = JService._device_multiple(hea(jq.Circuit, n).compile(jenv))
        tm = SimulationService._device_multiple(
            hea(tq.Circuit, n).compile(tenv))
        assert tm == jm == shards


@pytest.mark.parametrize("shards,requests", [(4, 3), (4, 2), (8, 3)])
def test_service_bucket_floor_matches_jax(shards, requests):
    """One paused burst of ``requests`` energy requests through a service
    on a ``shards``-shard env and the JAX package's on as many virtual
    devices: the same batches and padded rows (the bucket floored at the
    shard count), and energies equal to a direct sweep at 1e-12."""
    n = 5
    rng = np.random.default_rng(shards + requests)
    ham = z_ham(n)
    got, stats = {}, {}
    for name, qt in (("jax", jq), ("port", tq)):
        kw = {} if qt is jq else {"device": "cpu"}
        env = qt.createQuESTEnv(num_devices=shards, precision=qt.DOUBLE,
                                seed=[3], **kw)
        c = hea(qt.Circuit, n)
        pm = rng.uniform(0, 2 * np.pi, size=(requests, len(c.param_names))) \
            if name == "jax" else pm
        with qt.createSimulationService(env, max_batch=8,
                                        max_wait_s=0.05) as svc:
            svc.pause()
            futs = [svc.submit(c, dict(zip(c.param_names, p)),
                               observables=ham) for p in pm]
            svc.resume()
            got[name] = np.asarray(results(futs), dtype=np.float64)
            stats[name] = svc.dispatch_stats()
    js, ts = stats["jax"]["service"], stats["port"]["service"]
    for key in ("batches", "coalesced_requests", "padded_rows"):
        assert ts[key] == js[key], key
    assert ts["batches"] == 1
    assert ts["padded_rows"] == max(shards, 4 if requests > 2 else 2) \
        - requests
    assert stats["port"]["batch_size"] % shards == 0
    np.testing.assert_allclose(got["port"], got["jax"], atol=TOL)
    np.testing.assert_allclose(got["port"], oracle(hea(tq.Circuit, n), pm,
                                                   ham), atol=TOL)


def test_trajectory_request_on_a_mesh_service():
    """A trajectory request served on a 4-shard env equals the program's
    own batch on the same seed (the service adds no rows to a trajectory
    batch)."""
    rng = np.random.default_rng(3)
    env = tq.createQuESTEnv(num_devices=4, precision=tq.DOUBLE, seed=[5],
                            device="cpu")
    c = tq.Circuit(5)
    for q in range(5):
        c.ry(q, c.parameter(f"a{q}"))
    c.damp(0, 0.3)
    c.cnot(0, 4)
    c.dephase(4, 0.2)
    ham = ([[(0, 3)], [(4, 1), (1, 3)]], [0.6, -0.4])
    p = rng.uniform(0, 2 * np.pi, size=(1, 5))
    with tq.createSimulationService(env, max_batch=4) as svc:
        tp = svc.warm(c, observables=ham, trajectories=32)
        tq.seedQuEST(env, [21])
        got = svc.submit(c, p[0], observables=ham,
                         trajectories=32).result(timeout=TIMEOUT)
    tq.seedQuEST(env, [21])
    means, errs, _ = tp.expectation_batch(p, ham, 32, live_rows=1)
    assert got == (means[0], errs[0])


class TestReplicaEnvs:
    def test_k_shard_replicas(self):
        envs = replica_envs(2, devices_per_replica=4, device="cpu",
                            seed=[3])
        assert [e.num_devices for e in envs] == [4, 4]
        assert all(e.mesh.devices == (torch.device("cpu"),) * 4
                   for e in envs)
        # the JAX package over its 8 virtual devices: the same shapes
        jenvs = jq.serve.replica_envs(2, devices_per_replica=4, seed=[3])
        assert [e.num_devices for e in jenvs] == [4, 4]
        draws = [e.uniform() for e in envs]
        assert len(set(draws)) == 2           # seed + [i] per replica
        ones = replica_envs(3, devices_per_replica=1, device="cpu")
        assert all(e.mesh is None for e in ones)

    def test_validation(self):
        with pytest.raises(ValueError):
            replica_envs(0, device="cpu")
        with pytest.raises(ValueError, match="power of 2"):
            replica_envs(2, devices_per_replica=3, device="cpu")
        with pytest.raises(ValueError, match="devices_per_replica"):
            replica_envs(2, devices_per_replica=0, device="cpu")


def test_router_of_mesh_replicas_oracle():
    """4 threads x 8 requests over 2 replicas of 4 host shards each: every
    energy equals a direct sweep and the JAX package's router over 2 x 4
    virtual devices at 1e-12, both replicas serve, and every bucket is a
    multiple of the replica's shards."""
    n = 5
    rng = np.random.default_rng(1)
    c = hea(tq.Circuit, n)
    ham = z_ham(n)
    pm = rng.uniform(0, 2 * np.pi, size=(32, len(c.param_names)))
    want = oracle(c, pm, ham)
    jc = hea(jq.Circuit, n)
    with jq.createServiceRouter(
            jq.serve.replica_envs(2, devices_per_replica=4, seed=[7]),
            max_batch=8, max_wait_s=5e-3) as jrouter:
        jgot = np.asarray(results([jrouter.submit(
            jc, dict(zip(jc.param_names, p)), observables=ham)
            for p in pm]), dtype=np.float64)
    got = [None] * len(pm)
    errors = []
    sup = SupervisorPolicy(poll_s=0.01, stall_timeout_s=10.0,
                           restart_backoff_s=0.02, probe_timeout_s=TIMEOUT,
                           probe_batch=2)
    envs = replica_envs(2, devices_per_replica=4, precision=tq.DOUBLE,
                        seed=[7], device="cpu")
    with ServiceRouter(envs, supervisor=sup, max_batch=8,
                       max_wait_s=5e-3) as router:
        router.warm(c, batch_sizes=(8,), observables=ham)

        def worker(tid):
            try:
                futs = [(i, router.submit(
                    c, dict(zip(c.param_names, pm[i])), observables=ham))
                    for i in range(tid * 8, tid * 8 + 8)]
                for i, f in futs:
                    got[i] = f.result(timeout=TIMEOUT)
            except Exception as e:        # read on the main thread
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        st = router.dispatch_stats()
    assert not errors, errors
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, jgot, atol=TOL)
    assert st["router"]["routed"] == len(pm)
    assert st["router"]["failovers"] == 0
    for rep in st["replicas"]:
        svc = rep["service"]
        assert svc["completed"] > 0
        assert (svc["coalesced_requests"] + svc["padded_rows"]) % 4 == 0


def test_warm_cache_refuses_mesh_forms_as_jax(tmp_path):
    """The warm cache skips a mesh env's batch-sharded forms where the
    JAX package's skips them ("mesh batch mode"), caches a one-device
    env's, and keeps the shard count in its fingerprint."""
    n = 5
    ham = z_ham(n)
    tenv4 = tq.createQuESTEnv(num_devices=4, precision=tq.DOUBLE, seed=[1],
                              device="cpu")
    tenv1 = tq.createQuESTEnv(precision=tq.DOUBLE, seed=[1], device="cpu")
    jenv4 = jq.createQuESTEnv(num_devices=4, precision=jq.DOUBLE, seed=[1])
    cache = WarmCache(str(tmp_path / "port"))
    jcache = JWarmCache(str(tmp_path / "jax"))
    for batch in (4, 8):
        for kind in ("sweep", "energy"):
            h = ham if kind == "energy" else None
            got = cache.warm_form(hea(tq.Circuit, n).compile(tenv4), kind,
                                  batch, h)
            jgot = jcache.warm_form(hea(jq.Circuit, n).compile(jenv4), kind,
                                    batch, h)
            assert got == jgot == "skip", (kind, batch)
    assert cache.warm_form(hea(tq.Circuit, n).compile(tenv1), "energy", 8,
                           ham) == "miss"
    fp4, fp1 = env_fingerprint(tenv4), env_fingerprint(tenv1)
    assert fp4 != fp1 and "|4|" in fp4
