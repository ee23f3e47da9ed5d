"""The port's register checkpoints, segment recovery and lock-order check
against the JAX package's, on the CPU.

Registers of 3-6 qubits. Checkpoints round-trip bit for bit (state
vectors, density registers, QUAD and QUAD64), refuse typed on every
metadata mismatch, and ``save_npz`` files cross between the packages in
both directions bit for bit. ``checkpointed_run`` and
``checkpointed_sweep`` mirror the JAX package's segment-recovery tests
(``tests/test_resilience.py::TestSegmentRecovery``) and agree with the
JAX package's runs at 1e-12; their progress files, and the optimizer's
and the dynamics handles', cross packages. The lock-order check mirrors
``tests/test_lockcheck.py`` and installs beside the JAX package's copy in
either order.
"""

import json
import os
import threading

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu import checkpoint as jckpt
from quest_tpu.resilience import segments as jseg
import quest_tpu_torch as tq
from quest_tpu_torch import checkpoint as ckpt
from quest_tpu_torch.resilience import (FaultInjector, FaultSpec,
                                        HealthConfig, inject)
from quest_tpu_torch.resilience import segments as seg
from quest_tpu_torch.testing import lockcheck
from quest_tpu_torch.testing.lockcheck import LockOrderViolation
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

TOL = 1e-12
TIMEOUT = 30
PREFIX = "test-torch-lockcheck-"


def hea(C, n, layers=1):
    c = C(n)
    for layer in range(layers):
        for q in range(n):
            c.ry(q, c.parameter(f"y{layer}_{q}"))
            c.rz(q, c.parameter(f"z{layer}_{q}"))
        for q in range(n - 1):
            c.cnot(q, q + 1)
    return c


def tenv(precision=None, seed=3):
    return tq.createQuESTEnv(device="cpu", precision=precision or tq.DOUBLE,
                             seed=[seed])


def jenv(precision=None, seed=3):
    return jq.createQuESTEnv(num_devices=1,
                             precision=precision or jq.DOUBLE, seed=[seed])


def random_amps(rng, num):
    v = rng.normal(size=num) + 1j * rng.normal(size=num)
    return v / np.linalg.norm(v)


def port_planes(q):
    return q.state.cpu().numpy()


# -- checkpoints --------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sv_double", "sv_single", "density",
                                  "quad", "quad64"])
def test_round_trip_is_bit_exact(kind, tmp_path):
    rng = np.random.default_rng(11)
    prec = {"sv_single": tq.SINGLE, "quad": tq.QUAD,
            "quad64": tq.QUAD64}.get(kind, tq.DOUBLE)
    env = tenv(prec)
    n = 4
    q = tq.createDensityQureg(n, env) if kind == "density" \
        else tq.createQureg(n, env)
    q.device_put(random_amps(rng, q.num_amps_total))
    want = port_planes(q).copy()
    path = str(tmp_path / "reg")
    ckpt.save(q, path)
    assert os.path.exists(path + ".npz")
    other = tq.createDensityQureg(n, env) if kind == "density" \
        else tq.createQureg(n, env)
    ckpt.load(other, path)
    got = port_planes(other)
    assert got.shape == ((4 if prec.quest_prec == 4 else 2),
                         q.num_amps_total)
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))
    assert other.state.device == env.device


def test_load_of_a_missing_checkpoint_raises(tmp_path):
    q = tq.createQureg(3, tenv())
    with pytest.raises(FileNotFoundError):
        ckpt.load(q, str(tmp_path / "nothing"))


def _write_raw(path, state, meta):
    ckpt.atomic_savez(path, state=state, meta=json.dumps(meta))


@pytest.mark.parametrize("field", ["register", "precision", "num_planes",
                                   "real_dtype", "shape"])
def test_mismatches_are_typed(field, tmp_path):
    env = tenv()
    q = tq.createQureg(3, env)
    tq.initPlusState(q)
    path = str(tmp_path / "reg.npz")
    ckpt.save_npz(q, path)
    with np.load(path) as f:
        state, meta = f["state"], json.loads(str(f["meta"]))
    if field == "register":
        target = tq.createDensityQureg(3, env)
    elif field == "precision":
        target = tq.createQureg(3, tenv(tq.SINGLE))
    else:
        target = tq.createQureg(3, env)
        if field == "num_planes":
            meta.pop("precision")
            meta["num_planes"] = 4
        elif field == "real_dtype":
            meta.pop("precision")
            meta["real_dtype"] = "float32"
        else:
            state = state[:, :4]
        _write_raw(path, state, meta)
    with pytest.raises(ckpt.CheckpointMismatch) as ei:
        ckpt.load_npz(target, path)
    assert ei.value.field == field
    assert isinstance(ei.value, ValueError)


@pytest.mark.parametrize("kind", ["sv", "density", "quad", "quad64"])
def test_npz_files_cross_packages_bit_for_bit(kind, tmp_path):
    """A file written by either package's ``save_npz`` loads in the
    other with the same planes, bit for bit."""
    rng = np.random.default_rng(21)
    tprec, jprec = {"quad": (tq.QUAD, jq.QUAD),
                    "quad64": (tq.QUAD64, jq.QUAD64)}.get(
                        kind, (tq.DOUBLE, jq.DOUBLE))
    n = 3
    te, je = tenv(tprec), jenv(jprec)
    make_t = tq.createDensityQureg if kind == "density" else tq.createQureg
    make_j = jq.createDensityQureg if kind == "density" else jq.createQureg
    tqreg = make_t(n, te)
    tqreg.device_put(random_amps(rng, tqreg.num_amps_total))
    port_file = str(tmp_path / "port.npz")
    ckpt.save_npz(tqreg, port_file)
    jreg = make_j(n, je)
    jckpt.load_npz(jreg, port_file)
    want = port_planes(tqreg)
    got = np.asarray(jreg.state)
    assert got.dtype == want.dtype
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))

    jreg.device_put(random_amps(rng, jreg.num_amps_total))
    jax_file = str(tmp_path / "jax.npz")
    jckpt.save_npz(jreg, jax_file)
    back = make_t(n, te)
    ckpt.load_npz(back, jax_file)
    want = np.asarray(jreg.state)
    got = port_planes(back)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


def test_atomic_writes_leave_the_previous_file(tmp_path, monkeypatch):
    """A crash mid-write leaves the previous checkpoint whole and no temp
    file behind: for ``save_npz`` (``atomic_savez``) and
    ``atomic_write_json``."""
    env = tenv()
    q = tq.createQureg(3, env)
    tq.initPlusState(q)
    path = str(tmp_path / "reg.npz")
    ckpt.save_npz(q, path)
    good = open(path, "rb").read()
    real_savez = np.savez

    def torn_savez(f, **arrays):
        real_savez(f, **arrays)
        raise OSError("disk vanished mid-write")

    monkeypatch.setattr(np, "savez", torn_savez)
    tq.initZeroState(q)
    with pytest.raises(OSError, match="mid-write"):
        ckpt.save_npz(q, path)
    assert open(path, "rb").read() == good
    monkeypatch.setattr(np, "savez", real_savez)

    doc_path = str(tmp_path / "doc.json")
    ckpt.atomic_write_json(doc_path, {"a": 1})
    real_dump = json.dump

    def torn_dump(doc, f, **kw):
        f.write("{\"a\": ")
        raise OSError("disk vanished mid-write")

    monkeypatch.setattr(json, "dump", torn_dump)
    with pytest.raises(OSError):
        ckpt.atomic_write_json(doc_path, {"a": 2})
    monkeypatch.setattr(json, "dump", real_dump)
    assert json.load(open(doc_path)) == {"a": 1}
    assert sorted(os.listdir(tmp_path)) == ["doc.json", "reg.npz"]
    loaded = tq.createQureg(3, env)
    ckpt.load_npz(loaded, path)
    assert abs(tq.calcProbOfOutcome(loaded, 0, 0) - 0.5) < TOL


# -- segment recovery ---------------------------------------------------------

def _params(c, rng):
    return {nm: float(v) for nm, v in
            zip(c.param_names, rng.uniform(0, 2 * np.pi,
                                           len(c.param_names)))}


def _plain_run(pkg, env, c, params, n):
    q = pkg.createQureg(n, env)
    pkg.initZeroState(q)
    c.compile(env).run(q, params)
    return q


def test_split_circuit_preserves_program():
    c = hea(tq.Circuit, 4, layers=2)
    segs = seg.split_circuit(c, 3)
    jsegs = jseg.split_circuit(hea(jq.Circuit, 4, layers=2), 3)
    assert [len(s.ops) for s in segs] == [len(s.ops) for s in jsegs]
    assert sum(len(s.ops) for s in segs) == len(c.ops)
    assert all(s.param_names == c.param_names for s in segs)
    with pytest.raises(ValueError):
        seg.split_circuit(c, 0)


def test_checkpointed_run_matches_plain_run_and_jax(tmp_path):
    rng = np.random.default_rng(5)
    n = 5
    c = hea(tq.Circuit, n, layers=2)
    params = _params(c, rng)
    env = tenv()
    ref = _plain_run(tq, env, c, params, n)
    q = tq.createQureg(n, env)
    tq.initZeroState(q)
    stats = seg.checkpointed_run(c, q, params, num_segments=3,
                                 ckpt_dir=str(tmp_path / "segs"))
    assert np.array_equal(port_planes(q), port_planes(ref))
    assert stats == {"segments": 3, "restarts": 0, "checkpoints": 4,
                     "ckpt_dir": None}
    assert not os.path.exists(tmp_path / "segs")
    je = jenv()
    jc = hea(jq.Circuit, n, layers=2)
    jqreg = jq.createQureg(n, je)
    jq.initZeroState(jqreg)
    jstats = jseg.checkpointed_run(jc, jqreg, params, num_segments=3,
                                   ckpt_dir=str(tmp_path / "jsegs"))
    np.testing.assert_allclose(q.to_numpy(), jqreg.to_numpy(), atol=TOL)
    assert {k: v for k, v in jstats.items() if k != "ckpt_dir"} == \
        {k: v for k, v in stats.items() if k != "ckpt_dir"}


def test_checkpointed_run_recovers_from_transient_fault(tmp_path):
    rng = np.random.default_rng(6)
    n = 4
    c = hea(tq.Circuit, n, layers=2)
    params = _params(c, rng)
    env = tenv()
    ref = _plain_run(tq, env, c, params, n)
    q = tq.createQureg(n, env)
    tq.initZeroState(q)
    inj = FaultInjector([FaultSpec("transient", site="circuits.run",
                                   at_calls=(1, 2))], seed=2)
    with inject(inj):
        stats = seg.checkpointed_run(c, q, params, num_segments=4,
                                     ckpt_dir=str(tmp_path / "segs"),
                                     max_restarts=4, keep_checkpoints=True)
    assert np.array_equal(port_planes(q), port_planes(ref))
    assert stats["restarts"] == 2 and inj.total_injected == 2
    assert sorted(os.listdir(stats["ckpt_dir"])) == [
        f"seg-{k:04d}.npz" for k in range(5)]


def test_checkpointed_run_recovers_from_nan_poisoning(tmp_path):
    n = 4
    c = hea(tq.Circuit, n, layers=2)
    params = {nm: 0.3 for nm in c.param_names}
    env = tenv()
    ref = _plain_run(tq, env, c, params, n)
    q = tq.createQureg(n, env)
    tq.initZeroState(q)
    inj = FaultInjector([FaultSpec("nan", site="circuits.run",
                                   at_calls=(1,))], seed=5)
    with inject(inj):
        stats = seg.checkpointed_run(c, q, params, num_segments=3,
                                     ckpt_dir=str(tmp_path / "segs"),
                                     health=HealthConfig(cadence=1))
    assert np.array_equal(port_planes(q), port_planes(ref))
    assert stats["restarts"] == 1


def test_checkpointed_run_fatal_raises(tmp_path):
    c = hea(tq.Circuit, 3)
    q = tq.createQureg(3, tenv())
    tq.initZeroState(q)
    with pytest.raises(ValueError, match="missing circuit"):
        seg.checkpointed_run(c, q, {}, num_segments=2,
                             ckpt_dir=str(tmp_path / "segs"))


def test_checkpointed_sweep_matches_engine_and_jax():
    rng = np.random.default_rng(7)
    n = 4
    cc = hea(tq.Circuit, n).compile(tenv())
    pm = rng.uniform(0, 2 * np.pi, size=(10, len(cc.param_names)))
    want = cc.sweep(pm).numpy()
    got, stats = seg.checkpointed_sweep(cc, pm, segment_rows=4)
    assert np.array_equal(got, want)
    assert stats == {"segments": 3, "restarts": 0, "resumed_rows": 0,
                     "preemptions": 0}
    jcc = hea(jq.Circuit, n).compile(jenv())
    jgot, jstats = jseg.checkpointed_sweep(jcc, pm, segment_rows=4)
    np.testing.assert_allclose(got, np.asarray(jgot), atol=TOL)
    assert jstats == stats


def test_checkpointed_sweep_recovers_and_resumes(tmp_path):
    """A transient fault re-executes one segment; a bare path resumes
    from the file actually written and cleans up."""
    rng = np.random.default_rng(8)
    cc = hea(tq.Circuit, 3).compile(tenv())
    pm = rng.uniform(0, 2 * np.pi, size=(6, len(cc.param_names)))
    want = cc.sweep(pm).numpy()
    sweep, calls = cc.sweep, []

    def flaky(rows, *args, **kwargs):
        calls.append(len(rows))
        if len(calls) == 2:
            raise RuntimeError("transient device fault")
        return sweep(rows, *args, **kwargs)

    cc.sweep = flaky
    got, st = seg.checkpointed_sweep(cc, pm, segment_rows=2)
    del cc.sweep
    assert np.array_equal(got, want)
    assert st["restarts"] == 1 and st["segments"] == 3
    assert calls == [2, 2, 2, 2]
    path = str(tmp_path / "progress")
    seg.checkpointed_sweep(cc, pm, segment_rows=4, ckpt_path=path,
                           keep_checkpoint=True)
    got2, st2 = seg.checkpointed_sweep(cc, pm, segment_rows=4,
                                       ckpt_path=path)
    assert np.array_equal(got2, want)
    assert st2["resumed_rows"] == 6
    assert not any(tmp_path.iterdir())


def test_torn_sweep_progress_restarts_clean(tmp_path):
    rng = np.random.default_rng(9)
    cc = hea(tq.Circuit, 3).compile(tenv())
    pm = rng.uniform(0, 2 * np.pi, size=(6, len(cc.param_names)))
    want = cc.sweep(pm).numpy()
    path = str(tmp_path / "sweep.npz")
    seg.checkpointed_sweep(cc, pm, segment_rows=2, ckpt_path=path,
                           keep_checkpoint=True)
    blob = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(blob[:len(blob) // 2])
    got, stats = seg.checkpointed_sweep(cc, pm, segment_rows=2,
                                        ckpt_path=path)
    assert np.array_equal(got, want)
    assert stats["resumed_rows"] == 0 and stats["segments"] == 3


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sweep_progress_crosses_packages(writer, tmp_path):
    """A sweep checkpointed by one package resumes in the other under the
    same digest: every row comes from the file, none is recomputed."""
    rng = np.random.default_rng(10)
    n = 3
    pm = rng.uniform(0, 2 * np.pi, size=(6, 2 * n))
    tcc = hea(tq.Circuit, n).compile(tenv())
    jcc = hea(jq.Circuit, n).compile(jenv())
    path = str(tmp_path / "sweep.npz")
    first, second = (jseg, seg) if writer == "jax" else (seg, jseg)
    fcc, scc = (jcc, tcc) if writer == "jax" else (tcc, jcc)
    want, _ = first.checkpointed_sweep(fcc, pm, segment_rows=2,
                                       ckpt_path=path, keep_checkpoint=True)
    got, st = second.checkpointed_sweep(scc, pm, segment_rows=2,
                                        ckpt_path=path)
    assert st["resumed_rows"] == 6 and st["segments"] == 0
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_opt_and_dyn_progress_cross_packages(writer, tmp_path):
    rng = np.random.default_rng(12)
    save_mod, load_mod = (jseg, seg) if writer == "jax" else (seg, jseg)
    x = rng.normal(size=5)
    state = {"m": rng.normal(size=5), "v": rng.normal(size=5) ** 2,
             "t": np.asarray(3.0)}
    p = str(tmp_path / "opt.npz")
    save_mod.opt_progress_save(p, digest="d1", iteration=4, x=x, value=-1.5,
                               opt_state=state)
    got = load_mod.opt_progress_load(p, "d1")
    assert got["iteration"] == 4 and got["value"] == -1.5
    assert np.array_equal(got["x"], x)
    assert all(np.array_equal(got["opt_state"][k], v)
               for k, v in state.items())
    assert load_mod.opt_progress_load(p, "other") is None
    planes = rng.normal(size=(2, 8))
    p = str(tmp_path / "dyn.npz")
    save_mod.dyn_progress_save(p, digest="d2", segment=1, planes=planes,
                               energies=np.arange(4.0),
                               welford=np.array([4.0, 1.5, 0.25]),
                               residual=1e-3)
    got = load_mod.dyn_progress_load(p, "d2")
    assert got["segment"] == 1 and got["residual"] == 1e-3
    assert np.array_equal(got["planes"], planes)
    assert np.array_equal(got["energies"], np.arange(4.0))
    assert load_mod.dyn_progress_load(p, "other") is None
    with open(p, "wb") as f:
        f.write(b"torn")
    assert seg.dyn_progress_load(p, "d2") is None
    assert seg.opt_progress_load(str(tmp_path / "absent.npz"), "d1") is None


# -- the lock-order check -----------------------------------------------------

@pytest.fixture
def _clean_test_sites():
    yield
    lockcheck.clear(PREFIX)


def _mine(vs):
    return [v for v in vs if PREFIX in v.site_a or PREFIX in v.site_b]


@pytest.mark.usefixtures("_clean_test_sites")
class TestLockOrder:
    def test_deliberate_inversion_raises_typed(self):
        a = lockcheck.tracked_lock(PREFIX + "a")
        b = lockcheck.tracked_lock(PREFIX + "b")
        with a:
            with b:
                pass
        with pytest.raises(LockOrderViolation) as ei:
            with b:
                with a:
                    pass
        assert ei.value.site_a == PREFIX + "b"
        assert ei.value.site_b == PREFIX + "a"
        assert PREFIX + "a" in str(ei.value) and PREFIX + "b" in str(ei.value)
        assert any(v.site_b == PREFIX + "a" for v in lockcheck.violations())

    def test_suspended_tracks_nothing_created_inside(self, port_lock_order):
        """A lock the port creates inside ``suspended()`` is a plain lock;
        one created after it is tracked again."""
        from quest_tpu_torch.netserve.robust import TokenBucket
        assert lockcheck.installed()
        with lockcheck.suspended():
            assert not lockcheck.installed()
            inside = TokenBucket(1.0, 1)._lock
        assert lockcheck.installed()
        after = TokenBucket(1.0, 1)._lock
        assert not isinstance(inside, lockcheck._TrackedLock)
        assert isinstance(after, lockcheck._TrackedLock)

    def test_failed_acquire_leaves_the_lock_free(self):
        a = lockcheck.tracked_lock(PREFIX + "a")
        b = lockcheck.tracked_lock(PREFIX + "b")
        with a:
            with b:
                pass
        with pytest.raises(LockOrderViolation):
            with b:
                with a:
                    pass
        assert a.acquire(timeout=0.1)
        a.release()
        assert b.acquire(timeout=0.1)
        b.release()

    def test_cross_thread_inversion_without_deadlock(self):
        a = lockcheck.tracked_lock(PREFIX + "a")
        b = lockcheck.tracked_lock(PREFIX + "b")
        caught = []

        def t1():
            with a:
                with b:
                    pass

        def t2():
            try:
                with b:
                    with a:
                        pass
            except LockOrderViolation as e:
                caught.append(e)

        for target in (t1, t2):
            th = threading.Thread(target=target)
            th.start()
            th.join(TIMEOUT)
        assert len(caught) == 1 and caught[0].site_a == PREFIX + "b"

    def test_transitive_cycle_through_a_third_lock(self):
        a, b, c = (lockcheck.tracked_lock(PREFIX + x) for x in "abc")
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with pytest.raises(LockOrderViolation):
            with c:
                with a:
                    pass
        assert lockcheck.find_cycle() is None

    def test_benign_patterns_are_silent(self):
        r = lockcheck.tracked_lock(PREFIX + "r", rlock=True)
        with r:
            with r:
                pass
        a1 = lockcheck.tracked_lock(PREFIX + "same")
        a2 = lockcheck.tracked_lock(PREFIX + "same")
        with a1:
            with a2:
                pass
        with a2:
            with a1:
                pass
        a = lockcheck.tracked_lock(PREFIX + "a")
        b = lockcheck.tracked_lock(PREFIX + "b")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert PREFIX + "b" in lockcheck.graph().get(PREFIX + "a", {})
        cond = threading.Condition(lockcheck.tracked_lock(PREFIX + "cond",
                                                          rlock=True))
        seen = []

        def waiter():
            with cond:
                while not seen:
                    cond.wait(timeout=1.0)

        t = threading.Thread(target=waiter)
        t.start()
        with cond:
            seen.append(1)
            cond.notify_all()
        t.join(TIMEOUT)
        assert not t.is_alive()
        assert not _mine(lockcheck.violations())

    def test_port_locks_are_tracked_with_port_sites(self):
        with tq.createSimulationService(tenv(), max_wait_s=1e-3) as svc:
            lock = svc._cond._lock
            assert type(lock) is lockcheck._TrackedLock
            assert lock.site.startswith("quest_tpu_torch/serve/engine.py:")
            assert type(svc.metrics._lock) is lockcheck._TrackedLock

    def test_serving_and_router_workload_is_cycle_free(self):
        before = len(lockcheck.violations())
        env = tenv()
        c = tq.Circuit(3)
        c.rx(0, c.parameter("th"))
        c.cnot(0, 1)
        cc = c.compile(env)
        with tq.createSimulationService(env, max_batch=4, max_queue=2,
                                        max_wait_s=0.05) as svc:
            svc.pause()
            futs, rejected = [], 0
            for i in range(8):
                try:
                    futs.append(svc.submit(cc, {"th": 0.1 * i}))
                except tq.serve.QueueFull:
                    rejected += 1
            svc.resume()
            for f in futs:
                f.result(timeout=TIMEOUT)
            assert rejected > 0
            svc.dispatch_stats()
        envs = tq.serve.replica_envs(2, precision=tq.DOUBLE, seed=[4],
                                     device="cpu")
        with tq.createServiceRouter(envs, max_batch=4) as router:
            router.warm(c, batch_sizes=[4])
            futs = [router.submit(c, {"th": 0.05 * i}) for i in range(6)]
            assert all(np.isfinite(f.result(timeout=TIMEOUT)).all()
                       for f in futs)
            router.dispatch_stats()
        assert lockcheck.find_cycle() is None
        assert lockcheck.violations()[before:] == []


def _tracked_kinds():
    """(the port's lock kind, the JAX package's lock kind) of a fresh port
    service's and a fresh JAX service's admission condition."""
    with tq.createSimulationService(tenv(), max_wait_s=1e-3) as tsvc, \
            jq.createSimulationService(jenv(), max_wait_s=1e-3) as jsvc:
        return tsvc._cond._lock, jsvc._cond._lock


def _both_down(jlc):
    # last installed first: each copy restores the factory it wrapped
    lockcheck.uninstall()
    jlc.uninstall()


@pytest.mark.parametrize("order", ["jax_then_port", "port_then_jax"])
def test_installs_beside_the_jax_copy_in_either_order(order):
    """Whichever copy installs second wraps the other's factory; each
    tracks only its own package's locks, the other's passes them
    through."""
    from quest_tpu.testing import lockcheck as jlc
    was_j, was_p = jlc.installed(), lockcheck.installed()
    _both_down(jlc)
    try:
        firsts = (jlc, lockcheck) if order == "jax_then_port" \
            else (lockcheck, jlc)
        for mod in firsts:
            mod.install()
        assert threading.Lock is not None
        tlock, jlock = _tracked_kinds()
        assert type(tlock) is lockcheck._TrackedLock
        assert tlock.site.startswith("quest_tpu_torch/serve/engine.py:")
        assert type(jlock).__name__ == "_TrackedLock"
        assert type(jlock) is not lockcheck._TrackedLock
        assert jlock.site.startswith("quest_tpu/serve/engine.py:")
        for mod in reversed(firsts):
            mod.uninstall()
    finally:
        _both_down(jlc)
        if was_j:
            jlc.install()
        if was_p:
            lockcheck.install()
