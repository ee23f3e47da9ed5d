"""The port's explicit shard exchange (quest_tpu_torch/parallel/exchange.py)
on CPU shards, against whole-state references, in float64.

- ``run_exchange`` on random chunks equals the transpose of the whole
  state (``layout.apply_relayout``), for random relayouts at 2 and 3 shard
  bits, with and without a batch axis; the residual permutation's
  relabelling and its copy form agree;
- the role-split cross-shard 1q gate, with local and device controls and
  a flipped control, equals the gate engine on the whole state, and so
  does a per-row operator over a batch;
- the slab double-buffered relayout+gate equals the relayout then the
  gate (to rounding: the gate engine's matmul runs on the slab's shape);
- a device-bit control skips shards and a diagonal's device-bit axes are
  sliced per shard (``apply_op_local``);
- the shard-local two-stage sampler draws the whole-state sampler's
  outcomes from the same uniforms, and its totals sum to the norm;
- the exchange counters and log;
- the comm model measured on CPU shards, its cache and the pinned default,
  and the profiling hooks (``GateStats``, ``probe_gate``, ``trace``) on a
  mesh register.
"""

import itertools

import numpy as np
import pytest
import torch

from quest_tpu_torch.core.apply import apply_diagonal, apply_unitary
from quest_tpu_torch.parallel import exchange as ex
from quest_tpu_torch.parallel.layout import apply_relayout
from quest_tpu_torch.parallel.sampling import sample_outcomes, sample_sharded
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12


def rand_planes(rng, n, batch=None):
    shape = (2, 1 << n) if batch is None else (batch, 2, 1 << n)
    return torch.as_tensor(rng.normal(size=shape))


def split(planes, s):
    D = 1 << s
    C = planes.shape[-1] // D
    return [planes[..., d * C:(d + 1) * C].clone() for d in range(D)]


def join(chunks):
    return torch.cat(chunks, dim=-1)


def rand_u(rng, k):
    m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(
        size=(1 << k, 1 << k))
    return np.linalg.qr(m)[0]


@pytest.mark.parametrize("batch", [None, 3])
@pytest.mark.parametrize("n,s", [(6, 2), (7, 3)])
def test_run_exchange_is_the_transpose(n, s, batch):
    rng = np.random.default_rng(n + s)
    perms = list(itertools.permutations(range(n)))
    for idx in rng.choice(len(perms), size=40, replace=False):
        before = tuple(int(p) for p in rng.permutation(n))
        after = tuple(int(p) for p in perms[int(idx)])
        state = rand_planes(rng, n, batch)
        want = apply_relayout(state, n, before, after)
        chunks = split(state, s)
        ex.run_exchange(chunks, ex.plan_exchange(n, s, before, after))
        assert torch.equal(join(chunks), want)


def test_residual_permutation_copy_equals_relabel():
    rng = np.random.default_rng(4)
    chunks = [torch.as_tensor(rng.normal(size=(2, 8))) for _ in range(8)]
    pairs = tuple((v, (v * 3 + 1) % 8) for v in range(8))
    a = [c.clone() for c in chunks]
    b = [c.clone() for c in chunks]
    timer = ex._Timed(a, "test")
    ex._ppermute(a, pairs, timer, copy=False)
    ex._ppermute(b, pairs, timer, copy=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    for src, dst in pairs:
        assert torch.equal(a[dst], chunks[src])


CASES = [  # (position offset above lt, ctrl_mask, flip_mask)
    (0, 0, 0),
    (1, 0b101, 0),           # two local controls
    (2, 0b10, 0b10),         # a flipped local control
    (0, 1 << 9, 0),          # a device control (n=10, s=3 -> lt=7)
    (2, (1 << 8) | 1, 1 << 8),  # a flipped device control and a local one
]


@pytest.mark.parametrize("case", CASES)
def test_cross_shard_1q_equals_whole_state(case, monkeypatch):
    monkeypatch.setattr(ex, "_SLAB_AMPS", 32)   # several slabs per chunk
    n, s = 10, 3
    lt = n - s
    off, cm, fm = case
    rng = np.random.default_rng(off + cm)
    u = rand_u(rng, 1)
    state = rand_planes(rng, n)
    want = apply_unitary(state.clone(), n, u, (lt + off,), cm, fm)
    chunks = split(state, s)
    ex.apply_1q_cross_shard(chunks, u, lt + off, lt, s, cm, fm)
    assert (join(chunks) - want).abs().max() < TOL


def test_cross_shard_1q_per_row_operator():
    n, s, B = 8, 2, 4
    rng = np.random.default_rng(9)
    us = np.stack([rand_u(rng, 1) for _ in range(B)])
    state = rand_planes(rng, n, B)
    want = apply_unitary(state.clone(), n, us, (n - 1,), 0b11, 0b01)
    chunks = split(state, s)
    ex.apply_1q_cross_shard(chunks, us, n - 1, n - s, s, 0b11, 0b01)
    assert (join(chunks) - want).abs().max() < TOL


@pytest.mark.parametrize("seed", range(4))
def test_overlapped_equals_plain(seed):
    n, s = 9, 2
    lt = n - s
    rng = np.random.default_rng(seed)
    # bring the two device bits down onto the staging slots, as the
    # planner does, and run a 2q gate on them
    before = tuple(range(n))
    after = list(range(n))
    after[lt - 1], after[n - 1] = n - 1, lt - 1
    after[lt - 2], after[n - 2] = n - 2, lt - 2
    plan = ex.plan_exchange(n, s, before, after)
    targets = (lt - 1, 1) if seed % 2 else (lt - 2, lt - 1)
    cm = 0b1 if seed >= 2 else 0
    assert ex.overlap_eligible(plan, targets, cm)
    u = rand_u(rng, 2)
    state = rand_planes(rng, n)
    plain = split(state, s)
    ex.run_exchange(plain, plan)
    ex.apply_op_local(plain, "u", u, targets, cm, 0, lt)
    fused = split(state, s)
    ex.run_exchange_overlapped(fused, plan, u, targets, cm, 0)
    for a, b in zip(plain, fused):
        assert (a - b).abs().max() < TOL


def test_overlap_eligibility_rules():
    n, s = 8, 2
    lt = n - s
    after = list(range(n))
    after[lt - 1], after[n - 1] = n - 1, lt - 1
    plan = ex.plan_exchange(n, s, tuple(range(n)), after)
    slab = lt - plan.k - 1
    assert ex.overlap_eligible(plan, (0,), 0)
    assert not ex.overlap_eligible(plan, (slab,), 0)
    assert not ex.overlap_eligible(plan, (0,), 1 << slab)
    assert not ex.overlap_eligible(
        ex.plan_exchange(n, s, tuple(range(n)), tuple(range(n))), (0,), 0)


def test_device_controls_and_diagonals_per_shard():
    n, s = 8, 2
    lt = n - s
    rng = np.random.default_rng(12)
    state = rand_planes(rng, n)
    u = rand_u(rng, 2)
    cm, fm = (1 << (n - 1)) | (1 << 1), 1 << (n - 1)
    want = apply_unitary(state.clone(), n, u, (0, 3), cm, fm)
    chunks = split(state, s)
    ex.apply_op_local(chunks, "u", u, (0, 3), cm, fm, lt)
    assert (join(chunks) - want).abs().max() < TOL
    d = np.exp(1j * rng.uniform(0, 6, size=(2, 2, 2)))
    pos = (n - 1, 5, 2)                      # one device bit, sorted desc
    want = apply_diagonal(state.clone(), n, pos, d)
    chunks = split(state, s)
    ex.apply_op_local(chunks, "diag", d, pos, 0, 0, lt)
    assert (join(chunks) - want).abs().max() < TOL
    d1 = np.exp(1j * rng.uniform(0, 6, size=(2,)))
    want = apply_diagonal(state.clone(), n, (n - 2,), d1)
    chunks = split(state, s)
    ex.apply_op_local(chunks, "diag", d1, (n - 2,), 0, 0, lt)
    assert (join(chunks) - want).abs().max() < TOL


def test_sample_sharded_matches_whole_state_draws():
    n, s = 10, 3
    rng = np.random.default_rng(21)
    state = rand_planes(rng, n)
    u = torch.as_tensor(rng.uniform(size=4000))
    probs = state[0] ** 2 + state[1] ** 2
    want, total = sample_outcomes(probs, u)
    got, got_total = sample_sharded(split(state, s), u, False, n, n - s)
    assert abs(got_total - float(total)) < 1e-9 * float(total)
    # the two cumulative sums differ only by rounding: a draw may move only
    # when it lands within rounding of a bin edge
    assert np.mean(got == want.numpy()) > 0.999


def test_counters_and_log():
    n, s = 6, 2
    rng = np.random.default_rng(2)
    chunks = split(rand_planes(rng, n), s)
    after = list(range(n))
    after[0], after[n - 1] = n - 1, 0
    ex.reset_counts()
    ex.start_log()
    ex.run_exchange(chunks, ex.plan_exchange(n, s, tuple(range(n)), after))
    ex.apply_1q_cross_shard(chunks, rand_u(rng, 1), n - 2, n - s, s)
    log = ex.stop_log()
    assert ex.COUNTS["relayouts"] == 1 and ex.COUNTS["all_to_all"] == 1
    assert ex.COUNTS["xshard"] == 1
    chunk_bytes = 2 * 8 * (1 << (n - s))
    # a 1-bit all-to-all over groups of 2: half of each chunk crosses to
    # the pair, the mesh total of the cost model's (2^k - 1)/2^k per chunk
    assert log[0]["kind"] == "relayout" and log[0]["k"] == 1
    assert log[0]["bytes"] == (1 << s) * chunk_bytes // 2
    assert log[1]["kind"] == "xshard"
    assert all(rec["ms"] >= 0.0 for rec in log)


@pytest.mark.parametrize("t0,t1", [(2e-6, 6e-6), (5e-6, 5e-6)],
                         ids=["rising", "flat"])
def test_comm_model_measured_cached_and_pinned(monkeypatch, t0, t1):
    """The fit's logic on fixed probe seconds: probes that rise with the
    bytes give a measured (alpha, beta); probes that do not give the
    default model. Either is cached until invalidated, and the pin
    returns the default unmeasured."""
    import quest_tpu_torch as tq
    from quest_tpu_torch import profiling as prof
    env = tq.createQuESTEnv(num_devices=4, device="cpu")
    assert prof.comm_model(env) is prof.DEFAULT_COMM_MODEL   # host shards
    prof.invalidate_comm_model()
    probes = {1 << 14: t0, 1 << 20: t1}
    asked = []

    def fixed(mesh, nbytes, trials):
        asked.append(nbytes)
        return probes[nbytes]

    monkeypatch.setattr(prof, "_time_exchange", fixed)
    model = prof.comm_model(env, measure=True)
    assert asked == [1 << 14, 1 << 20]
    if t1 > t0:
        beta = (t1 - t0) / float((1 << 20) - (1 << 14))
        assert model.source == "measured"
        assert model.beta_s_per_byte == beta
        assert model.alpha_s == max(t0 - beta * (1 << 14), 0.0)
    else:
        assert model is prof.DEFAULT_COMM_MODEL
    assert prof.comm_model(env) is model                      # cached
    assert len(asked) == 2
    assert prof.invalidate_comm_model() >= 1
    monkeypatch.setenv("QUEST_TPU_COMM_MODEL", "default")
    assert prof.measure_comm_model(env.mesh) is prof.DEFAULT_COMM_MODEL
    assert prof.comm_model(tq.createQuESTEnv(device="cpu")) is \
        prof.DEFAULT_COMM_MODEL


def test_profiling_hooks_on_a_mesh_register(tmp_path):
    import os
    import quest_tpu_torch as tq
    from quest_tpu_torch import profiling as prof
    env = tq.createQuESTEnv(num_devices=4, precision=tq.DOUBLE,
                            device="cpu")
    q = tq.createQureg(6, env)
    with prof.GateStats() as stats:
        tq.hadamard(q, 5)
        tq.hadamard(q, 0)
        tq.controlledNot(q, 5, 1)
    assert stats.total_calls == 3
    assert stats.entries["hadamard"].calls == 2
    assert "hadamard" in stats.report()
    assert tq.hadamard is not None and not hasattr(tq.hadamard,
                                                   "__wrapped__")
    res = prof.probe_gate(q, tq.hadamard, num_trials=2, targets=range(4, 6))
    assert set(res) == {4, 5} and all(r["min"] > 0 for r in res.values())
    with prof.trace(str(tmp_path)):
        tq.rotateY(q, 5, 0.3)
    assert any(f.startswith("trace_") for f in os.listdir(tmp_path))
