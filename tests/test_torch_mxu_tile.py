"""The PyTorch port's MXU-tile kernel (``apply_mxu_tile`` in
quest_tpu_torch/ops/layer_kernel.py) and the FAST tier's packed-contraction
crossover, against the JAX package's (``pallas_kernels.apply_mxu_tile`` and
``parallel/layout.choose_mxu_contraction``).

On the CPU the port's ``apply_mxu_tile`` runs its plain version; the JAX
kernel runs in Pallas interpret mode, as ``tests/test_mxu_saturation.py``
runs it. Both get the same seeded state and gate. Bars: 1e-12 at float64;
the FAST form within ``FAST_TIER.drift_per_gate`` (absolute, on a
normalised state), the tier model's per-gate budget. The structure tests
compile the same circuit in both packages with the packed contraction
forced on and compare the collected stages at the same tile height (n <= 13,
where both tiles hold the whole register).

The CUDA kernel itself has no CPU form: ``test_kernel_matches_plain_on_card``
holds it against the plain version where a card is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
from quest_tpu.ops import pallas_kernels as pk
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from quest_tpu_torch.core.apply import apply_unitary
from quest_tpu_torch.ops import layer_kernel as lk
from quest_tpu_torch.parallel.layout import choose_mxu_contraction
from torch_threads import one_blas_thread  # noqa: F401

N = 9
TARGETS = [(3,), (8,), (3, 8), (7, 8), (2, 5, 7)]


def _unitary(rng, k):
    d = 1 << k
    z = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _state(rng, n=N):
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return z / np.linalg.norm(z)


def _planes(z, dtype=torch.float64):
    return torch.as_tensor(np.stack([z.real, z.imag]), dtype=dtype)


def _amps(planes):
    p = planes.double().numpy()
    return p[0] + 1j * p[1]


@pytest.mark.parametrize("targets", TARGETS, ids=str)
def test_tile_matches_jax(targets):
    rng = np.random.default_rng(sum(targets) + 3)
    z, u = _state(rng), _unitary(rng, len(targets))
    want = np.asarray(pk.apply_mxu_tile(jnp.asarray(z), N, u, targets,
                                        interpret=True))
    got = lk.apply_mxu_tile(_planes(z), N, u, targets)
    assert np.abs(_amps(got) - want).max() <= 1e-12
    # and the gate engine's own form of the same gate
    ref = apply_unitary(_planes(z), N, u, targets)
    assert np.abs(_amps(got) - _amps(ref)).max() <= 1e-12


@pytest.mark.parametrize("targets", [(3,), (3, 8), (2, 5, 7)], ids=str)
def test_fast_tile_within_the_tier_drift(targets):
    """FAST (bf16 operator, bf16 hi/lo state, float32 sums) moves the
    result, but by less than the tier's modeled per-gate error."""
    rng = np.random.default_rng(len(targets))
    z, u = _state(rng), _unitary(rng, len(targets))
    want = np.asarray(pk.apply_mxu_tile(jnp.asarray(z), N, u, targets,
                                        interpret=True))
    got = lk.apply_mxu_tile(_planes(z, torch.float32), N, u, targets,
                            fast=True)
    dev = np.abs(_amps(got) - want).max()
    assert 0.0 < dev <= tq.FAST_TIER.drift_per_gate


def test_row_target_outside_the_tile_raises():
    """The tile is 64 rows at float64 and 128 at float32, so row targets
    stop at qubits 12 and 13."""
    rng = np.random.default_rng(0)
    u = _unitary(rng, 1)
    with pytest.raises(ValueError, match="outside the 64-row tile"):
        lk.apply_mxu_tile(torch.zeros(2, 1 << 14, dtype=torch.float64), 14,
                          u, (13,))
    with pytest.raises(ValueError, match="outside the 128-row tile"):
        lk.apply_mxu_tile(torch.zeros(2, 1 << 15), 15, u, (14,))
    with pytest.raises(ValueError, match="FAST planes are float32"):
        lk.apply_mxu_tile(torch.zeros(2, 1 << N, dtype=torch.float64), N,
                          u, (3,), fast=True)
    with pytest.raises(ValueError, match="distinct"):
        lk.apply_mxu_tile(torch.zeros(2, 1 << N), N, _unitary(rng, 2),
                          (3, 3))


MODES = [(torch.float32, False), (torch.float64, False),
         (torch.float32, True)]
# the target sets above, and a gate on 4 qubits (513 gate values)
POOL_TARGETS = TARGETS + [(0, 2, 5, 8)]


def _bits(t):
    """A tensor's raw bits, so -0.0 and 0.0 differ."""
    return t.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("dtype,fast", MODES,
                         ids=["f32", "f64", "fast"])
@pytest.mark.parametrize("targets", POOL_TARGETS, ids=str)
def test_cached_pool_equals_the_per_layer_pack(targets, dtype, fast):
    """The geometry's index map gathers, bit for bit, the pool that
    ``_operands`` packs for the gate's own one-stage layer (the path every
    call took before): M^T, or for FAST the bf16 slab order rounded
    through float32; the descriptor and launch geometry too."""
    n = 10
    rng = np.random.default_rng(sum(targets) + 7)
    u = _unitary(rng, len(targets))
    u[0, 0] = complex(-0.0, u[0, 0].imag)    # the embedding adds 0.0
    tile = lk._mxu_tile(n, targets, dtype, fast, torch.device("cpu"))
    tile.fill(u)
    want = lk._operands(lk._mxu_tile_layer(n, u, targets, dtype), n, dtype,
                        torch.device("cpu"), fast)
    got = tile.operands
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
        else:
            assert a == b


def test_tile_cache_stays_bounded():
    lk._MXU_TILES.clear()
    keys = [(n, t) for n in (9, 10, 11, 12) for t in TARGETS]
    tiles = [lk._mxu_tile(n, t, torch.float64, False, torch.device("cpu"))
             for n, t in keys]
    assert len(lk._MXU_TILES) == lk.MXU_TILE_CACHE_SIZE < len(keys)
    # the newest geometry is kept and served again; the oldest went
    n, t = keys[-1]
    assert lk._mxu_tile(n, t, torch.float64, False,
                        torch.device("cpu")) is tiles[-1]
    n, t = keys[0]
    assert lk._mxu_tile(n, t, torch.float64, False,
                        torch.device("cpu")) is not tiles[0]
    assert len(lk._MXU_TILES) == lk.MXU_TILE_CACHE_SIZE
    with pytest.raises(ValueError, match="shape"):
        tiles[-1].fill(np.eye(4))


@pytest.mark.parametrize("targets", [(3,), (3, 8), (2, 5, 7)], ids=str)
def test_repeated_calls_on_one_geometry_match_jax(targets):
    """One cached geometry, a new gate each call: each result matches the
    JAX kernel on the same gate, and each refill of the geometry's pool
    (the buffers the card's calls reuse) is that gate's per-layer pack."""
    rng = np.random.default_rng(len(targets) + 40)
    tile = lk._mxu_tile(N, targets, torch.float64, False, torch.device("cpu"))
    for call in range(3):
        z, u = _state(rng), _unitary(rng, len(targets))
        want = np.asarray(pk.apply_mxu_tile(jnp.asarray(z), N, u, targets,
                                            interpret=True))
        got = lk.apply_mxu_tile(_planes(z), N, u, targets)
        assert np.abs(_amps(got) - want).max() <= 1e-12
        tile.fill(u)
        pool = lk._operands(lk._mxu_tile_layer(N, u, targets, torch.float64),
                            N, torch.float64, torch.device("cpu"), False)[1]
        assert torch.equal(_bits(tile.operands[1]), _bits(pool))
    assert lk._mxu_tile(N, targets, torch.float64, False,
                        torch.device("cpu")) is tile


def test_fast_crossover_prices_the_tensor_cores():
    """At the bf16 tensor-core rate the packed contraction is never slower
    than the row path (both sit at the HBM floor), so FAST takes rowmxu
    for every row gate; at the CUDA-core rate a lone row gate keeps the
    row path. The FAST side can only move the decision toward rowmxu."""
    for j in range(3):
        for k in range(1, 4):
            f = choose_mxu_contraction(j, k, 4, fast=True)
            s = choose_mxu_contraction(j, k, 4)
            assert f["use_mxu"] and f["mxu_seconds"] == f["mem_seconds"]
            assert f["mxu_seconds"] <= s["mxu_seconds"]
            assert f["alt_seconds"] == s["alt_seconds"]
    assert not choose_mxu_contraction(1, 1, 4)["use_mxu"]
    assert not choose_mxu_contraction(1, 1, 4, force=False,
                                      fast=True)["use_mxu"]


def _brickwork(n, layers=2, seed=2026):
    rng = np.random.default_rng(seed)
    c = JCircuit(n)
    for layer in range(layers):
        for q in range(n):
            c.rotate(q, float(rng.uniform(0, 2 * np.pi)), rng.normal(size=3))
        for q in range(layer % 2, n - 1, 2):
            c.cnot(q, q + 1)
    return c


def _records(jc):
    return [(op.kind, op.targets, op.ctrl_mask, op.flip_mask,
             op.mat if op.kind == "u" else op.diag) for op in jc.ops]


def _same(a, b):
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.abs(a - b).max(initial=0) <= 1e-12
    return a == b


def _layers(cc):
    return [op for op in cc._ops if op.kind == "layer"]


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[3]),
            tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[3]))


@pytest.mark.parametrize("n", [10, 13])
def test_fast_compile_collects_the_jax_stages(n, envs, monkeypatch):
    jenv, tenv = envs
    monkeypatch.setenv("QUEST_TPU_MXU_SHAPE", "1")
    jc = _brickwork(n)
    jcc = jc.compile(jenv, pallas="interpret", tier="fast")
    tcc = interop.circuit_from_records(n, _records(jc)).compile(
        tenv, mxu=True, tier="fast")
    jl, tl = _layers(jcc), _layers(tcc)
    assert len(jl) == len(tl) >= 1
    assert "rowmxu" in {st[0] for op in tl for st in op.stages}
    for a, b in zip(jl, tl):
        assert a.members == b.members
        assert _same(a.stages, b.stages)
    assert [jcc._ops[it[1]].kind for it in jcc.plan.items] == \
        [tcc._ops[it[1]].kind for it in tcc.plan.items]


def test_each_tier_keeps_its_own_layers(envs):
    """Unforced, the FAST crossover collects rowmxu stages where SINGLE
    collects row stages; a per-dispatch FAST sweep plans its own layers
    once and keeps them beside the compile-time plan."""
    tenv32 = tq.createQuESTEnv(device="cpu", seed=[3])
    c = interop.circuit_from_records(10, _records(_brickwork(10)))
    cc = c.compile(tenv32)
    kinds = {st[0] for op in _layers(cc) for st in op.stages}
    assert "rowmxu" not in kinds and "row" in kinds
    cc.sweep(np.zeros((1, 0)), tier="fast")
    cc.sweep(np.zeros((1, 0)), tier="fast")
    assert set(cc._plans) == {(torch.float32, False), (torch.float32, True)}
    fast_ops = cc._plan_for(tq.FAST_TIER)[1]
    assert "rowmxu" in {st[0] for op in fast_ops if op.kind == "layer"
                        for st in op.stages}
    assert cc._plan_for(tq.SINGLE_TIER)[1] is cc._ops
    fcc = c.compile(tenv32, tier="fast")
    assert _same([op.stages for op in _layers(fcc)],
                 [op.stages for op in fast_ops if op.kind == "layer"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the MXU-tile kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fast,tol", [(torch.float32, False, 1e-5),
                                            (torch.float64, False, 1e-12),
                                            (torch.float32, True, 1e-5)])
def test_kernel_matches_plain_on_card(card, dtype, fast, tol):
    n = 20
    rng = np.random.default_rng(11)
    for targets in TARGETS:
        u = _unitary(rng, len(targets))
        z = _state(rng, n)
        base = _planes(z, dtype).to(card)
        want = lk.apply_mxu_tile_plain(base.clone(), n, u, targets, fast)
        before = lk.apply_mxu_tile.launches
        got = lk.apply_mxu_tile(base.clone(), n, u, targets, fast=fast)
        torch.cuda.synchronize()
        assert lk.apply_mxu_tile.launches == before + 1
        assert float((got - want).abs().max() / want.abs().max()) <= tol
