"""The layer kernel's ``rowdiag`` paths in the PyTorch port
(quest_tpu_torch/ops/layer_kernel.py, csrc/layer_kernel.cu): the streaming
entry that a layer of ``rowdiag`` stages only takes, and the run-length
field that lets the tile kernel apply a run of consecutive ``rowdiag``
stages in one pass over the tile.

On the CPU the port's ``apply_layer`` / ``apply_layer_batched`` run their
plain PyTorch version; the JAX package's run its Pallas kernel in
interpret mode, as its own tests run it. Both get the same seeded float64
states and the same stages, shaped like the density QFT's layers (k = 1-3
row bits, inside the tile and above it, 1-7 stages), and both plan with the
same tile height. Bound: 1e-12 on normalised states.

The routing and the descriptors are host code and are checked here; the
CUDA entries themselves have no CPU form, so
``test_both_routes_match_plain_on_card`` holds them against the plain
version where a card is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.ops import pallas_kernels as pk
from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread  # noqa: F401

N = 15                                 # row bits 0..7
TOL = 1e-12
TILE = lk.TILE_ROWS[torch.float64]     # 64 rows: row bits 0..5 in a tile
ABOVE = N - 8                          # row bit 7: above either tile


def _phases(rng, k):
    return np.exp(1j * rng.uniform(0, 2 * np.pi, (1 << k, 128)))


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


# rowdiag stages by their row bits: the density QFT's lifted controlled
# phases pair row bits inside the tile with bits above it
DIAG_CASES = {
    "k1_inside": [(2,)],
    "k1_above": [(ABOVE,)],
    "k2_straddle": [(3, ABOVE)],
    "k3_straddle": [(0, 5, ABOVE)],
    "run3": [(1,), (4, ABOVE), (0, 2, 6)],
    "run7": [(0, ABOVE), (1,), (2, 6, ABOVE), (3, 5), (ABOVE,), (0, 1, 2),
             (4, 6)],
}


def _diag_layer(name, n=N):
    rng = np.random.default_rng(list(DIAG_CASES).index(name))
    stages = [("rowdiag", _phases(rng, len(bits)), bits)
              for bits in DIAG_CASES[name]]
    return stages


def _states(seed, batch, n=N):
    rng = np.random.default_rng(500 + seed)
    z = rng.normal(size=(batch, 1 << n)) + 1j * rng.normal(
        size=(batch, 1 << n))
    return z / np.linalg.norm(z, axis=1, keepdims=True)


def _planes(z):
    return torch.as_tensor(np.stack([z.real, z.imag], axis=-2),
                           dtype=torch.float64)


def _amps(planes):
    p = planes.numpy()
    return p[..., 0, :] + 1j * p[..., 1, :]


# -- routing ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(DIAG_CASES))
def test_rowdiag_only_layer_takes_the_streaming_entry(name):
    layer = lk.LayerOp(N, 1, _diag_layer(name))
    assert lk.is_diagonal_layer(layer)
    assert lk.launch_entry(layer, torch.float32, False) == \
        "quest_layer_diag_f32"
    assert lk.launch_entry(layer, torch.float64, False) == \
        "quest_layer_diag_f64"
    # FAST's rowdiag stages are float32
    assert lk.launch_entry(layer, torch.float32, True) == \
        "quest_layer_diag_f32"


@pytest.mark.parametrize("other", ["lane", "row", "rowk", "rowmxu"])
def test_a_layer_with_other_stages_takes_the_tile_kernel(other):
    rng = np.random.default_rng(3)
    stage = {"lane": ("lane", _unitary(rng, 128)),
             "row": ("row", 8, _unitary(rng, 2), 0, 0, 0, 0),
             "rowk": ("rowk", (0, 2), _unitary(rng, 4), 0, 0, 0, 0),
             "rowmxu": ("rowmxu", (1,), _unitary(rng, 256))}[other]
    layer = lk.LayerOp(N, 2, _diag_layer("run3") + [stage])
    assert not lk.is_diagonal_layer(layer)
    assert lk.launch_entry(layer, torch.float32, False) == \
        "quest_layer_apply_f32"
    assert lk.launch_entry(layer, torch.float64, False) == \
        "quest_layer_apply_f64"
    assert lk.launch_entry(layer, torch.float32, True) == \
        "quest_layer_apply_fast_f32"
    assert not lk.is_diagonal_layer(lk.LayerOp(N, 0, []))


def test_widest_density_layer_tables_fit_the_shared_memory_cap():
    """The widest density-QFT layer (7 stages of k = 3) keeps its tables in
    the streaming entry's shared memory at either dtype: its whole pool is
    within DIAG_TABLE_CAP (at float64 exactly), which one block may hold."""
    rng = np.random.default_rng(4)
    layer = lk.LayerOp(N, 7, [("rowdiag", _phases(rng, 3), (0, 3, ABOVE))
                              for _ in range(7)])
    for dtype in (torch.float32, torch.float64):
        _, pool, _, _ = lk._device_operands(layer, N, dtype,
                                            torch.device("cpu"))
        assert pool.numel() * pool.element_size() <= lk.DIAG_TABLE_CAP
    assert pool.numel() * pool.element_size() == lk.DIAG_TABLE_CAP
    assert lk.DIAG_TABLE_CAP <= lk.SMEM_LIMIT_BYTES


# -- the run-length field ----------------------------------------------------

def _stage_of(code, rng):
    """D: rowdiag, R: row, L: lane, K: rowk (row bits in the tile)."""
    if code == "D":
        return ("rowdiag", _phases(rng, 2), (1, ABOVE))
    if code == "R":
        return ("row", 9, _unitary(rng, 2), 0, 0, 0, 0)
    if code == "L":
        return ("lane", _unitary(rng, 128))
    return ("rowk", (0, 3), _unitary(rng, 4), 0, 0, 0, 0)


def _want_runs(pattern):
    out, run = [], 0
    for code in reversed(pattern):
        run = run + 1 if code == "D" else 0
        out.append(run)
    return out[::-1]


@pytest.mark.parametrize("pattern", [
    "D", "DD", "DDDDDDD", "LD", "DR", "DRD", "DDDLDD", "KDDDDDDDRDDDDD",
    "LDDDDDDDKDRDD", "DDKDDLDDDRDDDDDD"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rowdiag_descriptors_hold_their_run_length(pattern, dtype):
    """A rowdiag descriptor's free slot (column 4) holds the stages left in
    its run, itself included; runs of 1-7 stages broken by row, lane or
    rowk stages, whose column 4 (their lane mask) is left alone."""
    rng = np.random.default_rng(len(pattern))
    stages = [_stage_of(c, rng) for c in pattern]
    layer = lk.LayerOp(N, len(stages), stages)
    desc, pool, _, _ = lk._device_operands(layer, N, dtype,
                                           torch.device("cpu"))
    desc = desc.numpy()
    is_diag = desc[:, 0] == lk.TAG_ROWDIAG
    assert list(is_diag) == [c == "D" for c in pattern]
    assert list(desc[is_diag, 4]) == [r for r, c in zip(_want_runs(pattern),
                                                        pattern) if c == "D"]
    assert not desc[~is_diag, 4].any()
    # each table is read as 16-byte vectors
    assert all(int(off) * pool.element_size() % 16 == 0
               for off in desc[is_diag, 3])
    # the FAST pack marks the same runs
    fdesc = lk._fast_operands(layer, N, torch.device("cpu"))[0].numpy()
    assert np.array_equal(fdesc[is_diag, 4], desc[is_diag, 4])


# -- the layers against the JAX package --------------------------------------

def _jax_layer(stages):
    return pk.LayerOp(N, len(stages), stages)


@pytest.mark.parametrize("name", list(DIAG_CASES))
def test_rowdiag_layer_matches_jax(name):
    stages = _diag_layer(name)
    z = _states(list(DIAG_CASES).index(name), 1)[0]
    want = np.asarray(pk.apply_layer(jnp.asarray(z), N, _jax_layer(stages),
                                     block_rows=TILE, interpret=True))
    planes = _planes(z)
    before = (lk.apply_layer.launches, lk.apply_layer.diag_launches)
    out = lk.apply_layer(planes, N, lk.LayerOp(N, len(stages), stages))
    assert out is planes
    # the CPU runs the plain version: no launch is counted
    assert (lk.apply_layer.launches, lk.apply_layer.diag_launches) == before
    assert np.abs(_amps(planes) - want).max() <= TOL


@pytest.mark.parametrize("name", list(DIAG_CASES))
def test_rowdiag_layer_batched_matches_jax(name):
    batch = 3
    stages = _diag_layer(name)
    z = _states(10 + list(DIAG_CASES).index(name), batch)
    want = np.asarray(pk.apply_layer_batched(
        jnp.asarray(z), N, _jax_layer(stages), block_rows=TILE,
        interpret=True))
    states = _planes(z)
    before = lk.apply_layer_batched.diag_launches
    lk.apply_layer_batched(states, N, lk.LayerOp(N, len(stages), stages))
    assert lk.apply_layer_batched.diag_launches == before
    assert np.abs(_amps(states) - want).max() <= TOL


@pytest.mark.parametrize("batch", [1, 3])
def test_rowdiag_runs_in_a_mixed_layer_match_jax(batch):
    """Runs of rowdiag stages between lane, row and rowk stages: the layer
    the tile kernel applies run by run."""
    rng = np.random.default_rng(batch)
    stages = ([_stage_of("L", rng)] + _diag_layer("run3")
              + [_stage_of("R", rng)] + _diag_layer("k2_straddle")
              + [_stage_of("K", rng)] + _diag_layer("run7"))
    z = _states(20 + batch, batch)
    layer = lk.LayerOp(N, len(stages), stages)
    if batch == 1:
        want = np.asarray(pk.apply_layer(jnp.asarray(z[0]), N,
                                         _jax_layer(stages), block_rows=TILE,
                                         interpret=True))[None]
        states = _planes(z[0])
        lk.apply_layer(states, N, layer)
        got = _amps(states)[None]
    else:
        want = np.asarray(pk.apply_layer_batched(
            jnp.asarray(z), N, _jax_layer(stages), block_rows=TILE,
            interpret=True))
        states = _planes(z)
        lk.apply_layer_batched(states, N, layer)
        got = _amps(states)
    assert np.abs(got - want).max() <= TOL


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the layer kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,fast,tol", [(torch.float32, False, 1e-5),
                                            (torch.float32, True, 1e-5),
                                            (torch.float64, False, 1e-12)])
@pytest.mark.parametrize("batch", [1, 3])
def test_both_routes_match_plain_on_card(card, dtype, fast, tol, batch):
    """The streaming entry (rowdiag only) and the tile kernel's runs (the
    same stages between other stages) against the plain version, relative
    to max|plain|; the diag count moves only for the streaming entry."""
    n = 20
    rng = np.random.default_rng(9)
    far = n - 8
    diag = [("rowdiag", _phases(rng, len(b)), b)
            for b in [(0, far), (1,), (2, 6, far), (3, 5), (far,),
                      (0, 1, 2), (4, 6)]]
    mixed = ([("lane", _unitary(rng, 128))] + diag[:3]
             + [("row", 9, _unitary(rng, 2), 0, 0, 0, 0)] + diag[3:])
    fn, plain = (lk.apply_layer_batched, lk.apply_layer_batched_plain) \
        if batch > 1 else (lk.apply_layer, lk.apply_layer_plain)
    for stages, route in ((diag, 1), (mixed, 0)):
        layer = lk.LayerOp(n, len(stages), stages)
        z = _states(30, batch, n)
        base = _planes(z).to(dtype).to(card)
        if batch == 1:
            base = base[0]
        want = plain(base.clone(), n, layer, fast=fast)
        before = fn.diag_launches
        got = fn(base.clone(), n, layer, fast=fast)
        torch.cuda.synchronize()
        assert fn.diag_launches == before + route
        assert float((got - want).abs().max() / want.abs().max()) <= tol
