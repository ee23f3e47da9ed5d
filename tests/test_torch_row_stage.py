"""The full-precision row stages (quest_tpu_torch/csrc/dense_stage.cuh
``stage_dense_row<T, J>``, J = 1, 2): their shared-memory contract with the
host, and the function they compute against the JAX package's Pallas
kernels.

The row stages run the layer kernel's ``rowmxu`` stages and the MXU tile
on row targets. They stream their ``dim x dim`` operator (dim = 128 << J)
through the lane stage's ring of K slabs beside the tile: a slab is 16 KiB
of each operator plane, K = ``LANE_K >> J`` inputs, so every
full-precision launch keeps the lane stage's sums (``ops/layer_kernel.py``
``shared_memory_bytes`` / ``lane_scratch_bytes``), and the kernel's C entry
point gives the same bytes on the card.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in Pallas interpret mode. The states are small enough that the tile
holds 4-16 rows, fewer groups than the stage spreads its threads over
(16 >> J group blocks of 4 at float64), with row bits adjacent (from row
bit 0) and not. Bound: 1e-12 in float64. The card test holds the kernel
against its plain version at 1e-5 (float32) / 1e-12 (float64) of
max|plain|.
"""

import numpy as np
import pytest
import torch

from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
KIB = 1024
DTYPES = [torch.float32, torch.float64]


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _state(rng, n, num=None):
    shape = (1 << n,) if num is None else (num, 1 << n)
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _amps(planes, axis=0):
    p = planes.numpy()
    return np.take(p, 0, axis) + 1j * np.take(p, 1, axis)


# -- the ring beside the tile ----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("j", [1, 2])
def test_row_slabs_fill_the_lane_ring(dtype, j):
    itemsize = dtype.itemsize
    dim = lk.LANES << j
    k = lk.LANE_K[itemsize] >> j            # inputs per slab
    assert k * dim * itemsize == 16 * KIB   # the lane stage's slab bytes
    assert dim % k == 0 and k % (16 // itemsize) == 0
    assert lk.lane_scratch_bytes(itemsize) == 2 * k * dim * 2 * itemsize
    rows = lk.TILE_ROWS[dtype]
    need = lk.shared_memory_bytes(rows, itemsize)
    assert need == 128 * KIB + 64 * KIB
    assert need <= 227 * KIB == lk.SMEM_LIMIT_BYTES
    # every thread owns 8 outputs of each of its groups: the tile's
    # groups x dim outputs over 256 threads
    groups = rows >> j
    assert groups * dim == 256 * 8 * (32 // itemsize)


@pytest.mark.parametrize("dtype", DTYPES)
def test_a_rowmxu_layer_reserves_the_lane_ring(dtype):
    """A layer with rowmxu stages packs like any full-precision layer:
    its launch reserves tile + lane ring, whatever its widest stage."""
    rng = np.random.default_rng(4)
    n = 14
    stages = [("rowmxu", (1,), _unitary(rng, 256)),
              ("lane", _unitary(rng, 128)),
              ("rowmxu", (0, 2), _unitary(rng, 512))]
    layer = lk.LayerOp(n, len(stages), stages)
    desc, pool, tile_rows, _ = lk._device_operands(layer, n, dtype,
                                                   torch.device("cpu"))
    assert tile_rows == lk.TILE_ROWS[dtype]
    assert lk.shared_memory_bytes(tile_rows, dtype.itemsize) == 192 * KIB
    dense = desc[desc[:, 0] == lk.TAG_DENSE]
    assert [int(r[1]) for r in dense] == [1, 0, 2]
    for row in dense:
        off, dim = int(row[3]), lk.LANES << int(row[1])
        assert off * dtype.itemsize % 16 == 0       # cp.async's alignment
        assert off + 2 * dim * dim <= pool.numel()


# -- the stages' function against the Pallas kernels -----------------------

@pytest.fixture(scope="module")
def pk():
    """The JAX package's Pallas kernels, imported by the tests that run
    them, so the card test below runs where JAX is not installed."""
    from quest_tpu.ops import pallas_kernels
    return pallas_kernels


def _jnp(z):
    import jax.numpy as jnp
    return jnp.asarray(z)


# (qubits, row bits): 4, 8 and 16 rows a tile, row bits from row bit 0
# (adjacent) and not
SMALL_CASES = [(9, (0,)), (9, (1,)), (9, (0, 1)),
               (10, (2,)), (10, (0, 2)), (10, (1, 2)),
               (11, (3,)), (11, (1, 3)), (11, (0, 1))]


def _row_layer(rng, n, bits, mixed, dtype=torch.float64):
    stages = [("rowmxu", bits, _unitary(rng, lk.LANES << len(bits)))]
    if mixed:
        rows = min(lk.TILE_ROWS[dtype], (1 << n) // lk.LANES)
        top = rows.bit_length() - 2       # the tile's top row bit
        stages = [("lane", _unitary(rng, 128))] + stages + [
            ("row", lk.LANE_QUBITS + top, _unitary(rng, 2), 0b10, 0b10, 0,
             0),
            ("rowmxu", (top,), _unitary(rng, 256))]
    return stages


@pytest.mark.parametrize("mixed", [False, True], ids=["alone", "mixed"])
@pytest.mark.parametrize("n,bits", SMALL_CASES, ids=str)
def test_row_stages_match_pallas_interpret(pk, n, bits, mixed):
    rng = np.random.default_rng(10 * n + sum(bits) + mixed)
    stages = _row_layer(rng, n, bits, mixed)
    z = _state(rng, n)
    rows = min(lk.TILE_ROWS[torch.float64], (1 << n) // lk.LANES)
    want = np.asarray(pk.apply_layer(_jnp(z), n,
                                     pk.LayerOp(n, len(stages), stages),
                                     block_rows=rows, interpret=True))
    planes = torch.as_tensor(np.stack([z.real, z.imag]))
    before = lk.apply_layer.launches
    lk.apply_layer(planes, n, lk.LayerOp(n, len(stages), stages))
    assert lk.apply_layer.launches == before
    assert np.abs(_amps(planes) - want).max() <= TOL


@pytest.mark.parametrize("n,bits", SMALL_CASES[::2], ids=str)
def test_batched_row_stages_match_pallas_interpret(pk, n, bits):
    rng = np.random.default_rng(7 * n + sum(bits))
    stages = _row_layer(rng, n, bits, mixed=True)
    z = _state(rng, n, 3)
    rows = min(lk.TILE_ROWS[torch.float64], (1 << n) // lk.LANES)
    want = np.asarray(pk.apply_layer_batched(
        _jnp(z), n, pk.LayerOp(n, len(stages), stages),
        block_rows=rows, interpret=True))
    states = torch.as_tensor(np.stack([z.real, z.imag], axis=1))
    lk.apply_layer_batched(states, n, lk.LayerOp(n, len(stages), stages))
    assert np.abs(_amps(states, axis=1) - want).max() <= TOL


# MXU-tile targets on 4-16 row tiles: one or two row targets among lane
# targets, the row bits adjacent and not
TILE_CASES = [(9, (8,)), (9, (2, 7, 8)), (10, (3, 9)), (10, (7, 9)),
              (11, (0, 10)), (11, (8, 10))]


@pytest.mark.parametrize("n,targets", TILE_CASES, ids=str)
def test_mxu_tile_row_targets_match_pallas_interpret(pk, n, targets):
    rng = np.random.default_rng(n + sum(targets))
    z = _state(rng, n)
    u = _unitary(rng, 1 << len(targets))
    want = np.asarray(pk.apply_mxu_tile(_jnp(z), n, u, targets,
                                        interpret=True))
    planes = torch.as_tensor(np.stack([z.real, z.imag]))
    lk.apply_mxu_tile(planes, n, u, targets)
    assert np.abs(_amps(planes) - want).max() <= TOL


# -- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the row stages run only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_row_stages_match_plain_on_card(card, dtype, tol):
    lib = lk.build_library()[0]
    assert lib.quest_layer_lane_scratch_bytes(dtype.itemsize) == \
        lk.lane_scratch_bytes(dtype.itemsize)
    rng = np.random.default_rng(23)
    for n in (9, 11, 20):
        for bits in ((0,), (1,), (0, 1), (1, 3)):
            if bits[-1] >= min(lk.TILE_ROWS[dtype].bit_length() - 1, n - 7):
                continue
            for mixed in (False, True):
                stages = _row_layer(rng, n, bits, mixed, dtype)
                layer = lk.LayerOp(n, len(stages), stages)
                for batch in (None, 3):
                    z = _state(rng, n, batch)
                    axis = 0 if batch is None else 1
                    base = torch.as_tensor(
                        np.stack([z.real, z.imag], axis=axis), dtype=dtype,
                        device=card)
                    fn, plain = (lk.apply_layer, lk.apply_layer_plain) \
                        if batch is None else \
                        (lk.apply_layer_batched, lk.apply_layer_batched_plain)
                    want = plain(base.clone(), n, layer)
                    got = fn(base.clone(), n, layer)
                    torch.cuda.synchronize()
                    rel = float((got - want).abs().max() / want.abs().max())
                    assert rel <= tol, (n, bits, mixed, batch, rel)
