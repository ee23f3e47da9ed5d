"""The full-precision lane stage (quest_tpu_torch/csrc/dense_stage.cuh
``stage_dense_lane``): its shared-memory contract with the host, and the
function it computes against the JAX package's Pallas kernels.

The stage runs the layer kernel's ``lane`` and ``clane`` stages and the
fused Kraus kernel's drawn operator. It streams its operator through a ring
of K slabs beside the tile, which every full-precision launch reserves;
the host sizes that launch (``ops/layer_kernel.py`` ``shared_memory_bytes``
/ ``lane_scratch_bytes``, ``ops/kraus_kernel.py`` ``shared_memory_for``),
and the kernel's own C entry points give the same bytes on the card.

On the CPU the port's wrappers run their plain versions; the JAX kernels
run in Pallas interpret mode. The states are small enough that the tile
holds fewer than the 16 row blocks the stage spreads its threads over
(rows past the tile are read but never written), down to one row. Bound:
1e-12 in float64. The card test holds the kernels against their plain
versions at 1e-5 (float32) / 1e-12 (float64) of max|plain|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.ops import pallas_kernels as pk
from quest_tpu_torch.ops import kraus_kernel as kk
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


# -- the ring beside the tile ----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_ring_is_two_slabs_of_both_operator_planes(dtype):
    itemsize = dtype.itemsize
    k = lk.LANE_K[itemsize]
    assert k * itemsize == 128              # 16 KiB of each plane per slab
    assert lk.LANES % k == 0                # the slabs cover the inputs
    assert lk.lane_scratch_bytes(itemsize) == 2 * k * lk.LANES * 2 * itemsize
    assert lk.lane_scratch_bytes(itemsize) == 64 * KIB


@pytest.mark.parametrize("dtype", DTYPES)
def test_full_precision_tile_and_ring_fit_hopper(dtype):
    itemsize = dtype.itemsize
    rows = lk.TILE_ROWS[dtype]
    need = lk.shared_memory_bytes(rows, itemsize)
    assert need == 128 * KIB + 64 * KIB
    assert need <= lk.SMEM_LIMIT_BYTES
    # the smaller tiles of small states reserve the same ring
    while rows > 1:
        rows //= 2
        assert lk.shared_memory_bytes(rows, itemsize) == \
            2 * rows * lk.LANES * itemsize + 64 * KIB


@pytest.mark.parametrize("max_j,ring_kib", [(0, 48), (1, 48), (2, 72)])
def test_fast_launch_sums_are_unchanged(max_j, ring_kib):
    """A FAST launch reserves its own ring and not the lane stage's."""
    need = lk.shared_memory_bytes(lk.TILE_ROWS[torch.float32], 4, max_j)
    assert need == 128 * KIB + ring_kib * KIB


def test_lane_ring_takes_only_plane_itemsizes():
    with pytest.raises(ValueError, match="itemsize"):
        lk.lane_scratch_bytes(2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [7, 10, 14, 22])
def test_kraus_and_layer_kernels_size_the_same_ring(dtype, n):
    itemsize = dtype.itemsize
    tile_rows = min(lk.tile_rows_for(dtype), (1 << n) // lk.LANES)
    need = kk.shared_memory_for(n, dtype)
    assert need == lk.shared_memory_bytes(tile_rows, itemsize)
    assert need == 2 * tile_rows * lk.LANES * itemsize \
        + lk.lane_scratch_bytes(itemsize)


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_operands_are_16_byte_aligned(dtype):
    """The lane stage copies its operator with 16-byte cp.async: every
    dense operand's pool offset is 16-byte aligned, after operands of
    every other stage kind."""
    rng = np.random.default_rng(5)
    n = 14
    top = lk.max_mid_qubit(lk.tile_rows_for(dtype)) - lk.LANE_QUBITS
    stages = [("row", 8, _unitary(rng, 2), 0, 0, 0, 0),
              ("lane", _unitary(rng, 128)),
              ("rowk", (0, top), _unitary(rng, 4), 0, 0, 0, 0),
              ("clane", _unitary(rng, 128), 0b1, 0b1),
              ("rowdiag", np.exp(1j * rng.uniform(size=(2, 128))), (1,)),
              ("lane", _unitary(rng, 128)),
              ("rowmxu", (top,), _unitary(rng, 256)),
              ("lane", _unitary(rng, 128))]
    layer = lk.LayerOp(n, len(stages), stages)
    desc, pool, _, _ = lk._device_operands(layer, n, dtype,
                                           torch.device("cpu"))
    dense = desc[desc[:, 0] == lk.TAG_DENSE]
    assert len(dense) == 5
    for row in dense:
        off, dim = int(row[3]), lk.LANES << int(row[1])
        assert off * dtype.itemsize % 16 == 0
        assert off + 2 * dim * dim <= pool.numel()


# -- the stage's function against the Pallas kernels -----------------------

def _lane_cases(rng, n):
    far = n - 8                       # the top row bit of the state
    return {
        "lane": [("lane", _unitary(rng, 128))],
        "clane_in_tile": [("clane", _unitary(rng, 128), 0b1, 0b1)],
        "clane_far": [("clane", _unitary(rng, 128), 1 << far, 0)],
        "lane_twice": [("lane", _unitary(rng, 128)),
                       ("clane", _unitary(rng, 128), 1 << far, 1 << far)],
    }


@pytest.mark.parametrize("n", [8, 10, 12])
@pytest.mark.parametrize("case", ["lane", "clane_in_tile", "clane_far",
                                  "lane_twice"])
def test_lane_stages_match_pallas_interpret(n, case):
    rng = np.random.default_rng(100 * n + len(case))
    stages = _lane_cases(rng, n)[case]
    z = _state(rng, n)
    rows = min(lk.TILE_ROWS[torch.float64], (1 << n) // lk.LANES)
    want = np.asarray(pk.apply_layer(jnp.asarray(z), n,
                                     pk.LayerOp(n, len(stages), stages),
                                     block_rows=rows, interpret=True))
    planes = torch.as_tensor(np.stack([z.real, z.imag]))
    before = lk.apply_layer.launches
    lk.apply_layer(planes, n, lk.LayerOp(n, len(stages), stages))
    assert lk.apply_layer.launches == before
    got = planes[0].numpy() + 1j * planes[1].numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("n", [7, 9])
def test_kraus_lane_product_on_small_tiles_matches_pallas_interpret(n):
    """One row (n = 7) and four rows (n = 9) of lanes per state."""
    rng = np.random.default_rng(n)
    num_ops, num_traj = 3, 5
    kemb = np.stack([lk.embed_lane_matrix(
        rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2)), (6,))
        for _ in range(num_ops)])
    probs = rng.uniform(0.1, 1.0, size=(num_traj, num_ops))
    probs /= probs.sum(axis=1, keepdims=True)
    u = rng.uniform(size=num_traj)
    z = _state(rng, n, num_traj)
    want = np.asarray(pk.fused_kraus_apply_batched(
        jnp.asarray(z), n, kemb, jnp.asarray(probs), jnp.asarray(u),
        interpret=True))
    states = torch.as_tensor(np.stack([z.real, z.imag], axis=1))
    kk.fused_kraus_apply_batched(states, n, kemb, torch.as_tensor(probs),
                                 torch.as_tensor(u))
    got = states[:, 0].numpy() + 1j * states[:, 1].numpy()
    assert np.abs(got - want).max() <= TOL


# -- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the lane stage runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_lane_stage_matches_plain_on_card(card, dtype, tol):
    itemsize = dtype.itemsize
    for lib in (lk.build_library()[0], kk.build_library()[0]):
        fn = getattr(lib, "quest_layer_lane_scratch_bytes", None) \
            or lib.quest_kraus_lane_scratch_bytes
        assert fn(itemsize) == lk.lane_scratch_bytes(itemsize)
    rng = np.random.default_rng(17)
    for n in (10, 20):
        for case, stages in _lane_cases(rng, n).items():
            layer = lk.LayerOp(n, len(stages), stages)
            for batch in (None, 3):
                z = _state(rng, n, batch)
                axis = 0 if batch is None else 1
                base = torch.as_tensor(np.stack([z.real, z.imag], axis=axis),
                                       dtype=dtype, device=card)
                fn, plain = (lk.apply_layer, lk.apply_layer_plain) \
                    if batch is None else \
                    (lk.apply_layer_batched, lk.apply_layer_batched_plain)
                want = plain(base.clone(), n, layer)
                got = fn(base.clone(), n, layer)
                torch.cuda.synchronize()
                rel = float((got - want).abs().max() / want.abs().max())
                assert rel <= tol, (n, case, batch, rel)
    n, num_traj = 16, 8
    for num_ops in (2, 4):
        kemb = rng.normal(size=(num_ops, 128, 128)) \
            + 1j * rng.normal(size=(num_ops, 128, 128))
        probs = rng.uniform(0.05, 1.0, size=(num_traj, num_ops))
        probs /= probs.sum(axis=1, keepdims=True)
        pt = torch.as_tensor(probs, dtype=dtype, device=card)
        ut = torch.as_tensor(rng.uniform(size=num_traj), dtype=dtype,
                             device=card)
        z = _state(rng, n, num_traj)
        base = torch.as_tensor(np.stack([z.real, z.imag], axis=1),
                               dtype=dtype, device=card)
        want = kk.fused_kraus_apply_batched_plain(base.clone(), n, kemb, pt,
                                                  ut)
        got = kk.fused_kraus_apply_batched(base.clone(), n, kemb, pt, ut)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        assert rel <= tol, (num_ops, rel)
