"""The PyTorch port's fused-layer module (quest_tpu_torch/ops/layer_kernel.py)
against the JAX package's Pallas layer kernel (quest_tpu/ops/pallas_kernels.py).

On the CPU the port's ``apply_layer`` runs its plain PyTorch version; the
JAX kernel runs in Pallas interpret mode, as the JAX package's own tests
run it. Both get the same seeded float64 state and the same stage list,
and both plan with the same tile height (the JAX ``block_rows`` is set to
the port's float64 ``tile_rows``). Bound: 1e-12 on a normalised state.

The CUDA kernel itself has no CPU form; ``test_kernel_matches_plain_on_card``
holds it against the plain version where a card is present.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.ops import pallas_kernels as pk
from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread  # noqa: F401

N = 14
TOL = 1e-12
TILE = lk.TILE_ROWS[torch.float64]
HI = lk.max_mid_qubit(TILE)          # highest row-stage target qubit
TOP = HI - lk.LANE_QUBITS            # its row bit
FAR = N - 8                          # a row bit above every tile


def _unitary(rng, dim):
    z = rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))
    q, r = np.linalg.qr(z)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def _phases(rng, k):
    return np.exp(1j * rng.uniform(0, 2 * np.pi, (1 << k, 128)))


def _stage_cases(rng):
    """One single-stage layer per stage kind (row bits in row-bit
    coordinates: qubit = bit + 7), then all of them in one layer."""
    cases = {
        "lane": [("lane", _unitary(rng, 128))],
        "clane": [("clane", _unitary(rng, 128), 0b101 | (1 << FAR),
                   0b001 | (1 << FAR))],
        "row": [("row", 7 + TOP, _unitary(rng, 2), 0, 0, 0, 0)],
        "row_lane_ctrl": [("row", 7 + TOP, _unitary(rng, 2), 0b1000010,
                           0b0000010, 0, 0)],
        "row_row_ctrl": [("row", 8, _unitary(rng, 2), 0, 0,
                          0b100 | (1 << FAR), 0b100)],
        "rowk2": [("rowk", (0, TOP), _unitary(rng, 4), 0b11, 0b01,
                   1 << FAR, 1 << FAR)],
        "rowk3": [("rowk", (0, 2, TOP), _unitary(rng, 8), 0, 0, 0, 0)],
        "rowdiag1": [("rowdiag", _phases(rng, 1), (FAR,))],
        "rowdiag2": [("rowdiag", _phases(rng, 2), (1, FAR))],
        "rowdiag3": [("rowdiag", _phases(rng, 3), (0, 3, FAR))],
        "rowmxu1": [("rowmxu", (TOP,), _unitary(rng, 256))],
        "rowmxu2": [("rowmxu", (1, TOP), _unitary(rng, 512))],
    }
    cases["mixed"] = [st for stages in cases.values() for st in stages]
    return cases


CASE_NAMES = list(_stage_cases(np.random.default_rng(0)))


def _case(name):
    return _stage_cases(np.random.default_rng(CASE_NAMES.index(name)))[name]


def _state(seed, n=N):
    rng = np.random.default_rng(1000 + seed)
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return z / np.linalg.norm(z)


def _planes(z, device="cpu"):
    return torch.as_tensor(np.stack([z.real, z.imag]), dtype=torch.float64,
                           device=device)


def _same(a, b):
    """Stage-field equality: numbers and tuples exactly, arrays to TOL."""
    if isinstance(a, (tuple, list)):
        return (isinstance(b, (tuple, list)) and len(a) == len(b)
                and all(_same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and np.abs(a - b).max(initial=0) <= TOL
    return a == b


# -- host-side operand preparation ----------------------------------------

@pytest.mark.parametrize("targets,ctrl,flip", [
    ((0,), 0, 0), ((3, 1), 0, 0), ((6, 0, 2), 0, 0), ((2,), 0b1, 0),
    ((4, 5), 0b1000001, 0b1), ((1,), 0b1111100, 0b0101000)])
def test_embed_lane_matrix_matches_jax(targets, ctrl, flip):
    u = _unitary(np.random.default_rng(len(targets) + ctrl), 1 << len(targets))
    assert _same(lk.embed_lane_matrix(u, targets, ctrl, flip),
                 pk.embed_lane_matrix(u, targets, ctrl, flip))


@pytest.mark.parametrize("qubits_desc", [(), (0,), (6, 2), (5, 3, 1)])
def test_lane_diag_matches_jax(qubits_desc):
    rng = np.random.default_rng(len(qubits_desc))
    t = np.exp(1j * rng.uniform(0, 6, (2,) * len(qubits_desc)))
    assert _same(lk.lane_diag_vector(t, qubits_desc),
                 pk.lane_diag_vector(t, qubits_desc))
    assert _same(lk.lane_diag_matrix(t, qubits_desc),
                 pk.lane_diag_matrix(t, qubits_desc))


@pytest.mark.parametrize("targets,bits", [
    ((8,), (1,)), ((0, 9), (2,)), ((10, 7, 3), (0, 3)), ((8, 11), (1, 4))])
def test_mxu_group_matrix_matches_jax(targets, bits):
    u = _unitary(np.random.default_rng(sum(targets)), 1 << len(targets))
    assert _same(lk.mxu_group_matrix(u, targets, bits),
                 pk.mxu_group_matrix(u, targets, bits))


@pytest.mark.parametrize("prev,union", [((1,), (1, 3)), ((4,), (0, 4)),
                                        ((), (2,)), ((0, 2), (0, 2))])
def test_mxu_expand_matches_jax(prev, union):
    m = _unitary(np.random.default_rng(len(union)), 128 << len(prev))
    assert _same(lk.mxu_expand(m, prev, union), pk.mxu_expand(m, prev, union))


@pytest.mark.parametrize("name", CASE_NAMES)
def test_layer_kernel_plan_matches_jax(name):
    stages = _case(name)
    mine = lk.layer_kernel_plan(lk.LayerOp(N, 1, stages), N, TILE)
    ref = pk.layer_kernel_plan(pk.LayerOp(N, 1, stages), N, TILE)
    assert _same(mine, ref)
    assert lk.LayerOp(N, 1, stages).targets == pk.LayerOp(N, 1,
                                                          stages).targets


def test_plan_rejects_targets_above_the_tile():
    layer = lk.LayerOp(N, 1, [("row", HI + 1, np.eye(2), 0, 0, 0, 0)])
    with pytest.raises(ValueError, match="outside"):
        lk.layer_kernel_plan(layer, N, TILE)


@pytest.mark.parametrize("stage", [
    ("rowmxu", (0, 1, 2), np.eye(1024)),
    ("rowk", (0, 1, 2, 3), np.eye(16), 0, 0, 0, 0)])
def test_kernel_operands_reject_stages_it_has_no_instance_for(stage):
    """The plain version takes any width; the CUDA kernel is instantiated
    for rowmxu over <= 2 row bits and rowk over <= 3, and its operand
    preparation raises beyond them rather than run a wrong instance."""
    layer = lk.LayerOp(N, 1, [stage])
    lk.apply_layer_plain(_planes(_state(0)), N, layer)
    with pytest.raises(ValueError, match="row bits"):
        lk._device_operands(layer, N, torch.float64, torch.device("cpu"))


def test_tile_fits_hopper_shared_memory():
    for dtype, rows in lk.TILE_ROWS.items():
        assert lk.shared_memory_bytes(rows, dtype.itemsize) <= \
            lk.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        lk.shared_memory_bytes(256, 8)


# -- the plain version against the Pallas kernel ---------------------------

@pytest.mark.parametrize("name", CASE_NAMES)
def test_plain_layer_matches_pallas_interpret(name):
    stages = _case(name)
    z = _state(CASE_NAMES.index(name))
    want = np.asarray(pk.apply_layer(jnp.asarray(z), N,
                                     pk.LayerOp(N, 1, stages),
                                     block_rows=TILE, interpret=True))
    planes = _planes(z)
    before = lk.apply_layer.launches
    out = lk.apply_layer(planes, N, lk.LayerOp(N, 1, stages))
    assert out is planes                       # in place
    assert lk.apply_layer.launches == before   # no kernel on the CPU
    got = planes[0].numpy() + 1j * planes[1].numpy()
    assert np.abs(got - want).max() <= TOL


def test_wrapper_checks_its_inputs():
    layer = lk.LayerOp(N, 1, _case("lane"))
    planes = _planes(_state(0))
    with pytest.raises(ValueError, match="shape"):
        lk.apply_layer(planes[:, :-128], N, layer)
    with pytest.raises(ValueError, match="float32 or float64"):
        lk.apply_layer(planes.to(torch.float16), N, layer)
    with pytest.raises(ValueError, match="contiguous"):
        lk.apply_layer(torch.stack([planes[1], planes[0]], 1).T, N, layer)
    with pytest.raises(ValueError, match="collected for"):
        lk.apply_layer(_planes(_state(0, N + 1)), N + 1, layer)
    # the FAST tier runs on float32 planes only (the engine casts)
    with pytest.raises(ValueError, match="FAST planes are float32"):
        lk.apply_layer(planes, N, layer, fast=True)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the layer kernel runs only on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_kernel_matches_plain_on_card(card, dtype, tol):
    n = 20
    rng = np.random.default_rng(7)
    hi = lk.max_mid_qubit(lk.tile_rows_for(dtype))
    top, far = hi - 7, n - 8
    stages = [("lane", _unitary(rng, 128)),
              ("row", 7 + top, _unitary(rng, 2), 0b10, 0b10, 1 << far, 0),
              ("rowk", (0, 2, top), _unitary(rng, 8), 0, 0, 0, 0),
              ("rowdiag", _phases(rng, 2), (1, far)),
              ("rowmxu", (1, top), _unitary(rng, 512)),
              ("clane", _unitary(rng, 128), 1 << far, 1 << far)]
    layer = lk.LayerOp(n, len(stages), stages)
    z = _state(3, n)
    base = torch.as_tensor(np.stack([z.real, z.imag]), dtype=dtype,
                           device=card)
    want = lk.apply_layer_plain(base.clone(), n, layer)
    before = lk.apply_layer.launches
    got = lk.apply_layer(base.clone(), n, layer)
    torch.cuda.synchronize()
    assert lk.apply_layer.launches == before + 1
    assert float((got - want).abs().max()) <= tol
