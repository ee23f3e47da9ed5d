"""The FAST dense stage's operands on the host (quest_tpu_torch/ops/
layer_kernel.py ``_fast_operands``, ``fast_operator_slabs``,
``fast_scratch_bytes``), read on the CPU the way csrc/dense_stage.cuh
``stage_dense_fast`` reads them.

The kernel runs only on the card; what the CPU can hold is its contract
with the host. The layers come from the JAX package's FAST collector (and
the port's, which must collect the same stages): a 12-qubit brickwork plus a
lane gate under a row-qubit control gives lane, clane and ``rowmxu`` stages
on one and two row bits. For each, the bf16 pool read back by the layout
``fast_operator_slabs`` documents is bf16(M), rounded through float32,
exactly; every stage's offset is 16-byte aligned (``cp.async``); and the
ring fits beside the 128-row float32 tile in Hopper's 227 KiB.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.circuits import Circuit as JCircuit
import quest_tpu_torch as tq
from quest_tpu_torch import interop
from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread  # noqa: F401

N = 12
KINDS = ["lane", "clane", "rowmxu1", "rowmxu2"]


def _circuit():
    rng = np.random.default_rng(2026)
    c = JCircuit(N)
    for layer in range(2):
        for q in range(N):
            c.rotate(q, float(rng.uniform(0, 2 * np.pi)), rng.normal(size=3))
        for q in range(layer % 2, N - 1, 2):
            c.cnot(q, q + 1)
    c.cnot(10, 3)                         # a lane target under a row control
    c.rotate(2, 0.3, (1.0, 0.2, 0.1))
    return c


def _records(jc):
    return [(op.kind, op.targets, op.ctrl_mask, op.flip_mask,
             op.mat if op.kind == "u" else op.diag) for op in jc.ops]


def _kind(stage):
    return stage[0] + (str(len(stage[1])) if stage[0] == "rowmxu" else "")


def _matrix(stage):
    return stage[2] if stage[0] == "rowmxu" else stage[1]


@pytest.fixture(scope="module")
def layers():
    """(JAX layer, port layer) pairs of the FAST compile, stages equal."""
    mp = pytest.MonkeyPatch()
    mp.setenv("QUEST_TPU_MXU_SHAPE", "1")
    try:
        jc = _circuit()
        jcc = jc.compile(jq.createQuESTEnv(num_devices=1,
                                           precision=jq.DOUBLE, seed=[3]),
                         pallas="interpret", tier="fast")
        tcc = interop.circuit_from_records(N, _records(jc)).compile(
            tq.createQuESTEnv(device="cpu", seed=[3]), mxu=True, tier="fast")
    finally:
        mp.undo()
    jl = [op for op in jcc._ops if op.kind == "layer"]
    tl = [op for op in tcc._ops if op.kind == "layer"]
    assert len(jl) == len(tl) >= 1
    for a, b in zip(jl, tl):
        assert [_kind(st) for st in a.stages] == \
            [_kind(st) for st in b.stages]
    return list(zip(jl, tl))


def _dense_stages(layers):
    """(kind, JAX operator, port layer, index among its dense stages)."""
    out = []
    for jlayer, tlayer in layers:
        dense = [st for st in jlayer.stages
                 if st[0] in ("lane", "clane", "rowmxu")]
        out += [(_kind(st), np.asarray(_matrix(st)), tlayer, i)
                for i, st in enumerate(dense)]
    return out


def _unpack(seg: torch.Tensor, dim: int) -> torch.Tensor:
    """(re, im) x dim x dim from one stage's bf16 pool segment, by the
    documented layout: element (((k * dim/8 + t) * 32 + lane) * 4 + w) * 2
    + p is part w // 2 at output 8t + lane // 4, input 16k + 8 (w % 2) +
    2 (lane % 4) + p."""
    k, t, lane, w, p = np.indices((dim // lk.FAST_K, dim // 8, 32, 4, 2))
    part = w // 2
    o = 8 * t + lane // 4
    e = lk.FAST_K * k + 8 * (w % 2) + 2 * (lane % 4) + p
    out = torch.empty(2, dim, dim, dtype=torch.bfloat16)
    out[torch.as_tensor(part.reshape(-1)), torch.as_tensor(o.reshape(-1)),
        torch.as_tensor(e.reshape(-1))] = seg
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_pool_reads_back_the_bf16_operator(layers, kind):
    cases = [c for c in _dense_stages(layers) if c[0] == kind]
    assert cases, f"the FAST compile collected no {kind} stage"
    for _, m, tlayer, i in cases:
        desc, _, fast_pool, _, _, _ = lk._fast_operands(
            tlayer, N, torch.device("cpu"))
        row = desc[desc[:, 0] == lk.TAG_DENSE][i]
        dim = lk.LANES << int(row[1])
        assert m.shape == (dim, dim)
        off = int(row[3])
        got = _unpack(fast_pool[off:off + 2 * dim * dim], dim)
        want = torch.as_tensor(np.stack([m.real, m.imag]),
                               dtype=torch.float32).to(torch.bfloat16)
        assert torch.equal(got, want)


def test_fast_pool_offsets_are_16_byte_aligned(layers):
    rng = np.random.default_rng(5)
    # dense stages between float32-pool stages, in one layer
    mixed = lk.LayerOp(N, 4, [
        ("rowdiag", np.exp(1j * rng.uniform(0, 6, (2, 128))), (3,)),
        ("rowmxu", (4,), np.eye(256)),
        ("row", 8, np.eye(2), 0, 0, 0, 0),
        ("lane", np.eye(128)),
        ("rowmxu", (0, 2), np.eye(512))])
    for tlayer in [t for _, t in layers] + [mixed]:
        desc, _, fast_pool, max_j, _, _ = lk._fast_operands(
            tlayer, N, torch.device("cpu"))
        dense = desc[desc[:, 0] == lk.TAG_DENSE]
        assert len(dense) >= 1
        assert int(max_j) == int(dense[:, 1].max())
        for row in dense:
            off, dim = int(row[3]), lk.LANES << int(row[1])
            assert off * fast_pool.element_size() % 16 == 0
            assert off + 2 * dim * dim <= fast_pool.numel()


@pytest.mark.parametrize("max_j", [0, 1, 2])
def test_fast_shared_memory_fits_hopper(max_j):
    need = lk.shared_memory_bytes(lk.TILE_ROWS[torch.float32], 4, max_j)
    # tile, then two ring stages of the widest (operator + A) slab pair
    assert need == 128 * 1024 + {0: 48, 1: 48, 2: 72}[max_j] * 1024
    assert need <= lk.SMEM_LIMIT_BYTES
    with pytest.raises(ValueError, match="max_j"):
        lk.fast_scratch_bytes(lk.MAX_DENSE_ROW_BITS + 1)
