"""The golden corpus replayed through the PyTorch port, on the CPU in
float64.

Every entry of ``tests/golden/*.test`` (written by the JAX package's
trusted float64 path) and ``tests/golden_ref/*.test`` (written by the
reference's own serial build), state-vector and density alike, replays
through the port's copy of the runner (``quest_tpu_torch.testing.golden``)
at 1e-10, the reference's own tolerance. The only entries skipped are those
of the ``reseed=True`` specs (``measure``, ``measureWithStats``): they
check the JAX package's threefry stream, which the port's
``torch.Generator`` does not reproduce.
"""

import glob
import os

import pytest

import quest_tpu_torch as tq
from quest_tpu_torch.testing import GATE_SPECS, run_file
from torch_threads import one_blas_thread  # noqa: F401

HERE = os.path.dirname(__file__)
FILES = sorted(glob.glob(os.path.join(HERE, "golden", "*.test"))
               + glob.glob(os.path.join(HERE, "golden_ref", "*.test")))
RESEED = sorted(name for name, spec in GATE_SPECS.items() if spec.reseed)


@pytest.fixture(scope="module")
def env():
    return tq.createQuESTEnv(device="cpu", precision=tq.DOUBLE, seed=[5])


def _name(path):
    return os.path.splitext(os.path.basename(path))[0]


def _entries(path):
    with open(path) as f:
        f.readline()
        return int(f.readline())


def test_corpus_covers_every_spec():
    names = {_name(p) for p in FILES}
    assert names == set(GATE_SPECS), names ^ set(GATE_SPECS)
    assert RESEED == ["measure", "measureWithStats"]


@pytest.mark.parametrize(
    "path", FILES,
    ids=[f"{os.path.basename(os.path.dirname(p))}/{_name(p)}" for p in FILES])
def test_replay(path, env):
    failures, skipped = run_file(path, env, tol=1e-10)
    assert not failures, "\n".join(
        f"{f.function}[{f.test_index}] {f.check}: {f.detail}"
        for f in failures[:10])
    # skips only where the spec reseeds, and then every entry
    assert skipped == (_entries(path) if _name(path) in RESEED else 0)


def test_skips_are_the_reseed_entries_only(env):
    skipped = {p: run_file(p, env)[1] for p in FILES
               if _name(p) in RESEED}
    assert sum(skipped.values()) == 48
    assert all(p.split(os.sep)[-2] == "golden" for p in skipped)
