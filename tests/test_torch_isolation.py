"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
asks for a CUDA card unless told to use the CPU, and never runs a kernel's
plain version (the layer kernel's at either precision, the batched layer
kernel's, the adjoint layers of a gradient sweep, the MXU-tile kernel's, the
fused Kraus kernel's) on a CUDA tensor, a density register's included.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import quest_tpu_torch as tq
from quest_tpu_torch.ops import kraus_kernel as kk
from quest_tpu_torch.ops import layer_kernel as lk
from torch_threads import one_blas_thread, port_lock_order  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_smoke_script_import_no_jax():
    code = ("import sys, quest_tpu_torch, quest_tpu_torch.interop, "
            "quest_tpu_torch.ops.trajectories, quest_tpu_torch.ops.channels, "
            "quest_tpu_torch.ops.kraus_kernel, quest_tpu_torch.ops.cuda_build, "
            "quest_tpu_torch.parallel.sampling, quest_tpu_torch.profiling, "
            "quest_tpu_torch.ops.densmatr, quest_tpu_torch.testing.golden, "
            "quest_tpu_torch.ops.adjoint, quest_tpu_torch.parallel.pergate, "
            "quest_tpu_torch.serve, quest_tpu_torch.serve.warmcache, "
            "quest_tpu_torch.ops.dynamics, quest_tpu_torch.algorithms, "
            "quest_tpu_torch.qasm_import, quest_tpu_torch.ops.doubledouble, "
            "quest_tpu_torch.telemetry, quest_tpu_torch.telemetry.metrics, "
            "quest_tpu_torch.telemetry.events, "
            "quest_tpu_torch.telemetry.tracing, "
            "quest_tpu_torch.telemetry.profile, "
            "quest_tpu_torch.telemetry.ledger, "
            "quest_tpu_torch.telemetry.export, "
            "quest_tpu_torch.telemetry.endpoints, "
            "quest_tpu_torch.resilience, quest_tpu_torch.resilience.faults, "
            "quest_tpu_torch.resilience.health, "
            "quest_tpu_torch.resilience.recovery, "
            "quest_tpu_torch.serve.metrics, quest_tpu_torch.serve.coalesce, "
            "quest_tpu_torch.serve.sched, quest_tpu_torch.serve.engine, "
            "quest_tpu_torch.serve.router, quest_tpu_torch.serve.optimize, "
            "quest_tpu_torch.serve.dynamics, quest_tpu_torch.checkpoint, "
            "quest_tpu_torch.resilience.segments, "
            "quest_tpu_torch.testing.lockcheck, "
            "quest_tpu_torch.netserve, quest_tpu_torch.netserve.errors, "
            "quest_tpu_torch.netserve.wire, "
            "quest_tpu_torch.netserve.session, "
            "quest_tpu_torch.netserve.robust, "
            "quest_tpu_torch.netserve._pool, "
            "quest_tpu_torch.netserve.server, "
            "quest_tpu_torch.netserve.client, chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'quest_tpu.')) "
            "or m == 'quest_tpu')\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_default_env_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tq.createQuESTEnv()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tq.createQuESTEnv(device="cuda")
    env = tq.createQuESTEnv(device="cpu")
    assert env.device.type == "cpu" and env.precision is tq.SINGLE


class _FakeCudaPlanes(torch.Tensor):
    """A CPU tensor that reports a CUDA device: enough to walk the
    wrapper's CUDA branch on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    n = 8
    layer = lk.LayerOp(n, 1, [("lane", np.eye(128))])
    planes = torch.zeros(2, 1 << n, dtype=torch.float32).as_subclass(
        _FakeCudaPlanes)
    assert planes.device.type == "cuda"

    def forbidden(*args, **kwargs):
        raise AssertionError("plain version reached for a CUDA tensor")

    def no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(lk, "apply_layer_plain", forbidden)
    monkeypatch.setattr(lk, "_device_operands",
                        lambda *a: (torch.zeros(1, lk.DESC_WIDTH,
                                                dtype=torch.int64),
                                    torch.zeros(1), 2, 2))
    monkeypatch.setattr(lk, "build_library", no_toolkit)
    before = lk.apply_layer.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        lk.apply_layer(planes, n, layer)
    assert lk.apply_layer.launches == before


def _no_toolkit():
    raise RuntimeError("nvcc not found")


def test_cuda_density_register_never_reaches_the_plain_version(monkeypatch):
    """A density-compiled program's layer (here two rowdiag stages from
    the lifted controlled phases) on a CUDA register launches the kernel
    or raises."""
    env = tq.createQuESTEnv(device="cpu")
    c = tq.Circuit(7)
    c.cphase(0, 1, 0.3).cphase(2, 3, 0.5)
    compiled = c.compile(env, density=True)
    assert [compiled._ops[it[1]].kind for it in compiled.plan.items] == \
        ["layer"]
    q = tq.createDensityQureg(7, env)
    q.state = q.state.as_subclass(_FakeCudaPlanes)
    assert q.state.device.type == "cuda"
    monkeypatch.setattr(lk, "apply_layer_plain", _forbidden)
    monkeypatch.setattr(lk, "apply_layer_batched_plain", _forbidden)
    monkeypatch.setattr(lk, "_device_operands",
                        lambda *a: (torch.zeros(1, lk.DESC_WIDTH,
                                                dtype=torch.int64),
                                    torch.zeros(1), 2, 2))
    monkeypatch.setattr(lk, "build_library", _no_toolkit)
    before = lk.apply_layer.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        compiled.run(q)
    assert lk.apply_layer.launches == before


def _forbidden(*args, **kwargs):
    raise AssertionError("plain version reached for a CUDA tensor")


def test_cuda_batch_never_reaches_the_batched_plain_version(monkeypatch):
    n = 8
    layer = lk.LayerOp(n, 1, [("lane", np.eye(128))])
    states = torch.zeros(3, 2, 1 << n, dtype=torch.float32).as_subclass(
        _FakeCudaPlanes)
    monkeypatch.setattr(lk, "apply_layer_batched_plain", _forbidden)
    monkeypatch.setattr(lk, "apply_layer_plain", _forbidden)
    monkeypatch.setattr(lk, "_device_operands",
                        lambda *a: (torch.zeros(1, lk.DESC_WIDTH,
                                                dtype=torch.int64),
                                    torch.zeros(1), 2, 2))
    monkeypatch.setattr(lk, "build_library", _no_toolkit)
    before = lk.apply_layer_batched.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        lk.apply_layer_batched(states, n, layer)
    assert lk.apply_layer_batched.launches == before


def _fast_operands_stub(*args):
    return (torch.zeros(1, lk.DESC_WIDTH, dtype=torch.int64), torch.zeros(1),
            torch.zeros(1, dtype=torch.bfloat16), 0, 2, 2)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_cuda_fast_never_reaches_the_plain_version(monkeypatch, batched):
    """fast=True on a CUDA tensor launches the FAST kernel or raises: a
    missing toolkit is an error, never a quiet bf16 emulation."""
    n = 8
    layer = lk.LayerOp(n, 1, [("lane", np.eye(128))])
    shape = (3, 2, 1 << n) if batched else (2, 1 << n)
    states = torch.zeros(shape, dtype=torch.float32).as_subclass(
        _FakeCudaPlanes)
    monkeypatch.setattr(lk, "apply_layer_batched_plain", _forbidden)
    monkeypatch.setattr(lk, "apply_layer_plain", _forbidden)
    monkeypatch.setattr(lk, "_fast_operands", _fast_operands_stub)
    monkeypatch.setattr(lk, "build_library", _no_toolkit)
    fn = lk.apply_layer_batched if batched else lk.apply_layer
    before = (fn.launches, fn.fast_launches)
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(states, n, layer, fast=True)
    assert (fn.launches, fn.fast_launches) == before


@pytest.mark.parametrize("fast", [False, True], ids=["highest", "fast"])
def test_cuda_mxu_tile_never_reaches_the_plain_version(monkeypatch, fast):
    n = 9
    planes = torch.zeros(2, 1 << n, dtype=torch.float32).as_subclass(
        _FakeCudaPlanes)
    monkeypatch.setattr(lk, "apply_mxu_tile_plain", _forbidden)
    monkeypatch.setattr(lk, "apply_layer_plain", _forbidden)
    monkeypatch.setattr(lk, "apply_layer_batched_plain", _forbidden)
    monkeypatch.setattr(lk, "_device_operands",
                        lambda *a: (torch.zeros(1, lk.DESC_WIDTH,
                                                dtype=torch.int64),
                                    torch.zeros(1), 2, 2))
    monkeypatch.setattr(lk, "_fast_operands", _fast_operands_stub)
    monkeypatch.setattr(lk, "build_library", _no_toolkit)
    before = lk.apply_mxu_tile.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        lk.apply_mxu_tile(planes, n, np.eye(4), (3, 8), fast=fast)
    assert lk.apply_mxu_tile.launches == before


def test_cuda_batch_never_reaches_the_kraus_plain_version(monkeypatch):
    n, num_traj = 8, 4
    states = torch.zeros(num_traj, 2, 1 << n,
                         dtype=torch.float32).as_subclass(_FakeCudaPlanes)
    probs = torch.full((num_traj, 2), 0.5).as_subclass(_FakeCudaPlanes)
    u01 = torch.zeros(num_traj).as_subclass(_FakeCudaPlanes)
    kemb = np.stack([np.eye(128), np.eye(128)])
    monkeypatch.setattr(kk, "fused_kraus_apply_batched_plain", _forbidden)
    monkeypatch.setattr(kk, "draw_plain", _forbidden)
    monkeypatch.setattr(kk, "build_library", _no_toolkit)
    before = kk.fused_kraus_apply_batched.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        kk.fused_kraus_apply_batched(states, n, kemb, probs, u01)
    assert kk.fused_kraus_apply_batched.launches == before


def test_every_kernel_source_is_in_the_build_key(tmp_path, monkeypatch):
    """One key over every csrc source: a change to the shared header
    rebuilds both libraries."""
    from quest_tpu_torch.ops import cuda_build
    for src in cuda_build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    key = cuda_build.sources_key()
    header = tmp_path / "dense_stage.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert cuda_build.sources_key() != key
    assert {p.name for p in cuda_build._sources()} >= {
        "layer_kernel.cu", "kraus_kernel.cu", "dense_stage.cuh"}


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Run without CUDA (here), or alone in a directory without the
    package, the smoke script exits non-zero and prints no result."""
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (str(tmp_path), str(tmp_path / "chip_smoke.py"))):
        if cwd != ROOT:
            with open(os.path.join(ROOT, "chip_smoke.py")) as src:
                (tmp_path / "chip_smoke.py").write_text(src.read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_cuda_adjoint_layers_never_reach_the_plain_version(monkeypatch):
    """A gradient sweep on a CUDA batch launches every layer and its
    adjoint through the kernel or raises: here the walk's first layer
    launch, and an adjoint layer's, raise for want of a toolkit, and no
    plain version runs."""
    from quest_tpu_torch.ops import adjoint as adj
    n = 8
    layer = lk.LayerOp(n, 1, [("lane", np.eye(128))])
    walk = adj.AdjointWalk(n, [(layer, ("op", 0, (), 0, 0, None))], ("a",),
                           None, False, False)
    assert id(layer) in walk.adjoints
    monkeypatch.setattr(lk, "apply_layer_batched_plain", _forbidden)
    monkeypatch.setattr(lk, "apply_layer_plain", _forbidden)
    monkeypatch.setattr(lk, "_device_operands",
                        lambda *args: (torch.zeros(1, lk.DESC_WIDTH,
                                                   dtype=torch.int64),
                                       torch.zeros(1), 2, 2))
    monkeypatch.setattr(lk, "build_library", _no_toolkit)
    start = torch.zeros(2, 1 << n).as_subclass(_FakeCudaPlanes)
    before = lk.apply_layer_batched.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        walk.run(np.zeros((2, 1)), start, lambda psi: None,
                 lambda psi, lam: None, 0)
    with pytest.raises(RuntimeError, match="nvcc"):
        lk.apply_layer_batched(torch.zeros(4, 2, 1 << n).as_subclass(
            _FakeCudaPlanes), n, walk.adjoints[id(layer)])
    assert lk.apply_layer_batched.launches == before


def test_interpret_on_a_cuda_env_raises():
    """``pallas="interpret"`` asks for the layer kernel's plain version,
    which no path on the card takes: compiling for a CUDA env raises
    before anything is planned or launched."""
    env = tq.QuESTEnv(precision=tq.SINGLE, device=torch.device("cuda", 0))
    c = tq.Circuit(8).h(0).cnot(0, 1)
    with pytest.raises(ValueError, match="plain version"):
        c.compile(env, pallas="interpret")
    with pytest.raises(ValueError, match="plain version"):
        c.compile_trajectories(env, pallas="interpret")


def test_concurrent_first_builds_run_the_build_once(tmp_path, monkeypatch):
    """Two threads that ask for the kernels at the same moment (a serving
    dispatcher and a caller warming a program) share one build: ``nvcc``
    runs once per source, and both get the same libraries. The compiler
    is a stub that sleeps, so an unlocked build would overlap."""
    import threading
    import types

    from quest_tpu_torch.ops import cuda_build
    calls = tmp_path / "calls"
    stub = tmp_path / "nvcc"
    stub.write_text("#!/bin/sh\n"
                    f"echo run >> {calls}\n"
                    "sleep 0.2\n"
                    "while [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = \"-o\" ]; then shift; : > \"$1\"; fi\n"
                    "  shift\n"
                    "done\n")
    stub.chmod(0o755)
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(cuda_build, "_build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(cuda_build, "ctypes", types.SimpleNamespace(
        CDLL=lambda path: ("library", path)))
    cuda_build.build_all.cache_clear()
    got, errors = [], []

    def first_use():
        try:
            got.append(cuda_build.build_all())
        except Exception as e:           # reported by the main thread
            errors.append(e)

    try:
        threads = [threading.Thread(target=first_use) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors
        units = [p for p in cuda_build._sources() if p.suffix == ".cu"]
        assert calls.read_text().count("run") == len(units)
        assert got[0] is got[1] and set(got[0]) == {p.stem for p in units}
        assert cuda_build.build_all.cache_info().misses == 1
    finally:
        cuda_build.build_all.cache_clear()


NETSERVE_MODULES = ("__init__", "errors", "wire", "session", "robust",
                    "_pool", "server", "client")


@pytest.mark.parametrize("module", NETSERVE_MODULES)
def test_netserve_module_imports_nothing_of_jax(module):
    """Every import statement of the front door's modules names the
    standard library, numpy or the port itself (relative), never JAX or
    the JAX package, including imports made inside functions."""
    import ast
    path = os.path.join(ROOT, "quest_tpu_torch", "netserve",
                        f"{module}.py")
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                    "quest_tpu")]
    assert not bad, (module, bad)
