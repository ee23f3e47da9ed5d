"""QUAD registers through the port's public API against the JAX package's
float64 golden corpus and its QUAD registers, on the CPU: the
``TestQuadTier`` of ``tests/test_doubledouble.py`` with its bars (the whole
golden corpus on QUAD64 at 1e-13 and on QUAD at 5e-13, with the
``calcPurity`` scaling of its :287; the deep circuit at 5e-13 where plain
float32 drifts past 1e-7; controlled k-qubit gates at 2e-13; inner
products and fidelity at 1e-13), each register path also against the JAX
package's QUAD register on the same inputs.
"""

import glob
import os

import numpy as np
import pytest

import quest_tpu as jq
import quest_tpu_torch as tq
from quest_tpu_torch.testing.golden import run_file
from torch_threads import one_blas_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


class TestQuadTier:
    """QUAD registers through the public API: the whole golden corpus (the
    JAX package's float64 results) replayed on dd planes, and the register
    paths against the JAX package's QUAD registers."""

    @pytest.mark.parametrize("tier,tol", [("QUAD64", 1e-13), ("QUAD", 5e-13)])
    def test_golden_corpus_replay_quad(self, tier, tol):
        env = tq.createQuESTEnv(device="cpu", precision=getattr(tq, tier),
                                seed=[12345])
        files = sorted(glob.glob(os.path.join(GOLDEN, "*.test")))
        assert files
        all_failures = []
        for path in files:
            # calcPurity's unnormalised debug-density return is ~6.9e3;
            # the absolute tol there scales with the magnitude, as in the
            # JAX package's test
            t = max(tol, 7e3 * 4e-15) if "calcPurity" in path else tol
            failures, _ = run_file(path, env, tol=t)
            all_failures.extend(failures)
        assert not all_failures, all_failures[:5]

    def test_quad_beats_f32_on_deep_circuit(self, rng):
        n, depth = 4, 400
        envs = {"quad": tq.createQuESTEnv(device="cpu", precision=tq.QUAD,
                                          seed=[1]),
                "single": tq.createQuESTEnv(device="cpu",
                                            precision=tq.SINGLE, seed=[1])}
        jenv = jq.createQuESTEnv(num_devices=1, precision=jq.QUAD, seed=[1])
        gates = []
        for _ in range(depth):
            m = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
            gates.append((np.linalg.qr(m)[0], int(rng.integers(0, n))))
        psi = np.zeros(1 << n, dtype=np.complex128)
        psi[0] = 1.0
        for u, t in gates:
            full = np.eye(1, dtype=complex)
            for q in range(n - 1, -1, -1):
                full = np.kron(full, u if q == t else np.eye(2))
            psi = full @ psi
        outs = {}
        for name, e in list(envs.items()) + [("jax", jenv)]:
            mod = jq if name == "jax" else tq
            q = mod.createQureg(n, e)
            for u, t in gates:
                mod.unitary(q, t, u)
            outs[name] = q.to_numpy()
        err_q = np.abs(outs["quad"] - psi).max()
        assert err_q < 5e-13, err_q
        assert np.abs(outs["single"] - psi).max() > 1e-7
        assert np.abs(outs["quad"] - outs["jax"]).max() < 1e-13

    def test_quad_kq_dense_and_controls(self, rng):
        n = 5
        u3 = np.linalg.qr(rng.normal(size=(8, 8))
                          + 1j * rng.normal(size=(8, 8)))[0]
        u1 = np.linalg.qr(rng.normal(size=(2, 2))
                          + 1j * rng.normal(size=(2, 2)))[0]
        outs = []
        for mod, prec, kw in ((tq, tq.DOUBLE, {"device": "cpu"}),
                              (tq, tq.QUAD, {"device": "cpu"}),
                              (jq, jq.QUAD, {"num_devices": 1})):
            e = mod.createQuESTEnv(precision=prec, seed=[2], **kw)
            q = mod.createQureg(n, e)
            mod.initDebugState(q)
            mod.multiQubitUnitary(q, (4, 1, 2), u3)
            mod.multiControlledUnitary(q, (0, 3), 4, u1)
            mod.multiStateControlledUnitary(q, (1, 3), (1, 0), 0, u1)
            outs.append(q.to_numpy())
        np.testing.assert_allclose(outs[1], outs[0], atol=2e-13)
        np.testing.assert_allclose(outs[1], outs[2], atol=2e-13)

    def test_quad_inner_products_and_fidelity(self, rng):
        n = 4
        va = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
        vb = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
        va /= np.linalg.norm(va)
        vb /= np.linalg.norm(vb)
        for mod, prec, kw in ((tq, tq.QUAD, {"device": "cpu"}),
                              (jq, jq.QUAD, {"num_devices": 1})):
            env = mod.createQuESTEnv(precision=prec, seed=[4], **kw)
            a = mod.createQureg(n, env)
            b = mod.createQureg(n, env)
            a.device_put(va)
            b.device_put(vb)
            assert abs(mod.calcInnerProduct(a, b) - np.vdot(va, vb)) < 1e-13
            assert abs(mod.calcFidelity(a, b)
                       - abs(np.vdot(va, vb)) ** 2) < 1e-13
            d = mod.createDensityQureg(n, env)
            mod.initPureState(d, a)
            assert abs(mod.calcFidelity(d, b)
                       - abs(np.vdot(va, vb)) ** 2) < 1e-12
