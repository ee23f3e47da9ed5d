"""Quad-precision registers on the port: f64-class results from float32
arithmetic.

The port's counterpart of the JAX package's ``examples/quad_precision.py``:
the same deep random circuit through SINGLE (plain float32) and QUAD
(double-double float32, ``ops/doubledouble.py``) registers, each against a
float64 oracle. The float32 register drifts to ~1e-6 while QUAD stays at
~1e-14.

Run: python -m quest_tpu_torch.examples.quad_precision [--device cpu]
"""

import numpy as np

import quest_tpu_torch as qt
from quest_tpu_torch.config import QUAD, SINGLE
from quest_tpu_torch.examples._common import make_env, parse_device


def main(device=None, n: int = 5, depth: int = 300) -> dict:
    rng = np.random.default_rng(7)
    gates = []
    for _ in range(depth):
        m = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        gates.append((np.linalg.qr(m)[0], int(rng.integers(0, n))))

    # f64 oracle (host-side dense product)
    psi = np.zeros(1 << n, dtype=np.complex128)
    psi[0] = 1.0
    for u, t in gates:
        full = np.eye(1, dtype=complex)
        for q in range(n - 1, -1, -1):
            full = np.kron(full, u if q == t else np.eye(2))
        psi = full @ psi

    out = {}
    for key, label, prec in (("single", "SINGLE (f32)", SINGLE),
                             ("quad", "QUAD (dd-f32)", QUAD)):
        env = make_env(device, seed=[1], precision=prec)
        q = qt.createQureg(n, env)
        qt.initZeroState(q)
        for u, t in gates:
            qt.unitary(q, t, u)
        amps = q.to_numpy()
        err = float(np.abs(amps - psi).max())
        tot = float(qt.calcTotalProb(q))
        print(f"{label:16s} after {depth} gates: "
              f"max amp error vs f64 oracle = {err:.2e}, "
              f"totalProb = {tot:.15f}")
        out[key] = {"amps": amps, "max_err": err, "total_prob": tot}

    print("\nSame hardware arithmetic (float32) - the QUAD register's"
          " hi+lo planes carry the bits plain float32 drops.")
    return out


if __name__ == "__main__":
    main(parse_device(__doc__))
