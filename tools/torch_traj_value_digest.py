#!/usr/bin/env python3
"""Digest of the trajectory value path on the card, to hold two trees'
``TrajectoryProgram.expectation`` equal bit for bit.

Runs ``chip_smoke.py``'s phase-9 circuit (``bench.py``'s trajectory-wave
circuit, 22 qubits, complex64) through ``expectation`` over 256
trajectories in waves of 128 at a fixed seed, and one 128-trajectory
``trajectory_sweep`` on fixed uniforms, and prints the mean and stderr as
``repr`` and a SHA-256 of the sweep's planes, with the kernels' launch
counts. Run it from the root of each tree on the same card::

    python3 tools/torch_traj_value_digest.py

and compare the lines: equal digests mean equal bits.
"""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import quest_tpu_torch as qt
    from quest_tpu_torch.ops import kraus_kernel as kk
    from quest_tpu_torch.ops import layer_kernel as lk
    n = 22
    rng = np.random.default_rng(2110)
    c = qt.Circuit(n)
    for q in range(n):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    c.damp(2, 0.2)
    for q in range(n - 1):
        c.cnot(q, q + 1)
    c.dephase(4, 0.15)
    for q in range(n):
        c.ry(q, float(rng.uniform(0.2, 2.8)))
    terms = [[(q, 3)] for q in range(n)]
    coeffs = list(rng.normal(size=n))
    tp = c.compile_trajectories(qt.createQuESTEnv(seed=[7]))
    lk.apply_layer_batched.launches = 0
    kk.fused_kraus_apply_batched.launches = 0
    mean, err = tp.expectation(terms, coeffs, num_trajectories=256,
                               wave_size=128, seed=29)
    u = np.random.default_rng(5).uniform(size=(128, tp.num_channels))
    planes = tp.trajectory_sweep(128, uniforms=u)
    torch.cuda.synchronize()
    digest = hashlib.sha256(planes.cpu().numpy().tobytes()).hexdigest()
    print(f"expectation mean {mean!r} stderr {err!r}")
    print(f"sweep planes sha256 {digest}")
    print(f"launches: batched layer {lk.apply_layer_batched.launches}, "
          f"Kraus {kk.fused_kraus_apply_batched.launches}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
