"""Quantum-trajectory noise simulation on the port: density-matrix
accuracy from state-vector-sized work.

The port's counterpart of the JAX package's
``examples/noisy_trajectories.py``. A 10-qubit noisy GHZ circuit three
ways:

1. exact density evolution: 2^20 flat amplitudes;
2. ONE stochastic trajectory: 2^10 amplitudes;
3. 512 trajectories as one batch (the batched layer kernel and the fused
   Kraus kernel on the card), whose averaged observables converge to the
   exact density answer.

Run: python -m quest_tpu_torch.examples.noisy_trajectories [--device cpu]
"""

import numpy as np
import torch

import quest_tpu_torch as qt
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.core.packing import pack
from quest_tpu_torch.examples._common import make_env, parse_device


def noisy_ghz(n: int) -> Circuit:
    c = Circuit(n)
    c.h(0)
    for q in range(1, n):
        c.cnot(q - 1, q)
    for q in range(n):
        c.damp(q, 0.08)
        c.dephase(q, 0.05)
    return c


def main(device=None, n: int = 10, trajectories: int = 512) -> dict:
    env = make_env(device, seed=[2026])
    c = noisy_ghz(n)

    # 1. exact density path (2^(2n) amplitudes)
    d = qt.createDensityQureg(n, env)
    qt.initZeroState(d)
    c.compile(env, density=True).run(d)
    exact = qt.calcProbOfOutcome(d, n - 1, 1)
    print(f"exact density:      P(q{n-1}=1) = {exact:.5f}   "
          f"({1 << (2 * n):,} amplitudes)")

    # 2. one trajectory (2^n amplitudes)
    prog = c.compile_trajectories(env)
    q1 = qt.createQureg(n, env)
    qt.initZeroState(q1)
    prog.run(q1)
    one = qt.calcProbOfOutcome(q1, n - 1, 1)
    print(f"one trajectory:     P(q{n-1}=1) = {one:.5f}   "
          f"({1 << n:,} amplitudes, one random draw)")

    # 3. the trajectories as one batch
    psi0 = torch.zeros(1 << n, dtype=env.precision.complex_dtype)
    psi0[0] = 1.0
    batch = prog.run_batch(pack(psi0), trajectories).cpu().numpy()
    psis = batch[:, 0] + 1j * batch[:, 1]
    idx = np.arange(1 << n)
    mask = ((idx >> (n - 1)) & 1) == 1
    per_traj = np.sum(np.abs(psis[:, mask]) ** 2, axis=1)
    mc = float(np.mean(per_traj))
    mc_err = float(np.std(per_traj, ddof=1) / np.sqrt(trajectories))
    print(f"{trajectories} trajectories:   P(q{n-1}=1) = {mc:.5f}   "
          f"(one batch)")
    assert abs(mc - exact) < 0.05

    # observables come with their own Monte-Carlo error bar
    mean, err = prog.expectation([[(n - 1, 3)]], [1.0], pack(psi0),
                                 trajectories)
    print(f"<Z_{n-1}> = {mean:+.4f} +/- {err:.4f}   "
          f"(exact {1.0 - 2.0 * exact:+.4f})")
    assert abs(mean - (1.0 - 2.0 * exact)) < 6 * err + 1e-3
    return {"exact": exact, "one_trajectory": one, "ensemble": mc,
            "ensemble_stderr": mc_err, "z_mean": mean, "z_stderr": err}


if __name__ == "__main__":
    main(parse_device(__doc__))
