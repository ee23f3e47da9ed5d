#!/usr/bin/env python3
"""Times the trajectory walker's gate-engine calls by row group on the card.

``TrajectoryProgram``'s walker applies its gate-engine items (the gates the
fused layers leave out) in fixed groups of rows, so a row's result does not
depend on how many rows run (``ops/trajectories.py`` ``_rows_unitary``).
This probe runs ``chip_smoke.py``'s phase-9 program (``bench.py``'s
trajectory-wave circuit, 22 qubits, complex64) through ``expectation`` over
512 trajectories in waves of 128, with those calls in groups of 8 rows (the
walker's), of 32, and in one call over the wave, in alternating order over
several rounds, and prints each arrangement's trajectories/s (median and
every run) beside the card's name and power limit. Run it from the root of
a checkout on a machine with one CUDA card::

    python3 tools/torch_traj_group_probe.py [rounds]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import quest_tpu_torch as qt
    from quest_tpu_torch.core.apply import apply_unitary
    from quest_tpu_torch.ops import trajectories as tr
    rounds = int(argv[0]) if argv else 4
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    n, num, wave = 22, 512, 128
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
    grouped = tr._rows_unitary

    def in_groups(rows):
        def apply(states, num_qubits, u, targets, ctrl_mask=0,
                  flip_mask=0):
            u = torch.as_tensor(u).to(states.device) \
                if not isinstance(u, torch.Tensor) else u
            per_row = u.dim() == 3
            for r0 in range(0, states.shape[0], rows):
                g = slice(r0, r0 + rows)
                apply_unitary(states[g], num_qubits, u[g] if per_row else u,
                              targets, ctrl_mask, flip_mask)
        return apply

    def whole(states, num_qubits, u, targets, ctrl_mask=0, flip_mask=0):
        apply_unitary(states, num_qubits, u, targets, ctrl_mask, flip_mask)

    arrangements = {"groups of 8 (the walker's)": grouped,
                    "groups of 32": in_groups(32),
                    "one call over the wave": whole}
    values = {}
    rates = {k: [] for k in arrangements}
    try:
        for name, fn in arrangements.items():      # warm every arrangement
            tr._rows_unitary = fn
            tp.expectation(terms, coeffs, num_trajectories=wave,
                           wave_size=wave, seed=3)
        torch.cuda.synchronize()
        for r in range(rounds):
            order = list(arrangements)
            if r % 2:
                order.reverse()
            for name in order:
                tr._rows_unitary = arrangements[name]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mean, err = tp.expectation(terms, coeffs,
                                           num_trajectories=num,
                                           wave_size=wave, seed=1)
                torch.cuda.synchronize()
                rates[name].append(num / (time.perf_counter() - t0))
                values.setdefault(name, (mean, err))
    finally:
        tr._rows_unitary = grouped
    print(f"card: {card}")
    for name, rs in rates.items():
        print(f"{name}: median {float(np.median(rs)):.2f} trajectories/s, "
              f"runs {[round(x, 2) for x in rs]}, mean "
              f"{values[name][0]!r} stderr {values[name][1]!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
