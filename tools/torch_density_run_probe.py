#!/usr/bin/env python3
"""The compiled run of a 15-qubit density cell alone, on one CUDA card.

Builds ``BASELINE.json`` config 4 (``chip_smoke.density_noise``: a rotation
per qubit, CNOTs, dephasing and damping on every qubit) or the noisy QFT
(``chip_smoke.noisy_qft``) with ``Circuit.compile(density=True)``, runs it
once on a density register from |+><+| (config 4) or a basis state (the
QFT), then prints the host milliseconds of 7 more synchronised runs: their
minimum, median and every run, with the card's name and power limit.
Nothing else runs in the process, so its state is the package's alone.

Run from the root of a checkout: it times the package (and takes the
cell from the ``chip_smoke.py``) of the directory it runs in, so run from
another tree's root it times that tree::

    python3 tools/torch_density_run_probe.py [config4|qft]
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np


def main(argv) -> int:
    import torch
    sys.path.insert(0, os.getcwd())
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import quest_tpu_torch as qt
    cell = argv[0] if argv else "config4"
    n = cs.DENSITY_QUBITS
    env = qt.createQuESTEnv()
    q = qt.createDensityQureg(n, env)
    if cell == "config4":
        circuit = cs.density_noise(qt, n)[0]
        qt.initPlusState(q)
    else:
        circuit = cs.noisy_qft(qt, n)[0]
        qt.initClassicalState(q, 0b101100111000101)
    cc = circuit.compile(env, density=True)
    cc.run(q)
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        t0 = time.perf_counter()
        cc.run(q)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(f"{cell} at {n} qubits on {card}: min {min(times):.1f} ms, "
          f"median {float(np.median(times)):.1f} ms, runs "
          f"{[round(t, 1) for t in times]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
