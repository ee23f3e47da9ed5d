"""A production simulation workflow on the port.

The port's counterpart of the JAX package's
``examples/production_workflow.py``. The habits that matter when kernel
builds and dispatch latency are real costs:

1. a persistent build cache: the JAX package points ``jax.config`` at a
   compilation cache directory. The port's kernels are built with ``nvcc``
   into ``build/quest_tpu_torch/<hash of the sources>/`` beside the
   package (``ops/cuda_build.py``), so a later run of an unchanged
   checkout loads the built libraries instead of compiling them;
2. ahead-of-time preparation (``precompile``): build the kernels and pack
   every layer's operands before the first production call;
3. one-pass multi-shot sampling (``sampleOutcomes``): M shots without M
   register copies;
4. precision control: compensated float32 scalars by default, double-double
   registers when a result must be f64-class from float32 planes.

Run: python -m quest_tpu_torch.examples.production_workflow [--device cpu]
"""

import time

import numpy as np

import quest_tpu_torch as qt
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.examples._common import (make_env, parse_device,
                                              synchronize)


def main(device=None, n: int = 16, shots: int = 4096) -> dict:
    env = make_env(device, seed=[11])

    # 1. the kernel build cache ---------------------------------------------
    if env.device.type == "cuda":
        from quest_tpu_torch.ops import cuda_build
        t0 = time.perf_counter()
        cuda_build.build_all()
        print(f"kernels ready in {time.perf_counter() - t0:.2f}s "
              f"(cached under build/quest_tpu_torch/"
              f"{cuda_build.sources_key()} for every later run)")

    # a parameterized ansatz: one compiled program serves every angle
    c = Circuit(n)
    theta = c.parameter("theta")
    for i in range(n):
        c.h(i)
    for i in range(n - 1):
        c.cnot(i, i + 1)
    c.rz(n // 2, theta)
    for i in range(n):
        c.rx(i, 0.1 + 0.05 * i)

    # 2. prepare ahead of time ----------------------------------------------
    t0 = time.perf_counter()
    cc = c.compile(env).precompile()
    prepare_s = time.perf_counter() - t0
    print(f"compiled and prepared in {prepare_s:.2f}s")

    q = qt.createQureg(n, env)
    qt.initZeroState(q)
    t0 = time.perf_counter()
    cc.run(q, params={"theta": 0.37})  # pure dispatch: nothing builds here
    synchronize(env.device)
    first_ms = 1e3 * (time.perf_counter() - t0)
    print(f"first production dispatch: {first_ms:.1f} ms")

    # 3. multi-shot sampling in one pass --------------------------------------
    draws = qt.sampleOutcomes(q, shots)  # state untouched, env RNG advances
    counts = np.bincount(np.asarray(draws) & 0b111, minlength=8)
    print(f"low-3-qubit histogram over {shots} shots:", counts.tolist())
    total = float(qt.calcTotalProb(q))
    assert abs(total - 1.0) < 1e-6

    # 4. precision tiers ------------------------------------------------------
    # float32 registers + compensated reductions give f64-class scalar
    # results; QUAD double-double registers when amplitudes themselves must
    # carry ~f64 precision (see quad_precision.py)
    p = float(qt.calcProbOfOutcome(q, 0, 0))
    print(f"calcProbOfOutcome(q0=0) = {p:.9f} (compensated reduction)")

    print("workflow complete")
    return {"counts": counts, "total_prob": total, "prob_q0_is_0": p,
            "prepare_s": prepare_s, "first_dispatch_ms": first_ms,
            "amps": q.to_numpy()}


if __name__ == "__main__":
    main(parse_device(__doc__))
