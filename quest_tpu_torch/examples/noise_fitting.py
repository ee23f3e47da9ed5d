"""Fit a device's noise model by gradient descent, on the port.

The port's counterpart of the JAX package's ``examples/noise_fitting.py``.
Channel strengths can be circuit Parameters: the density path binds them at
run time, and the backward of ``CompiledCircuit.expectation_fn`` (the
adjoint walk) differentiates through the Kraus superoperators. Given
measured expectation values of a noisy "device", ``torch.optim.Adam``
(optax.adam's settings) recovers the hidden damping and dephasing rates.

Run:  python -m quest_tpu_torch.examples.noise_fitting [--device cpu]
"""

import torch

import quest_tpu_torch as qt
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.examples._common import make_env, parse_device

TRUE_DAMP, TRUE_DEPHASE = 0.23, 0.17


def main(device=None, steps: int = 300) -> dict:
    env = make_env(device, seed=[11])

    # --- the "device": a Bell-pair circuit with hidden noise rates -------
    dev_circuit = Circuit(2)
    dev_circuit.h(0).cnot(0, 1)
    dev_circuit.damp(0, TRUE_DAMP).dephase(1, TRUE_DEPHASE)
    d = qt.createDensityQureg(2, env)
    qt.initZeroState(d)
    dev_circuit.compile(env, density=True).run(d)

    # "experiment": measure a few observables on the device state
    observables = [[3, 0], [0, 3], [1, 1], [2, 2]]     # Z0, Z1, X0X1, Y0Y1
    data = [qt.calcExpecPauliSum(d, codes, [1.0]) for codes in observables]
    print("device expectations:", [round(x, 4) for x in data])

    # --- the model: same circuit, channel strengths as Parameters --------
    model = Circuit(2)
    g = model.parameter("damp")
    p = model.parameter("dephase")
    model.h(0).cnot(0, 1).damp(0, g).dephase(1, p)
    cc = model.compile(env, density=True)
    fns = [cc.expectation_fn(
        [[(q, c) for q, c in enumerate(codes) if c]], [1.0])
        for codes in observables]

    def loss(pv):
        return sum((f(pv) - t) ** 2 for f, t in zip(fns, data))

    pv = torch.tensor([0.5, 0.5], dtype=torch.float64,
                      requires_grad=True)               # bad initial guess
    opt = torch.optim.Adam([pv], lr=0.05, betas=(0.9, 0.999), eps=1e-8,
                           foreach=False)
    for _ in range(steps):
        opt.zero_grad()
        loss(pv).backward()
        opt.step()
        with torch.no_grad():
            pv.clamp_(1e-4, 0.49)
    rates = pv.detach().numpy().copy()
    fitted = [round(float(x), 4) for x in rates]
    print(f"fitted rates: damp={fitted[0]}, dephase={fitted[1]} "
          f"(true: {TRUE_DAMP}, {TRUE_DEPHASE})")
    assert abs(fitted[0] - TRUE_DAMP) < 0.01
    assert abs(fitted[1] - TRUE_DEPHASE) < 0.01
    print("noise model recovered by gradient descent")
    return {"data": data, "rates": rates}


if __name__ == "__main__":
    main(parse_device(__doc__))
