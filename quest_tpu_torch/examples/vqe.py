"""Variational quantum eigensolver on the port's compiled circuits.

The port's counterpart of the JAX package's ``examples/vqe.py``. There a
compiled circuit's energy is a jitted function that ``jax.value_and_grad``
differentiates and optax's Adam minimises. Here
``CompiledCircuit.expectation_fn`` is a ``torch.autograd.Function`` whose
backward is the adjoint walk (``ops/adjoint.py``), so ``.backward()`` gives
the exact gradient, and ``torch.optim.Adam`` (optax's defaults: betas 0.9,
0.999, eps 1e-8) runs the loop.

Problem: ground state of the 4-qubit transverse-field Ising Hamiltonian
    H = -J sum_i Z_i Z_{i+1} - h sum_i X_i
with a hardware-efficient Ry+CNOT ansatz; then the same optimisation under
noise, on the density path (``compile(density=True)``).

Run:  python -m quest_tpu_torch.examples.vqe [--device cpu]
"""

import numpy as np
import torch

import quest_tpu_torch as qt
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.examples._common import make_env, parse_device

N = 4
J, H_FIELD = 1.0, 0.7
LAYERS = 3
LEARNING_RATE = 5e-2


def ansatz() -> Circuit:
    c = Circuit(N)
    for layer in range(LAYERS):
        for q in range(N):
            c.ry(q, c.parameter(f"t{layer}_{q}"))
        for q in range(N - 1):
            c.cnot(q, q + 1)
    return c


def hamiltonian_terms():
    terms, coeffs = [], []
    for i in range(N - 1):
        terms.append([(i, int(qt.PAULI_Z)), (i + 1, int(qt.PAULI_Z))])
        coeffs.append(-J)
    for i in range(N):
        terms.append([(i, int(qt.PAULI_X))])
        coeffs.append(-H_FIELD)
    return terms, coeffs


def exact_ground_energy(terms, coeffs) -> float:
    mats = {1: np.array([[0, 1], [1, 0]], complex),
            3: np.diag([1.0, -1.0]).astype(complex)}
    h = np.zeros((1 << N, 1 << N), complex)
    for term, w in zip(terms, coeffs):
        full = np.eye(1, dtype=complex)
        sel = {q: mats[c] for q, c in term}
        for q in range(N - 1, -1, -1):
            full = np.kron(full, sel.get(q, np.eye(2, dtype=complex)))
        h += w * full
    return float(np.linalg.eigvalsh(h)[0])


def run_adam(energy, start: np.ndarray, steps: int, report: int = 0):
    """``steps`` Adam steps on ``energy`` from ``start`` (optax.adam's
    update: the gradient at the current point, then the step); returns the
    final float64 parameters as numpy."""
    theta = torch.tensor(start, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=LEARNING_RATE, betas=(0.9, 0.999),
                           eps=1e-8, foreach=False)
    for step in range(steps):
        opt.zero_grad()
        e = energy(theta)
        e.backward()
        opt.step()
        if report and step % report == 0:
            print(f"step {step:3d}: E = {float(e.detach()):+.6f}")
    return theta.detach().numpy().copy()


def main(device=None, steps: int = 200, noisy_steps: int = 120) -> dict:
    env = make_env(device, seed=[7])
    terms, coeffs = hamiltonian_terms()
    energy = ansatz().compile(env).expectation_fn(terms, coeffs)

    rng = np.random.default_rng(0)
    params = run_adam(energy, rng.uniform(-0.1, 0.1, size=LAYERS * N),
                      steps, report=40)
    e_final = float(energy(torch.as_tensor(params)))
    e_exact = exact_ground_energy(terms, coeffs)
    print(f"final:     E = {e_final:+.6f}")
    print(f"exact:     E = {e_exact:+.6f}  (error {e_final - e_exact:+.2e})")

    # -- the same optimisation UNDER NOISE ---------------------------------
    # compile(density=True) lifts the ansatz (plus its channels) to the
    # density path; expectation_fn is then Tr(H rho(params)) and its
    # backward walks straight through the decoherence, so the optimiser
    # finds the best variational state OF THE NOISY DEVICE
    noisy = ansatz().with_noise(p1=0.01, damping=0.02)
    nenergy = noisy.compile(env, density=True).expectation_fn(terms, coeffs)
    nparams = run_adam(nenergy, rng.uniform(-0.1, 0.1, size=LAYERS * N),
                       noisy_steps)
    e_noisy = float(nenergy(torch.as_tensor(nparams)))
    print(f"noisy:     E = {e_noisy:+.6f}  (above the exact ground energy "
          "by the decoherence floor)")
    assert e_noisy > e_exact - 1e-9
    return {"params": params, "energy": e_final, "exact": e_exact,
            "noisy_params": nparams, "noisy_energy": e_noisy}


if __name__ == "__main__":
    main(parse_device(__doc__))
