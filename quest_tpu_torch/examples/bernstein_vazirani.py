"""Bernstein-Vazirani on the port: recover a secret bitstring with one
oracle query.

The port's counterpart of the JAX package's
``examples/bernstein_vazirani.py`` (the reference's
``examples/bernstein_vazirani_circuit.c``), expressed two ways: the per-gate
API (reference style) and the compiled whole-circuit path
(``quest_tpu_torch.algorithms.bernstein_vazirani``).

Run: python -m quest_tpu_torch.examples.bernstein_vazirani [num_qubits]
     [secret] [--device cpu]
"""

import argparse

import quest_tpu_torch as qt
from quest_tpu_torch import algorithms as alg
from quest_tpu_torch.examples._common import make_env


def main(device=None, num_qubits: int = 10, secret=None) -> dict:
    if secret is None:
        secret = 0b1011001101 & ((1 << num_qubits) - 1)
    env = make_env(device)

    print("-------------------------------------------------------")
    print(f"Bernstein-Vazirani on {num_qubits} qubits, "
          f"secret = {secret:#0{num_qubits + 2}b}")
    print("-------------------------------------------------------")

    # --- per-gate API (reference style) ---
    q = qt.createQureg(num_qubits, env)
    qt.initZeroState(q)
    for i in range(num_qubits):
        qt.hadamard(q, i)
    for i in range(num_qubits):
        if (secret >> i) & 1:
            qt.pauliZ(q, i)             # phase oracle for the secret
    for i in range(num_qubits):
        qt.hadamard(q, i)

    measured = 0
    for i in range(num_qubits):
        measured |= qt.measure(q, i) << i
    print(f"per-gate API measured   : {measured:#0{num_qubits + 2}b}"
          f"  ({'OK' if measured == secret else 'MISMATCH'})")

    # --- compiled whole-circuit path ---
    q2 = qt.createQureg(num_qubits, env)
    alg.bernstein_vazirani(num_qubits, secret).compile(env).run(q2)
    amp = qt.getProbAmp(q2, secret)
    print(f"compiled circuit P(|secret>) = {amp:.6f}  "
          f"({'OK' if abs(amp - 1.0) < 1e-6 else 'MISMATCH'})")

    qt.destroyQureg(q, env)
    qt.destroyQureg(q2, env)
    qt.destroyQuESTEnv(env)
    return {"secret": secret, "measured": measured, "prob_secret": amp}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Bernstein-Vazirani")
    ap.add_argument("num_qubits", type=int, nargs="?", default=10)
    ap.add_argument("secret", type=int, nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = main(args.device, args.num_qubits, args.secret)
    assert out["measured"] == out["secret"]
