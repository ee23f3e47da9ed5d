"""Single-qubit damping on a density register, on the port.

The port's counterpart of the JAX package's ``examples/damping_example.py``
(the reference's ``examples/damping_example.c``): a 1-qubit density matrix
in |+><+|, damped 10 times at probability 0.1, its state printed after each
application.

Run: python -m quest_tpu_torch.examples.damping_example [--device cpu]
"""

import numpy as np

import quest_tpu_torch as qt
from quest_tpu_torch.examples._common import make_env, parse_device


def _matrix(qureg) -> np.ndarray:
    return np.array([[complex(qt.getDensityAmp(qureg, r, c))
                      for c in range(2)] for r in range(2)])


def main(device=None, repetitions: int = 10, prob: float = 0.1) -> dict:
    env = make_env(device)

    print("-------------------------------------------------------")
    print("Running QuEST damping example on the PyTorch port:")
    print("\t Basic circuit involving damping of a qubit.")
    print("-------------------------------------------------------")

    qubits = qt.createDensityQureg(1, env)
    qt.initPlusState(qubits)

    print("\n Reporting the qubit state to screen:")
    qt.reportStateToScreen(qubits, env, 0)
    states = [_matrix(qubits)]

    print(f"\n Applying damping {repetitions} times with probability "
          f"{prob}")
    for counter in range(repetitions):
        qt.mixDamping(qubits, 0, prob)
        print(f"\n Qubit state after applying damping {counter + 1} "
              "times:")
        qt.reportStateToScreen(qubits, env, 0)
        states.append(_matrix(qubits))

    qt.destroyQureg(qubits, env)
    qt.destroyQuESTEnv(env)
    return {"states": states}


if __name__ == "__main__":
    main(parse_device(__doc__))
