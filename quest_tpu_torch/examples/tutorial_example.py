"""QuEST tutorial on the port: the reference's 3-qubit demo circuit.

The port's counterpart of the JAX package's ``examples/tutorial_example.py``
(the reference's ``examples/tutorial_example.c``): the same gates and the
same printed quantities through ``quest_tpu_torch``.

Run: python -m quest_tpu_torch.examples.tutorial_example [--device cpu]
"""

import numpy as np

import quest_tpu_torch as qt
from quest_tpu_torch.examples._common import make_env, parse_device


def main(device=None) -> dict:
    # prepare environment (once per program)
    env = make_env(device)

    print("-------------------------------------------------------")
    print("Running QuEST tutorial on the PyTorch port:")
    print("\t Basic circuit involving a system of 3 qubits.")
    print("-------------------------------------------------------")

    # prepare qubit system
    qubits = qt.createQureg(3, env)
    qt.initZeroState(qubits)

    # report system and environment
    print("\nThis is our environment:")
    qt.reportQuregParams(qubits)
    qt.reportQuESTEnv(env)

    # apply circuit
    qt.hadamard(qubits, 0)
    qt.controlledNot(qubits, 0, 1)
    qt.rotateY(qubits, 2, 0.1)

    qt.multiControlledPhaseFlip(qubits, [0, 1, 2])

    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j],
                  [0.5 - 0.5j, 0.5 + 0.5j]])
    qt.unitary(qubits, 0, u)

    a = 0.5 + 0.5j
    b = 0.5 - 0.5j
    qt.compactUnitary(qubits, 1, a, b)

    v = (1.0, 0.0, 0.0)
    qt.rotateAroundAxis(qubits, 2, 3.14 / 2, v)

    qt.controlledCompactUnitary(qubits, 0, 1, a, b)

    qt.multiControlledUnitary(qubits, [0, 1], 2, u)

    toff = qt.createComplexMatrixN(3)      # a Toffoli as an explicit matrix
    for i in range(6):
        toff[i, i] = 1.0
    toff[6, 7] = 1.0
    toff[7, 6] = 1.0
    qt.multiQubitUnitary(qubits, [0, 1, 2], toff)

    # study quantum state
    print("\nCircuit output:")

    prob_amp = qt.getProbAmp(qubits, 7)
    print(f"Probability amplitude of |111>: {prob_amp:f}")

    prob_q2 = qt.calcProbOfOutcome(qubits, 2, 1)
    print(f"Probability of qubit 2 being in state 1: {prob_q2:f}")

    outcome0 = qt.measure(qubits, 0)
    print(f"Qubit 0 was measured in state {outcome0}")

    outcome2, prob2 = qt.measureWithStats(qubits, 2)
    print(f"Qubit 2 collapsed to {outcome2} with probability {prob2:f}")

    # free memory / close environment (no-ops here; kept for API parity)
    qt.destroyQureg(qubits, env)
    qt.destroyComplexMatrixN(toff)
    qt.destroyQuESTEnv(env)
    return {"prob_amp_111": prob_amp, "prob_q2_is_1": prob_q2,
            "outcome_q0": outcome0, "outcome_q2": outcome2,
            "prob_q2_outcome": prob2}


if __name__ == "__main__":
    main(parse_device(__doc__))
