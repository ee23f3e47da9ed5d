"""Shor's algorithm on the port: factoring 15 by quantum order finding.

The port's counterpart of the JAX package's ``examples/shor.py``: a
12-qubit register (8 counting + 4 work), QPE over the modular
multiplication ``U_a |y> = |a y mod 15>`` compiled once, measurement of the
counting register, continued-fraction post-processing and the classical
factor extraction ``gcd(a^{r/2} +- 1, N)``.

Run: python -m quest_tpu_torch.examples.shor [--device cpu]
"""

import math

import quest_tpu_torch as qt
from quest_tpu_torch.algorithms import order_finding, order_from_phase
from quest_tpu_torch.examples._common import make_env, parse_device

N = 15
A = 7
NUM_COUNTING = 8


def measured_counting_value(qureg, num_counting):
    """Measure the counting qubits (low indices) one by one."""
    value = 0
    for q in range(num_counting):
        value |= qt.measure(qureg, q) << q
    return value


def main(device=None, seed: int = 2026) -> dict:
    env = make_env(device, seed=[seed])
    circuit = order_finding(A, N, num_counting=NUM_COUNTING)
    compiled = circuit.compile(env)
    print(f"order finding for a={A}, N={N}: "
          f"{circuit.num_qubits} qubits, {len(circuit.ops)} gates")

    for attempt in range(1, 11):
        q = qt.createQureg(circuit.num_qubits, env)
        qt.initZeroState(q)
        compiled.run(q)
        m = measured_counting_value(q, NUM_COUNTING)
        r = order_from_phase(m, NUM_COUNTING, N)
        print(f"attempt {attempt}: measured {m} -> order candidate r={r}")
        if r % 2 or pow(A, r, N) != 1:
            continue                      # bad draw (e.g. m=0): re-run
        f1 = math.gcd(pow(A, r // 2) - 1, N)
        if 1 < f1 < N:
            print(f"order r={r}:  {N} = {f1} x {N // f1}")
            return {"factors": (f1, N // f1), "order": r,
                    "attempts": attempt, "num_gates": len(circuit.ops)}
    raise RuntimeError("no nontrivial factor in 10 attempts (p < 1e-5)")


if __name__ == "__main__":
    out = main(parse_device(__doc__))
    assert sorted(out["factors"]) == [3, 5]
