"""What the framework adds beyond the reference, on the port.

The port's counterpart of the JAX package's ``examples/tpu_features.py``
(the file name is kept so the two map one to one). Five things QuEST
cannot do:

1. whole-circuit compilation: a 20-qubit QFT as one planned program of
   fused layers (the layer kernel on the card);
2. parameterized circuits: one compiled program, every rotation angle;
3. exact gradients of Pauli-sum expectations (``expectation_fn``, whose
   backward is the adjoint walk);
4. batched simulation: a whole parameter sweep in one batched dispatch
   (``CompiledCircuit.sweep``, where the JAX package ``vmap``s ``apply``);
5. mesh sharding: the same kind of circuit on an 8-shard amplitude-sharded
   mesh (eight shards of the one card, or eight host shards with
   ``--device cpu``).

Run: python -m quest_tpu_torch.examples.tpu_features [--device cpu]
"""

import numpy as np
import torch

import quest_tpu_torch as qt
from quest_tpu_torch import algorithms as alg
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.core.packing import pack
from quest_tpu_torch.examples._common import make_env, parse_device


def main(device=None, n: int = 20, mesh_qubits: int = 10) -> dict:
    env = make_env(device, seed=[7])
    out = {}

    # 1. whole-circuit compilation -------------------------------------------
    q = qt.createQureg(n, env)
    qt.initClassicalState(q, 0b1011)
    compiled = alg.qft(n).compile(env)
    compiled.run(q)
    out["qft_total_prob"] = float(qt.calcTotalProb(q))
    out["qft_amps"] = q.to_numpy()
    print(f"QFT-{n}: {compiled.plan.num_qubits}-qubit program, "
          f"{len(compiled._ops)} scheduled ops, "
          f"totalProb={out['qft_total_prob']:.12f}")

    # 2. parameterized circuit: one compile, many angles ----------------------
    c = Circuit(4)
    theta = c.parameter("theta")
    for i in range(4):
        c.ry(i, theta)
    c.cnot(0, 1).cnot(2, 3)
    f = c.compile(env)
    out["param_probs"] = []
    for t in (0.1, 0.7, 2.4):              # no recompiles between calls
        reg = qt.createQureg(4, env)
        f.run(reg, params={"theta": t})
        p = qt.calcProbOfOutcome(reg, 0, 0)
        out["param_probs"].append(p)
        print(f"theta={t:.1f}  P(q0=0)={p:.6f}")

    # 3. exact gradients for variational optimisation -------------------------
    ham = [[(0, int(qt.PAULI_Z))], [(1, int(qt.PAULI_Z))],
           [(0, int(qt.PAULI_X))]]
    energy = f.expectation_fn(ham, [1.0, 1.0, 0.5])
    params = torch.tensor([0.3], dtype=torch.float64)
    for _ in range(5):                     # 5 steps of gradient descent
        x = params.clone().requires_grad_(True)
        grad, = torch.autograd.grad(energy(x), x)
        params = params - 0.4 * grad
    out["descent_energy"] = float(energy(params))
    out["descent_theta"] = float(params[0])
    print(f"VQE-style descent: E={out['descent_energy']:.6f} "
          f"at theta={out['descent_theta']:.4f}")

    # 4. batched simulation: a whole parameter sweep in one dispatch ----------
    angles = np.linspace(0.0, np.pi, 16).reshape(16, 1)
    zero = torch.zeros(1 << 4, dtype=env.precision.complex_dtype)
    zero[0] = 1.0
    batch = f.sweep(angles, state_f=pack(zero)).cpu().numpy()
    p0 = batch[:, 0, 0] ** 2 + batch[:, 1, 0] ** 2  # |amp(|0000>)|^2
    out["sweep_p0"] = p0
    print(f"batched sweep: 16 angles in one dispatch, "
          f"P(|0000>) from {p0.max():.4f} to {p0.min():.4f}")

    # 5. mesh sharding --------------------------------------------------------
    mesh_env = make_env(device, seed=[7], precision=env.precision,
                        num_devices=8)
    qm = qt.createQureg(mesh_qubits, mesh_env)
    cc = alg.random_circuit(mesh_qubits, depth=6, seed=3).compile(mesh_env)
    cc.run(qm)
    out["mesh_total_prob"] = float(qt.calcTotalProb(qm))
    out["mesh_relayouts"] = int(cc.plan.num_relayouts)
    qm.ensure_canonical()
    out["mesh_amps"] = torch.cat([ch.cpu() for ch in qm.chunks], dim=1) \
        .numpy()
    print(f"8-shard mesh: state held as {len(qm.chunks)} chunks of "
          f"{qm.chunks[0].shape[-1]} amplitudes, "
          f"{out['mesh_relayouts']} planned relayouts, "
          f"totalProb={out['mesh_total_prob']:.12f}")
    return out


if __name__ == "__main__":
    main(parse_device(__doc__))
