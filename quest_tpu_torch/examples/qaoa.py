"""QAOA for MaxCut on the port: differentiable compiled circuits end to
end.

The port's counterpart of the JAX package's ``examples/qaoa.py``: a 6-node
ring + chords graph, 2 QAOA layers, the cut expectation as a function of
the parameter vector whose gradient is exact
(``CompiledCircuit.expectation_fn``, a ``torch.autograd.Function`` whose
backward is the adjoint walk), and ``torch.optim.Adam`` with optax.adam's
settings in place of optax. The final parameters are checked by sampling
the optimised state.

Run: python -m quest_tpu_torch.examples.qaoa [--device cpu]
"""

import numpy as np
import torch

import quest_tpu_torch as qt
from quest_tpu_torch import algorithms as alg
from quest_tpu_torch.examples._common import make_env, parse_device

N = 6
EDGES = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (5, 0),  # ring
         (0, 3), (1, 4)]                                  # chords
LAYERS = 2


def cut_size(bits: int) -> int:
    return sum(((bits >> u) & 1) != ((bits >> v) & 1) for u, v in EDGES)


def main(device=None, steps: int = 120, shots: int = 256) -> dict:
    env = make_env(device, seed=[2026])
    circuit = alg.qaoa_maxcut(N, EDGES, num_layers=LAYERS)
    compiled = circuit.compile(env)
    terms, coeffs = alg.qaoa_maxcut_terms(EDGES)
    energy = compiled.expectation_fn(terms, coeffs)

    params = torch.tensor([0.5, 0.5, 0.3, 0.3], dtype=torch.float64,
                          requires_grad=True)
    opt = torch.optim.Adam([params], lr=0.1, betas=(0.9, 0.999),
                           eps=1e-8, foreach=False)
    for step in range(steps):
        opt.zero_grad()
        e = energy(params)
        e.backward()
        opt.step()
        if step % 30 == 0:
            print(f"step {step:3d}: <C> - |E|/2 = "
                  f"{float(e.detach()):+.4f}")

    final = params.detach().numpy().copy()
    best = max(cut_size(b) for b in range(1 << N))
    expect_cut = len(EDGES) / 2.0 - float(energy(torch.as_tensor(final)))
    print(f"optimised expected cut = {expect_cut:.3f}  (max cut = {best})")

    # sample the optimised state and report the best drawn cut
    q = qt.createQureg(N, env)
    qt.initZeroState(q)
    compiled.run(q, params={nm: float(final[i])
                            for i, nm in enumerate(compiled.param_names)})
    draws = qt.sampleOutcomes(q, shots)
    best_drawn = max(cut_size(int(b)) for b in draws)
    print(f"best cut among {shots} samples: {best_drawn}")
    assert expect_cut > 0.85 * best
    assert best_drawn == best
    return {"params": final, "expected_cut": expect_cut, "max_cut": best,
            "best_drawn": best_drawn, "num_draws": len(draws)}


if __name__ == "__main__":
    main(parse_device(__doc__))
