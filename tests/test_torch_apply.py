"""The PyTorch port's gate engine (quest_tpu_torch/core/apply.py) against
the JAX package's (quest_tpu/core/apply.py), on the CPU in float64.

The same seeded state and matrices go through both; the port updates its
planes in place. Bound: 1e-12 on amplitudes of a normalised state (both
sides do the same float64 contractions in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from quest_tpu.core import apply as japply
from quest_tpu_torch.core import apply as tapply
from torch_threads import one_blas_thread  # noqa: F401

N = 8
TOL = 1e-12

# (targets, controls, flipped controls): the permute-free fast paths
# (lowest k qubits, a contiguous block) and the generic permute path
# (scattered targets, controls, flip masks), for 1..4 targets
CASES = [
    ((0,), (), ()),
    ((1, 0), (), ()),
    ((0, 1, 2, 3), (), ()),
    ((3,), (), ()),
    ((4, 5), (), ()),
    ((6, 4, 5), (), ()),
    ((2, 7), (), ()),
    ((7, 0, 4), (), ()),
    ((1, 3, 5, 7), (), ()),
    ((5,), (0,), ()),
    ((2,), (6, 7), (7,)),
    ((0, 1), (4,), (4,)),
    ((6, 3), (1, 7), ()),
    ((2, 4, 6), (0,), ()),
    ((0, 2, 5, 7), (3,), (3,)),
]


def _random_state(rng, n):
    z = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    return z / np.linalg.norm(z)


def _random_matrix(rng, dim):
    # a general (non-unitary) matrix: the engine applies any operator
    return rng.normal(size=(dim, dim)) + 1j * rng.normal(size=(dim, dim))


def _planes(z):
    return torch.as_tensor(np.stack([z.real, z.imag]), dtype=torch.float64)


def _mask(qs):
    m = 0
    for q in qs:
        m |= 1 << q
    return m


@pytest.mark.parametrize("targets,controls,flipped", CASES,
                         ids=[f"t{c[0]}-c{c[1]}-f{c[2]}" for c in CASES])
def test_apply_unitary_matches_jax(targets, controls, flipped):
    rng = np.random.default_rng(hash((targets, controls)) & 0xFFFF)
    z = _random_state(rng, N)
    u = _random_matrix(rng, 1 << len(targets))
    cm, fm = _mask(controls), _mask(flipped)
    want = np.asarray(japply.apply_unitary(jnp.asarray(z), N, jnp.asarray(u),
                                           targets, cm, fm))
    planes = _planes(z)
    out = tapply.apply_unitary(planes, N, u, targets, cm, fm)
    assert out is planes                      # updated in place
    got = planes[0].numpy() + 1j * planes[1].numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("qubits", [(0,), (5,), (1, 0), (7, 2), (3, 6, 0),
                                    (1, 4, 5, 7)])
def test_apply_diagonal_matches_jax(qubits):
    rng = np.random.default_rng(sum(qubits) + 17 * len(qubits))
    z = _random_state(rng, N)
    d = np.exp(1j * rng.uniform(0, 2 * np.pi, (2,) * len(qubits)))
    d = d * rng.uniform(0.5, 1.5, d.shape)           # not only phases
    desc = tuple(sorted(qubits, reverse=True))
    want = np.asarray(japply.apply_diagonal(jnp.asarray(z), N, desc,
                                            jnp.asarray(d)))
    planes = _planes(z)
    tapply.apply_diagonal(planes, N, desc, d)
    got = planes[0].numpy() + 1j * planes[1].numpy()
    assert np.abs(got - want).max() <= TOL


@pytest.mark.parametrize("targets", [(0, 1), (2, 0, 1), (5, 3), (1, 4, 2)])
def test_bit_order_permutations_match_jax(targets):
    order = tuple(sorted(targets))
    assert np.array_equal(tapply.permutation_to_order(targets, order),
                          japply.permutation_to_order(targets, order))
    assert np.array_equal(tapply.permutation_to_sorted_desc(targets),
                          japply.permutation_to_sorted_desc(targets))
    desc = tuple(sorted(targets, reverse=True))
    assert tapply.split_shape(N, desc) == japply.split_shape(N, desc)
