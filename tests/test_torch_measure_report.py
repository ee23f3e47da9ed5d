"""The port's ``setWeightedQureg``, ``sampleOutcomes`` and the reporting and
housekeeping names (``reportState``/``initStateFromSingleFile``,
``compareStates``, ``getEnvironmentString``, ``getQuEST_PREC``, ...)
against the JAX package's, on the CPU in float64.

Mirrors the ``setWeightedQureg`` and ``sampleOutcomes`` cases of
``tests/test_measure_calc.py`` and the report and env cases of
``tests/test_init_env_qasm.py``. The two packages draw from different
random streams, so the port's sampler is fed numpy uniforms and held, index
for index, against a numpy inverse CDF over the JAX register's
probabilities; its own draws are held to each bin's probability within 5
standard errors.
"""

import numpy as np
import pytest
import torch

import quest_tpu as jq
from quest_tpu.validation import ErrorCode as JErrorCode
import quest_tpu_torch as tq
from quest_tpu_torch.parallel.sampling import sample_outcomes
from torch_threads import one_blas_thread  # noqa: F401

TOL = 1e-12
N = 5


@pytest.fixture(scope="module")
def envs():
    return (jq.createQuESTEnv(num_devices=1, precision=jq.DOUBLE, seed=[9]),
            tq.createQuESTEnv(num_devices=1, precision=tq.DOUBLE, seed=[9],
                              device="cpu"))


def _state(dim, seed):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=dim) + 1j * rng.normal(size=dim)
    return z / np.linalg.norm(z)


def _pair(envs, n, seed, density=False):
    """The same random state (a random mixed state for a density
    register) in a JAX and a port register."""
    if density:
        dim = 1 << n
        a = _state(dim * dim, seed).reshape(dim, dim)
        rho = a @ a.conj().T
        flat = (rho / np.trace(rho)).T.reshape(-1)
        regs = (jq.createDensityQureg(n, envs[0]),
                tq.createDensityQureg(n, envs[1]))
        for pkg, q in zip((jq, tq), regs):
            pkg.setDensityAmps(q, flat.real, flat.imag)
        return regs
    z = _state(1 << n, seed)
    regs = (jq.createQureg(n, envs[0]), tq.createQureg(n, envs[1]))
    for pkg, q in zip((jq, tq), regs):
        pkg.initStateFromAmps(q, z.real, z.imag)
    return regs


def _code(excinfo):
    return int(excinfo.value.code)


# -- setWeightedQureg ---------------------------------------------------------

FACTORS = ((0.3 + 0.1j, -0.2j, 0.5), (1.0, 0.0, -0.7 + 0.2j),
           (-0.25, 0.5 + 0.5j, 0.0))


@pytest.mark.parametrize("density", [False, True])
@pytest.mark.parametrize("alias", ["none", "first", "second"])
@pytest.mark.parametrize("facs", FACTORS)
def test_set_weighted_matches_jax(envs, density, alias, facs):
    n = 3 if density else N
    ja, ta = _pair(envs, n, 1, density)
    jb, tb = _pair(envs, n, 2, density)
    jo, to = _pair(envs, n, 3, density)
    if alias == "first":
        jo, to = ja, ta
    elif alias == "second":
        jo, to = jb, tb
    f1, f2, fo = facs
    jq.setWeightedQureg(f1, ja, f2, jb, fo, jo)
    tq.setWeightedQureg(f1, ta, f2, tb, fo, to)
    np.testing.assert_allclose(to.to_numpy(), jo.to_numpy(), atol=TOL)


def test_set_weighted_oracle(envs):
    _, ta = _pair(envs, N, 4)
    _, tb = _pair(envs, N, 5)
    a, b = ta.to_numpy(), tb.to_numpy()
    out = tq.createQureg(N, envs[1])
    tq.setWeightedQureg(0.3 + 0.1j, ta, -0.2j, tb, 0.5, out)
    want = (0.3 + 0.1j) * a + (-0.2j) * b + 0.5 * np.eye(1 << N)[0]
    np.testing.assert_allclose(out.to_numpy(), want, atol=TOL)
    np.testing.assert_allclose(ta.to_numpy(), a, atol=0)   # inputs kept


def test_set_weighted_in_chunks(envs, monkeypatch):
    from quest_tpu_torch.ops import statevec
    monkeypatch.setattr(statevec, "WEIGHTED_CHUNK", 8)
    ja, ta = _pair(envs, N, 6)
    jb, tb = _pair(envs, N, 7)
    jq.setWeightedQureg(0.5j, ja, 0.25, jb, -1.0 + 0.5j, ja)
    tq.setWeightedQureg(0.5j, ta, 0.25, tb, -1.0 + 0.5j, ta)
    np.testing.assert_allclose(ta.to_numpy(), ja.to_numpy(), atol=TOL)


def test_set_weighted_validation_codes(envs):
    jenv, tenv = envs
    cases = (lambda pkg, env: (pkg.createQureg(2, env),
                               pkg.createDensityQureg(2, env),
                               pkg.createQureg(2, env)),
             lambda pkg, env: (pkg.createQureg(2, env),
                               pkg.createQureg(3, env),
                               pkg.createQureg(2, env)),
             lambda pkg, env: (pkg.createQureg(2, env),
                               pkg.createQureg(2, env),
                               pkg.createDensityQureg(2, env)))
    for make in cases:
        a, b, o = make(jq, jenv)
        with pytest.raises(jq.QuESTError) as je:
            jq.setWeightedQureg(1.0, a, 1.0, b, 0.0, o)
        a, b, o = make(tq, tenv)
        with pytest.raises(tq.QuESTError) as te:
            tq.setWeightedQureg(1.0, a, 1.0, b, 0.0, o)
        assert _code(te) == _code(je)


# -- sampleOutcomes -----------------------------------------------------------

def _numpy_inverse_cdf(probs, uniforms):
    cum = np.cumsum(probs)
    idx = np.searchsorted(cum, uniforms * cum[-1], side="right")
    return np.minimum(idx, probs.size - 1)


@pytest.mark.parametrize("density", [False, True])
def test_sampler_matches_numpy_inverse_cdf(envs, density):
    n = 3 if density else 7
    jqr, tqr = _pair(envs, n, 11, density)
    if density:
        probs = np.clip(np.real(np.diag(jqr.density_matrix_numpy())), 0,
                        None)
        planes = tqr.state
        dim = 1 << n
        tprobs = planes[0].view(dim, dim).diagonal().clamp(min=0.0)
    else:
        probs = np.abs(jqr.to_numpy()) ** 2
        tprobs = tqr.state[0] ** 2 + tqr.state[1] ** 2
    u = np.random.default_rng(12).random(20000)
    idx, total = sample_outcomes(tprobs, torch.as_tensor(u))
    np.testing.assert_array_equal(idx.numpy(), _numpy_inverse_cdf(probs, u))
    assert abs(float(total) - probs.sum()) < TOL


def _within_5_stderr(samples, probs):
    m = samples.size
    freq = np.bincount(samples, minlength=probs.size) / m
    stderr = np.sqrt(probs * (1 - probs) / m)
    assert np.all(np.abs(freq - probs) <= 5 * stderr + 1e-12), (freq, probs)


@pytest.mark.parametrize("density", [False, True])
def test_draws_within_5_stderr(envs, density):
    n = 3 if density else 6
    jqr, tqr = _pair(envs, n, 13, density)
    before = tqr.to_numpy()
    s = tq.sampleOutcomes(tqr, 40000)
    np.testing.assert_array_equal(tqr.to_numpy(), before)   # no collapse
    if density:
        probs = np.clip(np.real(np.diag(jqr.density_matrix_numpy())), 0,
                        None)
    else:
        probs = np.abs(jqr.to_numpy()) ** 2
    _within_5_stderr(s, probs / probs.sum())
    # the env's generator advanced: a second batch differs
    assert not np.array_equal(s[:100], tq.sampleOutcomes(tqr, 100))


def test_bell_pair_and_packing(envs):
    env = envs[1]
    q = tq.createQureg(3, env)
    tq.hadamard(q, 0)
    tq.controlledNot(q, 0, 1)
    s = tq.sampleOutcomes(q, 4000)
    assert set(np.unique(s)) == {0, 3}
    q = tq.createQureg(3, env)
    tq.initClassicalState(q, 0b101)
    # bit 0 <- qubit 2 (= 1), bit 1 <- qubit 0 (= 1): always 0b11
    np.testing.assert_array_equal(tq.sampleOutcomes(q, 16, qubits=[2, 0]),
                                  np.full(16, 3))
    np.testing.assert_array_equal(tq.sampleOutcomes(q, 8, qubits=[1]),
                                  np.zeros(8))


def test_packed_marginals_within_5_stderr(envs):
    jqr, tqr = _pair(envs, 6, 14)
    s = tq.sampleOutcomes(tqr, 40000, qubits=[4, 1])
    p = (np.abs(jqr.to_numpy()) ** 2).reshape(2, 2, 2, 2, 2, 2)
    # axis 5 - q is qubit q; bit 0 of the packed value is qubit 4
    marg = p.sum(axis=(0, 2, 3, 5))             # [q4, q1]
    want = np.array([marg[0, 0], marg[1, 0], marg[0, 1], marg[1, 1]])
    _within_5_stderr(s, want)


def test_density_diagonal_not_squared(envs):
    # a non-uniform diagonal: sampling |planes|^2 of the flat vector
    # would give other bins
    d = tq.createDensityQureg(2, envs[1])
    tq.rotateY(d, 0, 0.4)
    tq.rotateY(d, 1, 1.2)
    tq.mixDephasing(d, 0, 0.5)
    tq.mixDephasing(d, 1, 0.5)
    p0, p1 = float(np.sin(0.2) ** 2), float(np.sin(0.6) ** 2)
    want = np.array([(1 - p0) * (1 - p1), p0 * (1 - p1), (1 - p0) * p1,
                     p0 * p1])
    _within_5_stderr(tq.sampleOutcomes(d, 20000), want)


@pytest.mark.parametrize("case", ["zero_shots", "repeated_qubit",
                                  "qubit_out_of_range", "zero_norm"])
def test_sample_errors_carry_the_reference_codes(envs, case):
    codes = []
    for pkg, env in zip((jq, tq), envs):
        q = pkg.createQureg(3, env)
        if case == "zero_norm":
            pkg.initBlankState(q)
        call = {"zero_shots": lambda: pkg.sampleOutcomes(q, 0),
                "repeated_qubit": lambda: pkg.sampleOutcomes(
                    q, 4, qubits=[0, 0]),
                "qubit_out_of_range": lambda: pkg.sampleOutcomes(
                    q, 4, qubits=[5]),
                "zero_norm": lambda: pkg.sampleOutcomes(q, 8)}[case]
        with pytest.raises(pkg.QuESTError) as e:
            call()
        codes.append(_code(e))
    assert codes[0] == codes[1]
    if case == "zero_norm":
        assert codes[1] == int(JErrorCode.E_COLLAPSE_STATE_ZERO_PROB)


def test_sampling_flushes_buffered_gates(envs):
    q = tq.createQureg(2, envs[1])
    with tq.fusedGates(q):
        tq.pauliX(q, 1)
        np.testing.assert_array_equal(tq.sampleOutcomes(q, 8), np.full(8, 2))


# -- reporting and housekeeping -----------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("density", [False, True])
def test_report_state_round_trips_across_packages(envs, tmp_path, writer,
                                                  density):
    n = 2 if density else N
    jqr, tqr = _pair(envs, n, 21, density)
    path = str(tmp_path / "state.csv")
    if writer == "jax":
        jq.reportState(jqr, path)
    else:
        tq.reportState(tqr, path)
    with open(path) as f:
        text = f.read()
    other = str(tmp_path / "other.csv")
    (tq if writer == "jax" else jq).reportState(
        tqr if writer == "jax" else jqr, other)
    with open(other) as f:
        assert f.read() == text        # the same CSV form, byte for byte
    make = "createDensityQureg" if density else "createQureg"
    for pkg, env in zip((jq, tq), envs):
        q = getattr(pkg, make)(n, env)
        pkg.initStateFromSingleFile(q, path)
        np.testing.assert_allclose(q.to_numpy(), jqr.to_numpy(), atol=1e-11)


def test_init_from_file_errors(envs, tmp_path):
    path = str(tmp_path / "short.csv")
    tq.reportState(tq.createQureg(2, envs[1]), path)
    codes = []
    for pkg, env in zip((jq, tq), envs):
        q = pkg.createQureg(3, env)
        with pytest.raises(pkg.QuESTError) as e:
            pkg.initStateFromSingleFile(q, path)
        codes.append(_code(e))
        with pytest.raises(pkg.QuESTError) as e:
            pkg.initStateFromSingleFile(q, str(tmp_path / "missing.csv"))
        codes.append(_code(e))
    assert codes[:2] == codes[2:]


def test_compare_states(envs):
    for pkg, env in zip((jq, tq), envs):
        q1 = pkg.createQureg(3, env)
        q2 = pkg.createQureg(3, env)
        pkg.initPlusState(q1)
        pkg.initPlusState(q2)
        assert pkg.compareStates(q1, q2, 1e-12)
        pkg.phaseShift(q2, 0, 1e-6)
        assert not pkg.compareStates(q1, q2, 1e-12)
        assert pkg.compareStates(q1, q2, 1e-5)
    with pytest.raises(tq.QuESTError):
        tq.compareStates(tq.createQureg(2, envs[1]),
                         tq.createQureg(3, envs[1]), 1e-3)


def test_environment_string_and_precision(envs):
    jenv, tenv = envs
    s = tq.getEnvironmentString(tenv)
    assert s == jq.getEnvironmentString(jenv), s
    assert s.startswith("CUDA=0 ") and "backend=cpu" in s
    # each package's default precision: the port's is SINGLE, the card's
    # native format, as the JAX package's is without x64 (on the TPU)
    from quest_tpu.config import default_precision as jdefault
    from quest_tpu_torch.config import default_precision as tdefault
    assert tq.getQuEST_PREC() == tdefault().quest_prec == 1
    assert jq.getQuEST_PREC() == jdefault().quest_prec
    assert tq.syncQuESTSuccess(3) == jq.syncQuESTSuccess(3) == 1
    assert tq.syncQuESTSuccess(0) == 0


def test_screen_reports(envs, capsys):
    jenv, tenv = envs
    outs = []
    for pkg, env in zip((jq, tq), envs):
        q = pkg.createQureg(2, env)
        pkg.hadamard(q, 0)
        pkg.reportStateToScreen(q, env)
        pkg.reportStateToScreen(pkg.createQureg(6, env), env)  # silent
        pkg.reportStateToScreen(pkg.createDensityQureg(3, env), env)
        pkg.reportQuregParams(q)
        pkg.copyStateToGPU(q)
        pkg.copyStateFromGPU(q)
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]


def test_density_matrix_numpy(envs):
    jd, td = _pair(envs, 3, 31, density=True)
    np.testing.assert_allclose(td.density_matrix_numpy(),
                               jd.density_matrix_numpy(), atol=TOL)
    rho = td.density_matrix_numpy()
    assert np.allclose(rho, rho.conj().T, atol=TOL)
