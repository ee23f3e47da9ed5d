"""The port's public signatures against the JAX package's.

For every public name both packages define (the functions of ``api.py``,
``algorithms.py``, ``qasm_import.py``, ``ops/dynamics.py``,
``serve/coalesce.py``, ``serve/sched.py``, ``serve/optimize.py``,
``serve/dynamics.py``, ``serve/router.py``, ``serve/warmcache.py``,
``checkpoint.py``, ``resilience/recovery.py``,
``resilience/segments.py``, ``serve/metrics.py`` and every module of
``netserve/``, and the methods of ``Circuit``,
``CompiledCircuit``, ``TrajectoryProgram``, ``Qureg``, ``QuESTEnv``,
``SimulationService``, ``ServiceRouter``, ``WarmCache``, the optimizer
and dynamics classes, ``WireMetrics`` and the front door's classes), the
port's
parameters begin with the
reference's, by name and in order, so a program written for the JAX
package calls the port the same way, positionally or by keyword. The port
may add parameters after them.

``ALLOWED`` is the whole list of exceptions, each with its reason: a
reference parameter the port leaves out, and the port's parameters that
stand in its place (which the comparison then skips on the port's side).
The dataclasses of those modules (``EvolveSpec``, ``GroundSpec``,
``ParsedQASM``) have the same fields with the same defaults.
"""

import dataclasses

import inspect

import pytest
import torch

import quest_tpu as jq
from quest_tpu import algorithms as jalg
from quest_tpu import api as japi
from quest_tpu import qasm_import as jqasm
from quest_tpu.ops import dynamics as jdyn
from quest_tpu.ops.trajectories import TrajectoryProgram as JTrajectories
from quest_tpu.resilience import recovery as jrec
from quest_tpu.serve import SimulationService as JService
from quest_tpu import checkpoint as jckpt
from quest_tpu.resilience import segments as jseg
from quest_tpu.serve import ServiceRouter as JRouter
from quest_tpu.serve import WarmCache as JWarmCache
from quest_tpu.serve import coalesce as jco
from quest_tpu.serve import dynamics as jsdyn
from quest_tpu.serve import optimize as jopt
from quest_tpu.serve import router as jrouter
from quest_tpu.serve import sched as jsched
from quest_tpu.serve import warmcache as jwc
from quest_tpu.serve import metrics as jmetrics
from quest_tpu import netserve as jnet
from quest_tpu.netserve import client as jnclient
from quest_tpu.netserve import errors as jnerrors
from quest_tpu.netserve import robust as jnrobust
from quest_tpu.netserve import server as jnserver
from quest_tpu.netserve import session as jnsession
from quest_tpu.netserve import wire as jnwire
import quest_tpu_torch as tq
from quest_tpu_torch import algorithms as talg
from quest_tpu_torch import api as tapi
from quest_tpu_torch import qasm_import as tqasm
from quest_tpu_torch.ops import dynamics as tdyn
from quest_tpu_torch.ops.trajectories import TrajectoryProgram as TTrajectories
from quest_tpu_torch.resilience import recovery as trec
from quest_tpu_torch.serve import SimulationService as TService
from quest_tpu_torch import checkpoint as tckpt
from quest_tpu_torch.resilience import segments as tseg
from quest_tpu_torch.serve import ServiceRouter as TRouter
from quest_tpu_torch.serve import WarmCache as TWarmCache
from quest_tpu_torch.serve import coalesce as tco
from quest_tpu_torch.serve import dynamics as tsdyn
from quest_tpu_torch.serve import optimize as topt
from quest_tpu_torch.serve import router as trouter
from quest_tpu_torch.serve import sched as tsched
from quest_tpu_torch.serve import warmcache as twc
from quest_tpu_torch.serve import metrics as tmetrics
from quest_tpu_torch import netserve as tnet
from quest_tpu_torch.netserve import client as tnclient
from quest_tpu_torch.netserve import errors as tnerrors
from quest_tpu_torch.netserve import robust as tnrobust
from quest_tpu_torch.netserve import server as tnserver
from quest_tpu_torch.netserve import session as tnsession
from quest_tpu_torch.netserve import wire as tnwire
from torch_threads import one_blas_thread  # noqa: F401

RNG = ("the RNG decision (ROADMAP): the port draws from a "
       "torch.Generator or caller-given uniforms, never jax.random keys")

# (qualified name, reference parameter) -> (port parameters in its place,
# reason)
ALLOWED = {
    ("CompiledCircuit.sample_sweep", "key"): (("generator",), RNG),
    ("TrajectoryProgram.run", "key"): (("uniforms",), RNG),
    ("TrajectoryProgram.run_batch", "key"): (("uniforms",), RNG),
    ("TrajectoryProgram.trajectory_sweep", "key"): (("uniforms",), RNG),
    ("TrajectoryProgram.expectation", "key"): (("seed", "uniforms"), RNG),
    ("TrajectoryProgram.expectation_batch", "key"): (("seed",), RNG),
    ("TrajectoryProgram.expectation_grad", "key"): (("seed", "uniforms"),
                                                    RNG),
    ("TrajectoryProgram.expectation_grad_batch", "key"): (("seed",), RNG),
    ("TrajectoryProgram.apply", "key"): (("uniforms",), RNG),
    ("TrajectoryProgram.sample", "key"): (("seed", "uniforms"), RNG),
    ("TrajectoryProgram.average_density", "key"): (("uniforms",), RNG),
    ("QuESTEnv.__init__", "key"): (("generator",), RNG),
}

MODULES = (("algorithms", jalg, talg), ("qasm_import", jqasm, tqasm),
           ("ops.dynamics", jdyn, tdyn), ("serve.coalesce", jco, tco),
           ("serve.sched", jsched, tsched),
           ("resilience.recovery", jrec, trec),
           ("checkpoint", jckpt, tckpt),
           ("resilience.segments", jseg, tseg),
           ("serve.optimize", jopt, topt), ("serve.dynamics", jsdyn, tsdyn),
           ("serve.router", jrouter, trouter),
           ("serve.metrics", jmetrics, tmetrics),
           ("netserve", jnet, tnet), ("netserve.wire", jnwire, tnwire),
           ("netserve.errors", jnerrors, tnerrors),
           ("netserve.session", jnsession, tnsession),
           ("netserve.robust", jnrobust, tnrobust),
           ("netserve.server", jnserver, tnserver),
           ("netserve.client", jnclient, tnclient))

# modules whose port exports more than the JAX package's names (the warm
# cache's artifact class): every JAX name exists and is compared
SUPERSET_MODULES = (("serve.warmcache", jwc, twc),)

CLASSES = (("Circuit", jq.Circuit, tq.Circuit),
           ("CompiledCircuit", jq.CompiledCircuit, tq.CompiledCircuit),
           ("TrajectoryProgram", JTrajectories, TTrajectories),
           ("Qureg", jq.Qureg, tq.Qureg),
           ("QuESTEnv", jq.QuESTEnv, tq.QuESTEnv),
           ("SimulationService", JService, TService),
           ("ServiceRouter", JRouter, TRouter),
           ("WarmCache", JWarmCache, TWarmCache),
           ("VariationalProblem", jopt.VariationalProblem,
            topt.VariationalProblem),
           ("OptimizationHandle", jopt.OptimizationHandle,
            topt.OptimizationHandle),
           ("GradientDescent", jopt.GradientDescent, topt.GradientDescent),
           ("Adam", jopt.Adam, topt.Adam),
           ("DynamicsProblem", jsdyn.DynamicsProblem, tsdyn.DynamicsProblem),
           ("DynamicsHandle", jsdyn.DynamicsHandle, tsdyn.DynamicsHandle),
           ("WireMetrics", jmetrics.WireMetrics, tmetrics.WireMetrics))

# the front door's classes, compared whole: every public method (and
# __init__) of the JAX package's class exists in the port's and is
# compared
NETSERVE_CLASSES = tuple(
    (name, getattr(jnet, name), getattr(tnet, name))
    for name in jnet.__all__ if isinstance(getattr(jnet, name), type)
    and not issubclass(getattr(jnet, name), Exception)) + (
    ("WorkerPool", jnet._pool.WorkerPool, tnet._pool.WorkerPool),)


def _function(obj):
    if isinstance(obj, (staticmethod, classmethod)):
        return obj.__func__
    return obj if inspect.isfunction(obj) else None


def _shared_callables():
    """``[(qualified name, reference function, port function)]`` for every
    public function and method both packages define."""
    out = []
    for name in japi.__all__:
        jf, tf = getattr(japi, name), getattr(tapi, name, None)
        if inspect.isfunction(jf) and inspect.isfunction(tf):
            out.append((name, jf, tf))
    for mod_name, jmod, tmod in MODULES + SUPERSET_MODULES:
        for name in jmod.__all__:
            jf, tf = getattr(jmod, name), getattr(tmod, name, None)
            if inspect.isfunction(jf) and inspect.isfunction(tf):
                out.append((f"{mod_name}.{name}", jf, tf))
    for cls_name, jcls, tcls in CLASSES + NETSERVE_CLASSES:
        for name in sorted(set(vars(jcls)) & set(vars(tcls))):
            if name.startswith("_") and name != "__init__":
                continue
            jf = _function(inspect.getattr_static(jcls, name))
            tf = _function(inspect.getattr_static(tcls, name))
            if jf is not None and tf is not None:
                out.append((f"{cls_name}.{name}", jf, tf))
    return out


SHARED = _shared_callables()


def _names(fn):
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def test_the_comparison_covers_the_surface():
    names = {q for q, _, _ in SHARED}
    assert len(names) == len(SHARED)
    for must in ("createQuESTEnv", "sampleOutcomes", "setWeightedQureg",
                 "startGateFusion", "Circuit.compile",
                 "Circuit.compile_trajectories", "Circuit.to_qasm",
                 "CompiledCircuit.__init__", "CompiledCircuit.apply",
                 "CompiledCircuit.precompile",
                 "CompiledCircuit.dispatch_stats",
                 "TrajectoryProgram.__init__", "Qureg.device_put",
                 "Qureg.flush_gates", "QuESTEnv.__init__"):
        assert must in names, must


def test_the_new_modules_are_compared_whole():
    """Every public name of the algorithm library, the QASM importer, the
    dynamics module and the serving policy modules (coalescing, WFQ,
    recovery) exists in the port, and each function is compared."""
    names = {q for q, _, _ in SHARED}
    for mod_name, jmod, tmod in MODULES:
        assert tmod.__all__ == jmod.__all__, mod_name
        for name in jmod.__all__:
            assert hasattr(tmod, name), (mod_name, name)
            if inspect.isfunction(getattr(jmod, name)):
                assert f"{mod_name}.{name}" in names, (mod_name, name)
    for must in ("CompiledCircuit.evolve_sweep",
                 "CompiledCircuit.ground_sweep"):
        assert must in names, must


def test_the_serving_core_is_compared_whole():
    names = {q for q, _, _ in SHARED}
    for must in ("createSimulationService", "SimulationService.__init__",
                 "SimulationService.submit", "SimulationService.warm",
                 "SimulationService.optimize", "SimulationService.evolve",
                 "SimulationService.ground_state",
                 "SimulationService.dispatch_stats",
                 "SimulationService.close", "SimulationService.quiesce",
                 "SimulationService.set_tenant",
                 "SimulationService.timeline", "serve.coalesce.split_ready",
                 "serve.sched.plan_wfq_schedule",
                 "resilience.recovery.classify"):
        assert must in names, must


def test_the_rest_of_serving_is_compared_whole():
    """The router, the warm cache, the optimizer and dynamics handles,
    checkpoints and segments: every public name of the JAX package's
    modules exists in the port, and the new entry points are compared."""
    names = {q for q, _, _ in SHARED}
    for mod_name, jmod, tmod in SUPERSET_MODULES:
        assert set(jmod.__all__) <= set(tmod.__all__), mod_name
    for must in ("createServiceRouter", "createVariationalProblem",
                 "ServiceRouter.__init__", "ServiceRouter.submit",
                 "ServiceRouter.warm", "ServiceRouter.optimize",
                 "ServiceRouter.set_tenant", "ServiceRouter.scale_to",
                 "ServiceRouter.rolling_restart",
                 "ServiceRouter.dispatch_stats", "ServiceRouter.close",
                 "ServiceRouter.interactive_pressure",
                 "SimulationService.optimize", "SimulationService.evolve",
                 "SimulationService.ground_state",
                 "WarmCache.__init__", "WarmCache.warm_form",
                 "WarmCache.stats", "serve.warmcache.env_fingerprint",
                 "serve.warmcache.circuit_digest",
                 "CompiledCircuit.lower_batched",
                 "CompiledCircuit.install_batched_aot",
                 "checkpoint.save", "checkpoint.load", "checkpoint.save_npz",
                 "checkpoint.load_npz", "checkpoint.atomic_savez",
                 "checkpoint.atomic_write_json",
                 "resilience.segments.split_circuit",
                 "resilience.segments.checkpointed_run",
                 "resilience.segments.checkpointed_sweep",
                 "resilience.segments.opt_progress_save",
                 "resilience.segments.dyn_progress_load",
                 "serve.optimize.run_optimization",
                 "serve.optimize.resolve_optimizer",
                 "serve.dynamics.run_dynamics", "serve.router.replica_envs",
                 "VariationalProblem.digest", "OptimizationHandle.result",
                 "OptimizationHandle.iterates", "DynamicsHandle.result",
                 "Adam.update", "GradientDescent.update"):
        assert must in names, must
    assert inspect.isclass(TWarmCache.from_env.__self__)
    for name in ("ServiceRouter", "AllReplicasUnavailable", "WarmCache",
                 "VariationalProblem", "OptimizationHandle",
                 "GradientDescent", "Adam", "DynamicsProblem",
                 "DynamicsHandle", "SimulationService"):
        assert name in tq.__all__ and getattr(tq, name) is getattr(
            tq.serve, name), name
    assert [f.name for f in dataclasses.fields(tsdyn.DynamicsProblem)] == \
        [f.name for f in dataclasses.fields(jsdyn.DynamicsProblem)]
    assert [(f.name, f.default) for f in dataclasses.fields(
        topt.VariationalProblem)] == [(f.name, f.default) for f in
                                      dataclasses.fields(
                                          jopt.VariationalProblem)]


@pytest.mark.parametrize("name", ["EvolveSpec", "GroundSpec", "ParsedQASM"])
def test_dataclass_fields_match(name):
    mods = (jdyn, tdyn) if name != "ParsedQASM" else (jqasm, tqasm)
    jf, tf = (dataclasses.fields(getattr(m, name)) for m in mods)
    assert [(f.name, f.default) for f in tf] == \
        [(f.name, f.default) for f in jf]
    assert getattr(tq, name) is getattr(mods[1], name)


def test_the_trajectory_program_is_compared_whole():
    names = {q for q, _, _ in SHARED}
    for must in ("expectation_grad", "expectation_grad_batch", "apply",
                 "dispatch_stats", "expectation", "expectation_batch",
                 "trajectory_sweep", "run", "run_batch", "sample",
                 "average_density"):
        assert f"TrajectoryProgram.{must}" in names, must
    for cls in (JTrajectories, TTrajectories):
        assert isinstance(inspect.getattr_static(cls, "program_digest"),
                          property)
        assert isinstance(inspect.getattr_static(cls, "last_traj_stats"),
                          property)


@pytest.mark.parametrize("qualname,jfn,tfn", SHARED,
                         ids=[q for q, _, _ in SHARED])
def test_port_parameters_begin_with_the_reference(qualname, jfn, tfn):
    ref = _names(jfn)
    port = _names(tfn)
    for (q, ref_param), (stand_ins, reason) in ALLOWED.items():
        if q != qualname:
            continue
        assert reason
        ref.remove(ref_param)
        port = [p for p in port if p not in stand_ins]
    assert port[:len(ref)] == ref, (qualname, ref, port)


def test_every_allowance_names_a_reference_parameter():
    by_name = {q: jf for q, jf, _ in SHARED}
    for (qualname, ref_param), (stand_ins, reason) in ALLOWED.items():
        assert qualname in by_name, qualname
        assert ref_param in _names(by_name[qualname]), (qualname, ref_param)
        assert reason


MISSING_BEFORE = (
    "startGateFusion", "stopGateFusion", "fusedGates", "syncQuESTSuccess",
    "getEnvironmentString", "copyStateToGPU", "copyStateFromGPU",
    "setWeightedQureg", "sampleOutcomes", "reportState",
    "reportStateToScreen", "reportQuregParams", "compareStates",
    "initStateFromSingleFile", "getQuEST_PREC")


@pytest.mark.parametrize("name", MISSING_BEFORE)
def test_the_main_path_names_exist(name):
    assert name in tq.__all__ and callable(getattr(tq, name))


def test_the_class_members_exist():
    for name in ("pauli_string", "to_qasm", "extend", "inverse", "depth"):
        assert hasattr(tq.Circuit, name), name
    for name in ("program_digest", "precompile", "dispatch_stats"):
        assert hasattr(tq.CompiledCircuit, name), name
    for name in ("state", "flush_gates", "is_quad", "num_amps_per_chunk",
                 "num_chunks", "ensure_canonical", "density_matrix_numpy"):
        assert hasattr(tq.Qureg, name), name
    env = tq.createQuESTEnv(num_devices=1, device="cpu")
    assert (env.num_devices, env.rank, env.num_ranks,
            env.is_multihost) == (1, 0, 1, False)
    q = tq.createQureg(3, env)
    assert (q.is_quad, q.num_amps_per_chunk, q.num_chunks) == (False, 8, 1)


def test_num_devices_one_device_only():
    """``num_devices`` of None or 1 is one device; more build a mesh of
    host shards on the CPU, and asking for more CUDA devices than exist,
    or a count that is not a power of 2, raises ``ValueError`` as the JAX
    package's ``create_quest_env`` does."""
    for n in (None, 1):
        env = tq.createQuESTEnv(n, tq.DOUBLE, [3], device="cpu")
        assert env.precision is tq.DOUBLE and env.device.type == "cpu"
        assert env.mesh is None and env.num_devices == 1
    env = tq.createQuESTEnv(num_devices=8, device="cpu")
    assert env.num_devices == 8 and env.mesh.size == 8
    assert all(d.type == "cpu" for d in env.mesh.devices)
    assert env.device == env.mesh.devices[0]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    want = max(have + 1, 2)
    with pytest.raises(ValueError, match=f"requested {want} devices "
                       f"but only {have} available"):
        tq.createQuESTEnv(num_devices=want)
    with pytest.raises(ValueError, match="power of 2"):
        tq.createQuESTEnv(num_devices=3, device="cpu")
    with pytest.raises(ValueError, match="power of 2"):
        tq.createQuESTEnv(devices=["cpu"] * 6)
    assert tq.createQuESTEnv(devices=["cpu"] * 4).num_devices == 4


def test_the_front_door_is_compared_whole():
    """The network front door and its metrics: every public name of the
    JAX package's ``netserve`` modules and ``WireMetrics`` exists in the
    port, every method of their classes is compared, and the entry points
    keep the reference's parameters in order."""
    names = {q for q, _, _ in SHARED}
    for cls_name, jcls, tcls in NETSERVE_CLASSES + (
            ("WireMetrics", jmetrics.WireMetrics, tmetrics.WireMetrics),):
        for name in vars(jcls):
            if name.startswith("_") and name != "__init__":
                continue
            if _function(inspect.getattr_static(jcls, name)) is None:
                continue
            assert f"{cls_name}.{name}" in names, (cls_name, name)
    for must in ("NetServer.__init__", "NetServer.drain",
                 "NetServer.close", "NetClient.__init__",
                 "NetClient.submit", "NetClient.stream",
                 "NetClient.resume_stream", "NetClient.submit_wire",
                 "netserve.wire.encode_circuit",
                 "netserve.wire.decode_circuit",
                 "netserve.wire.encode_request",
                 "netserve.wire.decode_request",
                 "netserve.wire.encode_result",
                 "netserve.wire.parse_result",
                 "netserve.wire.canonical_json",
                 "netserve.errors.raise_typed",
                 "netserve.errors.http_status",
                 "netserve.robust.backlog_estimate",
                 "SessionManager.__init__", "ProgramRegistry.register",
                 "DedupWindow.begin", "TokenBucket.acquire",
                 "ResumableStream.attach", "WireMetrics.snapshot",
                 "WorkerPool.submit"):
        assert must in names, must
    assert tnet.WIRE_SCHEMA == jnet.WIRE_SCHEMA == "quest_tpu.wire/1"
    assert tnet.REQUEST_KINDS == jnet.REQUEST_KINDS
    assert tnwire._REQUEST_KEYS == jnwire._REQUEST_KEYS
    assert tnwire._FORBIDDEN_DEADLINE_KEYS == jnwire._FORBIDDEN_DEADLINE_KEYS
    assert tnwire._MAX_REQUEST_ID_LEN == jnwire._MAX_REQUEST_ID_LEN
    assert sorted(tnwire._REPLAY) == sorted(jnwire._REPLAY)
    assert tmetrics._WIRE_COUNTERS == jmetrics._WIRE_COUNTERS
