"""The public QuEST-compatible API surface.

Counterpart of the JAX package's ``api.py`` for state vectors and density
matrices on one device: the same names, argument orders, validation (the same
:class:`~quest_tpu_torch.validation.ErrorCode` on the same bad input) and
numerical conventions. Each function follows the reference's 3-step shape
(``QuEST.c``): validate -> apply -> record QASM. Gates update the
register's planes in place (``core/apply.py``); ``calc*`` functions return
Python floats/complex (a device sync).

Measurement draws come from the env's :class:`torch.Generator`; they are
not the JAX package's threefry bits, so outcome parity between the two
packages is held through :func:`collapseToOutcome`.

A density register of n qubits holds the flat 2n-qubit vector
``flat[r + c*2^n] = rho[r, c]`` (``ops/densmatr.py``). As in the JAX
package, an uncontrolled gate acts on it as the single combined operator
``conj(U) (x) U`` on ``(targets, targets+n)`` — one pass over the 4^n
amplitudes where the reference makes two (``QuEST.c:175-658``) — and a
controlled gate as the reference's two passes.

On a mesh env (``createQuESTEnv(num_devices=n)``) a register is
amplitude-sharded over the shards' chunks (``qureg.py``) and the
functions below route over them, as the JAX package's mesh paths do: gates
through the lazy-layout per-gate engine (``parallel/pergate.py``; a SWAP
is layout metadata), density channels as sharded superoperators and
diagonals, and the ``calc*`` reductions, ``collapseToOutcome``,
``measure``, ``sampleOutcomes``, ``getAmp`` and the ``init*`` functions
chunk by chunk (``parallel/chunks.py``; partial sums combined in float64).
A function not routed yet raises ``NotImplementedError`` naming ROADMAP
Queue 1 item 8; none computes on a gathered copy.

A QUAD or QUAD64 register (``(4, 2^N)`` double-double planes) takes the
same dispatch shapes through the dd kernels of ``ops/doubledouble.py``
(``ddm``), as the JAX package's ``is_quad`` branches do; its reductions
come back as compensated pairs combined in host double precision.
"""

from __future__ import annotations

import math
import numbers
from typing import Optional, Sequence

import numpy as np
import torch

from . import validation as val
from .config import Precision
from .core import matrices as mats
from .core.apply import apply_diagonal, apply_unitary, bitmask, split_shape
from .env import QuESTEnv, create_quest_env, destroy_quest_env
from .ops import channels as chan
from .ops import densmatr as dm
from .ops import doubledouble as ddm
from .ops import initstates as ist
from .ops import reductions as red
from .ops import statevec as sv
from .parallel import chunks as chk
from .parallel import pergate as _pg
from .parallel.pergate import GateFusionBuffer
from .parallel.sampling import sample_outcomes, sample_sharded
from .qureg import Qureg
from .types import PauliOpType, QuESTError

__all__ = [
    # env
    "createQuESTEnv", "destroyQuESTEnv", "syncQuESTEnv", "syncQuESTSuccess",
    "reportQuESTEnv", "getEnvironmentString", "seedQuEST", "seedQuESTDefault",
    # the serving runtime (no QuEST counterpart)
    "createSimulationService", "createServiceRouter",
    "createVariationalProblem",
    # imperative gate fusion
    "startGateFusion", "stopGateFusion", "fusedGates",
    # registers
    "createQureg", "createDensityQureg", "createCloneQureg", "destroyQureg",
    "createComplexMatrixN", "destroyComplexMatrixN", "initComplexMatrixN",
    "copyStateToGPU", "copyStateFromGPU",
    # init
    "initBlankState", "initZeroState", "initPlusState", "initClassicalState",
    "initPureState", "initDebugState", "initStateFromAmps", "setAmps",
    "setDensityAmps", "cloneQureg", "setWeightedQureg",
    "initStateOfSingleQubit",
    # 1q gates
    "phaseShift", "sGate", "tGate", "pauliX", "pauliY", "pauliZ", "hadamard",
    "compactUnitary", "unitary", "rotateX", "rotateY", "rotateZ",
    "rotateAroundAxis",
    # controlled / multi-qubit
    "controlledPhaseShift", "multiControlledPhaseShift", "controlledPhaseFlip",
    "multiControlledPhaseFlip", "controlledNot", "controlledPauliY",
    "controlledRotateX", "controlledRotateY", "controlledRotateZ",
    "controlledRotateAroundAxis", "controlledCompactUnitary",
    "controlledUnitary", "multiControlledUnitary", "multiStateControlledUnitary",
    "swapGate", "sqrtSwapGate", "multiRotateZ", "multiRotatePauli",
    "twoQubitUnitary", "controlledTwoQubitUnitary",
    "multiControlledTwoQubitUnitary", "multiQubitUnitary",
    "controlledMultiQubitUnitary", "multiControlledMultiQubitUnitary",
    # measurement
    "calcProbOfOutcome", "collapseToOutcome", "measure", "measureWithStats",
    "sampleOutcomes",
    # calculations
    "getNumQubits", "getNumAmps", "getAmp", "getRealAmp", "getImagAmp",
    "getProbAmp", "getDensityAmp", "calcTotalProb", "calcInnerProduct",
    "calcDensityInnerProduct", "calcPurity", "calcFidelity",
    "calcExpecPauliProd", "calcExpecPauliSum", "calcHilbertSchmidtDistance",
    "applyPauliSum",
    # decoherence
    "mixDephasing", "mixTwoQubitDephasing", "mixDepolarising", "mixDamping",
    "mixTwoQubitDepolarising", "mixPauli", "mixDensityMatrix", "mixKrausMap",
    "mixTwoQubitKrausMap", "mixMultiQubitKrausMap",
    # QASM
    "startRecordingQASM", "stopRecordingQASM", "clearRecordedQASM",
    "printRecordedQASM", "writeRecordedQASMToFile",
    # debug / reporting
    "reportState", "reportStateToScreen", "reportQuregParams",
    "compareStates", "initStateFromSingleFile", "getQuEST_PREC",
]


def _canon(*quregs) -> None:
    """Restore canonical qubit layout on each register (a no-op off the
    sharded per-gate path): before positional reads and
    register-to-register functions."""
    for q in quregs:
        q.ensure_canonical()


def _pair(pair) -> float:
    s, e = pair
    return float(s) + float(e)


def _apply_gate(qureg: Qureg, u: np.ndarray, targets: Sequence[int],
                controls: Sequence[int] = (),
                flips: Sequence[int] = ()) -> None:
    """Apply u (with controls) to a register, in place; a density register
    takes the passes of :func:`densmatr.gate_passes` (one fused pass when
    uncontrolled, two when controlled)."""
    targets = tuple(int(t) for t in targets)
    ctrl_mask, flip_mask = bitmask(controls), bitmask(flips)
    if qureg.is_quad:
        return _dd_gate(qureg, u, targets, ctrl_mask, flip_mask)
    buf = qureg._fusion_buffer
    if buf is not None and not buf.flushing:
        # opt-in imperative fusion (startGateFusion): record the LOGICAL
        # gate; the buffer contracts and dispatches at the next state read
        buf.add_gate(u, targets, ctrl_mask, flip_mask)
        return
    nv = qureg.num_qubits_in_state_vec
    if _pg.use_lazy(qureg):
        passes = [(np.asarray, targets, ctrl_mask, flip_mask)] \
            if not qureg.is_density_matrix else dm.gate_passes(
                targets, ctrl_mask, flip_mask, qureg.num_qubits_represented)
        for lift, ts, cm, fm in passes:
            _sharded_unitary(qureg, lift(u), ts, cm, fm)
        return
    if not qureg.is_density_matrix:
        apply_unitary(qureg.state, nv, u, targets, ctrl_mask, flip_mask)
        return
    for lift, ts, cm, fm in dm.gate_passes(targets, ctrl_mask, flip_mask,
                                           qureg.num_qubits_represented):
        apply_unitary(qureg.state, nv, lift(u), ts, cm, fm)


def _sharded_unitary(qureg: Qureg, u, targets, ctrl_mask: int,
                     flip_mask: int) -> None:
    """One dense pass on a sharded register through the per-gate engine;
    a gate wider than the chunk's local positions raises (the JAX
    package takes its GSPMD path there; the port has no gathered
    fallback)."""
    if not _pg.fits_local(qureg, len(targets)):
        raise qureg._unrouted(
            f"a {len(targets)}-qubit dense pass wider than the "
            f"{qureg.num_qubits_in_state_vec - _pg._shard_bits(qureg)} "
            "local qubits of each chunk")
    _pg.sharded_unitary(qureg, u, targets, ctrl_mask, flip_mask)


def _dd_gate(qureg: Qureg, u: np.ndarray, targets: tuple,
             ctrl_mask: int, flip_mask: int) -> None:
    """QUAD-register gate application: dense k-qubit dd kernels
    (``ops/doubledouble.py``) with the same density-matrix dispatch shapes
    as the native-precision path."""
    nv = qureg.num_qubits_in_state_vec
    state = qureg.state
    if not qureg.is_density_matrix:
        qureg.state = ddm.dd_apply_kq(state, nv, u, targets, ctrl_mask,
                                      flip_mask)
        return
    for lift, ts, cm, fm in dm.gate_passes(targets, ctrl_mask, flip_mask,
                                           qureg.num_qubits_represented):
        state = ddm.dd_apply_kq(state, nv, lift(u), ts, cm, fm)
    qureg.state = state


def _apply_diag_gate(qureg: Qureg, tensor: np.ndarray,
                     qubits: Sequence[int]) -> None:
    """Apply a diagonal factor tensor (axis i = i-th qubit of ``qubits``
    sorted descending); a density register takes the outer product of
    :func:`densmatr.diagonal_lift`."""
    qs = tuple(sorted((int(q) for q in qubits), reverse=True))
    tensor = np.asarray(tensor, dtype=np.complex128)
    buf = qureg._fusion_buffer
    if buf is not None and not buf.flushing:
        buf.add_diag(tensor, qs)
        return
    if qureg.is_density_matrix:
        lift, qs = dm.diagonal_lift(qs, qureg.num_qubits_represented)
        tensor = lift(tensor)
    if qureg.is_quad:
        qureg.state = ddm.dd_apply_diag(
            qureg.state, qureg.num_qubits_in_state_vec, tensor, qs)
        return
    if _pg.use_lazy(qureg):
        # diagonals never pair amplitudes: any position, no communication
        _pg.sharded_diag(qureg, tensor, qs)
        return
    apply_diagonal(qureg.state, qureg.num_qubits_in_state_vec, qs, tensor)


def _dispatch_fused_op(qureg: Qureg, op) -> None:
    """Apply one fused-group record from the imperative fusion buffer
    through the regular per-gate dispatch (called with the buffer's
    ``flushing`` flag set, so the recursion bottoms out)."""
    if op.kind == "u":
        controls = tuple(q for q in range(qureg.num_qubits_represented)
                         if (op.ctrl_mask >> q) & 1)
        flips = tuple(c for c in controls if (op.flip_mask >> c) & 1)
        _apply_gate(qureg, op.mat, op.targets, controls, flips)
    else:
        _apply_diag_gate(qureg, op.diag, op.targets)


def startGateFusion(qureg: Qureg, max_qubits: int = 3) -> None:
    """Buffer subsequent imperative gate calls and dispatch them as fused
    groups of combined support <= ``max_qubits`` (the compiled pipeline's
    gate-fusion engine, :mod:`quest_tpu_torch.core.fusion`, applied to the
    per-gate path). Flushing is automatic at any state read (measure,
    calc*, get*, compiled run, host copy) and at :func:`stopGateFusion`.
    No reference counterpart; QUAD registers are unsupported (their
    double-double kernels dispatch eagerly)."""
    if qureg.is_quad:
        raise QuESTError("gate fusion is not supported on QUAD registers")
    new = GateFusionBuffer(qureg, max_qubits)
    buf = qureg._fusion_buffer
    if buf is not None:
        if buf.max_k == new.max_k:
            return                      # already active at this budget
        buf.flush()                     # re-arm at the new support cap
    qureg._fusion_buffer = new


def stopGateFusion(qureg: Qureg) -> None:
    """Flush any buffered gates and return to eager per-gate dispatch."""
    buf = qureg._fusion_buffer
    if buf is not None:
        buf.flush()
        qureg._fusion_buffer = None


class fusedGates:
    """Context manager form of :func:`startGateFusion` ::

        with qt.fusedGates(qureg, max_qubits=3):
            for q in range(n):
                qt.hadamard(qureg, q)      # buffered, dispatched fused

    Contexts nest: the inner block flushes on exit and the outer buffer
    resumes (where a bare ``stopGateFusion`` turns fusion off entirely).
    """

    def __init__(self, qureg: Qureg, max_qubits: int = 3):
        self.qureg = qureg
        self.max_qubits = max_qubits

    def __enter__(self):
        self._prev = self.qureg._fusion_buffer
        startGateFusion(self.qureg, self.max_qubits)
        return self.qureg

    def __exit__(self, *exc):
        buf = self.qureg._fusion_buffer
        if buf is not None:
            buf.flush()
        self.qureg._fusion_buffer = self._prev
        return False


# ---------------------------------------------------------------------------
# environment (QuEST.h:785-832)
# ---------------------------------------------------------------------------

def createQuESTEnv(num_devices: Optional[int] = None,
                   precision: Optional[Precision] = None,
                   seed: Optional[Sequence[int]] = None,
                   compensated: Optional[bool] = None,
                   device=None, devices=None) -> QuESTEnv:
    """``num_devices`` of None or 1 is one device: ``device=None`` selects
    ``cuda:0`` and raises where CUDA is absent; ``device="cpu"`` runs on
    the host (the CPU tests). ``num_devices=n > 1`` makes a mesh of ``n``
    amplitude shards driven by this process: the first ``n`` CUDA devices
    (``ValueError`` when fewer exist or ``n`` is not a power of 2), or
    ``n`` host shards with ``device="cpu"``; ``devices=`` names the shards,
    repeats allowed (``["cuda:0"] * 4``: four shards on one card)."""
    return create_quest_env(num_devices=num_devices, precision=precision,
                            seed=seed, compensated=compensated,
                            device=device, devices=devices)


def createSimulationService(env: QuESTEnv, **kwargs):
    """Create the asynchronous serving runtime over ``env``
    (:class:`quest_tpu_torch.serve.SimulationService`; no QuEST
    counterpart): callers ``submit`` requests and get futures, and the
    service coalesces compatible requests into one batched dispatch. The
    keyword arguments are the service's knobs: ``max_queue``,
    ``max_batch``, ``max_wait_s``, ``request_timeout_s``, ``max_retries``,
    ``resilience`` (a :class:`quest_tpu_torch.resilience.ResiliencePolicy`:
    retry backoff, circuit breaker, batch quarantine, watchdog),
    ``trace_sample_rate`` (:mod:`quest_tpu_torch.telemetry`), ``tenants``
    and ``pipeline_depth``. Close it with ``service.close()`` (or use it
    as a context manager)."""
    from .serve import SimulationService
    return SimulationService(env, **kwargs)


def createServiceRouter(envs=None, **kwargs):
    """Create the replicated serving front end: N
    :class:`quest_tpu_torch.serve.SimulationService` replicas behind one
    ``submit()`` with health-aware routing, replica failover with
    supervised restart, and the persistent warm-start cache
    (:class:`quest_tpu_torch.serve.router.ServiceRouter`; no QuEST
    counterpart). Pass ``envs`` (one ``QuESTEnv`` per replica, e.g. from
    :func:`quest_tpu_torch.serve.replica_envs`: on one card every replica
    shares the device) or ``num_replicas=``; the other keyword arguments
    are the per-replica service knobs plus ``supervisor`` (a
    :class:`quest_tpu_torch.resilience.SupervisorPolicy`),
    ``max_failovers``, ``hedge_after_s`` and ``warm_cache``. Close it with
    ``router.close()`` (or use it as a context manager)."""
    from .serve import ServiceRouter
    return ServiceRouter(envs, **kwargs)


def createVariationalProblem(circuit, observables, x0, **kwargs):
    """Name a variational workload for the optimizer-in-the-loop serving
    API (:class:`quest_tpu_torch.serve.optimize.VariationalProblem`; no
    QuEST counterpart): ``circuit`` (a recorded
    :class:`~quest_tpu_torch.circuits.Circuit` with Param angles), the
    ``(pauli_terms, coeffs)`` objective, and the starting point ``x0``
    (name->angle dict or ordered vector). Keyword arguments:
    ``trajectories``/``sampling_budget`` (noisy objectives through the
    trajectory gradient) and ``tier``. Run it with
    ``service.optimize(problem, ...)`` or ``router.optimize(...)``: each
    iterate is one coalesced gradient dispatch, and the returned handle
    streams iterates."""
    from .serve import VariationalProblem
    return VariationalProblem(circuit, observables, x0, **kwargs)


def destroyQuESTEnv(env: QuESTEnv) -> None:
    destroy_quest_env(env)


def syncQuESTEnv(env: QuESTEnv) -> None:
    env.sync()


def syncQuESTSuccess(success_code: int) -> int:
    """Logical-AND agreement across ranks (``QuEST_cpu_distributed.c:163``);
    one process agrees with itself."""
    return int(bool(success_code))


def reportQuESTEnv(env: QuESTEnv) -> None:
    print(env.report())


def getEnvironmentString(env: QuESTEnv) -> str:
    """Backend capability summary (``getEnvironmentString`` ``QuEST.h:832``)
    in the reference's field order, reporting what carries the
    computation: ``CUDA=1`` and the card's name for an env on the card,
    ``CUDA=0`` on the CPU."""
    if env.device.type == "cuda":
        backend = f"cuda ({torch.cuda.get_device_name(env.device)})"
    else:
        backend = env.device.type
    mode = "mesh" if env.mesh is not None else "local"
    return (f"CUDA={int(env.device.type == 'cuda')} OpenMP=0 MPI=0 TPU=0 "
            f"backend={backend} mode={mode} threads=1 "
            f"ranks={env.num_ranks}")


def seedQuEST(env: QuESTEnv, seeds: Sequence[int]) -> None:
    env.seed(seeds)


def seedQuESTDefault(env: QuESTEnv) -> None:
    env.seed_default()


# ---------------------------------------------------------------------------
# register management (QuEST.h:224-292)
# ---------------------------------------------------------------------------

def createQureg(num_qubits: int, env: QuESTEnv) -> Qureg:
    val.validate_num_qubits(num_qubits, "createQureg")
    q = Qureg(num_qubits, env)
    initZeroState(q)
    return q


def createDensityQureg(num_qubits: int, env: QuESTEnv) -> Qureg:
    val.validate_num_qubits(num_qubits, "createDensityQureg")
    q = Qureg(num_qubits, env, is_density=True)
    initZeroState(q)
    return q


def createCloneQureg(qureg: Qureg, env: QuESTEnv) -> Qureg:
    new = Qureg(qureg.num_qubits_represented, env,
                is_density=qureg.is_density_matrix)
    if qureg.is_sharded:
        qureg.ensure_canonical()
        new.chunks = [c.clone() for c in qureg.chunks]
        return new
    new.state = qureg.state.clone()
    return new


def destroyQureg(qureg: Qureg, env: QuESTEnv = None) -> None:
    qureg.state = None


def createComplexMatrixN(num_qubits: int) -> np.ndarray:
    val.validate_num_qubits(num_qubits, "createComplexMatrixN")
    d = 1 << num_qubits
    return np.zeros((d, d), dtype=np.complex128)


def destroyComplexMatrixN(m: np.ndarray) -> None:
    pass  # numpy arrays are GC-managed; kept for API parity


def initComplexMatrixN(m: np.ndarray, re, im) -> None:
    m[...] = np.asarray(re, dtype=np.float64) \
        + 1j * np.asarray(im, dtype=np.float64)


def copyStateToGPU(qureg: Qureg) -> None:
    """The amplitudes already live on the env's device (``copyStateToGPU``
    ``QuEST.h:855`` exists because the reference mirrors host and device
    copies): apply any buffered gates and wait for the device."""
    if qureg.is_sharded:
        qureg.flush_gates()
        qureg.env.sync()
        return
    state = qureg.state
    if state.device.type == "cuda":
        torch.cuda.synchronize(state.device)


def copyStateFromGPU(qureg: Qureg) -> None:
    copyStateToGPU(qureg)


# ---------------------------------------------------------------------------
# state initialisation (QuEST.h:383-506)
# ---------------------------------------------------------------------------

_CHUNK_INITS = {ist.blank: "blank", ist.classical: "classical",
                ist.plus: "plus", ist.debug: "debug",
                ist.single_qubit_outcome: "single"}


def _init(qureg: Qureg, fn, *args) -> None:
    if qureg.is_sharded:
        chk.init_chunks(qureg, _CHUNK_INITS[fn], *args)
        return
    qureg.state = fn(qureg.num_amps_total, qureg.real_dtype, qureg.device,
                     *args, quad=qureg.is_quad)


def initBlankState(qureg: Qureg) -> None:
    _init(qureg, ist.blank)
    qureg.qasm_log.record_comment(
        "the register was set to the unphysical all-zero-amplitudes state")


def initZeroState(qureg: Qureg) -> None:
    _init(qureg, ist.classical, 0)
    qureg.qasm_log.record_init_zero()


def initPlusState(qureg: Qureg) -> None:
    n = qureg.num_qubits_represented
    amp = (1.0 / (1 << n)) if qureg.is_density_matrix \
        else (1.0 / np.sqrt(1 << n))
    _init(qureg, ist.plus, amp)
    qureg.qasm_log.record_init_plus()


def initClassicalState(qureg: Qureg, state_ind: int) -> None:
    val.validate_state_index(qureg.num_qubits_represented, state_ind,
                             "initClassicalState")
    idx = int(state_ind) * ((1 << qureg.num_qubits_represented) + 1) \
        if qureg.is_density_matrix else int(state_ind)
    _init(qureg, ist.classical, idx)
    qureg.qasm_log.record_init_classical(state_ind)


def initPureState(qureg: Qureg, pure: Qureg) -> None:
    val.validate_second_qureg_state_vec(pure.is_density_matrix,
                                        "initPureState")
    val.validate_matching_precision(qureg.env.precision.quest_prec,
                                    pure.env.precision.quest_prec,
                                    "initPureState")
    val.validate_matching_dims(qureg.num_qubits_represented,
                               pure.num_qubits_represented, "initPureState")
    if qureg.is_sharded:
        if qureg.is_density_matrix:
            chk.init_pure_density(qureg, pure)
        else:
            pure.ensure_canonical()
            qureg.chunks = [c.clone() for c in pure.chunks]
    elif qureg.is_quad and qureg.is_density_matrix:
        # |psi><psi| as a dd outer product: the lo planes survive, so
        # QUAD64 keeps its ~106-bit envelope
        qureg.state = ddm.dd_outer(pure.state.to(qureg.device),
                                   conj_left=False)
    elif qureg.is_density_matrix:
        qureg.state = dm.init_pure_state(pure.state.to(qureg.device))
    else:
        qureg.state = pure.state.to(qureg.device, copy=True)
    qureg.qasm_log.record_comment(
        "the register was initialised to an undisclosed pure state")


def initDebugState(qureg: Qureg) -> None:
    _init(qureg, ist.debug)


def initStateFromAmps(qureg: Qureg, reals, imags) -> None:
    val.validate_state_vec(qureg.is_density_matrix, "initStateFromAmps")
    arr = np.asarray(reals, dtype=np.float64) \
        + 1j * np.asarray(imags, np.float64)
    val.validate_num_amps(qureg.num_amps_total, 0, arr.size,
                          "initStateFromAmps")
    if arr.size != qureg.num_amps_total:
        val._fail("the amplitude arrays must cover the full register",
                  "initStateFromAmps", val.ErrorCode.E_INVALID_NUM_AMPS)
    qureg.device_put(arr)
    qureg.qasm_log.record_comment(
        "the register was initialised to an undisclosed pure state")


def setAmps(qureg: Qureg, start_ind: int, reals, imags,
            num_amps: int) -> None:
    val.validate_state_vec(qureg.is_density_matrix, "setAmps")
    val.validate_num_amps(qureg.num_amps_total, start_ind, num_amps,
                          "setAmps")
    re64 = np.asarray(reals, np.float64)[:num_amps]
    im64 = np.asarray(imags, np.float64)[:num_amps]
    vals = ddm._dd_split_host(re64 + 1j * im64, ddm._np_dtype(
        qureg.real_dtype)) if qureg.is_quad else np.stack([re64, im64])
    if qureg.is_sharded:
        qureg.ensure_canonical()
        chk.set_amps(qureg, int(start_ind), vals)
        qureg.qasm_log.record_comment("amplitudes were manually edited")
        return
    qureg.state[:, start_ind:start_ind + num_amps] = torch.as_tensor(
        vals, dtype=qureg.real_dtype, device=qureg.device)
    qureg.qasm_log.record_comment("amplitudes were manually edited")


def setDensityAmps(qureg: Qureg, reals, imags) -> None:
    """Overwrite every element of a density register from the flat
    ``flat[r + c*2^n]`` arrays (the JAX package's form, one call for the
    whole matrix)."""
    arr = np.asarray(reals, np.float64).reshape(-1) \
        + 1j * np.asarray(imags, np.float64).reshape(-1)
    if arr.size != qureg.num_amps_total:
        val._fail("the amplitude arrays must cover the full density matrix",
                  "setDensityAmps", val.ErrorCode.E_INVALID_NUM_AMPS)
    qureg.device_put(arr)
    qureg.qasm_log.record_comment(
        "density-matrix amplitudes were manually edited")


def cloneQureg(target: Qureg, copy: Qureg) -> None:
    val.validate_matching_types(target.is_density_matrix,
                                copy.is_density_matrix, "cloneQureg")
    val.validate_matching_precision(target.env.precision.quest_prec,
                                    copy.env.precision.quest_prec,
                                    "cloneQureg")
    val.validate_matching_dims(target.num_qubits_represented,
                               copy.num_qubits_represented, "cloneQureg")
    if copy.is_sharded:
        copy.ensure_canonical()
        target.chunks = [c.clone() for c in copy.chunks]
        return
    target.state = copy.state.to(target.device, copy=True)


def setWeightedQureg(fac1, qureg1: Qureg, fac2, qureg2: Qureg,
                     fac_out, out: Qureg) -> None:
    """out = fac1 qureg1 + fac2 qureg2 + fac_out out, written into
    ``out``'s planes (which may be ``qureg1``'s or ``qureg2``'s)
    (``setWeightedQureg`` ``QuEST.h:3047``)."""
    val.validate_matching_types(qureg1.is_density_matrix,
                                qureg2.is_density_matrix, "setWeightedQureg")
    val.validate_matching_precision(qureg1.env.precision.quest_prec,
                                    qureg2.env.precision.quest_prec,
                                    "setWeightedQureg")
    val.validate_matching_precision(qureg1.env.precision.quest_prec,
                                    out.env.precision.quest_prec,
                                    "setWeightedQureg")
    val.validate_matching_types(qureg1.is_density_matrix,
                                out.is_density_matrix, "setWeightedQureg")
    val.validate_matching_dims(qureg1.num_qubits_represented,
                               qureg2.num_qubits_represented,
                               "setWeightedQureg")
    val.validate_matching_dims(qureg1.num_qubits_represented,
                               out.num_qubits_represented, "setWeightedQureg")
    if out.is_sharded:
        _canon(qureg1, qureg2, out)
        chk.weighted(fac1, qureg1, fac2, qureg2, fac_out, out)
        out.qasm_log.record_comment(
            "the register was set to a weighted combination (possibly "
            "unphysical)")
        return
    target = out.state
    if out.is_quad:
        out.state = ddm.dd_weighted(fac1, qureg1.state.to(target.device),
                                    fac2, qureg2.state.to(target.device),
                                    fac_out, target)
    else:
        sv.set_weighted(fac1, qureg1.state.to(target.device), fac2,
                        qureg2.state.to(target.device), fac_out, target)
    out.qasm_log.record_comment(
        "the register was set to a weighted combination (possibly "
        "unphysical)")


def initStateOfSingleQubit(qureg: Qureg, qubit: int, outcome: int) -> None:
    val.validate_state_vec(qureg.is_density_matrix, "initStateOfSingleQubit")
    val.validate_target(qureg.num_qubits_represented, qubit,
                        "initStateOfSingleQubit")
    val.validate_outcome(outcome, "initStateOfSingleQubit")
    _init(qureg, ist.single_qubit_outcome, int(qubit), int(outcome))


# ---------------------------------------------------------------------------
# single-qubit gates (QuEST.h:540-1583)
# ---------------------------------------------------------------------------

def hadamard(qureg: Qureg, target: int) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "hadamard")
    _apply_gate(qureg, mats.hadamard(), (target,))
    qureg.qasm_log.record_gate("hadamard", target)


def pauliX(qureg: Qureg, target: int) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "pauliX")
    _apply_gate(qureg, mats.pauli_x(), (target,))
    qureg.qasm_log.record_gate("sigma_x", target)


def pauliY(qureg: Qureg, target: int) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "pauliY")
    _apply_gate(qureg, mats.pauli_y(), (target,))
    qureg.qasm_log.record_gate("sigma_y", target)


def pauliZ(qureg: Qureg, target: int) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "pauliZ")
    _apply_diag_gate(qureg, np.array([1.0, -1.0]), (target,))
    qureg.qasm_log.record_gate("sigma_z", target)


def sGate(qureg: Qureg, target: int) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "sGate")
    _apply_diag_gate(qureg, np.array([1.0, 1j]), (target,))
    qureg.qasm_log.record_gate("s", target)


def tGate(qureg: Qureg, target: int) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "tGate")
    _apply_diag_gate(qureg, np.array([1.0, np.exp(1j * np.pi / 4)]),
                     (target,))
    qureg.qasm_log.record_gate("t", target)


def phaseShift(qureg: Qureg, target: int, angle: float) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "phaseShift")
    _apply_diag_gate(qureg, np.array([1.0, np.exp(1j * angle)]), (target,))
    qureg.qasm_log.record_param_gate("phase_shift", target, angle)


def compactUnitary(qureg: Qureg, target: int, alpha, beta) -> None:
    val.validate_target(qureg.num_qubits_represented, target,
                        "compactUnitary")
    val.validate_unitary_complex_pair(alpha, beta, "compactUnitary",
                                      qureg.env.precision.eps)
    _apply_gate(qureg, mats.compact_unitary(alpha, beta), (target,))
    qureg.qasm_log.record_compact_unitary(alpha, beta, target)


def unitary(qureg: Qureg, target: int, u) -> None:
    val.validate_target(qureg.num_qubits_represented, target, "unitary")
    u = mats.matrix2(u)
    val.validate_unitary(u, "unitary", qureg.env.precision.eps)
    _apply_gate(qureg, u, (target,))
    qureg.qasm_log.record_unitary(u, target)


def rotateX(qureg: Qureg, target: int, angle: float) -> None:
    rotateAroundAxis(qureg, target, angle, (1.0, 0.0, 0.0),
                     _label="rotate_x", _angle=angle)


def rotateY(qureg: Qureg, target: int, angle: float) -> None:
    rotateAroundAxis(qureg, target, angle, (0.0, 1.0, 0.0),
                     _label="rotate_y", _angle=angle)


def rotateZ(qureg: Qureg, target: int, angle: float) -> None:
    rotateAroundAxis(qureg, target, angle, (0.0, 0.0, 1.0),
                     _label="rotate_z", _angle=angle)


def rotateAroundAxis(qureg: Qureg, target: int, angle: float, axis,
                     _label: Optional[str] = None,
                     _angle: Optional[float] = None) -> None:
    val.validate_target(qureg.num_qubits_represented, target,
                        "rotateAroundAxis")
    val.validate_vector(axis, "rotateAroundAxis", qureg.env.precision.eps)
    _apply_gate(qureg, mats.rotation(angle, axis), (target,))
    if _label is not None:
        qureg.qasm_log.record_param_gate(_label, target, _angle)
    else:
        qureg.qasm_log.record_axis_rotation(angle, axis, target)


# ---------------------------------------------------------------------------
# controlled gates (QuEST.h:583-1669)
# ---------------------------------------------------------------------------

def controlledNot(qureg: Qureg, control: int, target: int) -> None:
    val.validate_control_target(qureg.num_qubits_represented, control,
                                target, "controlledNot")
    _apply_gate(qureg, mats.pauli_x(), (target,), (control,))
    qureg.qasm_log.record_gate("sigma_x", target, (control,))


def controlledPauliY(qureg: Qureg, control: int, target: int) -> None:
    val.validate_control_target(qureg.num_qubits_represented, control,
                                target, "controlledPauliY")
    _apply_gate(qureg, mats.pauli_y(), (target,), (control,))
    qureg.qasm_log.record_gate("sigma_y", target, (control,))


def controlledPhaseShift(qureg: Qureg, q1: int, q2: int,
                         angle: float) -> None:
    val.validate_control_target(qureg.num_qubits_represented, q1, q2,
                                "controlledPhaseShift")
    tensor = np.ones((2, 2), dtype=np.complex128)
    tensor[1, 1] = np.exp(1j * angle)
    _apply_diag_gate(qureg, tensor, (q1, q2))
    qureg.qasm_log.record_param_gate("phase_shift", q2, angle, (q1,))


def multiControlledPhaseShift(qureg: Qureg, qubits: Sequence[int],
                              angle: float) -> None:
    val.validate_multi_qubits(qureg.num_qubits_represented, qubits,
                              "multiControlledPhaseShift")
    k = len(qubits)
    tensor = np.ones((2,) * k, dtype=np.complex128)
    tensor[(1,) * k] = np.exp(1j * angle)
    _apply_diag_gate(qureg, tensor, qubits)
    qureg.qasm_log.record_param_gate("phase_shift", qubits[-1], angle,
                                     tuple(qubits[:-1]),
                                     kind="multicontrolled")


def controlledPhaseFlip(qureg: Qureg, q1: int, q2: int) -> None:
    val.validate_control_target(qureg.num_qubits_represented, q1, q2,
                                "controlledPhaseFlip")
    tensor = np.ones((2, 2), dtype=np.complex128)
    tensor[1, 1] = -1.0
    _apply_diag_gate(qureg, tensor, (q1, q2))
    qureg.qasm_log.record_gate("sigma_z", q2, (q1,))


def multiControlledPhaseFlip(qureg: Qureg, qubits: Sequence[int]) -> None:
    val.validate_multi_qubits(qureg.num_qubits_represented, qubits,
                              "multiControlledPhaseFlip")
    k = len(qubits)
    tensor = np.ones((2,) * k, dtype=np.complex128)
    tensor[(1,) * k] = -1.0
    _apply_diag_gate(qureg, tensor, qubits)
    qureg.qasm_log.record_gate("sigma_z", qubits[-1], tuple(qubits[:-1]))


def controlledRotateX(qureg, control, target, angle):
    controlledRotateAroundAxis(qureg, control, target, angle, (1, 0, 0),
                               _label="rotate_x", _angle=angle)


def controlledRotateY(qureg, control, target, angle):
    controlledRotateAroundAxis(qureg, control, target, angle, (0, 1, 0),
                               _label="rotate_y", _angle=angle)


def controlledRotateZ(qureg, control, target, angle):
    controlledRotateAroundAxis(qureg, control, target, angle, (0, 0, 1),
                               _label="rotate_z", _angle=angle)


def controlledRotateAroundAxis(qureg: Qureg, control: int, target: int,
                               angle: float, axis,
                               _label: Optional[str] = None,
                               _angle: Optional[float] = None) -> None:
    val.validate_control_target(qureg.num_qubits_represented, control,
                                target, "controlledRotateAroundAxis")
    val.validate_vector(axis, "controlledRotateAroundAxis",
                        qureg.env.precision.eps)
    _apply_gate(qureg, mats.rotation(angle, axis), (target,), (control,))
    if _label is not None:
        qureg.qasm_log.record_param_gate(_label, target, _angle, (control,))
    else:
        qureg.qasm_log.record_axis_rotation(angle, axis, target, (control,))


def controlledCompactUnitary(qureg: Qureg, control: int, target: int,
                             alpha, beta) -> None:
    val.validate_control_target(qureg.num_qubits_represented, control,
                                target, "controlledCompactUnitary")
    val.validate_unitary_complex_pair(alpha, beta, "controlledCompactUnitary",
                                      qureg.env.precision.eps)
    _apply_gate(qureg, mats.compact_unitary(alpha, beta), (target,),
                (control,))
    qureg.qasm_log.record_compact_unitary(alpha, beta, target, (control,))


def controlledUnitary(qureg: Qureg, control: int, target: int, u) -> None:
    val.validate_control_target(qureg.num_qubits_represented, control,
                                target, "controlledUnitary")
    u = mats.matrix2(u)
    val.validate_unitary(u, "controlledUnitary", qureg.env.precision.eps)
    _apply_gate(qureg, u, (target,), (control,))
    qureg.qasm_log.record_unitary(u, target, (control,))


def multiControlledUnitary(qureg: Qureg, controls: Sequence[int],
                           target: int, u) -> None:
    val.validate_multi_controls_target(
        qureg.num_qubits_represented, controls, target,
        "multiControlledUnitary")
    u = mats.matrix2(u)
    val.validate_unitary(u, "multiControlledUnitary",
                         qureg.env.precision.eps)
    _apply_gate(qureg, u, (target,), tuple(controls))
    qureg.qasm_log.record_unitary(u, target, tuple(controls),
                                  kind="multicontrolled")


def multiStateControlledUnitary(qureg: Qureg, controls: Sequence[int],
                                control_state: Sequence[int],
                                target: int, u) -> None:
    val.validate_multi_controls_target(
        qureg.num_qubits_represented, controls, target,
        "multiStateControlledUnitary")
    val.validate_control_state(control_state, len(controls),
                               "multiStateControlledUnitary")
    u = mats.matrix2(u)
    val.validate_unitary(u, "multiStateControlledUnitary",
                         qureg.env.precision.eps)
    flips = tuple(c for c, s in zip(controls, control_state) if s == 0)
    _apply_gate(qureg, u, (target,), tuple(controls), flips)
    qureg.qasm_log.record_multi_state_controlled_unitary(
        u, tuple(controls), tuple(control_state), target)


# ---------------------------------------------------------------------------
# two-/multi-qubit gates (QuEST.h:2232-3043)
# ---------------------------------------------------------------------------

def swapGate(qureg: Qureg, q1: int, q2: int) -> None:
    val.validate_unique_targets(qureg.num_qubits_represented, q1, q2,
                                "swapGate")
    buf = qureg._fusion_buffer
    if qureg.is_quad or (buf is not None and not buf.flushing):
        # fusion active: the swap keeps program order with the buffered
        # gates by riding the buffer as a dense 2-qubit member. A QUAD
        # register applies the permutation matrix densely in dd: its
        # entries are exact 0/1, so it stays error-free
        _apply_gate(qureg, mats.swap(), (int(q1), int(q2)))
        qureg.qasm_log.record_gate("swap", q2, (q1,))
        return
    if _pg.use_lazy(qureg):
        # on a mesh a SWAP is layout metadata: no amplitude moves (the
        # reference exchanges chunks, ``statevec_swapQubitAmps``
        # ``QuEST_cpu_distributed.c:1355-1371``)
        _pg.metadata_swap(qureg, int(q1), int(q2))
        if qureg.is_density_matrix:
            n = qureg.num_qubits_represented
            _pg.metadata_swap(qureg, int(q1) + n, int(q2) + n)
        qureg.qasm_log.record_gate("swap", q2, (q1,))
        return
    sv.swap_amps(qureg.state, qureg.num_qubits_in_state_vec, q1, q2)
    if qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        sv.swap_amps(qureg.state, 2 * n, q1 + n, q2 + n)
    qureg.qasm_log.record_gate("swap", q2, (q1,))


def sqrtSwapGate(qureg: Qureg, q1: int, q2: int) -> None:
    val.validate_unique_targets(qureg.num_qubits_represented, q1, q2,
                                "sqrtSwapGate")
    _apply_gate(qureg, mats.sqrt_swap(), (q1, q2))
    qureg.qasm_log.record_gate("sqrt_swap", q2, (q1,))


def multiRotateZ(qureg: Qureg, qubits: Sequence[int], angle: float) -> None:
    val.validate_multi_targets(qureg.num_qubits_represented, qubits,
                               "multiRotateZ")
    k = len(qubits)
    _apply_diag_gate(qureg, sv.multi_rotate_z_diag(k, angle), qubits)
    qureg.qasm_log.record_comment(
        f"a {k}-qubit multiRotateZ of angle {angle:g} was applied")


def multiRotatePauli(qureg: Qureg, targets: Sequence[int],
                     paulis: Sequence[int], angle: float) -> None:
    """exp(-i angle/2 P1 (x) P2 ...) by a basis rotation to Z, then
    multiRotateZ, then the rotation back (``statevec_multiRotatePauli``
    ``QuEST_common.c:410-447``). Built from density-aware primitives, so
    a density register's column side is handled gate by gate."""
    val.validate_multi_targets(qureg.num_qubits_represented, targets,
                               "multiRotatePauli")
    val.validate_pauli_codes(paulis, "multiRotatePauli")
    fac = 1.0 / np.sqrt(2.0)
    u_rx = mats.compact_unitary(fac, -1j * fac)    # rotates Z -> Y
    u_ry = mats.compact_unitary(fac, -fac)         # rotates Z -> X
    basis = {PauliOpType.PAULI_X: u_ry, PauliOpType.PAULI_Y: u_rx}
    z_targets = []
    for t, p in zip(targets, paulis):
        p = int(p)
        if p in basis:
            _apply_gate(qureg, basis[p], (t,))
        if p != PauliOpType.PAULI_I:
            z_targets.append(t)
    if z_targets:
        _apply_diag_gate(qureg, sv.multi_rotate_z_diag(len(z_targets), angle),
                         z_targets)
    for t, p in zip(targets, paulis):
        if int(p) in basis:
            _apply_gate(qureg, basis[int(p)].conj().T, (t,))
    qureg.qasm_log.record_comment(
        f"a {len(targets)}-qubit multiRotatePauli of angle {angle:g} was "
        "applied")


def twoQubitUnitary(qureg: Qureg, t1: int, t2: int, u) -> None:
    val.validate_multi_targets(qureg.num_qubits_represented, (t1, t2),
                               "twoQubitUnitary")
    u = mats.matrix4(u)
    val.validate_unitary(u, "twoQubitUnitary", qureg.env.precision.eps)
    _apply_gate(qureg, u, (t1, t2))
    qureg.qasm_log.record_comment(
        "an undisclosed 2-qubit unitary was applied")


def controlledTwoQubitUnitary(qureg: Qureg, control: int, t1: int, t2: int,
                              u) -> None:
    val.validate_multi_controls_multi_targets(
        qureg.num_qubits_represented, (control,), (t1, t2),
        "controlledTwoQubitUnitary")
    u = mats.matrix4(u)
    val.validate_unitary(u, "controlledTwoQubitUnitary",
                         qureg.env.precision.eps)
    _apply_gate(qureg, u, (t1, t2), (control,))
    qureg.qasm_log.record_comment(
        "an undisclosed controlled 2-qubit unitary was applied")


def multiControlledTwoQubitUnitary(qureg: Qureg, controls: Sequence[int],
                                   t1: int, t2: int, u) -> None:
    val.validate_multi_controls_multi_targets(
        qureg.num_qubits_represented, controls, (t1, t2),
        "multiControlledTwoQubitUnitary")
    u = mats.matrix4(u)
    val.validate_unitary(u, "multiControlledTwoQubitUnitary",
                         qureg.env.precision.eps)
    _apply_gate(qureg, u, (t1, t2), tuple(controls))
    qureg.qasm_log.record_comment(
        "an undisclosed multi-controlled 2-qubit unitary was applied")


def multiQubitUnitary(qureg: Qureg, targets: Sequence[int], u) -> None:
    val.validate_multi_targets(qureg.num_qubits_represented, targets,
                               "multiQubitUnitary")
    u = np.asarray(u, dtype=np.complex128)
    val.validate_matrix_dim(u, len(targets), "multiQubitUnitary")
    val.validate_unitary(u, "multiQubitUnitary", qureg.env.precision.eps)
    _apply_gate(qureg, u, tuple(targets))
    qureg.qasm_log.record_comment(
        "an undisclosed multi-qubit unitary was applied")


def controlledMultiQubitUnitary(qureg: Qureg, control: int,
                                targets: Sequence[int], u) -> None:
    multiControlledMultiQubitUnitary(qureg, (control,), targets, u)


def multiControlledMultiQubitUnitary(qureg: Qureg, controls: Sequence[int],
                                     targets: Sequence[int], u) -> None:
    val.validate_multi_controls_multi_targets(
        qureg.num_qubits_represented, controls, targets,
        "multiControlledMultiQubitUnitary")
    u = np.asarray(u, dtype=np.complex128)
    val.validate_matrix_dim(u, len(targets),
                            "multiControlledMultiQubitUnitary")
    val.validate_unitary(u, "multiControlledMultiQubitUnitary",
                         qureg.env.precision.eps)
    _apply_gate(qureg, u, tuple(targets), tuple(controls))
    qureg.qasm_log.record_comment(
        "an undisclosed multi-controlled multi-qubit unitary was applied")


# ---------------------------------------------------------------------------
# measurement & collapse (QuEST.h:1694-1753)
# ---------------------------------------------------------------------------

def calcProbOfOutcome(qureg: Qureg, qubit: int, outcome: int) -> float:
    val.validate_target(qureg.num_qubits_represented, qubit,
                        "calcProbOfOutcome")
    val.validate_outcome(outcome, "calcProbOfOutcome")
    n = qureg.num_qubits_in_state_vec
    if qureg.is_sharded:
        qureg.flush_gates()
        if qureg.is_density_matrix:
            qureg.ensure_canonical()
            return chk.density_prob_of_outcome(qureg, int(qubit),
                                               int(outcome))
        return chk.prob_of_outcome(qureg,
                                   _pg.phys_targets(qureg, (qubit,))[0],
                                   int(outcome))
    if qureg.is_quad:
        if qureg.is_density_matrix:
            p0 = ddm.dd_prob_zero_dm(qureg.state,
                                     qureg.num_qubits_represented, qubit)
        else:
            p0 = ddm.dd_prob_zero_sv(qureg.state, n, qubit)
        return p0 if outcome == 0 else 1.0 - p0
    if qureg.is_density_matrix:
        nr = qureg.num_qubits_represented
        if qureg.env.compensated:
            pre, _, post = split_shape(nr, (qubit,))
            diag = dm.diagonal(qureg.state, nr).reshape(pre, 2, post)
            p0 = _pair(red.sum_pair(diag[:, 0, :]))
            return p0 if outcome == 0 else 1.0 - p0
        return float(dm.calc_prob_of_outcome(qureg.state, nr, qubit,
                                             outcome))
    if qureg.env.compensated:
        # outcome-1 probability is 1 - P0, as the reference derives it
        # (``statevec_calcProbOfOutcome`` QuEST_cpu_local.c:279-285)
        sub = sv.zero_half(qureg.state, n, qubit)
        p0 = _pair(red.dot_pair(sub, sub))
        return p0 if outcome == 0 else 1.0 - p0
    return float(sv.calc_prob_of_outcome(qureg.state, n, qubit, outcome))


def _collapse(qureg: Qureg, qubit: int, outcome: int, prob: float) -> None:
    if qureg.is_sharded:
        # the projector is diagonal: any position, no communication
        if qureg.is_density_matrix:
            n = qureg.num_qubits_represented
            fac = np.zeros((2, 2))
            fac[outcome, outcome] = 1.0 / prob
            _pg.sharded_diag(qureg, fac, (int(qubit) + n, int(qubit)))
        else:
            fac = np.zeros(2)
            fac[outcome] = 1.0 / math.sqrt(prob)
            _pg.sharded_diag(qureg, fac, (int(qubit),))
        return
    if qureg.is_quad:
        qureg.state = ddm.dd_collapse(
            qureg.state, qureg.num_qubits_in_state_vec, qubit, outcome,
            float(prob), density=qureg.is_density_matrix)
        return
    if qureg.is_density_matrix:
        dm.collapse_to_known_prob_outcome(qureg.state,
                                          qureg.num_qubits_represented,
                                          qubit, outcome, prob)
        return
    sv.collapse_to_known_prob_outcome(qureg.state,
                                      qureg.num_qubits_in_state_vec,
                                      qubit, outcome, prob)


def collapseToOutcome(qureg: Qureg, qubit: int, outcome: int) -> float:
    val.validate_target(qureg.num_qubits_represented, qubit,
                        "collapseToOutcome")
    val.validate_outcome(outcome, "collapseToOutcome")
    prob = calcProbOfOutcome(qureg, qubit, outcome)
    val.validate_measurement_prob(prob, qureg.env.precision.eps,
                                  "collapseToOutcome")
    _collapse(qureg, qubit, outcome, prob)
    qureg.qasm_log.record_measurement(qubit)
    return prob


def measureWithStats(qureg: Qureg, qubit: int):
    """Returns (outcome, outcome_prob). The draw comes from the env's
    torch.Generator (replacing mt19937, ``generateMeasurementOutcome``
    ``QuEST_common.c:154-169``)."""
    val.validate_target(qureg.num_qubits_represented, qubit,
                        "measureWithStats")
    zero_prob = calcProbOfOutcome(qureg, qubit, 0)
    eps = qureg.env.precision.eps
    if zero_prob < eps:
        outcome = 1
    elif 1.0 - zero_prob < eps:
        outcome = 0
    else:
        outcome = int(qureg.env.uniform() > zero_prob)
    prob = zero_prob if outcome == 0 else 1.0 - zero_prob
    _collapse(qureg, qubit, outcome, prob)
    qureg.qasm_log.record_measurement(qubit)
    return outcome, prob


def measure(qureg: Qureg, qubit: int) -> int:
    outcome, _ = measureWithStats(qureg, qubit)
    return outcome


def sampleOutcomes(qureg: Qureg, num_samples: int,
                   qubits=None) -> np.ndarray:
    """Draw ``num_samples`` computational-basis outcomes from the state's
    probability distribution WITHOUT collapsing it: M measurement shots in
    one pass (one cumulative sum, one search for every draw,
    :func:`quest_tpu_torch.parallel.sampling.sample_outcomes`). No
    reference counterpart: the reference can only measure and collapse.

    State vectors sample ``|amp|^2``; density registers their clipped real
    diagonal (the outcome distribution of a full measurement), read
    through a strided view of the flat vector. Returns an int64 array of
    basis indices, or, when ``qubits`` is given, the outcomes of those
    qubits packed little-endian (bit ``j`` = ``qubits[j]``). The register
    is untouched; the uniforms come from the env's generator."""
    if int(num_samples) < 1:
        val._fail("num_samples must be >= 1", "sampleOutcomes",
                  val.ErrorCode.E_INVALID_NUM_AMPS)
    n = qureg.num_qubits_represented
    if qubits is not None:
        qubits = [int(q) for q in qubits]
        val.validate_multi_targets(n, qubits, "sampleOutcomes")
    if qureg.is_sharded and (1 << n) >= qureg.env.num_devices:
        # shard-local two-stage inverse CDF (needs >= 1 outcome per
        # shard; a density register thinner than that is not routed)
        qureg.ensure_canonical()
        uniforms = torch.rand(int(num_samples),
                              generator=qureg.env.generator,
                              dtype=torch.float64)
        idx, total = sample_sharded(
            qureg.chunks, uniforms, qureg.is_density_matrix, n,
            qureg.num_qubits_in_state_vec - _pg._shard_bits(qureg))
        if total < qureg.env.precision.eps:
            val._fail("cannot sample a zero-probability register",
                      "sampleOutcomes",
                      val.ErrorCode.E_COLLAPSE_STATE_ZERO_PROB)
        return _packed_outcomes(idx, qubits)
    planes = qureg.state
    if qureg.is_quad:
        # the sampling tolerance does not need the lo bits: hi + lo
        # rounded to the plane dtype
        planes = torch.stack([planes[0] + planes[1], planes[2] + planes[3]])
    if qureg.is_density_matrix:
        dim = 1 << n
        probs = planes[0].view(dim, dim).diagonal().clamp(min=0.0)
    else:
        probs = planes[0] * planes[0] + planes[1] * planes[1]
    uniforms = torch.rand(int(num_samples), generator=qureg.env.generator,
                          dtype=torch.float64)
    idx_dev, total = sample_outcomes(probs, uniforms)
    del probs
    if float(total) < qureg.env.precision.eps:
        # a zero-norm register has no distribution to sample; the clamp
        # would otherwise return the last basis index for every shot
        val._fail("cannot sample a zero-probability register",
                  "sampleOutcomes", val.ErrorCode.E_COLLAPSE_STATE_ZERO_PROB)
    return _packed_outcomes(idx_dev.cpu().numpy().astype(np.int64), qubits)


def _packed_outcomes(idx: np.ndarray, qubits) -> np.ndarray:
    """Basis indices, or the outcomes of ``qubits`` packed little-endian."""
    if qubits is None:
        return idx
    out = np.zeros_like(idx)
    for j, q in enumerate(qubits):
        out |= ((idx >> q) & 1) << j
    return out


# ---------------------------------------------------------------------------
# amplitude access & calculations (QuEST.h:366-944)
# ---------------------------------------------------------------------------

def getNumQubits(qureg: Qureg) -> int:
    return qureg.num_qubits_represented


def getNumAmps(qureg: Qureg) -> int:
    val.validate_state_vec(qureg.is_density_matrix, "getNumAmps")
    return qureg.num_amps_total


def getAmp(qureg: Qureg, index: int) -> complex:
    val.validate_state_vec(qureg.is_density_matrix, "getAmp")
    val.validate_amp_index(qureg.num_amps_total, index, "getAmp")
    return _amp_pair(qureg, index)


def _amp_pair(qureg: Qureg, index: int) -> complex:
    if qureg.is_sharded:
        # under a lazy layout the logical index maps bit by bit to its
        # physical one; the read touches one shard
        qureg.flush_gates()
        return complex(*chk.amp_pair(qureg, _pg.phys_index(qureg, index)))
    pair = qureg.state[:, int(index)].double().cpu()
    if qureg.is_quad:
        return complex(float(pair[0]) + float(pair[1]),
                       float(pair[2]) + float(pair[3]))
    return complex(float(pair[0]), float(pair[1]))


def getRealAmp(qureg: Qureg, index: int) -> float:
    return getAmp(qureg, index).real


def getImagAmp(qureg: Qureg, index: int) -> float:
    return getAmp(qureg, index).imag


def getProbAmp(qureg: Qureg, index: int) -> float:
    a = getAmp(qureg, index)
    return a.real * a.real + a.imag * a.imag


def getDensityAmp(qureg: Qureg, row: int, col: int) -> complex:
    val.validate_density_matr(qureg.is_density_matrix, "getDensityAmp")
    dim = 1 << qureg.num_qubits_represented
    val.validate_amp_index(dim, row, "getDensityAmp")
    val.validate_amp_index(dim, col, "getDensityAmp")
    return _amp_pair(qureg, int(row) + int(col) * dim)


def calcTotalProb(qureg: Qureg) -> float:
    if qureg.is_sharded:
        if qureg.is_density_matrix:
            qureg.ensure_canonical()
            return chk.density_total_prob(qureg)
        return chk.total_prob(qureg)
    if qureg.is_quad:
        if qureg.is_density_matrix:
            return ddm.dd_total_prob_dm(qureg.state,
                                        qureg.num_qubits_represented)
        return ddm.dd_total_prob(qureg.state)
    if qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        if qureg.env.compensated:
            return _pair(red.sum_pair(dm.diagonal(qureg.state, n)))
        return float(dm.calc_total_prob(qureg.state, n))
    if qureg.env.compensated:
        return _pair(red.dot_pair(qureg.state, qureg.state))
    return float(sv.calc_total_prob(qureg.state))


def calcInnerProduct(bra: Qureg, ket: Qureg) -> complex:
    val.validate_state_vec(bra.is_density_matrix, "calcInnerProduct")
    val.validate_state_vec(ket.is_density_matrix, "calcInnerProduct")
    val.validate_matching_dims(bra.num_qubits_represented,
                               ket.num_qubits_represented, "calcInnerProduct")
    val.validate_matching_precision(bra.env.precision.quest_prec,
                                    ket.env.precision.quest_prec,
                                    "calcInnerProduct")
    if bra.is_sharded:
        _canon(bra, ket)
        return chk.inner_product(bra, ket)
    if bra.is_quad:
        return ddm.dd_vdot(bra.state, ket.state.to(bra.device))
    if bra.env.compensated:
        return red.vdot_compensated(bra.state, ket.state)
    re, im = sv.calc_inner_product(bra.state, ket.state)
    return complex(float(re), float(im))


def _validate_density_pair(a: Qureg, b: Qureg, func: str) -> None:
    val.validate_density_matr(a.is_density_matrix, func)
    val.validate_density_matr(b.is_density_matrix, func)
    val.validate_matching_dims(a.num_qubits_represented,
                               b.num_qubits_represented, func)
    val.validate_matching_precision(a.env.precision.quest_prec,
                                    b.env.precision.quest_prec, func)


def calcDensityInnerProduct(rho1: Qureg, rho2: Qureg) -> float:
    """real(Tr(rho1^dag rho2))."""
    _validate_density_pair(rho1, rho2, "calcDensityInnerProduct")
    if rho1.is_sharded:
        _canon(rho1, rho2)
        return chk.density_inner_product(rho1, rho2)
    if rho1.is_quad:
        return ddm.dd_vdot(rho1.state, rho2.state.to(rho1.device)).real
    if rho1.env.compensated:
        return _pair(red.dot_pair(rho1.state, rho2.state))
    return float(dm.calc_inner_product(rho1.state, rho2.state))


def calcPurity(qureg: Qureg) -> float:
    val.validate_density_matr(qureg.is_density_matrix, "calcPurity")
    if qureg.is_sharded:
        return chk.total_prob(qureg)
    if qureg.is_quad:
        return ddm.dd_total_prob(qureg.state)
    if qureg.env.compensated:
        return _pair(red.dot_pair(qureg.state, qureg.state))
    return float(dm.calc_purity(qureg.state))


def calcFidelity(qureg: Qureg, pure_state: Qureg) -> float:
    """|<qureg|pure>|^2 for a state vector, <pure|rho|pure> for a density
    register."""
    val.validate_second_qureg_state_vec(pure_state.is_density_matrix,
                                        "calcFidelity")
    val.validate_matching_dims(qureg.num_qubits_represented,
                               pure_state.num_qubits_represented,
                               "calcFidelity")
    val.validate_matching_precision(qureg.env.precision.quest_prec,
                                    pure_state.env.precision.quest_prec,
                                    "calcFidelity")
    if qureg.is_sharded:
        if qureg.is_density_matrix:
            qureg.ensure_canonical()
            return chk.fidelity_density(qureg, pure_state)
        _canon(qureg, pure_state)
        ip = chk.inner_product(qureg, pure_state)
        return ip.real ** 2 + ip.imag ** 2
    psi = pure_state.state.to(qureg.device)
    if qureg.is_quad:
        if qureg.is_density_matrix:
            # <psi|rho|psi> = sum_rc rho[r,c] conj(psi_r) psi_c: a plain
            # dd dot with the dd outer-product weights (lo planes kept)
            w = ddm.dd_outer(psi, conj_left=True)
            return ddm.dd_vdot(w, qureg.state, conj_a=False).real
        return abs(ddm.dd_vdot(qureg.state, psi)) ** 2
    if qureg.is_density_matrix:
        n = qureg.num_qubits_represented
        if qureg.env.compensated:
            # rho psi as matrix-vector products (their rounding stays),
            # then an error-free final dot: Re <psi|rho psi>. The planes
            # view as mat[c, r] = rho[r, c], so rho is the transpose
            # (the JAX package's compensated form multiplies by mat itself
            # and so computes <psi|rho^T|psi>, ROADMAP)
            dim = 1 << n
            a = qureg.state[0].view(dim, dim).t()
            b = qureg.state[1].view(dim, dim).t()
            w = torch.stack([torch.mv(a, psi[0]) - torch.mv(b, psi[1]),
                             torch.mv(a, psi[1]) + torch.mv(b, psi[0])])
            (re, re_e), _ = red.vdot_pair(psi, w)
            return float(re) + float(re_e)
        return float(dm.calc_fidelity(qureg.state, n, psi))
    if qureg.env.compensated:
        (re, re_e), (im, im_e) = red.vdot_pair(qureg.state, psi)
        return (float(re) + float(re_e)) ** 2 \
            + (float(im) + float(im_e)) ** 2
    re, im = sv.calc_inner_product(qureg.state, psi)
    return float(re) ** 2 + float(im) ** 2


def calcHilbertSchmidtDistance(a: Qureg, b: Qureg) -> float:
    _validate_density_pair(a, b, "calcHilbertSchmidtDistance")
    if a.is_sharded:
        _canon(a, b)
        return chk.hs_distance(a, b)
    if a.is_quad:
        diff = ddm.dd_weighted(1.0, a.state, -1.0, b.state.to(a.device),
                               0.0, a.state)
        return math.sqrt(max(0.0, ddm.dd_total_prob(diff)))
    if a.env.compensated:
        d = a.state - b.state
        return math.sqrt(max(0.0, _pair(red.dot_pair(d, d))))
    return float(dm.calc_hilbert_schmidt_distance(a.state, b.state))


def calcExpecPauliProd(qureg: Qureg, targets: Sequence[int],
                       codes: Sequence[int], num_targets: int = None,
                       workspace: Qureg = None) -> float:
    """``<psi|P|psi>`` or ``Tr(P rho)`` of one Pauli product
    (``QuEST.h:2454``; the 4th positional argument is numTargets and may be
    omitted). The product becomes one term of bit masks
    (``ops/reductions.py``), read in one gather pass; ``workspace`` is
    accepted for signature parity and unused."""
    if num_targets is not None and not isinstance(num_targets,
                                                  numbers.Integral):
        workspace, num_targets = num_targets, None
    if num_targets is not None:
        targets = tuple(targets)[:int(num_targets)]
        codes = tuple(codes)[:int(num_targets)]
    val.validate_multi_targets(qureg.num_qubits_represented, targets,
                               "calcExpecPauliProd")
    val.validate_pauli_codes(codes, "calcExpecPauliProd")
    n = qureg.num_qubits_represented
    codes_flat = [0] * n
    for t, c in zip(targets, codes):
        codes_flat[int(t)] = int(c)
    if qureg.is_quad:
        phi = _dd_pauli_image(qureg, codes_flat)
        if qureg.is_density_matrix:
            return float(ddm.dd_total_prob_dm(phi, n))
        return float(ddm.dd_vdot(qureg.state, phi).real)
    xm, ym, zm = red.pauli_masks(codes_flat, n)
    if qureg.is_sharded and not qureg.is_density_matrix:
        qureg.ensure_canonical()
        return float(chk.pauli_expvals(
            qureg.chunks, n - _pg._shard_bits(qureg), xm, ym, zm,
            qureg.env.compensated)[0, 0])
    if qureg.is_density_matrix:
        return float(red.pauli_sum_expvals_dm(qureg.state, n, xm, ym,
                                              zm)[0])
    return float(red.pauli_sum_expvals_sv(qureg.state.unsqueeze(0), xm, ym,
                                          zm)[0, 0])


def calcExpecPauliSum(qureg: Qureg, all_codes: Sequence[int],
                      coeffs: Sequence[float], num_sum_terms: int = None,
                      workspace: Qureg = None) -> float:
    """``sum_t coeffs[t] <psi|P_t|psi>`` (``QuEST.h:2504``; the 4th
    positional argument is numSumTerms and may be omitted). The terms
    become bit masks (``ops/reductions.py``) and the sum is reduced on the
    device with one scalar transfer, where the reference pays one workspace
    pass and one sync per term (``QuEST_common.c:464-491``); ``workspace``
    is accepted for signature parity and unused. On a density register
    each term reads only the 2^n paired-diagonal entries
    (``pauli_sum_total_dm``)."""
    if num_sum_terms is not None and not isinstance(num_sum_terms,
                                                    numbers.Integral):
        workspace, num_sum_terms = num_sum_terms, None
    n = qureg.num_qubits_represented
    num_terms = int(num_sum_terms) if num_sum_terms is not None \
        else len(coeffs)
    val.validate_num_pauli_sum_terms(num_terms, "calcExpecPauliSum")
    val.validate_pauli_codes(all_codes, "calcExpecPauliSum")
    codes_flat = tuple(int(c) for c in all_codes[:num_terms * n])
    if qureg.is_quad:
        # term by term on the dd planes: P_t psi, then one dd reduction
        value = 0.0
        for t in range(num_terms):
            phi = _dd_pauli_image(qureg, codes_flat[t * n:(t + 1) * n])
            if qureg.is_density_matrix:
                value += float(coeffs[t]) * ddm.dd_total_prob_dm(phi, n)
            else:
                value += float(coeffs[t]) * ddm.dd_vdot(qureg.state,
                                                        phi).real
        return value
    xm, ym, zm, coeffs_np = red.pauli_sum_operands(
        codes_flat, n, np.asarray(coeffs[:num_terms], np.float64))
    if qureg.is_sharded and not qureg.is_density_matrix:
        qureg.ensure_canonical()
        return float(chk.pauli_total(
            qureg.chunks, n - _pg._shard_bits(qureg), xm, ym, zm, coeffs_np,
            qureg.env.compensated)[0])
    if qureg.is_density_matrix:
        return float(red.pauli_sum_total_dm(qureg.state, n, xm, ym, zm,
                                            coeffs_np))
    return float(red.pauli_sum_total_sv(qureg.state.unsqueeze(0), xm, ym,
                                        zm, coeffs_np)[0])


def _dd_pauli_image(qureg: Qureg, codes: Sequence[int]) -> torch.Tensor:
    """P psi on a QUAD register's planes for one term's per-qubit codes
    (on a density register the Paulis act on the ket half). Pauli entries
    are 0, +-1 and +-i, so each dd gate is exact and the order of the
    qubits does not change a bit."""
    phi = qureg.state
    nv = qureg.num_qubits_in_state_vec
    for q, code in enumerate(codes):
        if code:
            phi = ddm.dd_apply_kq(phi, nv, mats.PAULI_MATS[code], (q,))
    return phi


def applyPauliSum(in_qureg: Qureg, all_codes: Sequence[int],
                  coeffs: Sequence[float], num_terms: int,
                  out_qureg: Qureg) -> None:
    """out = sum_t c_t P_t |in> (``statevec_applyPauliSum``
    ``QuEST_common.c:494-514``); on density registers the Paulis act on
    the ket half, so out = H rho. One xor-gather per term over the planes
    (``reductions.pauli_sum_apply``, the gradient walk's ``H psi``)."""
    val.validate_matching_types(in_qureg.is_density_matrix,
                                out_qureg.is_density_matrix, "applyPauliSum")
    val.validate_matching_precision(in_qureg.env.precision.quest_prec,
                                    out_qureg.env.precision.quest_prec,
                                    "applyPauliSum")
    val.validate_matching_dims(in_qureg.num_qubits_represented,
                               out_qureg.num_qubits_represented,
                               "applyPauliSum")
    val.validate_num_pauli_sum_terms(num_terms, "applyPauliSum")
    val.validate_pauli_codes(all_codes, "applyPauliSum")
    n = in_qureg.num_qubits_represented
    codes_flat = tuple(int(c) for c in all_codes[:num_terms * n])
    if in_qureg.is_quad:
        acc = None
        for t in range(num_terms):
            phi = _dd_pauli_image(in_qureg, codes_flat[t * n:(t + 1) * n])
            acc = ddm.dd_weighted(float(coeffs[t]), phi, 0.0, phi, 0.0,
                                  phi) if acc is None else \
                ddm.dd_weighted(1.0, acc, float(coeffs[t]), phi, 0.0, acc)
        out_qureg.state = acc.to(out_qureg.device)
        out_qureg.qasm_log.record_comment(
            "the register was set to a Pauli-sum image (possibly "
            "unphysical)")
        return
    xm, ym, zm, coeffs_np = red.pauli_sum_operands(
        codes_flat, n, np.asarray(coeffs[:num_terms], np.float64))
    out = red.pauli_sum_apply(in_qureg.state.unsqueeze(0), xm, ym, zm,
                              coeffs_np)
    out_qureg.state = out[0].to(out_qureg.device)
    out_qureg.qasm_log.record_comment(
        "the register was set to a Pauli-sum image (possibly unphysical)")


# ---------------------------------------------------------------------------
# decoherence (QuEST.h:1929-3043)
# ---------------------------------------------------------------------------

def _apply_kraus(qureg: Qureg, targets: Sequence[int], ops) -> None:
    """The channel's superoperator on (targets, targets+n) of the flat
    density vector (``densmatr_applyMultiQubitKrausSuperoperator``
    ``QuEST_common.c:598-604``)."""
    superop = dm.kraus_superoperator(ops)
    if qureg.is_quad:
        n = qureg.num_qubits_represented
        t2 = tuple(int(t) for t in targets) \
            + tuple(int(t) + n for t in targets)
        qureg.state = ddm.dd_apply_kq(qureg.state, 2 * n, superop, t2)
        return
    if qureg.is_sharded:
        n = qureg.num_qubits_represented
        t2 = tuple(int(t) for t in targets) \
            + tuple(int(t) + n for t in targets)
        _sharded_unitary(qureg, superop, t2, 0, 0)
        return
    dm.apply_kraus_superoperator(qureg.state, qureg.num_qubits_represented,
                                 targets, superop)


def mixDephasing(qureg: Qureg, target: int, prob: float) -> None:
    val.validate_density_matr(qureg.is_density_matrix, "mixDephasing")
    val.validate_target(qureg.num_qubits_represented, target, "mixDephasing")
    val.validate_prob(prob, "mixDephasing", 0.5, "dephasing probability",
                      code=val.ErrorCode.E_INVALID_ONE_QUBIT_DEPHASE_PROB)
    if qureg.is_quad:
        n = qureg.num_qubits_represented
        qureg.state = ddm.dd_apply_diag(qureg.state, 2 * n,
                                        dm.dephasing_factors(float(prob)),
                                        (int(target) + n, int(target)))
    elif qureg.is_sharded:
        # dephasing is diagonal on (target+n, target): position-free
        n = qureg.num_qubits_represented
        _pg.sharded_diag(qureg, dm.dephasing_factors(float(prob)),
                         (int(target) + n, int(target)))
    else:
        dm.mix_dephasing(qureg.state, qureg.num_qubits_represented,
                         int(target), float(prob))
    qureg.qasm_log.record_comment(
        f"a phase (Z) error occurred on qubit {target} with probability "
        f"{prob:g}")


def mixTwoQubitDephasing(qureg: Qureg, q1: int, q2: int,
                         prob: float) -> None:
    val.validate_density_matr(qureg.is_density_matrix,
                              "mixTwoQubitDephasing")
    val.validate_unique_targets(qureg.num_qubits_represented, q1, q2,
                                "mixTwoQubitDephasing")
    val.validate_prob(prob, "mixTwoQubitDephasing", 0.75,
                      "two-qubit dephasing probability",
                      code=val.ErrorCode.E_INVALID_TWO_QUBIT_DEPHASE_PROB)
    if qureg.is_quad:
        # diagonal on (q1, q2, q1+n, q2+n)
        n = qureg.num_qubits_represented
        hi, lo = max(int(q1), int(q2)), min(int(q1), int(q2))
        qureg.state = ddm.dd_apply_diag(
            qureg.state, 2 * n, dm.two_qubit_dephasing_factors(float(prob)),
            (hi + n, lo + n, hi, lo))
    elif qureg.is_sharded:
        n = qureg.num_qubits_represented
        hi, lo = max(int(q1), int(q2)), min(int(q1), int(q2))
        _pg.sharded_diag(qureg, dm.two_qubit_dephasing_factors(float(prob)),
                         (hi + n, lo + n, hi, lo))
    else:
        dm.mix_two_qubit_dephasing(qureg.state,
                                   qureg.num_qubits_represented, int(q1),
                                   int(q2), float(prob))
    qureg.qasm_log.record_comment(
        f"a phase (Z) error occurred on qubits {q1} and/or {q2} "
        f"with total probability {prob:g}")


def mixDepolarising(qureg: Qureg, target: int, prob: float) -> None:
    val.validate_density_matr(qureg.is_density_matrix, "mixDepolarising")
    val.validate_target(qureg.num_qubits_represented, target,
                        "mixDepolarising")
    val.validate_prob(prob, "mixDepolarising", 0.75,
                      "depolarising probability",
                      code=val.ErrorCode.E_INVALID_ONE_QUBIT_DEPOL_PROB)
    _apply_kraus(qureg, (target,), chan.depolarising_kraus(prob))
    qureg.qasm_log.record_comment(
        f"a depolarising error occurred on qubit {target} "
        f"with total probability {prob:g}")


def mixDamping(qureg: Qureg, target: int, prob: float) -> None:
    val.validate_density_matr(qureg.is_density_matrix, "mixDamping")
    val.validate_target(qureg.num_qubits_represented, target, "mixDamping")
    val.validate_prob(prob, "mixDamping", 1.0, "damping probability")
    _apply_kraus(qureg, (target,), chan.damping_kraus(prob))


def mixTwoQubitDepolarising(qureg: Qureg, q1: int, q2: int,
                            prob: float) -> None:
    val.validate_density_matr(qureg.is_density_matrix,
                              "mixTwoQubitDepolarising")
    val.validate_unique_targets(qureg.num_qubits_represented, q1, q2,
                                "mixTwoQubitDepolarising")
    val.validate_prob(prob, "mixTwoQubitDepolarising", 15.0 / 16.0,
                      "two-qubit depolarising probability",
                      code=val.ErrorCode.E_INVALID_TWO_QUBIT_DEPOL_PROB)
    _apply_kraus(qureg, (q1, q2), chan.two_qubit_depolarising_kraus(prob))
    qureg.qasm_log.record_comment(
        f"a depolarising error occurred on qubits {q1} and {q2} "
        f"with total probability {prob:g}")


def mixPauli(qureg: Qureg, qubit: int, prob_x: float, prob_y: float,
             prob_z: float) -> None:
    val.validate_density_matr(qureg.is_density_matrix, "mixPauli")
    val.validate_target(qureg.num_qubits_represented, qubit, "mixPauli")
    val.validate_one_qubit_pauli_probs(prob_x, prob_y, prob_z, "mixPauli")
    _apply_kraus(qureg, (qubit,), chan.pauli_kraus(prob_x, prob_y, prob_z))
    qureg.qasm_log.record_comment(
        f"X, Y and Z errors occurred on qubit {qubit} with probabilities "
        f"{prob_x:g}, {prob_y:g} and {prob_z:g} respectively")


def mixDensityMatrix(qureg: Qureg, other_prob: float, other: Qureg) -> None:
    """qureg = (1-p) qureg + p other, in place."""
    val.validate_density_matr(qureg.is_density_matrix, "mixDensityMatrix")
    val.validate_density_matr(other.is_density_matrix, "mixDensityMatrix")
    val.validate_matching_dims(qureg.num_qubits_represented,
                               other.num_qubits_represented,
                               "mixDensityMatrix")
    val.validate_prob(other_prob, "mixDensityMatrix")
    val.validate_matching_precision(qureg.env.precision.quest_prec,
                                    other.env.precision.quest_prec,
                                    "mixDensityMatrix")
    if qureg.is_sharded:
        _canon(qureg, other)
        chk.mix_density(qureg, other_prob, other)
        return
    src = other.state.to(qureg.device)
    if qureg.is_quad:
        qureg.state = ddm.dd_weighted(1.0 - float(other_prob), qureg.state,
                                      float(other_prob), src, 0.0,
                                      qureg.state)
        return
    if src.data_ptr() == qureg.state.data_ptr():
        src = src.clone()      # the in-place update would read itself
    dm.mix_density_matrix(qureg.state, float(other_prob), src)


def _kraus_list(ops, num_ops) -> list:
    return list(ops)[:num_ops] if num_ops is not None else list(ops)


def mixKrausMap(qureg: Qureg, target: int, ops, num_ops: int = None) -> None:
    val.validate_density_matr(qureg.is_density_matrix, "mixKrausMap")
    val.validate_target(qureg.num_qubits_represented, target, "mixKrausMap")
    ops = _kraus_list(ops, num_ops)
    val.validate_kraus_ops(ops, 1, "mixKrausMap", qureg.env.precision.eps)
    _apply_kraus(qureg, (target,), ops)
    qureg.qasm_log.record_comment(
        f"an undisclosed Kraus map was applied to qubit {target}")


def mixTwoQubitKrausMap(qureg: Qureg, t1: int, t2: int, ops,
                        num_ops: int = None) -> None:
    val.validate_density_matr(qureg.is_density_matrix, "mixTwoQubitKrausMap")
    val.validate_multi_targets(qureg.num_qubits_represented, (t1, t2),
                               "mixTwoQubitKrausMap")
    ops = _kraus_list(ops, num_ops)
    val.validate_kraus_ops(ops, 2, "mixTwoQubitKrausMap",
                           qureg.env.precision.eps)
    _apply_kraus(qureg, (t1, t2), ops)
    qureg.qasm_log.record_comment(
        f"an undisclosed two-qubit Kraus map was applied to qubits {t1}, "
        f"{t2}")


def mixMultiQubitKrausMap(qureg: Qureg, targets: Sequence[int], ops,
                          num_ops: int = None) -> None:
    val.validate_density_matr(qureg.is_density_matrix,
                              "mixMultiQubitKrausMap")
    val.validate_multi_targets(qureg.num_qubits_represented, targets,
                               "mixMultiQubitKrausMap")
    ops = _kraus_list(ops, num_ops)
    val.validate_kraus_ops(ops, len(targets), "mixMultiQubitKrausMap",
                           qureg.env.precision.eps)
    _apply_kraus(qureg, tuple(targets), ops)
    qureg.qasm_log.record_comment(
        f"an undisclosed {len(targets)}-qubit Kraus map was applied")


# ---------------------------------------------------------------------------
# QASM recording (QuEST.h:1868-1906)
# ---------------------------------------------------------------------------

def startRecordingQASM(qureg: Qureg) -> None:
    qureg.qasm_log.is_logging = True


def stopRecordingQASM(qureg: Qureg) -> None:
    qureg.qasm_log.is_logging = False


def clearRecordedQASM(qureg: Qureg) -> None:
    qureg.qasm_log.clear()


def printRecordedQASM(qureg: Qureg) -> None:
    print(qureg.qasm_log.text(), end="")


def writeRecordedQASMToFile(qureg: Qureg, filename: str) -> None:
    try:
        qureg.qasm_log.write_to_file(filename)
    except OSError:
        val.validate_file_opened(False, "writeRecordedQASMToFile")


# ---------------------------------------------------------------------------
# debug / reporting (QuEST.h:319-359, QuEST_debug.h)
# ---------------------------------------------------------------------------

def reportState(qureg: Qureg, filename: str = "state_rank_0.csv") -> None:
    """Dump amplitudes as 'real, imag' CSV (``reportState``
    ``QuEST_common.c:215-231``), the JAX package's form."""
    amps = qureg.to_numpy()
    with open(filename, "w") as f:
        f.write("real, imag\n")
        for a in amps:
            f.write(f"{a.real:.12e}, {a.imag:.12e}\n")


def reportStateToScreen(qureg: Qureg, env: QuESTEnv = None,
                        report_rank: int = 0) -> None:
    # the reference silently skips large registers rather than erroring
    # (guard on the STATE-VECTOR qubit count, QuEST_cpu.c:1343)
    if qureg.num_qubits_in_state_vec > 5:
        return
    amps = qureg.to_numpy()
    print("Reporting state from rank 0 of 1")
    for a in amps:
        print(f"{a.real:.12f}, {a.imag:.12f}")


def reportQuregParams(qureg: Qureg) -> None:
    print(f"QUBITS: {qureg.num_qubits_represented}")
    print(f"TOTAL AMPS: {qureg.num_amps_total}")
    print(f"AMPS PER DEVICE: {qureg.num_amps_per_chunk}")
    mem = qureg.num_amps_total * qureg.dtype.itemsize
    print(f"DEVICE MEMORY: {mem / 2**20:.1f} MiB")


def compareStates(q1: Qureg, q2: Qureg, precision: float) -> bool:
    val.validate_matching_dims(q1.num_qubits_represented,
                               q2.num_qubits_represented, "compareStates")
    a, b = q1.to_numpy(), q2.to_numpy()
    return bool(np.all(np.abs(a.real - b.real) < precision)
                and np.all(np.abs(a.imag - b.imag) < precision))


def initStateFromSingleFile(qureg: Qureg, filename: str,
                            env: QuESTEnv = None) -> None:
    """Load a state written by :func:`reportState` (of either package)."""
    rows = []
    try:
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("real"):
                    continue
                re_s, im_s = line.split(",")
                rows.append(complex(float(re_s), float(im_s)))
    except OSError:
        val.validate_file_opened(False, "initStateFromSingleFile")
    if len(rows) != qureg.num_amps_total:
        val._fail("the state file does not match the register dimension",
                  "initStateFromSingleFile",
                  val.ErrorCode.E_INVALID_NUM_AMPS)
    qureg.device_put(np.asarray(rows, dtype=np.complex128))


def getQuEST_PREC() -> int:
    from .config import default_precision
    return default_precision().quest_prec
