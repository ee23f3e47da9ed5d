"""Whole-circuit compilation, on one device or on a mesh of shards.

Counterpart of the JAX package's ``circuits.py``.
A :class:`Circuit` records gates; :meth:`Circuit.compile` runs the same
planning pipeline as the JAX package —

1. gate fusion (``core/fusion.py``): runs of adjacent gates whose support
   fits in k qubits contract into one dense op, with layer-eligible runs
   fenced off when the layer pass will claim them;
2. scheduling (``_schedule``): peephole fusion plus the layout plan (the
   JAX package's pure-Python branch, ``circuits.py:1547-1554``): the
   identity placement on one device; on a mesh env
   (``createQuESTEnv(num_devices=n)``) the lazy-layout planner of
   ``parallel/layout.py`` with relayouts, cross-shard 1q items and, with
   the communication model, absorbed SWAPs and composed exchanges;
3. super-gate grouping (``_group_supergates``);
4. layer collection (``_collect_layers_plan``): runs of ops whose footprint
   fits one kernel tile become :class:`~quest_tpu_torch.ops.layer_kernel.
   LayerOp` s —

and :meth:`CompiledCircuit.run` walks the plan: every layer through
``ops.layer_kernel.apply_layer`` (the CUDA kernel on the card, its plain
version on the CPU), every other op through the gate engine
(``core/apply.py``). PyTorch runs eagerly, so there is no whole-program
executable; the plan is the program, applied IN PLACE to the register's
planes. On a mesh the same walk runs on each shard's chunk (the JAX
package's ``shard_map`` local body, ``circuits.py:1869-1963``): layers and
gates on ``n - s`` local qubits, a control on a device bit as a per-shard
skip, relayouts and cross-shard items through ``parallel/exchange.py``,
with ``overlap=True`` pairing a relayout with the gate after it as the
slab double-buffered exchange. The batched engine chooses the batch or
the amplitude axis per dispatch (``layout.choose_batch_sharding``): in
``batch`` mode each shard runs whole states through the single-device
plan (a batch not divisible by the mesh is padded and the padding
dropped), in ``amp`` mode every state spans the mesh as chunks.

The batched ensemble engine (:meth:`CompiledCircuit.sweep`,
:meth:`~CompiledCircuit.expectation_sweep`,
:meth:`~CompiledCircuit.sample_sweep`) walks the same plan over a ``(B, 2,
2^n)`` batch, one parameter binding per row: layers through
``apply_layer_batched`` (one launch for the batch), other ops through the
gate engine's batched form (``ops/adjoint.py``), on state-vector and
density programs. :meth:`CompiledCircuit.value_and_grad_sweep` (and
``grad_sweep``, ``expectation_fn``) differentiates ``<H>`` by an adjoint
walk back over the same plan, each layer's adjoint one launch of the same
kernel. Channels (:meth:`Circuit.kraus` and the named
channels) are recorded as ``"kraus"`` ops; a state-vector compile rejects
them, ``compile(density=True)`` runs them exactly on a density register
(the program lifted to the flat 2n-qubit vector, ``_lifted_density``, and
planned like any other), and :meth:`Circuit.compile_trajectories` runs
them as trajectory ensembles (``ops/trajectories.py``). A parametrised
gate has one torch definition, bound per row and differentiated with
``torch.func``.

Precision tiers (``config.TIER_LADDER``): ``Circuit.compile(tier=...)`` or
``error_budget=...`` pins the tier ``run``/``apply`` execute at, and the
engine's entry points take a per-dispatch ``tier=``. One rule maps a tier
to its execution mode (:meth:`CompiledCircuit._tier_exec_mode`): FAST runs
the fused layers' dense stages on bf16 inputs (the layer kernel's FAST
branch) in float32 planes, SINGLE runs float32 with compensated Pauli
energies, DOUBLE float64 (an f64-storage environment only). A tier whose
plane dtype differs from the environment's is cast in and out: callers
always see env-dtype planes. The FAST tier's crossover prices the packed
``rowmxu`` contraction at the bf16 tensor-core rate, so it collects other
stages than SINGLE: each (plane dtype, FAST) pair plans its own layers,
built once and kept (the port runs eagerly, so there is no executable
cache to key).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from . import validation as val
from .config import QUAD_TIER, tier_by_name
from .core import matrices as mats
from .core.apply import apply_diagonal, apply_unitary, bitmask
from .env import QuESTEnv
from .ops import adjoint as adj
from .ops import channels as chan
from .ops import densmatr as dm
from .ops import dynamics as dyn
from .ops import layer_kernel as lk
from .ops import reductions as red
from .parallel import exchange as ex
from .parallel import shards
from .parallel.layout import LayoutPlan, is_swap_op, plan_layout
from .qureg import Qureg
from .resilience import faults as _faults
from .resilience import health as _health
from .telemetry import profile as _profile
from .telemetry.tracing import dispatch_annotation
from .types import PauliOpType

__all__ = ["Circuit", "CompiledCircuit", "Param"]


@dataclasses.dataclass(frozen=True)
class Param:
    """A named angle placeholder, bound at run time."""
    name: str


Angle = Union[float, Param]


@dataclasses.dataclass
class _Op:
    """One recorded gate. ``mat`` is a static numpy matrix (fusable) or
    ``mat_fn`` a ``params -> matrix`` function; likewise ``diag`` /
    ``diag_fn`` for elementwise (phase-family) factors of shape
    ``(2,)*k``."""
    kind: str                      # "u" | "diag" | "kraus"
    targets: tuple[int, ...]       # user bit order ("u", "kraus") /
    #                                sorted desc ("diag")
    ctrl_mask: int = 0
    flip_mask: int = 0
    mat: Optional[np.ndarray] = None
    mat_fn: Optional[Callable] = None
    diag: Optional[np.ndarray] = None
    diag_fn: Optional[Callable] = None
    kraus: Optional[object] = None  # kind "kraus": operator list, or a
    #                                 params -> operators callable
    channel: bool = False           # a channel's superoperator (density
    #                                 lift): not unitary

    @property
    def is_static(self) -> bool:
        return (self.mat_fn is None and self.diag_fn is None
                and not callable(self.kraus))


def _param(params: dict, a: Param) -> torch.Tensor:
    """The value ``params`` binds to ``a``, as a float64 tensor (a float,
    or a row's 0-dim slice when ``torch.func`` binds a batch of rows)."""
    return torch.as_tensor(params[a.name], dtype=torch.float64)


def _permute(t, axes):
    return t.permute(axes) if isinstance(t, torch.Tensor) \
        else np.transpose(t, axes)


def _wire_angle(a: Angle):
    """JSON-able wire form of one builder angle/rate argument: a Param
    placeholder travels by name, a static value by exact float."""
    if isinstance(a, Param):
        return {"param": a.name}
    return float(a)


def _wire_cmat(arr) -> dict:
    """JSON-able wire form of one complex tensor. ``json.dumps`` emits
    ``repr(float)`` so the round trip is bit-exact — the decoded matrix
    hashes to the same ``warmcache.circuit_digest`` bytes."""
    a = np.asarray(arr, dtype=np.complex128)
    return {"re": a.real.tolist(), "im": a.imag.tolist()}


class Circuit:
    """A recorded gate program over ``num_qubits`` qubits.

    Builder methods append gates; nothing touches a device until
    :meth:`compile`. Qubit/control indices follow the reference's
    conventions (bit ``j`` of a multi-qubit matrix row indexes
    ``targets[j]``).
    """

    def __init__(self, num_qubits: int):
        if num_qubits < 1:
            raise ValueError("circuit needs at least one qubit")
        self.num_qubits = num_qubits
        self.ops: list[_Op] = []
        self._params: list[str] = []
        # wire journal: one JSON-able row per recorded op describing the
        # builder call that produced it (None = not wire-serializable),
        # in the JAX package's row names and argument order.
        # quest_tpu_torch.netserve.wire replays rows through these same
        # builders, so a decoded circuit reproduces the exact op stream
        # — closures included — and with it warmcache.circuit_digest.
        self._wire: list = []
        self._wire_depth = 0

    # -- parameters --------------------------------------------------------

    def parameter(self, name: str) -> Param:
        if name not in self._params:
            self._params.append(name)
        return Param(name)

    @property
    def param_names(self) -> tuple[str, ...]:
        return tuple(self._params)

    def _check(self, qubits: Sequence[int]) -> None:
        for q in qubits:
            if not 0 <= q < self.num_qubits:
                raise ValueError(
                    f"qubit {q} out of range [0, {self.num_qubits})")
        if len(set(qubits)) != len(tuple(qubits)):
            raise ValueError(f"repeated qubit in {tuple(qubits)}")

    def _register_angle(self, a: Angle) -> Angle:
        if isinstance(a, Param):
            return self.parameter(a.name)
        return a

    def _journal(self, entry, fn):
        """Run a builder body with ``entry`` as its wire-journal row:
        the HIGH-LEVEL call (not the primitive it delegates to) is what
        the wire form replays, so parameterized closures decode to the
        same code objects they were recorded from."""
        base = len(self.ops)
        self._wire_depth += 1
        try:
            out = fn()
        finally:
            self._wire_depth -= 1
        if self._wire_depth == 0:
            added = len(self.ops) - base
            # guarded builders append exactly one op; anything else has
            # no 1:1 row and journals opaque rather than guessing
            self._wire.extend([entry] if added == 1 else [None] * added)
        return out

    def _record(self, op: _Op, row) -> "Circuit":
        """Append one primitive op with its journal row (dropped when a
        :meth:`_journal` call above records the high-level row)."""
        self.ops.append(op)
        if self._wire_depth == 0:
            self._wire.append(row)
        return self

    def _wire_rows(self) -> list:
        """The journal, validated against the op stream (consumed by
        ``quest_tpu_torch.netserve.wire``). A mutation path that bypassed
        the journal (``inverse``, direct ``ops`` edits) misaligns it —
        every row then reads opaque, never a wrong replay."""
        if len(self._wire) != len(self.ops):
            return [None] * len(self.ops)
        return list(self._wire)

    # -- primitives --------------------------------------------------------

    def gate(self, u, targets: Sequence[int], controls: Sequence[int] = (),
             control_states: Optional[Sequence[int]] = None) -> "Circuit":
        """Record an arbitrary k-qubit (controlled) unitary: ``u`` is a
        ``(2^k, 2^k)`` matrix or a callable ``params -> matrix``;
        ``control_states`` (default all-1) gives each control's
        conditioning bit. A callable that the batched engine binds per row,
        or that a gradient sweep differentiates, must build its matrix with
        torch ops (as the JAX package's must with jnp)."""
        targets = tuple(int(t) for t in targets)
        controls = tuple(int(c) for c in controls)
        self._check(targets + controls)
        flip = 0
        if control_states is not None:
            if len(control_states) != len(controls):
                raise ValueError(
                    f"{len(controls)} controls but "
                    f"{len(control_states)} control states")
            for c, s in zip(controls, control_states):
                if not s:
                    flip |= 1 << c
        if callable(u):
            # a bare callable payload has no wire form
            return self._record(_Op("u", targets, bitmask(controls), flip,
                                    mat_fn=u), None)
        u = np.asarray(u, dtype=np.complex128)
        dim = 1 << len(targets)
        if u.shape != (dim, dim):
            raise ValueError(f"matrix shape {u.shape} != {(dim, dim)}")
        return self._record(
            _Op("u", targets, bitmask(controls), flip, mat=u),
            ["gate", _wire_cmat(u), list(targets), list(controls),
             [int(s) for s in control_states]
             if control_states is not None else None])

    def diagonal(self, factors, qubits: Sequence[int]) -> "Circuit":
        """Record an elementwise phase factor: ``factors`` has shape
        ``(2,)*k`` with axis ``i`` indexed by the bit of ``qubits[i]``, or
        is a callable ``params -> tensor`` (same axis order). Axes are
        re-ordered internally to sorted-descending qubits."""
        qubits = tuple(int(q) for q in qubits)
        self._check(qubits)
        desc = tuple(sorted(qubits, reverse=True))
        axes = tuple(qubits.index(q) for q in desc)
        if callable(factors):
            fn = factors if axes == tuple(range(len(qubits))) else \
                (lambda p, f=factors, a=axes: _permute(f(p), a))
            return self._record(_Op("diag", desc, diag_fn=fn), None)
        t = np.asarray(factors, dtype=np.complex128)
        if t.shape != (2,) * len(qubits):
            raise ValueError(f"diagonal tensor shape {t.shape} != "
                             f"{(2,) * len(qubits)}")
        # journal the CALLER's axis order: replay re-derives the
        # sorted layout through this same method
        return self._record(_Op("diag", desc, diag=t.transpose(axes)),
                            ["diagonal", _wire_cmat(t), list(qubits)])

    # -- named gates (reference API surface) -------------------------------

    def h(self, q: int) -> "Circuit":
        return self.gate(mats.hadamard(), (q,))

    def x(self, q: int) -> "Circuit":
        return self.gate(mats.pauli_x(), (q,))

    def y(self, q: int) -> "Circuit":
        return self.gate(mats.pauli_y(), (q,))

    def z(self, q: int) -> "Circuit":
        return self.diagonal(np.array([1.0, -1.0]), (q,))

    def s(self, q: int) -> "Circuit":
        return self.diagonal(np.array([1.0, 1j]), (q,))

    def t(self, q: int) -> "Circuit":
        return self.diagonal(np.array([1.0, np.exp(1j * np.pi / 4)]), (q,))

    def _phase_gate(self, qubits: Sequence[int], angle: Angle,
                    exponents, row: list) -> "Circuit":
        """Record the diagonal ``exp(i angle exponents)`` on ``qubits``
        (axis ``i`` of the real ``exponents`` table indexed by the bit of
        ``qubits[i]``): the one definition of the phase-family gates, bound
        at record time for a float angle and at run time for a Param.
        ``row`` is the calling builder's journal row without its angle
        (``["rz", q]``): a Param call journals it, a static one journals
        the ``"diagonal"`` row the JAX package writes for it."""
        angle = self._register_angle(angle)
        table = torch.as_tensor(np.asarray(exponents, dtype=np.float64))
        if isinstance(angle, Param):
            return self._journal(
                row + [_wire_angle(angle)],
                lambda: self.diagonal(
                    lambda p, a=angle, t=table: mats.phase_factors_traceable(
                        _param(p, a) * t), qubits))
        return self.diagonal(
            mats.phase_factors_traceable(float(angle) * table).numpy(),
            qubits)

    def phase(self, q: int, angle: Angle) -> "Circuit":
        return self._phase_gate((q,), angle, [0.0, 1.0], ["phase", int(q)])

    def _rot(self, q: int, angle: Angle, axis, controls=()) -> "Circuit":
        angle = self._register_angle(angle)
        if isinstance(angle, Param):
            return self._journal(
                ["rot", int(q), _wire_angle(angle),
                 [float(x) for x in axis], [int(c) for c in controls]],
                lambda: self.gate(
                    lambda p, a=angle: mats.rotation_traceable(
                        _param(p, a), axis), (q,), controls))
        return self.gate(mats.rotation(float(angle), axis), (q,), controls)

    def rx(self, q: int, angle: Angle) -> "Circuit":
        return self._rot(q, angle, (1, 0, 0))

    def ry(self, q: int, angle: Angle) -> "Circuit":
        return self._rot(q, angle, (0, 1, 0))

    def rz(self, q: int, angle: Angle) -> "Circuit":
        # diagonal fast path: exp(∓i angle/2)
        return self._phase_gate((q,), angle, [-0.5, 0.5], ["rz", int(q)])

    def rotate(self, q: int, angle: Angle, axis) -> "Circuit":
        return self._rot(q, angle, axis)

    def cnot(self, control: int, target: int) -> "Circuit":
        return self.gate(mats.pauli_x(), (target,), (control,))

    def cy(self, control: int, target: int) -> "Circuit":
        return self.gate(mats.pauli_y(), (target,), (control,))

    def cz(self, q1: int, q2: int) -> "Circuit":
        return self.diagonal(np.array([[1.0, 1.0], [1.0, -1.0]]), (q1, q2))

    def cphase(self, control: int, target: int, angle: Angle) -> "Circuit":
        """Controlled phase shift (diag(1,1,1,e^{i angle}))."""
        return self._phase_gate((control, target), angle,
                                [[0.0, 0.0], [0.0, 1.0]],
                                ["cphase", int(control), int(target)])

    def crz(self, control: int, target: int, angle: Angle) -> "Circuit":
        return self._phase_gate((control, target), angle,
                                [[0.0, 0.0], [-0.5, 0.5]],
                                ["crz", int(control), int(target)])

    def swap(self, q1: int, q2: int) -> "Circuit":
        return self.gate(mats.swap(), (q1, q2))

    def sqrt_swap(self, q1: int, q2: int) -> "Circuit":
        return self.gate(mats.sqrt_swap(), (q1, q2))

    def multi_rotate_z(self, qubits: Sequence[int],
                       angle: Angle) -> "Circuit":
        """exp(-i angle/2 Z⊗…⊗Z): phase by mask parity
        (``QuEST_cpu.c:3075-3114``)."""
        qubits = tuple(qubits)
        parity = np.indices((2,) * len(qubits)).sum(axis=0) % 2
        return self._phase_gate(qubits, angle, -0.5 * (1.0 - 2.0 * parity),
                                ["multi_rotate_z", [int(q) for q in qubits]])

    # -- channels (trajectory programs) ------------------------------------

    def kraus(self, ops, targets: Sequence[int]) -> "Circuit":
        """Record a Kraus channel ``rho -> sum_k K_k rho K_k^dag`` on
        ``targets`` (bit ``j`` of each operator's index addresses
        ``targets[j]``). :meth:`compile_trajectories` runs it
        stochastically on state vectors, validating CPTP at the env's
        precision; a state-vector :meth:`compile` rejects it.

        ``ops`` may be a callable ``params_dict -> [K_k]`` for a
        PARAMETERIZED channel: the operators are built from the bound
        strengths at run time, and no CPTP validation is possible for a
        function."""
        targets = tuple(int(t) for t in targets)
        self._check(targets)
        if callable(ops):
            return self._record(_Op("kraus", targets, kraus=ops), None)
        mats_l = [np.asarray(m, dtype=np.complex128) for m in ops]
        return self._record(
            _Op("kraus", targets, kraus=mats_l),
            ["kraus", [_wire_cmat(m) for m in mats_l], list(targets)])

    def dephase(self, q: int, prob: Angle) -> "Circuit":
        """rho -> (1-p) rho + p Z rho Z (mixDephasing semantics; max prob
        1/2, ``QuEST_validation.c:108``). A Param ``prob`` binds at run
        time and bypasses the cap; values outside [0, 1] give NaN planes."""
        if isinstance(prob, Param):
            nm = self._register_angle(prob).name
            return self._journal(
                ["dephase", int(q), {"param": nm}],
                lambda: self.kraus(
                    lambda p, nm=nm: chan.dephasing_kraus_traceable(p[nm]),
                    (q,)))
        val.validate_prob(prob, "Circuit.dephase", 0.5,
                          code=val.ErrorCode.E_INVALID_ONE_QUBIT_DEPHASE_PROB)
        return self.kraus([np.sqrt(1 - prob) * np.eye(2),
                           np.sqrt(prob) * mats.pauli_z()], (q,))

    def depolarise(self, q: int, prob: Angle) -> "Circuit":
        """Homogeneous depolarising (mixDepolarising semantics; max 3/4).
        A Param ``prob`` binds at run time (see :meth:`dephase`)."""
        if isinstance(prob, Param):
            nm = self._register_angle(prob).name
            return self._journal(
                ["depolarise", int(q), {"param": nm}],
                lambda: self.kraus(
                    lambda p, nm=nm: chan.depolarising_kraus_traceable(
                        p[nm]), (q,)))
        val.validate_prob(prob, "Circuit.depolarise", 0.75,
                          code=val.ErrorCode.E_INVALID_ONE_QUBIT_DEPOL_PROB)
        return self.kraus(chan.depolarising_kraus(prob), (q,))

    def damp(self, q: int, prob: Angle) -> "Circuit":
        """Amplitude damping at rate ``prob`` (mixDamping semantics). A
        Param ``prob`` binds at run time (see :meth:`dephase`)."""
        if isinstance(prob, Param):
            nm = self._register_angle(prob).name
            return self._journal(
                ["damp", int(q), {"param": nm}],
                lambda: self.kraus(
                    lambda p, nm=nm: chan.damping_kraus_traceable(p[nm]),
                    (q,)))
        val.validate_prob(prob, "Circuit.damp", 1.0)
        return self.kraus(chan.damping_kraus(prob), (q,))

    def pauli_channel(self, q: int, prob_x: Angle, prob_y: Angle,
                      prob_z: Angle) -> "Circuit":
        """rho -> (1-px-py-pz) rho + px X rho X + py Y rho Y + pz Z rho Z
        (mixPauli semantics). Any probability may be a Param; the static
        components (and their sum) validate at record time."""
        probs = (prob_x, prob_y, prob_z)
        if any(isinstance(p, Param) for p in probs):
            # validate every static piece BEFORE registering any Param: a
            # rejected call must leave no orphan parameter names
            statics = [float(p) for p in probs if not isinstance(p, Param)]
            for v in statics:
                val.validate_prob(v, "Circuit.pauli_channel", 1.0)
            val.validate_prob_sum(sum(statics), "Circuit.pauli_channel")
            val.validate_partial_pauli_probs(statics,
                                             "Circuit.pauli_channel")
            vals = []
            for p in probs:
                if isinstance(p, Param):
                    nm = self._register_angle(p).name
                    vals.append(lambda pd, nm=nm: pd[nm])
                else:
                    vals.append(lambda pd, v=float(p): v)
            return self._journal(
                ["pauli_channel", int(q), _wire_angle(prob_x),
                 _wire_angle(prob_y), _wire_angle(prob_z)],
                lambda: self.kraus(
                    lambda pd, vs=tuple(vals): chan.pauli_kraus_traceable(
                        vs[0](pd), vs[1](pd), vs[2](pd)), (q,)))
        val.validate_one_qubit_pauli_probs(prob_x, prob_y, prob_z,
                                           "Circuit.pauli_channel")
        return self.kraus(chan.pauli_kraus(prob_x, prob_y, prob_z), (q,))

    def two_qubit_dephase(self, q1: int, q2: int, prob: float) -> "Circuit":
        """rho -> (1-p) rho + p/3 (Z1 rho Z1 + Z2 rho Z2 + Z1 Z2 rho Z1 Z2)
        (mixTwoQubitDephasing semantics; max 3/4)."""
        val.validate_prob(prob, "Circuit.two_qubit_dephase", 0.75,
                          code=val.ErrorCode.E_INVALID_TWO_QUBIT_DEPHASE_PROB)
        return self.kraus(chan.two_qubit_dephasing_kraus(prob), (q1, q2))

    def two_qubit_depolarise(self, q1: int, q2: int,
                             prob: float) -> "Circuit":
        """Homogeneous two-qubit depolarising (mixTwoQubitDepolarising
        semantics; max 15/16)."""
        val.validate_prob(prob, "Circuit.two_qubit_depolarise", 15.0 / 16.0,
                          code=val.ErrorCode.E_INVALID_TWO_QUBIT_DEPOL_PROB)
        return self.kraus(chan.two_qubit_depolarising_kraus(prob), (q1, q2))

    def mid_measure(self, q: int) -> "Circuit":
        """A mid-circuit measurement of qubit ``q`` as the projector channel
        ``{|0><0|, |1><1|}``: through :meth:`compile_trajectories` each
        trajectory draws a definite outcome with its physical probability
        and collapses."""
        p0 = np.zeros((2, 2), dtype=np.complex128)
        p1 = np.zeros((2, 2), dtype=np.complex128)
        p0[0, 0] = 1.0
        p1[1, 1] = 1.0
        return self.kraus([p0, p1], (q,))

    def with_noise(self, p1: Angle = 0.0, p2: Angle = 0.0,
                   damping: Angle = 0.0) -> "Circuit":
        """A copy with a uniform noise model: after every gate, each
        touched qubit (targets and controls) gets depolarising noise —
        ``p1`` after single-qubit gates, ``p2`` after multi-qubit ones —
        then amplitude damping at rate ``damping``. Existing channels are
        kept and not re-noised. Rates may be Params, shared by every
        inserted channel."""
        for name, p, cap in (("p1", p1, 0.75), ("p2", p2, 0.75),
                             ("damping", damping, 1.0)):
            if not isinstance(p, Param):
                val.validate_prob(p, f"Circuit.with_noise({name})", cap)
        out = Circuit(self.num_qubits)
        out._params = list(self._params)
        for p in (p1, p2, damping):
            if isinstance(p, Param):
                # a rate whose trigger never fires is still a declared
                # parameter of the model
                out.parameter(p.name)

        def on(p):
            return isinstance(p, Param) or p > 0.0

        base_rows = self._wire_rows()
        for op, row in zip(self.ops, base_rows):
            out.ops.append(op)
            out._wire.append(row)
            if op.kind == "kraus":
                continue
            touched = sorted(
                set(op.targets)
                | {q for q in range(self.num_qubits)
                   if (op.ctrl_mask >> q) & 1})
            p = p1 if len(touched) == 1 else p2
            for q in touched:
                if on(p):
                    out.depolarise(q, p)
                if on(damping):
                    out.damp(q, damping)
        return out

    def _lifted_density(self) -> "Circuit":
        """Rewrite this n-qubit program as a 2n-qubit program on the
        flattened density vector, by the lift the API applies
        (:func:`densmatr.gate_passes`, :func:`densmatr.diagonal_lift`):
        an uncontrolled static gate U becomes conj(U) (x) U on (targets,
        targets+n) in ONE pass, controlled and parametrised gates take two
        passes, diagonals become conj(D) (x) D on (targets+n, targets);
        channels become superoperators."""
        n = self.num_qubits
        out = Circuit(2 * n)
        out._params = list(self._params)
        for op in self.ops:
            if op.kind == "kraus":
                t2 = op.targets + tuple(t + n for t in op.targets)
                if callable(op.kraus):
                    out.ops.append(_Op(
                        "u", t2, mat_fn=lambda p, f=op.kraus:
                        dm.kraus_superoperator_traceable(f(p)),
                        channel=True))
                else:
                    out.ops.append(_Op("u", t2,
                                       mat=dm.kraus_superoperator(op.kraus),
                                       channel=True))
            elif op.kind == "u":
                for lift, ts, cm, fm in dm.gate_passes(
                        op.targets, op.ctrl_mask, op.flip_mask, n,
                        fused=op.mat_fn is None):
                    if op.mat_fn is None:
                        out.ops.append(_Op("u", ts, cm, fm,
                                           mat=lift(op.mat)))
                    else:
                        out.ops.append(_Op(
                            "u", ts, cm, fm, mat_fn=lambda p, f=op.mat_fn,
                            g=lift: g(f(p))))
            else:
                lift, t2 = dm.diagonal_lift(op.targets, n)
                if op.diag_fn is None:
                    out.ops.append(_Op("diag", t2, diag=lift(op.diag)))
                else:
                    out.ops.append(_Op(
                        "diag", t2, diag_fn=lambda p, f=op.diag_fn, g=lift:
                        g(f(p))))
        return out

    # -- compilation -------------------------------------------------------

    def compile(self, env: QuESTEnv, donate: bool = True, fuse: bool = True,
                lookahead: int = 32, pallas: Optional[object] = None,
                supergate_k: int = 4, fusion: Optional[object] = None,
                density: bool = False, comm_planner: Optional[bool] = None,
                overlap: bool = False, reorder: Optional[bool] = None,
                error_budget: Optional[float] = None, tier=None,
                layers: bool = True,
                mxu: Optional[bool] = None) -> "CompiledCircuit":
        """Plan the circuit for ``env``'s device and precision.

        The JAX package's parameters, in its order:

        - ``donate``: True (the default) runs :meth:`CompiledCircuit.apply`
          IN PLACE on the caller's planes, the port's form of a donated
          buffer; False works on a copy and leaves the caller's tensor as
          it was. ``run(qureg)`` updates the register either way.
        - ``pallas`` is the fused-layer pass: None or True (the default)
          on, with the layer kernel on the card and its plain version on
          the CPU; False (or ``"0"``/``"off"``) off, as ``layers=False``;
          ``"interpret"`` the plain version on a CPU env, and on a CUDA
          env it raises ``ValueError`` (no path on the card takes a plain
          version).
        - ``lookahead``, ``comm_planner``, ``overlap`` and ``reorder`` steer
          the layout planner on a mesh env (``parallel/layout.py``): the
          relayout window, the communication-aware mode (None = on), the
          slab double-buffered relayout+gate pairs, and the multi-host
          eviction re-pairing. On one device there is nothing to plan and
          they have no effect.
        - ``fusion`` is the gate-fusion support cap k (None = default 3,
          0/False = off).
        - ``density=True`` compiles the program for a DENSITY register of
          ``num_qubits`` qubits: the 2n-qubit lifted program
          (:meth:`_lifted_density`, channels as superoperators), planned and
          run like any other, so its uncontrolled gates on qubits whose
          lifted pair fits the kernel's tile go through the layer kernel.
          Static channels are validated as CPTP at the env's precision
          here. Without it, a circuit with channels is rejected.
        - ``error_budget`` is the precision-tier dial: state the max
          amplitude error the results may carry and the CHEAPEST tier whose
          modeled error (drift per gate x recorded gates,
          :func:`quest_tpu_torch.profiling.modeled_tier_error`) fits is
          chosen; an unmeetable budget raises ``ValueError`` here. ``tier``
          pins a rung explicitly (a ``PrecisionTier`` or its name). Both
          default to the environment's precision.

        The port's own, after them: ``layers`` turns the fused-layer pass
        on (the default) or off; ``mxu`` forces the packed ``rowmxu``
        contraction on (True) or off (False); None lets the H100 rate model
        decide (:func:`quest_tpu_torch.parallel.layout.
        choose_mxu_contraction`)."""
        if density:
            for op in self.ops:
                if op.kind == "kraus" and not callable(op.kraus):
                    val.validate_kraus_ops(op.kraus, len(op.targets),
                                           "Circuit.kraus",
                                           env.precision.eps)
            circ = self._lifted_density()
        else:
            if any(op.kind == "kraus" for op in self.ops):
                raise ValueError(
                    "circuit contains Kraus channels; compile with "
                    "density=True and run on a density register")
            circ = self
        if tier is None and error_budget is not None:
            from .profiling import choose_tier, engine_tiers
            # compile-time tiers pin run()/apply() too, which have no dd
            # form: QUAD stays a per-dispatch rung (a sweep's tier=)
            ladder = [t for t in engine_tiers(env) if t.name != "quad"]
            tier = choose_tier(float(error_budget), max(len(circ.ops), 1),
                               env, tiers=ladder)
        cc = CompiledCircuit(circ, env, donate=donate, fuse=fuse,
                             lookahead=lookahead, pallas=pallas,
                             supergate_k=supergate_k, fusion=fusion,
                             comm_planner=comm_planner, overlap=overlap,
                             reorder=reorder, tier=tier, layers=layers,
                             mxu=mxu)
        cc.is_density = density
        cc.error_budget = error_budget
        return cc

    def compile_dd(self, env: QuESTEnv, dtype=None):
        """Compile to the double-double amplitude path
        (:class:`~quest_tpu_torch.ops.doubledouble.DDProgram`): each
        amplitude component is an unevaluated hi+lo pair of ``dtype``
        floats, on the env's device. ``dtype`` defaults to the env's real
        dtype: float32 planes give a ~48-bit significand, float64 planes
        ~106 bits (the reference's quad build analogue). Raises
        ``ValueError`` for ops outside the dd subset (parameterised or
        multi-target dense gates). On a mesh env the program's planes are
        chunks over the mesh, scheduled by the layout planner (a register
        smaller than the mesh stays whole on the first shard, as a
        ``Qureg`` does)."""
        from .ops.doubledouble import DDProgram
        if dtype is None:
            dtype = np.float32 if env.precision.real_dtype == torch.float32 \
                else np.float64
        mesh = env.mesh if env.mesh is not None \
            and (1 << self.num_qubits) >= env.num_devices else None
        return DDProgram(list(self.ops), self.num_qubits, dtype=dtype,
                         device=env.device, mesh=mesh)

    def compile_trajectories(self, env: QuESTEnv,
                             pallas=None) -> "TrajectoryProgram":
        """Lower to a quantum-trajectory program: channels applied
        stochastically to STATE VECTORS (Monte-Carlo wavefunction), so a
        noisy n-qubit circuit costs 2^n amplitudes per trajectory
        (``ops/trajectories.py``). Static gate runs go through the batched
        layer kernel and channels on lane qubits through the fused Kraus
        kernel on the card; on the CPU their plain versions run.
        ``pallas`` as in :meth:`compile`: False runs the program with no
        layer and no Kraus kernel, ``"interpret"`` their plain versions
        on a CPU env (it raises on the card)."""
        from .ops.trajectories import TrajectoryProgram
        return TrajectoryProgram(self, env, pallas=pallas)

    # -- composition -------------------------------------------------------

    def pauli_string(self, paulis: Sequence[tuple[int, int]]) -> "Circuit":
        """Apply a product of Pauli operators [(qubit, code)] (code: 1=X,
        2=Y, 3=Z)."""
        for q, code in paulis:
            code = int(code)
            if code == int(PauliOpType.PAULI_X):
                self.x(q)
            elif code == int(PauliOpType.PAULI_Y):
                self.y(q)
            elif code == int(PauliOpType.PAULI_Z):
                self.z(q)
        return self

    def to_qasm(self, params: Optional[dict] = None) -> str:
        """Serialise the recorded program as OpenQASM 2.0 text, through the
        same logger (and so the same dialect) as the imperative API's
        recorder. Parametrised gates are bound with ``params`` first. Ops
        with no QASM form (k >= 2 dense unitaries, general diagonals,
        channels) are logged as comments, as the reference's logger
        handles its own non-expressible ops (``QuEST.c:634-637``)."""
        from .qasm import QASMLogger, _pair_and_phase_from_unitary
        log = QASMLogger(self.num_qubits)
        log.is_logging = True
        params = params or {}
        missing = [p for p in self.param_names if p not in params]
        if missing:
            raise ValueError(f"missing circuit parameters: {missing}")
        named_u = (("sigma_x", mats.pauli_x()),
                   ("sigma_y", mats.pauli_y()),
                   ("sigma_z", mats.pauli_z()),
                   ("hadamard", mats.hadamard()),
                   ("s", mats.s_gate()),
                   ("t", mats.t_gate()))
        for op in self.ops:
            if op.kind == "kraus":
                log.record_comment(
                    f"Kraus channel on qubits {list(op.targets)} "
                    "(no QASM form)")
                continue
            if op.kind == "diag":
                d = np.asarray(op.diag_fn(params)) \
                    if op.diag_fn is not None else op.diag
                if self._emit_diag_qasm(log, op.targets, d):
                    continue
                log.record_comment(
                    f"{len(op.targets)}-qubit general diagonal on qubits "
                    f"{list(op.targets)} (no QASM form)")
                continue
            controls = tuple(q for q in range(self.num_qubits)
                             if (op.ctrl_mask >> q) & 1)
            if len(op.targets) != 1:
                log.record_comment(
                    f"{len(op.targets)}-qubit unitary on qubits "
                    f"{list(op.targets)}"
                    + (f" controls {list(controls)}" if controls else "")
                    + " (no single-qubit QASM form)")
                continue
            mat = np.asarray(op.mat_fn(params)) \
                if op.mat_fn is not None else op.mat
            named = next((label for label, ref in named_u
                          if np.allclose(mat, ref, atol=1e-12)), None)
            flips = tuple(c for c in controls if (op.flip_mask >> c) & 1)
            for c in flips:              # controlled-on-0: NOT sandwich
                log.record_gate("sigma_x", c)
            if named is not None:
                # exact label (cx/ccz/...), never the lossy ZYZ split
                log.record_gate(named, op.targets[0], controls)
            else:
                alpha, beta, g = _pair_and_phase_from_unitary(mat)
                log.record_compact_unitary(alpha, beta, op.targets[0],
                                           controls)
                if controls and abs(g) > 1e-12:
                    # the dropped phase is physical under controls:
                    # c^{n-1}u1(g) on the controls restores it exactly
                    log.record_u1(g, controls[0], controls[1:])
            for c in flips:
                log.record_gate("sigma_x", c)
        return log.text()

    @staticmethod
    def _emit_diag_qasm(log, targets, d) -> bool:
        """Emit a recorded diagonal exactly when the dialect can express
        it: multi-controlled Z / phase (all-ones except the last entry),
        1q relative phases (u1), the 2q multiRotateZ parity form (rzz), and
        any unit-modulus diagonal on up to 4 qubits as one phase term per
        qubit subset. Returns False otherwise."""
        flat = np.asarray(d).reshape(-1)
        if not np.allclose(np.abs(flat), 1.0, atol=1e-12):
            return False
        lo = min(targets)
        rest = tuple(q for q in targets if q != lo)
        if np.allclose(flat[:-1], 1.0, atol=1e-12):
            # targets are sorted descending, so flat[-1] is the all-ones
            # bit pattern: a (multi-controlled) phase on the joint 1-state
            if abs(flat[-1] + 1.0) < 1e-12:
                log.record_gate("sigma_z", lo, rest)
            else:
                log.record_u1(float(np.angle(flat[-1])), lo, rest)
            return True
        if len(targets) == 1:
            # diag(a, b) = a * diag(1, b/a): the relative phase is exact,
            # the global factor a is dropped (as every ZYZ record does)
            log.record_u1(float(np.angle(flat[1] / flat[0])), targets[0])
            return True
        if len(targets) == 2 and abs(flat[0] - flat[3]) < 1e-12 \
                and abs(flat[1] - flat[2]) < 1e-12 \
                and abs(flat[1] - np.conj(flat[0])) < 1e-12:
            log.record_rzz(float(-2.0 * np.angle(flat[0])),
                           targets[1], targets[0])
            return True
        if len(targets) <= 4:
            # a unit-modulus diagonal factors exactly (up to the dropped
            # global flat[0]) into one phase term per nonempty qubit
            # subset S: theta_S is the angle of the Mobius-alternating
            # product of entries over sub-patterns of S, each term a
            # c^{|S|-1}u1. Bit j of the flat index is qubit asc[j]
            k = len(targets)
            asc = sorted(targets)
            for s in range(1, 1 << k):
                prod = 1.0 + 0.0j
                for m in range(1 << k):
                    if m & ~s:
                        continue
                    term = complex(flat[m])
                    if (bin(s ^ m).count("1")) % 2:
                        prod /= term
                    else:
                        prod *= term
                theta = float(np.angle(prod))
                if abs(theta) > 1e-12:
                    qs = [asc[j] for j in range(k) if (s >> j) & 1]
                    log.record_u1(theta, qs[0], tuple(qs[1:]))
            return True
        return False

    def extend(self, other: "Circuit") -> "Circuit":
        """Append ``other``'s ops (and declare its parameters), in place."""
        if other.num_qubits != self.num_qubits:
            raise ValueError("qubit count mismatch")
        self._wire = self._wire_rows() + other._wire_rows()
        self.ops.extend(other.ops)
        for n in other._params:
            if n not in self._params:
                self._params.append(n)
        return self

    def inverse(self) -> "Circuit":
        """Dagger of a *static* circuit (parametrised ops unsupported)."""
        inv = Circuit(self.num_qubits)
        for op in reversed(self.ops):
            if not op.is_static:
                raise ValueError("cannot invert a parameterized circuit")
            if op.kind == "kraus":
                raise ValueError(
                    "cannot invert a circuit containing channels "
                    "(CPTP maps are not generally invertible)")
            if op.kind == "u":
                inv.ops.append(dataclasses.replace(op, mat=op.mat.conj().T))
            else:
                inv.ops.append(dataclasses.replace(op, diag=op.diag.conj()))
        return inv

    @property
    def depth(self) -> int:
        return len(self.ops)


def _peephole_fused(ops: Sequence[_Op], diag_row_cap: int = -1) -> list:
    """Host-side peephole fusion over static gates: consecutive static
    diagonals merge (union of qubits, at most 6, and at most
    ``diag_row_cap`` row qubits when >= 0 so merged factors stay
    layer-eligible); consecutive static unitaries with identical (targets,
    controls) merge by matrix product."""
    fused: list = []
    for op in ops:
        if fused and op.is_static and fused[-1].is_static:
            prev = fused[-1]
            if (op.kind == "u" and prev.kind == "u"
                    and op.targets == prev.targets
                    and op.ctrl_mask == prev.ctrl_mask
                    and op.flip_mask == prev.flip_mask):
                fused[-1] = dataclasses.replace(prev, mat=op.mat @ prev.mat)
                continue
            if op.kind == "diag" and prev.kind == "diag":
                union = tuple(sorted(set(op.targets) | set(prev.targets),
                                     reverse=True))
                if len(union) <= 6 and (
                        diag_row_cap < 0
                        or sum(q >= 7 for q in union) <= diag_row_cap):
                    def expand(o):
                        shape = tuple(2 if q in o.targets else 1
                                      for q in union)
                        return o.diag.reshape(shape)
                    fused[-1] = _Op("diag", union,
                                    diag=expand(prev) * expand(op))
                    continue
        fused.append(op)
    return fused


def _group_supergates(ops: list, max_k: int = 4, fold_diags: bool = True,
                      barrier=None) -> list:
    """Merge consecutive static gates into k-qubit super-gates: L gates
    whose combined support fits in ``max_k`` qubits collapse into one
    ``2^k x 2^k`` operator, one pass instead of L. Parameterized ops,
    LayerOps and ops matching ``barrier`` break groups."""
    if max_k < 2:
        return ops
    from .core.fusion import compose_in_support, op_support

    out: list = []
    group: list = []
    support: set = set()

    def flush():
        nonlocal support
        if len(group) <= 1:
            out.extend(group)
        else:
            sup = tuple(sorted(support))
            out.append(_Op("u", sup, 0, 0,
                           mat=compose_in_support(group, sup)))
        group.clear()
        support = set()

    kinds = ("u", "diag") if fold_diags else ("u",)
    for op in ops:
        if (getattr(op, "kind", None) not in kinds or not op.is_static
                or (barrier is not None and barrier(op))):
            flush()
            out.append(op)
            continue
        qs = set(op_support(op))
        if len(qs) > max_k:
            flush()
            out.append(op)
            continue
        if len(support | qs) > max_k:
            flush()
        group.append(op)
        support |= qs
    flush()
    return out


def _mxu_policy(enabled: bool, itemsize: int, force: Optional[bool],
                fast: bool = False):
    """The layer collector's packed-contraction policy: None (off) or a
    dict with the memoized per-gate crossover ``decide(row_bits,
    gate_qubits)`` and the row-bit ``cap`` — one table shared by
    ``_layer_eligible`` and ``_LayerAccum.try_add``, so the fence and the
    collector never disagree about which gates ``rowmxu`` claims. ``fast``
    (the tier's FAST flag) prices the packed side at the bf16 tensor-core
    rate."""
    if not enabled:
        return None
    from .parallel.layout import MXU_ROW_CAP, choose_mxu_contraction
    memo: dict = {}

    def decide(row_bits: int, gate_qubits: int) -> bool:
        k = (row_bits, gate_qubits)
        if k not in memo:
            memo[k] = choose_mxu_contraction(row_bits, gate_qubits,
                                             itemsize, force,
                                             fast)["use_mxu"]
        return memo[k]

    return {"decide": decide, "cap": MXU_ROW_CAP}


class _LayerAccum:
    """Stage accumulator for one layer run (ops at PHYSICAL coordinates of
    a ``num_local``-qubit state).

    ``try_add`` either absorbs an op into the stage list (merging with
    compatible adjacent stages) and returns True, or rejects it untouched.
    Lane masks are over the 128-lane index, row masks over the row index
    (bit p = qubit p+7). ``mxu`` (a :func:`_mxu_policy` dict) turns on
    packed ``rowmxu`` contractions for dense uncontrolled gates.
    """

    LANE_MASK = (1 << lk.LANE_QUBITS) - 1

    def __init__(self, num_local: int, hi: int, mxu=None):
        self.num_local = num_local
        self.hi = hi
        self.mxu = mxu
        self.stages: list = []
        self.members = 0
        self.src_items: list = []

    def _append_lane(self, m: np.ndarray) -> None:
        # merge backward across row stages that do not read lane bits
        # (disjoint axes commute); stop at anything lane-coupled
        i = len(self.stages) - 1
        while i >= 0:
            st = self.stages[i]
            if st[0] == "lane":
                self.stages[i] = ("lane", m @ st[1])
                return
            if st[0] in ("row", "rowk") and st[3] == 0:
                i -= 1               # lane-blind row stage: commutes
                continue
            if st[0] == "rowmxu" and self.mxu is not None:
                # fold the lane matrix into the open packed operator:
                # kron(I, m) @ op, one (128, 128) product per row block
                # of op (a dense kron product is 2^bits times the work)
                op = st[2]
                self.stages[i] = ("rowmxu", st[1], (m @ op.reshape(
                    -1, m.shape[0], op.shape[1])).reshape(op.shape))
                return
            break
        self.stages.append(("lane", m))

    def _append_rowmxu(self, bits: tuple, phys_targets, mat) -> None:
        prev = self.stages[-1] if self.stages else None
        if prev is not None and prev[0] == "rowmxu":
            union = tuple(sorted(set(bits) | set(prev[1])))
            if len(union) <= self.mxu["cap"]:
                pm = prev[2] if union == prev[1] \
                    else lk.mxu_expand(prev[2], prev[1], union)
                m = lk.mxu_group_matrix(mat, phys_targets, union)
                self.stages[-1] = ("rowmxu", union, m @ pm)
                return
        self.stages.append(
            ("rowmxu", bits, lk.mxu_group_matrix(mat, phys_targets, bits)))

    def _append_row(self, q: int, u: np.ndarray, lane_mask: int,
                    lane_want: int, row_mask: int, row_want: int) -> None:
        if self.stages:
            st = self.stages[-1]
            if (st[0] == "row" and st[1] == q and st[3:] ==
                    (lane_mask, lane_want, row_mask, row_want)):
                self.stages[-1] = ("row", q, np.asarray(u) @ st[2],
                                   lane_mask, lane_want, row_mask, row_want)
                return
        self.stages.append(("row", q, np.asarray(u), lane_mask, lane_want,
                            row_mask, row_want))

    def _append_rowdiag(self, table: np.ndarray, bits: tuple) -> None:
        if self.stages:
            st = self.stages[-1]
            if st[0] == "rowdiag" and st[2] == bits:
                self.stages[-1] = ("rowdiag", st[1] * table, bits)
                return
        self.stages.append(("rowdiag", table, bits))

    def try_add(self, op, phys_targets, cmask, fmask, axis_order) -> bool:
        if getattr(op, "kind", None) not in ("u", "diag") or not op.is_static:
            return False
        lanes = lk.LANE_QUBITS
        if op.kind == "u":
            if cmask >> self.num_local:
                return False
            want = cmask & ~fmask
            lane_cm, lane_want = cmask & self.LANE_MASK, want & self.LANE_MASK
            row_cm, row_want = cmask >> lanes, want >> lanes
            row_t = [t for t in phys_targets if t >= lanes]
            if (self.mxu is not None and cmask == 0 and row_t
                    and len(row_t) <= self.mxu["cap"]
                    and all(t <= self.hi for t in row_t)):
                # packed contraction: fold into an open rowmxu stage for
                # free, else open one when the crossover says it wins
                bits = tuple(sorted(t - lanes for t in row_t))
                prev = self.stages[-1] if self.stages else None
                fold = (prev is not None and prev[0] == "rowmxu"
                        and set(bits) <= set(prev[1]))
                if fold or self.mxu["decide"](len(bits),
                                              len(phys_targets)):
                    self._append_rowmxu(bits, phys_targets, op.mat)
                    self.members += 1
                    return True
            if all(t < lanes for t in phys_targets):
                m = lk.embed_lane_matrix(op.mat, phys_targets, lane_cm,
                                         fmask & self.LANE_MASK)
                if row_cm:
                    self.stages.append(("clane", m, row_cm, row_want))
                else:
                    self._append_lane(m)
            elif (len(phys_targets) == 1
                    and lanes <= phys_targets[0] <= self.hi):
                self._append_row(phys_targets[0], op.mat, lane_cm,
                                 lane_want, row_cm, row_want)
            elif (2 <= len(phys_targets) <= 3
                    and all(lanes <= t <= self.hi for t in phys_targets)):
                # k-qubit dense gate entirely on row bits: "rowk" stage,
                # normalised to ascending bit order (gate-index bit j
                # addresses targets[j])
                k = len(phys_targets)
                order = sorted(range(k), key=lambda j: phys_targets[j])
                bits_asc = tuple(phys_targets[j] - lanes for j in order)
                u = np.asarray(op.mat)
                omap = [sum(((a >> m) & 1) << order[m] for m in range(k))
                        for a in range(1 << k)]
                self.stages.append(("rowk", bits_asc, u[np.ix_(omap, omap)],
                                    lane_cm, lane_want, row_cm, row_want))
            else:
                return False
            self.members += 1
            return True
        # diagonal: phys_targets is sorted-desc; position-indifferent, so
        # ANY row bit works (no hi bound) — but at most three row bits
        if any(p >= self.num_local for p in phys_targets):
            return False
        row_desc = [p for p in phys_targets if p >= lanes]
        if len(row_desc) > 3:
            return False
        d = np.asarray(op.diag)
        if axis_order is not None:
            d = np.transpose(d, axis_order)
        if not row_desc:
            self._append_lane(lk.lane_diag_matrix(d, phys_targets))
            self.members += 1
            return True
        lane_desc = [p for p in phys_targets if p < lanes]
        bits_asc = tuple(sorted(p - lanes for p in row_desc))
        table = np.empty((1 << len(bits_asc), lk.LANES), dtype=np.complex128)
        for cfg in range(1 << len(bits_asc)):
            idx = tuple((cfg >> bits_asc.index(p - lanes)) & 1
                        for p in row_desc)
            table[cfg] = lk.lane_diag_vector(d[idx], lane_desc)
        self._append_rowdiag(table, bits_asc)
        self.members += 1
        return True


def _collect_layers(ops: list, num_qubits: int, tile_rows: int,
                    min_members: int = 2, mxu=None) -> list:
    """Ops-level view of the layer peephole (identity placement): runs of
    eligible static gates become LayerOps; channels flush the run."""
    plan = plan_layout(ops, num_qubits)
    items, new_ops = _collect_layers_plan(plan.items, ops, num_qubits,
                                          tile_rows, min_members, mxu=mxu)
    return [new_ops[item[1]] for item in items]


def _tile_hi(num_local: int, tile_rows: int) -> int:
    total_rows = (1 << num_local) // lk.LANES
    return lk.max_mid_qubit(min(tile_rows, max(total_rows, 1)))


def _collect_layers_plan(items: list, ops: list, num_local: int,
                         tile_rows: int, min_members: int = 2, mxu=None):
    """Post-plan peephole: fuse runs of consecutive op items whose physical
    footprint fits the layer kernel's tile into LayerOps (appended to a
    copy of the ops table). Returns ``(new_items, new_ops)``."""
    if num_local < lk.LANE_QUBITS:
        return items, ops
    hi = _tile_hi(num_local, tile_rows)
    ops = list(ops)
    out: list = []
    acc = _LayerAccum(num_local, hi, mxu)

    def flush():
        nonlocal acc
        if acc.members >= min_members:
            ops.append(lk.LayerOp(num_local, acc.members, acc.stages))
            out.append(("op", len(ops) - 1, (), 0, 0, None))
        else:
            out.extend(acc.src_items)
        acc = _LayerAccum(num_local, hi, mxu)

    for item in items:
        if item[0] != "op":
            # a relayout or cross-shard item: runs never cross it
            flush()
            out.append(item)
            continue
        _, i, pt, cm, fm, ao = item
        if acc.try_add(ops[i], pt, cm, fm, ao):
            acc.src_items.append(item)
            continue
        # rejections are op-intrinsic: no fresh accumulator can take it
        # (a channel is rejected by kind, so it flushes the run)
        flush()
        out.append(item)
    flush()
    return out, ops


def _layer_eligible(op, num_local: int, hi: int, mxu=None) -> bool:
    """Mask/target-only mirror of ``_LayerAccum.try_add``'s accept set,
    cheap enough to run per op during fusion and super-gate grouping."""
    lanes = lk.LANE_QUBITS
    if getattr(op, "kind", None) not in ("u", "diag") or not op.is_static:
        return False
    if op.kind == "u":
        if op.ctrl_mask >> num_local:
            return False
        if (all(t < lanes for t in op.targets)
                or (len(op.targets) == 1 and lanes <= op.targets[0] <= hi)
                or (2 <= len(op.targets) <= 3
                    and all(lanes <= t <= hi for t in op.targets))):
            return True
        if mxu is None or op.ctrl_mask:
            return False
        row_t = [t for t in op.targets if t >= lanes]
        return (bool(row_t) and len(row_t) <= mxu["cap"]
                and all(t <= hi for t in row_t)
                and mxu["decide"](len(row_t), len(op.targets)))
    if any(p >= num_local for p in op.targets):
        return False
    return sum(p >= lanes for p in op.targets) <= 3


def _layer_barrier(ops: Sequence, num_qubits: int, tile_rows: int,
                   mxu=None):
    """Fence set (by op identity) for fusion and super-gate grouping: ops
    the layer pass fuses more cheaply. Only RUNS of >= 2 adjacent
    eligible ops are fenced — an isolated eligible gate cannot form a
    layer and is worth more inside a super-gate. ``hi`` comes from the
    kernel's tile height for the plane dtype."""
    hi = _tile_hi(num_qubits, tile_rows)
    elig = [_layer_eligible(op, num_qubits, hi, mxu) for op in ops]
    fence = set()
    for i, op in enumerate(ops):
        if elig[i] and ((i > 0 and elig[i - 1])
                        or (i + 1 < len(ops) and elig[i + 1])):
            fence.add(id(op))
    return lambda op: id(op) in fence


def _schedule(recorded: Sequence[_Op], num_qubits: int, fuse_flag: bool,
              diag_row_cap: int = -1, shard_bits: int = 0,
              lookahead: int = 32, cost_model=None,
              chunk_bytes: float = 0.0, host_bits: int = 0,
              reorder: bool = True):
    """Peephole-fuse + layout-plan the op stream (the JAX package's
    pure-Python branch). ``cost_model``/``chunk_bytes`` switch the planner
    to its communication-aware mode, ``host_bits``/``reorder`` to the
    two-tier one; with reordering on a multi-host mesh both variants are
    planned and the cheaper by modeled comm seconds is kept, as in the
    JAX package. Returns ``(ops_table, LayoutPlan)``."""
    ops_table = _peephole_fused(recorded, diag_row_cap) if fuse_flag \
        else list(recorded)

    def plan(ro):
        return plan_layout(ops_table, num_qubits, shard_bits,
                           lookahead=lookahead, cost_model=cost_model,
                           chunk_bytes=chunk_bytes, host_bits=host_bits,
                           reorder=ro)

    return ops_table, _best_of_reorder(plan, reorder, cost_model,
                                       chunk_bytes, host_bits)


def _best_of_reorder(plan, reorder: bool, cost_model, chunk_bytes: float,
                     host_bits: int):
    """``plan(reorder)``, or on a multi-host mesh with reordering on, the
    cheaper of ``plan(True)`` and ``plan(False)`` by modeled comm seconds
    (ties: inter-host bytes, then launches): the greedy re-pairing can
    lose, and reordering must never model slower."""
    if cost_model is None or host_bits <= 0 or not reorder:
        return plan(reorder)
    from .parallel.layout import reorder_plan_score
    on, off = plan(True), plan(False)
    if reorder_plan_score(off, chunk_bytes, cost_model, host_bits) < \
            reorder_plan_score(on, chunk_bytes, cost_model, host_bits):
        return off
    return on


def _layers_on(pallas, env: QuESTEnv) -> bool:
    """The JAX package's ``pallas=`` switch on the fused-layer pass: None
    or True on; False, ``"0"`` or ``"off"`` off; ``"interpret"`` on with
    the plain layer version, which only a CPU env runs (no path on the
    card takes a plain version)."""
    if pallas in (False, "0", "off"):
        return False
    if pallas == "interpret" and env.device.type != "cpu":
        raise ValueError(
            "pallas='interpret' runs the layer kernel's plain version, "
            "which the port runs only on the CPU; on the card the kernel "
            "runs (pallas=None) or the layer pass is off (pallas=False)")
    return True


def _param_row(theta: torch.Tensor) -> np.ndarray:
    """A ``(P,)`` parameter tensor as the ``(1, P)`` host float64 row of
    the batched engine."""
    return theta.detach().cpu().numpy().astype(np.float64).reshape(1, -1)


def _reset_circuit_twin(tw) -> None:
    """A shard's twin walks the unsharded plan and keeps its own dispatch
    record."""
    tw._shard_bits = 0
    tw._batch_stats = {}


class CompiledCircuit:
    """A planned :class:`Circuit`: layers and gates in program order,
    applied in place to ``(2, 2^N)`` planes on the env's device, at the
    compile-time precision tier (``tier``; None = the environment's
    precision)."""

    error_budget = None  # set by Circuit.compile(error_budget=...)
    is_density = False   # set by Circuit.compile(density=...)

    def __init__(self, circuit: Circuit, env: QuESTEnv, donate: bool = True,
                 fuse: bool = True, lookahead: int = 32,
                 pallas: Optional[object] = None, supergate_k: int = 4,
                 fusion: Optional[object] = None,
                 comm_planner: Optional[bool] = None, overlap: bool = False,
                 reorder: Optional[bool] = None, tier=None,
                 layers: bool = True, mxu: Optional[bool] = None):
        self.circuit = circuit
        self.env = env
        self.num_qubits = circuit.num_qubits
        self.param_names = circuit.param_names
        self.tier = self._resolve_tier(tier)
        self.donate = bool(donate)
        n = circuit.num_qubits
        # on a mesh the top shard_bits positions index the shard; a
        # register smaller than the mesh stays whole on the first shard
        self._shard_bits = env.num_devices.bit_length() - 1 \
            if env.mesh is not None and (1 << n) >= env.num_devices else 0
        s = self._shard_bits
        comm_on = (comm_planner if comm_planner is not None else True) \
            and s > 0
        from .profiling import comm_model
        self._cost_model = comm_model(env) if comm_on else None
        self._chunk_bytes = 2.0 * env.precision.real_dtype.itemsize \
            * (1 << (n - s))
        from .parallel.multihost import host_topology
        topo = host_topology(env.mesh) if s else None
        self._host_bits = min(topo.host_bits, s) if topo and comm_on else 0
        self._num_hosts = topo.num_hosts if topo else 1
        self._reorder = True if reorder is None else bool(reorder)
        self._lookahead = int(lookahead)
        self._overlap = bool(overlap)
        self._comm_stats = None
        self._warned_nondivisible = False
        self._compile_opts = {"fuse": fuse,
                              "layers": layers and _layers_on(pallas, env),
                              "supergate_k": supergate_k, "fusion": fusion,
                              "mxu": mxu}
        # plain ops' operators already on the device, per (plan key, op
        # index): filled by precompile(), else at an op's first run
        self._dev_operators: dict = {}
        # collected plans per (plane dtype, FAST flag): the compile-time
        # tier's now, a per-dispatch tier's at its first dispatch; and the
        # adjoint walks over them, at a tier's first gradient sweep
        self._plans: dict = {}
        self._walks: dict = {}
        # the health guard's cadence counter (run() may be called from
        # several threads)
        self._stats_lock = threading.Lock()
        self._health_counter = 0
        self.plan, self._ops, self.fusion_stats = self._plan_for(
            self.tier, sharded=True)
        self.tile_rows = lk.tile_rows_for(
            self._tier_dtypes(self.tier, env)[0])

    def _plan_for(self, tier, sharded: bool = False):
        """``(plan, ops, fusion_stats)`` of the layer plan a tier executes:
        built once per (plane dtype, FAST flag, layers, shard bits) — the
        tile height follows the plane dtype and the crossover the FAST
        flag — and kept. ``sharded`` asks for the mesh plan (relayouts,
        layers on the chunk's qubits); the batched engine's whole-state
        rows and every program off a mesh walk the unsharded one."""
        key = self._plan_key(tier, sharded)
        if key not in self._plans:
            self._plans[key] = self._build_plan(*key)
        return self._plans[key]

    def _plan_key(self, tier, sharded: bool = False) -> tuple:
        """``(plane dtype, FAST flag)``, then ``layers`` and ``shard_bits``
        where they differ from True and 0: the positional arguments of
        :meth:`_build_plan`."""
        key = (self._tier_dtypes(tier, self.env)[0],
               self._tier_exec_mode(tier)[1])
        # the QUAD rung walks a layer-free plan (``layers=False``): the
        # layer kernel has no dd form
        layers = not (tier is not None and tier.name == "quad")
        if sharded and self._shard_bits:
            return key + (layers, self._shard_bits)
        return key if layers else key + (False,)

    def _build_plan(self, dtype: torch.dtype, fast: bool,
                    layers: bool = True, shard_bits: int = 0,
                    comm: bool = True):
        """record -> FUSE -> schedule -> supergate -> collect layers, for
        planes of ``dtype`` (the kernel's tile height) with the crossover
        priced for the FAST tier or not; ``layers=False`` collects no
        layers (the QUAD rung's plan). ``shard_bits > 0`` plans for the
        mesh as the JAX package's ``build_pipeline`` does
        (``circuits.py:1641-1800``): fusion and super-gates capped at the
        chunk's local qubits, SWAPs fenced where the communication planner
        absorbs them, diagonals kept out of super-gates, and layers
        collected on the chunk's ``n - s`` qubits between relayouts;
        ``comm=False`` plans with the count-based planner (the baseline
        ``dispatch_stats`` measures the saved bytes against)."""
        from .core.fusion import fuse_ops, resolve_fusion_k

        opts = self._compile_opts
        n = self.num_qubits
        s = shard_bits
        lt = n - s
        tile_rows = lk.tile_rows_for(dtype)
        use_layers = bool(opts["layers"]) and layers \
            and lt >= lk.LANE_QUBITS
        mxu_policy = _mxu_policy(use_layers, dtype.itemsize, opts["mxu"],
                                 fast)
        diag_cap = 3 if use_layers else -1
        cm = self._cost_model if comm and s else None
        hb = self._host_bits if cm is not None else 0

        def fence(base):
            # an absorbed SWAP costs nothing; welded into a group it
            # costs a pass and may force relayouts
            if cm is None:
                return base
            if base is None:
                return is_swap_op
            return lambda op: is_swap_op(op) or base(op)

        recorded = list(self.circuit.ops)
        fusion_stats = None
        k_fuse = resolve_fusion_k(opts["fusion"], lt)
        if k_fuse >= 2:
            barrier = fence(_layer_barrier(recorded, lt, tile_rows,
                                           mxu_policy)
                            if use_layers else None)
            recorded, fusion_stats = fuse_ops(
                recorded, max_k=k_fuse, diag_row_cap=diag_cap,
                barrier=barrier)
        ops, plan = _schedule(recorded, n, opts["fuse"],
                              diag_row_cap=diag_cap, shard_bits=s,
                              lookahead=self._lookahead, cost_model=cm,
                              chunk_bytes=self._chunk_bytes, host_bits=hb,
                              reorder=self._reorder)
        supergate_k = min(opts["supergate_k"], lt) if s \
            else opts["supergate_k"]
        if supergate_k >= 2:
            before = len(ops)
            ops = _group_supergates(
                ops, supergate_k, fold_diags=(s == 0),
                barrier=fence(_layer_barrier(ops, lt, tile_rows, mxu_policy)
                              if use_layers else None))
            if len(ops) != before:
                plan = _best_of_reorder(
                    lambda ro: plan_layout(
                        ops, n, s, lookahead=self._lookahead,
                        cost_model=cm, chunk_bytes=self._chunk_bytes,
                        host_bits=hb, reorder=ro),
                    self._reorder, cm, self._chunk_bytes, hb)
        if use_layers:
            items, ops = _collect_layers_plan(plan.items, ops, lt, tile_rows,
                                              mxu=mxu_policy)
            # prune the table to executed ops (fused members are
            # superseded by their LayerOp)
            ref = sorted({it[1] for it in items
                          if it[0] in ("op", "xshard")})
            remap = {old: new for new, old in enumerate(ref)}
            ops = [ops[i] for i in ref]
            items = [(it[0], remap[it[1]], *it[2:])
                     if it[0] in ("op", "xshard") else it for it in items]
            plan = LayoutPlan(items, n, s, plan.num_relayouts,
                              num_xshard=plan.num_xshard,
                              swaps_absorbed=plan.swaps_absorbed,
                              collectives_fused=plan.collectives_fused)
        return plan, ops, fusion_stats

    # -- precision tiers -----------------------------------------------------

    def _resolve_tier(self, tier, dispatch: bool = False):
        """Validate a tier request (None passes through); ``dispatch``
        marks a per-dispatch request (sweep/expectation_sweep/
        sample_sweep) as opposed to the compile-time tier. QUAD runs on
        double-double planes through the batched engine's dd walk
        (:meth:`_run_dd_batched`) as a per-dispatch tier only, and needs
        an f64-storage env: results leave the engine as env-dtype planes,
        so on an f32 env the ~2^-49-significand dd values would round
        straight back to f32 and the tier would quietly deliver SINGLE
        accuracy. DOUBLE needs an f64-storage environment for the same
        reason."""
        if tier is None:
            return None
        tier = tier_by_name(tier)
        if tier.name == "quad":
            if not dispatch:
                raise ValueError(
                    "the QUAD tier is a per-DISPATCH rung: pass "
                    "tier='quad' to sweep/expectation_sweep/"
                    "sample_sweep — a compile-time quad tier would pin "
                    "run()/apply() to the plan, which has no dd form; "
                    "for static circuits Circuit.compile_dd is the "
                    "whole-program dd path")
            if self.env.precision.real_dtype != torch.float64:
                raise ValueError(
                    "the QUAD tier's double-double planes recombine to "
                    "env-dtype planes at the engine boundary: it needs "
                    "an f64-storage environment (precision=DOUBLE) so "
                    "the ~48-bit significand survives the exit; on this "
                    "env use Circuit.compile_dd (static circuits) "
                    "instead")
            return tier
        if tier.real_dtype == torch.float64 and \
                self.env.precision.real_dtype != torch.float64:
            raise ValueError(
                "the DOUBLE tier needs an f64-storage environment: results "
                "are returned as env-dtype planes, so on this f32 env the "
                "f64 execution would round back to f32 on exit — create "
                "the env with precision=DOUBLE")
        return tier

    def _effective_tier(self, tier):
        """The tier one dispatch runs at: the per-call override, else the
        compile-time tier, else None (the environment's precision)."""
        if tier is None:
            return self.tier
        return self._resolve_tier(tier, dispatch=True)

    @staticmethod
    def _tier_exec_mode(tier) -> tuple:
        """(matmul precision, FAST flag) for one tier: the ONE definition
        of the tier -> execution-mode rule, shared by ``run``/``apply`` and
        the batched engine."""
        fast = tier is not None and tier.matmul_precision == "default"
        return ("default" if fast else None), fast

    @staticmethod
    def _tier_token(tier) -> str:
        """A tier's key component (its name, ``"env"`` for the
        environment's precision): the serving coalescer's tier dimension
        and the dispatch profiler's key, one definition for both."""
        return tier.name if tier is not None else "env"

    @staticmethod
    def _dtype_token(dtype: torch.dtype) -> str:
        """A plane dtype's name as the JAX package writes it into its keys
        (``"float32"``, ``"float64"``)."""
        return str(dtype).replace("torch.", "")

    @staticmethod
    def _tier_dtypes(tier, env) -> tuple:
        """(real, complex) EXECUTION dtypes for one dispatch. QUAD's
        planes are float32 dd pairs, but its engine boundary is float64:
        casting the entry states to float32 would destroy the precision
        the dd split is about to keep."""
        if tier is not None and tier.name == "quad":
            return torch.float64, torch.complex128
        rdt = tier.real_dtype if tier is not None \
            else env.precision.real_dtype
        return rdt, (torch.complex64 if rdt == torch.float32
                     else torch.complex128)

    def _modeled_tier_error(self) -> float:
        """The budget model's per-run error bound for the compile-time
        tier (0.0 when no tier is selected)."""
        if self.tier is None:
            return 0.0
        from .profiling import modeled_tier_error
        return float(modeled_tier_error(self.tier,
                                        max(len(self.circuit.ops), 1)))

    @property
    def num_layers(self) -> int:
        return sum(1 for op in self._ops if op.kind == "layer")

    def _params(self, params: Optional[dict]) -> dict:
        params = dict(params or {})
        missing = [p for p in self.param_names if p not in params]
        if missing:
            raise ValueError(f"missing circuit parameters {missing}")
        return params

    def _static_operator(self, i: int, op, axis_order, dtype, device):
        """A static plain op's operator on the device, in the complex dtype
        of ``dtype`` planes: its matrix, or its diagonal factor in the
        plan's axis order; made once and kept."""
        key = (dtype, device, i)
        t = self._dev_operators.get(key)
        if t is None:
            cdt = torch.complex64 if dtype == torch.float32 \
                else torch.complex128
            host = op.mat if op.kind == "u" else np.transpose(
                np.asarray(op.diag), axis_order)
            t = torch.as_tensor(np.ascontiguousarray(host), dtype=cdt,
                                device=device)
            self._dev_operators[key] = t
        return t

    def apply(self, state_f, params: Optional[dict] = None):
        """Run the plan on ``(2, 2^N)`` planes at the compile-time tier and
        return the result: IN PLACE on ``state_f`` when the program was
        compiled with ``donate=True`` (the default), else on a copy, which
        leaves the caller's tensor as it was. Planes of another dtype than
        the tier's are cast in and the result copied back. A program
        compiled on a mesh takes the register's chunks instead (a list of
        ``(2, 2^(N-s))`` tensors, shard by shard, in canonical order) and
        returns the list."""
        n = self.num_qubits
        if self._shard_bits:
            if not isinstance(state_f, (list, tuple)) or \
                    len(state_f) != self.env.num_devices:
                raise ValueError(
                    "a program compiled on a mesh applies to the "
                    f"register's {self.env.num_devices} chunks (a list, "
                    "shard by shard); run(qureg) passes them")
            chunks = list(state_f) if self.donate else \
                [c.clone() for c in state_f]
            self._run_chunks(chunks, self._params(params))
            return chunks
        if tuple(state_f.shape) != (2, 1 << n):
            raise ValueError(f"planes have shape {tuple(state_f.shape)}; "
                             f"this circuit needs (2, {1 << n})")
        params = self._params(params)
        planes = state_f if self.donate else state_f.clone()
        prec, fast = self._tier_exec_mode(self.tier)
        rdt = self._tier_dtypes(self.tier, self.env)[0]
        work = planes if planes.dtype == rdt else planes.to(rdt)
        for _, i, phys_targets, cmask, fmask, axis_order in self.plan.items:
            op = self._ops[i]
            if op.kind == "layer":
                lk.apply_layer(work, n, op, fast=fast)
                continue
            operator = self._item_operator(op, i, axis_order, params, rdt,
                                           work.device)
            if op.kind == "u":
                apply_unitary(work, n, operator, phys_targets, cmask, fmask,
                              precision=prec)
            else:
                apply_diagonal(work, n, phys_targets, operator)
        if work is not planes:
            planes.copy_(work)
        return planes

    def _item_operator(self, op, i: int, axis_order, params: dict, rdt,
                       device):
        """A plain op's operator for one run: the cached device tensor of
        a static op (a diagonal already in the plan's axis order), else
        the bound matrix or diagonal (numpy)."""
        if op.is_static:
            return self._static_operator(i, op, axis_order, rdt, device)
        if op.kind == "u":
            return np.asarray(op.mat_fn(params), dtype=np.complex128)
        return np.ascontiguousarray(np.transpose(
            np.asarray(op.diag_fn(params)), axis_order))

    def _exchange_plans(self, plan) -> dict:
        """The exchange choreography of each relayout item of ``plan``
        (by item index), made once per plan."""
        cache = self.__dict__.setdefault("_ex_plans", {})
        if id(plan) not in cache:
            n, s = self.num_qubits, plan.shard_bits
            cache[id(plan)] = (plan, {
                j: ex.plan_exchange(n, s, it[1], it[2])
                for j, it in enumerate(plan.items) if it[0] == "relayout"})
        return cache[id(plan)][1]

    def _overlap_pairs(self, plan, ops, expl: dict) -> set:
        """Relayout items run fused with the dense gate right after them
        (``compile(overlap=True)``; the JAX package's rule: no
        post-transpose, the gate away from the slab bit)."""
        pairs = set()
        if not self._overlap:
            return pairs
        items = plan.items
        for j, it in enumerate(items):
            if it[0] != "relayout" or j + 1 >= len(items):
                continue
            nxt = items[j + 1]
            if nxt[0] == "op" and getattr(ops[nxt[1]], "kind", None) == "u" \
                    and ex.overlap_eligible(expl[j], nxt[2], nxt[3]):
                pairs.add(j)
        return pairs

    def _run_chunks(self, chunks: list, params: dict) -> list:
        """The local body on every shard (the JAX package's ``shard_map``
        program, ``circuits.py:1869-1963``), IN PLACE on the list of
        chunks: layers through the layer kernel on each chunk's ``n - s``
        qubits, plain ops on each chunk (a device-bit control as a
        per-shard skip, a diagonal's device-bit axes sliced per shard),
        relayouts and cross-shard items through ``parallel/exchange.py``.
        Chunks of another dtype than the tier's are cast in and copied
        back."""
        plan, ops = self.plan, self._ops
        s = plan.shard_bits
        lt = self.num_qubits - s
        prec, fast = self._tier_exec_mode(self.tier)
        rdt = self._tier_dtypes(self.tier, self.env)[0]
        work = chunks if chunks[0].dtype == rdt else [c.to(rdt)
                                                      for c in chunks]
        expl = self._exchange_plans(plan)
        fused = self._overlap_pairs(plan, ops, expl)
        dev = work[0].device
        skip = False
        for j, item in enumerate(plan.items):
            if skip:
                skip = False
                continue
            if item[0] == "relayout":
                if j in fused:
                    _, i, pt, cm, fm, ao = plan.items[j + 1]
                    u = self._item_operator(ops[i], i, ao, params, rdt, dev)
                    ex.run_exchange_overlapped(work, expl[j], u, pt, cm, fm,
                                               precision=prec)
                    skip = True
                else:
                    ex.run_exchange(work, expl[j])
                continue
            _, i, pt, cm, fm, ao = item
            op = ops[i]
            if op.kind == "layer":
                # by index: a loop variable would keep the last chunk
                # alive through the next relayout's out-of-place
                # transposes, a second chunk of scratch
                for d in range(len(work)):
                    lk.apply_layer(work[d], lt, op, fast=fast)
                continue
            operator = self._item_operator(op, i, ao, params, rdt, dev)
            if item[0] == "xshard":
                ex.apply_1q_cross_shard(work, operator, pt[0], lt, s, cm, fm,
                                        precision=prec)
            elif op.kind == "u":
                ex.apply_op_local(work, "u", operator, pt, cm, fm, lt,
                                  precision=prec)
            else:
                ex.apply_op_local(work, "diag", operator, pt, 0, 0, lt)
        if work is not chunks:
            for c, w in zip(chunks, work):
                c.copy_(w)
        return chunks

    def precompile(self) -> "CompiledCircuit":
        """Do the first run's setup ahead of it, with no state: on the card,
        build the kernels' libraries (``layer_kernel.build_library``) and
        pack every layer's operands for the compile-time tier (cached on
        the layer); on any device, put the plain ops' static operators on
        the device. On the CPU nothing is packed for the kernel. Returns
        ``self``: ``cc = circ.compile(env).precompile()``."""
        rdt = self._tier_dtypes(self.tier, self.env)[0]
        _, fast = self._tier_exec_mode(self.tier)
        device = self.env.device
        on_card = device.type == "cuda"
        if on_card:
            lk.build_library()
        num_local = self.num_qubits - self.plan.shard_bits
        devices = set(self.env.mesh.devices) if self.plan.shard_bits \
            else {device}
        for item in self.plan.items:
            if item[0] == "relayout":
                continue
            _, i, _, _, _, axis_order = item
            op = self._ops[i]
            if op.kind == "layer":
                if on_card:
                    for dev in devices:
                        lk.pack_layer(op, num_local, rdt, dev, fast)
            elif op.is_static:
                self._static_operator(i, op, axis_order, rdt, device)
        return self

    def dispatch_stats(self):
        """Dispatch accounting (:class:`quest_tpu_torch.profiling.
        DispatchStats`): recorded gates in, kernels out (the plan's layers
        and plain ops), planned relayouts, the gate-fusion pass's
        counters, the communication planner's accounting on a mesh
        (cross-shard items, absorbed SWAPs, composed exchanges, the
        modeled exchange bytes per run and those saved against the
        count-based planner's plan; computed at the first call), and the
        last batched dispatch's record (:meth:`_record_batch_stats`). The
        two executable-cache fields keep their defaults: the port runs
        eagerly and caches no executables."""
        from .profiling import DispatchStats
        fs = self.fusion_stats
        bs = self._batch_stats
        comm = self._comm_accounting()
        return DispatchStats(
            gates_in=self.circuit.depth,
            kernels_out=self.plan.num_kernels,
            relayouts=self.plan.num_relayouts,
            fused_groups=fs.fused_groups if fs else 0,
            diag_folds=fs.diag_folds if fs else 0,
            commuted_diagonals=fs.commuted_diagonals if fs else 0,
            max_group_gates=fs.max_group_gates if fs else 0,
            cross_shard_exchanges=self.plan.num_xshard,
            swaps_absorbed=self.plan.swaps_absorbed,
            collectives_fused=self.plan.collectives_fused,
            comm_bytes_planned=comm["planned"],
            comm_bytes_saved=comm["saved"],
            num_hosts=self._num_hosts,
            inter_host_collectives=comm["inter_launches"],
            comm_bytes_inter_planned=comm["inter_planned"],
            comm_bytes_inter_saved=comm["inter_saved"],
            batch_size=bs.get("batch_size", 0),
            host_syncs_avoided=bs.get("host_syncs_avoided", 0),
            batch_sharding_mode=bs.get("batch_sharding_mode", "none"),
            evolve_steps_fused=bs.get("evolve_steps_fused", 0),
            precision_tier=self.tier.name if self.tier is not None
            else "env",
            modeled_tier_error=self._modeled_tier_error())

    def _comm_accounting(self) -> dict:
        """Modeled exchange bytes of the plan (mesh-total per run) and
        those saved against the count-based planner's plan of the same
        circuit, and the inter-host share: computed once, at the first
        :meth:`dispatch_stats`."""
        with self._stats_lock:
            if self._comm_stats is not None:
                return self._comm_stats
        out = {"planned": 0.0, "saved": 0.0, "inter_planned": 0.0,
               "inter_saved": 0.0, "inter_launches": 0}
        if self.plan.shard_bits:
            from .parallel.layout import plan_comm_stats
            from .profiling import DEFAULT_COMM_MODEL
            model = self._cost_model or DEFAULT_COMM_MODEL
            hb, D = self._host_bits, self.env.num_devices
            tot = plan_comm_stats(self.plan, self._chunk_bytes, model, D,
                                  host_bits=hb)
            out.update(planned=tot["bytes"],
                       inter_planned=tot["inter_bytes"],
                       inter_launches=tot["inter_launches"])
            key = self._plan_key(self.tier, True)
            if self._cost_model is not None:
                base = self._build_plan(*key, comm=False)[0]
                out["saved"] = max(0.0, plan_comm_stats(
                    base, self._chunk_bytes, model, D,
                    host_bits=hb)["bytes"] - tot["bytes"])
                if hb > 0 and self._reorder:
                    reorder, self._reorder = self._reorder, False
                    try:
                        roff = self._build_plan(*key)[0]
                    finally:
                        self._reorder = reorder
                    out["inter_saved"] = max(0.0, plan_comm_stats(
                        roff, self._chunk_bytes, model, D,
                        host_bits=hb)["inter_bytes"] - tot["inter_bytes"])
        with self._stats_lock:
            self._comm_stats = out
        return out

    _digest_cached = None   # lazy program_digest (content-addressed)
    _batch_stats: dict = {}  # the last batched dispatch's record

    def _record_batch_stats(self, batch: int, host_syncs_avoided: int,
                            evolve_steps_fused: int = 0,
                            mode: str = "none") -> None:
        """Record one batched dispatch: its rows, its sharding mode
        (``"none"`` off a mesh, else the mode :meth:`_batch_policy` chose),
        the host synchronisations a per-point client would have paid
        beyond this dispatch's, and the dynamics steps it ran (0 for every
        non-dynamics dispatch). One atomic swap of the whole record, so a
        reader never sees a torn one."""
        self._batch_stats = {"batch_size": batch,
                             "batch_sharding_mode": mode,
                             "host_syncs_avoided": host_syncs_avoided,
                             "evolve_steps_fused": evolve_steps_fused}

    def _bytes_per_pass(self, batch: int = 1, terms: int = 0) -> float:
        """The device traffic of ONE dispatch of this program as the plan
        knows it: every planned item (layer or plain op) streams the re/im
        planes once, read and written, times the batch rows, plus one pass
        per Pauli term for energy dispatches. The dispatch profiler divides
        it by the measured seconds for a live achieved bytes/s and
        ``roofline_frac``."""
        itemsize = self.env.precision.real_dtype.itemsize
        state_bytes = 4.0 * itemsize * (1 << self.num_qubits)
        passes = max(self.plan.num_dispatches, 1) + max(int(terms), 0)
        return passes * max(int(batch), 1) * state_bytes

    def _batch_policy(self, batch: int, mem_factor: float = 1.0) -> dict:
        """The mesh batch-sharding decision for a ``batch``-point ensemble
        (:func:`quest_tpu_torch.parallel.layout.choose_batch_sharding`,
        priced by the compile-time comm model; ``{"mode": "none"}`` off a
        mesh). ``mem_factor=2.0`` is the gradient sweeps' pricing."""
        if not self._shard_bits:
            return {"mode": "none"}
        from .parallel.layout import choose_batch_sharding
        return choose_batch_sharding(
            self.num_qubits, batch, self.env.num_devices,
            self.env.precision.real_dtype.itemsize,
            self.plan.num_relayouts, cost_model=self._cost_model,
            host_bits=self._host_bits, mem_factor=mem_factor)

    def _drift_models(self, mode: str, rows: int, pol: dict) -> dict:
        """The drift-monitor models of one batched dispatch: only ``amp``
        mode pays exchanges, every planned one per row (``comm_plan``) at
        the price the policy modeled (``batch_amp_comm``)."""
        models: dict = {}
        if mode == "amp":
            from .parallel.layout import plan_comm_stats
            from .profiling import DEFAULT_COMM_MODEL
            cps = plan_comm_stats(self.plan, self._chunk_bytes,
                                  self._cost_model or DEFAULT_COMM_MODEL,
                                  host_bits=self._host_bits)["seconds"]
            if cps > 0.0:
                models["comm_plan"] = cps * rows
            if pol.get("amp_comm_seconds", 0.0) > 0.0:
                models["batch_amp_comm"] = pol["amp_comm_seconds"]
        return models

    @property
    def program_digest(self) -> str:
        """Stable content digest of the recorded program
        (:func:`quest_tpu_torch.serve.warmcache.circuit_digest`); for a
        static circuit it equals the JAX package's for the same recording.
        Falls back to a process-local id token when an op resists content
        addressing."""
        if self._digest_cached is None:
            from .serve.warmcache import circuit_digest
            d = circuit_digest(self.circuit, self.is_density)
            self._digest_cached = d or f"id-{id(self):x}"
        return self._digest_cached

    def run(self, qureg: Qureg, params: Optional[dict] = None) -> None:
        """Apply to a register, in place."""
        if qureg.is_density_matrix != self.is_density:
            if self.is_density:
                raise ValueError("this circuit was compiled with "
                                 "density=True; run it on a density register")
            raise ValueError(
                "running a statevector-compiled circuit on a density "
                "register; compile with density=True")
        if qureg.num_qubits_in_state_vec != self.num_qubits:
            raise ValueError(
                f"circuit has {self.num_qubits} qubits; register state "
                f"vector has {qureg.num_qubits_in_state_vec}")
        if qureg.is_quad:
            raise ValueError(
                "QUAD registers hold double-double planes; compile with "
                "Circuit.compile_dd and run on its packed planes, or use "
                "the imperative API (which routes to dd kernels)")
        if qureg.is_sharded != bool(self._shard_bits) or (
                qureg.is_sharded and qureg.env.mesh is not self.env.mesh):
            raise ValueError("the register and the program were made for "
                             "different meshes; compile on the register's "
                             "env")
        if qureg.is_sharded:
            qureg.ensure_canonical()      # drains a pending fusion buffer
            chunks = qureg.chunks
            if chunks[0].dtype != self.env.precision.real_dtype:
                raise ValueError("register precision differs from the "
                                 "circuit's compile-time environment")
            sp = _profile.profile_dispatch("circuits.run")
            with dispatch_annotation(
                    f"quest_tpu_torch.circuits.run:{self.num_qubits}q:"
                    f"mesh{self.env.num_devices}"):
                self._run_chunks(chunks, self._params(params))
            if sp is not None:
                sp.done(None, program=self.program_digest, kind="run",
                        bucket=1, tier=self._tier_token(self.tier),
                        dtype=self._dtype_token(
                            self.env.precision.real_dtype),
                        sharding="amp",
                        bytes_per_pass=self._bytes_per_pass())
            return
        state = qureg.state       # drains a pending fusion buffer
        if state.dtype != self.env.precision.real_dtype:
            raise ValueError("register precision differs from the "
                             "circuit's compile-time environment")
        # the profile span opens BEFORE the fault hook, so an injected
        # stall lands inside the measured time
        sp = _profile.profile_dispatch("circuits.run")
        poison = _faults.fire("circuits.run")
        with dispatch_annotation(
                f"quest_tpu_torch.circuits.run:{self.num_qubits}q"):
            out = self.apply(state, params)
        if sp is not None:
            sp.done(out, program=self.program_digest, kind="run", bucket=1,
                    tier=self._tier_token(self.tier),
                    dtype=self._dtype_token(self.env.precision.real_dtype),
                    sharding="none", bytes_per_pass=self._bytes_per_pass())
        out = _faults.poison_output(poison, out)
        qureg.state = self._health_tick(
            out, is_density=qureg.is_density_matrix,
            num_qubits=qureg.num_qubits_represented, where="run")

    def _health_tick(self, planes, *, is_density: bool, num_qubits: int,
                     where: str, tier=None):
        """The numerical health guard at the dispatch boundary: every
        ``cadence``-th guarded dispatch (the global config,
        :func:`quest_tpu_torch.resilience.health.configure` /
        ``QUEST_TPU_HEALTH_EVERY``) checks the output's invariants —
        NaN/Inf, statevector norm, density trace — in one reduction,
        raising a typed ``NumericalFault`` or renormalizing in the degraded
        mode. One int compare when the guard is off (the default).

        With a precision tier the check is the tier's fidelity monitor:
        the drift threshold widens to the tier's runtime tolerance
        (:func:`quest_tpu_torch.profiling.tier_runtime_tol`) and a
        violation carries the ``"precision"`` fault kind, which the serving
        recovery answers by re-executing one tier up."""
        cfg = _health.get_config()
        if cfg.cadence <= 0:
            return planes
        with self._stats_lock:
            self._health_counter += 1
            due = (self._health_counter % cfg.cadence) == 0
        if not due:
            return planes
        drift_kind = None
        if tier is None:
            tier = self.tier
        if tier is not None:
            from .profiling import tier_runtime_tol
            tol = tier_runtime_tol(tier, max(self.circuit.depth, 1))
            if tol > cfg.norm_tol:
                cfg = dataclasses.replace(cfg, norm_tol=tol)
            drift_kind = "precision"
        return _health.check_planes(
            planes, is_density=is_density, num_qubits=num_qubits,
            config=cfg, where=f"{where} ({self.num_qubits}q program)",
            drift_kind=drift_kind)


    # -- batched ensemble engine --------------------------------------------
    #
    # Thousands of parameter bindings of ONE circuit (VQE energy surfaces,
    # shot batches) run as a (B, 2, 2^n) batch through the same plan: a
    # layer is one launch of the batched layer kernel for all B states,
    # every other op one batched call of the gate engine, with a parameter
    # gate's matrix bound on the host for every row at once and moved to
    # the device once per op per call (``ops/adjoint.py``). Gradient sweeps
    # walk the same plan backwards (``ops/adjoint.AdjointWalk``).

    def _run_plan_batched(self, states: torch.Tensor, pm: np.ndarray,
                          tier=None) -> torch.Tensor:
        """Walk ``tier``'s plan over ``(B, 2, 2^n)`` states (already in the
        tier's plane dtype), IN PLACE, row ``b`` binding parameter row
        ``pm[b]``. The QUAD tier walks double-double planes instead
        (:meth:`_run_dd_batched`)."""
        if tier is not None and tier.name == "quad":
            return self._run_dd_batched(states, pm)
        plan, ops, _ = self._plan_for(tier)
        prec, fast = self._tier_exec_mode(tier)
        for item in plan.items:
            op = ops[item[1]]
            adj.apply_item(states, self.num_qubits, op, item,
                           adj.item_operator(op, self.param_names, pm),
                           prec, fast)
        return states

    def _run_dd_batched(self, states: torch.Tensor,
                        pm: np.ndarray) -> torch.Tensor:
        """The QUAD rung: the float64 ``(B, 2, 2^n)`` states split into
        float32 double-double planes ``(B, 4, 2^n)``, which walk the
        layer-free plan — every dense item through
        :func:`~quest_tpu_torch.ops.doubledouble.dd_apply_kq_traced`, every
        diagonal through the dd factor step, with a Param op's operator
        bound per row as complex128 before its dd split (so parameterised
        sweeps ride the dd path the standalone ``DDProgram`` rejects) —
        then recombine to float64 at the boundary, written back into
        ``states`` IN PLACE. No kernel of the layer engine runs here."""
        from .ops import doubledouble as dd
        plan, ops, _ = self._plan_for(QUAD_TIER)
        n = self.num_qubits
        device = states.device
        planes = dd.dd_split_planes(states[:, 0], states[:, 1],
                                    QUAD_TIER.real_dtype)
        for _, i, targets, cmask, fmask, axis_order in plan.items:
            op = ops[i]
            operator = torch.as_tensor(
                np.asarray(adj.item_operator(op, self.param_names, pm),
                           dtype=np.complex128), device=device)
            if op.kind == "u":
                planes = dd.dd_apply_kq_traced(planes, n, operator, targets,
                                               cmask, fmask)
                continue
            lead = operator.dim() - len(targets)
            operator = operator.permute(tuple(range(lead)) + tuple(
                lead + a for a in axis_order))
            planes = dd.dd_apply_diag_traced(planes, n, operator, targets)
        states.copy_(dd.dd_join_planes(planes))
        return states

    def _validated_param_matrix(self, param_matrix) -> np.ndarray:
        """The ``(B, P)`` parameter matrix as host float64, validated."""
        pm = np.asarray(param_matrix, dtype=np.float64)
        if pm.ndim != 2 or pm.shape[1] != len(self.param_names) \
                or pm.shape[0] < 1:
            raise ValueError(
                f"param_matrix must be (batch, {len(self.param_names)}); "
                f"got {pm.shape}")
        return pm

    @property
    def _register_qubits(self) -> int:
        """Qubits of the register the program runs on: a density program's
        n, not the 2n of its lifted vector."""
        return self.num_qubits // 2 if self.is_density else self.num_qubits

    def _pauli_operands(self, hamiltonian):
        """Validate ``(pauli_terms, coeffs)`` (qubits of the register) and
        encode it as the mask operands of :func:`quest_tpu_torch.ops.
        reductions.pauli_sum_operands`: ``(xm, ym, zm, coeffs)``."""
        nq = self._register_qubits
        terms, coeffs = red.validated_pauli_terms(*hamiltonian, nq)
        return red.pauli_terms_operands(terms, coeffs, nq)

    def _energies(self, states: torch.Tensor, operands,
                  tier) -> torch.Tensor:
        """The ``(B,)`` energies of a final batch, on the device:
        ``<z|H|z>`` per state, ``Tr(H rho)`` per density register; through
        the compensated reduction at a compensated tier (SINGLE)."""
        xm, ym, zm, coeffs = operands
        comp = tier is not None and tier.compensated
        if self.is_density:
            return red.pauli_sum_total_dm(states, self._register_qubits, xm,
                                          ym, zm, coeffs, compensated=comp)
        return red.pauli_sum_total_sv(states, xm, ym, zm, coeffs,
                                      compensated=comp)

    def _start_states(self, batch: int, state_f,
                      dtype: torch.dtype) -> torch.Tensor:
        """The ``(B, 2, 2^n)`` batch a sweep runs on, in ``dtype``: |0..0>
        or a shared ``(2, 2^n)`` start state copied per row, or the
        caller's own ``(B, 2, 2^n)`` batch (used in place when it already
        lies on the env's device in ``dtype``)."""
        n = self.num_qubits
        device = self.env.device
        if state_f is None:
            states = torch.zeros((batch, 2, 1 << n), dtype=dtype,
                                 device=device)
            states[:, 0, 0] = 1.0
            return states
        state_f = torch.as_tensor(state_f)
        if state_f.dim() == 2:
            if tuple(state_f.shape) != (2, 1 << n):
                raise ValueError(f"shared state_f must be (2, {1 << n}); "
                                 f"got {tuple(state_f.shape)}")
            return state_f.to(device=device, dtype=dtype).expand(
                batch, 2, 1 << n).contiguous()
        if tuple(state_f.shape) != (batch, 2, 1 << n):
            raise ValueError(
                f"state_f must be shared (2, {1 << n}) planes or an owned "
                f"({batch}, 2, {1 << n}) batch; got {tuple(state_f.shape)}")
        return state_f.to(device=device, dtype=dtype).contiguous()

    # -- the batched engine on a mesh ---------------------------------------

    def _mesh_mode(self, batch: int, mem_factor: float = 1.0) -> str:
        """``"none"`` off a mesh, else the policy's ``"batch"`` or
        ``"amp"`` for this many rows."""
        if not self._shard_bits:
            return "none"
        return self._batch_policy(batch, mem_factor)["mode"]

    def _shard_twin(self, d: int) -> "CompiledCircuit":
        """This program as it runs on shard ``d``'s device alone, for
        ``batch`` mode (:func:`~quest_tpu_torch.parallel.shards.
        shard_twin`): it shares the plan caches, and walks the unsharded
        plan."""
        return shards.shard_twin(self, d, _reset_circuit_twin)

    def _on_shards(self, pm: np.ndarray, run, state_f=None,
                   owned: bool = False) -> list:
        """``batch`` mode: split the rows over the shards and call
        ``run(twin, rows, state_f)`` on each shard's twin, in shard order.
        A batch not divisible by the mesh is padded (and an owned
        ``state_f`` batch with it) by
        :func:`~quest_tpu_torch.parallel.shards.split_rows`, whose extra
        rows' results the caller drops."""
        if owned:
            per, (pm, state_f) = shards.split_rows(
                self, "sweep batch", pm.shape[0], pm,
                torch.as_tensor(state_f))
        else:
            per, (pm,) = shards.split_rows(self, "sweep batch", pm.shape[0],
                                           pm)
        out = []
        for d in range(self.env.num_devices):
            sf = state_f[d * per:(d + 1) * per] if owned else state_f
            out.append(run(self._shard_twin(d), pm[d * per:(d + 1) * per],
                           sf))
        return out

    def _amp_start(self, batch: int, state_f, dtype) -> list:
        """``amp`` mode's start chunks: ``(B, 2, 2^(n-s))`` per shard, of
        |0..0>, a shared ``(2, 2^n)`` start or an owned batch."""
        lt = self.num_qubits - self._shard_bits
        C = 1 << lt
        devs = self.env.mesh.devices
        if state_f is None:
            chunks = [torch.zeros((batch, 2, C), dtype=dtype, device=dev)
                      for dev in devs]
            chunks[0][:, 0, 0] = 1.0
            return chunks
        sf = torch.as_tensor(state_f)
        if sf.dim() == 2:
            if tuple(sf.shape) != (2, 1 << self.num_qubits):
                raise ValueError(f"shared state_f must be (2, "
                                 f"{1 << self.num_qubits}); got "
                                 f"{tuple(sf.shape)}")
            return shards.start_chunks(sf, devs, lt, batch, dtype)
        if tuple(sf.shape) != (batch, 2, 1 << self.num_qubits):
            raise ValueError(
                f"state_f must be shared (2, {1 << self.num_qubits}) planes "
                f"or an owned ({batch}, 2, {1 << self.num_qubits}) batch; "
                f"got {tuple(sf.shape)}")
        return [sf[..., d * C:(d + 1) * C].to(dev, dtype).contiguous()
                for d, dev in enumerate(devs)]

    def _run_amp(self, pm: np.ndarray, state_f, tier) -> list:
        """``amp`` mode: every row spans the mesh as chunks; the mesh plan
        walks ``(B, 2, 2^(n-s))`` chunks, a layer as one launch of the
        batched layer kernel per shard, a parameter op's operator bound per
        row. Returns the chunks in the tier's plane dtype (float64 for
        QUAD, whose walk is :meth:`_run_amp_dd`)."""
        rdt = self._tier_dtypes(tier, self.env)[0]
        prec, fast = self._tier_exec_mode(tier)
        plan, ops, _ = self._plan_for(tier, sharded=True)
        s = plan.shard_bits
        chunks = self._amp_start(pm.shape[0], state_f, rdt)
        expl = self._exchange_plans(plan)
        if tier is not None and tier.name == "quad":
            return self._run_amp_dd(chunks, pm, plan, ops, expl)
        for j, item in enumerate(plan.items):
            if item[0] == "relayout":
                ex.run_exchange(chunks, expl[j])
                continue
            op = ops[item[1]]
            adj.apply_chunk_item(chunks, self.num_qubits, s, op, item,
                                 adj.item_operator(op, self.param_names, pm),
                                 prec, fast)
        return chunks

    def _run_amp_dd(self, chunks: list, pm: np.ndarray, plan, ops,
                    expl: dict) -> list:
        """The QUAD rung in ``amp`` mode: each float64 ``(B, 2, 2^(n-s))``
        chunk split into float32 double-double planes ``(B, 4,
        2^(n-s))``, which walk the layer-free mesh plan as
        :meth:`_run_dd_batched` walks the whole states: a relayout moves
        the four planes of every chunk together, a gate runs through the
        dd kernel on each chunk (a cross-shard 1q item on each pair of
        chunks as one operand, ``exchange.apply_op_grouped``), a diagonal
        with its device-bit axes sliced per shard. The chunks recombine to
        float64 at the boundary. No kernel of the layer engine runs."""
        from .ops import doubledouble as dd
        s = plan.shard_bits
        lt = self.num_qubits - s
        planes = [dd.dd_split_planes(c[:, 0], c[:, 1], QUAD_TIER.real_dtype)
                  for c in chunks]
        del chunks
        for j, item in enumerate(plan.items):
            if item[0] == "relayout":
                ex.run_exchange(planes, expl[j])
                continue
            kind, i, targets, cmask, fmask, axis_order = item
            op = ops[i]
            operator = adj.item_operator(op, self.param_names, pm)
            if kind == "xshard":
                ex.apply_op_grouped(planes, operator, targets, cmask, fmask,
                                    lt, s, dd=True)
            elif op.kind == "u":
                ex.apply_op_local(planes, "u", operator, targets, cmask,
                                  fmask, lt, dd=True)
            else:
                ex.apply_op_local(planes, "diag", adj._diag_in_plan_order(
                    operator, targets, axis_order), targets, 0, 0, lt,
                    dd=True)
        return [dd.dd_join_planes(p) for p in planes]

    def _amp_value_and_grad(self, pm: np.ndarray, operands, state_f,
                            tier):
        """``amp`` mode of :meth:`value_and_grad_sweep`: the adjoint walk
        over the mesh plan with every row spanning the shards
        (:class:`~quest_tpu_torch.ops.adjoint.ShardedAdjointWalk`), the
        energies and the cotangent ``H psi`` pair of chunks by pair
        (``parallel/chunks.py``). For a density program the values are
        ``Tr(H rho)`` and the cotangent is the flat ``H`` itself, made in
        chunks from the identity's flat vector."""
        from .parallel import chunks as chk
        s = self._shard_bits
        lt = self.num_qubits - s
        rdt = self._tier_dtypes(tier, self.env)[0]
        comp = tier is not None and tier.compensated
        key = self._plan_key(tier, sharded=True) + ("amp",)
        if key not in self._walks:
            plan, ops, _ = self._plan_for(tier, sharded=True)
            prec, fast = self._tier_exec_mode(tier)
            self._walks[key] = adj.ShardedAdjointWalk(
                self.num_qubits, s,
                [(ops[it[1]] if it[0] != "relayout" else None, it)
                 for it in plan.items],
                self.param_names, prec, fast, self.is_density)
        start = [c[0] for c in self._amp_start(1, state_f, rdt)]
        xm, ym, zm, coeffs = operands
        if self.is_density:
            reg = self._register_qubits
            eye = chk.density_identity(self.env.mesh.devices, lt, reg, rdt)
            h_flat = chk.pauli_sum_apply(eye, lt, xm, ym, zm, coeffs,
                                         [torch.empty_like(c) for c in eye])
            del eye

            def energies(psi):
                return chk.pauli_total_dm(psi, lt, reg, xm, ym, zm, coeffs,
                                          compensated=comp)

            def cotangent(psi, lam):
                for h, q in zip(h_flat, lam):
                    q.copy_(h.expand_as(q))
        else:
            def energies(psi):
                return chk.pauli_total(psi, lt, xm, ym, zm, coeffs,
                                       compensated=comp)

            def cotangent(psi, lam):
                chk.pauli_sum_apply(psi, lt, xm, ym, zm, coeffs, lam)
        values, grads = self._walks[key].run(
            pm, start, energies, cotangent,
            self._store_bytes(pm.shape[0], rdt))
        return (values.cpu().numpy().astype(np.float64),
                grads.cpu().numpy())

    def _mesh_sample(self, param_matrix, num_shots: int, generator,
                     tier):
        """:meth:`sample_sweep` on a mesh: each shard's rows drawn by its
        twin (``batch`` mode), or each row's chunks by the shard-local
        two-stage sampler (``amp`` mode)."""
        from .parallel.sampling import sample_sharded, shot_bucket
        tier = self._effective_tier(tier)
        pm = self._validated_param_matrix(param_matrix)
        B = pm.shape[0]
        mode = self._mesh_mode(B)
        if mode == "amp":
            chunks = self._run_amp(pm, None, tier)
            u = torch.rand((B, shot_bucket(num_shots)), generator=generator,
                           dtype=torch.float64)
            lt = self.num_qubits - self._shard_bits
            idx = np.empty((B, num_shots), dtype=np.int64)
            totals = np.empty(B)
            for b in range(B):
                idx[b], totals[b] = sample_sharded(
                    [c[b] for c in chunks], u[b, :num_shots], False,
                    self.num_qubits, lt)
        else:
            parts = self._on_shards(
                pm, lambda tw, rows, sf: tw.sample_sweep(
                    rows, num_shots, generator, tier))
            idx = np.concatenate([p[0] for p in parts])[:B]
            totals = np.concatenate([p[1] for p in parts])[:B]
        self._record_batch_stats(B, 2 * B - 2, mode=mode)
        return idx, totals

    def sweep(self, param_matrix, state_f=None, tier=None) -> torch.Tensor:
        """Run a whole batch of parameter vectors through the plan.

        ``param_matrix``: ``(B, len(param_names))``. ``state_f``: shared
        ``(2, 2^n)`` planes every run starts from (default |0..0>, for a
        density program |0..0><0..0| as its flat vector), or an OWNED ``(B,
        2, 2^n)`` batch, which is updated IN PLACE (the port's answer to
        donation) when it lies on the env's device in its dtype. ``tier``
        runs this dispatch at one precision-tier rung (a ``PrecisionTier``
        or name; default the compile-time tier, else the env precision).
        Returns the ``(B, 2, 2^n)`` planes in the env's dtype (on a mesh,
        gathered on the first shard's device: the rows the caller asked
        for)."""
        tier = self._effective_tier(tier)
        pm = self._validated_param_matrix(param_matrix)
        env_dt = self.env.precision.real_dtype
        if self._shard_bits:
            mode = self._mesh_mode(pm.shape[0])
            if mode == "amp":
                out = torch.cat([c.to(self.env.device, env_dt)
                                 for c in self._run_amp(pm, state_f, tier)],
                                dim=-1)
            else:
                owned = state_f is not None and \
                    torch.as_tensor(state_f).dim() == 3
                out = torch.cat([o.to(self.env.device)
                                 for o in self._on_shards(
                    pm, lambda tw, rows, sf: tw.sweep(rows, sf, tier),
                    state_f, owned)], dim=0)[:pm.shape[0]]
            self._record_batch_stats(pm.shape[0], pm.shape[0] - 1,
                                     mode=mode)
            return out
        states = self._start_states(pm.shape[0], state_f, env_dt)
        rdt = self._tier_dtypes(tier, self.env)[0]
        if rdt == env_dt:
            out = self._run_plan_batched(states, pm, tier)
        else:
            out = states.copy_(self._run_plan_batched(states.to(rdt), pm,
                                                      tier))
        # a per-point client pays one dispatch and transfer per row
        self._record_batch_stats(pm.shape[0], pm.shape[0] - 1)
        return out

    def expectation_sweep(self, param_matrix, hamiltonian,
                          state_f=None, tier=None) -> np.ndarray:
        """``(B,)`` energies ``<H>(params_b)`` with one device-to-host
        transfer. ``hamiltonian``: ``(pauli_terms, coeffs)``, terms as
        ``(qubit, code)`` pairs (codes 1=X 2=Y 3=Z). Each point runs the
        plan from |0..0> (or the shared ``state_f``) and the Pauli sum is
        reduced on the device, term after term (``ops/reductions.py``); on
        a density program each value is ``Tr(H rho)``. ``tier`` as in
        :meth:`sweep`; a compensated tier (SINGLE) reduces each term through
        the compensated pair path, FAST and DOUBLE through the naive reduce
        their budgets cover."""
        tier = self._effective_tier(tier)
        operands = self._pauli_operands(hamiltonian)
        pm = self._validated_param_matrix(param_matrix)
        if state_f is not None and tuple(torch.as_tensor(
                state_f).shape) != (2, 1 << self.num_qubits):
            raise ValueError(
                f"expectation_sweep state_f must be shared (2, "
                f"{1 << self.num_qubits}) planes (run batched planes "
                "through sweep(), then reduce)")
        vals = self._energy_rows(pm, operands, state_f, tier)
        # a per-point client pays at least one transfer per point (the
        # reference: one per term per point); the sweep's is one (B,) block
        self._record_batch_stats(
            pm.shape[0], pm.shape[0] * max(len(hamiltonian[0]), 1) - 1,
            mode=self._mesh_mode(pm.shape[0]))
        return vals

    def _energy_rows(self, pm: np.ndarray, operands, state_f,
                     tier) -> np.ndarray:
        """The float64 ``(B,)`` energies of validated rows (the body of
        :meth:`expectation_sweep`, which also records the dispatch). On a
        mesh: each shard's rows through the single-device walk (``batch``
        mode), or every row over the shards' chunks, reduced pair of
        chunks by pair (``amp`` mode; a density program's ``Tr(H rho)``
        from the entries ``rho[r ^ m, r]`` each shard holds)."""
        if self._shard_bits:
            if self._mesh_mode(pm.shape[0]) == "amp":
                from .parallel import chunks as chk
                xm, ym, zm, coeffs = operands
                comp = tier is not None and tier.compensated
                lt = self.num_qubits - self._shard_bits
                chunks = self._run_amp(pm, state_f, tier)
                if self.is_density:
                    vals = chk.pauli_total_dm(
                        chunks, lt, self._register_qubits, xm, ym, zm,
                        coeffs, compensated=comp)
                else:
                    vals = chk.pauli_total(chunks, lt, xm, ym, zm, coeffs,
                                           compensated=comp)
                return vals.cpu().numpy().astype(np.float64)
            return np.concatenate(self._on_shards(
                pm, lambda tw, rows, sf: tw._energy_rows(rows, operands, sf,
                                                         tier),
                state_f))[:pm.shape[0]]
        rdt = self._tier_dtypes(tier, self.env)[0]
        states = self._run_plan_batched(
            self._start_states(pm.shape[0], state_f, rdt), pm, tier)
        vals = self._energies(states, operands, tier)
        return vals.cpu().numpy().astype(np.float64)

    # -- gradient sweeps ------------------------------------------------------

    # the bytes of states a gradient sweep may keep at the inputs of its
    # non-unitary items (channels); None sizes it from the device's free
    # memory (:meth:`_store_bytes`)
    _adjoint_store_bytes: Optional[int] = None
    # the host's share when the walk runs on the CPU
    _CPU_STORE_BYTES = 4 << 30

    def _grad_tier(self, tier):
        """Tier resolution for gradient dispatches: the ladder applies
        (FAST/SINGLE/DOUBLE change only the plane dtype and the layers'
        dense products), but QUAD is rejected with the JAX package's error
        before the port's own "not ported" one: its double-double walk is
        not a differentiable path in either package."""
        if tier is not None and tier_by_name(tier).name == "quad":
            raise ValueError(
                "gradient sweeps cannot run at the QUAD tier: the "
                "double-double engine walk is not differentiable "
                "(no transpose rules for the dd split/barrier steps); "
                "use tier='double' for the highest differentiable "
                "rung, or estimate quad gradients by parameter shift "
                "over expectation_sweep(tier='quad')")
        return self._effective_tier(tier)

    def _adjoint_walk(self, tier) -> adj.AdjointWalk:
        """The adjoint walk over ``tier``'s plan, built once per plan and
        kept: its items classified and its layers' adjoints made once (and
        packed at their first launch)."""
        key = self._plan_key(tier)
        if key not in self._walks:
            plan, ops, _ = self._plan_for(tier)
            prec, fast = self._tier_exec_mode(tier)
            self._walks[key] = adj.AdjointWalk(
                self.num_qubits, [(ops[it[1]], it) for it in plan.items],
                self.param_names, prec, fast, self.is_density)
        return self._walks[key]

    def _store_bytes(self, batch: int, dtype: torch.dtype) -> int:
        """What a gradient sweep of ``batch`` rows may keep of the states
        entering its channels: on the card, its free memory less eight
        batches (the walk's stacked pair and derivative batch, and the
        gate engine's temporaries on the pair); on the CPU a fixed
        share."""
        if self._adjoint_store_bytes is not None:
            return int(self._adjoint_store_bytes)
        device = self.env.device
        if device.type != "cuda":
            return self._CPU_STORE_BYTES
        free = torch.cuda.mem_get_info(device)[0] \
            + torch.cuda.memory_reserved(device) \
            - torch.cuda.memory_allocated(device)
        state = batch * 2 * (1 << self.num_qubits) * dtype.itemsize
        return max(0, free - 8 * state)

    def value_and_grad_sweep(self, param_matrix, hamiltonian, state_f=None,
                             tier=None):
        """``(B,)`` energies AND their ``(B, P)`` parameter gradients
        from one forward and one reverse pass over the plan
        (:class:`~quest_tpu_torch.ops.adjoint.AdjointWalk`), where a
        parameter-shift client pays ``2P + 1`` energy sweeps.
        ``hamiltonian``/``state_f`` as in :meth:`expectation_sweep` (a
        shared ``state_f`` only); the values are its energies, from the same
        reduction. On a density program the gradients are those of ``Tr(H
        rho)`` THROUGH the channels, Param-bound rates included. ``tier`` as
        in :meth:`sweep`, except QUAD (rejected, :meth:`_grad_tier`). Every
        layer and its adjoint run through the batched layer kernel on the
        card.

        Returns ``(values, grads)``: float64 ``(B,)`` and ``(B, P)``
        arrays."""
        tier = self._grad_tier(tier)
        if not self.param_names:
            raise ValueError(
                "this circuit declares no parameters; there is nothing "
                "to differentiate (record angles via "
                "Circuit.parameter / Param placeholders)")
        operands = self._pauli_operands(hamiltonian)
        pm = self._validated_param_matrix(param_matrix)
        out = self._value_and_grad_rows(pm, operands, state_f, tier)
        # a parameter-shift client pays 2P + 1 energy dispatches per row
        B = pm.shape[0]
        self._record_batch_stats(B, B * (2 * len(self.param_names) + 1) - 1,
                                 mode=self._mesh_mode(B, 2.0))
        return out

    def _value_and_grad_rows(self, pm: np.ndarray, operands, state_f,
                             tier):
        """The body of :meth:`value_and_grad_sweep` on validated rows
        (which also records the dispatch). On a mesh each shard walks its
        rows (``batch`` mode, priced at ``mem_factor=2``)."""
        if self._shard_bits:
            if self._mesh_mode(pm.shape[0], 2.0) == "amp":
                return self._amp_value_and_grad(pm, operands, state_f, tier)
            parts = self._on_shards(
                pm, lambda tw, rows, sf: tw._value_and_grad_rows(
                    rows, operands, sf, tier), state_f)
            B = pm.shape[0]
            return (np.concatenate([v for v, _ in parts])[:B],
                    np.concatenate([g for _, g in parts])[:B])
        n = self.num_qubits
        if state_f is None:
            start = torch.zeros((2, 1 << n), dtype=torch.float64)
            start[0, 0] = 1.0
        else:
            start = torch.as_tensor(state_f)
            if tuple(start.shape) != (2, 1 << n):
                raise ValueError(
                    f"value_and_grad_sweep state_f must be shared "
                    f"(2, {1 << n}) planes; got {tuple(start.shape)}")
        rdt = self._tier_dtypes(tier, self.env)[0]
        start = start.to(device=self.env.device, dtype=rdt)
        xm, ym, zm, coeffs = operands
        if self.is_density:
            # Tr(H rho) = Re <H_flat, rho_flat>: the cotangent is H itself,
            # flattened as rho is (H applied to the identity's flat vector)
            dim = 1 << self._register_qubits
            eye = torch.zeros((1, 2, 1 << n), dtype=rdt,
                              device=self.env.device)
            eye[0, 0, ::dim + 1] = 1.0
            h_flat = red.pauli_sum_apply(eye, xm, ym, zm, coeffs)
            del eye

            def cotangent(psi, lam):
                lam.copy_(h_flat.expand_as(lam))
        else:
            def cotangent(psi, lam):
                red.pauli_sum_apply(psi, xm, ym, zm, coeffs, out=lam)
        values, grads = self._adjoint_walk(tier).run(
            pm, start, lambda psi: self._energies(psi, operands, tier),
            cotangent, self._store_bytes(pm.shape[0], rdt))
        return (values.cpu().numpy().astype(np.float64),
                grads.cpu().numpy())

    def grad_sweep(self, param_matrix, hamiltonian, state_f=None,
                   tier=None) -> np.ndarray:
        """The ``(B, P)`` gradient block alone: :meth:`value_and_grad_sweep`
        with the energies dropped (the walk computes them either way)."""
        return self.value_and_grad_sweep(param_matrix, hamiltonian,
                                         state_f=state_f, tier=tier)[1]

    def expectation_fn(self, pauli_terms, coeffs) -> Callable:
        """``theta -> <H>`` for ``H = sum_j coeffs[j] * prod Pauli``,
        starting from |0..0> (on a density program ``Tr(H rho(theta))``,
        noise channels included), at the compile-time tier: a function of a
        float64 ``(P,)`` tensor returning a 0-dim one. It is a
        ``torch.autograd.Function`` whose backward is the adjoint walk, so
        ``.backward()`` gives the :meth:`value_and_grad_sweep` row. Like
        the JAX package's, it is no batched dispatch and records none."""
        operands = self._pauli_operands((pauli_terms, coeffs))
        compiled = self

        class _Energy(torch.autograd.Function):
            @staticmethod
            def forward(ctx, theta):
                ctx.save_for_backward(theta)
                value = compiled._energy_rows(
                    compiled._validated_param_matrix(_param_row(theta)),
                    operands, None, compiled.tier)[0]
                return torch.as_tensor(value, dtype=theta.dtype,
                                       device=theta.device)

            @staticmethod
            def backward(ctx, grad_out):
                theta, = ctx.saved_tensors
                grad = compiled._value_and_grad_rows(
                    compiled._validated_param_matrix(_param_row(theta)),
                    operands, None, compiled._grad_tier(None))[1]
                return grad_out * torch.as_tensor(
                    grad[0], dtype=theta.dtype, device=theta.device)

        return _Energy.apply

    def sample_sweep(self, param_matrix, num_shots: int,
                     generator: Optional[torch.Generator] = None,
                     tier=None):
        """Shot batches over a parameter sweep: run the batch (at ``tier``,
        as in :meth:`sweep`), then draw ``num_shots`` basis outcomes per
        point from ``|amp|^2``
        (:func:`quest_tpu_torch.parallel.sampling.sample_batched`, uniforms
        from ``generator``, default the env's). Returns ``(indices,
        totals)``: int64 ``(B, num_shots)`` and the ``(B,)`` norms.
        Statevector-compiled circuits only."""
        if self.is_density:
            raise ValueError(
                "sample_sweep draws from |amp|^2 of statevector "
                "programs; sample density registers via sampleOutcomes")
        from .parallel.sampling import sample_batched
        if self._shard_bits:
            return self._mesh_sample(param_matrix, int(num_shots),
                                     generator or self.env.generator, tier)
        planes = self.sweep(param_matrix, tier=tier)
        out = sample_batched(planes, generator or self.env.generator,
                             int(num_shots))
        # two transfers (indices and totals) where a per-point loop pays
        # 2B (one run and one sampling sync per point)
        self._record_batch_stats(planes.shape[0], 2 * planes.shape[0] - 2)
        return out

    # -- Hamiltonian dynamics -------------------------------------------------

    def _dynamics_dispatch(self, kind: str, param_matrix, hamiltonian,
                           spec, state_f, tier) -> torch.Tensor:
        """The shared evolve/ground body: validate, run the prep program
        over the batch (the batched layer kernel on the card), then
        ``spec.steps`` steps of ``ops/dynamics.py`` on every row with the
        Pauli-sum energy after each, fold the energies into the Welford
        carry and pack ONE ``(B, W)`` block on the env's device. The step
        loop reads nothing back from the device (Lanczos waits once, for
        its eigensolver's status). Statevector programs only. On a mesh,
        each shard's rows run this body on its device (``batch`` mode), or
        every row spans the shards' chunks (``amp`` mode): the prep through
        the mesh plan, each term sweep chunk pair by chunk pair, and the
        norms, inner products and energies summed over the chunks in
        float64."""
        if self.is_density:
            raise ValueError(
                f"{kind}_sweep runs on statevector-compiled programs "
                "(Trotter rotations act on ket amplitudes); evolve "
                "density registers through their channel circuits")
        # the JAX package's error, before the port's own "not ported" one
        if tier is not None and tier_by_name(tier).name == "quad":
            raise ValueError(
                f"{kind}_sweep cannot run at the QUAD tier: the "
                "double-double walk has no scan-resident Trotter "
                "form; use tier='double' for the highest rung")
        tier = self._effective_tier(tier)
        xm, ym, zm, coeffs = self._pauli_operands(hamiltonian)
        n = self.num_qubits
        pm = self._validated_param_matrix(param_matrix)
        mode = self._mesh_mode(pm.shape[0])
        if mode == "batch":
            out = torch.cat([o.to(self.env.device) for o in self._on_shards(
                pm, lambda tw, rows, sf: tw._dynamics_dispatch(
                    kind, rows, hamiltonian, spec, sf, tier), state_f)])
            B, S = pm.shape[0], int(spec.steps)
            self._record_batch_stats(B, B * S - 1, evolve_steps_fused=B * S,
                                     mode=mode)
            return out[:B]
        if state_f is not None and getattr(state_f, "shape",
                                           None) != (2, 1 << n):
            raise ValueError(
                f"{kind}_sweep state_f must be shared (2, {1 << n}) "
                f"planes; got {getattr(state_f, 'shape', None)}")
        env_dt = self.env.precision.real_dtype
        env_np = np.float32 if env_dt == torch.float32 else np.float64
        # coefficients and the step size in the env's dtype, as the JAX
        # package passes them to its executable
        cf = coeffs.astype(env_np)
        cf_dev = torch.as_tensor(cf, device=self.env.device)
        comp = tier is not None and tier.compensated
        B, S = pm.shape[0], int(spec.steps)
        if mode == "amp":
            # every row spans the shards' chunks: the prep program through
            # the mesh plan, each term sweep chunk pair by chunk pair, the
            # norms, inner products and energies summed over the chunks
            from .parallel import chunks as chk
            local = n - self._shard_bits
            z = self._run_amp(pm, state_f, tier)

            def energy(z):
                vals = chk.pauli_expvals(z, local, xm, ym, zm,
                                         compensated=comp)
                return (vals.to(env_dt) * cf_dev).sum(-1)
        else:
            local = None

            def energy(z):
                vals = red.pauli_sum_expvals_sv(z, xm, ym, zm,
                                                compensated=comp)
                return (vals.to(env_dt) * cf_dev).sum(-1)

            rdt = self._tier_dtypes(tier, self.env)[0]
            z = self._run_plan_batched(self._start_states(B, state_f, rdt),
                                       pm, tier)
        es = torch.empty((B, S), dtype=env_dt, device=self.env.device)
        residual = None
        if kind == "evolve":
            dt = env_np(spec.dt)
            for s in range(S):
                dyn.trotter_step(z, xm, ym, zm, cf, dt, order=spec.order,
                                 local=local)
                es[:, s] = energy(z)
        elif spec.method == "lanczos":
            z, e, residual = dyn.lanczos_ground(z, xm, ym, zm, cf,
                                                num_vectors=S, local=local)
            es[:] = e.to(env_dt)[:, None]
            residual = residual.to(env_dt)
        else:
            tau = env_np(spec.tau)
            e0 = energy(z) if S == 1 else None
            for s in range(S):
                dyn.imag_time_step(z, xm, ym, zm, cf, tau, local=local)
                es[:, s] = energy(z)
            residual = (es[:, -1] - (es[:, -2] if S >= 2 else e0)).abs()
        welford = torch.stack(red.welford_wave(es, torch.ones(
            S, dtype=env_dt, device=es.device)), dim=1)
        planes = torch.cat([c.to(self.env.device, env_dt) for c in z],
                           dim=-1) if mode == "amp" else z.to(env_dt)
        out = dyn.pack_evolve_block(es, welford, planes) \
            if residual is None else \
            dyn.pack_ground_block(es, residual, welford, planes)
        # a stepping client pays one dispatch and transfer per step per
        # row; the segment leaves as ONE block
        self._record_batch_stats(B, B * S - 1, evolve_steps_fused=B * S,
                                 mode=mode)
        return out

    def evolve_sweep(self, param_matrix, hamiltonian, spec, state_f=None,
                     tier=None) -> torch.Tensor:
        """Trotterised ``exp(-i H t)`` for a whole parameter batch.

        Each row runs the compiled program from ``state_f`` (shared ``(2,
        2^n)`` planes, default |0..0>: the state-prep circuit), then
        ``spec.steps`` Trotter steps of order ``spec.order`` run on the
        device over every row at once, with the Pauli-sum energy after
        every step. ``hamiltonian``: ``(pauli_terms, coeffs)`` as in
        :meth:`expectation_sweep`; ``spec``: an :class:`~quest_tpu_torch.
        ops.dynamics.EvolveSpec`; ``tier`` as in :meth:`sweep` (a
        compensated tier reduces the energies compensated), except QUAD.

        Returns the packed ``(B, steps + 3 + 2^{n+1})`` real block on the
        env's device: per-step energies, the Welford (count, mean, M2)
        carry over them and the final planes; decode it with
        :func:`quest_tpu_torch.ops.dynamics.unpack_evolve_block` (one
        transfer)."""
        if not isinstance(spec, dyn.EvolveSpec):
            raise TypeError("spec must be an EvolveSpec")
        return self._dynamics_dispatch("evolve", param_matrix, hamiltonian,
                                       spec, state_f, tier)

    def ground_sweep(self, param_matrix, hamiltonian, spec, state_f=None,
                     tier=None) -> torch.Tensor:
        """One imaginary-time (or Lanczos) ground-state SEGMENT for a
        whole parameter batch: ``spec.steps`` iterations on the device
        with per-iteration energies and a convergence residual (``|e_S -
        e_{S-1}|`` for power iteration, ``|e_1 - e_0|`` at one step with
        ``e_0`` the start's energy; the Ritz bound ``beta_m |y_m|`` for
        Lanczos, whose energies are its one Ritz value repeated), as one
        packed ``(B, steps + 4 + 2^{n+1})`` block
        (:func:`quest_tpu_torch.ops.dynamics.unpack_ground_block`).
        ``spec``: a :class:`~quest_tpu_torch.ops.dynamics.GroundSpec`.
        Segments chain by passing a segment's output planes as the next
        one's ``state_f``."""
        if not isinstance(spec, dyn.GroundSpec):
            raise TypeError("spec must be a GroundSpec")
        return self._dynamics_dispatch("ground", param_matrix, hamiltonian,
                                       spec, state_f, tier)

    # -- warm-start artifacts (serve/warmcache.py) ---------------------------

    def _warm_form_key(self, kind: str, mode: str, tier=None) -> tuple:
        """The JAX package's form key of one warm form: the ``sweep``
        booleans (shared start state, not donated), the batch mode, the
        plane dtype and the tier token. The tier is part of the form, so
        another tier's artifact is a miss, never a wrong program."""
        dtstr = self._dtype_token(self.env.precision.real_dtype)
        tok = self._tier_token(tier)
        if kind == "sweep":
            return ("sweep", True, False, mode, dtstr, tok)
        if kind == "energy":
            return ("energy", mode, dtstr, tok)
        if kind == "grad":
            return ("grad", mode, dtstr, tok)
        raise ValueError(f"unknown warm form kind {kind!r}")

    def lower_batched(self, kind: str, batch: int, hamiltonian=None,
                      lower: bool = True, tier=None):
        """The warm form one batched dispatch kind runs: ``kind`` is
        ``"sweep"`` (broadcast start state: the serving dispatcher's
        state/sample form), ``"energy"`` or ``"grad"`` (the value-and-grad
        form, whose adjoint layers are its own). Returns ``(form,
        args_shapes, artifact)``: the JAX package's cache coordinates, and
        the :class:`~quest_tpu_torch.serve.warmcache.WarmArtifact` the
        form's first dispatch would compute (every layer it launches
        packed at the form's tier, the plain ops' static operators, and a
        description of the plan), ready for :meth:`install_batched_aot`.
        ``lower=False`` computes the coordinates only and packs nothing,
        so a cache hit never pays the packing."""
        if batch < 1:
            raise ValueError("batch must be >= 1")
        tier = self._grad_tier(tier) if kind == "grad" \
            else self._effective_tier(tier)
        mode = self._batch_policy(int(batch))["mode"]
        if mode != "none":
            raise ValueError(
                f"warm AOT lowering covers the unsharded batch mode; "
                f"batch {batch} chose {mode!r} on this mesh env")
        n = self.num_qubits
        shapes = ((2, 1 << n), (int(batch), len(self.param_names)))
        if kind in ("energy", "grad"):
            if hamiltonian is None:
                raise ValueError(f"kind={kind!r} needs hamiltonian=")
            if kind == "grad" and not self.param_names:
                raise ValueError(
                    "kind='grad' needs a parameterised circuit (no Param "
                    "placeholders declared)")
            shapes += tuple(tuple(t.shape)
                            for t in self._pauli_operands(hamiltonian))
        form = self._warm_form_key(kind, mode, tier)
        if not lower:
            return form, shapes, None
        return form, shapes, self._pack_form(form, shapes, tier)

    def _form_layers(self, form: tuple, tier) -> list:
        """``[(name, layer)]``: the layers a form launches, named by their
        plan item (``L<k>``), and a gradient form's adjoint layers
        (``A<k>``)."""
        plan, ops, _ = self._plan_for(tier)
        items = [(k, ops[it[1]]) for k, it in enumerate(plan.items)
                 if ops[it[1]].kind == "layer"]
        out = [(f"L{k}", op) for k, op in items]
        if form[0] == "grad":
            walk = self._adjoint_walk(tier)
            out += [(f"A{k}", walk.adjoints[id(op)]) for k, op in items]
        return out

    def _form_description(self, form: tuple, shapes: tuple, tier) -> dict:
        """The JSON description of a form's plan: every item's kind,
        targets, masks and axis order, whether it is static, and a layer's
        stage tags. An artifact installs only onto the plan it
        describes."""
        plan, ops, _ = self._plan_for(tier)
        items = []
        for _, i, targets, cmask, fmask, axis_order in plan.items:
            op = ops[i]
            stages = [st[0] for st in op.stages] if op.kind == "layer" \
                else []
            items.append([op.kind, [int(t) for t in targets], int(cmask),
                          int(fmask), [int(a) for a in axis_order or ()],
                          bool(op.is_static), stages])
        return {"version": 1, "form": list(form),
                "shapes": [list(s) for s in shapes],
                "num_qubits": self.num_qubits,
                "is_density": bool(self.is_density), "items": items}

    def _pack_form(self, form: tuple, shapes: tuple, tier):
        """Pack a form's layers and put its static operators on the device
        (counted like a first dispatch's: ``pack_layer``), and return them
        with the plan's description as one artifact."""
        from .serve.warmcache import WarmArtifact
        rdt = self._tier_dtypes(tier, self.env)[0]
        _, fast = self._tier_exec_mode(tier)
        device = self.env.device
        n = self.num_qubits
        desc = self._form_description(form, shapes, tier)
        tensors, layers = {}, {}
        for name, layer in self._form_layers(form, tier):
            lk.pack_layer(layer, n, rdt, device, fast)
            d, pool, fpool, max_j, tile_rows, total_rows = \
                lk.packed_operands(layer, n, rdt, device, fast)
            tensors[f"{name}.desc"] = d
            tensors[f"{name}.pool"] = pool
            if fpool is not None:
                tensors[f"{name}.fast_pool"] = fpool
            layers[name] = [max_j, tile_rows, total_rows]
        plan, ops, _ = self._plan_for(tier)
        static = []
        for _, i, _, _, _, axis_order in plan.items:
            op = ops[i]
            if op.kind != "layer" and op.is_static:
                tensors[f"S{i}"] = self._static_operator(i, op, axis_order,
                                                         rdt, device)
                static.append(i)
        desc.update(layers=layers, static=static)
        return WarmArtifact(desc, tensors)

    def install_batched_aot(self, form: tuple, args_shapes: tuple,
                            compiled) -> None:
        """Install one warm form's artifact (typically loaded from the
        persistent warm cache) for an exact ``(form, arg shapes)`` slot:
        its packed operands go where a launch finds them
        (``layer_kernel.install_packed``) and its static operators where
        ``run`` finds them, so the form's first dispatch packs nothing.
        Raises ``ValueError`` when the artifact describes another plan or
        lacks an operand."""
        form, args_shapes = tuple(form), tuple(tuple(s) for s in
                                               args_shapes)
        tok = form[-1]
        tier = None if tok == "env" else tier_by_name(tok)
        desc = dict(compiled.description)
        layers, static = desc.pop("layers", {}), desc.pop("static", [])
        if desc != self._form_description(form, args_shapes, tier):
            raise ValueError("the warm artifact describes another plan "
                             "than this program's")
        rdt = self._tier_dtypes(tier, self.env)[0]
        _, fast = self._tier_exec_mode(tier)
        device = self.env.device
        tensors = compiled.tensors
        names = self._form_layers(form, tier)
        try:
            packed = [(layer, (tensors[f"{name}.desc"].to(device),
                               tensors[f"{name}.pool"].to(device),
                               tensors[f"{name}.fast_pool"].to(device)
                               if fast else None, *layers[name]))
                      for name, layer in names]
            operators = {i: tensors[f"S{i}"].to(device) for i in static}
        except KeyError as e:
            raise ValueError(f"the warm artifact lacks operand {e}") from e
        for layer, ops in packed:
            lk.install_packed(layer, self.num_qubits, rdt, device, fast, ops)
        for i, t in operators.items():
            self._dev_operators[(rdt, device, i)] = t

    def __repr__(self) -> str:
        tier = self.tier.name if self.tier is not None else "env"
        return (f"CompiledCircuit({self.num_qubits} qubits, "
                f"{len(self.plan.items)} ops, {self.num_layers} layers, "
                f"tier {tier})")
