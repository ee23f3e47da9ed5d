"""The communication cost model, the precision-tier error model,
compile-time dispatch accounting, and host-side profiling hooks.

Counterpart of the JAX package's ``profiling.py``: :class:`CommCostModel`
(the layout planner's objective, measured on a mesh by timing the port's
own shard exchange), :class:`DispatchStats`, :func:`trace` (a
``torch.profiler`` Chrome trace), :class:`GateStats` and
:func:`probe_gate`. The
modeled max amplitude error of one program execution at a tier is
``drift_per_gate[tier] * num_gates`` (floored), seeded from the ladder's
constants (:data:`quest_tpu_torch.config.TIER_LADDER`) and refined per
device by a small cached calibration run (:func:`measure_tier_model`).
:func:`choose_tier` picks the cheapest rung whose modeled error fits a
caller's budget; an unmeetable budget raises.

The same environment variables as the JAX package steer it, so one setting
pins both packages: ``QUEST_TPU_TIER_MODEL=default`` pins the seeds,
``QUEST_TPU_TIER_CALIBRATE`` turns calibration on or off, and
``QUEST_TPU_TIER_SILICON`` the timing of each tier on the device. Both
default to on for an environment on a CUDA card and off on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Optional, Sequence

import torch

from .config import (DOUBLE_TIER, FAST_TIER, QUAD_TIER, SINGLE_TIER,
                     TIER_LADDER, tier_by_name)

__all__ = ["trace", "GateStats", "probe_gate", "CommCostModel",
           "DEFAULT_COMM_MODEL", "comm_model", "measure_comm_model",
           "invalidate_comm_model", "TierErrorModel", "DEFAULT_TIER_MODEL",
           "tier_error_model", "measure_tier_model", "modeled_tier_error",
           "engine_tiers", "choose_tier", "tier_runtime_tol",
           "DispatchStats"]


# ---------------------------------------------------------------------------
# collective cost model (the layout planner's objective function)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CommCostModel:
    """Two-tier linear latency/bandwidth model for one mesh collective:
    ``seconds = alpha + beta * bytes`` per shard, with a separate (alpha,
    beta) for collectives that cross a host boundary (the JAX package's
    model, field for field).

    The layout planner (:mod:`quest_tpu_torch.parallel.layout`) prices
    every candidate data movement with it: a relayout trading ``k``
    device-index bits against ``k`` chunk-local bits ships ``chunk_bytes *
    (2^k - 1) / 2^k`` per shard (plus a whole-chunk permutation when a
    residual device-bit permutation remains); a cross-shard 1q pair
    exchange ships the whole chunk. The inter fields default to None =
    same as intra. Decisions depend only on cost ratios, so plans are
    deterministic for any non-degenerate fit (alpha >= 0, beta > 0)."""

    alpha_s: float              # per-collective launch latency (seconds)
    beta_s_per_byte: float      # per-byte transfer time (seconds/byte)
    source: str = "default"     # "default" | "measured"
    inter_alpha_s: Optional[float] = None
    inter_beta_s_per_byte: Optional[float] = None

    def tier(self, inter: bool = False) -> tuple[float, float]:
        """(alpha, beta) of one tier; the inter tier falls back to intra
        when uncalibrated."""
        if inter and self.inter_alpha_s is not None:
            return (self.inter_alpha_s,
                    self.inter_beta_s_per_byte
                    if self.inter_beta_s_per_byte is not None
                    else self.beta_s_per_byte)
        if inter and self.inter_beta_s_per_byte is not None:
            return (self.alpha_s, self.inter_beta_s_per_byte)
        return (self.alpha_s, self.beta_s_per_byte)

    @staticmethod
    def all_to_all_bytes(chunk_bytes: float, k: int) -> float:
        """Per-shard bytes shipped by a k-bit relayout exchange."""
        if k <= 0:
            return 0.0
        return chunk_bytes * ((1 << k) - 1) / float(1 << k)

    @staticmethod
    def ppermute_bytes(chunk_bytes: float) -> float:
        """Per-shard bytes shipped by a whole-chunk pair exchange."""
        return float(chunk_bytes)

    def all_to_all_seconds(self, chunk_bytes: float, k: int,
                           inter: bool = False) -> float:
        if k <= 0:
            return 0.0
        alpha, beta = self.tier(inter)
        return alpha + beta * self.all_to_all_bytes(chunk_bytes, k)

    def ppermute_seconds(self, chunk_bytes: float,
                         inter: bool = False) -> float:
        alpha, beta = self.tier(inter)
        return alpha + beta * self.ppermute_bytes(chunk_bytes)


# The JAX package's default (a few-microsecond launch and ~50 GB/s per
# link; the inter tier ten times the latency and twenty times the cost
# per byte), kept so both packages plan alike where nothing was measured:
# the planner's decisions depend on ratios only.
DEFAULT_COMM_MODEL = CommCostModel(alpha_s=5e-6, beta_s_per_byte=2e-11,
                                   inter_alpha_s=5e-5,
                                   inter_beta_s_per_byte=4e-10)

# calibration cache keyed (mesh fingerprint, tier); failed fits are cached
# as the default, so the microbenchmark runs at most once per key
_COMM_MODEL_CACHE: dict = {}
# per cache key, what the last measurement saw: the probe times, or why
# it fell back to the default
COMM_MODEL_NOTES: dict = {}


def _mesh_cache_key(mesh, tier: str = "intra") -> tuple:
    return (mesh.size, tuple(str(d) for d in mesh.devices), tier)


def _comm_model_pinned() -> bool:
    """``QUEST_TPU_COMM_MODEL=default`` pins :data:`DEFAULT_COMM_MODEL`:
    no microbenchmark ever runs (tests, reproducible planning)."""
    return os.environ.get("QUEST_TPU_COMM_MODEL", "") == "default"


def _time_exchange(mesh, nbytes: int, trials: int) -> float:
    """Seconds of one neighbour-ring chunk permutation of ``nbytes`` per
    shard on ``mesh``, through the port's own exchange
    (:func:`quest_tpu_torch.parallel.exchange._ppermute`), timed with CUDA
    events on a card, the host clock elsewhere. On shards that share one
    device the permutation is copied (a relabelling would move nothing),
    so the fit is of device-to-device copies within that card."""
    from .parallel import exchange as ex
    n_dev = mesh.size
    numel = max(2, nbytes // 4)
    chunks = [torch.zeros(numel, dtype=torch.float32, device=d)
              for d in mesh.devices]
    pairs = tuple((i, (i + 1) % n_dev) for i in range(n_dev))
    timer = ex._Timed(chunks, "probe")

    def once():
        ex._ppermute(chunks, pairs, timer, copy=True)

    def timed() -> float:
        dev = mesh.devices[0]
        once()
        if dev.type == "cuda":
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(trials):
                once()
            end.record()
            for d in set(mesh.devices):
                torch.cuda.synchronize(d)
            return start.elapsed_time(end) / 1e3 / trials
        t0 = time.perf_counter()
        for _ in range(trials):
            once()
        return (time.perf_counter() - t0) / trials

    # the probe's copies are not the program's: the byte counter is
    # left as it was
    counted = ex.COUNTS["bytes"]
    try:
        return timed()
    finally:
        ex.COUNTS["bytes"] = counted


def measure_comm_model(mesh, probe_bytes=None,
                       trials: int = 5) -> CommCostModel:
    """Fit (alpha, beta) from the port's chunk permutation timed at two
    probe sizes on ``mesh``'s own devices, cached per mesh (failed or
    degenerate fits cache the default). One process drives the mesh, so
    there is one tier; the inter fields stay None. ``probe_bytes``
    defaults to 16 KiB and 128 MiB per shard on a card, where a smaller
    large probe is still set by the launches, not the bytes (16 MiB
    timed the same as 16 KiB on the H100), and 16 KiB and 1 MiB on the
    host. ``QUEST_TPU_COMM_MODEL=default`` returns the default
    unmeasured."""
    if _comm_model_pinned():
        return DEFAULT_COMM_MODEL
    key = _mesh_cache_key(mesh, "model")
    if key in _COMM_MODEL_CACHE:
        return _COMM_MODEL_CACHE[key]
    if probe_bytes is None:
        probe_bytes = (1 << 14, 1 << 27) if mesh.devices[0].type == "cuda" \
            else (1 << 14, 1 << 20)
    model = DEFAULT_COMM_MODEL
    try:
        t0, t1 = (_time_exchange(mesh, int(b), trials) for b in probe_bytes)
        b0, b1 = (float(b) for b in probe_bytes)
        beta = (t1 - t0) / (b1 - b0)
        alpha = t0 - beta * b0
        COMM_MODEL_NOTES[key] = f"probe seconds {t0!r} at {b0:.0f} B, " \
            f"{t1!r} at {b1:.0f} B"
        if beta > 0.0 and alpha == alpha and beta == beta:
            model = CommCostModel(alpha_s=max(alpha, 0.0),
                                  beta_s_per_byte=beta, source="measured")
    # quest: allow-broad-except(calibration boundary: a failed probe
    # falls back to the default model, never breaks a compile)
    except Exception as exc:
        COMM_MODEL_NOTES[key] = f"probe failed: {exc!r}"
        model = DEFAULT_COMM_MODEL
    _COMM_MODEL_CACHE[key] = model
    return model


def invalidate_comm_model() -> int:
    """Drop every cached fit so the next plan recalibrates. Returns the
    number of entries dropped."""
    n = len(_COMM_MODEL_CACHE)
    _COMM_MODEL_CACHE.clear()
    return n


def comm_model(env=None, measure: Optional[bool] = None) -> CommCostModel:
    """The cost model for ``env``'s mesh: the cached fit when one exists,
    a measured one when asked, else :data:`DEFAULT_COMM_MODEL`.
    ``measure=None`` measures on a mesh of CUDA shards and keeps the
    default on host shards (which share one memory system: a timing fit
    there only adds nondeterminism); ``QUEST_TPU_COMM_CALIBRATE=1``/``0``
    overrides, ``QUEST_TPU_COMM_MODEL=default`` pins the default."""
    mesh = getattr(env, "mesh", None) if env is not None else None
    if mesh is None or _comm_model_pinned():
        return DEFAULT_COMM_MODEL
    key = _mesh_cache_key(mesh, "model")
    if key in _COMM_MODEL_CACHE:
        return _COMM_MODEL_CACHE[key]
    if measure is None:
        flag = os.environ.get("QUEST_TPU_COMM_CALIBRATE")
        measure = flag not in ("0", "", "off") if flag is not None \
            else mesh.devices[0].type == "cuda"
    if measure:
        return measure_comm_model(mesh)
    return DEFAULT_COMM_MODEL


@dataclasses.dataclass(frozen=True)
class TierErrorModel:
    """Calibrated per-tier drift model: the modeled max amplitude error of
    one program execution at a tier is ``drift_per_gate[tier] *
    num_gates``, floored at ``floor``. Linear in depth on purpose: it may
    over-estimate the error (choosing a slower tier than needed) but must
    never promise accuracy the device cannot deliver.

    ``cost_per_gate`` holds seconds per gate pass of the calibration
    circuit at each tier, timed on the card (empty when not measured).
    """

    drift_per_gate: dict
    floor: float = 1e-15
    source: str = "default"      # "default" | "measured"
    cost_per_gate: dict = dataclasses.field(default_factory=dict)
    cost_source: str = "none"    # "none" | "silicon"

    def error(self, tier, num_gates: int) -> float:
        tier = tier_by_name(tier)
        per_gate = self.drift_per_gate.get(tier.name, tier.drift_per_gate)
        return max(per_gate * max(int(num_gates), 1), self.floor)

    def cost_ratio(self, tier) -> float:
        """Measured cost of one gate pass at ``tier`` relative to the FAST
        rung (1.0 when not measured)."""
        tier = tier_by_name(tier)
        base = self.cost_per_gate.get("fast")
        mine = self.cost_per_gate.get(tier.name)
        if not base or not mine:
            return 1.0
        return mine / base


DEFAULT_TIER_MODEL = TierErrorModel(
    drift_per_gate={t.name: t.drift_per_gate for t in TIER_LADDER})

# calibration cache keyed on the device fingerprint: the calibration runs
# at most once per process per fingerprint, failures included (they pin
# the seeds); locked so concurrent first callers do not each pay it
_TIER_MODEL_CACHE: dict = {}
_TIER_MODEL_LOCK = threading.Lock()


def _flag(name: str) -> Optional[bool]:
    raw = os.environ.get(name)
    if raw is None:
        return None
    return raw not in ("0", "", "off")


def _tier_model_pinned() -> bool:
    """``QUEST_TPU_TIER_MODEL=default`` pins the seed constants: no
    calibration ever runs (tests, reproducible tier selection)."""
    return os.environ.get("QUEST_TPU_TIER_MODEL", "") == "default"


def _on_card(env) -> bool:
    return env is not None and env.device.type == "cuda"


def _tier_silicon_auto(env) -> bool:
    """Timing each tier defaults on for an environment on a CUDA card and
    off on the CPU; ``QUEST_TPU_TIER_SILICON=1/0`` overrides."""
    flag = _flag("QUEST_TPU_TIER_SILICON")
    return _on_card(env) if flag is None else flag


def _device_fingerprint(env) -> tuple:
    """(device type, device name, device count): a model measured on one
    card is never served to another."""
    dev = env.device
    if dev.type == "cuda":
        return ("cuda", torch.cuda.get_device_name(dev),
                torch.cuda.device_count())
    return (dev.type, "", 1)


def measure_tier_model(env, num_qubits: int = 8, layers: int = 4,
                       silicon: Optional[bool] = None) -> TierErrorModel:
    """Refine the per-tier drift constants with a small fixed workload: a
    seeded brickwork runs at each tier the engine executes on ``env`` and
    its state is compared with the most accurate of them; the measured
    max |delta| per gate refines each tier's constant (4x headroom, never
    below the floor; a seed is lowered at most tenfold).

    The circuit compiles WITH fused layers. The JAX package's calibration
    compiles layer-free because on its TPU the uncompensated bf16 drift
    sat on the XLA gate path; here the bf16 products live only in the
    layer kernel's FAST dense stages, so a layer-free calibration would
    measure no FAST drift at all.

    ``silicon`` (default: on for a CUDA env) also times each tier's sweep
    on the device, best of three, into
    :attr:`TierErrorModel.cost_per_gate`. Cached per (device type, device
    name, device count, plane dtype, silicon flag)."""
    if _tier_model_pinned():
        return DEFAULT_TIER_MODEL
    if silicon is None:
        silicon = _tier_silicon_auto(env)
    key = _device_fingerprint(env) + (str(env.precision.real_dtype),
                                      bool(silicon))
    with _TIER_MODEL_LOCK:
        if key not in _TIER_MODEL_CACHE:
            _TIER_MODEL_CACHE[key] = _measure(env, num_qubits, layers,
                                              silicon)
        return _TIER_MODEL_CACHE[key]


def _measure(env, num_qubits: int, layers: int,
             silicon: bool) -> TierErrorModel:
    import numpy as np
    try:
        from .circuits import Circuit
        rng = np.random.default_rng(20260803)
        c = Circuit(num_qubits)
        n_gates = 0
        for _ in range(layers):
            for q in range(num_qubits):
                c.ry(q, float(rng.uniform(0, 2 * np.pi)))
                n_gates += 1
            for q in range(0, num_qubits - 1, 2):
                c.cnot(q, q + 1)
                n_gates += 1
        cc = c.compile(env)
        tiers = engine_tiers(env)
        pm = np.zeros((1, 0))
        states = {t.name: cc.sweep(pm, tier=t)[0].double().cpu()
                  for t in tiers}
        oracle = states[tiers[-1].name]
        drift = dict(DEFAULT_TIER_MODEL.drift_per_gate)
        for t in tiers[:-1]:
            meas = float((states[t.name] - oracle).abs().max())
            refined = max(4.0 * meas / n_gates, DEFAULT_TIER_MODEL.floor)
            drift[t.name] = max(refined, drift[t.name] / 10.0) \
                if refined < drift[t.name] else refined
        cost: dict = {}
        if silicon:
            for t in tiers:
                best = None
                for _ in range(3):
                    t0 = time.perf_counter()
                    cc.sweep(pm, tier=t)
                    env.sync()
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                cost[t.name] = best / max(n_gates, 1)
        return TierErrorModel(drift_per_gate=drift, source="measured",
                              cost_per_gate=cost,
                              cost_source="silicon" if cost else "none")
    # calibration boundary: a failed measurement keeps the conservative
    # seeds rather than failing the caller's compile
    except Exception:
        return DEFAULT_TIER_MODEL


def tier_error_model(env=None, measure: Optional[bool] = None
                     ) -> TierErrorModel:
    """The tier error model for ``env``: a calibration when asked for
    (``measure``; default ``QUEST_TPU_TIER_CALIBRATE``, else on for a CUDA
    env), else the seed constants. ``QUEST_TPU_TIER_MODEL=default`` pins
    the seeds unconditionally."""
    if env is None or _tier_model_pinned():
        return DEFAULT_TIER_MODEL
    if measure is None:
        flag = _flag("QUEST_TPU_TIER_CALIBRATE")
        measure = _on_card(env) if flag is None else flag
    if measure:
        return measure_tier_model(env)
    return DEFAULT_TIER_MODEL


def modeled_tier_error(tier, num_gates: int,
                       model: Optional[TierErrorModel] = None) -> float:
    """Modeled max amplitude error of one ``num_gates``-gate program
    execution at ``tier``."""
    return (model or DEFAULT_TIER_MODEL).error(tier, num_gates)


def engine_tiers(env) -> tuple:
    """The rungs the batched engine executes on ``env``, in rank order:
    FAST and SINGLE always (float32 planes), DOUBLE and QUAD on a float64
    environment (results leave the engine as env-dtype planes, so on a
    float32 env a DOUBLE execution would round straight back to float32,
    and QUAD's ~48-bit dd significand would too). QUAD executes through
    the engine's double-double walk as a per-dispatch tier, so a budget
    only it meets selects it, as in the JAX package."""
    tiers = [FAST_TIER, SINGLE_TIER]
    if env is not None and env.precision.real_dtype == torch.float64:
        tiers.append(DOUBLE_TIER)
        tiers.append(QUAD_TIER)
    return tuple(tiers)


def choose_tier(error_budget: float, num_gates: int, env=None,
                model: Optional[TierErrorModel] = None,
                tiers: Optional[Sequence] = None):
    """The cheapest (lowest-rank) tier whose modeled error fits
    ``error_budget``, over :func:`engine_tiers` of ``env`` (or an explicit
    ``tiers`` subset). Monotone: a tighter budget never picks a faster
    tier. Raises ``ValueError`` when no available tier fits."""
    if not (error_budget > 0.0):
        raise ValueError(f"error_budget must be > 0, got {error_budget!r}")
    model = model or (tier_error_model(env) if env is not None
                      else DEFAULT_TIER_MODEL)
    ladder = tuple(tiers) if tiers is not None else engine_tiers(env)
    for t in sorted(ladder, key=lambda t: t.rank):
        if model.error(t, num_gates) <= error_budget:
            return t
    best = min((model.error(t, num_gates) for t in ladder), default=None)
    raise ValueError(
        f"error budget {error_budget:g} is unmeetable on this "
        f"environment: the most accurate available tier models "
        f"{best:g} over {num_gates} gates (create the environment with "
        f"precision=DOUBLE for the DOUBLE and QUAD tiers, or use the "
        f"double-double compile_dd path)")


def tier_runtime_tol(tier, num_gates: int,
                     model: Optional[TierErrorModel] = None,
                     headroom: float = 8.0) -> float:
    """A norm-drift threshold for one tier: ``headroom`` times the modeled
    per-run error, floored at 1e-6 and capped at 2e-2 (a drift past two
    percent is a numerical fault at any tier)."""
    err = modeled_tier_error(tier, num_gates, model)
    return float(min(max(headroom * err, 1e-6), 2e-2))


@dataclasses.dataclass
class DispatchStats:
    """Compile-time dispatch accounting for one compiled program: how many
    recorded gates went in, how many kernels (fused groups, folded
    diagonals, layers) the final plan dispatches. Produced by
    :meth:`CompiledCircuit.dispatch_stats`. The fields are the JAX
    package's; on one device the mesh, multi-host, dynamics and cache
    fields keep their defaults."""

    gates_in: int            # ops recorded on the circuit
    kernels_out: int         # op items in the final plan
    relayouts: int           # planned all-to-all relayouts
    fused_groups: int = 0    # dense fusion groups of >= 2 gates
    diag_folds: int = 0      # diagonal gates folded into shared factors
    commuted_diagonals: int = 0  # diagonals deferred past a dense run
    max_group_gates: int = 0     # largest gates-per-group count
    cross_shard_exchanges: int = 0  # 1q pair-exchange items in the plan
    swaps_absorbed: int = 0      # SWAP gates composed into the layout perm
    collectives_fused: int = 0   # relayout pairs merged into one exchange
    comm_bytes_planned: float = 0.0  # mesh-total collective bytes per run
    comm_bytes_saved: float = 0.0    # vs the count-based planner's plan
    num_hosts: int = 1               # controller processes the mesh spans
    inter_host_collectives: int = 0  # planned collectives crossing hosts
    comm_bytes_inter_planned: float = 0.0  # mesh-total DCN bytes per run
    comm_bytes_inter_saved: float = 0.0    # vs the reordering-off plan
    batch_size: int = 0              # points in the last batched run
    host_syncs_avoided: int = 0      # device->host transfers vs per-point
    batch_sharding_mode: str = "none"  # "none" | "batch" | "amp"
    evolve_steps_fused: int = 0      # dynamics steps in one dispatch
    batched_cache_size: int = 0        # live entries in a bounded cache
    batched_cache_evictions: int = 0   # entries dropped by the bound
    precision_tier: str = "env"        # compile-time tier of this program
    modeled_tier_error: float = 0.0    # the budget model's per-run bound

    @property
    def dispatches(self) -> int:
        """Kernels the device runs per program execution (op passes plus
        relayout and pair exchanges)."""
        return self.kernels_out + self.relayouts + self.cross_shard_exchanges

    @property
    def collective_launches(self) -> int:
        """Collectives issued per program execution."""
        return self.relayouts + self.cross_shard_exchanges

    def as_dict(self) -> dict:
        return {"gates_in": self.gates_in,
                "kernels_out": self.kernels_out,
                "relayouts": self.relayouts,
                "dispatches": self.dispatches,
                "fused_groups": self.fused_groups,
                "diag_folds": self.diag_folds,
                "commuted_diagonals": self.commuted_diagonals,
                "max_group_gates": self.max_group_gates,
                "cross_shard_exchanges": self.cross_shard_exchanges,
                "swaps_absorbed": self.swaps_absorbed,
                "collectives_fused": self.collectives_fused,
                "collective_launches": self.collective_launches,
                "comm_bytes_planned": self.comm_bytes_planned,
                "comm_bytes_saved": self.comm_bytes_saved,
                "num_hosts": self.num_hosts,
                "inter_host_collectives": self.inter_host_collectives,
                "comm_bytes_inter_planned": self.comm_bytes_inter_planned,
                "comm_bytes_inter_saved": self.comm_bytes_inter_saved,
                "batch_size": self.batch_size,
                "host_syncs_avoided": self.host_syncs_avoided,
                "batch_sharding_mode": self.batch_sharding_mode,
                "evolve_steps_fused": self.evolve_steps_fused,
                "batched_cache_size": self.batched_cache_size,
                "batched_cache_evictions": self.batched_cache_evictions,
                "precision_tier": self.precision_tier,
                "modeled_tier_error": self.modeled_tier_error}


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profile everything inside the block with ``torch.profiler`` (host
    and, where a card is in use, device activity) and write a Chrome trace
    into ``logdir`` (``trace_<pid>_<n>.json``; opens in Perfetto).
    ``create_perfetto_link`` is accepted for the JAX package's signature;
    no link is made."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    n = len([f for f in os.listdir(logdir) if f.startswith("trace_")])
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}_{n}.json"))


@dataclasses.dataclass
class _Entry:
    calls: int = 0
    seconds: float = 0.0


class GateStats:
    """Count and time API-level gate calls.

    Use as a context manager around user code: it wraps the public gate
    functions of :mod:`quest_tpu_torch.api` (and the package's names) for
    the block. Times are host times of the calls; the card runs them
    asynchronously, so sync inside the block to include device
    completion."""

    GATE_NAMES = (
        "hadamard", "pauliX", "pauliY", "pauliZ", "sGate", "tGate",
        "phaseShift", "rotateX", "rotateY", "rotateZ", "rotateAroundAxis",
        "compactUnitary", "unitary", "controlledNot", "controlledPauliY",
        "controlledPhaseShift", "controlledPhaseFlip", "controlledRotateX",
        "controlledRotateY", "controlledRotateZ", "controlledCompactUnitary",
        "controlledUnitary", "multiControlledUnitary", "swapGate",
        "sqrtSwapGate", "multiRotateZ", "twoQubitUnitary", "multiQubitUnitary",
        "measure", "collapseToOutcome",
    )

    def __init__(self):
        self.entries: dict = defaultdict(_Entry)
        self._saved: dict = {}

    def __enter__(self):
        import quest_tpu_torch
        from . import api
        for name in self.GATE_NAMES:
            fn = getattr(api, name)
            self._saved[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kw):
                t0 = time.perf_counter()
                out = _fn(*args, **kw)
                e = self.entries[_name]
                e.calls += 1
                e.seconds += time.perf_counter() - t0
                return out

            setattr(api, name, wrapped)
            setattr(quest_tpu_torch, name, wrapped)
        return self

    def __exit__(self, *exc):
        import quest_tpu_torch
        from . import api
        for name, fn in self._saved.items():
            setattr(api, name, fn)
            setattr(quest_tpu_torch, name, fn)
        self._saved.clear()
        return False

    @property
    def total_calls(self) -> int:
        return sum(e.calls for e in self.entries.values())

    def report(self) -> str:
        lines = [f"{'gate':<28}{'calls':>8}{'total s':>12}{'per call us':>14}"]
        for name, e in sorted(self.entries.items(),
                              key=lambda kv: -kv[1].seconds):
            per = e.seconds / e.calls * 1e6 if e.calls else 0.0
            lines.append(f"{name:<28}{e.calls:>8}{e.seconds:>12.4f}"
                         f"{per:>14.1f}")
        return "\n".join(lines)


def probe_gate(qureg, gate_fn: Callable, num_trials: int = 20,
               targets: Optional[range] = None) -> dict:
    """The reference's rotate benchmark: time ``gate_fn(qureg, target)``
    over every target qubit, ``num_trials`` each, waiting for the device
    after each call; returns per-target mean/std/min/max seconds."""
    import numpy as np
    targets = targets or range(qureg.num_qubits_represented)
    results = {}
    for t in targets:
        gate_fn(qureg, t)                      # warm-up (kernel builds)
        qureg.env.sync()
        times = []
        for _ in range(num_trials):
            t0 = time.perf_counter()
            gate_fn(qureg, t)
            qureg.flush_gates()
            qureg.env.sync()
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times)
        results[int(t)] = {"mean": float(arr.mean()), "std": float(arr.std()),
                           "min": float(arr.min()), "max": float(arr.max())}
    return results
