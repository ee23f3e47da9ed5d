"""The precision-tier error model, and compile-time dispatch accounting.

Counterpart of the tier half of the JAX package's ``profiling.py`` and of
its :class:`DispatchStats`. The
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

import dataclasses
import os
import threading
import time
from typing import Optional, Sequence

import torch

from .config import (DOUBLE_TIER, FAST_TIER, QUAD_TIER, SINGLE_TIER,
                     TIER_LADDER, tier_by_name)

__all__ = ["TierErrorModel", "DEFAULT_TIER_MODEL", "tier_error_model",
           "measure_tier_model", "modeled_tier_error", "engine_tiers",
           "choose_tier", "tier_runtime_tol", "DispatchStats"]


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
