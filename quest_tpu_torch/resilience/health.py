"""Numerical health guards: cheap on-device invariant checks.

A long sharded run has three silent ways to rot: NaN/Inf poisoning (one
bad kernel output propagates to the whole register), statevector norm
drift (accumulated rounding, or a genuinely non-unitary bug), and
density-matrix trace drift. QuEST aborts only on *input* validation;
nothing watches the state itself. Here :func:`check_planes` computes
the invariants as ONE torch reduction over the batch per check (two
scalars per state — the device does the O(2^n) work, the host reads
them in one transfer) and either raises a typed :class:`NumericalFault`
or — in the opt-in degraded mode — renormalizes and warns.

The check cadence is configurable (:func:`configure`, or the
``QUEST_TPU_HEALTH_EVERY`` / ``QUEST_TPU_HEALTH_MODE`` /
``QUEST_TPU_HEALTH_TOL`` environment knobs read at import): cadence 0
(default) is off, cadence k checks every k-th guarded dispatch.
``CompiledCircuit.run`` consults the active config; the serving runtime
additionally screens every batch result row
host-side (:func:`bad_plane_rows` / :func:`bad_value_rows`) so one
poisoned request gets a typed failure instead of poisoning its batch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import warnings
from typing import Optional

import numpy as np
import torch

__all__ = ["NumericalFault", "HealthConfig", "configure", "get_config",
           "guarded", "check_planes", "bad_plane_rows", "bad_value_rows",
           "plane_norms", "drifted_rows", "health_stats", "reset_stats"]


class NumericalFault(RuntimeError):
    """A state invariant failed: NaN/Inf amplitudes, statevector norm
    drift, or density-matrix trace drift. ``kind`` is one of
    ``("nan", "norm", "trace", "precision")``; ``rows`` names the
    offending batch rows (empty for an unbatched state).

    ``"precision"`` is the precision-tier fidelity monitor's kind: the
    drift exceeded the TIER's runtime tolerance (:func:`quest_tpu.
    profiling.tier_runtime_tol`) — the result is outside the error
    budget the caller stated, and the recovery policy answers by
    re-executing one tier up the ladder rather than retrying the same
    rung (:mod:`quest_tpu_torch.serve.engine`)."""

    def __init__(self, message: str, kind: str = "nan", rows: tuple = ()):
        super().__init__(message)
        self.kind = kind
        self.rows = tuple(int(r) for r in rows)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """The guard knobs. ``cadence`` — check every k-th guarded dispatch
    (0 disables). ``norm_tol`` — allowed |norm - 1| (trace for density
    registers). ``mode`` — ``"raise"`` (typed :class:`NumericalFault`)
    or ``"renormalize"`` (degraded: rescale drifting states and warn;
    NaN/Inf still raises — there is nothing to rescale)."""

    cadence: int = 1
    norm_tol: float = 1e-6
    mode: str = "raise"

    def __post_init__(self):
        if self.cadence < 0:
            raise ValueError("cadence must be >= 0")
        if not self.norm_tol > 0.0:
            raise ValueError("norm_tol must be > 0")
        if self.mode not in ("raise", "renormalize"):
            raise ValueError("mode must be 'raise' or 'renormalize'")


_config = HealthConfig(
    cadence=int(os.environ.get("QUEST_TPU_HEALTH_EVERY", "0")),
    norm_tol=float(os.environ.get("QUEST_TPU_HEALTH_TOL", "1e-6")),
    mode=os.environ.get("QUEST_TPU_HEALTH_MODE", "raise"))

_stats_lock = threading.Lock()
_stats = {"checks": 0, "failures": 0, "renormalized": 0}


def configure(config: Optional[HealthConfig] = None, **kwargs
              ) -> HealthConfig:
    """Install a new global guard config (a :class:`HealthConfig`, or
    field overrides on the current one). Returns the PREVIOUS config so
    callers can restore it."""
    global _config
    prev = _config
    _config = config if config is not None \
        else dataclasses.replace(_config, **kwargs)
    return prev


def get_config() -> HealthConfig:
    return _config


@contextlib.contextmanager
def guarded(config: Optional[HealthConfig] = None, **kwargs):
    """Scope a guard config: ``with health.guarded(cadence=1): ...``."""
    prev = configure(config, **kwargs)
    try:
        yield _config
    finally:
        configure(prev)


def health_stats() -> dict:
    with _stats_lock:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_lock:
        for k in _stats:
            _stats[k] = 0


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        _stats[key] += n


# ---------------------------------------------------------------------------
# the invariant reduction (one pass over the batch; host reads two scalars
# per state)
# ---------------------------------------------------------------------------

def _invariants(planes, is_density: bool, nq: int, batched: bool):
    """``(finite, norm)`` host arrays with one entry per state: all
    amplitudes finite, and the SQUARED 2-norm (the trace for a density
    register), reduced in the planes' dtype on their device."""
    t = planes if isinstance(planes, torch.Tensor) \
        else torch.as_tensor(np.asarray(planes))
    x = t if batched else t.unsqueeze(0)
    flat = x.reshape(x.shape[0], -1)
    if is_density:
        diag = torch.arange(1 << nq, device=x.device) * ((1 << nq) + 1)
        norm = x[:, 0, diag].sum(dim=1)
    else:
        norm = (flat * flat).sum(dim=1)
    both = torch.stack([torch.isfinite(flat).all(dim=1).to(norm.dtype),
                        norm]).cpu().numpy()
    return both[0] != 0, both[1]


def check_planes(planes, *, is_density: bool = False,
                 num_qubits: Optional[int] = None,
                 config: Optional[HealthConfig] = None,
                 where: str = "state", drift_kind: Optional[str] = None):
    """Verify the invariants of packed float planes — ``(2, 2^n)`` or a
    batched ``(B, 2, 2^n)`` — and return them (possibly renormalized in
    degraded mode). ``num_qubits`` is the LOGICAL qubit count for
    density registers (their planes hold 4^nq amplitudes).

    Raises :class:`NumericalFault` on NaN/Inf always, and on norm/trace
    drift beyond ``config.norm_tol`` unless ``config.mode ==
    "renormalize"`` (then the drifting states are rescaled and a
    ``UserWarning`` names the drift). ``drift_kind`` overrides the
    fault kind a drift raises with (the precision-tier fidelity monitor
    passes ``"precision"`` so its violations classify for tier
    escalation, not quarantine)."""
    cfg = config or _config
    batched = getattr(planes, "ndim", 2) == 3
    if is_density and num_qubits is None:
        raise ValueError("density-plane checks need num_qubits (logical)")
    nq = int(num_qubits or 0)
    finite, norm = _invariants(planes, bool(is_density), nq, batched)
    if not is_density:
        # the device reduction is the SQUARED 2-norm; the documented
        # contract (|norm - 1| <= norm_tol) is on the norm itself, and
        # the density path's trace is linear — take the root so both
        # register kinds honour the same tolerance
        norm = np.sqrt(np.maximum(norm, 0.0))
    _count("checks")
    nan_rows = np.nonzero(~finite)[0]
    drift = np.abs(norm - 1.0) > cfg.norm_tol
    drift_rows = np.nonzero(drift & finite)[0]
    if nan_rows.size == 0 and drift_rows.size == 0:
        return planes
    _count("failures")
    label = "trace" if is_density else "norm"
    if nan_rows.size:
        rows = tuple(int(r) for r in nan_rows) if batched else ()
        raise NumericalFault(
            f"non-finite amplitudes in {where}"
            + (f" (batch rows {list(rows)})" if rows else ""),
            kind="nan", rows=rows)
    if cfg.mode == "renormalize":
        _count("renormalized", int(drift_rows.size))
        warnings.warn(
            f"{where}: {label} drifted to "
            f"{[round(float(norm[r]), 12) for r in drift_rows[:4]]}"
            f"{'...' if drift_rows.size > 4 else ''} "
            f"(tol {cfg.norm_tol}); renormalizing (degraded mode)",
            UserWarning, stacklevel=3)
        scale = np.ones_like(norm)
        safe = np.where(norm <= 0.0, 1.0, norm)
        # norm is now linear in the state for BOTH kinds (2-norm for
        # statevectors, trace for densities): planes scale by 1/norm
        scale = np.where(drift, 1.0 / safe, scale)
        if isinstance(planes, torch.Tensor):
            s = torch.as_tensor(scale, dtype=planes.dtype,
                                device=planes.device)
        else:
            s = np.asarray(scale, dtype=np.asarray(planes).dtype)
        return planes * (s.reshape((-1, 1, 1)) if batched else s[0])
    rows = tuple(int(r) for r in drift_rows) if batched else ()
    vals = [float(norm[r]) for r in (drift_rows if batched else [0])]
    raise NumericalFault(
        f"{where}: {label} drifted to {vals[:4]} (tol {cfg.norm_tol})"
        + (f" in batch rows {list(rows)}" if rows else ""),
        kind=(drift_kind or ("trace" if is_density else "norm")),
        rows=rows)


# ---------------------------------------------------------------------------
# host-side row screens (the serving engine screens host copies)
# ---------------------------------------------------------------------------

def bad_plane_rows(planes: np.ndarray) -> np.ndarray:
    """Row indices of a host ``(B, 2, 2^n)`` plane batch holding any
    non-finite value (the serving engine's per-request poison screen)."""
    flat = np.asarray(planes).reshape(planes.shape[0], -1)
    return np.nonzero(~np.isfinite(flat).all(axis=1))[0]


def bad_value_rows(values) -> np.ndarray:
    """Indices of non-finite scalars in a 1-D result vector (energies,
    sampling norms)."""
    return np.nonzero(~np.isfinite(np.asarray(values, dtype=np.float64)))[0]


def plane_norms(planes: np.ndarray, is_density: bool = False,
                num_qubits: Optional[int] = None) -> np.ndarray:
    """Per-row norm (statevector 2-norm) or trace of a host
    ``(B, 2, 2^n)`` plane batch — the serving layer's tier fidelity
    observable (non-finite rows report NaN; screen those with
    :func:`bad_plane_rows` first)."""
    p = np.asarray(planes)
    if is_density:
        if num_qubits is None:
            raise ValueError("density-plane norms need num_qubits "
                             "(logical)")
        diag = np.arange(1 << num_qubits) * ((1 << num_qubits) + 1)
        return p[:, 0, diag].sum(axis=1, dtype=np.float64)
    # einsum with a forced f64 accumulator: no full-size f64 copy of
    # the batch (a 25q x16 batch would spike ~17 GB of temporaries the
    # upcast-then-square form allocates to produce 16 scalars)
    flat = p.reshape(p.shape[0], -1)
    return np.sqrt(np.einsum("bi,bi->b", flat, flat,
                             dtype=np.float64))


def drifted_rows(values, tol: float) -> np.ndarray:
    """Indices of FINITE entries in a 1-D norm/trace vector that drift
    from 1 by more than ``tol`` (the per-request precision-violation
    screen; NaN rows are the NaN screen's business, not this one's)."""
    v = np.asarray(values, dtype=np.float64)
    return np.nonzero(np.isfinite(v) & (np.abs(v - 1.0) > float(tol)))[0]
