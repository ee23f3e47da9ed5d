"""Checkpoint-backed segment recovery for long executions.

Without it a transient fault (or NaN poisoning) 90% through a long run
throws the whole computation away. Here:

- :func:`checkpointed_run` splits a recorded :class:`Circuit` into
  segments, snapshots the register between them (via
  :mod:`quest_tpu_torch.checkpoint`, one ``.npz`` per snapshot), and on a
  transient/poison fault restores the LAST GOOD
  snapshot and re-executes only the failed segment (bounded restart
  budget; fatal caller errors re-raise immediately);
- :func:`checkpointed_sweep` does the same for the batched engine along
  the BATCH axis: row segments execute through ``CompiledCircuit.
  sweep``, completed segments append to an on-disk ``.npz`` progress
  file, and a faulted (or NaN-screened) segment re-executes without
  touching finished rows. The progress file makes the sweep resumable
  across PROCESS restarts too (``resume=True`` picks up where a killed
  run stopped, guarded by a parameter-matrix digest).

Both return recovery accounting (segments run, restarts, checkpoint
count) so chaos tests can assert the machinery actually engaged. The
progress files of the optimizer and dynamics handles
(:func:`opt_progress_save`, :func:`dyn_progress_save`) live here too.

A copy of the JAX package's module: the file formats and digests are its
own, so a progress file written by one package is accepted by the other's
loader under the same digest. A fault on the card that classifies FATAL
(a kernel that failed to build or launch, a sticky CUDA error) re-raises
at once, with the last snapshot intact.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from .health import HealthConfig, check_planes, bad_plane_rows, NumericalFault
from .recovery import classify, FATAL

__all__ = ["split_circuit", "checkpointed_run", "checkpointed_sweep",
           "opt_progress_save", "opt_progress_load",
           "dyn_progress_save", "dyn_progress_load"]


def split_circuit(circuit, num_segments: int) -> list:
    """Slice a recorded circuit into ``num_segments`` contiguous
    sub-circuits (op granularity, even split; empty tails dropped).
    Every sub-circuit carries the FULL parameter registry, so one
    ``params`` dict drives all segments."""
    from ..circuits import Circuit
    if num_segments < 1:
        raise ValueError("num_segments must be >= 1")
    ops = list(circuit.ops)
    num_segments = min(num_segments, max(1, len(ops)))
    per = -(-len(ops) // num_segments)       # ceil
    out = []
    for lo in range(0, len(ops), per):
        seg = Circuit(circuit.num_qubits)
        seg.ops = ops[lo:lo + per]
        seg._params = list(circuit._params)
        out.append(seg)
    return out or [circuit]


def _snap_path(ckpt_dir: str, k: int) -> str:
    return os.path.join(ckpt_dir, f"seg-{k:04d}")


def checkpointed_run(circuit, qureg, params: Optional[dict] = None, *,
                     num_segments: int = 4, ckpt_dir: Optional[str] = None,
                     max_restarts: int = 3,
                     health: Optional[HealthConfig] = None,
                     keep_checkpoints: bool = False, **compile_kwargs
                     ) -> dict:
    """Run ``circuit`` on ``qureg`` in checkpointed segments.

    Each segment compiles against ``qureg.env`` and runs through the
    normal compiled path; the register is snapshotted before segment 0
    and after every completed segment. A transient executor fault (see
    :func:`quest_tpu_torch.resilience.recovery.classify`) or a failed
    inter-segment health check restores the last good snapshot and
    re-executes the segment, up to ``max_restarts`` total; fatal errors
    re-raise with the snapshot intact. ``health`` (a
    :class:`HealthConfig`) enables an invariant check after EVERY
    segment regardless of the global cadence.

    Returns ``{"segments", "restarts", "checkpoints", "ckpt_dir"}``
    (``ckpt_dir`` survives only with ``keep_checkpoints=True``)."""
    from .. import checkpoint as ckpt
    own_dir = ckpt_dir is None
    if own_dir:
        ckpt_dir = tempfile.mkdtemp(prefix="quest_tpu_torch_segrun_")
    os.makedirs(ckpt_dir, exist_ok=True)
    segs = split_circuit(circuit, num_segments)
    compiled = [s.compile(qureg.env, **compile_kwargs) for s in segs]
    restarts = 0
    checkpoints = 0
    try:
        ckpt.save(qureg, _snap_path(ckpt_dir, 0))
        checkpoints += 1
        k = 0
        while k < len(compiled):
            try:
                compiled[k].run(qureg, params)
                if health is not None:
                    nq = qureg.num_qubits_represented
                    qureg.state = check_planes(
                        qureg.state, is_density=qureg.is_density_matrix,
                        num_qubits=nq, config=health,
                        where=f"segment {k}")
            # classified barrier: classify() re-raises FATAL; everything
            # else restores the last good snapshot and re-executes
            except Exception as e:
                if classify(e) == FATAL or restarts >= max_restarts:
                    raise
                restarts += 1
                ckpt.load(qureg, _snap_path(ckpt_dir, k))
                continue                      # re-execute this segment
            k += 1
            ckpt.save(qureg, _snap_path(ckpt_dir, k))
            checkpoints += 1
    finally:
        if not keep_checkpoints:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"segments": len(compiled), "restarts": restarts,
            "checkpoints": checkpoints,
            "ckpt_dir": ckpt_dir if keep_checkpoints else None}


def _pm_digest(pm: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(pm, dtype=np.float64).tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# optimizer-in-the-loop progress (serve/optimize.py)
# ---------------------------------------------------------------------------
#
# The optimization handle checkpoints every completed iterate the same
# way checkpointed_sweep checkpoints row segments: one atomic .npz
# (checkpoint.atomic_savez — a crash mid-write leaves the previous
# progress whole) guarded by a PROBLEM digest, so a resumed run
# continues a killed optimization only when the circuit + observables +
# optimizer configuration actually match. Mismatch or torn files mean
# "start clean", never a crash and never the wrong problem's iterates.


def opt_progress_save(path: str, *, digest: str, iteration: int,
                      x: np.ndarray, value: float,
                      opt_state: Optional[dict] = None) -> None:
    """Atomically persist one completed optimizer iterate: the iterate
    index, the parameter vector, its measured objective value, and the
    optimizer's own state arrays (Adam moments etc., saved under
    ``opt_<name>`` keys)."""
    from .. import checkpoint as ckpt
    arrays = {"digest": np.asarray(digest),
              "iteration": np.asarray(int(iteration)),
              "x": np.ascontiguousarray(x, dtype=np.float64),
              "value": np.asarray(float(value))}
    for k, v in (opt_state or {}).items():
        arrays[f"opt_{k}"] = np.asarray(v)
    ckpt.atomic_savez(path, **arrays)


def opt_progress_load(path: str, digest: str) -> Optional[dict]:
    """Read a saved optimizer iterate back, or None when the file is
    missing, torn, or belongs to a different problem (digest
    mismatch — silently resuming someone else's iterates would walk
    the WRONG energy surface). Returns ``{"iteration", "x", "value",
    "opt_state"}``."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as f:
            if str(f["digest"]) != digest:
                return None
            out = {"iteration": int(f["iteration"]),
                   "x": np.asarray(f["x"], dtype=np.float64),
                   "value": float(f["value"]),
                   "opt_state": {k[len("opt_"):]: np.asarray(f[k])
                                 for k in f.files
                                 if k.startswith("opt_")}}
        return out
    # torn-archive boundary: a corrupt progress file means "start
    # clean", never a crash
    except Exception:
        return None


def dyn_progress_save(path: str, *, digest: str, segment: int,
                      planes: np.ndarray, energies: np.ndarray,
                      welford: np.ndarray,
                      residual: Optional[float] = None) -> None:
    """Atomically persist one completed Hamiltonian-dynamics SEGMENT
    (an ``evolve``/``ground_state`` run's checkpoint boundary): the
    segment index, the packed ``(2, 2^n)`` state planes the next
    segment seeds from, the per-step energies accumulated so far, the
    pooled Welford ``(count, mean, M2)`` carry, and (ground runs) the
    last device-computed convergence residual. The planes ARE the
    resume state — a run killed mid-segment restarts bit-exactly from
    here, because segment boundaries are the only host-visible points
    of the whole evolution."""
    from .. import checkpoint as ckpt
    arrays = {"digest": np.asarray(digest),
              "segment": np.asarray(int(segment)),
              "planes": np.ascontiguousarray(planes, dtype=np.float64),
              "energies": np.ascontiguousarray(energies,
                                               dtype=np.float64),
              "welford": np.ascontiguousarray(welford,
                                              dtype=np.float64)}
    if residual is not None:
        arrays["residual"] = np.asarray(float(residual))
    ckpt.atomic_savez(path, **arrays)


def dyn_progress_load(path: str, digest: str) -> Optional[dict]:
    """Read a saved dynamics segment back, or None when the file is
    missing, torn, or belongs to a different run (digest mismatch — a
    different Hamiltonian, spec contract, start state, or tier must
    start clean, never continue someone else's trajectory). Returns
    ``{"segment", "planes", "energies", "welford", "residual"}``."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as f:
            if str(f["digest"]) != digest:
                return None
            out = {"segment": int(f["segment"]),
                   "planes": np.asarray(f["planes"], dtype=np.float64),
                   "energies": np.asarray(f["energies"],
                                          dtype=np.float64),
                   "welford": np.asarray(f["welford"],
                                         dtype=np.float64),
                   "residual": (float(f["residual"])
                                if "residual" in f.files else None)}
        return out
    # torn-archive boundary: a corrupt progress file means "start
    # clean", never a crash
    except Exception:
        return None


def checkpointed_sweep(cc, param_matrix, *, segment_rows: int = 64,
                       ckpt_path: Optional[str] = None,
                       max_restarts: int = 3, resume: bool = True,
                       keep_checkpoint: bool = False,
                       yield_to: Optional[Callable[[], bool]] = None,
                       yield_hold_s: float = 5.0):
    """A :meth:`CompiledCircuit.sweep` that survives faults and process
    restarts: the ``(B, P)`` parameter matrix executes in row segments
    of ``segment_rows``, each completed segment's planes are written to
    their own ``.npy`` sidecar next to the ``.npz`` metadata file at
    ``ckpt_path`` (per-segment I/O stays O(segment), not O(rows done)),
    and a faulted or NaN-screened segment re-executes from the last
    good row (bounded by ``max_restarts``). With ``resume=True`` an
    existing progress file whose parameter digest matches continues
    where it stopped.

    ``yield_to`` enables cooperative preemption at the segment
    boundary (the checkpoint boundary, so a preempted sweep that dies
    mid-hold still resumes bit-exactly): a zero-argument callable —
    e.g. a :class:`~quest_tpu_torch.serve.SimulationService`'s
    ``interactive_pressure`` — polled before each segment; while it
    returns truthy the sweep yields the device to the interactive burst,
    at most ``yield_hold_s`` seconds per preemption.

    Returns ``(planes, stats)``: the full ``(B, 2, 2^n)`` result (host
    numpy in the env's plane dtype; each segment copied off the device
    once) and
    ``{"segments", "restarts", "resumed_rows", "preemptions"}``."""
    from .. import checkpoint as ckpt
    pm = np.asarray(param_matrix, dtype=np.float64)
    if pm.ndim != 2:
        raise ValueError(f"param_matrix must be 2-D; got shape {pm.shape}")
    if segment_rows < 1:
        raise ValueError("segment_rows must be >= 1")
    B = pm.shape[0]
    own_path = ckpt_path is None
    if own_path:
        fd, ckpt_path = tempfile.mkstemp(suffix=".npz",
                                         prefix="quest_tpu_torch_segsweep_")
        os.close(fd)
        os.unlink(ckpt_path)      # mkstemp created it; savez rewrites
    elif not ckpt_path.endswith(".npz"):
        # np.savez appends ".npz" to a bare path; normalize up front or
        # the resume check and cleanup would look at the wrong file
        ckpt_path += ".npz"

    def _seg_path(i: int) -> str:
        return f"{ckpt_path}.seg{i:04d}.npy"

    def _cleanup(n_segs: int) -> None:
        for p in [ckpt_path] + [_seg_path(i) for i in range(n_segs)]:
            try:
                os.unlink(p)
            except OSError:
                pass

    digest = _pm_digest(pm)
    done = 0
    chunks: list = []
    n_saved = 0
    if resume and os.path.exists(ckpt_path):
        try:
            with np.load(ckpt_path, allow_pickle=False) as f:
                # a digest mismatch silently restarting would return
                # planes for the WRONG parameters; start clean instead
                if str(f["digest"]) == digest and int(f["batch"]) == B:
                    done = int(f["done"])
                    n_saved = int(f["segments"])
        # torn-archive boundary: a corrupt progress file means "start
        # clean", never a crash
        except Exception:
            # torn/truncated archive (crash mid-write before the atomic
            # rename landed, or pre-atomic leftovers): a corrupt
            # progress file must mean "start clean", never a crash here
            done, n_saved = 0, 0
        try:
            chunks = [np.load(_seg_path(i)) for i in range(n_saved)]
        except (OSError, ValueError):
            done, n_saved, chunks = 0, 0, []   # sidecars gone/torn: restart
        if chunks and sum(c.shape[0] for c in chunks) != done:
            done, n_saved, chunks = 0, 0, []   # torn progress: restart
    resumed = done
    restarts = 0
    segments = 0
    preemptions = 0
    try:
        while done < B:
            if yield_to is not None and yield_to():
                # segment boundary == checkpoint boundary: the hold
                # can't corrupt progress, only delay it
                preemptions += 1
                t0 = time.monotonic()
                while (time.monotonic() - t0 < yield_hold_s
                       and yield_to()):
                    time.sleep(2e-3)
            hi = min(B, done + segment_rows)
            try:
                planes = cc.sweep(pm[done:hi]).cpu().numpy()
                bad = bad_plane_rows(planes)
                if bad.size:
                    raise NumericalFault(
                        f"non-finite planes in sweep rows "
                        f"{[int(done + r) for r in bad]}", kind="nan",
                        rows=tuple(int(done + r) for r in bad))
            # classified barrier: classify() re-raises FATAL; transient
            # faults re-execute the segment from the on-disk progress
            except Exception as e:
                if classify(e) == FATAL or restarts >= max_restarts:
                    raise
                restarts += 1
                continue                      # re-execute this segment
            segments += 1
            chunks.append(planes)
            done = hi
            np.save(_seg_path(n_saved), planes)
            n_saved += 1
            # atomic: the metadata commits AFTER its sidecar exists, and
            # a crash mid-write leaves the previous progress file whole
            # (a torn .npz would otherwise poison the next resume)
            ckpt.atomic_savez(ckpt_path, done=done, batch=B,
                              digest=digest, segments=n_saved)
        out = np.concatenate(chunks, axis=0) if chunks \
            else np.zeros((0,), dtype=np.float64)
    finally:
        if own_path and not keep_checkpoint:
            _cleanup(n_saved)
    if not own_path and not keep_checkpoint:
        _cleanup(n_saved)
    return out, {"segments": segments, "restarts": restarts,
                 "resumed_rows": resumed, "preemptions": preemptions}
