"""Checkpoint / resume for register state.

The reference's story is debug-grade: per-rank CSV dumps (``reportState``,
``QuEST_common.c:215-231``) reloadable via ``initStateFromSingleFile``
(``QuEST_cpu.c:1599``). Here a register is one ``(2, 2^N)`` tensor of
float planes (``(4, 2^N)`` double-double planes for QUAD/QUAD64), saved
with the metadata needed to refuse a wrong restore: qubit count, register
kind, precision, plane count and plane dtype.

The JAX package saves with orbax where it is installed and falls back to
one ``.npz`` file; orbax is a JAX library, so the port keeps the ``.npz``
form only: :func:`save` writes ``path + ".npz"`` and :func:`load` reads
it. The archive's layout and metadata are the JAX package's, so a file
written by either package's :func:`save_npz` loads in the other, bit for
bit. The planes go to the host once, whole, and a restore puts them on
the register's device in one copy.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import torch

from .qureg import Qureg

__all__ = ["save", "load", "save_npz", "load_npz", "atomic_savez",
           "atomic_write_json", "CheckpointMismatch"]


def atomic_savez(path: str, **arrays) -> None:
    """``np.savez`` with crash-safe replace semantics: the archive is
    written to a temp file in the SAME directory, fsynced, then
    ``os.replace``d over ``path``, so a crash mid-write leaves the last
    good file intact instead of a torn half-archive. ``path`` must
    already carry its ``.npz`` suffix (``np.savez`` would append one to
    the temp name and the replace would miss it)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz",
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    # cleanup-and-reraise: the temp file is unlinked on ANY interruption,
    # KeyboardInterrupt included; the exception always propagates
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_json(path: str, doc: dict) -> None:
    """:func:`atomic_savez`'s crash-safe replace for a JSON document
    (same-directory temp + fsync + ``os.replace``): a crash mid-write
    leaves the previous file intact."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json",
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f, sort_keys=True, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    # cleanup-and-reraise, as in atomic_savez
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class CheckpointMismatch(ValueError):
    """The checkpoint's metadata does not match the target register:
    qubit count, register kind, precision, plane layout, or dtype. A
    subclass of ``ValueError`` carrying ``field``: which check failed."""

    def __init__(self, message: str, field: str = ""):
        super().__init__(message)
        self.field = field


def _np_real_dtype(qureg: Qureg) -> np.dtype:
    return np.dtype(str(qureg.real_dtype).replace("torch.", ""))


def _meta(qureg: Qureg) -> dict:
    return {
        "num_qubits_represented": qureg.num_qubits_represented,
        "is_density_matrix": qureg.is_density_matrix,
        "precision": qureg.env.precision.name,
        # plane layout + dtype: a QUAD (4-plane double-double) state and a
        # float32 state are both silently corruptible by a cast-only
        # restore; record enough to refuse loudly
        "num_planes": 4 if qureg.is_quad else 2,
        "real_dtype": str(_np_real_dtype(qureg)),
    }


def _check_meta(meta: dict, qureg: Qureg) -> None:
    if (meta["num_qubits_represented"] != qureg.num_qubits_represented
            or meta["is_density_matrix"] != qureg.is_density_matrix):
        raise CheckpointMismatch(
            f"checkpoint holds a "
            f"{meta['num_qubits_represented']}-qubit "
            f"{'density' if meta['is_density_matrix'] else 'statevector'} "
            f"register; target register is "
            f"{qureg.num_qubits_represented}-qubit "
            f"{'density' if qureg.is_density_matrix else 'statevector'}",
            field="register")
    saved_prec = meta.get("precision")
    if saved_prec is not None and saved_prec != qureg.env.precision.name:
        raise CheckpointMismatch(
            f"checkpoint was saved in {saved_prec} precision; target "
            f"register uses {qureg.env.precision.name}: create the env "
            f"with precision={saved_prec} (or re-save) to restore",
            field="precision")
    saved_planes = meta.get("num_planes")
    want_planes = 4 if qureg.is_quad else 2
    if saved_planes is not None and int(saved_planes) != want_planes:
        raise CheckpointMismatch(
            f"checkpoint holds {saved_planes}-plane state but the target "
            f"register packs {want_planes} planes "
            f"({'QUAD double-double' if qureg.is_quad else 'real/imag'})",
            field="num_planes")
    saved_dtype = meta.get("real_dtype")
    if saved_dtype is not None and \
            np.dtype(saved_dtype) != _np_real_dtype(qureg):
        raise CheckpointMismatch(
            f"checkpoint planes are {saved_dtype}; target register uses "
            f"{_np_real_dtype(qureg)}: restoring through a silent cast "
            f"would corrupt precision", field="real_dtype")


def save(qureg: Qureg, path: str) -> None:
    """Checkpoint a register to ``path + ".npz"`` (the JAX package's form
    where orbax is not installed)."""
    save_npz(qureg, path + ".npz")


def load(qureg: Qureg, path: str) -> None:
    """Restore a checkpoint written by :func:`save` into ``qureg``, on its
    env's device."""
    path = os.path.abspath(path)
    if os.path.exists(path + ".npz"):
        load_npz(qureg, path + ".npz")
        return
    raise FileNotFoundError(path)


def save_npz(qureg: Qureg, filename: str) -> None:
    """Copy the planes to the host once and save them with their metadata
    as ``.npz`` (atomic: a crash mid-write cannot corrupt the previous
    checkpoint)."""
    qureg.ensure_canonical()
    if not filename.endswith(".npz"):
        filename += ".npz"     # np.savez would append it past the replace
    atomic_savez(filename, state=qureg.state.cpu().numpy(),
                 meta=json.dumps(_meta(qureg)))


def load_npz(qureg: Qureg, filename: str) -> None:
    with np.load(filename, allow_pickle=False) as data:
        _check_meta(json.loads(str(data["meta"])), qureg)
        host = data["state"].astype(_np_real_dtype(qureg), copy=False)
    planes = 4 if qureg.is_quad else 2
    if host.shape != (planes, qureg.num_amps_total):
        raise CheckpointMismatch(
            f"checkpoint state has shape {host.shape}; target register "
            f"expects ({planes}, {qureg.num_amps_total})", field="shape")
    # the planes verbatim (a QUAD register's four dd planes too:
    # recombining through a complex vector would lose the lo planes)
    qureg.state = torch.from_numpy(np.ascontiguousarray(host)).to(
        qureg.device)
