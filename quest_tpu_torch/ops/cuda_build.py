"""Building the port's CUDA kernels at first use.

Every ``csrc/*.cu`` file is one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` and loaded with :mod:`ctypes`. The
libraries of one build live in ``build/quest_tpu_torch/<key>/``, where the
key is a hash over ALL sources in ``csrc/`` (the ``.cuh`` headers they
share included) and the flags: a change to any source rebuilds every
library, and the first kernel a program calls builds them all, one
``nvcc`` per source, all started together. The build runs once per
process under a lock, whichever thread asks first (a serving dispatcher
and a caller warming a program may ask at the same moment).

A build that fails raises :class:`KernelBuildError`, and a launch that
CUDA refuses raises :class:`KernelLaunchError`: the serving runtime
classifies both as fatal (no retry, no fallback).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "KernelBuildError", "KernelLaunchError",
           "sources_key", "build_all", "library"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    """A kernel library could not be built (no ``nvcc``, or ``nvcc``
    failed on a source)."""


class KernelLaunchError(RuntimeError):
    """A built kernel's C entry point refused a launch (its CUDA error
    string is the message)."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found: the port's kernels are built "
                           "from quest_tpu_torch/csrc with the CUDA "
                           "toolkit")


def _sources() -> list:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def sources_key() -> str:
    """Hash over every source in ``csrc/`` and the compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def _build_dir() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "quest_tpu_torch"


@functools.lru_cache(maxsize=None)
def _build_all() -> dict:
    out_dir = _build_dir() / sources_key()
    out_dir.mkdir(parents=True, exist_ok=True)
    units = [p for p in _sources() if p.suffix == ".cu"]
    procs = {}
    try:
        for src in units:
            lib_path = out_dir / f"{src.stem}.so"
            if lib_path.exists():
                continue
            tmp = out_dir / f".{src.stem}.{os.getpid()}.tmp"
            procs[src.stem] = (src, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = {}
        failed = []
        for stem, (src, tmp, proc) in procs.items():
            logs[stem] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {src}:\n{logs[stem]}")
            else:
                os.replace(tmp, out_dir / f"{stem}.so")
    finally:
        for _, _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise KernelBuildError("\n".join(failed))
    return {src.stem: (ctypes.CDLL(str(out_dir / f"{src.stem}.so")),
                       str(out_dir / f"{src.stem}.so"),
                       logs.get(src.stem, ""))
            for src in units}


_BUILD_LOCK = threading.Lock()


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` not yet built under the current key
    (all ``nvcc`` processes at once) and load each library, once per
    process: concurrent first callers wait on one lock and share the one
    build. Returns ``{stem: (ctypes.CDLL, path, compiler_output)}``; the
    output is empty for a library found already built."""
    with _BUILD_LOCK:
        return _build_all()


# the cache's accounting and reset, where callers read them
build_all.cache_info = _build_all.cache_info
build_all.cache_clear = _build_all.cache_clear


def library(stem: str) -> tuple:
    """``(ctypes.CDLL, path, compiler_output)`` of ``csrc/<stem>.cu``,
    building every library first if needed."""
    return build_all()[stem]
