"""Content digests of recorded circuits and the persistent warm-start
cache: ``warm()`` means "load", not "pack the world again".

Every (re)started serving process pays the same setup for the same
programs before its first dispatch: on the card, the layers' descriptors
and operand pools packed and uploaded (``ops/layer_kernel.pack_layer``)
and the plain ops' static operators put on the device. The JAX package
serialises a compiled XLA executable per warm form; the port runs eagerly
and caches no executable (its kernels are built once per source hash,
``ops/cuda_build.py``), so its artifact is what ``precompile()`` and a
form's first dispatch compute:

- for each warm form, a ``(circuit digest, env fingerprint, form key,
  exact arg shapes)`` slot, exactly the JAX package's coordinates
  (:meth:`~quest_tpu_torch.circuits.CompiledCircuit.lower_batched`);
- the artifact (:class:`WarmArtifact`): the packed operands of every layer
  the form launches (a gradient form's adjoint layers too) at the form's
  tier, the static operators of the plan's plain ops, and a JSON
  description of the plan that produced them;
- stored as one torch file of tensors plus that description, written
  atomically, and loaded with ``torch.load(..., weights_only=True)``, so
  no code is unpickled. On a hit the form packs nothing
  (:meth:`~quest_tpu_torch.circuits.CompiledCircuit.install_batched_aot`
  installs the operands where a launch finds them).

Keying refuses to guess: the circuit digest (byte for byte the JAX
package's) hashes the recorded op stream, and :func:`env_fingerprint`
names the package, torch's and CUDA's versions, the device's name and
count, the precision and plane dtype, and the kernel sources' hash, so
an artifact of the JAX package in the same ``$QUEST_TPU_WARM_CACHE_DIR``,
or of another kernel build, is a miss, never a wrong load. A torn or
corrupt artifact, or one whose description no longer matches the plan,
counts ``errors``, is rebuilt fresh and overwrites its slot.

``WarmCache.stats()`` reports hits / misses / stores / errors / skips; the
serving runtime mirrors hits and misses into its metrics.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
from typing import Optional

import numpy as np
import torch

__all__ = ["WarmCache", "WarmArtifact", "circuit_digest", "env_fingerprint",
           "WARM_CACHE_ENV"]

WARM_CACHE_ENV = "QUEST_TPU_WARM_CACHE_DIR"

# fixed probe bindings for parametrised-op sampling: two distinct per-name
# values pin WHICH parameter drives WHICH op (a code-object hash alone
# cannot see closure contents)
_PROBES = ((0.137, 0.0173), (1.113, 0.0311))


def _probe_params(names, base: float, step: float) -> dict:
    return {nm: base + step * i for i, nm in enumerate(names)}


def _hash_array(h, arr) -> None:
    if hasattr(arr, "detach"):           # a torch tensor from a gate callable
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(a.tobytes())


def _hash_consts(h, consts) -> None:
    """Digest a code object's constants. Nested code objects (inner
    lambdas, comprehensions) are hashed structurally: their repr embeds a
    per-process memory address and an absolute source path."""
    for c in consts:
        if hasattr(c, "co_code"):
            h.update(c.co_name.encode())
            h.update(c.co_code)
            _hash_consts(h, c.co_consts)
        else:
            h.update(repr(c).encode())


def _hash_callable(h, fn, names) -> bool:
    """Digest a parametrised matrix/diag callable: code identity plus
    sample evaluations at the probe bindings. Returns False when the
    callable cannot be probed (the op then has no stable content key and
    the whole circuit is uncacheable)."""
    code = getattr(fn, "__code__", None)
    h.update(getattr(fn, "__qualname__", type(fn).__name__).encode())
    if code is not None:
        h.update(code.co_code)
        _hash_consts(h, code.co_consts)
    try:
        for base, step in _PROBES:
            out = fn(_probe_params(names, base, step))
            if isinstance(out, (list, tuple)):
                for m in out:
                    _hash_array(h, m)
            else:
                _hash_array(h, out)
    # quest: allow-broad-except(digest boundary: an unhashable exotic
    # gate payload means "uncacheable", never a caller-visible error)
    except Exception:
        return False
    return True


def circuit_digest(circuit, is_density: bool = False) -> Optional[str]:
    """Stable content digest of a recorded :class:`~quest_tpu_torch.
    circuits.Circuit`. None when any op resists content addressing (never
    guess: an aliased key would load a wrong program)."""
    h = hashlib.sha256()
    h.update(f"v1|{circuit.num_qubits}|{int(bool(is_density))}|".encode())
    names = tuple(circuit.param_names)
    h.update("|".join(names).encode())
    for op in circuit.ops:
        h.update(f"|{op.kind}|{op.targets}|{op.ctrl_mask}|"
                 f"{op.flip_mask}|".encode())
        if op.mat is not None:
            _hash_array(h, op.mat)
        if op.diag is not None:
            _hash_array(h, op.diag)
        for fn in (op.mat_fn, op.diag_fn):
            if fn is not None and not _hash_callable(h, fn, names):
                return None
        if op.kraus is not None:
            if callable(op.kraus):
                if not _hash_callable(h, op.kraus, names):
                    return None
            else:
                for m in op.kraus:
                    if callable(m):
                        if not _hash_callable(h, m, names):
                            return None
                    else:
                        _hash_array(h, m)
    return h.hexdigest()


def _device_identity(device) -> tuple:
    """``(name, count)`` of the devices an env's artifacts are made for."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device), torch.cuda.device_count()
    return "cpu", 1


def env_fingerprint(env) -> str:
    """Everything a stored artifact implicitly depends on: a mismatch in
    any field must be a cache MISS. The fields: the package, torch's and
    CUDA's versions, the device's type and name, the env's and the
    machine's device counts, the precision and plane dtype, and the
    kernel sources' hash (``ops/cuda_build.sources_key``), which stands
    where the JAX package pins its compiler: packed descriptors are read
    by the kernels of one build."""
    from ..ops.cuda_build import sources_key
    name, count = _device_identity(env.device)
    return "|".join([
        "quest_tpu_torch", torch.__version__,
        str(torch.version.cuda or "none"), env.device.type, name,
        str(env.num_devices), str(count), env.precision.name,
        str(env.precision.real_dtype).replace("torch.", ""),
        sources_key(),
    ])


class WarmArtifact:
    """One warm form's artifact: ``description`` (a JSON-able dict: the
    form, its shapes, and the plan that produced the operands) and
    ``tensors`` (name -> tensor: each layer's ``<name>.desc``,
    ``<name>.pool`` and FAST ``<name>.fast_pool``, each static operator
    ``S<item>``)."""

    __slots__ = ("description", "tensors")

    def __init__(self, description: dict, tensors: dict):
        self.description = description
        self.tensors = tensors


class WarmCache:
    """One on-disk artifact cache rooted at ``root``.

    Thread-safe (the router's supervisor restarts replicas from a
    background thread while callers warm). All I/O failures degrade to
    misses: the cache can make a restart fast, never make it wrong or make
    it crash.

    ``install_xla_cache`` is kept for the JAX package's signature. There
    the cache has a second layer, XLA's own compilation cache for the
    forms it cannot serialise; the port has no second layer, because its
    kernels are built once per source hash into the build directory.
    """

    def __init__(self, root: str, install_xla_cache: bool = True):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self._c = {"hits": 0, "misses": 0, "stores": 0, "errors": 0,
                   "skipped": 0}

    @classmethod
    def from_env(cls) -> Optional["WarmCache"]:
        """The ambient cache: rooted at ``$QUEST_TPU_WARM_CACHE_DIR``, None
        (disabled) when the variable is unset or empty."""
        root = os.environ.get(WARM_CACHE_ENV, "").strip()
        return cls(root) if root else None

    # -- accounting --------------------------------------------------------

    def _incr(self, name: str) -> None:
        with self._lock:
            self._c[name] += 1

    def stats(self) -> dict:
        with self._lock:
            return {**self._c, "root": self.root}

    # -- keyed artifacts ---------------------------------------------------

    def _key(self, cc, form: tuple, shapes: tuple) -> Optional[str]:
        digest = circuit_digest(cc.circuit, cc.is_density)
        if digest is None:
            return None
        doc = f"{digest}|{env_fingerprint(cc.env)}|{form!r}|{shapes!r}"
        return hashlib.sha256(doc.encode()).hexdigest()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".warm.pt")

    def _load(self, key: str, device) -> Optional[WarmArtifact]:
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            doc = torch.load(path, map_location=device, weights_only=True)
            art = WarmArtifact(json.loads(doc["description"]),
                               dict(doc["tensors"]))
        # torn-artifact boundary: a corrupt or truncated file reads as a
        # miss (counted), and the fresh build overwrites the slot
        except Exception:
            self._incr("errors")
            return None
        return art

    def _store(self, key: str, art: WarmArtifact) -> bool:
        path = self._path(key)
        d = os.path.dirname(path)
        doc = {"description": json.dumps(art.description, sort_keys=True),
               "tensors": {k: v.detach().cpu()
                           for k, v in art.tensors.items()}}
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    torch.save(doc, f)
                os.replace(tmp, path)    # atomic: no torn artifacts
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except OSError:
            self._incr("errors")
            return False
        self._incr("stores")
        return True

    # -- the warm entry point ----------------------------------------------

    def warm_form(self, cc, kind: str, batch: int,
                  hamiltonian=None, tier=None) -> str:
        """Make one warm form's operands resident in ``cc``: ``"hit"``,
        loaded from disk and installed (nothing packed); ``"miss"``, packed
        fresh, stored and installed; ``"skip"``, this form cannot be cached
        (an unprobeable circuit, or a form the program cannot lower) and
        the caller warms it by dispatch. ``tier`` selects a precision
        tier's form: the tier token rides the form key, so another tier's
        artifact is a miss, never a wrong program."""
        try:
            form, shapes, _ = cc.lower_batched(kind, batch, hamiltonian,
                                               lower=False, tier=tier)
        except ValueError:
            self._incr("skipped")
            return "skip"
        key = self._key(cc, form, shapes)
        if key is None:
            self._incr("skipped")
            return "skip"
        art = self._load(key, cc.env.device)
        if art is not None:
            try:
                cc.install_batched_aot(form, shapes, art)
            except ValueError:
                # the description no longer matches this plan: rebuild
                self._incr("errors")
            else:
                self._incr("hits")
                return "hit"
        _, _, art = cc.lower_batched(kind, batch, hamiltonian, tier=tier)
        cc.install_batched_aot(form, shapes, art)
        if not self._store(key, art):
            self._incr("skipped")
            return "skip"
        self._incr("misses")
        return "miss"
