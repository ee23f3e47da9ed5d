"""Content digests of recorded circuits.

Counterpart of ``circuit_digest`` and its hashing helpers in the JAX
package's ``serve/warmcache.py``, byte for byte in what they hash, so a
static circuit digests the same in both packages. The persistent kernel
cache that keys on it waits for the port's serving slice (ROADMAP Queue 1
item 10).
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np

__all__ = ["circuit_digest"]

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
