"""Runtime lock-order validation for the port's serving threads.

The serving runtime runs a dispatcher, a completion thread, a watchdog,
the router's supervisor, restart and scale threads, and the optimizer
and dynamics loops, over a dozen locks in several modules; nothing else
enforces one acquisition order. An inversion (thread 1 takes A then B,
thread 2 takes B then A) deadlocks only under the unlucky interleaving.
This module turns the invariant into a deterministic test failure:

- :func:`install` wraps ``threading.Lock`` / ``threading.RLock`` so every
  lock **created from quest_tpu_torch code** (``threading.Condition``,
  ``Event``, ``queue.Queue`` and ``Future`` build theirs through those
  factories) is a tracked proxy tagged with its creation site
  (``quest_tpu_torch/module.py:line``: one graph node per site, shared by
  every instance, so replica 0 and replica 1 teach the same rules);
- each thread keeps its held set; acquiring B while holding A records
  the edge ``A -> B`` in a process-global acquisition-order graph;
- an acquisition that closes a cycle raises a typed
  :class:`LockOrderViolation` naming both lock sites and both acquire
  sites, and records it process-globally (:func:`violations`), so a
  violation swallowed by a recovery path's broad handler still fails the
  test that checks the list.

A copy of the JAX package's validator, with the port as the package it
tracks. Its state hangs on ``threading`` under its own attribute, so it
installs beside the JAX package's copy (which the test configuration
installs for the JAX package's own locks): whichever installs second
wraps whatever factory ``threading.Lock`` is at that moment, each copy
tracks only the locks its own package creates, and the other's
factory hands those through untouched. :func:`uninstall` unhooks the
factory where it is outermost; where the other copy wrapped it since,
it stays in the chain as a pass-through until the next :func:`install`.

Reentrant acquisition of the same lock (RLock, the Condition idiom)
never adds edges. The cost is a dict probe per acquisition.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading

__all__ = ["LockOrderViolation", "install", "uninstall", "installed",
           "suspended", "tracked_lock", "graph", "violations", "clear",
           "assert_clean",
           "find_cycle"]


class LockOrderViolation(RuntimeError):
    """Two lock sites were acquired in both orders: a latent deadlock.

    ``site_a`` / ``site_b`` name the lock CREATION sites
    (``module.py:line``); the message carries the acquire sites of both
    directions."""

    def __init__(self, msg: str, site_a: str = "", site_b: str = ""):
        super().__init__(msg)
        self.site_a = site_a
        self.site_b = site_b


# all mutable state is anchored on the threading module, so every copy
# of this module (a standalone load and the package import) shares one
# graph, one violation list, one held set and one pair of factories
_STATE = getattr(threading, "_quest_tpu_torch_lockcheck", None)
if _STATE is None:
    _STATE = {
        "state_lock": threading.Lock(),   # guards graph + violations
        "edges": {},                      # site -> {site: acquire_site}
        "violations": [],
        "installed": False,
        # our factories sit in threading's chain (possibly wrapped by the
        # JAX package's copy, installed after us)
        "in_chain": False,
        "real": {},                       # the factories we wrapped
        "factories": {},
        "tls": threading.local(),
    }
    threading._quest_tpu_torch_lockcheck = _STATE

# the exception class is anchored too: every copy must raise and catch
# the same type
LockOrderViolation = _STATE.setdefault("exc_class", LockOrderViolation)

_state_lock = _STATE["state_lock"]
_edges: dict = _STATE["edges"]
_violations: list = _STATE["violations"]
_real: dict = _STATE["real"]
_tls = _STATE["tls"]
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SELF = os.path.abspath(__file__)


def _held() -> list:
    """This thread's held stack (innermost last)."""
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _caller_site(depth_limit: int = 12):
    """The first stack frame inside quest_tpu_torch (this module
    excluded): the lock's creation or acquire site. None when no frame of
    the port is near (such locks stay untracked raw locks)."""
    frame = sys._getframe(2)
    for _ in range(depth_limit):
        if frame is None:
            return None
        fn = frame.f_code.co_filename
        af = os.path.abspath(fn)
        if af != _SELF and af.startswith(_PKG_DIR + os.sep) \
                and "threading" not in os.path.basename(fn):
            rel = os.path.relpath(af, os.path.dirname(_PKG_DIR))
            return f"{rel.replace(os.sep, '/')}:{frame.f_lineno}"
        frame = frame.f_back
    return None


def _reach(src: str, dst: str) -> bool:
    """DFS reachability in the order graph (caller holds _state_lock)."""
    seen = set()
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            return True
        if n in seen:
            continue
        seen.add(n)
        stack.extend(_edges.get(n, ()))
    return False


def _path(src: str, dst: str) -> list:
    """One path src -> dst (caller holds _state_lock; one exists)."""
    seen = {src: None}
    stack = [src]
    while stack:
        n = stack.pop()
        if n == dst:
            out = [n]
            while seen[n] is not None:
                n = seen[n]
                out.append(n)
            return list(reversed(out))
        for m in _edges.get(n, {}):
            if m not in seen:
                seen[m] = n
                stack.append(m)
    return [src, dst]


class _HeldEntry:
    __slots__ = ("site", "proxy", "count")

    def __init__(self, site, proxy):
        self.site = site
        self.proxy = proxy
        self.count = 1


class _TrackedLock:
    """Order-tracking proxy around a real lock primitive.

    Forwards everything it does not intercept (``_is_owned``,
    ``_release_save``...: the Condition protocol) to the wrapped lock, so
    it composes with ``threading.Condition``. Hold bookkeeping is per
    thread: a Condition ``wait`` releases the raw lock underneath while
    other threads acquire through the proxy, and per-thread entries stay
    consistent at the wait's entry and exit."""

    __slots__ = ("_lock", "site")

    def __init__(self, raw, site: str):
        self._lock = raw
        self.site = site

    def _note_acquired(self):
        held = _held()
        for e in held:
            if e.proxy is self:
                e.count += 1     # reentrant (RLock): no new edges
                return
        if held:
            # the acquire-site stack walk is lazy: only a first-time edge
            # (or a violation) pays it
            acq = None
            with _state_lock:
                for e in held:
                    site = e.site
                    if site == self.site:
                        # distinct instances of one site held together
                        continue
                    fwd = _edges.setdefault(site, {})
                    if self.site in fwd:
                        continue
                    if acq is None:
                        acq = _caller_site() or "<frame outside the port>"
                    if _reach(self.site, site):
                        cyc = _path(self.site, site)
                        first = _edges.get(cyc[0], {}).get(cyc[1], "?")
                        msg = (
                            f"lock-order inversion: acquiring "
                            f"{self.site} (at {acq}) while holding "
                            f"{site}, but the reverse order "
                            f"{' -> '.join(cyc)} was already recorded "
                            f"(first at {first}): these locks deadlock "
                            f"under the wrong interleaving")
                        v = LockOrderViolation(msg, site_a=site,
                                               site_b=self.site)
                        _violations.append(v)
                        raise v
                    fwd[self.site] = acq
        held.append(_HeldEntry(self.site, self))

    def _note_released(self):
        held = _held()
        for i in range(len(held) - 1, -1, -1):
            e = held[i]
            if e.proxy is self:
                e.count -= 1
                if e.count <= 0:
                    del held[i]
                return

    def acquire(self, *a, **k):
        got = self._lock.acquire(*a, **k)
        if got:
            try:
                self._note_acquired()
            except LockOrderViolation:
                # leave the lock as a failed acquire would: unheld
                self._lock.release()
                raise
        return got

    def release(self):
        self._note_released()
        self._lock.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()

    def __getattr__(self, name):
        # the Condition protocol forwards to the raw lock; the held set
        # keeps the lock "held" across a wait, consistent at both ends
        return getattr(self._lock, name)


def _make_factory(kind: str):
    def make(*args, **kwargs):
        raw = _real[kind](*args, **kwargs)
        if not _STATE["installed"]:
            return raw           # unhooked while wrapped: pass through
        site = _caller_site()
        if site is None:
            return raw           # not the port's code: untouched
        return _TrackedLock(raw, site)

    make.__name__ = f"lockcheck_torch_{kind}"
    return make


for _kind in ("Lock", "RLock"):
    _STATE["factories"].setdefault(_kind, _make_factory(_kind))


def install() -> None:
    """Wrap the ``threading`` lock factories that are current now
    (idempotent). Only locks created from quest_tpu_torch modules AFTER
    this call are tracked."""
    with _state_lock:
        if _STATE["installed"]:
            return
        _STATE["installed"] = True
        if _STATE["in_chain"]:
            return           # still wrapped by a later factory: re-arm
        _real["Lock"] = threading.Lock
        _real["RLock"] = threading.RLock
        threading.Lock = _STATE["factories"]["Lock"]
        threading.RLock = _STATE["factories"]["RLock"]
        _STATE["in_chain"] = True


def uninstall() -> None:
    """Stop tracking new locks (tracked locks already handed out keep
    tracking: they are still valid locks). Restores the wrapped factories
    where ours are outermost; otherwise ours stay in the chain as a
    pass-through."""
    with _state_lock:
        if not _STATE["installed"]:
            return
        _STATE["installed"] = False
        fac = _STATE["factories"]
        if threading.Lock is fac["Lock"] and threading.RLock is fac["RLock"]:
            threading.Lock = _real.pop("Lock")
            threading.RLock = _real.pop("RLock")
            _STATE["in_chain"] = False


def installed() -> bool:
    return bool(_STATE["installed"])


@contextlib.contextmanager
def suspended():
    """Track no lock created inside the block (the JAX package's
    ``suspended``): for a timed window whose number is the production
    runtime's cost, which the check would otherwise be part of. Locks
    created before the block keep tracking; a no-op when not
    installed."""
    was = installed()
    if was:
        uninstall()
    try:
        yield
    finally:
        if was:
            install()


def tracked_lock(site: str, rlock: bool = False) -> _TrackedLock:
    """A tracked lock with an EXPLICIT site label: the test hook (tests
    are outside the package, so the creation-site filter skips their
    locks)."""
    real = _real.get("RLock" if rlock else "Lock")
    if real is None:
        real = threading.RLock if rlock else threading.Lock
    return _TrackedLock(real(), site)


# -- inspection -------------------------------------------------------------

def graph() -> dict:
    """A copy of the acquisition-order graph:
    ``{site: {site: first_acquire_site}}``."""
    with _state_lock:
        return {a: dict(b) for a, b in _edges.items()}


def find_cycle():
    """A cycle in the current graph (``[site, ..., site]``), or None: the
    edge-insertion check should make this impossible."""
    with _state_lock:
        edges = {a: list(b) for a, b in _edges.items()}
    color: dict = {}
    stack: list = []

    def dfs(n):
        color[n] = 1
        stack.append(n)
        for m in edges.get(n, ()):
            if color.get(m, 0) == 1:
                return stack[stack.index(m):] + [m]
            if color.get(m, 0) == 0:
                hit = dfs(m)
                if hit:
                    return hit
        stack.pop()
        color[n] = 2
        return None

    for n in sorted(edges):
        if color.get(n, 0) == 0:
            hit = dfs(n)
            if hit:
                return hit
    return None


def violations() -> list:
    """Every :class:`LockOrderViolation` raised so far, including ones
    swallowed by broad exception handlers downstream."""
    with _state_lock:
        return list(_violations)


def clear(site_prefix: str = "") -> None:
    """Drop recorded violations and graph nodes whose site starts with
    ``site_prefix`` (everything when empty): the cleanup hook for tests
    that prove a deliberate inversion raises."""
    with _state_lock:
        if not site_prefix:
            _violations.clear()
            _edges.clear()
            return
        _violations[:] = [
            v for v in _violations
            if not (v.site_a.startswith(site_prefix)
                    or v.site_b.startswith(site_prefix))]
        for a in list(_edges):
            if a.startswith(site_prefix):
                del _edges[a]
                continue
            for b in list(_edges[a]):
                if b.startswith(site_prefix):
                    del _edges[a][b]


def assert_clean() -> None:
    """Raise if any violation was recorded or the graph holds a cycle."""
    vs = violations()
    if vs:
        raise AssertionError(
            f"{len(vs)} LockOrderViolation(s) were raised during the "
            f"run (possibly swallowed downstream): "
            + "; ".join(str(v) for v in vs[:3]))
    cyc = find_cycle()
    if cyc is not None:
        raise AssertionError(
            f"lock acquisition graph holds a cycle: {' -> '.join(cyc)}")
