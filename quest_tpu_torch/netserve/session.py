"""Sessions: authn tokens -> tenants, and the digest-keyed program
registry that pins a session's compiled programs to warm replicas.

The authn surface is a single pluggable hook: :class:`AuthHook`
``.authenticate(token)`` returns a :class:`SessionGrant` (tenant name
plus an optional WFQ :class:`~quest_tpu_torch.serve.sched.TenantPolicy`) or
``None`` to reject. The server installs the grant's policy on the
backend via ``set_tenant`` when the session opens, so quota/priority
admission (429 ``QuotaExceeded``/``QueueFull``) is enforced by the SAME
WFQ layer that guards in-process callers — the wire adds no second
quota system.

Programs are content-addressed: the first submission of a circuit
registers it under its :func:`~quest_tpu_torch.serve.warmcache.circuit_digest`
and warms the backend's replicas; later submissions send only the
digest (``circuit_ref``) and skip re-serialization, re-decode, and
re-compile entirely. Hit rates are tracked per session (``GET
/v1/sessions``).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional

from .errors import AuthError, SessionExpired, UnknownProgram

__all__ = ["SessionGrant", "AuthHook", "OpenAuth", "StaticTokenAuth",
           "Session", "SessionManager", "ProgramRegistry"]

DEFAULT_TENANT = "default"


class SessionGrant:
    """What an authn hook vouches for: the tenant this token serves
    under, optionally the WFQ policy to install for it."""

    __slots__ = ("tenant", "policy", "meta")

    def __init__(self, tenant: str, policy=None, meta: dict = None):
        self.tenant = str(tenant)
        self.policy = policy
        self.meta = dict(meta or {})


class AuthHook:
    """Pluggable authn: map a bearer token to a :class:`SessionGrant`
    (or ``None`` to reject). Subclass and hand an instance to
    :class:`~quest_tpu_torch.netserve.server.NetServer`."""

    def authenticate(self, token: Optional[str]) -> Optional[SessionGrant]:
        raise NotImplementedError


class OpenAuth(AuthHook):
    """Accept everything; every caller lands on one tenant. The default
    for loopback/dev servers, mirroring the telemetry exporter."""

    def __init__(self, tenant: str = DEFAULT_TENANT):
        self._tenant = tenant

    def authenticate(self, token):
        return SessionGrant(self._tenant)


class StaticTokenAuth(AuthHook):
    """A fixed token table: ``{token: SessionGrant | tenant_name}``.
    Unknown tokens reject (401)."""

    def __init__(self, tokens: dict):
        self._tokens = {}
        for token, grant in dict(tokens).items():
            if not isinstance(grant, SessionGrant):
                grant = SessionGrant(str(grant))
            self._tokens[str(token)] = grant

    def authenticate(self, token):
        return self._tokens.get(token)


class Session:
    """One authenticated wire session: identity plus per-session
    program-registry hit accounting. ``last_seen`` feeds the idle-TTL
    sweep; ``bucket`` is the lazily-created per-session rate limiter
    (:class:`~quest_tpu_torch.netserve.robust.TokenBucket`) when the server
    enforces one."""

    __slots__ = ("id", "tenant", "grant", "hits", "misses", "requests",
                 "last_seen", "bucket")

    def __init__(self, sid: str, grant: SessionGrant):
        self.id = sid
        self.tenant = grant.tenant
        self.grant = grant
        self.hits = 0
        self.misses = 0
        self.requests = 0
        self.last_seen = time.monotonic()
        self.bucket = None

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        return {"session": self.id, "tenant": self.tenant,
                "requests": self.requests, "program_hits": self.hits,
                "program_misses": self.misses,
                "program_hit_rate": round(self.hit_rate(), 4)}


class ProgramRegistry:
    """Digest-keyed store of decoded circuits. ``lookup`` raises typed
    :class:`UnknownProgram` (404 — transient: re-sending the full
    circuit resolves it) for digests this server never saw or evicted."""

    def __init__(self, max_programs: int = 256):
        self._lock = threading.Lock()
        self._programs: dict = {}       # digest -> Circuit (insertion order)
        self._max = int(max_programs)

    def register(self, digest: str, circuit) -> bool:
        """Store a decoded program; returns True when it was new (the
        caller then warms replicas exactly once per digest)."""
        with self._lock:
            if digest in self._programs:
                return False
            while len(self._programs) >= self._max:
                self._programs.pop(next(iter(self._programs)))
            self._programs[digest] = circuit
            return True

    def get(self, digest: str):
        with self._lock:
            return self._programs.get(digest)

    def evict(self, digest: str) -> bool:
        """Drop one program (operator tooling + the ``stale_ref`` chaos
        kind); returns whether it was present. The next ``circuit_ref``
        naming it answers 404 and the client self-heals with a full
        resend."""
        with self._lock:
            return self._programs.pop(digest, None) is not None

    def items(self) -> list:
        """``[(digest, circuit), ...]`` in insertion order — the drain
        persistence walk."""
        with self._lock:
            return list(self._programs.items())

    def lookup(self, digest: str):
        c = self.get(digest)
        if c is None:
            raise UnknownProgram(
                f"no program registered under digest {digest!r} "
                "(never sent, or evicted) — re-submit the full circuit",
                detail={"digest": str(digest)})
        return c

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)


class SessionManager:
    """Open/resolve sessions against an :class:`AuthHook` and install
    each grant's tenant policy on the backend (once per tenant).

    ``ttl_s`` enables idle eviction: a session unseen for that long is
    swept (lazily, on the next open/resolve), its program-registry
    hit/miss counters folded into the preserved :meth:`evicted_summary`
    aggregate so the registry's hit-rate accounting survives the
    eviction. Resolving an evicted id raises the typed
    :class:`~quest_tpu_torch.netserve.errors.SessionExpired` (401) — the
    client re-authenticates and retries; ``on_evict`` (if given) is
    called with the number of sessions each sweep evicted (the server
    wires its ``sessions_expired`` counter here)."""

    #: remember at most this many evicted ids (FIFO) so an expired
    #: session answers the typed 401 instead of a generic unknown-id one
    MAX_EXPIRED_IDS = 4096

    def __init__(self, auth: Optional[AuthHook] = None, backend=None,
                 allow_anonymous: bool = True,
                 ttl_s: Optional[float] = None, on_evict=None,
                 clock=time.monotonic):
        self._auth = auth
        self._backend = backend
        self._allow_anonymous = bool(allow_anonymous)
        self._ttl_s = ttl_s
        self._on_evict = on_evict
        self._clock = clock
        self._lock = threading.Lock()
        self._sessions: dict = {}
        self._ids = itertools.count(1)
        self._policies_installed: set = set()
        self._anon: Optional[Session] = None
        self._expired: dict = {}       # sid -> True (bounded FIFO)
        self._evicted_sessions = 0
        self._evicted_hits = 0
        self._evicted_misses = 0
        self._evicted_requests = 0

    def open(self, token: Optional[str]) -> Session:
        if self._auth is not None:
            grant = self._auth.authenticate(token)
            if grant is None:
                raise AuthError("unknown token: the authn hook rejected "
                                "this credential")
        elif token is not None or self._allow_anonymous:
            grant = SessionGrant(DEFAULT_TENANT)
        else:
            raise AuthError("this server requires a token")
        evicted = 0
        with self._lock:
            evicted = self._sweep_locked()
            sid = f"s{next(self._ids):06d}"
            sess = Session(sid, grant)
            sess.last_seen = self._clock()
            self._sessions[sid] = sess
        if evicted and self._on_evict is not None:
            self._on_evict(evicted)
        self._install_policy(grant)
        return sess

    def _sweep_locked(self) -> int:
        """Evict idle sessions past the TTL; caller holds ``_lock``.
        Returns how many were evicted."""
        if self._ttl_s is None:
            return 0
        now = self._clock()
        stale = [sid for sid, s in self._sessions.items()
                 if (now - s.last_seen) > self._ttl_s]
        for sid in stale:
            s = self._sessions.pop(sid)
            # the hit-rate accounting survives the eviction as an
            # aggregate — /v1/sessions still reports a truthful
            # registry hit rate after idle sessions age out
            self._evicted_sessions += 1
            self._evicted_hits += s.hits
            self._evicted_misses += s.misses
            self._evicted_requests += s.requests
            self._expired[sid] = True
            if self._anon is s:
                self._anon = None
        while len(self._expired) > self.MAX_EXPIRED_IDS:
            self._expired.pop(next(iter(self._expired)))
        return len(stale)

    def _install_policy(self, grant: SessionGrant) -> None:
        if grant.policy is None or self._backend is None:
            return
        set_tenant = getattr(self._backend, "set_tenant", None)
        if set_tenant is None:
            return
        with self._lock:
            if grant.tenant in self._policies_installed:
                return
            self._policies_installed.add(grant.tenant)
        set_tenant(grant.tenant, grant.policy)

    def resolve(self, sid: Optional[str]) -> Session:
        """Session id -> Session; unknown ids reject 401 (evicted ones
        with the typed :class:`SessionExpired`). A missing id opens an
        implicit anonymous session when allowed."""
        if sid is None:
            if self._auth is None and self._allow_anonymous:
                # ONE shared implicit session, not one per request: the
                # hit-rate accounting stays meaningful for sessionless
                # callers
                with self._lock:
                    anon = self._anon
                if anon is not None:
                    anon.last_seen = self._clock()
                    return anon
                sess = self.open(None)
                with self._lock:
                    if self._anon is None:
                        self._anon = sess
                    sess = self._anon
                return sess
            raise AuthError("no session: POST /v1/session first")
        evicted = 0
        with self._lock:
            evicted = self._sweep_locked()
            sess = self._sessions.get(sid)
            expired = sid in self._expired if sess is None else False
        if evicted and self._on_evict is not None:
            self._on_evict(evicted)
        if sess is None:
            if expired:
                raise SessionExpired(
                    f"session {sid!r} expired after "
                    f"{self._ttl_s}s idle — re-open it "
                    "(POST /v1/session) and retry",
                    detail={"session": str(sid)})
            raise AuthError(f"unknown session {sid!r}: it was never "
                            "opened here, or the server restarted")
        sess.last_seen = self._clock()
        return sess

    def snapshot(self) -> list:
        with self._lock:
            return [s.snapshot() for s in self._sessions.values()]

    def evicted_summary(self) -> dict:
        """The preserved aggregate of every TTL-evicted session's
        accounting (hit-rate truth survives eviction)."""
        with self._lock:
            total = self._evicted_hits + self._evicted_misses
            return {"sessions": self._evicted_sessions,
                    "program_hits": self._evicted_hits,
                    "program_misses": self._evicted_misses,
                    "requests": self._evicted_requests,
                    "program_hit_rate":
                        round(self._evicted_hits / total, 4)
                        if total else 0.0}

    # -- drain persistence -------------------------------------------------

    def persist(self) -> dict:
        """The JSON-ready session table for the drain snapshot: ids,
        tenants, and accounting (grants beyond the tenant name — WFQ
        policies, token meta — are re-derived on the next authenticate,
        not persisted)."""
        with self._lock:
            rows = [{"session": s.id, "tenant": s.tenant,
                     "requests": s.requests, "hits": s.hits,
                     "misses": s.misses}
                    for s in self._sessions.values()]
            return {"rows": rows,
                    "anon": self._anon.id if self._anon else None,
                    "next_id": next(self._ids)}

    def restore(self, doc: dict) -> int:
        """Readmit a persisted session table: every persisted id
        resolves again (no re-auth storm after a warm handover), and
        the id counter advances past the restored ids so new sessions
        never collide. Returns how many sessions were readmitted."""
        rows = doc.get("rows", [])
        anon_id = doc.get("anon")
        with self._lock:
            for row in rows:
                sid = str(row["session"])
                sess = Session(sid, SessionGrant(str(row["tenant"])))
                sess.requests = int(row.get("requests", 0))
                sess.hits = int(row.get("hits", 0))
                sess.misses = int(row.get("misses", 0))
                sess.last_seen = self._clock()
                self._sessions[sid] = sess
                if sid == anon_id:
                    self._anon = sess
            self._ids = itertools.count(int(doc.get("next_id", 1)))
            return len(rows)
