"""Network front door for the port's serving stack.

An asyncio HTTP/1.1 JSON façade in front of
:class:`~quest_tpu_torch.serve.router.ServiceRouter` /
:class:`~quest_tpu_torch.serve.engine.SimulationService` — stdlib-only on the
server side, like the telemetry loopback exporter it shares endpoint
plumbing with:

- :mod:`quest_tpu_torch.netserve.wire` — the versioned ``quest_tpu.wire/1``
  form: recorded circuits (builder-call journal replay), Param
  bindings, observables-as-Pauli-terms, every request kind, canonical
  JSON, and a content digest that matches
  :func:`quest_tpu_torch.serve.warmcache.circuit_digest`;
- :mod:`quest_tpu_torch.netserve.session` — authn tokens -> tenants through a
  pluggable :class:`AuthHook` (quota/priority ride the WFQ
  :class:`~quest_tpu_torch.serve.sched.TenantPolicy` contract) and the
  digest-keyed program registry that pins a session's compiled
  programs to warm replicas;
- :mod:`quest_tpu_torch.netserve.server` — the server: request/stream/
  observability endpoints, chunked-transfer streaming of optimizer
  iterates, dynamics segments, and trajectory wave progress;
- :mod:`quest_tpu_torch.netserve.client` — the stdlib sync client with the
  same ``submit() -> Future`` shape as the in-process service.

A copy of the JAX package's front door over the port's service and
router: the same routes, knobs and hardening, and the same
``quest_tpu.wire/1`` documents (journal, request envelope and results
are ``canonical_json``-equal across the two packages for the same
builder calls). The content digest is each package's own, as for warm
caches: static circuits and QASM programs cross packages, while a
Param circuit's digest differs (each package hashes its own gate code),
so its cross-package document is refused with :class:`DigestMismatch`.
"""

from .errors import (WireError, WireFormatError, DigestMismatch,
                     UnknownProgram, AuthError, SessionExpired,
                     RequestTimeout, RateLimited, ServerOverloaded,
                     UnknownStream, StreamUnsupported, http_status,
                     error_body, retry_after_s)
from .wire import (WIRE_SCHEMA, REQUEST_KINDS, canonical_json,
                   encode_circuit, decode_circuit, encode_request,
                   decode_request, encode_result, parse_result,
                   WireRequest)
from .session import (AuthHook, StaticTokenAuth, OpenAuth, SessionGrant,
                      Session, SessionManager, ProgramRegistry)
from .robust import (TokenBucket, DedupWindow, ResumableStream,
                     backlog_estimate)
from .server import NetServer
from .client import NetClient

__all__ = [
    "WIRE_SCHEMA", "REQUEST_KINDS", "canonical_json",
    "encode_circuit", "decode_circuit", "encode_request",
    "decode_request", "encode_result", "parse_result", "WireRequest",
    "WireError", "WireFormatError", "DigestMismatch", "UnknownProgram",
    "AuthError", "SessionExpired", "RequestTimeout", "RateLimited",
    "ServerOverloaded", "UnknownStream", "StreamUnsupported",
    "http_status", "error_body", "retry_after_s",
    "AuthHook", "StaticTokenAuth", "OpenAuth", "SessionGrant",
    "Session", "SessionManager", "ProgramRegistry",
    "TokenBucket", "DedupWindow", "ResumableStream",
    "backlog_estimate",
    "NetServer", "NetClient",
]
