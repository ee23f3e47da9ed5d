"""Typed wire errors and their HTTP mapping.

Every error crossing the wire carries three things: an HTTP status, the
exception TYPE name (clients dispatch on it the way in-process callers
``except QueueFull``), and the resilience classification
(:func:`quest_tpu_torch.resilience.recovery.classify` — ``transient``
errors are retryable, ``fatal`` ones are caller bugs or a broken card).
The mapping table is the JAX package's contract, with the port's own
device failures added:

===============================  ======  ==============
exception                        status  classification
===============================  ======  ==============
``WireFormatError`` (bad form)   400     fatal
``AuthError``                    401     fatal
``SessionExpired`` (TTL evict)   401     transient
``UnknownProgram``               404     transient
``UnknownStream``                404     fatal
``RequestTimeout`` (slow loris)  408     transient
``DigestMismatch``               409     fatal
``QueueFull`` / ``QuotaExceeded``  429   transient
``RateLimited`` / ``ServerOverloaded``  429  transient
``NumericalFault`` (poison)      500     poison
``KernelBuildError`` /           500     fatal
``KernelLaunchError`` /
``torch.AcceleratorError``
``StreamUnsupported``            501     fatal
``CircuitBreakerOpen`` etc.      503     transient
``DeadlineExceeded``             504     transient
===============================  ======  ==============

The 429 family and ``RequestTimeout`` carry ``retry_after_s`` in their
``detail`` (and the server mirrors it into an HTTP ``Retry-After``
header) so a well-behaved client backs off by the server's estimate of
when capacity returns, not by a blind exponential guess.

A kernel that did not build, a launch the card refused and a sticky
CUDA error reach the client as the JAX package's non-retryable server
failure: 500 with classification ``fatal``, which the client re-raises
as :class:`WireError` without a retry. Never a retryable 5xx or 429 —
the retry loop would resubmit onto a broken card.
"""

from __future__ import annotations

__all__ = ["WireError", "WireFormatError", "DigestMismatch",
           "UnknownProgram", "UnknownStream", "AuthError",
           "SessionExpired", "RequestTimeout", "RateLimited",
           "ServerOverloaded", "StreamUnsupported",
           "http_status", "error_body", "retry_after_s", "raise_typed"]


class WireError(Exception):
    """Base class for wire-protocol errors; ``status`` is the HTTP
    code the server answers with."""

    status = 400
    classification = "fatal"     # a malformed submission never retries

    def __init__(self, message: str, detail: dict = None):
        super().__init__(message)
        self.detail = dict(detail or {})


class WireFormatError(WireError):
    """The request body is not a valid ``quest_tpu.wire/1`` document
    (unknown schema/kind, malformed circuit row, absolute deadline,
    un-serializable op)."""

    status = 400


class AuthError(WireError):
    """Unknown token or session — the authn hook rejected it."""

    status = 401


class SessionExpired(AuthError):
    """A session the TTL sweep evicted for idleness. Transient by
    contract: re-opening the session (POST /v1/session) and replaying
    the request resolves it — the client's retry loop does both."""

    classification = "transient"


class RequestTimeout(WireError):
    """The peer failed to deliver a complete request within the
    server's read deadline (the slow-loris guard). The connection is
    closed after this answer; a healthy client retries promptly on a
    fresh connection."""

    status = 408
    classification = "transient"


class RateLimited(WireError):
    """The session's token bucket is empty — the per-session request
    rate exceeded the server's ``rate_limit``. ``detail`` carries
    ``retry_after_s``: when the next token lands."""

    status = 429
    classification = "transient"


class ServerOverloaded(WireError):
    """Priority-aware load shed: the backend queue depth crossed the
    server's watermark and this request's priority class is sheddable.
    ``detail`` carries ``retry_after_s``, derived from the WFQ backlog
    estimate (queue depth x per-request service time)."""

    status = 429
    classification = "transient"


class UnknownProgram(WireError):
    """A ``circuit_ref`` digest the server has no registered program
    for (evicted or never sent): re-submit the full circuit."""

    status = 404
    classification = "transient"   # the full-circuit retry resolves it


class DigestMismatch(WireError):
    """The decoded circuit's content digest does not match the digest
    the submission claimed — a corrupted or mis-assembled wire form is
    rejected, never silently served."""

    status = 409


class UnknownStream(WireError):
    """A stream-resume request named a stream id this server does not
    hold (never opened, expired past its resume TTL, or the requested
    cursor fell off the bounded replay buffer). Fatal for the RESUME
    attempt: start a fresh stream instead of retrying the resume."""

    status = 404


class StreamUnsupported(WireError):
    """The backend behind this server cannot stream the requested
    kind (e.g. a bare router with no ``evolve()``)."""

    status = 501


def http_status(exc: BaseException) -> int:
    """HTTP status for ANY exception crossing the wire boundary."""
    if isinstance(exc, WireError):
        return exc.status
    from ..serve.engine import (QueueFull, QuotaExceeded,
                                DeadlineExceeded, ServeError)
    if isinstance(exc, (QueueFull, QuotaExceeded)):
        return 429
    if isinstance(exc, DeadlineExceeded):
        return 504
    if isinstance(exc, ServeError):
        # ServiceClosed, CircuitBreakerOpen, AllReplicasUnavailable, …
        return 503
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return 400       # caller errors reject typed at admission
    # everything else — the card's own failures included, which
    # classify() calls fatal so the client never retries them
    return 500


def error_body(exc: BaseException) -> dict:
    """The JSON error envelope: type name + message + resilience
    classification (+ any typed detail)."""
    from ..resilience.recovery import classify
    body = {"error": {
        "type": type(exc).__name__,
        "message": str(exc),
        "classification": getattr(exc, "classification", None)
        or classify(exc),
    }}
    detail = getattr(exc, "detail", None)
    if detail:
        body["error"]["detail"] = dict(detail)
    return body


def retry_after_s(exc: BaseException):
    """The server's backoff estimate riding a typed error (the
    ``retry_after_s`` detail of the 429 family), or None."""
    detail = getattr(exc, "detail", None)
    if isinstance(detail, dict):
        ra = detail.get("retry_after_s")
        if isinstance(ra, (int, float)) and ra >= 0:
            return ra
    return None


_CLIENT_TYPES = None


def raise_typed(status: int, err: dict) -> None:
    """Client side of the mapping: re-raise the server's error envelope
    as the SAME typed exception family the in-process API raises, so
    ``except QueueFull`` works identically over the socket."""
    global _CLIENT_TYPES
    if _CLIENT_TYPES is None:
        from ..serve.engine import (QueueFull, QuotaExceeded,
                                    DeadlineExceeded, ServiceClosed,
                                    CircuitBreakerOpen)
        _CLIENT_TYPES = {
            "QueueFull": QueueFull,
            "QuotaExceeded": QuotaExceeded,
            "DeadlineExceeded": DeadlineExceeded,
            "ServiceClosed": ServiceClosed,
            "CircuitBreakerOpen": CircuitBreakerOpen,
            "WireFormatError": WireFormatError,
            "DigestMismatch": DigestMismatch,
            "UnknownProgram": UnknownProgram,
            "UnknownStream": UnknownStream,
            "AuthError": AuthError,
            "SessionExpired": SessionExpired,
            "RequestTimeout": RequestTimeout,
            "RateLimited": RateLimited,
            "ServerOverloaded": ServerOverloaded,
            "StreamUnsupported": StreamUnsupported,
            "ValueError": ValueError,
            "TypeError": TypeError,
        }
    info = dict(err.get("error", {}))
    name = str(info.get("type", "WireError"))
    msg = str(info.get("message", f"HTTP {status}"))
    exc_type = _CLIENT_TYPES.get(name)
    if exc_type is None:
        e = WireError(f"{name}: {msg} (HTTP {status})")
        e.status = status
        raise e
    if issubclass(exc_type, WireError):
        # typed detail survives the wire: the client retry loop reads
        # retry_after_s off the re-raised exception exactly as an
        # in-process caller would
        raise exc_type(msg, detail=info.get("detail"))
    raise exc_type(msg)
