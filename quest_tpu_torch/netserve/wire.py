"""The versioned wire form: ``quest_tpu.wire/1``.

Circuits travel as a **builder-call journal** — the high-level calls
that recorded them (``["rx", q, {"param": "t0"}]``), not pickled
closures. Decoding replays the journal through the same
:class:`~quest_tpu_torch.circuits.Circuit` builders, so the decoded circuit
reproduces the exact op stream — parameterized closures land on the
SAME code objects — and therefore the exact
:func:`~quest_tpu_torch.serve.warmcache.circuit_digest`. That digest is the
wire form's content address: submissions carry it, the server recomputes
it after decode, and a mismatch rejects typed
(:class:`~quest_tpu_torch.netserve.errors.DigestMismatch`) instead of serving
a mis-assembled program. Static matrices travel as exact ``repr``
floats (canonical JSON round-trips them bit-for-bit).

Versioning rules (the JAX package's, unchanged):

- the envelope names its schema; an unknown schema string rejects 400;
- **unknown top-level keys reject** in v1 (strict — a typo'd knob must
  not silently serve defaults); additive evolution bumps the version;
- deadlines are RELATIVE (``timeout_s``) only: absolute client
  timestamps are rejected by name — client clocks are not trusted.

Requests: ``kind`` in :data:`REQUEST_KINDS`, a program as exactly one
of ``circuit`` (full wire form), ``circuit_ref`` (a digest the server
already holds), or ``qasm`` (OpenQASM 2.0 via
:mod:`quest_tpu_torch.qasm_import`), plus the kind's knobs. Results mirror
the in-process future values shape-for-shape; the port's futures resolve
with host numpy and floats (the service copies each batch off the card),
so no device tensor reaches the encoder.

Every document is ``canonical_json``-equal to the JAX package's for the
same builder calls and inputs. The digest is each package's own: equal
for static circuits and QASM programs, different for a Param circuit
(each package hashes its own gate code), whose cross-package document
therefore rejects with :class:`DigestMismatch` unless decoded with
``verify_digest=False``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from .errors import WireFormatError, DigestMismatch

__all__ = ["WIRE_SCHEMA", "REQUEST_KINDS", "canonical_json", "jsonable",
           "encode_circuit", "decode_circuit", "encode_request",
           "decode_request", "encode_result", "parse_result",
           "WireRequest"]

WIRE_SCHEMA = "quest_tpu.wire/1"

#: wire kind token -> the in-process submit() surface it maps onto
REQUEST_KINDS = ("sweep", "expectation", "shots", "trajectory",
                 "gradient", "evolve", "ground")

#: absolute-deadline key names rejected by NAME: a skewed client clock
#: must never extend (or shrink) a server-side deadline
_FORBIDDEN_DEADLINE_KEYS = ("deadline", "deadline_s", "deadline_epoch",
                            "expires_at", "deadline_wall")

_REQUEST_KEYS = frozenset({
    "schema", "kind", "circuit", "circuit_ref", "qasm", "params",
    "observables", "shots", "trajectories", "sampling_budget", "tier",
    "priority", "timeout_s", "evolve", "ground", "init_state",
    "optimizer", "request_id", "resumable",
})

#: client-chosen idempotency keys are opaque but bounded: the server's
#: dedup window stores them verbatim, so a pathological id must not be
#: able to balloon it
_MAX_REQUEST_ID_LEN = 128


def jsonable(obj):
    """Recursively coerce a result/iterate payload (numpy arrays and
    scalars included) into plain JSON types — the stream-event encoder.
    Unknown objects degrade to ``repr`` rather than failing the
    stream."""
    if isinstance(obj, dict):
        return {str(k): jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonable(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.bool_):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, (bool, int, float, str)) or obj is None:
        return obj
    return repr(obj)


def canonical_json(doc) -> str:
    """The one serialization of a wire document: sorted keys, no
    whitespace, NaN/Inf rejected (they are not JSON)."""
    try:
        return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                          allow_nan=False)
    except ValueError as e:
        raise WireFormatError(f"document is not canonical-JSON-able: {e}")


# ---------------------------------------------------------------------------
# circuits
# ---------------------------------------------------------------------------


def _mat(doc) -> np.ndarray:
    # assign the planes, never `re + 1j*im`: complex multiplication
    # flips signed zeros, and the content digest hashes exact BYTES
    re_l = np.asarray(doc["re"], dtype=np.float64)
    im_l = np.asarray(doc["im"], dtype=np.float64)
    out = np.empty(re_l.shape, dtype=np.complex128)
    out.real = re_l
    out.imag = im_l
    return out


def _angle(doc):
    from ..circuits import Param
    if isinstance(doc, dict):
        return Param(str(doc["param"]))
    return float(doc)


# journal row replay table: row[0] names the builder, row[1:] its args.
# Every entry funnels through the SAME Circuit builders that recorded
# it — that is what makes the decode digest-stable.
_REPLAY = {
    "gate": lambda c, m, tg, ct, st: c.gate(_mat(m), tg, ct, st),
    "diagonal": lambda c, m, qs: c.diagonal(_mat(m), qs),
    "kraus": lambda c, ms, tg: c.kraus([_mat(m) for m in ms], tg),
    "phase": lambda c, q, a: c.phase(int(q), _angle(a)),
    "rot": lambda c, q, a, axis, ct: c._rot(
        int(q), _angle(a), tuple(float(x) for x in axis),
        tuple(int(x) for x in ct)),
    "rz": lambda c, q, a: c.rz(int(q), _angle(a)),
    "cphase": lambda c, ctl, tgt, a: c.cphase(int(ctl), int(tgt),
                                              _angle(a)),
    "crz": lambda c, ctl, tgt, a: c.crz(int(ctl), int(tgt), _angle(a)),
    "multi_rotate_z": lambda c, qs, a: c.multi_rotate_z(
        [int(q) for q in qs], _angle(a)),
    "dephase": lambda c, q, a: c.dephase(int(q), _angle(a)),
    "depolarise": lambda c, q, a: c.depolarise(int(q), _angle(a)),
    "damp": lambda c, q, a: c.damp(int(q), _angle(a)),
    "pauli_channel": lambda c, q, ax, ay, az: c.pauli_channel(
        int(q), _angle(ax), _angle(ay), _angle(az)),
}


def encode_circuit(circuit) -> dict:
    """The wire form of a recorded circuit: qubit count, declared
    parameter names (registration order — it is part of the digest),
    the builder-call journal, and the content digest. Raises
    :class:`WireFormatError` naming the first op that resists content
    addressing (user-supplied callable payloads, inverted circuits)."""
    rows = circuit._wire_rows()
    for i, (row, op) in enumerate(zip(rows, circuit.ops)):
        if row is None:
            raise WireFormatError(
                f"op {i} (kind {op.kind!r}) is not wire-serializable: "
                "callable payloads and journal-bypassing mutations "
                "(inverse, direct op edits) have no stable wire form — "
                "record the circuit through the builder API",
                detail={"op_index": i, "op_kind": op.kind})
    from ..serve.warmcache import circuit_digest
    return {"qubits": int(circuit.num_qubits),
            "params": list(circuit.param_names),
            "ops": rows,
            "digest": circuit_digest(circuit)}


def decode_circuit(doc: dict, *, verify_digest: bool = True):
    """Replay a wire circuit back into a recorded
    :class:`~quest_tpu_torch.circuits.Circuit`; with ``verify_digest`` the
    recomputed content digest must match the document's claim."""
    from ..circuits import Circuit
    from ..serve.warmcache import circuit_digest
    if not isinstance(doc, dict) or "qubits" not in doc:
        raise WireFormatError("circuit document needs a 'qubits' field")
    c = Circuit(int(doc["qubits"]))
    # pre-register declared parameters: registration ORDER is part of
    # the digest and of the param-vector layout
    for nm in doc.get("params", []):
        c.parameter(str(nm))
    for i, row in enumerate(doc.get("ops", [])):
        try:
            fn = _REPLAY[row[0]]
        except (KeyError, IndexError, TypeError):
            raise WireFormatError(
                f"op {i}: unknown wire op "
                f"{row[0] if isinstance(row, list) and row else row!r}")
        try:
            fn(c, *row[1:])
        except WireFormatError:
            raise
        # quest: allow-broad-except(replay failures must reject typed
        # at the wire boundary, whatever the builder raised)
        except Exception as e:
            raise WireFormatError(
                f"op {i} ({row[0]!r}) failed to replay: "
                f"{type(e).__name__}: {e}")
    want = doc.get("digest")
    if verify_digest and want is not None:
        have = circuit_digest(c)
        if have != want:
            raise DigestMismatch(
                "decoded circuit's content digest does not match the "
                "submission's claim — rejecting rather than serving a "
                "mis-assembled program",
                detail={"claimed": want, "computed": have})
    return c


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------


class WireRequest:
    """One decoded wire request, normalized: the server resolves
    ``circuit``/``circuit_ref``/``qasm`` to a program and passes
    :meth:`submit_kwargs` straight to the backend's ``submit``."""

    __slots__ = ("kind", "circuit_doc", "circuit_ref", "qasm", "params",
                 "observables", "shots", "trajectories",
                 "sampling_budget", "tier", "priority", "timeout_s",
                 "evolve", "ground", "init_state", "optimizer",
                 "request_id", "resumable")

    def __init__(self, **kw):
        for name in self.__slots__:
            setattr(self, name, kw.get(name))

    def submit_kwargs(self) -> dict:
        """The backend ``submit()`` kwargs this request maps onto
        (program and deadline are supplied by the server)."""
        kw = {}
        if self.params is not None:
            kw["params"] = self.params
        if self.observables is not None:
            kw["observables"] = self.observables
        if self.kind == "shots":
            kw["shots"] = self.shots
        if self.kind in ("trajectory", "gradient") \
                and self.trajectories is not None:
            kw["trajectories"] = self.trajectories
            if self.sampling_budget is not None:
                kw["sampling_budget"] = self.sampling_budget
        if self.kind == "gradient":
            kw["gradient"] = True
        if self.kind == "evolve":
            kw["evolve"] = self.evolve
        if self.kind == "ground":
            kw["ground_state"] = self.ground
        if self.init_state is not None:
            kw["init_state"] = self.init_state
        if self.tier is not None:
            kw["tier"] = self.tier
        if self.priority is not None:
            kw["priority"] = self.priority
        return kw


def _decode_observables(doc):
    if doc is None:
        return None
    try:
        terms = [[(int(q), int(code)) for q, code in term]
                 for term in doc["terms"]]
        coeffs = [float(c) for c in doc["coeffs"]]
    except (KeyError, TypeError, ValueError) as e:
        raise WireFormatError(
            f"observables must be {{'terms': [[[qubit, pauli_code], "
            f"...], ...], 'coeffs': [...]}}: {e}")
    return (terms, coeffs)


def _encode_observables(observables):
    if observables is None:
        return None
    terms, coeffs = observables
    return {"terms": [[[int(q), int(code)] for q, code in term]
                      for term in terms],
            "coeffs": [float(c) for c in coeffs]}


def encode_request(kind: str, *, circuit=None, circuit_ref=None,
                   qasm=None, params=None, observables=None, shots=None,
                   trajectories=None, sampling_budget=None, tier=None,
                   priority=None, timeout_s=None, evolve=None,
                   ground=None, init_state=None, optimizer=None,
                   request_id=None, resumable=None) -> dict:
    """Build one canonical wire request document. ``circuit`` is a
    recorded Circuit (encoded inline), ``circuit_ref`` a digest the
    server already registered, ``qasm`` an OpenQASM 2.0 source string —
    exactly one of the three."""
    if kind not in REQUEST_KINDS:
        raise WireFormatError(
            f"unknown request kind {kind!r}; expected one of "
            f"{REQUEST_KINDS}")
    programs = [p for p in (circuit, circuit_ref, qasm) if p is not None]
    if len(programs) != 1:
        raise WireFormatError(
            "a request names its program as exactly ONE of circuit= "
            "(wire form), circuit_ref= (registered digest), or qasm= "
            "(OpenQASM 2.0 source)")
    doc = {"schema": WIRE_SCHEMA, "kind": kind}
    if circuit is not None:
        doc["circuit"] = circuit if isinstance(circuit, dict) \
            else encode_circuit(circuit)
    if circuit_ref is not None:
        doc["circuit_ref"] = str(circuit_ref)
    if qasm is not None:
        doc["qasm"] = str(qasm)
    if params is not None:
        doc["params"] = {str(k): float(v) for k, v in dict(params).items()}
    if observables is not None:
        doc["observables"] = _encode_observables(observables)
    if shots is not None:
        doc["shots"] = int(shots)
    if trajectories is not None:
        doc["trajectories"] = int(trajectories)
    if sampling_budget is not None:
        doc["sampling_budget"] = float(sampling_budget)
    if tier is not None:
        doc["tier"] = getattr(tier, "name", str(tier))
    if priority is not None:
        doc["priority"] = int(priority)
    if timeout_s is not None:
        doc["timeout_s"] = float(timeout_s)
    if evolve is not None:
        doc["evolve"] = {"t": float(evolve.t), "steps": int(evolve.steps),
                         "order": int(evolve.order)} \
            if not isinstance(evolve, dict) else dict(evolve)
    if ground is not None:
        doc["ground"] = {"steps": int(ground.steps),
                         "tau": float(ground.tau),
                         "method": str(ground.method),
                         "tol": float(ground.tol)} \
            if not isinstance(ground, dict) else dict(ground)
    if init_state is not None:
        st = np.asarray(init_state, dtype=np.float64)
        doc["init_state"] = {"planes": st.tolist()}
    if optimizer is not None:
        doc["optimizer"] = dict(optimizer)
    if request_id is not None:
        doc["request_id"] = str(request_id)
    if resumable:
        doc["resumable"] = True
    return doc


def decode_request(doc: dict) -> WireRequest:
    """Validate + normalize one wire request document (strict v1: an
    unknown schema, kind, or top-level key rejects typed)."""
    if not isinstance(doc, dict):
        raise WireFormatError("request body must be a JSON object")
    schema = doc.get("schema")
    if schema != WIRE_SCHEMA:
        raise WireFormatError(
            f"unknown wire schema {schema!r}; this server speaks "
            f"{WIRE_SCHEMA}")
    for key in _FORBIDDEN_DEADLINE_KEYS:
        if key in doc:
            raise WireFormatError(
                f"{key!r} is not part of the wire form: deadlines are "
                "RELATIVE (timeout_s, seconds from server receipt) — "
                "client clocks are not trusted")
    unknown = sorted(set(doc) - _REQUEST_KEYS)
    if unknown:
        raise WireFormatError(
            f"unknown request keys {unknown}: quest_tpu.wire/1 is "
            "strict — a typo'd knob must not silently serve defaults")
    kind = doc.get("kind")
    if kind not in REQUEST_KINDS:
        raise WireFormatError(
            f"unknown request kind {kind!r}; expected one of "
            f"{REQUEST_KINDS}")
    programs = [k for k in ("circuit", "circuit_ref", "qasm")
                if doc.get(k) is not None]
    if len(programs) != 1:
        raise WireFormatError(
            f"a request names exactly ONE program source; got "
            f"{programs or 'none'}")
    params = doc.get("params")
    if params is not None:
        if not isinstance(params, dict):
            raise WireFormatError("params must be a name->angle object")
        params = {str(k): float(v) for k, v in params.items()}
    request_id = doc.get("request_id")
    if request_id is not None:
        if not isinstance(request_id, str) or not request_id:
            raise WireFormatError(
                "request_id must be a non-empty string — it is the "
                "idempotency key the dedup window stores verbatim")
        if len(request_id) > _MAX_REQUEST_ID_LEN:
            raise WireFormatError(
                f"request_id exceeds {_MAX_REQUEST_ID_LEN} chars")
    resumable = doc.get("resumable")
    if resumable is not None and not isinstance(resumable, bool):
        raise WireFormatError("resumable must be a JSON boolean")
    timeout_s = doc.get("timeout_s")
    if timeout_s is not None:
        timeout_s = float(timeout_s)
        if not (timeout_s > 0.0 and np.isfinite(timeout_s)):
            raise WireFormatError(
                f"timeout_s must be a finite positive relative budget; "
                f"got {timeout_s!r}")
    evolve = ground = None
    if kind == "evolve":
        spec = doc.get("evolve")
        if not isinstance(spec, dict):
            raise WireFormatError(
                "evolve requests carry evolve={'t', 'steps', 'order'}")
        from ..ops.dynamics import EvolveSpec
        try:
            evolve = EvolveSpec(t=float(spec["t"]),
                                steps=int(spec["steps"]),
                                order=int(spec.get("order", 2)))
        except (KeyError, TypeError, ValueError) as e:
            raise WireFormatError(f"bad evolve spec: {e}")
    if kind == "ground":
        spec = doc.get("ground")
        if not isinstance(spec, dict):
            raise WireFormatError(
                "ground requests carry ground={'steps', 'tau', "
                "'method', 'tol'}")
        from ..ops.dynamics import GroundSpec
        try:
            ground = GroundSpec(steps=int(spec.get("steps", 16)),
                                tau=float(spec.get("tau", 0.1)),
                                method=str(spec.get("method", "power")),
                                tol=float(spec.get("tol", 1e-9)))
        except (TypeError, ValueError) as e:
            raise WireFormatError(f"bad ground spec: {e}")
    init_state = None
    st = doc.get("init_state")
    if st is not None:
        try:
            init_state = np.asarray(st["planes"], dtype=np.float64)
        except (KeyError, TypeError, ValueError) as e:
            raise WireFormatError(
                f"init_state must be {{'planes': [[...], [...]]}}: {e}")
    return WireRequest(
        kind=kind,
        circuit_doc=doc.get("circuit"),
        circuit_ref=doc.get("circuit_ref"),
        qasm=doc.get("qasm"),
        params=params,
        observables=_decode_observables(doc.get("observables")),
        shots=int(doc["shots"]) if doc.get("shots") is not None else None,
        trajectories=int(doc["trajectories"])
        if doc.get("trajectories") is not None else None,
        sampling_budget=float(doc["sampling_budget"])
        if doc.get("sampling_budget") is not None else None,
        tier=str(doc["tier"]) if doc.get("tier") is not None else None,
        priority=int(doc["priority"])
        if doc.get("priority") is not None else None,
        timeout_s=timeout_s,
        evolve=evolve, ground=ground, init_state=init_state,
        optimizer=doc.get("optimizer"),
        request_id=request_id, resumable=bool(resumable))


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


def encode_result(kind: str, value) -> dict:
    """The JSON form of one resolved in-process future, per kind.
    Mirrors the shapes :meth:`SimulationService.submit` documents."""
    if kind == "sweep":
        planes = np.asarray(value, dtype=np.float64)
        return {"planes": planes.tolist()}
    if kind == "expectation":
        return {"value": float(value)}
    if kind == "shots":
        outcomes, total = value
        return {"outcomes": [int(x) for x in np.asarray(outcomes)],
                "total_norm": float(total)}
    if kind == "trajectory":
        mean, stderr = value
        return {"mean": float(mean), "stderr": float(stderr)}
    if kind == "gradient":
        if len(value) == 3:              # trajectory gradient
            v, grad, stderr = value
            return {"value": float(v),
                    "grad": np.asarray(grad, dtype=np.float64).tolist(),
                    "stderr": np.asarray(stderr,
                                         dtype=np.float64).tolist()}
        v, grad = value
        return {"value": float(v),
                "grad": np.asarray(grad, dtype=np.float64).tolist()}
    if kind in ("evolve", "ground"):
        # the packed per-row dynamics block, verbatim: callers decode
        # with ops.dynamics.unpack_evolve_block / unpack_ground_block
        return {"block": np.asarray(value, dtype=np.float64).tolist()}
    raise WireFormatError(f"unknown result kind {kind!r}")


def parse_result(kind: str, doc: dict):
    """Client side: the wire result back into the exact value shape the
    in-process future resolves with."""
    if kind == "sweep":
        return np.asarray(doc["planes"], dtype=np.float64)
    if kind == "expectation":
        return float(doc["value"])
    if kind == "shots":
        return (np.asarray(doc["outcomes"], dtype=np.int64),
                float(doc["total_norm"]))
    if kind == "trajectory":
        return (float(doc["mean"]), float(doc["stderr"]))
    if kind == "gradient":
        if "stderr" in doc:
            return (float(doc["value"]),
                    np.asarray(doc["grad"], dtype=np.float64),
                    np.asarray(doc["stderr"], dtype=np.float64))
        return (float(doc["value"]),
                np.asarray(doc["grad"], dtype=np.float64))
    if kind in ("evolve", "ground"):
        return np.asarray(doc["block"], dtype=np.float64)
    raise WireFormatError(f"unknown result kind {kind!r}")
