"""The port's ``quest_tpu.wire/1`` form, against the JAX package's.

The JAX package's wire tests, run on the port: a journal round trip lands
on the same content digest, un-journalable circuits reject typed, and the
strict-v1 request validation rejects at the boundary. Then the two
packages side by side: for every one of the 13 journal row kinds, static
and (where the builder takes one) Param, the ``qubits``/``params``/``ops``
of both packages' documents are ``canonical_json``-equal; static digests
are equal; a Param document of one package raises ``DigestMismatch`` in
the other and replays there with ``verify_digest=False`` to that
package's own recording of the same calls; ``extend`` and ``with_noise``
journal alike; request and result documents are byte-equal; and each
strict-v1 rejection has the same type and HTTP status in both. No device
work anywhere in this module.
"""

import json

import numpy as np
import pytest

import quest_tpu as jq
from quest_tpu.netserve import wire as jwire
from quest_tpu.serve.warmcache import circuit_digest as jdigest
import quest_tpu_torch as tq
from quest_tpu_torch.circuits import Circuit
from quest_tpu_torch.netserve import (DigestMismatch, WireFormatError,
                                      http_status, wire)
from quest_tpu_torch.ops.dynamics import EvolveSpec, GroundSpec
from quest_tpu_torch.serve.warmcache import circuit_digest
from torch_threads import one_blas_thread  # noqa: F401


def _roundtrip(circuit):
    """Encode -> canonical JSON text -> parse -> decode, the actual
    wire path."""
    doc = json.loads(wire.canonical_json(wire.encode_circuit(circuit)))
    return wire.decode_circuit(doc), doc


def _param_circuit(C=Circuit):
    c = C(3)
    t0 = c.parameter("t0")
    t1 = c.parameter("t1")
    c.h(0)
    c.cnot(0, 1)
    c.rx(1, t0)
    c.ry(2, 0.3)
    c.rz(0, t1)
    c.cphase(0, 2, 0.25)
    c.crz(1, 2, t0)
    c.multi_rotate_z([0, 2], t1)
    c.phase(1, 0.5)
    c.x(2)
    c.s(0)
    c.t(1)
    return c


class TestCircuitRoundTrip:
    def test_param_circuit_digest_stable(self):
        c = _param_circuit()
        c2, doc = _roundtrip(c)
        assert doc["digest"] == circuit_digest(c)
        assert circuit_digest(c2) == circuit_digest(c)
        assert c2.param_names == c.param_names
        assert len(c2.ops) == len(c.ops)

    def test_channel_circuit_digest_stable(self):
        d = Circuit(2)
        g = d.parameter("g")
        d.h(0)
        d.dephase(0, g)
        d.depolarise(1, 0.05)
        d.damp(0, g)
        d.pauli_channel(1, 0.01, g, 0.02)
        d.kraus([np.eye(2), np.zeros((2, 2))], [0])
        d2, _ = _roundtrip(d)
        assert circuit_digest(d2) == circuit_digest(d)

    def test_gate_and_diagonal_digest_stable(self):
        e = Circuit(2)
        e.gate(np.array([[1, 0], [0, 1j]]), [1], [0])
        e.diagonal(np.array([1, 1j, -1, -1j]).reshape(2, 2), (0, 1))
        e2, _ = _roundtrip(e)
        assert circuit_digest(e2) == circuit_digest(e)

    def test_signed_zero_matrix_entries_survive(self):
        """The digest hashes exact BYTES: a matrix containing -0.0 must
        round-trip bit for bit."""
        e = Circuit(1)
        e.gate(np.array([[1.0, -0.0], [0.0, -1.0]], dtype=complex), [0])
        e2, _ = _roundtrip(e)
        assert circuit_digest(e2) == circuit_digest(e)

    def test_inverse_is_opaque(self):
        s = Circuit(2)
        s.h(0)
        s.cnot(0, 1)
        s.t(1)
        with pytest.raises(WireFormatError, match="not wire-serializ"):
            wire.encode_circuit(s.inverse())

    def test_callable_payload_is_opaque(self):
        f = Circuit(1)
        f.parameter("a")
        f.gate(lambda a: np.eye(2), [0])
        with pytest.raises(WireFormatError, match="not wire-serializ"):
            wire.encode_circuit(f)

    def test_digest_mismatch_rejects(self):
        c = _param_circuit()
        doc = wire.encode_circuit(c)
        doc["digest"] = "0" * 64
        with pytest.raises(DigestMismatch) as ei:
            wire.decode_circuit(doc)
        assert ei.value.detail["claimed"] == "0" * 64
        assert ei.value.detail["computed"] == circuit_digest(c)
        assert ei.value.status == 409

    def test_unknown_op_rejects_with_index(self):
        doc = wire.encode_circuit(_param_circuit())
        doc["ops"][2] = ["frobnicate", 0]
        with pytest.raises(WireFormatError, match="op 2"):
            wire.decode_circuit(doc, verify_digest=False)

    def test_decoded_circuit_runs_like_the_original(self):
        c = _param_circuit()
        c2, _ = _roundtrip(c)
        env = tq.createQuESTEnv(precision=tq.DOUBLE, device="cpu")
        pm = np.array([[0.3, -0.7], [1.1, 0.2]])
        a = c.compile(env).sweep(pm).numpy()
        b = c2.compile(env).sweep(pm).numpy()
        np.testing.assert_array_equal(a, b)


class TestRequestValidation:
    def _req(self, **kw):
        kw.setdefault("circuit", _param_circuit())
        kw.setdefault("params", {"t0": 0.1, "t1": 0.2})
        return wire.encode_request(
            kw.pop("kind", "expectation"),
            observables=kw.pop("observables",
                               ([[(0, 3)], [(1, 1)]], [1.0, 0.5])),
            **kw)

    def test_roundtrip_all_kinds(self):
        c = _param_circuit()
        obs = ([[(0, 3)]], [1.0])
        docs = [
            wire.encode_request("sweep", circuit=c, params={"t0": 0.1,
                                                            "t1": 0.2}),
            wire.encode_request("expectation", circuit=c,
                                observables=obs),
            wire.encode_request("shots", circuit=c, shots=16),
            wire.encode_request("trajectory", circuit=c,
                                observables=obs, trajectories=32,
                                sampling_budget=1e-2),
            wire.encode_request("gradient", circuit=c,
                                observables=obs),
            wire.encode_request("evolve", circuit=c, observables=obs,
                                evolve={"t": 0.5, "steps": 8,
                                        "order": 2}),
            wire.encode_request("ground", circuit=c, observables=obs,
                                ground={"steps": 4, "tau": 0.1,
                                        "method": "power",
                                        "tol": 1e-9}),
        ]
        for doc in docs:
            wr = wire.decode_request(json.loads(wire.canonical_json(doc)))
            assert wr.kind == doc["kind"]
            if wr.kind == "shots":
                assert wr.submit_kwargs()["shots"] == 16
            if wr.kind == "trajectory":
                kw = wr.submit_kwargs()
                assert kw["trajectories"] == 32
                assert kw["sampling_budget"] == pytest.approx(1e-2)
            if wr.kind == "gradient":
                assert wr.submit_kwargs()["gradient"] is True
            if wr.kind == "evolve":
                assert isinstance(wr.evolve, EvolveSpec)
                assert wr.evolve.steps == 8
                assert "evolve" in wr.submit_kwargs()
            if wr.kind == "ground":
                assert isinstance(wr.ground, GroundSpec)
                assert wr.ground.tau == pytest.approx(0.1)
                assert "ground_state" in wr.submit_kwargs()

    def test_absolute_deadline_keys_reject_by_name(self):
        base = self._req(timeout_s=5.0)
        for key in ("deadline", "deadline_s", "deadline_epoch",
                    "expires_at", "deadline_wall"):
            doc = dict(base)
            doc[key] = 4102444800.0          # far-future epoch
            with pytest.raises(WireFormatError, match="RELATIVE"):
                wire.decode_request(doc)

    def test_unknown_top_level_key_rejects(self):
        doc = self._req()
        doc["shotz"] = 4
        with pytest.raises(WireFormatError, match="shotz"):
            wire.decode_request(doc)

    def test_unknown_schema_rejects(self):
        doc = self._req()
        doc["schema"] = "quest_tpu.wire/99"
        with pytest.raises(WireFormatError, match="schema"):
            wire.decode_request(doc)

    def test_unknown_kind_rejects(self):
        with pytest.raises(WireFormatError, match="kind"):
            wire.encode_request("teleport", circuit=_param_circuit())

    def test_program_source_arity(self):
        c = _param_circuit()
        with pytest.raises(WireFormatError, match="exactly ONE"):
            wire.encode_request("sweep", circuit=c, qasm="OPENQASM...")
        with pytest.raises(WireFormatError, match="ONE program"):
            wire.decode_request({"schema": wire.WIRE_SCHEMA,
                                 "kind": "sweep"})

    def test_bad_timeout_rejects(self):
        for bad in (0.0, -1.0):
            doc = self._req()
            doc["timeout_s"] = bad
            with pytest.raises(WireFormatError, match="timeout_s"):
                wire.decode_request(doc)

    def test_params_roundtrip_exact(self):
        doc = self._req(params={"t0": 0.123456789012345, "t1": -2.5})
        wr = wire.decode_request(json.loads(wire.canonical_json(doc)))
        assert wr.params == {"t0": 0.123456789012345, "t1": -2.5}

    def test_observables_shape_errors(self):
        doc = self._req()
        doc["observables"] = {"terms": "nope"}
        with pytest.raises(WireFormatError, match="observables"):
            wire.decode_request(doc)


class TestResults:
    def test_result_roundtrips(self):
        planes = np.arange(8, dtype=np.float64).reshape(2, 4)
        got = wire.parse_result("sweep", wire.encode_result("sweep",
                                                            planes))
        np.testing.assert_array_equal(got, planes)
        assert wire.parse_result(
            "expectation", wire.encode_result("expectation", 0.25)) == 0.25
        outcomes = np.array([0, 3, 1], dtype=np.int64)
        o2, norm = wire.parse_result(
            "shots", wire.encode_result("shots", (outcomes, 0.999)))
        np.testing.assert_array_equal(o2, outcomes)
        assert o2.dtype == np.int64
        assert norm == pytest.approx(0.999)
        mean, stderr = wire.parse_result(
            "trajectory", wire.encode_result("trajectory", (0.5, 0.01)))
        assert (mean, stderr) == (0.5, 0.01)
        v, g = wire.parse_result(
            "gradient",
            wire.encode_result("gradient", (1.5, np.array([0.1, -0.2]))))
        assert v == 1.5
        np.testing.assert_array_equal(g, [0.1, -0.2])
        v, g, s = wire.parse_result(
            "gradient", wire.encode_result("gradient", (
                1.5, np.array([0.1]), np.array([0.01]))))
        np.testing.assert_array_equal(s, [0.01])
        block = np.arange(6, dtype=np.float64)
        np.testing.assert_array_equal(
            wire.parse_result("evolve", wire.encode_result("evolve", block)),
            block)

    def test_unknown_result_kind_rejects(self):
        with pytest.raises(WireFormatError):
            wire.encode_result("teleport", 1.0)


class TestCanonicalJson:
    def test_sorted_and_compact(self):
        assert wire.canonical_json({"b": 1, "a": [1, 2]}) \
            == '{"a":[1,2],"b":1}'

    def test_nan_rejects(self):
        with pytest.raises(WireFormatError):
            wire.canonical_json({"x": float("nan")})

    def test_jsonable_numpy(self):
        doc = wire.jsonable({"a": np.float64(1.5), "b": np.int32(3),
                             "c": np.array([1.0, 2.0]),
                             "d": np.bool_(True), "e": (1, "x", None)})
        assert doc == {"a": 1.5, "b": 3, "c": [1.0, 2.0], "d": True,
                       "e": [1, "x", None]}
        json.dumps(doc)


# -- the two packages side by side ------------------------------------------

KRAUS = [np.sqrt(0.7) * np.eye(2),
         np.sqrt(0.3) * np.array([[0.0, 1.0], [1.0, 0.0]])]

# row kind -> builder call on a 3-qubit circuit with angle (or rate) ``a``;
# None = the builder takes no Param (its callable form journals opaque)
ROW_BUILDERS = {
    "gate": (lambda c, a: c.gate(np.array([[0.6, 0.8j], [0.8j, 0.6]]),
                                 (2,), (0,), (0,)), False),
    "diagonal": (lambda c, a: c.diagonal(
        np.array([[1.0, 1j], [-1.0, np.exp(0.3j)]]), (2, 0)), False),
    "kraus": (lambda c, a: c.kraus(KRAUS, (1,)), False),
    "phase": (lambda c, a: c.phase(1, a), True),
    "rot": (lambda c, a: c._rot(1, a, (0.6, 0.0, 0.8), (0, 2)), True),
    "rz": (lambda c, a: c.rz(2, a), True),
    "cphase": (lambda c, a: c.cphase(2, 0, a), True),
    "crz": (lambda c, a: c.crz(0, 2, a), True),
    "multi_rotate_z": (lambda c, a: c.multi_rotate_z([2, 0, 1], a), True),
    "dephase": (lambda c, a: c.dephase(0, a), True),
    "depolarise": (lambda c, a: c.depolarise(1, a), True),
    "damp": (lambda c, a: c.damp(2, a), True),
    "pauli_channel": (lambda c, a: c.pauli_channel(0, 0.05, a, 0.02), True),
}

ROW_CASES = [(kind, param) for kind, (_, takes) in ROW_BUILDERS.items()
             for param in ((False, True) if takes else (False,))]


def _both(build):
    """The same builder calls recorded in each package."""
    return build(jq.Circuit), build(Circuit)


def _one_row(kind, param):
    fn = ROW_BUILDERS[kind][0]

    def build(C):
        c = C(3)
        fn(c, c.parameter("a") if param else 0.125)
        return c
    return build


def _program_fields(doc):
    return wire.canonical_json({k: doc[k] for k in ("qubits", "params",
                                                    "ops")})


@pytest.mark.parametrize("kind,param", ROW_CASES,
                         ids=[f"{k}-{'param' if p else 'static'}"
                              for k, p in ROW_CASES])
def test_each_row_kind_journals_alike(kind, param):
    jc, tc = _both(_one_row(kind, param))
    jdoc, tdoc = jwire.encode_circuit(jc), wire.encode_circuit(tc)
    assert _program_fields(tdoc) == _program_fields(jdoc)
    (row,) = tdoc["ops"]
    # a Param call journals its own row; a static one the primitive's
    expect = kind if param or kind in ("gate", "diagonal", "kraus") \
        else ("gate" if kind == "rot" else
              "kraus" if kind in ("dephase", "depolarise", "damp",
                                  "pauli_channel") else "diagonal")
    assert row[0] == expect
    if not param:
        assert tdoc["digest"] == jdoc["digest"]
    # each package's own document replays to its own digest
    assert circuit_digest(wire.decode_circuit(tdoc)) == tdoc["digest"]


def _mixed(C):
    c = C(3)
    t = c.parameter("t")
    for kind, (fn, takes) in ROW_BUILDERS.items():
        fn(c, t if takes and kind in ("rz", "rot", "damp") else 0.125)
    return c


def test_static_digests_cross_in_both_directions():
    def build(C):
        c = C(3)
        for kind, (fn, _) in ROW_BUILDERS.items():
            fn(c, 0.2)
        c.h(0)
        c.cnot(0, 1)
        c.swap(1, 2)
        c.t(2)
        return c
    jc, tc = _both(build)
    jdoc, tdoc = jwire.encode_circuit(jc), wire.encode_circuit(tc)
    assert tdoc == jdoc
    # each package decodes the other's document with the digest check on
    assert circuit_digest(wire.decode_circuit(jdoc)) == jdoc["digest"]
    assert jdigest(jwire.decode_circuit(tdoc)) == tdoc["digest"]


def test_a_param_document_crosses_only_without_the_digest_check():
    jc, tc = _both(_mixed)
    jdoc, tdoc = jwire.encode_circuit(jc), wire.encode_circuit(tc)
    assert _program_fields(tdoc) == _program_fields(jdoc)
    assert tdoc["digest"] != jdoc["digest"]
    with pytest.raises(DigestMismatch) as ei:
        wire.decode_circuit(jdoc)
    assert ei.value.status == 409
    assert ei.value.detail == {"claimed": jdoc["digest"],
                               "computed": tdoc["digest"]}
    from quest_tpu.netserve import DigestMismatch as JDigestMismatch
    with pytest.raises(JDigestMismatch):
        jwire.decode_circuit(tdoc)
    replayed = wire.decode_circuit(jdoc, verify_digest=False)
    assert circuit_digest(replayed) == circuit_digest(tc)
    assert jdigest(jwire.decode_circuit(tdoc, verify_digest=False)) \
        == jdigest(jc)


def test_extend_and_with_noise_journal_alike():
    def build(C):
        a = _param_circuit(C)
        b = C(3)
        b.crz(2, 1, b.parameter("u"))
        b.kraus(KRAUS, (0,))
        a.extend(b)
        return a.with_noise(C(3).parameter("p1"), 0.01, 0.002)
    jc, tc = _both(build)
    jdoc, tdoc = jwire.encode_circuit(jc), wire.encode_circuit(tc)
    assert _program_fields(tdoc) == _program_fields(jdoc)
    assert None not in tdoc["ops"]
    assert tc.param_names == ("t0", "t1", "u", "p1")
    assert circuit_digest(wire.decode_circuit(tdoc)) == tdoc["digest"]
    # the noisy copy keeps each base row ahead of the channels it adds
    # (a Param rate journals its builder, a static one the Kraus row)
    assert [r[0] for r in tdoc["ops"][:3]] == ["gate", "depolarise",
                                               "kraus"]


def test_inverse_rejects_typed_in_both():
    jc, tc = _both(lambda C: C(2).h(0).cnot(0, 1).t(1))
    for mod, c in ((jwire, jc.inverse()), (wire, tc.inverse())):
        with pytest.raises(mod.WireFormatError, match="not wire-serializ"):
            mod.encode_circuit(c)


def _request_docs(mod, C):
    c = _param_circuit(C)
    obs = ([[(0, 3)], [(1, 1), (2, 2)]], [1.0, -0.25])
    p = {"t0": 0.1, "t1": -0.3}
    return [
        mod.encode_request("sweep", circuit=c, params=p, tier="single",
                           priority=0, timeout_s=2.5, request_id="r-1"),
        mod.encode_request("expectation", circuit=c, params=p,
                           observables=obs, resumable=True),
        mod.encode_request("shots", circuit_ref="ab" * 32, shots=16),
        mod.encode_request("trajectory", circuit=c, params=p,
                           observables=obs, trajectories=32,
                           sampling_budget=1e-2),
        mod.encode_request("gradient", circuit=c, params=p,
                           observables=obs,
                           optimizer={"name": "adam", "max_iters": 3}),
        mod.encode_request("evolve", qasm="OPENQASM 2.0;\nqreg q[1];\n",
                           observables=obs,
                           evolve={"t": 0.5, "steps": 8, "order": 2},
                           init_state=np.eye(2, 2)),
        mod.encode_request("ground", circuit=c, observables=obs,
                           ground={"steps": 4, "tau": 0.1,
                                   "method": "lanczos", "tol": 1e-9}),
    ]


def test_request_documents_are_byte_equal():
    for jdoc, tdoc in zip(_request_docs(jwire, jq.Circuit),
                          _request_docs(wire, Circuit)):
        if "circuit" in jdoc:
            # the program fields agree; the digest is each package's own
            assert _program_fields(tdoc["circuit"]) == \
                _program_fields(jdoc["circuit"])
            jdoc = dict(jdoc, circuit=None)
            tdoc = dict(tdoc, circuit=None)
        assert wire.canonical_json(tdoc) == jwire.canonical_json(jdoc)


def test_spec_objects_encode_like_the_reference():
    from quest_tpu.ops.dynamics import EvolveSpec as JE, GroundSpec as JG
    for kind, key, t, j in (
            ("evolve", "evolve", EvolveSpec(t=0.5, steps=8, order=1),
             JE(t=0.5, steps=8, order=1)),
            ("ground", "ground", GroundSpec(steps=3, tau=0.2),
             JG(steps=3, tau=0.2))):
        a = wire.encode_request(kind, circuit_ref="x", **{key: t})
        b = jwire.encode_request(kind, circuit_ref="x", **{key: j})
        assert wire.canonical_json(a) == jwire.canonical_json(b)


RESULTS = [
    ("sweep", np.linspace(-1, 1, 16).reshape(2, 8)),
    ("expectation", np.float64(-0.731)),
    ("shots", (np.array([0, 3, 1, 7]), 0.9999999)),
    ("trajectory", (0.25, 0.0125)),
    ("gradient", (1.5, np.array([0.1, -0.2, 1e-17]))),
    ("gradient", (1.5, np.array([0.1]), np.array([0.01]))),
    ("evolve", np.linspace(0, 1, 11)),
    ("ground", np.linspace(-2, 0, 7)),
]


@pytest.mark.parametrize("kind,value", RESULTS,
                         ids=[f"{k}{i}" for i, (k, _) in enumerate(RESULTS)])
def test_result_documents_are_byte_equal(kind, value):
    t = wire.canonical_json(wire.encode_result(kind, value))
    j = jwire.canonical_json(jwire.encode_result(kind, value))
    assert t == j
    got = wire.parse_result(kind, json.loads(t))
    ref = jwire.parse_result(kind, json.loads(j))
    if isinstance(ref, tuple):
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(got, ref)


def _bad_docs(mod, C):
    ok = mod.encode_request("expectation", circuit=_param_circuit(C),
                            observables=([[(0, 3)]], [1.0]))
    bad_circuit = dict(ok["circuit"], ops=[["frobnicate", 0]])
    return {
        "not an object": [1, 2],
        "schema": dict(ok, schema="quest_tpu.wire/2"),
        "absolute deadline": dict(ok, expires_at=1.0),
        "unknown key": dict(ok, shotz=3),
        "kind": dict(ok, kind="teleport"),
        "two programs": dict(ok, qasm="OPENQASM 2.0;"),
        "no program": {"schema": mod.WIRE_SCHEMA, "kind": "sweep"},
        "params": dict(ok, params=[0.1]),
        "request id type": dict(ok, request_id=7),
        "request id length": dict(ok, request_id="x" * 129),
        "resumable": dict(ok, resumable="yes"),
        "timeout": dict(ok, timeout_s=-1.0),
        "evolve spec": dict(ok, kind="evolve", evolve={"steps": 2}),
        "ground spec": dict(ok, kind="ground", ground=[1]),
        "init state": dict(ok, init_state={"vec": []}),
        "observables": dict(ok, observables={"terms": 1}),
        "bad circuit row": dict(ok, circuit=bad_circuit),
    }


@pytest.mark.parametrize("case", sorted(_bad_docs(wire, Circuit)))
def test_each_strict_v1_rejection_matches_the_reference(case):
    tdoc = _bad_docs(wire, Circuit)[case]
    jdoc = _bad_docs(jwire, jq.Circuit)[case]
    errs = []
    for mod, doc in ((wire, tdoc), (jwire, jdoc)):
        with pytest.raises(Exception) as ei:
            wr = mod.decode_request(doc)
            if wr.circuit_doc is not None:
                mod.decode_circuit(wr.circuit_doc, verify_digest=False)
        errs.append(ei.value)
    t, j = errs
    assert type(t).__name__ == type(j).__name__ == "WireFormatError"
    from quest_tpu.netserve import http_status as jhttp_status
    assert http_status(t) == jhttp_status(j) == 400


def test_error_envelopes_match_the_reference():
    from quest_tpu.netserve import errors as jerr
    from quest_tpu_torch.netserve import errors as terr
    from quest_tpu.serve import QueueFull as JQueueFull
    from quest_tpu_torch.serve import QueueFull as TQueueFull
    pairs = [(terr.RateLimited("slow down", {"retry_after_s": 0.5}),
              jerr.RateLimited("slow down", {"retry_after_s": 0.5})),
             (terr.UnknownProgram("gone"), jerr.UnknownProgram("gone")),
             (terr.SessionExpired("idle"), jerr.SessionExpired("idle")),
             (TQueueFull("full"), JQueueFull("full")),
             (ValueError("bad"), ValueError("bad"))]
    for t, j in pairs:
        assert terr.http_status(t) == jerr.http_status(j)
        assert terr.error_body(t) == jerr.error_body(j)
        assert terr.retry_after_s(t) == jerr.retry_after_s(j)
