"""The persistent perf ledger: measured performance that survives
process restarts.

Everything the serving runtime measures — per-program request latency,
the batch buckets traffic actually hit, dispatch-profiler snapshots,
bench rows — dies with the process, so every restart cold-starts its
scheduling estimates. :class:`PerfLedger` is a small content-addressed
JSON store that accumulates those measurements across restarts. It
writes only under the directory its caller names (``PerfLedger(root)``)
or ``$QUEST_TPU_PERF_LEDGER_DIR`` names (:meth:`PerfLedger.from_env`;
unset means no ledger):

- **program records** (``programs/<sha256(digest)>.json``) — request
  counts, total/mean request seconds, the batch buckets and tiers
  observed, merged monotonically on every
  :meth:`SimulationService.close`. They seed the WFQ scheduler's
  per-program cost estimate and :meth:`SimulationService.warm`'s
  default bucket choices;
- **profile records** (``profile/<sha256(key)>.json``) — per-key
  dispatch-profiler aggregates (:meth:`record_profile`) so roofline
  attribution accumulates across runs;
- **bench rows** (``bench.jsonl``) — result rows appended by a bench,
  schema-stamped ``quest_tpu.perf/1`` (the JAX package's schema, so one
  comparison tool reads both).

Writes are read-merge-replace with an atomic ``os.replace`` (no torn
files). Concurrent processes merging the same slot race
last-writer-wins on one merge window — acceptable for monotone counters
that re-accumulate, never acceptable to crash on, so all I/O failures
degrade to "no record". The ledger can make a restart smarter; it must
never make one fail.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from typing import Optional

__all__ = ["PERF_SCHEMA", "PERF_LEDGER_ENV", "PerfLedger"]

PERF_SCHEMA = "quest_tpu.perf/1"
PERF_LEDGER_ENV = "QUEST_TPU_PERF_LEDGER_DIR"


def _slot(name: str) -> str:
    return hashlib.sha256(name.encode()).hexdigest()[:40]


class PerfLedger:
    """One on-disk perf ledger rooted at ``root`` (thread-safe; all I/O
    failures degrade to misses/no-ops)."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        # reentrant: the slot-merge helpers count errors/records while
        # the public record_* methods hold the ledger lock
        self._lock = threading.RLock()
        self._c = {"records": 0, "loads": 0, "errors": 0}

    @classmethod
    def from_env(cls) -> Optional["PerfLedger"]:
        """The ambient ledger: rooted at ``$QUEST_TPU_PERF_LEDGER_DIR``,
        None (disabled) when unset/empty."""
        root = os.environ.get(PERF_LEDGER_ENV, "").strip()
        if not root:
            return None
        try:
            return cls(root)
        except OSError:
            return None

    def _incr(self, name: str) -> None:
        with self._lock:
            self._c[name] += 1

    def stats(self) -> dict:
        with self._lock:
            return {**self._c, "root": self.root}

    # -- atomic JSON slots -------------------------------------------------

    def _read(self, path: str) -> Optional[dict]:
        try:
            with open(path) as fh:
                doc = json.load(fh)
            return doc if isinstance(doc, dict) else None
        except (OSError, ValueError):
            return None          # absent or torn: start the slot fresh

    def _write(self, path: str, doc: dict) -> bool:
        d = os.path.dirname(path)
        try:
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, indent=1, default=str)
            os.replace(tmp, path)       # atomic: no torn records
        except (OSError, TypeError, ValueError):
            self._incr("errors")
            return False
        self._incr("records")
        return True

    # -- program records ---------------------------------------------------

    def _program_path(self, digest: str) -> str:
        return os.path.join(self.root, "programs",
                            _slot(str(digest)) + ".json")

    def record_program(self, digest: str, *, requests: int = 0,
                       total_request_s: float = 0.0, buckets=None,
                       tiers=None) -> bool:
        """Merge one run's accounting for a program digest: counts and
        times add, bucket/tier histograms accumulate."""
        if not digest:
            return False
        with self._lock:
            path = self._program_path(digest)
            doc = self._read(path) or {
                "schema": PERF_SCHEMA, "kind": "program",
                "program": str(digest), "requests": 0,
                "total_request_s": 0.0, "buckets": {}, "tiers": {}}
            doc["requests"] = int(doc.get("requests", 0)) + int(requests)
            doc["total_request_s"] = float(
                doc.get("total_request_s", 0.0)) + float(total_request_s)
            doc["mean_request_s"] = (doc["total_request_s"]
                                     / doc["requests"]
                                     if doc["requests"] else 0.0)
            bk = doc.setdefault("buckets", {})
            for b, n in dict(buckets or {}).items():
                bk[str(int(b))] = int(bk.get(str(int(b)), 0)) + int(n)
            tk = doc.setdefault("tiers", {})
            for t, n in dict(tiers or {}).items():
                tk[str(t)] = int(tk.get(str(t), 0)) + int(n)
            doc["updated_wall"] = round(time.time(), 3)
            return self._write(path, doc)

    def program(self, digest: str) -> Optional[dict]:
        """One program's merged record (None when never recorded)."""
        self._incr("loads")
        with self._lock:
            return self._read(self._program_path(digest))

    def programs(self) -> list:
        """Every program record in the ledger."""
        d = os.path.join(self.root, "programs")
        out = []
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return out
        with self._lock:
            for name in names:
                if name.endswith(".json"):
                    doc = self._read(os.path.join(d, name))
                    if doc is not None:
                        out.append(doc)
        return out

    def mean_request_s(self, digest: Optional[str] = None) -> float:
        """Measured mean request seconds — for one program, or pooled
        over every recorded program (the router's EMA warm-start seed).
        0.0 when the ledger has nothing (callers keep their cold
        start)."""
        if digest is not None:
            doc = self.program(digest)
            if doc and doc.get("requests"):
                return float(doc.get("mean_request_s", 0.0))
            return 0.0
        total_n = 0
        total_s = 0.0
        for doc in self.programs():
            total_n += int(doc.get("requests", 0))
            total_s += float(doc.get("total_request_s", 0.0))
        return total_s / total_n if total_n else 0.0

    def warm_buckets(self, digest: str) -> tuple:
        """The batch buckets this program's traffic actually hit in
        prior runs, most-used first — :meth:`SimulationService.warm`'s
        default bucket choice. Empty when unrecorded."""
        doc = self.program(digest) if digest else None
        if not doc:
            return ()
        buckets = doc.get("buckets", {}) or {}
        try:
            ranked = sorted(buckets.items(),
                            key=lambda kv: (-int(kv[1]), int(kv[0])))
            return tuple(int(b) for b, _ in ranked)
        except (TypeError, ValueError):
            return ()

    # -- profile records ---------------------------------------------------

    def record_profile(self, snapshot: dict) -> int:
        """Merge a :meth:`~quest_tpu_torch.telemetry.profile.DispatchProfiler.
        snapshot`'s per-key aggregates (count, total seconds, bytes) so
        roofline attribution accumulates across restarts. Returns the
        number of keys written."""
        written = 0
        for keystr, key in (snapshot.get("keys", {}) or {}).items():
            count = int(key.get("count", 0))
            if count <= 0:
                continue
            path = os.path.join(self.root, "profile",
                                _slot(keystr) + ".json")
            with self._lock:
                doc = self._read(path) or {
                    "schema": PERF_SCHEMA, "kind": "profile",
                    "key": keystr, "count": 0, "total_s": 0.0}
                for f in ("site", "program", "kind", "bucket", "tier",
                          "dtype", "sharding", "replica"):
                    if f in key:
                        doc[f] = key[f]
                doc["count"] = int(doc.get("count", 0)) + count
                doc["total_s"] = float(doc.get("total_s", 0.0)) \
                    + float(key.get("mean_s", 0.0)) * count
                doc["mean_s"] = doc["total_s"] / doc["count"]
                doc["bytes_per_pass"] = float(
                    key.get("bytes_per_pass", 0.0))
                doc["roofline_frac"] = float(
                    key.get("roofline_frac", 0.0))
                doc["updated_wall"] = round(time.time(), 3)
                if self._write(path, doc):
                    written += 1
        return written

    def profiles(self) -> list:
        d = os.path.join(self.root, "profile")
        out = []
        try:
            names = sorted(os.listdir(d))
        except OSError:
            return out
        with self._lock:
            for name in names:
                if name.endswith(".json"):
                    doc = self._read(os.path.join(d, name))
                    if doc is not None:
                        out.append(doc)
        return out

    # -- bench rows --------------------------------------------------------

    def append_bench(self, row: dict) -> bool:
        """Append one bench result row (schema-stamped) to the ledger's
        ``bench.jsonl`` — the persistent bench trajectory a comparison
        gates regressions against."""
        try:
            line = json.dumps({"schema": PERF_SCHEMA, **row},
                              default=str)
        except (TypeError, ValueError):
            self._incr("errors")
            return False
        with self._lock:
            try:
                with open(os.path.join(self.root, "bench.jsonl"),
                          "a") as fh:
                    fh.write(line + "\n")
            except OSError:
                self._incr("errors")
                return False
            self._c["records"] += 1
        return True

    def bench_rows(self) -> list:
        """Every appended bench row, in order (torn lines skipped)."""
        out = []
        try:
            with open(os.path.join(self.root, "bench.jsonl")) as fh:
                for raw in fh:
                    raw = raw.strip()
                    if not raw:
                        continue
                    try:
                        out.append(json.loads(raw))
                    except ValueError:
                        continue
        except OSError:
            pass
        return out
