"""The unified event record: one schema for every bounded timeline.

A monotonic offset alone cannot be correlated across services (each
has its own ``t0``), across processes (monotonic clocks are per-boot),
or with anything wall-clock (an incident report, a Prometheus scrape, a
device profile). Every event carries BOTH clocks plus an optional trace
id:

``{"t": <seconds since the ring owner's t0, monotonic>, "wall": <epoch
seconds>, "event": <name>, ["trace": <trace id>,] **detail}``

The stream version is :data:`EVENT_SCHEMA` (the JAX package's, so one
reader takes both); a dump that carries a timeline stamps it next to the
events.

:func:`read_timeline` is how trace-consuming tools should read a ring:
it returns a plain list and warns ONCE per process when the source was
built with ``record_events=0`` — a silently empty recovery timeline
reads exactly like "nothing happened" (the knob disables the ring
entirely; pass ``record_events>0`` or leave the default).
"""

from __future__ import annotations

import threading
import time
import warnings
from typing import Optional

__all__ = ["EVENT_SCHEMA", "make_event", "read_timeline"]

EVENT_SCHEMA = "quest_tpu.event/1"

_warn_lock = threading.Lock()
_warned_eventless = False


def make_event(name: str, t0_mono: float,
               trace_id: Optional[str] = None, **detail) -> dict:
    """One versioned event record: monotonic offset (compat), wall
    epoch, and the trace id when the event belongs to one request."""
    now_m = time.monotonic()
    ev = {"t": round(now_m - t0_mono, 6),
          "wall": round(time.time(), 6),
          "event": name}
    if trace_id is not None:
        ev["trace"] = trace_id
    ev.update(detail)
    return ev


def read_timeline(source, tool: str = "a trace tool") -> list:
    """The event ring of a service/router as a plain list.

    Warns once per process when the ring is disabled
    (``record_events=0``): every downstream consumer silently renders
    empty against such a source, which looks exactly like "nothing
    happened" during an incident.
    """
    global _warned_eventless
    events = getattr(source, "events", None)
    if events is None:
        return []
    if getattr(events, "maxlen", None) == 0:
        with _warn_lock:
            if not _warned_eventless:
                _warned_eventless = True
                warnings.warn(
                    f"{tool} is reading the event timeline of a "
                    f"{type(source).__name__} created with "
                    "record_events=0: the ring is disabled and the "
                    "timeline will be empty. Pass record_events>0 "
                    "(default 256) to record one.",
                    RuntimeWarning, stacklevel=3)
    return list(events)
