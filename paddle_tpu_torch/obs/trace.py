"""Chrome trace-event recording (counterpart of
``paddle_tpu/obs/trace.py``): the per-request lifecycle spans and counter
tracks the serving engine emits at its host boundaries, exported as the
JSON object format Perfetto and chrome://tracing load (the Trace Event
Format's ``X`` / ``i`` / ``C`` / ``M`` phases).

One event is an epoch subtraction and one ``list.append`` into a bounded
buffer: past ``max_events`` new events are counted as dropped (exported
in the trace's metadata). Timestamps are microseconds from the
recorder's epoch (``time.perf_counter`` at construction), so the engine
passes the host stamps it already takes. Nothing here touches a tensor.
"""
from __future__ import annotations

import json
import time

__all__ = ["TraceRecorder", "validate_chrome_trace",
           "load_chrome_trace"]

_PID = 1  # single-process traces: one pid, tracks are tids


class TraceRecorder:
    """Bounded trace-event buffer.

    Event kinds (all take ``t``/``t0``/``t1`` as perf_counter seconds,
    converted to epoch-relative µs):

    - :meth:`complete` — an ``X`` span (name, start, duration).
    - :meth:`instant` — an ``i`` thread-scoped marker.
    - :meth:`counter` — a ``C`` sampled-values track (dict of series).
    - :meth:`thread_name` — an ``M`` metadata record naming a track.
    """

    def __init__(self, max_events=65536, epoch=None):
        self.max_events = int(max_events)
        self.epoch = time.perf_counter() if epoch is None else float(epoch)
        self.events = []
        self.dropped = 0
        self._named = set()

    def __len__(self):
        return len(self.events)

    def _us(self, t):
        return round((float(t) - self.epoch) * 1e6, 3)

    def _push(self, ev):
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def thread_name(self, tid, name):
        """Name a track (idempotent)."""
        if tid in self._named:
            return
        self._named.add(tid)
        self._push({"name": "thread_name", "ph": "M", "pid": _PID,
                    "tid": int(tid), "args": {"name": str(name)}})

    def complete(self, name, t0, t1, tid=0, args=None):
        ev = {"name": str(name), "ph": "X", "pid": _PID,
              "tid": int(tid), "ts": self._us(t0),
              "dur": max(round((float(t1) - float(t0)) * 1e6, 3), 0.0)}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def instant(self, name, t, tid=0, args=None):
        ev = {"name": str(name), "ph": "i", "s": "t", "pid": _PID,
              "tid": int(tid), "ts": self._us(t)}
        if args:
            ev["args"] = dict(args)
        self._push(ev)

    def counter(self, name, t, values, tid=0):
        self._push({"name": str(name), "ph": "C", "pid": _PID,
                    "tid": int(tid), "ts": self._us(t),
                    "args": {k: float(v) for k, v in values.items()}})

    # -- export ------------------------------------------------------------
    def chrome_trace(self):
        """The JSON Object Format: ``traceEvents`` + metadata.
        Events sorted by (ts, tid) — loaders do not require order, but
        determinism keeps golden comparisons byte-stable."""
        evs = sorted(self.events,
                     key=lambda e: (e.get("ts", -1.0), e["tid"],
                                    e["name"]))
        return {
            "traceEvents": evs,
            "displayTimeUnit": "ms",
            "otherData": {
                "producer": "paddle_tpu_torch.obs",
                "dropped_events": self.dropped,
            },
        }

    def save(self, path):
        obj = self.chrome_trace()
        validate_chrome_trace(obj)
        with open(path, "w") as f:
            json.dump(obj, f, sort_keys=True)
        return path


_REQUIRED_BY_PHASE = {
    "X": ("ts", "dur"),
    "i": ("ts",),
    "C": ("ts", "args"),
    "M": ("args",),
}


def validate_chrome_trace(obj):
    """Schema check for the subset of the Trace Event Format this
    recorder emits; raises ValueError with the first offending event.
    Used by :meth:`TraceRecorder.save`, the CLI, and the round-trip
    test."""
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        raise ValueError("not a chrome trace: missing 'traceEvents'")
    for i, ev in enumerate(obj["traceEvents"]):
        ctx = f"traceEvents[{i}] = {ev!r}"
        for k in ("name", "ph", "pid", "tid"):
            if k not in ev:
                raise ValueError(f"{ctx}: missing {k!r}")
        ph = ev["ph"]
        if ph not in _REQUIRED_BY_PHASE:
            raise ValueError(f"{ctx}: unsupported phase {ph!r}")
        for k in _REQUIRED_BY_PHASE[ph]:
            if k not in ev:
                raise ValueError(f"{ctx}: phase {ph!r} missing {k!r}")
        if "ts" in ev and (not isinstance(ev["ts"], (int, float))
                           or ev["ts"] < 0):
            raise ValueError(f"{ctx}: ts must be a non-negative number")
        if ph == "X" and (not isinstance(ev["dur"], (int, float))
                          or ev["dur"] < 0):
            raise ValueError(f"{ctx}: dur must be a non-negative number")
        if ph == "i" and ev.get("s", "t") not in ("t", "p", "g"):
            raise ValueError(f"{ctx}: instant scope must be t|p|g")
    return obj


def load_chrome_trace(path):
    """Load + validate a saved trace; returns the dict."""
    with open(path) as f:
        obj = json.load(f)
    return validate_chrome_trace(obj)
