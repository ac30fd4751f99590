"""Metrics registry of the port's serving tier (counterpart of
``paddle_tpu/obs/registry.py``).

Three label-aware instrument kinds: :class:`Counter` (monotonic, reset
only through the legacy stats view's ``_set`` or
:meth:`MetricsRegistry.reset`), :class:`Gauge` (last write wins) and
:class:`Histogram` (fixed upper-bound buckets declared at creation: one
bisect and two adds an observation). Two deterministic exports:
:meth:`MetricsRegistry.snapshot`, a stable-sorted JSON-able dict, and
Prometheus text (:meth:`MetricsRegistry.prometheus`, or
:func:`prometheus_from_snapshot` over a saved snapshot).

Host-side Python over plain dicts: nothing here touches a tensor.
"""
from __future__ import annotations

import bisect
import json
import math

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "prometheus_from_snapshot", "LATENCY_BUCKETS",
]

# shared default for latency-in-seconds histograms: 100 µs .. 10 s,
# roughly log-spaced (prometheus client_golang's defaults widened one
# decade down — quantum dispatches on small models sit under 1 ms)
LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

_VALID_TYPES = ("counter", "gauge", "histogram")


def _label_key(labels):
    """Canonical hashable form of a label dict: sorted (k, v) tuples,
    values coerced to str (prometheus labels are strings)."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Shared name/help/label bookkeeping; one ``_series`` entry per
    distinct label set."""

    type = None  # overridden

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._series = {}  # _label_key -> per-kind state

    def _labels_of(self, key):
        return {k: v for k, v in key}

    def reset(self):
        """Drop every recorded series (the instrument and its buckets
        stay registered). The bench-warmup reset: clears counters,
        gauges AND histogram observations in one call, replacing the
        old hand-zeroing through the legacy stats view."""
        self._series.clear()


class Counter(_Metric):
    type = "counter"

    def inc(self, amount=1.0, **labels):
        if amount < 0:
            raise ValueError(
                f"counter {self.name} cannot decrease (amount={amount}); "
                f"use a Gauge")
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels):
        return self._series.get(_label_key(labels), 0.0)

    def _set(self, value, **labels):
        """Reset hook for the legacy ServingEngine.stats view and bench
        warmup resets — intentionally private: counters are monotonic
        to every other caller."""
        self._series[_label_key(labels)] = float(value)


class Gauge(_Metric):
    type = "gauge"

    def set(self, value, **labels):
        self._series[_label_key(labels)] = float(value)

    def inc(self, amount=1.0, **labels):
        key = _label_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels):
        return self._series.get(_label_key(labels), 0.0)

    _set = set


class Histogram(_Metric):
    """Fixed-bucket histogram: ``buckets`` are the finite upper bounds
    (strictly increasing); the implicit ``+Inf`` bucket is the overflow.
    Internal counts are PER-BUCKET (non-cumulative); the exposition
    renders the cumulative prometheus form."""

    type = "histogram"

    def __init__(self, name, help="", buckets=LATENCY_BUCKETS):
        super().__init__(name, help)
        bs = [float(b) for b in buckets]
        if not bs or any(b2 <= b1 for b1, b2 in zip(bs, bs[1:])):
            raise ValueError(
                f"histogram {name}: buckets must be non-empty and "
                f"strictly increasing, got {buckets}")
        if any(math.isinf(b) for b in bs):
            raise ValueError(
                f"histogram {name}: +Inf bucket is implicit")
        self.buckets = tuple(bs)

    def observe(self, value, **labels):
        key = _label_key(labels)
        st = self._series.get(key)
        if st is None:
            st = self._series[key] = {
                "counts": [0] * (len(self.buckets) + 1),
                "sum": 0.0, "count": 0,
            }
        v = float(value)
        # first bucket whose upper bound >= v (prometheus `le` is <=)
        st["counts"][bisect.bisect_left(self.buckets, v)] += 1
        st["sum"] += v
        st["count"] += 1

    def count(self, **labels):
        st = self._series.get(_label_key(labels))
        return st["count"] if st else 0

    def sum(self, **labels):
        st = self._series.get(_label_key(labels))
        return st["sum"] if st else 0.0

    def bucket_counts(self, **labels):
        """Non-cumulative per-bucket counts (len(buckets) + 1 for the
        +Inf overflow)."""
        st = self._series.get(_label_key(labels))
        return (list(st["counts"]) if st
                else [0] * (len(self.buckets) + 1))

    def quantile(self, q, **labels):
        """Bucket-interpolated quantile estimate (the exposition-side
        approximation dashboards use); None when empty."""
        st = self._series.get(_label_key(labels))
        if not st or not st["count"]:
            return None
        target = q * st["count"]
        seen = 0
        lo = 0.0
        for i, c in enumerate(st["counts"]):
            if seen + c >= target and c:
                hi = (self.buckets[i] if i < len(self.buckets)
                      else self.buckets[-1])
                frac = (target - seen) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            seen += c
            if i < len(self.buckets):
                lo = self.buckets[i]
        return self.buckets[-1]


class MetricsRegistry:
    """Create-or-get instrument factory + the two exporters. Metric
    names are unique across kinds; re-registration with a different
    kind (or different histogram buckets) raises."""

    def __init__(self):
        self._metrics = {}

    def _get(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise ValueError(
                    f"metric {name!r} already registered as {m.type}")
            if kw.get("buckets") is not None \
                    and tuple(float(b) for b in kw["buckets"]) != m.buckets:
                raise ValueError(
                    f"histogram {name!r} re-registered with different "
                    f"buckets")
            return m
        m = cls(name, help, **{k: v for k, v in kw.items()
                               if v is not None})
        self._metrics[name] = m
        return m

    def counter(self, name, help=""):
        return self._get(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get(Gauge, name, help)

    def histogram(self, name, help="", buckets=None):
        return self._get(Histogram, name, help, buckets=buckets)

    def get(self, name):
        return self._metrics.get(name)

    def names(self):
        return sorted(self._metrics)

    def reset(self):
        """Reset every registered instrument (see
        :meth:`_Metric.reset`): one call returns the registry to its
        just-registered state between bench warmup and timed phases."""
        for m in self._metrics.values():
            m.reset()

    # -- export ------------------------------------------------------------
    def snapshot(self):
        """Stable-sorted JSON-able dict: metrics sorted by name, series
        sorted by label items. json.dumps of two snapshots of identical
        state are byte-identical."""
        metrics = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            entry = {"name": name, "type": m.type, "help": m.help}
            if m.type == "histogram":
                entry["buckets"] = list(m.buckets)
            series = []
            for key in sorted(m._series):
                labels = {k: v for k, v in key}
                if m.type == "histogram":
                    st = m._series[key]
                    series.append({"labels": labels,
                                   "counts": list(st["counts"]),
                                   "sum": st["sum"],
                                   "count": st["count"]})
                else:
                    series.append({"labels": labels,
                                   "value": m._series[key]})
            entry["series"] = series
            metrics.append(entry)
        return {"version": 1, "metrics": metrics}

    def snapshot_json(self, indent=None):
        return json.dumps(self.snapshot(), indent=indent,
                          sort_keys=True)

    def prometheus(self):
        return prometheus_from_snapshot(self.snapshot())


def _fmt_value(v):
    if v == math.inf:
        return "+Inf"
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _fmt_labels(labels, extra=()):
    items = list(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in items)
    return "{" + body + "}"


def prometheus_from_snapshot(snap):
    """Prometheus text exposition (v0.0.4) of a :meth:`snapshot` dict —
    shared by the live registry and the CLI's offline re-render."""
    if snap.get("version") != 1:
        raise ValueError(
            f"unsupported snapshot version {snap.get('version')!r}")
    out = []
    for m in snap["metrics"]:
        name, typ = m["name"], m["type"]
        if typ not in _VALID_TYPES:
            raise ValueError(f"metric {name!r}: unknown type {typ!r}")
        if m.get("help"):
            out.append(f"# HELP {name} {m['help']}")
        out.append(f"# TYPE {name} {typ}")
        for s in m["series"]:
            labels = s.get("labels", {})
            if typ == "histogram":
                cum = 0
                for le, c in zip(list(m["buckets"]) + [math.inf],
                                 s["counts"]):
                    cum += c
                    out.append(
                        f"{name}_bucket"
                        f"{_fmt_labels(labels, [('le', _fmt_value(le))])}"
                        f" {cum}")
                out.append(f"{name}_sum{_fmt_labels(labels)} "
                           f"{_fmt_value(s['sum'])}")
                out.append(f"{name}_count{_fmt_labels(labels)} "
                           f"{s['count']}")
            else:
                out.append(f"{name}{_fmt_labels(labels)} "
                           f"{_fmt_value(s['value'])}")
    return "\n".join(out) + "\n"
