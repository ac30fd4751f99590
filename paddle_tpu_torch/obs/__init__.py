"""Runtime observability of the port's serving tier (counterpart of
``paddle_tpu/obs``): the metrics registry, request tracing, SLO health,
the flight recorder, cost attribution and the live exporter, all on the
host at the engine's scheduler boundaries.

- :mod:`.registry`: :class:`MetricsRegistry` (counters, gauges,
  fixed-bucket histograms), a stable JSON snapshot and Prometheus text;
- :mod:`.trace`: :class:`TraceRecorder`, a bounded Chrome trace-event
  buffer; ``validate_chrome_trace`` / ``load_chrome_trace``;
- :mod:`.serving`: :class:`ServingObs`, the engine's hooks and the legacy
  ``engine.stats`` view;
- :mod:`.slo`: :class:`SLO` objectives with multi-window burn rates and
  the ordered health states ``OK < WARN < CRITICAL``;
- :mod:`.flight`: :class:`FlightRecorder`, per-request journals dumped on
  anomaly to validated JSONL;
- :mod:`.attribution`: :class:`CostLedger`, tokens and dispatch walls by
  phase, with its conservation invariants;
- :mod:`.export`: :class:`MetricsExporter` (``/metrics``, ``/healthz``,
  ``/slo``, ``/snapshot``, ``/anomalies`` on a local port) and
  :func:`render_dashboard`.

No hook reads a tensor or synchronizes the card: a decode dispatch keeps
its one host sync with everything on. ``InstrumentedTrainStep`` (ROADMAP
A6), ``ClusterExporter`` and the ``obs`` command line (A5, second half)
come later: they raise.
"""
from .registry import (  # noqa: F401
    Counter, Gauge, Histogram, LATENCY_BUCKETS, MetricsRegistry,
    prometheus_from_snapshot,
)
from .trace import (  # noqa: F401
    TraceRecorder, load_chrome_trace, validate_chrome_trace,
)
from .serving import ServingObs  # noqa: F401
from .slo import (  # noqa: F401
    CRITICAL, OK, WARN, HealthState, SLO, SLOSet,
    default_serving_slos, state_of, worst_state,
)
from .flight import (  # noqa: F401
    FlightRecorder, load_flight_records, validate_flight_records,
)
from .attribution import (  # noqa: F401
    CostLedger, decode_flops_per_token,
)
from .export import MetricsExporter, render_dashboard  # noqa: F401
from .._later import not_ported

ClusterExporter = not_ported("ClusterExporter", "A5, second half")
InstrumentedTrainStep = not_ported("InstrumentedTrainStep", "A6")

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS",
    "MetricsRegistry", "prometheus_from_snapshot",
    "TraceRecorder", "load_chrome_trace", "validate_chrome_trace",
    "ServingObs",
    "HealthState", "OK", "WARN", "CRITICAL", "state_of", "worst_state",
    "SLO", "SLOSet", "default_serving_slos",
    "FlightRecorder", "validate_flight_records", "load_flight_records",
    "CostLedger", "decode_flops_per_token",
    "MetricsExporter", "render_dashboard",
    "ClusterExporter", "InstrumentedTrainStep",
]
