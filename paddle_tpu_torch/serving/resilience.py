"""Watchdog and retry / quarantine policy of the serving engine
(counterpart of ``paddle_tpu/serving/resilience.py``). Host-side policy
only: nothing here enters a captured graph.

- :class:`QuantumWatchdog`: a wall-clock deadline per dispatch kind from
  the engine's own dispatch-seconds distribution: p99 x
  ``deadline_margin``, once ``min_samples`` observations are in, floored at
  ``min_deadline_s``. It owns a PRIVATE
  :class:`~paddle_tpu_torch.obs.registry.Histogram`, so it works under
  ``obs="off"`` and never double-counts ``serving_quantum_seconds``. It
  detects only: an overrun trips after the dispatch returned and feeds the
  trip counter and the speculative fallback. The engine times the host
  wall of a dispatch (the injector's check, the staging, the enqueue of
  the replays), as the reference times its asynchronous JAX dispatch, and
  divides it by the dispatch's quanta.
- :class:`ResiliencePolicy`: the knobs: the retry budget and exponential
  backoff of :class:`~paddle_tpu_torch.serving.faults.InjectedFault`
  retries, the watchdog's margin, floor and warm-up, and the
  ``spec_fault_threshold`` of speculative-round faults after which the
  engine falls back to the plain quantum for good. ``sleep`` is injectable
  so tests check backoff schedules without waiting.
"""
from __future__ import annotations

import time

from ..obs.registry import Histogram

__all__ = ["ResiliencePolicy", "QuantumWatchdog"]


class ResiliencePolicy:
    """Knobs of the engine's fault handling (``resilience=True`` builds
    the stock policy).

    Args:
        max_retries: injected-fault retries per dispatch before the engine
            escalates (poison: bisect quarantine; transient: skip the step,
            the next step retries).
        backoff_base_s / backoff_mult: retry i sleeps ``base * mult**i``.
        deadline_margin: watchdog deadline = p99 x margin.
        min_deadline_s: floor under the p99-derived deadline.
        min_samples: observations per kind before the watchdog arms.
        spec_fault_threshold: speculative-round faults or trips before the
            engine falls back to the plain quantum.
        sleep: the backoff's stall (tests pass a stub).
    """

    def __init__(self, max_retries=3, backoff_base_s=0.01,
                 backoff_mult=2.0, deadline_margin=20.0,
                 min_deadline_s=0.25, min_samples=16,
                 spec_fault_threshold=3, sleep=time.sleep):
        if max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if spec_fault_threshold < 1:
            raise ValueError("spec_fault_threshold must be >= 1")
        self.max_retries = int(max_retries)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_mult = float(backoff_mult)
        self.deadline_margin = float(deadline_margin)
        self.min_deadline_s = float(min_deadline_s)
        self.min_samples = int(min_samples)
        self.spec_fault_threshold = int(spec_fault_threshold)
        self.sleep = sleep

    def backoff_s(self, attempt):
        """Stall before retry ``attempt`` (0-based)."""
        return self.backoff_base_s * (self.backoff_mult ** attempt)


class QuantumWatchdog:
    """Wall-clock overrun detection per dispatch kind, calibrated from
    the engine's own latency distribution."""

    def __init__(self, policy=None):
        self.policy = policy if policy is not None else ResiliencePolicy()
        self._hist = Histogram("watchdog_quantum_seconds")
        self.trips_total = 0
        self.trips = {}  # kind -> count

    def observe(self, kind, dt):
        self._hist.observe(float(dt), kind=str(kind))

    def deadline(self, kind):
        """The deadline of ``kind`` in seconds, or None while fewer than
        ``min_samples`` observations are in."""
        if self._hist.count(kind=str(kind)) < self.policy.min_samples:
            return None
        p99 = self._hist.quantile(0.99, kind=str(kind))
        if p99 is None:
            return None
        return max(p99 * self.policy.deadline_margin,
                   self.policy.min_deadline_s)

    def check(self, kind, elapsed):
        """Record ``elapsed``, then test it against the deadline that held
        BEFORE this observation; True on a trip."""
        limit = self.deadline(kind)
        self.observe(kind, elapsed)
        if limit is not None and elapsed > limit:
            self.trips_total += 1
            self.trips[kind] = self.trips.get(kind, 0) + 1
            return True
        return False

    def stats(self):
        return {"trips_total": self.trips_total,
                "trips": dict(self.trips)}
