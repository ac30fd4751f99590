"""Serving SLOs with multi-window burn rates (counterpart of
``paddle_tpu/obs/slo.py``).

An :class:`SLO` states an objective over one serving signal: a latency
(``ttft_seconds``, ``e2e_latency_seconds``, ``inter_token_seconds``:
"``target`` of requests under ``threshold`` seconds") or the outcome
rate (``request_outcomes``: 1.0 a bad outcome, shed or error, 0.0 a
good one). With error budget ``1 - target`` the burn rate is
``bad_fraction / budget``. Each objective is evaluated over two trailing
windows (fast, default 5 min; slow, default 1 h) of the per-request
samples :meth:`~paddle_tpu_torch.obs.serving.ServingObs.timeseries`
keeps on the host, and its state escalates only when BOTH windows burn
past a gate: ``CRITICAL`` at ``critical_burn``, ``WARN`` at
``warn_burn``. States are ordered ``OK < WARN < CRITICAL``
(:class:`HealthState`); an :class:`SLOSet` reports the worst, as the
dict the exporter's ``/healthz`` and ``/slo`` serve and the front
door's shedding admission
(:class:`~paddle_tpu_torch.serving.FrontDoorPolicy`) reads.

An empty window burns nothing (no traffic is not an outage), and a
sample stamped in the future counts as "now" in every window.
"""
from __future__ import annotations

import time

__all__ = [
    "HealthState", "OK", "WARN", "CRITICAL", "state_of", "worst_state",
    "SLO", "SLOSet", "default_serving_slos",
    "LATENCY_SIGNALS", "RATE_SIGNALS",
]

# signal name == the ServingObs sample-series key it evaluates
LATENCY_SIGNALS = ("ttft_seconds", "e2e_latency_seconds",
                   "inter_token_seconds")
RATE_SIGNALS = ("request_outcomes",)


class HealthState:
    """One of the ordered health states ``OK < WARN < CRITICAL``.

    Compares against other states or their lowercase string names, so
    report consumers can write ``state >= "warn"`` without importing
    the singletons; ``str()`` is the JSON form."""

    __slots__ = ("name", "rank")

    def __init__(self, name, rank):
        self.name = str(name)
        self.rank = int(rank)

    @staticmethod
    def _rank_of(other):
        if isinstance(other, HealthState):
            return other.rank
        if isinstance(other, str):
            return state_of(other).rank
        return None

    def __eq__(self, other):
        r = self._rank_of(other)
        return NotImplemented if r is None else self.rank == r

    def __lt__(self, other):
        r = self._rank_of(other)
        return NotImplemented if r is None else self.rank < r

    def __le__(self, other):
        r = self._rank_of(other)
        return NotImplemented if r is None else self.rank <= r

    def __gt__(self, other):
        r = self._rank_of(other)
        return NotImplemented if r is None else self.rank > r

    def __ge__(self, other):
        r = self._rank_of(other)
        return NotImplemented if r is None else self.rank >= r

    def __hash__(self):
        return hash(self.rank)

    def __str__(self):
        return self.name

    def __repr__(self):
        return self.name


OK = HealthState("ok", 0)
WARN = HealthState("warn", 1)
CRITICAL = HealthState("critical", 2)
_STATES = {s.name: s for s in (OK, WARN, CRITICAL)}


def state_of(name):
    """Parse a state name back to its :class:`HealthState` singleton
    (the inverse of the report's ``str()`` form)."""
    if isinstance(name, HealthState):
        return name
    try:
        return _STATES[str(name).lower()]
    except KeyError:
        raise ValueError(
            f"unknown health state {name!r}; expected one of "
            f"{sorted(_STATES)}")


def worst_state(states):
    """The max of an iterable of states/names; OK when empty."""
    out = OK
    for s in states:
        s = state_of(s)
        if s > out:
            out = s
    return out


class SLO:
    """One declarative objective over one serving signal.

    Args:
        name: report key (e.g. ``ttft_p95``); unique within a set.
        signal: sample series to evaluate — one of
            :data:`LATENCY_SIGNALS` or :data:`RATE_SIGNALS`.
        threshold: latency objectives only — the per-request bound in
            seconds; a sample above it is "bad".
        target: fraction of requests that must be good (0.95 == "p95
            under threshold"); the error budget is ``1 - target``.
        fast_window / slow_window: trailing evaluation windows in
            seconds (SRE defaults: 5 min / 1 h).
        warn_burn / critical_burn: burn-rate gates; BOTH windows must
            exceed a gate for the state to escalate.
    """

    def __init__(self, name, signal, threshold=None, target=0.95,
                 fast_window=300.0, slow_window=3600.0,
                 warn_burn=3.0, critical_burn=10.0):
        self.name = str(name)
        self.signal = str(signal)
        if self.signal not in LATENCY_SIGNALS + RATE_SIGNALS:
            raise ValueError(
                f"SLO {name!r}: unknown signal {signal!r}; expected one "
                f"of {LATENCY_SIGNALS + RATE_SIGNALS}")
        self.is_rate = self.signal in RATE_SIGNALS
        if self.is_rate:
            if threshold is not None:
                raise ValueError(
                    f"SLO {name!r}: rate signal {signal!r} takes no "
                    f"threshold (the series already records good/bad)")
            self.threshold = None
        else:
            if threshold is None or float(threshold) <= 0:
                raise ValueError(
                    f"SLO {name!r}: latency signal {signal!r} needs a "
                    f"positive threshold in seconds, got {threshold!r}")
            self.threshold = float(threshold)
        self.target = float(target)
        if not 0.0 < self.target < 1.0:
            raise ValueError(
                f"SLO {name!r}: target must be in (0, 1), got {target}")
        self.budget = 1.0 - self.target
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        if not 0.0 < self.fast_window < self.slow_window:
            raise ValueError(
                f"SLO {name!r}: need 0 < fast_window < slow_window, got "
                f"{fast_window} / {slow_window}")
        self.warn_burn = float(warn_burn)
        self.critical_burn = float(critical_burn)
        if not 0.0 < self.warn_burn <= self.critical_burn:
            raise ValueError(
                f"SLO {name!r}: need 0 < warn_burn <= critical_burn, "
                f"got {warn_burn} / {critical_burn}")

    def _is_bad(self, value):
        if self.is_rate:
            return float(value) >= 0.5  # outcome series: 1.0 == bad
        return float(value) > self.threshold

    def window_stats(self, samples, now, window):
        """(n, bad, bad_fraction, burn_rate) over one trailing window
        of ``(t, value)`` samples. A sample stamped in the FUTURE
        (clock skew across threads/hosts) has its age clamped to 0 so
        it counts in every window rather than silently vanishing; an
        empty window burns nothing."""
        n = bad = 0
        for t, v in samples:
            age = now - float(t)
            if age < 0.0:
                age = 0.0
            if age <= window:
                n += 1
                if self._is_bad(v):
                    bad += 1
        frac = (bad / n) if n else 0.0
        return {
            "window_s": window, "n": n, "bad": bad,
            "bad_fraction": frac, "burn_rate": frac / self.budget,
        }

    def evaluate(self, series, now=None):
        """Burn-rate report for this objective over a series dict
        (``{signal: [(t, value), ...]}`` — live
        :meth:`ServingObs.timeseries` output or a saved snapshot's
        lists). ``now`` defaults to the obs clock
        (``time.perf_counter``); pass the snapshot's stamp when
        evaluating offline."""
        if now is None:
            now = time.perf_counter()
        samples = series.get(self.signal, ())
        fast = self.window_stats(samples, now, self.fast_window)
        slow = self.window_stats(samples, now, self.slow_window)
        if (fast["burn_rate"] >= self.critical_burn
                and slow["burn_rate"] >= self.critical_burn):
            state = CRITICAL
        elif (fast["burn_rate"] >= self.warn_burn
                and slow["burn_rate"] >= self.warn_burn):
            state = WARN
        else:
            state = OK
        return {
            "name": self.name, "signal": self.signal,
            "state": str(state), "threshold": self.threshold,
            "target": self.target, "budget": self.budget,
            "warn_burn": self.warn_burn,
            "critical_burn": self.critical_burn,
            "windows": {"fast": fast, "slow": slow},
        }


class SLOSet:
    """An ordered set of objectives evaluated together; overall health
    is the WORST per-objective state. ``None`` builds
    :func:`default_serving_slos`."""

    def __init__(self, slos=None):
        self.slos = list(default_serving_slos() if slos is None
                         else slos)
        seen = set()
        for s in self.slos:
            if not isinstance(s, SLO):
                raise TypeError(f"SLOSet takes SLO instances, got {s!r}")
            if s.name in seen:
                raise ValueError(f"duplicate SLO name {s.name!r}")
            seen.add(s.name)

    def __iter__(self):
        return iter(self.slos)

    def __len__(self):
        return len(self.slos)

    def threshold(self, signal):
        """Tightest latency threshold declared for ``signal`` (None if
        no objective covers it) — the flight recorder's anomaly rule
        reads its dump triggers from here."""
        ts = [s.threshold for s in self.slos
              if s.signal == signal and s.threshold is not None]
        return min(ts) if ts else None

    def evaluate(self, source, now=None):
        """The machine-readable health report the exporter serves and
        the front door's shedding admission polls. ``source`` is a
        ServingObs (or
        anything with ``timeseries()``) or a plain series dict."""
        series = (source.timeseries() if hasattr(source, "timeseries")
                  else source)
        if now is None:
            now = time.perf_counter()
        objectives = [s.evaluate(series, now) for s in self.slos]
        state = worst_state(o["state"] for o in objectives)
        return {
            "version": 1,
            "state": str(state),
            "now": float(now),
            "objectives": objectives,
        }


def default_serving_slos(ttft_p95_s=0.5, inter_token_p99_s=0.1,
                         e2e_p99_s=30.0, error_budget=0.01, **kw):
    """The stock serving objective set: p95 TTFT, p99 inter-token, p99
    e2e latency, and a 99%-good outcome (error/shed) rate. Extra
    keyword args (windows, burn gates) forward to every
    :class:`SLO`."""
    return [
        SLO("ttft_p95", "ttft_seconds", threshold=ttft_p95_s,
            target=0.95, **kw),
        SLO("inter_token_p99", "inter_token_seconds",
            threshold=inter_token_p99_s, target=0.99, **kw),
        SLO("e2e_p99", "e2e_latency_seconds", threshold=e2e_p99_s,
            target=0.99, **kw),
        SLO("error_rate", "request_outcomes",
            target=1.0 - float(error_budget), **kw),
    ]
