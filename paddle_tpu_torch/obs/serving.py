"""Serving-engine instrumentation of the port (counterpart of
``paddle_tpu/obs/serving.py``). Every hook runs ON THE HOST at a
scheduler boundary (submit / admit, the mixed step, the decode dispatch
or speculative round, retire) on values the engine already holds on the
host: no hook reads a tensor, synchronizes the card or enters the
captured quantum, so a decode dispatch keeps its one host sync with
observability on.

:class:`ServingObs` owns a :class:`~paddle_tpu_torch.obs.registry.
MetricsRegistry` (counters, gauges and histograms are dict operations)
and an optional :class:`~paddle_tpu_torch.obs.trace.TraceRecorder`
(per-request spans on per-slot tracks, dispatch spans and counter tracks
on the engine track). The engine's ``stats`` is :class:`_LegacyStatsView`,
a MutableMapping over the same registry counters, with the keys, types
and order it always had.

Exported metrics:

- counters: ``serving_requests_{submitted,admitted,finished}_total``,
  ``serving_tokens_emitted_total`` (one bump per token appended to a
  stream), the front door's ``serving_requests_{shed,preempted,
  resumed}_total`` / ``serving_tokens_recomputed_total`` /
  ``serving_drains_total``, the prefix cache's
  ``serving_prefix_cache_{hits,misses,cow_copies,shared_blocks}_total``
  ``{pool=target|draft}`` (carried from the pool's counters at step
  boundaries), and the legacy ``serving_*_total`` counters behind
  ``engine.stats``;
- histograms: ``serving_queue_wait_seconds``, ``serving_ttft_seconds``
  (once per request), ``serving_e2e_latency_seconds``,
  ``serving_inter_token_seconds`` (per-request mean at retirement),
  ``serving_quantum_seconds{kind=decode|spec_round|mixed}``;
- gauges: ``serving_tokens_per_second_window``,
  ``serving_host_gap_fraction``, ``serving_spec_acceptance_rate``,
  ``serving_slots_occupied``, ``serving_pool_{blocks_in_use,free_blocks,
  utilization}{pool}``, ``serving_pool_{bytes,per_chip_bytes}{pool,
  kv_dtype}``, ``serving_prefix_cache_cached_block_fraction{pool}``;
- the cost ledger (:mod:`~paddle_tpu_torch.obs.attribution`, owned as
  ``obs.ledger``), fed from the same boundaries;
- host ring-buffer series (:meth:`timeseries`): ``tokens_per_s``,
  ``spec_acceptance_rate``, and the per-request samples the SLO windows
  read: ``ttft_seconds``, ``e2e_latency_seconds``,
  ``inter_token_seconds`` and ``request_outcomes`` (1.0 a shed or error
  outcome, 0.0 eos / stop / length).

The resilience tier's instruments: ``serving_faults_injected_total{site,
kind}``, ``serving_quantum_retries_total{kind}``,
``serving_watchdog_trips_total{kind}``, ``serving_degraded_mode{mode}``,
``serving_degrades_total{mode}``, ``serving_pool_rebuilds_total``,
``serving_quarantines_total{kind}`` and ``serving_restores_total``, fed by
the engine at its step boundaries. The reference's collective census comes
with tensor parallelism (ROADMAP A7).
"""
from __future__ import annotations

import time
from collections import deque
from collections.abc import MutableMapping

from .attribution import CostLedger
from .registry import LATENCY_BUCKETS, MetricsRegistry
from .trace import TraceRecorder

__all__ = ["ServingObs"]

# legacy ServingEngine.stats key -> registry counter name, in the
# historical dict order (engine_stats()'s shape is part of the API)
_LEGACY_KEYS = {
    "steps": "serving_steps_total",
    "mixed_steps": "serving_mixed_steps_total",
    "decode_quanta": "serving_decode_quanta_total",
    "quantum_tokens": "serving_quantum_tokens_total",
    "prefill_tokens": "serving_prefill_tokens_total",
    "generated_tokens": "serving_generated_tokens_total",
    "occupancy_sum": "serving_occupancy_sum",
    "spec_rounds": "serving_spec_rounds_total",
    "spec_proposed": "serving_spec_proposed_total",
    "spec_accepted": "serving_spec_accepted_total",
}
_FLOAT_KEYS = ("occupancy_sum",)


class _LegacyStatsView(MutableMapping):
    """``engine.stats`` compatibility: same keys, same int/float types,
    same iteration order — but every read/write goes through the
    registry counters, so there is exactly ONE source of truth."""

    def __init__(self, counters):
        self._counters = counters  # legacy key -> Counter

    def __getitem__(self, key):
        v = self._counters[key].value()
        return v if key in _FLOAT_KEYS else int(v)

    def __setitem__(self, key, value):
        self._counters[key]._set(value)

    def __delitem__(self, key):
        raise TypeError("engine.stats has a fixed key set")

    def __iter__(self):
        return iter(self._counters)

    def __len__(self):
        return len(self._counters)

    def __repr__(self):
        return repr(dict(self))


class ServingObs:
    """Metrics + tracing sink for one :class:`ServingEngine`.

    Args:
        registry: share a registry across engines (default: fresh).
        trace: record Chrome trace events (bounded buffer; off by
            default — the metrics registry alone is always on).
        tracer: bring your own :class:`TraceRecorder` (wins over
            ``trace``).
        enabled: ``False`` short-circuits every rich hook (histograms,
            gauges, tracer, time series) — the ``obs="off"`` arm of the
            ``serving_obs_overhead`` bench; the legacy stats counters
            keep working either way.
        window_s: trailing window for the tokens/s gauge.
    """

    def __init__(self, registry=None, trace=False, tracer=None,
                 enabled=True, window_s=1.0, series_maxlen=4096):
        self.enabled = bool(enabled)
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer if tracer is not None \
            else (TraceRecorder() if trace else None)
        self.window_s = float(window_s)
        r = self.registry
        self._legacy = {
            key: r.counter(name, f"legacy engine.stats[{key!r}]")
            for key, name in _LEGACY_KEYS.items()
        }
        self._c_submitted = r.counter(
            "serving_requests_submitted_total", "requests queued")
        self._c_admitted = r.counter(
            "serving_requests_admitted_total", "requests given a slot")
        self._c_finished = r.counter(
            "serving_requests_finished_total", "requests retired")
        self._c_tokens = r.counter(
            "serving_tokens_emitted_total",
            "tokens appended to request streams")
        self._h_queue = r.histogram(
            "serving_queue_wait_seconds", "submit -> admit",
            buckets=LATENCY_BUCKETS)
        self._h_ttft = r.histogram(
            "serving_ttft_seconds",
            "submit -> first generated token (once per request)",
            buckets=LATENCY_BUCKETS)
        self._h_e2e = r.histogram(
            "serving_e2e_latency_seconds", "submit -> retirement",
            buckets=LATENCY_BUCKETS)
        self._h_itl = r.histogram(
            "serving_inter_token_seconds",
            "per-request mean inter-token latency at retirement",
            buckets=LATENCY_BUCKETS)
        self._h_quantum = r.histogram(
            "serving_quantum_seconds",
            "one dispatch: mixed step / decode quantum / spec round",
            buckets=LATENCY_BUCKETS)
        self._g_rate = r.gauge(
            "serving_tokens_per_second_window",
            "generated tok/s over the trailing window")
        self._g_hostgap = r.gauge(
            "serving_host_gap_fraction",
            "host wall minus device wall over quantum wall at the "
            "decode dispatch boundary (the multi-quantum driver's "
            "headline: collapses as K grows)")
        self._g_accept = r.gauge(
            "serving_spec_acceptance_rate",
            "per-round accepted/proposed")
        self._g_slots = r.gauge(
            "serving_slots_occupied", "live slots this step")
        self._g_blocks = r.gauge(
            "serving_pool_blocks_in_use", "KV pool blocks allocated")
        self._g_free = r.gauge(
            "serving_pool_free_blocks", "KV pool free-list length")
        self._g_util = r.gauge(
            "serving_pool_utilization",
            "live tokens / allocated token capacity")
        # dtype-aware residency: actual bytes the allocated blocks pin
        # (pool itemsize x elements + the int8 pools' f32 scale rows),
        # labeled by the pool's kv dtype so a dashboard shows the int8
        # residency win directly against a float engine's line
        self._g_bytes = r.gauge(
            "serving_pool_bytes",
            "bytes pinned by allocated KV blocks (incl. scale pools), "
            "by pool and kv_dtype")
        self._g_chip_bytes = r.gauge(
            "serving_pool_per_chip_bytes",
            "per-chip bytes pinned by allocated KV blocks under TP")
        self._c_shed = r.counter(
            "serving_requests_shed_total",
            "requests refused by load shedding")
        # the front door's overload counters (serving/frontend.py):
        # preempt/resume pair up over a run, drains count graceful
        # stop-the-front-door events, recomputed tokens are the KV a
        # preemption dropped (re-prefilled on resume — the recompute-
        # on-resume debt)
        self._c_preempted = r.counter(
            "serving_requests_preempted_total",
            "live requests evicted under pool pressure")
        self._c_resumed = r.counter(
            "serving_requests_resumed_total",
            "preempted requests re-admitted (recompute-on-resume)")
        self._c_recomputed = r.counter(
            "serving_tokens_recomputed_total",
            "cached tokens dropped by preemption (re-prefilled on "
            "resume)")
        self._c_drains = r.counter(
            "serving_drains_total", "graceful drains started")
        # content-addressed prefix cache (engine prefix_cache=True):
        # the pool keeps monotonic counters on its hot path; on_step
        # carries their deltas into the registry, so the metrics cost
        # nothing inside the allocator
        self._c_pc_hits = r.counter(
            "serving_prefix_cache_hits_total",
            "full prompt blocks served from the prefix index")
        self._c_pc_misses = r.counter(
            "serving_prefix_cache_misses_total",
            "full prompt blocks that had to be prefilled")
        self._c_pc_cow = r.counter(
            "serving_prefix_cache_cow_copies_total",
            "copy-on-write copies (first write into a shared block)")
        self._c_pc_shared = r.counter(
            "serving_prefix_cache_shared_blocks_total",
            "block aliases the prefix index created at admission")
        self._g_pc_frac = r.gauge(
            "serving_prefix_cache_cached_block_fraction",
            "index-held blocks / blocks in use")
        # the resilience tier: injected faults, dispatch retries, watchdog
        # overruns, the degraded modes and quarantines, restores, all
        # reported by the engine at its step boundaries
        self._c_faults = r.counter(
            "serving_faults_injected_total",
            "faults the seeded injector fired, by site/kind")
        self._c_retries = r.counter(
            "serving_quantum_retries_total",
            "quantum dispatches retried after an injected fault")
        self._c_watchdog = r.counter(
            "serving_watchdog_trips_total",
            "quantum dispatches that overran the p99-derived deadline")
        self._g_degraded = r.gauge(
            "serving_degraded_mode",
            "1 while a degraded mode is active, by mode "
            "(spec_disabled|pool_rebuild)")
        self._c_degrades = r.counter(
            "serving_degrades_total",
            "degradation-ladder activations, by mode")
        self._c_pool_rebuilds = r.counter(
            "serving_pool_rebuilds_total",
            "pool accounting rebuilt from live block tables")
        self._c_quarantines = r.counter(
            "serving_quarantines_total",
            "poison requests error-finished / prefix subtrees dropped, "
            "by kind")
        self._c_restores = r.counter(
            "serving_restores_total",
            "engines rebuilt from a snapshot (crash recovery)")
        # (pool identity, counter attr) -> last value synced; keyed by
        # id() so engines sharing one registry don't cross-credit, and
        # kept OUT of reset() so a registry reset restarts the counters
        # from zero without replaying the pool's full history
        self._pc_marks = {}
        # per-token cost ledger (obs/attribution.py): phase-attributed
        # tokens/walls + useful-fraction / prefix-savings / MFU gauges,
        # fed from the SAME boundaries below — no new host callbacks,
        # and disabled with the rest of the rich hooks (obs="off")
        self.ledger = CostLedger(r)
        self._window = deque()
        self._cum_tokens = 0
        self._series = {
            "tokens_per_s": deque(maxlen=series_maxlen),
            "spec_acceptance_rate": deque(maxlen=series_maxlen),
            # per-request samples the SLO burn-rate windows read
            "ttft_seconds": deque(maxlen=series_maxlen),
            "e2e_latency_seconds": deque(maxlen=series_maxlen),
            "inter_token_seconds": deque(maxlen=series_maxlen),
            "request_outcomes": deque(maxlen=series_maxlen),
        }

    # the engine's single clock (the old code had six scattered
    # ``now = time.perf_counter()`` blocks)
    @staticmethod
    def now():
        return time.perf_counter()

    def legacy_stats_view(self):
        return _LegacyStatsView(self._legacy)

    def timeseries(self):
        """{"tokens_per_s": [(t, v), ...], "spec_acceptance_rate":
        [...], "ttft_seconds": [...], "e2e_latency_seconds": [...],
        "inter_token_seconds": [...], "request_outcomes": [...]} —
        host ring buffers for offline plotting and the SLO layer's
        burn-rate windows (obs/slo.py)."""
        return {k: list(v) for k, v in self._series.items()}

    def reset(self):
        """Return every surface to its initial state between bench
        warmup and timed phases: registry series
        (:meth:`MetricsRegistry.reset` — counters, gauges AND
        histograms), the throughput window, and the ring-buffer time
        series. Replaces the old per-key zeroing through
        ``engine.stats``."""
        self.registry.reset()
        self._window.clear()
        self._cum_tokens = 0
        for s in self._series.values():
            s.clear()

    # -- request lifecycle hooks -------------------------------------------
    def on_submit(self, req):
        if not self.enabled:
            return
        self._c_submitted.inc()
        if self.tracer is not None:
            self.tracer.thread_name(0, "engine")
            self.tracer.instant("submit", req.arrival_time, tid=0,
                                args={"req": str(req.req_id)})

    def on_admit(self, req, now):
        if not self.enabled:
            return
        self._c_admitted.inc()
        self._h_queue.observe(now - req.arrival_time)
        if self.tracer is not None:
            tid = req.slot + 1
            self.tracer.thread_name(tid, f"slot{req.slot}")
            self.tracer.instant("admit", now, tid=tid,
                                args={"req": str(req.req_id)})

    def on_first_token(self, req, now):
        """TTFT — the caller stamps ``first_token_time`` exactly once
        (at the prefill-completion step), so this observes once per
        request by construction."""
        if not self.enabled:
            return
        ttft = now - req.arrival_time
        self._h_ttft.observe(ttft)
        self._series["ttft_seconds"].append((now, ttft))
        if self.tracer is not None:
            self.tracer.instant("first_token", now, tid=req.slot + 1,
                                args={"req": str(req.req_id)})

    def on_token(self, req):
        """One token actually appended to a request's stream."""
        if self.enabled:
            self._c_tokens.inc()

    def on_retire(self, req, now):
        if not self.enabled:
            return
        self._c_finished.inc()
        e2e = now - req.arrival_time
        self._h_e2e.observe(e2e)
        self._series["e2e_latency_seconds"].append((now, e2e))
        # outcome sample for the error/shed-rate SLO: eos/stop/length
        # are the good endings, anything else is a bad one
        self._series["request_outcomes"].append(
            (now, 0.0 if req.finish_reason in ("eos", "stop", "length")
             else 1.0))
        n = len(req.tokens)
        if req.first_token_time is not None and n >= 2:
            itl = (req.finish_time - req.first_token_time) / (n - 1)
            self._h_itl.observe(itl)
            self._series["inter_token_seconds"].append((now, itl))
        if self.tracer is not None and req.slot is not None:
            self.tracer.complete(
                f"req {req.req_id}", req.admit_time or now, now,
                tid=req.slot + 1,
                args={"tokens": n, "reason": req.finish_reason,
                      "prompt_len": req.prompt_len})

    def on_shed(self, req, now):
        """A request refused admission by a load-shedding policy (the
        front door's SLO-driven admission, serving/policy.py): counted,
        and recorded as a BAD outcome sample so the error/shed-rate
        objective burns budget for it."""
        if not self.enabled:
            return
        self._c_shed.inc()
        self._series["request_outcomes"].append((now, 1.0))
        if self.tracer is not None:
            self.tracer.instant("shed", now, tid=0,
                                args={"req": str(req.req_id)})

    def on_preempt(self, req, now, cached_tokens=0):
        """A live request evicted under pool pressure: its
        ``cached_tokens`` of KV go back to the pool and become
        recompute debt (re-prefilled when it resumes)."""
        if not self.enabled:
            return
        self._c_preempted.inc()
        self._c_recomputed.inc(int(cached_tokens))
        if self.tracer is not None:
            tid = 0 if req.slot is None else req.slot + 1
            self.tracer.instant("preempt", now, tid=tid,
                                args={"req": str(req.req_id),
                                      "cached_tokens": int(
                                          cached_tokens)})

    def on_resume(self, req, now):
        """A preempted request re-admitted to a slot (the resume half
        of the preempt/resume pair; TTFT and queue-wait were observed
        on the FIRST admission, so neither re-observes here)."""
        if not self.enabled:
            return
        self._c_resumed.inc()
        if self.tracer is not None:
            tid = 0 if req.slot is None else req.slot + 1
            self.tracer.instant("resume", now, tid=tid,
                                args={"req": str(req.req_id),
                                      "preemptions": int(
                                          req.preemptions)})

    def on_drain(self, now, live=0, waiting=0):
        """The front door stopped admitting (graceful drain): counted;
        in-flight work finishes and the flight recorder flushes."""
        if not self.enabled:
            return
        self._c_drains.inc()
        if self.tracer is not None:
            self.tracer.instant("drain", now, tid=0,
                                args={"live": int(live),
                                      "waiting": int(waiting)})

    # -- step / dispatch hooks ---------------------------------------------
    def on_step(self, now, live, num_slots, pool, d_pool=None):
        """Per-scheduler-iteration gauges (slot occupancy + pool
        health); also feeds the trace's counter tracks."""
        if not self.enabled:
            return
        self._g_slots.set(live)
        pools = [("target", pool)]
        if d_pool is not None:
            pools.append(("draft", d_pool))
        for label, p in pools:
            st = p.fragmentation_stats()
            self._g_blocks.set(st["blocks_in_use"], pool=label)
            self._g_free.set(st["free_blocks"], pool=label)
            self._g_util.set(st["utilization"], pool=label)
            kv_dtype = st.get("kv_dtype", "float")
            self._g_bytes.set(float(st.get("bytes_in_use", 0)),
                              pool=label, kv_dtype=kv_dtype)
            self._g_chip_bytes.set(
                float(st.get("per_chip_bytes_in_use", 0)),
                pool=label, kv_dtype=kv_dtype)
            if getattr(p, "prefix_cache_enabled", False):
                self._sync_prefix(label, p, st)
        if self.tracer is not None:
            self.tracer.counter(
                "occupancy", now,
                {"live_slots": live, "free_slots": num_slots - live})
            self.tracer.counter(
                "pool_blocks", now,
                {label: p.blocks_in_use for label, p in pools})

    def _sync_prefix(self, label, pool, st):
        """Carry one pool's monotonic prefix-cache counters into the
        registry as DELTAS since the last step, and refresh the
        cached-block-fraction gauge."""
        for attr, c in (("prefix_hits", self._c_pc_hits),
                        ("prefix_misses", self._c_pc_misses),
                        ("cow_copies", self._c_pc_cow),
                        ("prefix_aliases", self._c_pc_shared)):
            v = getattr(pool, attr)
            key = (id(pool), attr)
            delta = v - self._pc_marks.get(key, 0)
            if delta:
                c.inc(delta, pool=label)
            self._pc_marks[key] = v
        in_use = st["blocks_in_use"]
        self._g_pc_frac.set(
            (st["cached_blocks"] / in_use) if in_use else 0.0,
            pool=label)

    def on_quantum(self, kind, t0, t1, tokens, rows, breakdown=None,
                   device_s=None):
        """One dispatch boundary: ``kind`` is ``mixed`` (chunked
        prefill + decode rows through block_mha), ``decode`` (the
        captured quantum) or ``spec_round``; ``tokens`` is how many
        tokens the dispatch appended to request streams. A mixed step
        passes ``breakdown`` (prefill/decode emission split + novel vs
        recompute work tokens) for the cost ledger's phase
        attribution. ``device_s`` (decode quanta) is the host clock from
        the dispatch's return to its collect's sync (the reference's
        definition: no CUDA event is recorded for it) and refreshes the
        ``serving_host_gap_fraction`` gauge."""
        if not self.enabled:
            return
        wall = t1 - t0
        if device_s is not None and wall > 0.0:
            self._g_hostgap.set(max(wall - device_s, 0.0) / wall)
        self._h_quantum.observe(t1 - t0, kind=kind)
        self._cum_tokens += int(tokens)
        self._window.append((t1, self._cum_tokens))
        while len(self._window) > 2 \
                and t1 - self._window[0][0] > self.window_s:
            self._window.popleft()
        t_old, c_old = self._window[0]
        if t1 > t_old:
            rate = (self._cum_tokens - c_old) / (t1 - t_old)
            self._g_rate.set(rate)
            self._series["tokens_per_s"].append((t1, rate))
        self.ledger.on_quantum(kind, t0, t1, tokens,
                               breakdown=breakdown,
                               window_rate=self._g_rate.value())
        if self.tracer is not None:
            self.tracer.complete(kind, t0, t1, tid=0,
                                 args={"tokens": int(tokens),
                                       "rows": int(rows)})
            self.tracer.counter("tokens_per_s", t1,
                                {"window": self._g_rate.value()})

    def on_spec_round(self, now, proposed, accepted):
        if not self.enabled or proposed <= 0:
            return
        self.ledger.on_spec_round(proposed, accepted)
        rate = accepted / proposed
        self._g_accept.set(rate)
        self._series["spec_acceptance_rate"].append((now, rate))

    # -- resilience hooks --------------------------------------------------
    def on_fault(self, site, kind):
        """One injected fault fired (carried from the injector's journal at
        the step boundary; the injector never touches the registry)."""
        if self.enabled:
            self._c_faults.inc(site=site, kind=kind)

    def on_retry(self, kind, attempt):
        """One dispatch retried after an injected fault (``attempt`` is
        1-based; only the count is exported)."""
        if self.enabled:
            self._c_retries.inc(kind=kind)

    def on_watchdog(self, kind, elapsed):
        """One dispatch overran its watchdog deadline (detection only: it
        already returned)."""
        if not self.enabled:
            return
        self._c_watchdog.inc(kind=kind)
        if self.tracer is not None:
            self.tracer.instant("watchdog_trip", self.now(), tid=0,
                                args={"kind": kind,
                                      "elapsed_s": float(elapsed)})

    def on_degrade(self, mode, now):
        """A degraded mode came on (``spec_disabled`` | ``pool_rebuild``):
        its gauge latches 1 and the activation counter counts; a pool
        rebuild also counts in its own counter."""
        if not self.enabled:
            return
        self._g_degraded.set(1.0, mode=mode)
        self._c_degrades.inc(mode=mode)
        if mode == "pool_rebuild":
            self._c_pool_rebuilds.inc()
        if self.tracer is not None:
            self.tracer.instant("degrade", now, tid=0, args={"mode": mode})

    def on_quarantine(self, now, what, count=1):
        """``what="poison"``: a poisoned request was isolated and finished
        with an error. ``what="prefix"``: cached prefix entries dropped
        after a checksum mismatch."""
        if not self.enabled:
            return
        self._c_quarantines.inc(int(count), kind=what)
        if self.tracer is not None:
            self.tracer.instant("quarantine", now, tid=0,
                                args={"kind": what, "count": int(count)})

    def on_restore(self, now, inflight):
        """An engine was rebuilt from a snapshot, re-admitting
        ``inflight`` requests through recompute-on-resume."""
        if not self.enabled:
            return
        self._c_restores.inc()
        if self.tracer is not None:
            self.tracer.instant("restore", now, tid=0,
                                args={"inflight": int(inflight)})

    def on_cached_prefill(self, req, tokens):
        """Prompt tokens an admission skipped via a prefix-cache alias
        — the savings side of the ledger's prefill work split (fires
        at the existing ``_admit`` boundary)."""
        if not self.enabled:
            return
        self.ledger.on_cached_prefill(tokens)
