"""Per-request flight recorder (counterpart of ``paddle_tpu/obs/flight.py``):
a bounded journal of every lifecycle event a request passes through on
the host (submit, admit with its pool context, prefill chunks, first
token, decode-quantum yields, speculative rounds, preempt / resume,
shed, retire), with DUMP-ON-ANOMALY: when a retiring request's TTFT or
end-to-end latency crosses its SLO threshold, or its preemptions
re-computed more cached tokens than ``recompute_threshold``, the whole
journal is captured into a bounded anomaly buffer, exportable as
schema-validated JSON lines.

One event is a dict append into a bounded per-request list; the live
table and the anomaly buffer are bounded too, and every drop is
counted. ``EVENT_KINDS`` keeps the reference's whole schema (the fault,
route and hand-off kinds of the resilience and cluster tiers among
them), so records of either package validate against either's
:func:`validate_flight_records`.
"""
from __future__ import annotations

import json

__all__ = ["FlightRecorder", "validate_flight_records",
           "load_flight_records", "EVENT_KINDS"]

EVENT_KINDS = ("submit", "admit", "prefill_chunk", "first_token",
               "decode_quantum", "spec_round", "preempt", "resume",
               "shed", "retire", "fault", "retry", "degrade", "restore",
               "route", "handoff")

_ANOMALY_SIGNALS = ("ttft_seconds", "e2e_latency_seconds")


class FlightRecorder:
    """Bounded per-request journals + the anomaly dump buffer.

    Args:
        slo: an :class:`~paddle_tpu_torch.obs.slo.SLOSet` (or anything with
            ``threshold(signal)``) the dump triggers are read from —
            the tightest declared ``ttft_seconds`` /
            ``e2e_latency_seconds`` thresholds.
        ttft_threshold / e2e_threshold: explicit trigger overrides in
            seconds (win over ``slo``); with neither an SLO nor an
            override for a signal, that signal never triggers a dump.
        recompute_threshold: dump when a retiring request's journaled
            preemptions re-computed MORE than this many cached tokens
            (the recompute-waste spike the cost ledger's
            useful-token-fraction gauge prices; obs/attribution.py).
            ``None`` (default) never triggers; the count is summed
            from the journal's own ``preempt`` events, so no new
            engine plumbing is involved.
        max_live: journal table capacity — requests submitted past it
            ride unjournaled (``dropped_requests`` counts them).
        max_events: per-request journal bound (overflow counted in the
            journal's ``dropped_events``).
        max_anomalies: anomaly buffer bound (``dropped_anomalies``
            counts captures that found it full).
    """

    def __init__(self, slo=None, ttft_threshold=None, e2e_threshold=None,
                 recompute_threshold=None, max_live=1024,
                 max_events=256, max_anomalies=64):
        def _trigger(explicit, signal):
            if explicit is not None:
                return float(explicit)
            if slo is not None and hasattr(slo, "threshold"):
                return slo.threshold(signal)
            return None

        self.ttft_threshold = _trigger(ttft_threshold, "ttft_seconds")
        self.e2e_threshold = _trigger(e2e_threshold,
                                      "e2e_latency_seconds")
        self.recompute_threshold = (None if recompute_threshold is None
                                    else float(recompute_threshold))
        self.max_live = int(max_live)
        self.max_events = int(max_events)
        self.max_anomalies = int(max_anomalies)
        self._live = {}          # req_id -> journal dict
        self.anomalies = []      # captured journals, bounded
        self.dropped_requests = 0
        self.dropped_anomalies = 0
        self.retired_total = 0
        self.captured_total = 0

    def __len__(self):
        return len(self._live)

    @property
    def live_count(self):
        return len(self._live)

    # -- journaling --------------------------------------------------------
    def _event(self, req, kind, t, _force=False, **fields):
        j = self._live.get(str(req.req_id))
        if j is None:
            return  # unjournaled (table overflow) or unknown request
        if not _force and len(j["events"]) >= self.max_events:
            j["dropped_events"] += 1
            return  # terminal events (_force) always land, so a
        ev = {"t": float(t), "kind": kind}  # captured journal stays
        ev.update(fields)                   # schema-valid (ends at
        j["events"].append(ev)              # retire/shed)

    def on_submit(self, req, t):
        rid = str(req.req_id)
        if rid not in self._live and len(self._live) >= self.max_live:
            self.dropped_requests += 1
            return
        self._live[rid] = {
            "req_id": rid,
            "prompt_len": int(req.prompt_len),
            "max_new_tokens": int(req.max_new_tokens),
            "events": [],
            "dropped_events": 0,
        }
        self._event(req, "submit", t)

    def on_admit(self, req, t, queue_wait=None, blocks_reserved=None,
                 pool_free_blocks=None, pool_blocks_in_use=None,
                 cached_blocks=None, novel_blocks=None):
        """``cached_blocks`` / ``novel_blocks`` split the admission's
        block demand between prefix-cache aliases (no prefill compute,
        no fresh residency) and blocks it must still populate."""
        self._event(req, "admit", t, slot=int(req.slot),
                    queue_wait_s=queue_wait,
                    blocks_reserved=blocks_reserved,
                    pool_free_blocks=pool_free_blocks,
                    pool_blocks_in_use=pool_blocks_in_use,
                    cached_blocks=cached_blocks,
                    novel_blocks=novel_blocks)

    def on_prefill_chunk(self, req, t, tokens, pos):
        """``tokens`` prompt tokens entered the pool this mixed step;
        ``pos`` is the prefill cursor AFTER the chunk."""
        self._event(req, "prefill_chunk", t, tokens=int(tokens),
                    pos=int(pos))

    def on_first_token(self, req, t, ttft):
        self._event(req, "first_token", t, ttft_s=float(ttft))

    def on_quantum_tokens(self, req, t, tokens):
        """Tokens this request gained from one decode quantum."""
        self._event(req, "decode_quantum", t, tokens=int(tokens))

    def on_spec_round(self, req, t, proposed, accepted, emitted):
        """One speculative round's per-request outcome: ``proposed``
        draft tokens, ``accepted`` of them, ``emitted`` appended to the
        stream (acceptance prefix + bonus, capped by eos/max-new)."""
        self._event(req, "spec_round", t, proposed=int(proposed),
                    accepted=int(accepted), emitted=int(emitted))

    def on_preempt(self, req, t, cached_tokens=0, tokens_emitted=0):
        """The request lost its slot under pool pressure: its cached KV
        (``cached_tokens``) went back to the pool and will be
        re-prefilled on resume; the emitted stream is untouched."""
        self._event(req, "preempt", t, cached_tokens=int(cached_tokens),
                    tokens_emitted=int(tokens_emitted))

    def on_resume(self, req, t, slot=None, prefill_tokens=0):
        """The preempted request re-admitted: ``prefill_tokens`` =
        prompt + emitted tokens to re-prefill before the stream
        continues."""
        self._event(req, "resume", t,
                    slot=(None if slot is None else int(slot)),
                    prefill_tokens=int(prefill_tokens),
                    preemptions=int(req.preemptions))

    def on_shed(self, req, t, reason="shed"):
        """A request refused admission by a load-shedding policy: its
        (short) journal is always worth keeping — shedding IS an
        anomaly — so it captures unconditionally."""
        self._event(req, "shed", t, _force=True, reason=str(reason))
        self._finish(req, {"shed": {"value": 1.0, "threshold": 0.0}},
                     reason=str(reason), t=t, tokens=0)

    # -- retirement + anomaly capture --------------------------------------
    def on_retire(self, req, t, ttft=None, e2e=None, reason=None):
        """Journal the retirement, then apply the dump rule: if the
        request's TTFT or e2e crossed its threshold, capture the full
        journal into the anomaly buffer; either way the live entry is
        released."""
        self.retired_total += 1
        self._event(req, "retire", t, _force=True, ttft_s=ttft,
                    e2e_s=e2e, reason=reason, tokens=len(req.tokens))
        signals = {}
        if (self.ttft_threshold is not None and ttft is not None
                and ttft > self.ttft_threshold):
            signals["ttft_seconds"] = {
                "value": float(ttft), "threshold": self.ttft_threshold}
        if (self.e2e_threshold is not None and e2e is not None
                and e2e > self.e2e_threshold):
            signals["e2e_latency_seconds"] = {
                "value": float(e2e), "threshold": self.e2e_threshold}
        if self.recompute_threshold is not None:
            j = self._live.get(str(req.req_id))
            recomputed = sum(
                ev.get("cached_tokens", 0) for ev in j["events"]
                if ev["kind"] == "preempt") if j else 0
            if recomputed > self.recompute_threshold:
                signals["recomputed_tokens"] = {
                    "value": float(recomputed),
                    "threshold": self.recompute_threshold}
        if signals:
            self._finish(req, signals, reason=reason, t=t,
                         tokens=len(req.tokens))
        else:
            self._live.pop(str(req.req_id), None)

    def _finish(self, req, signals, reason, t, tokens):
        j = self._live.pop(str(req.req_id), None)
        if j is None:
            return  # was unjournaled; nothing to capture
        j["anomaly"] = {"t": float(t), "signals": signals,
                        "reason": reason, "tokens": int(tokens)}
        self.captured_total += 1
        if len(self.anomalies) >= self.max_anomalies:
            self.dropped_anomalies += 1
            return
        self.anomalies.append(j)

    # -- export ------------------------------------------------------------
    def stats(self):
        return {
            "live": len(self._live),
            "anomalies": len(self.anomalies),
            "captured_total": self.captured_total,
            "retired_total": self.retired_total,
            "dropped_requests": self.dropped_requests,
            "dropped_anomalies": self.dropped_anomalies,
            "ttft_threshold": self.ttft_threshold,
            "e2e_threshold": self.e2e_threshold,
            "recompute_threshold": self.recompute_threshold,
        }

    def records(self):
        """The captured anomaly records (schema-validated copies)."""
        return validate_flight_records(
            [json.loads(json.dumps(j)) for j in self.anomalies])

    def jsonl(self):
        """One JSON object per line — streams and concatenates."""
        return "".join(json.dumps(j, sort_keys=True) + "\n"
                       for j in self.records())

    def save(self, path):
        with open(path, "w") as f:
            f.write(self.jsonl())
        return path


def _expect(cond, ctx, msg):
    if not cond:
        raise ValueError(f"{ctx}: {msg}")


def validate_flight_records(records):
    """Schema check for anomaly dumps — the JSONL counterpart of
    ``validate_chrome_trace``; raises ValueError naming the first
    offending record/field. Returns ``records``."""
    _expect(isinstance(records, list), "flight records",
            f"expected a list of records, got {type(records).__name__}")
    for i, rec in enumerate(records):
        ctx = f"records[{i}]"
        _expect(isinstance(rec, dict), ctx, "record must be a dict")
        for k in ("req_id", "prompt_len", "max_new_tokens", "events",
                  "dropped_events", "anomaly"):
            _expect(k in rec, ctx, f"missing {k!r}")
        _expect(isinstance(rec["req_id"], str), ctx,
                "req_id must be a string")
        _expect(isinstance(rec["dropped_events"], int)
                and rec["dropped_events"] >= 0, ctx,
                "dropped_events must be a non-negative int")
        an = rec["anomaly"]
        _expect(isinstance(an, dict) and an.get("signals"), ctx,
                "anomaly.signals must be a non-empty dict")
        for sig, d in an["signals"].items():
            sctx = f"{ctx}.anomaly.signals[{sig!r}]"
            _expect(isinstance(d, dict), sctx, "must be a dict")
            for k in ("value", "threshold"):
                _expect(isinstance(d.get(k), (int, float)), sctx,
                        f"{k} must be a number")
        evs = rec["events"]
        _expect(isinstance(evs, list) and evs, ctx,
                "events must be a non-empty list")
        last_t = None
        for jn, ev in enumerate(evs):
            ectx = f"{ctx}.events[{jn}]"
            _expect(isinstance(ev, dict), ectx, "event must be a dict")
            _expect(ev.get("kind") in EVENT_KINDS, ectx,
                    f"kind must be one of {EVENT_KINDS}, got "
                    f"{ev.get('kind')!r}")
            _expect(isinstance(ev.get("t"), (int, float)), ectx,
                    "t must be a number")
            _expect(last_t is None or ev["t"] >= last_t, ectx,
                    "events must be time-ordered")
            last_t = ev["t"]
        _expect(evs[0]["kind"] == "submit", ctx,
                "journal must start at submit")
        _expect(evs[-1]["kind"] in ("retire", "shed"), ctx,
                "journal must end at retire/shed")
    return records


def load_flight_records(path):
    """Load + validate a saved JSONL dump; returns the record list."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return validate_flight_records(records)
