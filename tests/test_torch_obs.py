"""The port's observability tier (``paddle_tpu_torch.obs``) held against
``paddle_tpu.obs``, and the port's engine hooks against the reference
engine's.

Unit parity: the same synthetic event sequence, with explicit times, is
fed to both packages' registry, trace recorder, SLOs, flight recorder,
cost ledger, ``ServingObs``, dashboard and exporter; the results must be
EQUAL (exact: the same float operations in the same order). The
reference's ``ServingObs`` also registers the tensor-parallel collective
census, which comes with a later slice (ROADMAP A7): the comparisons take
the port's metric names and check that the reference's extra names are
exactly those.

Engine parity: the tiny Llama (f32, weights carried across with
``load_paddle_tpu_arrays``) on one ragged trace with a preemption, obs,
trace, SLOs and the flight recorder on, both packages' clocks patched to
one that the test advances between the halves of each step: streams,
``engine_stats()``, the registry, the health report, the flight records,
the Chrome trace and ``attribution()`` must be equal.
"""
import itertools
import json
import sys
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.obs as R
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import generation as ref_generation
from paddle_tpu.serving import Request as RefRequest
from paddle_tpu.serving import ServingEngine as RefEngine
import paddle_tpu_torch.obs as P
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.nlp.generation import speculative_generate
from paddle_tpu_torch.serving import Request, ServingEngine

# the reference's instruments that come with later slices of the port
_LATER = {"serving_collective_bytes_total", "serving_collective_count_total"}


def _restricted(ref_snap, port_snap):
    """The reference snapshot restricted to the port's metric names; the
    names left out must be exactly the later slices' instruments."""
    names = {m["name"] for m in port_snap["metrics"]}
    extra = {m["name"] for m in ref_snap["metrics"]} - names
    assert extra <= _LATER, extra
    return {"version": ref_snap["version"],
            "metrics": [m for m in ref_snap["metrics"] if m["name"] in names]}


# ------------------------------------------------ registry
def _registry_ops(mod):
    r = mod.MetricsRegistry()
    c = r.counter("reqs_total", "requests")
    c.inc()
    c.inc(2.5, route="a")
    c.inc(1, route='q"uote')
    c._set(7, route="b")
    g = r.gauge("depth", "queue depth")
    g.set(3)
    g.inc(-1.5, pool="draft")
    h = r.histogram("lat_seconds", "latency")
    for v in (0.00005, 0.0003, 0.02, 0.02, 3.0, 50.0):
        h.observe(v)
        h.observe(v * 2, kind="decode")
    h2 = r.histogram("sizes", "sizes", buckets=(1, 2, 4, 8))
    for v in (0, 1, 3, 9):
        h2.observe(v)
    r.counter("dropped_total", "reset below").inc(4)
    r.get("dropped_total").reset()
    return r


def test_registry_snapshot_and_prometheus_equal_reference():
    port, ref = _registry_ops(P), _registry_ops(R)
    assert port.snapshot() == ref.snapshot()
    assert port.snapshot_json() == ref.snapshot_json()
    assert port.prometheus() == ref.prometheus()
    snap = ref.snapshot()
    assert P.prometheus_from_snapshot(snap) == R.prometheus_from_snapshot(snap)
    hp, hr = port.get("lat_seconds"), ref.get("lat_seconds")
    for q in (0.0, 0.5, 0.95, 1.0):
        assert hp.quantile(q) == hr.quantile(q)
        assert hp.quantile(q, kind="decode") == hr.quantile(q, kind="decode")
    assert hp.bucket_counts() == hr.bucket_counts()
    assert port.names() == ref.names()
    port.reset()
    ref.reset()
    assert port.snapshot() == ref.snapshot()


@pytest.mark.parametrize("case", ["negative_inc", "kind_clash", "buckets",
                                  "inf_bucket", "version"])
def test_registry_refusals_equal_reference(case):
    def run(mod):
        r = mod.MetricsRegistry()
        r.counter("x")
        r.histogram("h", buckets=(1, 2))
        if case == "negative_inc":
            r.get("x").inc(-1)
        elif case == "kind_clash":
            r.gauge("x")
        elif case == "buckets":
            r.histogram("h", buckets=(1, 3))
        elif case == "inf_bucket":
            r.histogram("g", buckets=(1, float("inf")))
        else:
            mod.prometheus_from_snapshot({"version": 2, "metrics": []})

    errors = []
    for mod in (P, R):
        with pytest.raises(ValueError) as e:
            run(mod)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------ trace
def _trace_ops(mod):
    t = mod.TraceRecorder(max_events=6, epoch=10.0)
    t.thread_name(0, "engine")
    t.thread_name(0, "engine")
    t.instant("submit", 10.5, args={"req": "0"})
    t.complete("decode", 11.0, 11.25, tid=1, args={"tokens": 3})
    t.counter("occupancy", 11.25, {"live": 2, "free": 1})
    t.complete("mixed", 10.75, 11.0)
    t.instant("retire", 12.0, tid=2)
    t.instant("dropped", 13.0)
    return t


def test_chrome_trace_equal_reference(tmp_path):
    port, ref = _trace_ops(P), _trace_ops(R)
    pt, rt = port.chrome_trace(), ref.chrome_trace()
    assert pt["otherData"].pop("producer") == "paddle_tpu_torch.obs"
    rt["otherData"].pop("producer")
    assert pt == rt
    assert pt["otherData"]["dropped_events"] == 1
    path = port.save(tmp_path / "trace.json")
    loaded = P.load_chrome_trace(path)
    assert loaded["traceEvents"] == rt["traceEvents"]
    R.validate_chrome_trace(loaded)


@pytest.mark.parametrize("bad", [
    {"ph": "X", "name": "a", "pid": 1, "tid": 0, "ts": 0.0},
    {"ph": "Q", "name": "a", "pid": 1, "tid": 0, "ts": 0.0},
    {"ph": "i", "name": "a", "pid": 1, "tid": 0, "ts": -1.0},
    {"ph": "i", "name": "a", "pid": 1, "tid": 0, "ts": 1.0, "s": "z"},
    {"ph": "C", "pid": 1, "tid": 0, "ts": 1.0, "args": {}},
])
def test_chrome_trace_validation_equals_reference(bad):
    errors = []
    for mod in (P, R):
        with pytest.raises(ValueError) as e:
            mod.validate_chrome_trace({"traceEvents": [bad]})
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------ SLOs
_NOW = 5000.0
_SERIES = {
    "empty": {},
    "quiet": {"ttft_seconds": [(_NOW - 10.0, 0.1)] * 30},
    "warn": {"ttft_seconds": [(_NOW - 10.0, 0.1)] * 80
             + [(_NOW - 20.0, 2.0)] * 20},
    "critical": {"ttft_seconds": [(_NOW - 1.0, 9.0)] * 20,
                 "request_outcomes": [(_NOW - 2.0, 1.0)] * 5},
    "spike": {"ttft_seconds": [(_NOW - 4000.0, 0.1)] * 400
              + [(_NOW - 5.0, 3.0)] * 10},
    "skewed": {"e2e_latency_seconds": [(_NOW + 30.0, 99.0)] * 4,
               "inter_token_seconds": [(_NOW - 100.0, 0.5)] * 3},
}


@pytest.mark.parametrize("name", sorted(_SERIES))
@pytest.mark.parametrize("objectives", ["stock", "custom"])
def test_slo_reports_equal_reference(name, objectives):
    def slos(mod):
        if objectives == "stock":
            return mod.SLOSet()
        return mod.SLOSet([
            mod.SLO("ttft_p90", "ttft_seconds", threshold=1.0, target=0.9,
                    fast_window=60.0, slow_window=600.0, warn_burn=1.5,
                    critical_burn=5.0),
            mod.SLO("errors", "request_outcomes", target=0.95)])

    series = _SERIES[name]
    port = slos(P).evaluate(series, now=_NOW)
    assert port == slos(R).evaluate(series, now=_NOW)
    if name in ("critical", "empty"):
        assert port["state"] == ("critical" if name == "critical" else "ok")


def test_health_states_order_like_reference():
    for a, b in itertools.product(("ok", "warn", "critical"), repeat=2):
        assert (P.state_of(a) < b) == (R.state_of(a) < b)
        assert (P.state_of(a) >= b) == (R.state_of(a) >= b)
    assert str(P.worst_state(["ok", "critical", "warn"])) == "critical"
    assert str(P.worst_state([])) == "ok"
    for mod in (P, R):
        with pytest.raises(ValueError, match="unknown health state"):
            mod.state_of("degraded")


@pytest.mark.parametrize("kw", [
    dict(signal="queue_depth", threshold=1.0),
    dict(signal="ttft_seconds"),
    dict(signal="request_outcomes", threshold=1.0),
    dict(signal="ttft_seconds", threshold=1.0, target=1.0),
    dict(signal="ttft_seconds", threshold=1.0, fast_window=10.0,
         slow_window=5.0),
    dict(signal="ttft_seconds", threshold=1.0, warn_burn=5.0,
         critical_burn=2.0),
])
def test_slo_refusals_equal_reference(kw):
    errors = []
    for mod in (P, R):
        with pytest.raises(ValueError) as e:
            mod.SLO("s", **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------ flight recorder
def _flight_ops(mod, Req):
    rec = mod.FlightRecorder(slo=mod.SLOSet(), recompute_threshold=4,
                             max_live=3, max_events=6, max_anomalies=2)
    reqs = [Req(np.arange(1, 6), max_new_tokens=4, req_id=i,
                arrival_time=1.0 + i) for i in range(4)]
    for r in reqs:
        rec.on_submit(r, r.arrival_time)           # the 4th is dropped
    for i, r in enumerate(reqs[:3]):
        r.slot = i
        rec.on_admit(r, 4.0, queue_wait=4.0 - r.arrival_time,
                     blocks_reserved=3, pool_free_blocks=10 - i,
                     pool_blocks_in_use=i, cached_blocks=1, novel_blocks=2)
        rec.on_prefill_chunk(r, 4.5, 4, 4)
        rec.on_first_token(r, 5.0, 5.0 - r.arrival_time)
    rec.on_quantum_tokens(reqs[0], 5.5, 3)
    rec.on_preempt(reqs[1], 5.75, cached_tokens=6, tokens_emitted=1)
    reqs[1].preemptions += 1
    rec.on_resume(reqs[1], 6.0, slot=1, prefill_tokens=6)
    rec.on_spec_round(reqs[2], 6.25, proposed=4, accepted=2, emitted=3)
    for j in range(5):
        rec.on_quantum_tokens(reqs[2], 6.5 + j, 1)   # overflows max_events
    for r, reason in zip(reqs[:3], ("length", "eos", "length")):
        r.tokens = [7] * 4
        rec.on_retire(r, 9.0, ttft=(0.25 if r.req_id == 0 else 3.0),
                      e2e=9.0 - r.arrival_time, reason=reason)
    shed = Req(np.arange(1, 3), req_id="shed0", arrival_time=9.5)
    rec.on_submit(shed, 9.5)
    rec.on_shed(shed, 9.5, reason="backpressure")
    return rec


def test_flight_records_equal_reference(tmp_path):
    port, ref = _flight_ops(P, Request), _flight_ops(R, RefRequest)
    assert port.records() == ref.records()
    assert port.jsonl() == ref.jsonl()
    assert port.stats() == ref.stats()
    # requests 1 and 2 (TTFT past 0.5 s, request 1's recompute past 4)
    # and the shed one are captured; the buffer holds 2
    assert port.stats()["captured_total"] == 3
    assert port.stats()["dropped_anomalies"] == 1
    assert port.dropped_requests == 1
    path = port.save(tmp_path / "flight.jsonl")
    assert P.load_flight_records(path) == R.load_flight_records(path)
    first = port.records()[0]
    assert [ev["kind"] for ev in first["events"]] == [
        "submit", "admit", "prefill_chunk", "first_token", "preempt",
        "resume", "retire"]
    assert set(first["anomaly"]["signals"]) == {"ttft_seconds",
                                                "recomputed_tokens"}
    assert port.records()[1]["dropped_events"] == 4


@pytest.mark.parametrize("corrupt", ["not_list", "no_anomaly", "bad_kind",
                                     "unordered", "open_end", "no_submit"])
def test_flight_validation_equals_reference(corrupt):
    good = _flight_ops(R, RefRequest).records()[0]
    rec = json.loads(json.dumps(good))
    if corrupt == "not_list":
        rec = {"records": rec}
    elif corrupt == "no_anomaly":
        del rec["anomaly"]
    elif corrupt == "bad_kind":
        rec["events"][1]["kind"] = "teleport"
    elif corrupt == "unordered":
        rec["events"][2]["t"] = 0.0
    elif corrupt == "open_end":
        rec["events"].pop()
    else:
        rec["events"].pop(0)
    records = rec if corrupt == "not_list" else [rec]
    errors = []
    for mod in (P, R):
        with pytest.raises(ValueError) as e:
            mod.validate_flight_records(records)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------ cost ledger
def _ledger_ops(mod):
    led = mod.CostLedger(mod.MetricsRegistry()).configure(
        flops_per_token=mod.decode_flops_per_token(1000, 200),
        peak_flops=1e6)
    led.on_quantum("mixed", 0.0, 0.5, 3, breakdown={
        "prefill_emitted": 2, "decode_emitted": 1, "novel_tokens": 12,
        "recompute_tokens": 4, "decode_rows": 1}, window_rate=6.0)
    led.on_quantum("mixed", 0.5, 0.75, 0, breakdown={}, window_rate=6.0)
    led.on_cached_prefill(8)
    led.on_quantum("decode", 0.75, 1.0, 9, window_rate=20.0)
    led.on_quantum("spec_round", 1.0, 1.5, 5, window_rate=14.0)
    led.on_spec_round(8, 5)
    led.on_quantum("other", 1.5, 1.625, 1)
    return led


def test_cost_ledger_report_equals_reference():
    port, ref = _ledger_ops(P), _ledger_ops(R)
    rep = port.report()
    assert rep == ref.report()
    assert rep["emitted_total"] == 2 + 1 + 9 + 5
    assert rep["waste_tokens"] == {"preempt_recompute": 4,
                                   "spec_rejected": 3}
    assert rep["mfu"]["flops_per_token"] == 1600.0
    assert port.registry.snapshot() == ref.registry.snapshot()


# ------------------------------------------------ ServingObs hooks
class _Pool:
    """The pool surface ``ServingObs.on_step`` reads."""

    def __init__(self, in_use, prefix):
        self.blocks_in_use = in_use
        self.prefix_cache_enabled = prefix
        self.prefix_hits, self.prefix_misses = 3 * in_use, in_use
        self.cow_copies, self.prefix_aliases = 1, 2 * in_use

    def fragmentation_stats(self):
        return {"blocks_in_use": self.blocks_in_use,
                "free_blocks": 20 - self.blocks_in_use,
                "utilization": 0.75, "kv_dtype": "float32",
                "bytes_in_use": 4096 * self.blocks_in_use,
                "per_chip_bytes_in_use": 4096 * self.blocks_in_use,
                "cached_blocks": 2}


def _obs_ops(mod, Req, enabled=True):
    obs = mod.ServingObs(tracer=mod.TraceRecorder(epoch=0.0),
                         enabled=enabled, window_s=1.0)
    reqs = [Req(np.arange(1, 6), max_new_tokens=4, req_id=i,
                arrival_time=0.5 * i) for i in range(4)]
    pool, d_pool = _Pool(3, True), _Pool(2, False)
    for r in reqs:
        obs.on_submit(r)
    for i, r in enumerate(reqs[:3]):
        r.slot = i
        r.admit_time = 2.0
        obs.on_admit(r, 2.0)
    obs.on_cached_prefill(reqs[0], 8)
    obs.on_step(2.0, 3, 4, pool, d_pool)
    for r in reqs[:3]:
        r.first_token_time = 2.5
        obs.on_first_token(r, 2.5)
        r.tokens.append(5)
        obs.on_token(r)
    obs.on_quantum("mixed", 2.0, 2.5, 3, 3, breakdown={
        "prefill_emitted": 3, "decode_emitted": 0, "novel_tokens": 15,
        "recompute_tokens": 0, "decode_rows": 0})
    obs.on_preempt(reqs[2], 2.75, cached_tokens=6)
    reqs[2].preemptions = 1
    obs.on_resume(reqs[2], 3.0)
    pool.prefix_hits += 4
    obs.on_step(3.0, 3, 4, pool, d_pool)
    for j in range(3):
        for r in reqs[:2]:
            r.tokens.append(6)
            obs.on_token(r)
        obs.on_quantum("decode", 3.0 + j, 3.75 + j, 2, 2, device_s=0.5)
    obs.on_spec_round(6.0, 8, 6)
    obs.on_spec_round(6.0, 0, 0)
    obs.on_quantum("spec_round", 6.0, 6.25, 4, 2)
    for r, reason in zip(reqs[:3], ("length", "eos", "error")):
        r.finished, r.finish_reason, r.finish_time = True, reason, 7.0
        obs.on_retire(r, 7.0)
    obs.on_shed(reqs[3], 7.25)
    obs.on_drain(7.5, live=0, waiting=1)
    return obs


@pytest.mark.parametrize("enabled", [True, False])
def test_serving_obs_equals_reference(enabled):
    port = _obs_ops(P, Request, enabled)
    ref = _obs_ops(R, RefRequest, enabled)
    assert port.registry.snapshot() == _restricted(ref.registry.snapshot(),
                                                   port.registry.snapshot())
    assert port.timeseries() == ref.timeseries()
    assert port.ledger.report() == ref.ledger.report()
    assert dict(port.legacy_stats_view()) == dict(ref.legacy_stats_view())
    assert (port.tracer.chrome_trace()["traceEvents"]
            == ref.tracer.chrome_trace()["traceEvents"])
    if enabled:
        reg = port.registry
        assert reg.get("serving_tokens_emitted_total").value() == 9
        assert reg.get("serving_requests_preempted_total").value() == 1
        assert reg.get("serving_prefix_cache_hits_total").value(
            pool="target") == 13
        assert reg.get("serving_host_gap_fraction").value() == 1 / 3
        report = P.SLOSet().evaluate(port, now=8.0)
        assert report == R.SLOSet().evaluate(ref, now=8.0)
    else:
        assert port.tracer.chrome_trace()["traceEvents"] == []
    port.reset()
    ref.reset()
    assert port.timeseries() == ref.timeseries()


def test_dashboard_equals_reference():
    port, ref = _obs_ops(P, Request), _obs_ops(R, RefRequest)
    snap = ref.registry.snapshot()
    report = R.SLOSet().evaluate(ref, now=8.0)
    text = P.render_dashboard(port.registry.snapshot(), report)
    assert text == R.render_dashboard(snap, report)
    assert P.render_dashboard(snap, report) == text
    assert "[CRIT]" in text and "prefix[target]" in text
    assert P.render_dashboard({"version": 1, "metrics": []}) == \
        R.render_dashboard({"version": 1, "metrics": []})


# ------------------------------------------------ exporter
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.mark.parametrize("state", ["ok", "critical"])
def test_exporter_endpoints_equal_reference(state):
    # samples stamped in the future count in every window whatever the
    # evaluation's clock, so both exporters see the same report
    value = 9.0 if state == "critical" else 0.01
    series = {"ttft_seconds": [(1e12, value)] * 10}
    bodies = []
    for mod in (P, R):
        registry = _registry_ops(mod)
        flight = _flight_ops(mod, Request if mod is P else RefRequest)
        exp = mod.MetricsExporter(registry, slos=mod.SLOSet(), obs=series,
                                  flight=flight, host="127.0.0.1", port=0)
        with exp:
            got = {path: _get(exp.url(path)) for path in (
                "/metrics", "/healthz", "/slo", "/anomalies", "/nope")}
        slo = json.loads(got["/slo"][1])
        slo.pop("now")
        got["/slo"] = (got["/slo"][0], slo)
        bodies.append(got)
    assert bodies[0] == bodies[1]
    status, body = bodies[0]["/healthz"]
    assert status == (503 if state == "critical" else 200)
    assert json.loads(body)["state"] == state
    assert bodies[0]["/metrics"][1].startswith("# HELP depth")


# ------------------------------------------------ engine parity
@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLM(RefConfig.tiny(tensor_parallel=False))
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                            device="cpu")
    load_paddle_tpu_arrays(
        port, {k: v.numpy() for k, v in ref.state_dict().items()})
    return ref, port


class _Clock:
    """The obs clock both engines read; the test advances it."""
    t = 100.0

    @classmethod
    def now(cls):
        return cls.t


def _drive(engine, prompts, max_new, stop_tok):
    """Submit the ragged trace, preempt request 0 after its second token,
    and run to the end; the clock moves 0.125 s across each dispatch and
    0.25 s between steps."""
    reqs = [engine.submit(p, max_new_tokens=mn,
                          stop_token_ids=[stop_tok] if i == 4 else None)
            for i, (p, mn) in enumerate(zip(prompts, max_new))]
    _Clock.t += 0.25
    preempted = False
    while engine.has_work:
        pending = engine.step_dispatch()
        _Clock.t += 0.125
        engine.step_collect(pending)
        _Clock.t += 0.25
        if not preempted and len(reqs[0].tokens) >= 2:
            engine.preempt(reqs[0])
            preempted = True
    return reqs


@pytest.fixture(scope="module")
def traced(models):
    ref_model, port_model = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    max_new = [6, 4, 8, 5, 7]
    kw = dict(num_slots=3, block_size=4, prefill_chunk=4, decode_quantum=3,
              slo=True, flight=True)
    probe = ServingEngine(port_model, device="cpu", **kw)
    probe_reqs = [probe.submit(p, max_new_tokens=mn)
                  for p, mn in zip(prompts, max_new)]
    probe.run()
    stop_tok = probe_reqs[4].tokens[2]
    out = {}
    patch = pytest.MonkeyPatch()
    try:
        for name, mod, engine_cls, model, extra in (
                ("ref", R, RefEngine, ref_model, {}),
                ("port", P, ServingEngine, port_model, {"device": "cpu"})):
            patch.setattr(mod.ServingObs, "now", staticmethod(_Clock.now))
            _Clock.t = 100.0
            obs = mod.ServingObs(tracer=mod.TraceRecorder(epoch=100.0))
            engine = engine_cls(model, obs=obs, **kw, **extra)
            reqs = _drive(engine, prompts, max_new, stop_tok)
            out[name] = (engine, reqs, engine.health(now=_Clock.t))
        # the obs="off" arm: streams equal, the legacy counters count
        off = ServingEngine(port_model, obs="off", device="cpu", **kw)
        out["off"] = (off, _drive(off, prompts, max_new, stop_tok), None)
    finally:
        patch.undo()
    return out


def test_engine_streams_and_stats_equal_reference(traced):
    ref_engine, ref_reqs, _ = traced["ref"]
    port_engine, port_reqs, _ = traced["port"]
    off_engine, off_reqs, _ = traced["off"]
    for r, p, o in zip(ref_reqs, port_reqs, off_reqs):
        assert p.tokens == r.tokens == o.tokens
        assert p.finish_reason == r.finish_reason
    assert port_reqs[0].preemptions == 1
    assert port_reqs[4].finish_reason == "stop"
    ref_st = ref_engine.engine_stats()
    port_st = port_engine.engine_stats()
    for key, value in port_st.items():
        assert value == ref_st[key], key
    assert off_engine.engine_stats() == port_st
    assert off_engine.obs.registry.get(
        "serving_tokens_emitted_total").value() == 0


def test_engine_registry_equals_reference(traced):
    ref_snap = traced["ref"][0].obs.registry.snapshot()
    port_snap = traced["port"][0].obs.registry.snapshot()
    assert port_snap == _restricted(ref_snap, port_snap)
    reg = traced["port"][0].obs.registry
    emitted = sum(len(r.tokens) for r in traced["port"][1])
    assert reg.get("serving_tokens_emitted_total").value() == emitted
    assert reg.get("serving_ttft_seconds").count() == 5
    assert reg.get("serving_requests_resumed_total").value() == 1
    assert reg.get("serving_quantum_seconds").count(kind="decode") == \
        traced["port"][0].stats["decode_quanta"]


def test_engine_health_flight_trace_equal_reference(traced):
    ref_engine, _, ref_health = traced["ref"]
    port_engine, port_reqs, port_health = traced["port"]
    assert port_health == ref_health
    assert port_health["resilience"]["faults"]["journal_len"] == 0
    assert port_health["state"] in ("ok", "warn", "critical")
    assert port_engine.flight.records() == ref_engine.flight.records()
    assert port_engine.flight.stats() == ref_engine.flight.stats()
    kinds = {r["req_id"]: [e["kind"] for e in r["events"]]
             for r in port_engine.flight.records()}
    rid = str(port_reqs[0].req_id)
    if rid in kinds:
        assert "preempt" in kinds[rid] and "resume" in kinds[rid]
    pt = port_engine.obs.tracer.chrome_trace()
    rt = ref_engine.obs.tracer.chrome_trace()
    assert pt["traceEvents"] == rt["traceEvents"]
    P.validate_chrome_trace(pt)


def test_engine_attribution_equals_reference(traced):
    port_engine = traced["port"][0]
    rep = port_engine.attribution()
    assert rep == traced["ref"][0].attribution()
    raw = rep["raw_counters"]
    assert sum(rep["emitted_tokens"].values()) == \
        raw["serving_tokens_emitted_total"]
    work = rep["prefill_work_tokens"]
    assert work["novel"] + work["recompute"] == \
        raw["serving_prefill_tokens_total"]
    assert work["recompute"] > 0
    assert rep["mfu"]["peak_flops_per_chip"] == 0.0


class _Tick:
    """A clock that moves 0.125 s at every reading: both engines must
    read it at the same boundaries for their timings to agree. The
    resilience envelope (``_guarded_dispatch``) reads it once a dispatch
    for its watchdog; that reading does not move it."""
    t = 100.0

    @classmethod
    def now(cls):
        if sys._getframe(1).f_code.co_name != "_guarded_dispatch":
            cls.t += 0.125
        return cls.t


def test_speculative_generate_records_into_obs(models):
    """``speculative_generate(obs=)`` on the reference's and the port's
    speculative engines, same weights, both obs clocks patched to one
    ticking clock: the streams, the acceptance rate, the registry, the
    Chrome trace and the ledger's report are equal, and the emitted
    tokens conserve."""
    ref_target, port_target = models
    paddle.seed(11)
    ref_draft = RefLM(RefConfig.tiny(tensor_parallel=False,
                                     num_hidden_layers=1))
    ref_draft.eval()
    port_draft = LlamaForCausalLM(
        LlamaConfig.tiny(tensor_parallel=False, num_hidden_layers=1),
        device="cpu")
    load_paddle_tpu_arrays(
        port_draft, {k: v.numpy() for k, v in ref_draft.state_dict().items()})
    ids = np.random.RandomState(3).randint(1, 128, (2, 6))
    runs = {}
    patch = pytest.MonkeyPatch()
    try:
        for name, mod, gen, target, draft in (
                ("ref", R, ref_generation.speculative_generate, ref_target,
                 ref_draft),
                ("port", P, speculative_generate, port_target, port_draft)):
            patch.setattr(mod.ServingObs, "now", staticmethod(_Tick.now))
            _Tick.t = 100.0
            obs = mod.ServingObs(tracer=mod.TraceRecorder(epoch=100.0))
            out, rate = gen(target, draft, ids, max_new_tokens=7, gamma=2,
                            block_size=4, obs=obs)
            runs[name] = (np.asarray(out), rate, obs)
    finally:
        patch.undo()
    (ref_out, ref_rate, ref_obs), (out, rate, obs) = runs["ref"], runs["port"]
    assert out.shape == (2, 13)
    np.testing.assert_array_equal(out, ref_out)
    assert rate == ref_rate
    port_snap = obs.registry.snapshot()
    assert port_snap == _restricted(ref_obs.registry.snapshot(), port_snap)
    assert obs.tracer.chrome_trace()["traceEvents"] == \
        ref_obs.tracer.chrome_trace()["traceEvents"]
    assert obs.ledger.report() == ref_obs.ledger.report()
    reg = obs.registry
    rounds = reg.get("serving_spec_rounds_total").value()
    assert rounds > 0
    assert reg.get("serving_quantum_seconds").count(kind="spec_round") == \
        rounds
    assert reg.get("serving_tokens_emitted_total").value() == 14
    proposed = reg.get("serving_spec_proposed_total").value()
    accepted = reg.get("serving_spec_accepted_total").value()
    assert accepted / proposed == rate
    assert obs.ledger.waste_tokens()["spec_rejected"] == proposed - accepted
    assert sum(obs.ledger.emitted_tokens().values()) == 14
    P.validate_chrome_trace(obs.tracer.chrome_trace())
