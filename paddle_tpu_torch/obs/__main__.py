"""The port's observability command line (counterpart of
``python -m paddle_tpu.obs``)::

    python -m paddle_tpu_torch.obs snapshot --in metrics.json [--format prom]
    python -m paddle_tpu_torch.obs snapshot --demo [--format prom|json]
    python -m paddle_tpu_torch.obs export --demo --out trace.json \\
        [--metrics-out metrics.json] [--spec]
    python -m paddle_tpu_torch.obs export --in trace.json      # validate
    python -m paddle_tpu_torch.obs serve --demo [--port 9100] [--duration S]
    python -m paddle_tpu_torch.obs slo --demo [--out series.json]
    python -m paddle_tpu_torch.obs slo --in series.json [--fail-on critical]
    python -m paddle_tpu_torch.obs watch --url http://127.0.0.1:9100
    python -m paddle_tpu_torch.obs watch --in metrics.json [--slo-in rep.json]
    python -m paddle_tpu_torch.obs check [--device cuda|cpu]

``snapshot`` renders a metrics snapshot (live from the ``--demo`` engine,
or from a saved ``--in`` JSON dump) as Prometheus text or stable-sorted
JSON. ``export`` writes or validates a Chrome trace-event JSON; with
``--demo`` it drives the demo serving engine (``--spec``: the speculative
round). ``serve`` runs the live HTTP exporter over the demo engine; ``slo``
evaluates the burn-rate health report (``--fail-on warn|critical`` turns
the state into an exit code); ``watch`` renders the terminal dashboard.

``check`` is the CI gate: the SLO, front-door, prefix-cache, int8,
attribution, resilience (a bounded seeded chaos soak) and cluster smokes,
each asserting that the instrumentation recorded what the forced events
must produce and that the streams equal their oracles; exit 1 on any
failure. The reference's graph audit of its compiled recipes
(``--recipe``) comes with the analysis tier (ROADMAP A8), its tensor-
parallel recipe with multi-device serving (A7): they raise.

``--device`` (default ``cuda``; no fallback to the CPU) places every demo
and smoke engine. The demo and smoke model is the reference's
``LlamaConfig.tiny`` with seeded weights; on CUDA its head dim is widened
from 16 to 64 (hidden 256), the narrowest the card's attention kernels take
(ROADMAP A10), and on the CPU it is the reference's configuration exactly.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .._later import not_ported

_DEVICE = "cuda"


def _config(**overrides):
    """The demo and smoke configuration on the chosen device."""
    from ..nlp import LlamaConfig

    if _DEVICE != "cpu":
        overrides.setdefault("hidden_size", 256)
    return LlamaConfig.tiny(tensor_parallel=False, **overrides)


def _model(cfg, seed):
    """A seeded causal LM of ``cfg`` on the chosen device."""
    import torch

    from .._device import resolve_device
    from ..nlp import LlamaForCausalLM

    dev = resolve_device(_DEVICE)
    return LlamaForCausalLM(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))


def _demo_models(spec=False):
    """The demo target (seed 0) and, with ``spec``, its 1-layer draft
    (seed 7)."""
    target = _model(_config(), 0)
    draft = _model(_config(num_hidden_layers=1), 7) if spec else None
    return target, draft


def _demo_engine(spec=False, trace=True, slo=None, flight=None):
    """A small serving run with full instrumentation: a handful of ragged
    requests through prefill and decode (and the speculative round),
    enough to fill every serving metric and trace track."""
    import numpy as np

    from ..serving import ServingEngine

    model, draft = _demo_models(spec)
    kw = dict(spec_draft=draft, spec_gamma=2) if spec else {}
    engine = ServingEngine(model, num_slots=3, block_size=4,
                           prefill_chunk=4, decode_quantum=3,
                           trace=trace, slo=slo, flight=flight,
                           device=_DEVICE, **kw)
    rng = np.random.RandomState(0)
    for n, mn in ((5, 6), (9, 4), (3, 8), (12, 5)):
        engine.submit(rng.randint(1, model.config.vocab_size, n)
                      .astype(np.int32), max_new_tokens=mn)
    engine.run()
    return engine


def _cmd_snapshot(args):
    from .registry import prometheus_from_snapshot

    if args.demo:
        snap = _demo_engine(spec=args.spec,
                            trace=False).obs.registry.snapshot()
    elif args.infile:
        with open(args.infile) as f:
            snap = json.load(f)
    else:
        print("snapshot: need --demo or --in FILE", file=sys.stderr)
        return 2
    text = (prometheus_from_snapshot(snap) if args.format == "prom"
            else json.dumps(snap, indent=2, sort_keys=True) + "\n")
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        sys.stdout.write(text)
    return 0


def _cmd_export(args):
    from .trace import load_chrome_trace

    if args.demo:
        if not args.out:
            print("export --demo: need --out FILE", file=sys.stderr)
            return 2
        engine = _demo_engine(spec=args.spec, trace=True)
        engine.obs.tracer.save(args.out)
        n = len(engine.obs.tracer.events)
        print(f"wrote {args.out}: {n} trace events "
              f"({engine.obs.tracer.dropped} dropped)", file=sys.stderr)
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                f.write(engine.obs.registry.snapshot_json(indent=2))
            print(f"wrote {args.metrics_out}", file=sys.stderr)
        return 0
    if args.infile:
        obj = load_chrome_trace(args.infile)
        print(f"{args.infile}: valid chrome trace, "
              f"{len(obj['traceEvents'])} events", file=sys.stderr)
        return 0
    print("export: need --demo or --in FILE", file=sys.stderr)
    return 2


def _cmd_serve(args):
    """The live exporter over the demo engine: run it, point a browser,
    curl or Prometheus at the printed URLs."""
    from .export import MetricsExporter

    engine = _demo_engine(spec=args.spec, trace=False, slo=True,
                          flight=True)
    exporter = MetricsExporter.for_engine(
        engine, host=args.host, port=args.port).start()
    for route in exporter.routes():
        print(f"serving {exporter.url(route)}", file=sys.stderr)
    try:
        if args.duration is not None:
            time.sleep(args.duration)
        else:
            print("Ctrl-C to stop", file=sys.stderr)
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        exporter.stop()
    return 0


def _cmd_slo(args):
    """The burn-rate health report: live from the demo engine, or from a
    saved ``ServingObs.series_snapshot()`` dump."""
    from .slo import SLOSet, state_of

    if args.demo:
        engine = _demo_engine(spec=args.spec, trace=False, slo=True,
                              flight=True)
        report = engine.health()
        if args.out:
            with open(args.out, "w") as f:
                json.dump(engine.obs.series_snapshot(), f, sort_keys=True)
            print(f"wrote {args.out}", file=sys.stderr)
    elif args.infile:
        with open(args.infile) as f:
            snap = json.load(f)
        if snap.get("version") != 1 or "series" not in snap:
            print(f"slo: {args.infile} is not a series snapshot "
                  f"(need version=1 + 'series'; write one with "
                  f"`slo --demo --out FILE`)", file=sys.stderr)
            return 2
        report = SLOSet().evaluate(snap["series"], now=snap.get("now"))
    else:
        print("slo: need --demo or --in FILE", file=sys.stderr)
        return 2
    print(json.dumps(report, indent=2, sort_keys=True))
    if args.fail_on and state_of(report["state"]) >= args.fail_on:
        print(f"slo: state {report['state']} >= --fail-on "
              f"{args.fail_on}", file=sys.stderr)
        return 1
    return 0


def _cmd_watch(args):
    """The terminal dashboard: poll a live exporter (``--url``) or render
    one frame from saved snapshot and report files (``--in``)."""
    from .export import render_dashboard

    def frame():
        if args.url:
            from urllib.request import urlopen

            base = args.url.rstrip("/")
            with urlopen(base + "/snapshot") as r:
                snap = json.load(r)
            with urlopen(base + "/slo") as r:
                report = json.load(r)
            return snap, report
        with open(args.infile) as f:
            snap = json.load(f)
        report = None
        if args.slo_in:
            with open(args.slo_in) as f:
                report = json.load(f)
        return snap, report

    if not args.url and not args.infile:
        print("watch: need --url BASE or --in metrics.json",
              file=sys.stderr)
        return 2
    frames = args.frames if args.frames is not None \
        else (0 if args.url else 1)  # 0: until interrupted
    n = 0
    try:
        while True:
            snap, report = frame()
            if n and args.url:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear between polls
            sys.stdout.write(render_dashboard(snap, report))
            sys.stdout.flush()
            n += 1
            if frames and n >= frames:
                break
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    return 0


_CHECK_RECIPES = ("serving_decode_step", "speculative_verify_step",
                  "serving_frontdoor_step", "serving_prefix_step",
                  "serving_int8_step", "serving_tp_step",
                  "serving_multiquantum_step")


def _check_slo_smoke():
    """SLOs and a flight recorder whose triggers always fire on the demo
    engine: the burn-rate evaluation orders states on both sides of a
    threshold, and every forced crossing left a schema-valid journal."""
    from .flight import FlightRecorder
    from .slo import SLOSet, default_serving_slos

    engine = _demo_engine(
        trace=False, slo=True,
        flight=FlightRecorder(ttft_threshold=1e-9, e2e_threshold=1e-9))
    finished = len(engine.completed)
    lenient = SLOSet(default_serving_slos(
        ttft_p95_s=1e9, inter_token_p99_s=1e9, e2e_p99_s=1e9))
    tight = SLOSet(default_serving_slos(
        ttft_p95_s=1e-9, inter_token_p99_s=1e-9, e2e_p99_s=1e-9))
    ok = lenient.evaluate(engine.obs)["state"]
    crit = tight.evaluate(engine.obs)["state"]
    if ok != "ok":
        raise AssertionError(f"lenient SLOs read {ok!r}, expected 'ok'")
    if crit != "critical":
        raise AssertionError(
            f"impossible SLOs read {crit!r}, expected 'critical'")
    records = engine.flight.records()  # schema-validates
    if len(records) != finished:
        raise AssertionError(
            f"{len(records)} anomaly journals for {finished} forced "
            f"threshold crossings")
    report = engine.health()  # stock objectives, real state
    print(f"slo smoke: lenient=ok impossible=critical "
          f"stock={report['state']}, {len(records)} schema-valid "
          f"anomaly journals for {finished} requests")


def _check_frontdoor_smoke():
    """A one-slot engine through a FORCED preemption (a BATCH request
    mid-decode evicted by an INTERACTIVE arrival): the overload counters
    fire, the resumed stream is whole, the pool gives back every block,
    and the dashboard renders the overload line."""
    import numpy as np

    from ..serving import (BATCH, INTERACTIVE, FrontDoorPolicy,
                           ServingEngine, ServingFrontDoor)
    from .export import render_dashboard

    cfg = _config()
    model = _model(cfg, 0)
    engine = ServingEngine(model, num_slots=1, block_size=4,
                           prefill_chunk=4, decode_quantum=2,
                           slo=True, flight=True, device=_DEVICE)
    door = ServingFrontDoor(engine, policy=FrontDoorPolicy())
    rng = np.random.RandomState(0)
    low = door.submit(rng.randint(1, cfg.vocab_size, 5).astype(np.int32),
                      max_new_tokens=6, priority=BATCH)
    while len(low.request.tokens) < 2:  # the batch request mid-decode
        door.pump()
    hi = door.submit(rng.randint(1, cfg.vocab_size, 4).astype(np.int32),
                     max_new_tokens=4, priority=INTERACTIVE)
    summary = door.drain()  # finish everything, flush the recorder
    reg = engine.obs.registry
    if reg.get("serving_requests_preempted_total").value() < 1 \
            or reg.get("serving_requests_resumed_total").value() < 1:
        raise AssertionError(f"forced preemption did not fire: {summary}")
    if reg.get("serving_tokens_recomputed_total").value() < 1:
        raise AssertionError("preemption recorded no recompute debt")
    if reg.get("serving_drains_total").value() != 1:
        raise AssertionError("drain counter did not fire")
    if len(hi.request.tokens) != 4 or len(low.request.tokens) != 6:
        raise AssertionError(
            f"streams wrong after preempt/resume: hi="
            f"{len(hi.request.tokens)} low={len(low.request.tokens)}")
    if engine.pool.fragmentation_stats()["blocks_in_use"] != 1:
        raise AssertionError("pool leaked blocks across preemption")
    frame = render_dashboard(reg.snapshot(), engine.health())
    if "preempted" not in frame or "shed" not in frame:
        raise AssertionError("dashboard frame missing overload line")
    print(f"front-door smoke: preempted="
          f"{engine.scheduler.preempted_total} resumed="
          f"{engine.scheduler.resumed_total} recomputed="
          f"{int(reg.get('serving_tokens_recomputed_total').value())} "
          f"tokens, drain flushed "
          f"{summary['flight']['captured_total']} journals")


def _check_prefix_smoke():
    """A forced cache hit and copy-on-write (a twin prompt aliases the
    first's blocks, one token short, so its re-prefill copies the tail
    block): the counters fire, the streams equal an UNSHARED engine's,
    the cached-token count surfaces, utilization stays <= 1 and the
    dashboard renders the prefix line."""
    import numpy as np

    from ..serving import ServingEngine
    from .export import render_dashboard
    from .flight import FlightRecorder

    cfg = _config()
    model = _model(cfg, 0)
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, cfg.vocab_size, 8).astype(np.int32)

    def drive(prefix):
        engine = ServingEngine(model, num_slots=2, block_size=4,
                               prefill_chunk=8, decode_quantum=2,
                               prefix_cache=prefix, slo=True,
                               # every journal captures, so the admit
                               # events stay inspectable after retirement
                               flight=FlightRecorder(ttft_threshold=1e-9,
                                                     e2e_threshold=1e-9),
                               device=_DEVICE)
        first = engine.submit(prompt.copy(), max_new_tokens=4)
        engine.step()  # prefill + publish before the twin arrives
        second = engine.submit(prompt.copy(), max_new_tokens=4)
        engine.run()
        return engine, first, second

    plain, p1, p2 = drive(False)
    cached, c1, c2 = drive(True)
    if (p1.tokens, p2.tokens) != (c1.tokens, c2.tokens):
        raise AssertionError(
            f"prefix-cached streams diverged: {c1.tokens}/{c2.tokens} "
            f"vs unshared {p1.tokens}/{p2.tokens}")
    if c2.cached_prefix_tokens != 8:
        raise AssertionError(
            f"twin aliased {c2.cached_prefix_tokens} tokens, expected "
            f"its full 8-token prompt")
    pool = cached.pool
    if pool.prefix_hits < 2 or pool.cow_copies < 1:
        raise AssertionError(
            f"forced hit/COW did not fire: hits={pool.prefix_hits} "
            f"cow={pool.cow_copies}")
    reg = cached.obs.registry
    for m in ("serving_prefix_cache_hits_total",
              "serving_prefix_cache_cow_copies_total",
              "serving_prefix_cache_shared_blocks_total"):
        if reg.get(m).value(pool="target") < 1:
            raise AssertionError(f"registry counter {m} never fired")
    st = pool.fragmentation_stats()
    if st["utilization"] > 1.0:
        raise AssertionError(f"refcount-aware utilization broke: {st}")
    frame = render_dashboard(reg.snapshot())
    if "prefix[" not in frame:
        raise AssertionError("dashboard frame missing prefix line")
    admits = [e for j in cached.flight.records()
              for e in j["events"] if e["kind"] == "admit"]
    if not any(e.get("cached_blocks") for e in admits):
        raise AssertionError(
            "flight admit events carry no cached-block counts")
    print(f"prefix smoke: hits={pool.prefix_hits} "
          f"misses={pool.prefix_misses} cow={pool.cow_copies} "
          f"cached_blocks={pool.cached_blocks}, streams equal to the "
          f"unshared engine's")


def _check_int8_smoke():
    """A forced cache hit and copy-on-write on an int8 engine (int8
    weights, int8 KV with per-row scale pools): the shared streams equal
    an UNSHARED int8 engine's, the counters fire on the int8 pool, and
    ``serving_pool_bytes`` shows the int8 pool under half a float
    engine's bytes for the same blocks."""
    import numpy as np

    from ..serving import ServingEngine

    cfg = _config()
    rng = np.random.RandomState(0)
    prompt = rng.randint(1, cfg.vocab_size, 8).astype(np.int32)

    def drive(prefix, quant):
        # a fresh model per engine: the quantize sweep rewrites the
        # Linears in place
        model = _model(cfg, 0)
        kw = (dict(quantize="weight_only_int8", kv_dtype="int8")
              if quant else {})
        engine = ServingEngine(model, num_slots=2, block_size=4,
                               prefill_chunk=8, decode_quantum=2,
                               prefix_cache=prefix, device=_DEVICE, **kw)
        first = engine.submit(prompt.copy(), max_new_tokens=4)
        engine.step()  # prefill + publish before the twin arrives
        mid_bytes = engine.pool.bytes_in_use()
        second = engine.submit(prompt.copy(), max_new_tokens=4)
        engine.run()
        return engine, first, second, mid_bytes

    shared, s1, s2, q_bytes = drive(True, True)
    plain, p1, p2, _ = drive(False, True)
    flt, _, _, f_bytes = drive(True, False)
    if (s1.tokens, s2.tokens) != (p1.tokens, p2.tokens):
        raise AssertionError(
            f"int8 prefix-shared streams diverged from the unshared int8 "
            f"engine: {s1.tokens}/{s2.tokens} vs {p1.tokens}/{p2.tokens}")
    pool = shared.pool
    if not pool.quantized:
        raise AssertionError("kv_dtype='int8' engine built a float pool")
    if pool.prefix_hits < 2 or pool.cow_copies < 1:
        raise AssertionError(
            f"forced hit/COW did not fire on the int8 pool: "
            f"hits={pool.prefix_hits} cow={pool.cow_copies}")
    if not q_bytes or q_bytes > 0.5 * f_bytes:
        raise AssertionError(
            f"int8 pool residency win missing: {q_bytes} B vs float "
            f"{f_bytes} B for the same allocated blocks")
    g = shared.obs.registry.get("serving_pool_bytes")
    if g.value(pool="target", kv_dtype="int8") <= 0:
        raise AssertionError(
            "serving_pool_bytes{kv_dtype=int8} gauge never fired")
    print(f"int8 smoke: hits={pool.prefix_hits} cow={pool.cow_copies}, "
          f"shared streams equal to the unshared int8 engine's, pool "
          f"bytes {q_bytes} vs float {f_bytes} "
          f"({f_bytes / q_bytes:.2f}x residency win)")


def _check_attribution_smoke():
    """The demo engine's speculative arm: the cost ledger conserves (its
    phase buckets sum to the emitted-token counter, prefill work splits
    into novel + recompute, the verify's waste is proposed - accepted)
    and its phase seconds sum to the measured quantum walls."""
    engine = _demo_engine(spec=True)
    reg = engine.obs.registry
    ledger = engine.obs.ledger

    emitted = ledger.emitted_tokens()
    total_emitted = reg.get("serving_tokens_emitted_total").value()
    if sum(emitted.values()) != total_emitted:
        raise AssertionError(
            f"ledger lost tokens: phase buckets {emitted} sum to "
            f"{sum(emitted.values())}, engine emitted {total_emitted}")
    work = ledger.prefill_work()
    prefill_total = reg.get("serving_prefill_tokens_total").value()
    if work["novel"] + work["recompute"] != prefill_total:
        raise AssertionError(
            f"prefill work {work} does not decompose the legacy counter "
            f"{prefill_total}")
    proposed = reg.get("serving_spec_proposed_total").value()
    accepted = reg.get("serving_spec_accepted_total").value()
    if proposed <= 0 or emitted["spec_verify"] <= 0:
        raise AssertionError(
            f"spec arm never exercised: proposed={proposed} "
            f"spec_verify emitted={emitted['spec_verify']}")
    rejected = ledger.waste_tokens()["spec_rejected"]
    if rejected != proposed - accepted:
        raise AssertionError(
            f"spec waste drifted: ledger rejected={rejected}, engine "
            f"proposed-accepted={proposed - accepted}")
    hist = reg.get("serving_quantum_seconds")
    wall = sum(hist.sum(kind=k) for k in ("mixed", "decode", "spec_round"))
    attributed = sum(ledger.phase_seconds().values())
    if abs(attributed - wall) > 1e-6 * max(1.0, wall):
        raise AssertionError(
            f"phase seconds {attributed:.9f} do not sum to measured "
            f"quantum wall {wall:.9f}")
    rep = engine.attribution()
    if not 0.0 < rep["useful_token_fraction"] <= 1.0:
        raise AssertionError(f"useful-token fraction out of range: {rep}")
    if rep["mfu"]["flops_per_token"] <= 0:
        raise AssertionError(
            f"ledger never configured with model FLOPs: {rep['mfu']}")
    print(f"attribution smoke: {int(total_emitted)} tokens conserved "
          f"across {emitted}, useful={rep['useful_token_fraction']:.3f}, "
          f"{attributed:.3f}s attributed == quantum wall")


def _check_resilience_smoke():
    """A bounded seeded run of the two-arm chaos soak: faults fired and
    every non-poisoned stream equals the fault-free arm's (``run_soak``
    asserts the drain, definite finish reasons and no leaked block
    itself)."""
    from ..serving.soak import run_soak

    model = _model(_config(), 0)
    # 6 rounds land a couple of injected faults in a short run
    rep = run_soak(model, rounds=6, seed=2, device=_DEVICE)
    if rep["faults_injected"] < 1:
        raise AssertionError(
            f"soak injected no faults: plan or seed drifted: {rep}")
    if rep["requests"] < 1:
        raise AssertionError(f"soak submitted nothing: {rep}")
    expect_exact = rep["requests"] - len(rep["poisoned"])
    if rep["bitexact_streams"] != expect_exact:
        raise AssertionError(
            f"soak lost streams: {rep['bitexact_streams']} equal of "
            f"{expect_exact} non-poisoned")
    print(f"resilience smoke: seed={rep['seed']} rounds={rep['rounds']} "
          f"requests={rep['requests']} faults={rep['faults_injected']} "
          f"retries={rep['retries']} skips={rep['step_skips']}, "
          f"{rep['bitexact_streams']} non-poisoned streams equal, pools "
          f"drained clean")


def _check_cluster_smoke():
    """A shared-prefix trace through a 2-replica ClusterFrontDoor: the
    twin prompts land on their prefix's owner (affinity hits > 0), the
    router counters fire, the streams equal a cluster of one's, and the
    merged ClusterExporter snapshot renders the dashboard's cluster
    line."""
    import numpy as np

    from ..serving import (ClusterFrontDoor, ClusterReplica, ClusterRouter,
                           ServingEngine, no_shed_policy)
    from .export import ClusterExporter, render_dashboard

    cfg = _config()
    model = _model(cfg, 0)
    rng = np.random.RandomState(0)
    shared = rng.randint(1, cfg.vocab_size, 8).tolist()
    prompts = [shared + rng.randint(1, cfg.vocab_size, 2 + i).tolist()
               for i in range(4)]

    def drive(n_replicas):
        reps = [ClusterReplica(
                    f"r{i}",
                    ServingEngine(model, num_slots=2, block_size=4,
                                  prefix_cache=True, device=_DEVICE),
                    policy=no_shed_policy())
                for i in range(n_replicas)]
        cfd = ClusterFrontDoor(ClusterRouter(reps, affinity_blocks=2))
        streams = [cfd.submit(p, max_new_tokens=2, seed=0)
                   for p in prompts]
        cfd.run_until_idle()
        return cfd, [list(s.result()) for s in streams]

    cfd2, out2 = drive(2)
    cfd1, out1 = drive(1)
    if out2 != out1:
        raise AssertionError(
            f"cluster-of-2 streams diverged from cluster-of-1: {out2} vs "
            f"{out1}")
    st = cfd2.router.affinity_stats()
    if st["keyed_requests"] != len(prompts) or st["affinity_hits"] < 1:
        raise AssertionError(
            f"shared prefixes never re-landed on their owner: {st}")
    reqs = cfd2.router._c_requests
    routed = int(sum(reqs.value(replica=r.name, reason=reason)
                     for r in cfd2.router.replicas
                     for reason in ("affinity", "balance", "failover")))
    if routed != len(prompts):
        raise AssertionError(
            f"router accounted {routed} placements for {len(prompts)} "
            f"requests")
    exp = ClusterExporter.for_cluster(cfd2)
    frame = render_dashboard(exp.registry.snapshot())
    if " cluster " not in frame:
        raise AssertionError("dashboard frame missing cluster line")
    print(f"cluster smoke: routed={routed} "
          f"affinity_hits={st['affinity_hits']} "
          f"hit_rate={st['hit_rate']:.2f}, 2-replica streams equal to a "
          f"cluster of one's, merged dashboard ok")


_SMOKES = (
    ("slo smoke", _check_slo_smoke, (AssertionError, ValueError)),
    ("front-door smoke", _check_frontdoor_smoke,
     (AssertionError, ValueError)),
    ("prefix smoke", _check_prefix_smoke, (AssertionError, ValueError)),
    ("int8 smoke", _check_int8_smoke, (AssertionError, ValueError)),
    ("attribution smoke", _check_attribution_smoke,
     (AssertionError, ValueError, KeyError)),
    ("resilience smoke", _check_resilience_smoke,
     (AssertionError, ValueError, RuntimeError)),
    ("cluster smoke", _check_cluster_smoke, (AssertionError, ValueError)),
)


def _cmd_check(args):
    """The CI gate: every smoke runs; exit 1 if any failed."""
    for name in args.recipe or ():
        item = "A7" if name == "serving_tp_step" else "A8"
        not_ported(f"the obs check's graph audit of {name}", item)()
    failed = False
    for name, smoke, caught in _SMOKES:
        try:
            smoke()
        except caught as e:
            failed = True
            print(f"{name}: FAIL — {e}", file=sys.stderr)
    if failed:
        return 1
    print("obs check: every smoke passed")
    return 0


def main(argv=None):
    global _DEVICE
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.obs",
        description="runtime observability command line (see the "
                    "module docstring)")
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                        help="where the demo and smoke engines run "
                             "(default cuda; no fallback)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("snapshot", parents=[common],
                       help="render a metrics snapshot")
    p.add_argument("--in", dest="infile", default=None,
                   help="saved snapshot JSON to re-render")
    p.add_argument("--demo", action="store_true",
                   help="drive the demo serving engine instead")
    p.add_argument("--spec", action="store_true",
                   help="the demo runs the speculative round")
    p.add_argument("--format", choices=("prom", "json"), default="prom")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=_cmd_snapshot)

    p = sub.add_parser("export", parents=[common],
                       help="write/validate a Chrome trace JSON")
    p.add_argument("--in", dest="infile", default=None,
                   help="existing trace to validate")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--spec", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--metrics-out", default=None,
                   help="also dump the demo registry snapshot here")
    p.set_defaults(fn=_cmd_export)

    p = sub.add_parser("serve", parents=[common],
                       help="live HTTP exporter over the demo engine")
    p.add_argument("--demo", action="store_true", default=True,
                   help="(implied) drive the demo engine")
    p.add_argument("--spec", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=9100)
    p.add_argument("--duration", type=float, default=None,
                   help="serve for N seconds then exit (default: until "
                        "Ctrl-C)")
    p.set_defaults(fn=_cmd_serve)

    p = sub.add_parser("slo", parents=[common],
                       help="evaluate the burn-rate health report")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--spec", action="store_true")
    p.add_argument("--in", dest="infile", default=None,
                   help="saved series snapshot (slo --demo --out)")
    p.add_argument("--out", default=None,
                   help="with --demo: also dump the series snapshot")
    p.add_argument("--fail-on", choices=("warn", "critical"), default=None,
                   help="exit 1 when the state reaches this level")
    p.set_defaults(fn=_cmd_slo)

    p = sub.add_parser("watch", parents=[common],
                       help="terminal health dashboard")
    p.add_argument("--url", default=None,
                   help="base URL of a running exporter (serve)")
    p.add_argument("--in", dest="infile", default=None,
                   help="saved registry snapshot JSON")
    p.add_argument("--slo-in", dest="slo_in", default=None,
                   help="saved /slo report JSON (with --in)")
    p.add_argument("--interval", type=float, default=1.0)
    p.add_argument("--frames", type=int, default=None,
                   help="stop after N frames (default: loop on --url, 1 "
                        "on --in)")
    p.set_defaults(fn=_cmd_watch)

    p = sub.add_parser("check", parents=[common],
                       help="the smokes' CI gate")
    p.add_argument("--recipe", action="append", default=None,
                   choices=_CHECK_RECIPES,
                   help="the reference's graph audit (not ported: raises)")
    p.set_defaults(fn=_cmd_check)

    args = ap.parse_args(argv)
    _DEVICE = args.device
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
