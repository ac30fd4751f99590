"""The port's cluster tier (``paddle_tpu_torch.serving.cluster``, the
merged ``ClusterExporter``) and its ``obs`` command line held against
``paddle_tpu``'s, through the scenarios of ``tests/test_cluster.py``.

Router placement runs as parametrised host cases over stub engines on both
packages: the placements, redistributions, health gating and refusals must
be EQUAL. The live scenarios use the tiny Llama in f32 (weights carried
across with ``load_paddle_tpu_arrays``): a cluster of 4 equals a cluster of
one and the reference's; shed coordination fails over before it refuses;
drain finishes everything and the merged exporter serves the fleet over
HTTP on 127.0.0.1; the prefill/decode hand-off and the fleet snapshot /
restore equal the reference's streams. The command line's ``check`` smokes
pass on ``--device cpu``, and its ``snapshot`` / ``export`` output equals
the reference's ``_demo_engine`` output under one patched clock.
"""
import json
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.obs as R_obs
import paddle_tpu.obs.__main__ as R_cli
import paddle_tpu.serving as R
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import paged_cache as R_pc
import paddle_tpu_torch.obs as P_obs
import paddle_tpu_torch.obs.__main__ as P_cli
import paddle_tpu_torch.serving as P
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.nlp import load_paddle_tpu_arrays
from paddle_tpu_torch.nlp import paged_cache as P_pc

_LATER = {"serving_collective_bytes_total", "serving_collective_count_total"}


def _carry(ref, cfg):
    port = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_arrays(
        port, {k: v.numpy() for k, v in ref.state_dict().items()})
    return port


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLM(RefConfig.tiny(tensor_parallel=False))
    ref.eval()
    return {"ref": ref,
            "port": _carry(ref, LlamaConfig.tiny(tensor_parallel=False))}


# ------------------------------------------------ prompt_prefix_key
def test_prompt_prefix_key_matches_both_pools_chains():
    toks = np.arange(1, 14, dtype=np.int32)  # 3 full blocks + a tail
    pool = P_pc.PagedKVCachePool(16, 4, 2, 8, prefix_cache=True,
                                 device="cpu")
    pool.ensure("a", len(toks))
    pool.publish_prefix("a", toks)
    entries = pool._match_entries(toks)
    assert len(entries) == 3
    for d in (None, 1, 2, 3):
        key = P.prompt_prefix_key(toks, 4, max_blocks=d)
        assert key == R_pc.prompt_prefix_key(toks, 4, max_blocks=d)
        assert key == entries[(3 if d is None else d) - 1].hash
    assert P_pc._chain_hash(5, (1, 2)) == R_pc._chain_hash(5, (1, 2))
    assert P.prompt_prefix_key([1, 2, 3], 4) is None
    with pytest.raises(ValueError):
        P.prompt_prefix_key([1, 2, 3, 4], 0)


# ------------------------------------------------ router host cases
class _StubPool:
    def __init__(self, block_size):
        self.block_size = block_size
        self.free_blocks = 64
        self.blocks_in_use = 0


class _StubSched:
    def __init__(self):
        self.waiting = []

    def live(self):
        return []


class _StubObs:
    def now(self):
        return 0.0

    def on_drain(self, *a, **k):
        pass


class _StubCfg:
    num_slots = 4


class _StubEngine:
    """Just the engine surface the replica and the router read."""

    def __init__(self, block_size=4):
        self.pool = _StubPool(block_size)
        self.scheduler = _StubSched()
        self.obs = _StubObs()
        self.config = _StubCfg()
        self.token_sink = None
        self.flight = None
        self.slo = None


def _stub_cluster(mod, n, **kw):
    reps = [mod.ClusterReplica(f"r{i}", _StubEngine()) for i in range(n)]
    return reps, mod.ClusterRouter(reps, **kw)


def _keys(seed, n, n_blocks=2, bs=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 1000, size=n_blocks * bs).tolist()
            for _ in range(n)]


def _case_affinity(mod):
    reps, router = _stub_cluster(mod, 4, vnodes=32)
    toks = _keys(0, 1)[0]
    first = router.plan(toks)
    assert first[0][1] == "affinity"
    assert all(r == "failover" for _, r in first[1:]) and len(first) == 4
    for _ in range(5):
        assert router.plan(toks)[0][0] is first[0][0]
    assert router.plan([1, 2, 3])[0][1] == "balance"
    return [(r.name, why) for r, why in first]


def _case_redistribution(mod):
    reps, router = _stub_cluster(mod, 4, vnodes=64)
    keys = _keys(1, 300)
    before = {tuple(k): router.plan(k)[0][0].name for k in keys}
    router.add_replica(mod.ClusterReplica("r4", _StubEngine()))
    after = {tuple(k): router.plan(k)[0][0].name for k in keys}
    moved = [k for k in before if before[k] != after[k]]
    assert all(after[k] == "r4" for k in moved)
    assert 0.0 < len(moved) / len(keys) < 0.45
    router.remove_replica("r4")
    assert {tuple(k): router.plan(k)[0][0].name for k in keys} == before
    return sorted(before.items()), sorted(after.items())


def _case_health(mod):
    reps, router = _stub_cluster(mod, 3, vnodes=32)
    toks = next(k for k in _keys(2, 200)
                if router.plan(k)[0][0].name == "r1")
    out = []
    reps[1].health_state = lambda now: "critical"
    plan = router.plan(toks)
    assert all(rep.name != "r1" for rep, _ in plan)
    out.append([(r.name, w) for r, w in plan])
    reps[1].health_state = lambda now: "warn"
    plan = router.plan(toks)
    assert all(rep.name != "r1" for rep, _ in plan)
    out.append([(r.name, w) for r, w in plan])
    for r in reps:
        r.health_state = lambda now: "warn"
    assert router.plan(toks)[0][0].name == "r1"
    for r in reps:
        r.health_state = lambda now: "critical"
    assert len(router.plan(toks)) == 3
    out.append(router.registry.snapshot())
    return out


def _case_balance(mod):
    reps, router = _stub_cluster(mod, 3, vnodes=32)
    reps[0].engine.scheduler.waiting = [1, 2]
    reps[1].engine.scheduler.waiting = [1]
    assert router.plan([1, 2, 3])[0][0].name == "r2"
    _, rr = _stub_cluster(mod, 3, strategy="round_robin")
    order = [rr.plan([5, 6, 7, 8])[0][0].name for _ in range(6)]
    assert order == ["r0", "r1", "r2", "r0", "r1", "r2"]
    return order


def _case_load_report(mod):
    reps, router = _stub_cluster(mod, 2)
    parsed = json.loads(json.dumps(router.load_reports()))
    assert parsed[0]["replica"] == "r0"
    return parsed


def _case_refusals(mod):
    msgs = []
    a, b = _StubEngine(block_size=4), _StubEngine(block_size=8)
    for build in (
            lambda: mod.ClusterRouter([mod.ClusterReplica("a", a),
                                       mod.ClusterReplica("b", b)]),
            lambda: mod.ClusterRouter([mod.ClusterReplica("x", a),
                                       mod.ClusterReplica("x", a)]),
            lambda: mod.ClusterRouter([]),
            lambda: mod.ClusterReplica("z", a, role="boss"),
            lambda: mod.ClusterRouter([mod.ClusterReplica("y", a)],
                                      strategy="random")):
        with pytest.raises(ValueError) as e:
            build()
        msgs.append(str(e.value))
    return msgs


def _case_drain_interleaves(mod):
    ledger = []

    class _DrainEngine(_StubEngine):
        def __init__(self, steps):
            super().__init__()
            self.steps_left = steps

        @property
        def has_work(self):
            return self.steps_left > 0

    class _DrainDoor:
        def __init__(self, engine, name):
            self.engine = engine
            self._name = name
            self._draining = False

        @property
        def draining(self):
            return self._draining

        def pump_dispatch(self):
            return self._name

        def pump_collect(self, pending):
            self.engine.steps_left -= 1
            ledger.append(self._name)
            return self.engine.has_work

        def drain(self, flight_path=None):
            assert not self.engine.has_work
            return {"completed": 0, "shed": 0, "preempted": 0,
                    "resumed": 0}

    reps = []
    for name in ("a", "b"):
        eng = _DrainEngine(8)
        reps.append(mod.ClusterReplica(name, eng,
                                       door=_DrainDoor(eng, name)))
    summary = mod.ClusterFrontDoor(mod.ClusterRouter(reps)).drain()
    counts = {"a": 0, "b": 0}
    for name in ledger:
        counts[name] += 1
        assert abs(counts["a"] - counts["b"]) <= 1
    assert summary["drained"] and len(ledger) == 16
    return ledger, summary


_CASES = {"affinity": _case_affinity, "redistribution": _case_redistribution,
          "health": _case_health, "balance": _case_balance,
          "load_report": _case_load_report, "refusals": _case_refusals,
          "drain_interleaves": _case_drain_interleaves}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_router_host_case_equals_reference(case):
    assert _CASES[case](P) == _CASES[case](R)


# ------------------------------------------------ live clusters
def _replica(ns, model, name, role="general", policy=None, flight=False,
             **eng_kw):
    kw = dict(num_slots=2, block_size=4, prefix_cache=True)
    kw.update(eng_kw)
    if ns is P:
        kw["device"] = "cpu"
    if flight:
        kw["flight"] = (P_obs if ns is P else R_obs).FlightRecorder()
    eng = ns.ServingEngine(model, **kw)
    return ns.ClusterReplica(name, eng, role=role,
                             policy=policy or ns.no_shed_policy())


def _trace(n=4, seed=3, vocab=128):
    """A seeded ragged trace over two shared system prompts."""
    rng = np.random.default_rng(seed)
    sys_a = rng.integers(1, vocab, size=8).tolist()
    sys_b = rng.integers(1, vocab, size=8).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(1, vocab, size=int(rng.integers(2, 7))).tolist()
        prompts.append((sys_a if i % 2 else sys_b) + tail)
    return prompts


def _run_cluster(ns, model, prompts, n, max_new_tokens=2):
    reps = [_replica(ns, model, f"r{i}") for i in range(n)]
    cfd = ns.ClusterFrontDoor(ns.ClusterRouter(reps, affinity_blocks=2))
    streams = [cfd.submit(p, max_new_tokens=max_new_tokens, seed=0)
               for p in prompts]
    cfd.run_until_idle()
    return cfd, {s.request.req_id: list(s.result()) for s in streams}


@pytest.fixture(scope="module")
def canon(models):
    """The shared trace and the reference's cluster-of-one streams."""
    prompts = _trace()
    _, ref = _run_cluster(R, models["ref"], prompts, 1)
    return prompts, ref


def test_cluster_of_4_equals_cluster_of_1_and_reference(models, canon):
    prompts, ref = canon
    _, one = _run_cluster(P, models["port"], prompts, 1)
    cfd4, four = _run_cluster(P, models["port"], prompts, 4)
    assert four == one == ref
    st = cfd4.router.affinity_stats()
    assert st["keyed_requests"] == len(prompts) and st["affinity_hits"] > 0
    reqs = cfd4.router._c_requests
    assert sum(reqs.value(replica=f"r{i}", reason="affinity")
               for i in range(4)) == len(prompts)


def test_cluster_shed_coordination_failover(models):
    """A request sheds only when every eligible replica refused it."""
    pol = P.FrontDoorPolicy(max_waiting=1, preempt=False,
                            backpressure_exempt=P.INTERACTIVE)
    reps = [_replica(P, models["port"], f"r{i}", policy=pol)
            for i in range(2)]
    cfd = P.ClusterFrontDoor(P.ClusterRouter(reps, affinity_blocks=1))
    p = list(range(1, 9))
    s1, s2, s3 = (cfd.submit(p, max_new_tokens=1, seed=0) for _ in range(3))
    assert not s1.shed and not s2.shed and s3.shed
    reqs = cfd.router._c_requests
    assert sum(reqs.value(replica=f"r{i}", reason="failover")
               for i in range(2)) == 1
    assert cfd.router._c_shed.value(reason="cluster_full") == 1
    cfd.run_until_idle()
    assert list(s1.result()) == list(s2.result())


def test_cluster_victim_selection_on_full_cluster(models):
    """An INTERACTIVE arrival on a pool-tight replica preempts a BATCH
    victim through the routed door's own preemption."""
    reps = [_replica(P, models["port"], "r0",
                     policy=P.FrontDoorPolicy(preempt=True), num_blocks=10,
                     prefix_cache=False)]
    cfd = P.ClusterFrontDoor(P.ClusterRouter(reps))
    rng = np.random.default_rng(5)
    ps = [rng.integers(1, 128, size=10).tolist() for _ in range(3)]
    batch = [cfd.submit(ps[i], max_new_tokens=3, priority=P.BATCH, seed=0)
             for i in range(2)]
    cfd.pump()
    vip = cfd.submit(ps[2], max_new_tokens=3, priority=P.INTERACTIVE,
                     seed=0)
    cfd.run_until_idle()
    assert reps[0].engine.scheduler.preempted_total >= 1
    assert not vip.shed and len(vip.result()) == 3
    assert all(len(s.result()) == 3 for s in batch)


class _ForcedCritical:
    def health_report(self, now=None):
        return {"version": 1, "state": "critical", "now": now,
                "objectives": []}


def test_cluster_drain_and_merged_exporter_over_http(models, canon):
    """Drain finishes every accepted request and sheds later ones on every
    replica; the merged scrape is the union of the replicas' relabeled
    series; ``/healthz`` is the worst replica's; the exporter answers over
    HTTP on 127.0.0.1; the dashboard renders the cluster line."""
    prompts, _ = canon
    reps = [_replica(P, models["port"], f"r{i}") for i in range(2)]
    cfd = P.ClusterFrontDoor(P.ClusterRouter(reps, affinity_blocks=2))
    streams = [cfd.submit(p, max_new_tokens=1, seed=0) for p in prompts]
    summary = cfd.drain()
    assert summary["drained"] and summary["completed"] == len(prompts)
    assert all(len(s.result()) == 1 for s in streams)
    late = cfd.submit(prompts[0], max_new_tokens=1)
    assert late.shed and late.finish_reason == "shed"
    assert cfd.router._c_shed.value(reason="draining") == 1
    exp = P_obs.ClusterExporter.for_cluster(cfd)
    merged = exp.registry.snapshot()
    for rep in reps:
        for m in rep.engine.obs.registry.snapshot()["metrics"]:
            mm = next(x for x in merged["metrics"] if x["name"] == m["name"])
            for s in m["series"]:
                want = dict(s.get("labels", {}), replica=rep.name)
                hit = [x for x in mm["series"] if x["labels"] == want]
                assert len(hit) == 1, (m["name"], want)
                if "value" in s:
                    assert hit[0]["value"] == s["value"]
    text = exp.registry.prometheus()
    assert "serving_router_requests_total" in text
    assert 'replica="r0"' in text and 'replica="r1"' in text
    status, body = exp.healthz()
    assert status == 200 and body["state"] == "ok"
    exp._members[1] = (exp._members[1][0], _ForcedCritical())
    status, body = exp.healthz()
    assert status == 503 and body == {
        "state": "critical", "replicas": {"r0": "ok", "r1": "critical"}}
    with P_obs.ClusterExporter.for_cluster(cfd) as live:
        assert live.url("/metrics").startswith("http://127.0.0.1:")
        raw = urllib.request.urlopen(live.url("/metrics"),
                                     timeout=5).read().decode()
        assert 'replica="r1"' in raw
        health = json.loads(urllib.request.urlopen(
            live.url("/healthz"), timeout=5).read().decode())
        assert health["state"] == "ok"
    dash = P_obs.render_dashboard(merged)
    assert " cluster " in dash and "hit" in dash
    # the merged snapshot renders as the reference's dashboard does
    assert dash == R_obs.render_dashboard(merged)


def test_disaggregated_handoff_equals_reference(models, canon):
    """Prefill replica then decode replica through recompute-on-resume:
    the joined streams equal a single replica's and the reference's
    hand-off, the hand-offs are counted and journaled, and the journals
    validate."""
    prompts, canon_ref = canon
    prompts = prompts[:2]
    out = {}
    for ns, model in ((R, models["ref"]), (P, models["port"])):
        reps = [_replica(ns, model, "pf", role="prefill", flight=True),
                _replica(ns, model, "dc", role="decode", flight=True)]
        cfd = ns.ClusterFrontDoor(ns.ClusterRouter(reps, affinity_blocks=2))
        streams = [cfd.submit(p, max_new_tokens=2, seed=0) for p in prompts]
        cfd.run_until_idle()
        out[ns] = ({s.request.req_id: list(s.result()) for s in streams},
                   cfd.router._c_handoffs.value(),
                   reps[0].engine.pool.prefix_cache_stats(),
                   reps, cfd.router.affinity_stats())
    assert out[P][0] == out[R][0] == {f"c{i}": canon_ref[f"c{i}"]
                                      for i in range(len(prompts))}
    assert out[P][1] == out[R][1] == len(prompts)
    assert out[P][2] == out[R][2] and out[P][2]["cached_blocks"] > 0
    assert out[P][4] == out[R][4]
    for rep in out[P][3]:
        recs = [json.loads(ln) for ln in rep.engine.flight.jsonl()
                .splitlines()]
        if recs:
            P_obs.validate_flight_records(recs)
        kinds = [e["kind"] for j in rep.engine.flight._live.values()
                 for e in j["events"]]
        if rep.role == "decode":
            assert "submit" not in kinds


def test_fleet_snapshot_restore_equals_reference(models, canon):
    """Crash mid-decode, restore the whole fleet from its JSON snapshot,
    finish: the snapshots equal the reference's, the streams equal the
    uninterrupted run's, and the affinity map survives."""
    prompts, ref = canon
    got = {}
    for ns, model in ((R, models["ref"]), (P, models["port"])):
        reps = [_replica(ns, model, f"r{i}") for i in range(2)]
        cfd = ns.ClusterFrontDoor(ns.ClusterRouter(reps, affinity_blocks=2))
        for p in prompts:
            cfd.submit(p, max_new_tokens=2, seed=0)
        cfd.pump()
        snap = json.loads(json.dumps(cfd.snapshot()))
        kw = {"device": "cpu"} if ns is P else {}
        restored = ns.ClusterFrontDoor.restore(
            snap, model, policy=ns.no_shed_policy(), **kw)
        streams = restored.streams()
        restored.run_until_idle()
        out = {rid: list(s.result()) for rid, s in streams.items()}
        completed = {str(r.req_id): list(r.tokens) for rep in cfd.replicas
                     for r in rep.engine.completed}
        got[ns] = (snap, out, completed, restored.router._key_owner,
                   cfd.router._key_owner)
    assert got[P][0] == got[R][0]
    assert got[P][0]["kind"] == "serving_cluster_snapshot"
    snap, out, completed, owners, before = got[P]
    assert out and out == got[R][1]
    for rid, toks in ref.items():
        assert out.get(rid, completed.get(rid)) == toks
    assert owners == before == got[R][3]


# ------------------------------------------------ the command line
def test_cli_check_smokes_pass_on_cpu(capsys):
    assert P_cli.main(["check", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for smoke in ("slo smoke", "front-door smoke", "prefix smoke",
                  "int8 smoke", "attribution smoke", "resilience smoke",
                  "cluster smoke"):
        assert smoke + ":" in out
    assert "obs check: every smoke passed" in out


@pytest.mark.parametrize("recipe,item", [("serving_decode_step", "A8"),
                                         ("serving_tp_step", "A7")])
def test_cli_check_graph_audit_refuses(recipe, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        P_cli.main(["check", "--device", "cpu", "--recipe", recipe])


class _Clock:
    t = 100.0

    @classmethod
    def now(cls):
        return cls.t


def test_cli_snapshot_and_export_equal_reference(models, tmp_path,
                                                 monkeypatch, capsys):
    """``export --demo --metrics-out`` and ``snapshot --demo`` on the
    reference's demo weights, both clocks patched to one: the trace
    events and the registry snapshot (restricted to the port's names)
    are equal; ``snapshot --in``, ``watch --in`` and ``slo --in`` render
    a saved file as the reference does."""
    monkeypatch.setattr(P_cli, "_demo_models",
                        lambda spec=False: (models["port"], None))
    for obs in (P_obs, R_obs):
        monkeypatch.setattr(obs.ServingObs, "now", staticmethod(_Clock.now))
        # the demo's tracer takes its epoch from the same clock
        monkeypatch.setattr(obs.TraceRecorder.__init__, "__defaults__",
                            (65536, _Clock.t))
    files = {}
    for name, cli, argv in (("ref", R_cli, []),
                            ("port", P_cli, ["--device", "cpu"])):
        trace, metrics = tmp_path / f"{name}.json", tmp_path / f"{name}.m"
        assert cli.main(["export", "--demo", "--out", str(trace),
                         "--metrics-out", str(metrics)] + argv) == 0
        files[name] = (json.loads(trace.read_text()),
                       json.loads(metrics.read_text()))
    assert files["port"][0]["traceEvents"] == files["ref"][0]["traceEvents"]
    ref_m, port_m = files["ref"][1], files["port"][1]
    names = {m["name"] for m in port_m["metrics"]}
    assert {m["name"] for m in ref_m["metrics"]} - names <= _LATER
    assert port_m == {"version": ref_m["version"],
                      "metrics": [m for m in ref_m["metrics"]
                                  if m["name"] in names]}
    capsys.readouterr()
    assert P_cli.main(["snapshot", "--demo", "--format", "json",
                       "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == port_m
    saved = tmp_path / "port.m"
    outs = []
    for cli, argv in ((R_cli, []), (P_cli, ["--device", "cpu"])):
        for cmd in (["snapshot", "--in", str(saved)],
                    ["watch", "--in", str(saved)]):
            assert cli.main(cmd + argv) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "paddle_tpu serving health" in outs[1]
    assert P_cli.main(["snapshot", "--device", "cpu"]) == 2
