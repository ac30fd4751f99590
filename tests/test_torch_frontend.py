"""The port's serving front door (``paddle_tpu_torch.serving.ServingFrontDoor``,
``FrontDoorPolicy``, ``inference.serve``) held against the reference's.

- Policy parity: ``FrontDoorPolicy.admission`` and ``choose_victim`` over a
  grid of policies, classes, health states, queue depths and live sets
  must decide as the reference's do.
- Front-door parity: the tiny Llama (f32, carried weights) through both
  packages' ``serve()`` on one trace: BATCH requests, an INTERACTIVE
  arrival that preempts one of them, NORMAL arrivals past the queue bound
  (backpressure), a forced-critical health report (SLO shedding), drain,
  and a submission after the drain. Both clocks are patched to one the
  test advances between pumps. Streams, finish reasons, the shed requests
  and their reasons, preemptions, resumes, the drain summary, the flight
  journal, the registry and ``stats()`` must be EQUAL.
- The port's own behaviour, on the model of the reference's
  tests/test_frontend.py: ``async for`` streaming equal to the sync
  streams, the per-token ``timeout=``, a pump failure failing every open
  stream, an orphaned stream's error close, preemption under the prefix
  cache equal to an undisturbed run, and the refusals of every option a
  later slice brings.
"""
import asyncio
import json

import numpy as np
import pytest

import paddle_tpu as paddle
import paddle_tpu.obs as R_obs
import paddle_tpu.serving as R
from paddle_tpu import inference as R_inference
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
import paddle_tpu_torch.obs as P_obs
import paddle_tpu_torch.serving as P
from paddle_tpu_torch import inference
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.obs import load_flight_records
from paddle_tpu_torch.serving import (BATCH, INTERACTIVE, NORMAL,
                                      FrontDoorPolicy, ServingEngine,
                                      ServingFrontDoor, no_shed_policy)

_POLICIES = {
    "stock": {},
    "bounded": dict(max_waiting=4),
    "disjoint": dict(shed_on_warn=(BATCH,), shed_on_critical=(NORMAL,),
                     max_waiting=2, backpressure_exempt=NORMAL),
    "no_shed": None,
}


def _policy(mod, name):
    kw = _POLICIES[name]
    return mod.no_shed_policy() if kw is None else mod.FrontDoorPolicy(**kw)


@pytest.mark.parametrize("policy", sorted(_POLICIES))
@pytest.mark.parametrize("priority", [BATCH, NORMAL, INTERACTIVE])
@pytest.mark.parametrize("state", ["ok", "warn", "critical"])
@pytest.mark.parametrize("depth", [0, 2, 4, 9])
def test_admission_equals_reference(policy, priority, state, depth):
    port = _policy(P, policy).admission(priority, state, depth)
    assert port == _policy(R, policy).admission(priority, state, depth)
    if state == "ok" and depth == 0:
        assert port == (True, None)


_LIVE = {  # (priority, admit time, slot or None, finished)
    "mixed": [(NORMAL, 0.5, 0, False), (BATCH, 1.0, 1, False),
              (BATCH, 2.0, 2, False)],
    "one_normal": [(NORMAL, 0.5, 0, False)],
    "ties": [(BATCH, 1.0, 0, False), (BATCH, 1.0, 1, False)],
    "none_live": [(BATCH, 1.0, None, False), (NORMAL, 2.0, 1, True)],
    "unadmitted": [(BATCH, None, 0, False), (BATCH, 3.0, 1, False)],
}


@pytest.mark.parametrize("live", sorted(_LIVE))
@pytest.mark.parametrize("below", [BATCH, NORMAL, INTERACTIVE])
def test_choose_victim_equals_reference(live, below):
    picks = []
    for mod in (P, R):
        reqs = []
        for i, (pri, admit, slot, finished) in enumerate(_LIVE[live]):
            r = mod.Request(np.arange(1, 4), max_new_tokens=2, req_id=i,
                            priority=pri)
            r.admit_time, r.slot, r.finished = admit, slot, finished
            reqs.append(r)
        victim = mod.choose_victim(reqs, below)
        picks.append(None if victim is None else victim.req_id)
    assert picks[0] == picks[1]
    if live == "mixed" and below == INTERACTIVE:
        assert picks[0] == 2


# ------------------------------------------------ front-door parity
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
    t = 50.0

    @classmethod
    def now(cls):
        return cls.t


_KW = dict(num_slots=2, block_size=4, prefill_chunk=4, decode_quantum=3)


def _door_trace(mod, fd, tmp_path):
    """The trace of the module docstring; returns what is compared."""
    rng = np.random.RandomState(4)

    def prompt(n):
        return rng.randint(1, 128, n).astype(np.int32)

    def pump():
        fd.pump()
        _Clock.t += 0.001

    streams = [fd.submit(prompt(5), max_new_tokens=6, priority=BATCH),
               fd.submit(prompt(9), max_new_tokens=5, priority=BATCH)]
    while len(streams[0].request.tokens) < 2:
        pump()
    streams.append(fd.submit(prompt(4), max_new_tokens=4,
                             priority=INTERACTIVE))
    pump()
    streams += [fd.submit(prompt(3 + i), max_new_tokens=3, priority=NORMAL)
                for i in range(4)]
    while fd.engine.scheduler.waiting:
        pump()
    # every recent time to first token past the stock 0.5 s objective:
    # both windows burn past the critical gate
    fd.engine.obs._series["ttft_seconds"].extend(
        [(_Clock.t, 10.0)] * 20)
    streams += [fd.submit(prompt(6), max_new_tokens=2, priority=p)
                for p in (BATCH, NORMAL, INTERACTIVE)]
    pump()
    fd.run_until_idle()
    summary = fd.drain(flight_path=str(tmp_path / f"{mod.__name__}.jsonl"))
    drained = {r["req_id"] for r in (P_obs if mod is P else R_obs)
               .load_flight_records(summary["flight_path"])}
    streams.append(fd.submit(prompt(3), max_new_tokens=2))
    journals = {r["req_id"]: r for r in fd.engine.flight.records()}
    assert drained == set(journals) - {"shed%d" % (len(fd.shed_requests)
                                                   - 1)}
    return {
        "streams": [list(s) for s in streams],
        "tokens": [list(s.request.tokens) for s in streams],
        "reasons": [s.finish_reason for s in streams],
        "preemptions": [s.request.preemptions for s in streams],
        "shed": [(r.req_id, journals[r.req_id]["events"][-1]["reason"])
                 for r in fd.shed_requests],
        "summary": summary,
        "journals": journals,
        "registry": fd.engine.obs.registry.snapshot(),
        "stats": fd.stats(),
    }


@pytest.fixture(scope="module")
def doors(models, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("doors")
    out = {}
    patch = pytest.MonkeyPatch()
    try:
        for name, mod, obs, serve, model in (
                ("ref", R, R_obs, R_inference.serve, models[0]),
                ("port", P, P_obs, inference.serve, models[1])):
            patch.setattr(obs.ServingObs, "now", staticmethod(_Clock.now))
            _Clock.t = 50.0
            kw = dict(_KW, device="cpu") if mod is P else dict(_KW)
            fd = serve(model, policy=mod.FrontDoorPolicy(
                max_waiting=3, health_interval_s=0.0), **kw)
            out[name] = _door_trace(mod, fd, tmp)
    finally:
        patch.undo()
    return out


def test_door_streams_equal_reference(doors):
    ref, port = doors["ref"], doors["port"]
    assert port["tokens"] == ref["tokens"]
    assert port["streams"] == ref["streams"]
    assert port["reasons"] == ref["reasons"]
    assert port["preemptions"] == ref["preemptions"]
    # the streams carry exactly the emitted tokens; shed ones are empty
    for toks, stream, reason in zip(port["tokens"], port["streams"],
                                    port["reasons"]):
        assert stream == toks
        assert (reason == "shed") == (toks == [])
    assert port["preemptions"][1] == 1       # the newest BATCH gave way
    assert port["reasons"][-1] == "shed"     # submitted after the drain


def test_door_sheds_and_drain_equal_reference(doors):
    ref, port = doors["ref"], doors["port"]
    assert port["shed"] == ref["shed"]
    reasons = [r for _, r in port["shed"]]
    assert {"backpressure", "slo_critical", "draining"} <= set(reasons)
    assert port["summary"].pop("flight_path").endswith(".jsonl")
    ref["summary"].pop("flight_path")
    assert port["summary"] == ref["summary"]
    assert port["summary"]["preempted"] >= 1
    assert port["summary"]["resumed"] == port["summary"]["preempted"]
    assert port["journals"] == ref["journals"]


def test_door_registry_and_stats_equal_reference(doors):
    ref, port = doors["ref"], doors["port"]
    names = {m["name"] for m in port["registry"]["metrics"]}
    assert [m for m in ref["registry"]["metrics"] if m["name"] in names] \
        == port["registry"]["metrics"]
    for key, value in port["stats"].items():
        assert value == ref["stats"][key], key
    metrics = {m["name"]: m for m in port["registry"]["metrics"]}
    shed = metrics["serving_requests_shed_total"]["series"][0]["value"]
    assert shed == len(port["shed"])
    assert metrics["serving_drains_total"]["series"][0]["value"] == 1


# ------------------------------------------------ the port's behaviour
@pytest.fixture(scope="module")
def port_model(models):
    return models[1]


def _prompts(seed, lens):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, n).astype(np.int32) for n in lens]


def test_async_streams_equal_sync(port_model):
    prompts = _prompts(1, (5, 7, 3, 6))
    pris = (INTERACTIVE, NORMAL, BATCH, NORMAL)
    sync = inference.serve(port_model, policy=no_shed_policy(),
                           device="cpu", **_KW)
    want = [sync.submit(p, max_new_tokens=4 + i, priority=pri)
            for i, (p, pri) in enumerate(zip(prompts, pris))]
    want = [list(s) for s in want]
    fd = inference.serve(port_model, policy=no_shed_policy(), device="cpu",
                         **_KW)

    async def client(i):
        stream = fd.submit(prompts[i], max_new_tokens=4 + i,
                           priority=pris[i])
        return [tok async for tok in stream]

    async def main():
        task = asyncio.create_task(fd.run_async(idle_s=0.001))
        outs = await asyncio.gather(*(client(i) for i in range(4)))
        fd.stop()
        await asyncio.wait_for(task, timeout=60)
        return outs

    assert asyncio.run(main()) == want
    assert [len(w) for w in want] == [4, 5, 6, 7]


def test_stream_timeout_kwarg(port_model):
    fd = inference.serve(port_model, num_slots=1, block_size=4,
                         prefill_chunk=8, policy=no_shed_policy(),
                         device="cpu")
    p = _prompts(3, (5, 5, 5))
    busy = fd.submit(p[0], max_new_tokens=3)
    starved = fd.submit(p[1], max_new_tokens=1, timeout=1e-4)
    with pytest.raises(TimeoutError, match="no token"):
        list(starved)
    # per wait, not terminal: once the slot frees, the stream drains
    ok = fd.submit(p[2], max_new_tokens=1, timeout=30.0)
    assert list(busy) == busy.request.tokens
    assert len(list(starved)) + len(starved.request.tokens) >= 1
    assert len(list(ok)) == 1
    fd.drain()


def test_pump_failure_fails_open_streams(port_model, monkeypatch):
    fd = inference.serve(port_model, num_slots=2, block_size=4,
                         prefill_chunk=8, device="cpu")
    p = _prompts(5, (5, 5))
    s0 = fd.submit(p[0], max_new_tokens=1)
    s1 = fd.submit(p[1], max_new_tokens=1)

    def boom():
        raise RuntimeError("engine died")

    monkeypatch.setattr(fd.engine, "step", boom)
    with pytest.raises(RuntimeError, match="engine died"):
        list(s0)
    assert s0.closed and s1.closed
    assert s0.finish_reason == "error" and s1.finish_reason == "error"
    assert fd._streams == {}


def test_orphaned_stream_error_closes(port_model):
    fd = inference.serve(port_model, num_slots=2, block_size=4,
                         prefill_chunk=8, device="cpu")
    s = fd.submit(_prompts(6, (5,))[0], max_new_tokens=1)
    fd.engine.scheduler.waiting.remove(s.request)   # the request falls out
    assert list(s) == []
    assert s.closed and s.finish_reason == "error"


def test_serve_wiring_and_forced_critical_shedding(port_model):
    fd = inference.serve(port_model, num_slots=2, block_size=4,
                         policy=FrontDoorPolicy(health_interval_s=0.0),
                         device="cpu")
    eng = fd.engine
    assert eng.slo is not None and eng.flight is not None
    assert eng.token_sink is not None
    with pytest.raises(ValueError, match="one front door"):
        ServingFrontDoor(eng)
    now = eng.obs.now()
    eng.obs._series["ttft_seconds"].extend(
        [(now - i * 0.1, 10.0) for i in range(20)])
    assert eng.health(now=now)["state"] == "critical"
    p = np.arange(1, 6, dtype=np.int32)
    assert fd.submit(p, max_new_tokens=1, priority=BATCH).shed
    assert fd.submit(p, max_new_tokens=1, priority=NORMAL).shed
    assert not fd.submit(p, max_new_tokens=1, priority=INTERACTIVE).shed
    outcomes = eng.obs.timeseries()["request_outcomes"]
    assert [v for _, v in outcomes].count(1.0) == 2
    fd.drain()
    sampled = inference.serve(port_model, num_slots=2, block_size=4,
                              decode_strategy="sampling", top_k=4,
                              device="cpu")
    assert sampled.engine._per_request_sampling is True
    bare = ServingFrontDoor(ServingEngine(port_model, num_slots=2,
                                          block_size=4, device="cpu"))
    assert bare._health_state(bare.engine.obs.now()) == "ok"


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_preempted_stream_equals_undisturbed(port_model, prefix_cache):
    """INTERACTIVE arrivals force BATCH victims out of a pool sized for
    two requests; the victims resume by re-prefill and their streams equal
    an undisturbed engine's (f32). With the prefix cache the victims share
    their system prompt's blocks."""
    system = _prompts(8, (8,))[0]
    tails = _prompts(9, (3, 5, 4, 2))
    prompts = [np.concatenate([system, t]) for t in tails]
    kw = dict(num_slots=2, block_size=4, prefill_chunk=4, decode_quantum=2,
              num_blocks=11, prefix_cache=prefix_cache, device="cpu")
    calm = ServingEngine(port_model, **kw)
    want = [calm.submit(p, max_new_tokens=6) for p in prompts]
    calm.run()
    fd = inference.serve(port_model, policy=FrontDoorPolicy(
        shed_on_warn=(), shed_on_critical=()), **kw)
    low = [fd.submit(p, max_new_tokens=6, priority=BATCH)
           for p in prompts[:2]]
    while len(low[1].request.tokens) < 2:
        fd.pump()
    high = [fd.submit(p, max_new_tokens=6, priority=INTERACTIVE)
            for p in prompts[2:]]
    fd.run_until_idle()
    got = [s.request.tokens for s in low + high]
    assert got == [r.tokens for r in want]
    st = fd.stats()
    assert st["preempted"] >= 1 and st["resumed"] == st["preempted"]
    assert fd.engine.obs.registry.get(
        "serving_tokens_recomputed_total").value() > 0
    if prefix_cache:
        assert st["prefix_cache"]["hits"] > 0
    pool = fd.engine.pool
    assert pool.fragmentation_stats()["blocks_in_use"] == \
        1 + pool.cached_blocks


_REFUSALS = {
    "mesh": (lambda m: ServingEngine(m, mesh=object(), device="cpu"), "A7"),
    "tp": (lambda m: ServingEngine(m, tp=2, device="cpu"), "A7"),
    "cost_model": (lambda m: ServingEngine(m, cost_model=True,
                                           device="cpu"), "A8"),
}


@pytest.mark.parametrize("option", sorted(_REFUSALS))
def test_later_slices_refuse(port_model, option):
    build, item = _REFUSALS[option]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        build(port_model)


def test_drained_journal_validates(port_model, tmp_path):
    fd = inference.serve(port_model, policy=FrontDoorPolicy(max_waiting=1),
                         device="cpu", **_KW)
    p = _prompts(10, (5, 5, 5, 5))
    streams = [fd.submit(x, max_new_tokens=2, priority=pri)
               for x, pri in zip(p, (NORMAL, NORMAL, BATCH, INTERACTIVE))]
    # nothing admits before a pump: the second submission finds one
    # waiting and is shed; INTERACTIVE is exempt
    assert [s.shed for s in streams] == [False, True, True, False]
    out = fd.drain(flight_path=str(tmp_path / "flight.jsonl"))
    assert out["completed"] == 2 and out["shed"] == 2
    assert [len(s.request.tokens) for s in streams] == [2, 0, 0, 2]
    records = load_flight_records(tmp_path / "flight.jsonl")
    shed = [r for r in records if r["events"][-1]["kind"] == "shed"]
    assert [r["events"][-1]["reason"] for r in shed] == ["backpressure"] * 2
    assert json.loads(json.dumps(fd.stats()))["draining"] is True
