"""The port's resilience tier (``paddle_tpu_torch.serving`` faults,
resilience, soak, the engine's snapshot / restore) held against
``paddle_tpu.serving``'s.

Units: the same calls drive both packages' injector, watchdog and policy;
journals, deadlines, trips and refusals must be equal. The in-place bit
flip of a cached block is held against the reference's copy-and-replace on
float32, bfloat16 and int8 pools, for the seeds where the reference's int8
flip works and where it raises.

Engine scenarios: the tiny Llama in f32, weights carried across with
``load_paddle_tpu_arrays``, the reference's three-request workload
(prompts 5 / 9 / 3, max_new 6 / 4 / 8), both packages' obs clocks patched
to one clock the test advances between the halves of each step. For each
scenario (transient retry, skip and pool rebuild; the poison bisect and
quarantine; the watchdog on a slow dispatch; the speculative fallback; the
cached-prefix bit flip; snapshot / restore) the streams, finish reasons,
``resilience_report()``, the injector's journal, the registry (restricted
to the port's names) and the flight journals must be EQUAL. The soak's
report (``run_soak(rounds=12, seed=4)``) must equal the reference's.
"""
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.obs as R_obs
import paddle_tpu.serving as R
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp.paged_cache import PagedKVCachePool as RefPool
from paddle_tpu.serving.soak import run_soak as ref_run_soak
import paddle_tpu_torch.obs as P_obs
import paddle_tpu_torch.serving as P
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  PagedKVCachePool,
                                  load_paddle_tpu_arrays)

# the reference's instruments that come with a later slice (ROADMAP A7)
_LATER = {"serving_collective_bytes_total", "serving_collective_count_total"}


def _nosleep(_s):
    return None


class _Clock:
    """The obs clock both packages read; the test advances it."""
    t = 100.0

    @classmethod
    def now(cls):
        return cls.t

    @classmethod
    def sleep(cls, s):
        cls.t += s


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    ref = RefLM(RefConfig.tiny(tensor_parallel=False))
    ref.eval()
    paddle.seed(11)
    ref_draft = RefLM(RefConfig.tiny(tensor_parallel=False,
                                     num_hidden_layers=1))
    ref_draft.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                            device="cpu")
    load_paddle_tpu_arrays(
        port, {k: v.numpy() for k, v in ref.state_dict().items()})
    port_draft = LlamaForCausalLM(
        LlamaConfig.tiny(tensor_parallel=False, num_hidden_layers=1),
        device="cpu")
    load_paddle_tpu_arrays(
        port_draft, {k: v.numpy() for k, v in ref_draft.state_dict().items()})
    return {"ref": (ref, ref_draft), "port": (port, port_draft)}


def _workload():
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in (5, 9, 3)]
    return prompts, [6, 4, 8]


# ------------------------------------------------ units
def _drive_injector(mod, seed):
    inj = mod.FaultInjector(
        plan=[mod.FaultSpec("decode", "raise", p=0.4),
              mod.FaultSpec("alloc", "alloc_fail", p=0.3, times=2),
              mod.FaultSpec("mixed", "slow", p=0.2, sleep_s=0.5)],
        seed=seed, sleep=_nosleep)
    raised = []
    for i in range(40):
        for site in ("decode", "mixed"):
            try:
                inj.before_dispatch(site, [f"r{i % 3}"])
            except mod.InjectedFault as e:
                raised.append((i, e.site, e.kind, str(e)))
        try:
            inj.on_alloc(None)
        except mod.InjectedFault as e:
            raised.append((i, e.site, e.kind, str(e)))
    inj.poison("bad")
    try:
        inj.before_dispatch("decode", ["ok", "bad"])
    except mod.InjectedFault as e:
        raised.append(("poison", e.poison, str(e)))
    armed = inj.armed
    inj.cure("bad")
    inj.before_dispatch("spec_round", ["ok", "bad"])
    return inj, raised, armed


@pytest.mark.parametrize("seed", [7, 8])
def test_injector_journal_equals_reference(seed):
    port, p_raised, p_armed = _drive_injector(P, seed)
    ref, r_raised, r_armed = _drive_injector(R, seed)
    assert port.journal and port.journal == ref.journal
    assert p_raised == r_raised and p_armed == r_armed
    assert port.stats() == ref.stats()
    assert sum(1 for j in port.journal if j["site"] == "alloc") == 2
    off = P.FaultInjector()
    assert not off.armed
    off.before_dispatch("decode", ["r0"])
    off.on_alloc(None)
    assert off.maybe_corrupt(None) is None
    assert off.journal == [] and off.stats() == R.FaultInjector().stats()


@pytest.mark.parametrize("bad", [("gpu", "raise"), ("decode", "explode")])
def test_fault_spec_refusals_equal_reference(bad):
    errors = []
    for mod in (P, R):
        with pytest.raises(ValueError) as e:
            mod.FaultSpec(*bad)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert repr(P.FaultSpec("kv", "bit_flip", p=0.5, times=3)) == \
        repr(R.FaultSpec("kv", "bit_flip", p=0.5, times=3))


def _watchdog_ops(mod):
    wd = mod.QuantumWatchdog(mod.ResiliencePolicy(
        min_samples=4, min_deadline_s=0.001, deadline_margin=2.0,
        sleep=_nosleep))
    out = []
    for dt in (0.010, 0.012, 0.011, 0.010, 10.0, 0.02, 0.5):
        out.append((wd.deadline("decode"), wd.check("decode", dt)))
    out.append(wd.check("mixed", 10.0))
    out.append(wd.stats())
    pol = mod.ResiliencePolicy(backoff_base_s=0.01, backoff_mult=2.0)
    out.append([pol.backoff_s(i) for i in range(4)])
    return out


def test_watchdog_and_policy_equal_reference():
    port, ref = _watchdog_ops(P), _watchdog_ops(R)
    assert port == ref
    assert port[3][0] is None and port[4][0] is not None and port[4][1]
    for kw in (dict(max_retries=-1), dict(spec_fault_threshold=0)):
        msgs = []
        for mod in (P, R):
            with pytest.raises(ValueError) as e:
                mod.ResiliencePolicy(**kw)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def _cached_pools(kv_dtype, dtype, prompt):
    """A reference pool and a port pool holding the same cached-only
    blocks with the same content."""
    nb, bs, hk, d = 8, 4, 2, 16
    ref = RefPool(nb, bs, hk, d, num_layers=2, dtype=getattr(jnp, dtype),
                  prefix_cache=True, kv_dtype=kv_dtype)
    port = PagedKVCachePool(nb, bs, hk, d, num_layers=2,
                            dtype=getattr(torch, dtype), prefix_cache=True,
                            kv_dtype=kv_dtype, device="cpu")
    rng = np.random.RandomState(1)
    for pool in (ref, port):
        pool.ensure("a", len(prompt))
        pool.publish_prefix("a", prompt)
        pool.free("a")
    shape = (nb, bs, hk, d)
    if kv_dtype == "int8":
        k0 = rng.randint(-127, 128, shape).astype(np.int8)
    else:
        k0 = rng.standard_normal(shape).astype(np.float32)
    ref.k_pools[0] = ref._pin(jnp.asarray(k0).astype(ref.k_pools[0].dtype))
    port.k_pools[0].copy_(torch.from_numpy(k0).to(port.k_pools[0].dtype))
    return ref, port


def _pool_bytes(t):
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


@pytest.mark.parametrize("kv_dtype,dtype,seed", [
    (None, "float32", 0), (None, "float32", 5), (None, "bfloat16", 3),
    ("int8", "float32", 0), ("int8", "float32", 1), ("int8", "float32", 2),
    ("int8", "float32", 6)])
def test_bit_flip_in_place_equals_reference(kv_dtype, dtype, seed):
    """The port flips the bit IN PLACE (the pool tensor keeps its address)
    and lands on the same block, element and bit as the reference's
    copy-and-replace; on an int8 pool it raises where the reference's
    32-bit view runs out, as the reference does (ROADMAP queue C)."""
    prompt = np.arange(1, 13, dtype=np.int32)
    ref, port = _cached_pools(kv_dtype, dtype, prompt)
    addr = port.k_pools[0].data_ptr()
    plan = [("kv", "bit_flip")]
    r_inj = R.FaultInjector(plan=plan, seed=seed)
    p_inj = P.FaultInjector(plan=plan, seed=seed)
    outcomes = []
    for inj, pool in ((r_inj, ref), (p_inj, port)):
        try:
            outcomes.append(("flip", inj.maybe_corrupt(pool)))
        except IndexError as e:
            outcomes.append(("raise", str(e)))
    assert outcomes[0] == outcomes[1]
    assert p_inj.journal == r_inj.journal
    assert port.k_pools[0].data_ptr() == addr
    assert _pool_bytes(port.k_pools[0]) == _pool_bytes(ref.k_pools[0])
    if outcomes[1][0] == "flip":
        assert p_inj.journal[-1]["block"] == outcomes[1][1]


def test_int8_bit_flip_raises_for_most_elements():
    """Of the seeds above, the int8 flip works for some and raises for
    others (an element index past a quarter of the block)."""
    got = set()
    prompt = np.arange(1, 13, dtype=np.int32)
    for seed in range(8):
        _, port = _cached_pools("int8", "float32", prompt)
        try:
            P.FaultInjector(plan=[("kv", "bit_flip")],
                            seed=seed).maybe_corrupt(port)
            got.add("flip")
        except IndexError:
            got.add("raise")
    assert got == {"flip", "raise"}


# ------------------------------------------------ engine scenarios
def _ns(name, models):
    mod, obs = (P, P_obs) if name == "port" else (R, R_obs)
    model, draft = models[name]
    kw = {"device": "cpu"} if name == "port" else {}
    return types.SimpleNamespace(S=mod, O=obs, model=model, draft=draft,
                                 kw=kw)


def _flight(ns):
    # every journal captures: the records are the whole journal table
    return ns.O.FlightRecorder(ttft_threshold=1e-9, e2e_threshold=1e-9)


def _drive(eng, until=None):
    """Step until idle (or ``until()``), the clock moving 0.125 s across
    each dispatch and 0.25 s between steps."""
    while eng.has_work and not (until is not None and until()):
        pending = eng.step_dispatch()
        _Clock.t += 0.125
        eng.step_collect(pending)
        _Clock.t += 0.25


def _sc_transient(ns):
    prompts, max_new = _workload()
    slept = []
    inj = ns.S.FaultInjector(
        plan=[ns.S.FaultSpec("decode", "raise", times=2),
              ns.S.FaultSpec("alloc", "alloc_fail", times=1)], seed=3)
    eng = ns.S.ServingEngine(
        ns.model, num_slots=3, block_size=4, prefill_chunk=4,
        decode_quantum=3, faults=inj, flight=_flight(ns),
        resilience=ns.S.ResiliencePolicy(max_retries=3, sleep=slept.append),
        **ns.kw)
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    for _ in range(4):
        pending = eng.step_dispatch()
        eng.step_collect(pending)
    # drift: a mapped block's refcount entry deleted mid-run
    mapped = [b for s, t in eng.pool._tables.items()
              if s != "__scratch__" for b in t]
    del eng.pool._refcounts[mapped[0]]
    _drive(eng)
    return eng, inj, reqs, {"slept": slept}


def _sc_poison(ns):
    prompts, max_new = _workload()
    inj = ns.S.FaultInjector(seed=0)
    eng = ns.S.ServingEngine(
        ns.model, num_slots=3, block_size=4, prefill_chunk=4,
        decode_quantum=3, faults=inj, flight=_flight(ns),
        resilience=ns.S.ResiliencePolicy(sleep=_nosleep), **ns.kw)
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    _drive(eng, until=lambda: len(reqs[1].tokens) >= 1)
    inj.poison(reqs[1].req_id)
    _drive(eng)
    return eng, inj, reqs, {"poisoned": sorted(inj.poisoned),
                            "victim": str(reqs[1].req_id)}


def _sc_watchdog(ns):
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, 128, 5).astype(np.int32)
    inj = ns.S.FaultInjector(
        plan=[ns.S.FaultSpec("decode", "slow", sleep_s=0.12)], seed=0,
        sleep=_Clock.sleep)
    eng = ns.S.ServingEngine(
        ns.model, num_slots=2, block_size=4, prefill_chunk=8,
        decode_quantum=1, faults=inj, flight=_flight(ns),
        resilience=ns.S.ResiliencePolicy(min_samples=1, min_deadline_s=0.05,
                                         deadline_margin=0.01,
                                         sleep=_nosleep), **ns.kw)
    reqs = [eng.submit(prompt, max_new_tokens=5)]
    _drive(eng)
    return eng, inj, reqs, {}


def _sc_spec_disable(ns):
    prompts, max_new = _workload()
    inj = ns.S.FaultInjector(
        plan=[ns.S.FaultSpec("spec_round", "raise", times=2)], seed=0)
    eng = ns.S.ServingEngine(
        ns.model, spec_draft=ns.draft, spec_gamma=2, num_slots=2,
        block_size=4, prefill_chunk=8, decode_quantum=4, max_context=254,
        faults=inj, flight=_flight(ns),
        resilience=ns.S.ResiliencePolicy(max_retries=0,
                                         spec_fault_threshold=2,
                                         sleep=_nosleep), **ns.kw)
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts[:2], max_new[:2])]
    _drive(eng)
    return eng, inj, reqs, {
        "draft_in_use": eng.d_pool.fragmentation_stats()["blocks_in_use"]}


def _prefix_prompts():
    rng = np.random.RandomState(9)
    prefix = rng.randint(1, 128, 12).astype(np.int32)
    tails = [rng.randint(1, 128, 4).astype(np.int32) for _ in range(5)]
    return [np.concatenate([prefix, t]) for t in tails]


def _sc_prefix_flip(ns):
    prompts = _prefix_prompts()
    inj = ns.S.FaultInjector(plan=[ns.S.FaultSpec("kv", "bit_flip",
                                                  times=1)], seed=2)
    eng = ns.S.ServingEngine(
        ns.model, num_slots=2, block_size=4, prefill_chunk=4,
        decode_quantum=2, prefix_cache=True, faults=inj, flight=_flight(ns),
        resilience=ns.S.ResiliencePolicy(sleep=_nosleep), **ns.kw)
    reqs = [eng.submit(p, max_new_tokens=4) for p in prompts[:4]]
    _drive(eng)
    flipped = any("block" in j for j in inj.journal)
    reqs.append(eng.submit(prompts[4], max_new_tokens=4))
    _drive(eng)
    return eng, inj, reqs, {"flipped": flipped,
                            "pool_quarantines": eng.pool.prefix_quarantines}


def _sc_snapshot(ns):
    prompts, max_new = _workload()
    eng = ns.S.ServingEngine(
        ns.model, num_slots=3, block_size=4, prefill_chunk=4,
        decode_quantum=3, resilience=ns.S.ResiliencePolicy(sleep=_nosleep),
        **ns.kw)
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
    _drive(eng, until=lambda: len(reqs[0].tokens) >= 2)
    pre = {str(r.req_id): list(r.tokens) for r in eng.completed}
    snap = json.loads(json.dumps(eng.snapshot()))
    eng2 = ns.S.ServingEngine.restore(
        snap, ns.model, resilience=ns.S.ResiliencePolicy(sleep=_nosleep),
        flight=_flight(ns), **ns.kw)
    _drive(eng2)
    done = dict(pre)
    done.update({str(r.req_id): list(r.tokens) for r in eng2.completed})
    return eng2, eng2.faults, reqs, {
        "snapshot": snap, "done": done, "ids": [str(r.req_id) for r in reqs],
        "finished": eng2.scheduler.finished_total,
        "restored_reasons": {str(r.req_id): r.finish_reason
                             for r in eng2.completed}}


_SCENARIOS = {"transient": _sc_transient, "poison": _sc_poison,
              "watchdog": _sc_watchdog, "spec_disable": _sc_spec_disable,
              "prefix_flip": _sc_prefix_flip, "snapshot": _sc_snapshot}


def _run_both(models, scenario):
    out = {}
    patch = pytest.MonkeyPatch()
    try:
        for name in ("ref", "port"):
            ns = _ns(name, models)
            patch.setattr(ns.O.ServingObs, "now", staticmethod(_Clock.now))
            _Clock.t = 100.0
            eng, inj, reqs, extra = _SCENARIOS[scenario](ns)
            out[name] = {
                "streams": [list(r.tokens) for r in reqs],
                "reasons": [r.finish_reason for r in reqs],
                "report": eng.resilience_report(),
                "journal": list(inj.journal),
                "registry": eng.obs.registry.snapshot(),
                "flight": (eng.flight.records()
                           if eng.flight is not None else None),
                "in_use": eng.pool.fragmentation_stats()["blocks_in_use"],
                "cached": eng.pool.cached_blocks,
                "extra": extra, "engine": eng}
    finally:
        patch.undo()
    return out


def _restricted(ref_snap, port_snap):
    names = {m["name"] for m in port_snap["metrics"]}
    extra = {m["name"] for m in ref_snap["metrics"]} - names
    assert extra <= _LATER, extra
    return {"version": ref_snap["version"],
            "metrics": [m for m in ref_snap["metrics"] if m["name"] in names]}


def _check_transient(port):
    rep = port["report"]
    assert rep["retries_total"] == 2 and rep["step_skips"] >= 1
    assert rep["pool_rebuilds"] == 1
    assert port["extra"]["slept"] == [0.01, 0.02]
    reg = port["engine"].obs.registry
    assert reg.get("serving_quantum_retries_total").value(kind="decode") == 2
    assert reg.get("serving_faults_injected_total").value(
        site="alloc", kind="alloc_fail") == 1
    assert reg.get("serving_degraded_mode").value(mode="pool_rebuild") == 1.0
    assert port["reasons"] == ["length"] * 3


def _check_poison(port):
    assert port["reasons"] == ["length", "error", "length"]
    assert port["report"]["quarantined"] == [port["extra"]["victim"]]
    assert port["extra"]["poisoned"] == []
    assert port["engine"].obs.registry.get(
        "serving_quarantines_total").value(kind="poison") == 1


def _check_watchdog(port):
    assert port["report"]["watchdog"]["trips"].get("decode", 0) >= 1
    assert port["engine"].obs.registry.get(
        "serving_watchdog_trips_total").value(kind="decode") >= 1


def _check_spec_disable(port):
    rep = port["report"]
    assert rep["spec_disabled"] and rep["spec_faults"] >= 2
    assert port["reasons"] == ["length", "length"]
    assert port["engine"].obs.registry.get("serving_degraded_mode").value(
        mode="spec_disabled") == 1.0
    assert port["extra"]["draft_in_use"] == 1


def _check_prefix_flip(port):
    assert port["extra"]["flipped"]
    assert port["report"]["prefix_quarantines"] >= 1
    assert port["extra"]["pool_quarantines"] >= 1
    assert port["engine"].obs.registry.get(
        "serving_quarantines_total").value(kind="prefix") >= 1


def _check_snapshot(port):
    snap = port["extra"]["snapshot"]
    assert snap["kind"] == "serving_engine_snapshot"
    assert port["extra"]["finished"] == len(snap["inflight"])
    kinds = {e["kind"] for r in port["flight"] for e in r["events"]}
    assert "restore" in kinds


_CHECKS = {"transient": _check_transient, "poison": _check_poison,
           "watchdog": _check_watchdog, "spec_disable": _check_spec_disable,
           "prefix_flip": _check_prefix_flip, "snapshot": _check_snapshot}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_scenario_equals_reference(models, scenario):
    out = _run_both(models, scenario)
    ref, port = out["ref"], out["port"]
    for key in ("streams", "reasons", "report", "journal", "flight",
                "in_use", "cached"):
        assert port[key] == ref[key], key
    assert port["registry"] == _restricted(ref["registry"], port["registry"])
    for key in ("slept", "poisoned", "victim", "flipped", "pool_quarantines",
                "draft_in_use", "snapshot", "done", "ids", "finished",
                "restored_reasons"):
        if key in port["extra"]:
            assert port["extra"][key] == ref["extra"][key], key
    assert port["in_use"] == 1 + port["cached"]
    _CHECKS[scenario](port)
    # the port's streams against its own fault-free engine
    clean = P.ServingEngine(
        models["port"][0], num_slots=3, block_size=4, prefill_chunk=4,
        decode_quantum=3, device="cpu")
    if scenario == "prefix_flip":
        prompts, max_new = _prefix_prompts(), [4] * 5
    elif scenario == "watchdog":
        prompts = [np.random.RandomState(5).randint(1, 128, 5)
                   .astype(np.int32)]
        max_new = [5]
    else:
        prompts, max_new = _workload()
    want = [clean.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, max_new)]
    clean.run()
    if scenario == "snapshot":
        got = [port["extra"]["done"][i] for i in port["extra"]["ids"]]
    else:
        got = port["streams"]
    for i, (g, w) in enumerate(zip(got, want)):
        if port["reasons"][i] != "error":
            assert g == w.tokens, (scenario, i)


def test_restore_refuses_a_foreign_payload(models):
    msgs = []
    for name in ("ref", "port"):
        ns = _ns(name, models)
        for cls in (ns.S.ServingEngine, ns.S.ServingFrontDoor):
            with pytest.raises(ValueError, match="snapshot") as e:
                cls.restore({"kind": "nope"}, ns.model, **ns.kw)
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:]


def test_front_door_restore_resumes_streams(models):
    """``ServingFrontDoor.restore`` after a JSON round trip: each in-flight
    request's fresh stream holds its tokens emitted before the snapshot,
    and every stream completes equal to an uninterrupted door's."""
    from paddle_tpu_torch.inference import serve

    model = models["port"][0]
    prompts, max_new = _workload()
    kw = dict(num_slots=3, block_size=4, prefill_chunk=4, decode_quantum=3,
              device="cpu")
    plain = serve(model, policy=P.no_shed_policy(), **kw)
    want = [plain.submit(p, max_new_tokens=m) for p, m in zip(prompts,
                                                              max_new)]
    want = [list(s) for s in want]
    fd = serve(model, policy=P.no_shed_policy(), **kw)
    streams = [fd.submit(p, max_new_tokens=m)
               for p, m in zip(prompts, max_new)]
    while len(streams[0].request.tokens) < 2:
        fd.pump()
    before = {str(s.request.req_id): list(s.request.tokens)
              for s in streams}
    snap = json.loads(json.dumps(fd.snapshot()))
    fd2 = P.ServingFrontDoor.restore(snap, model, policy=P.no_shed_policy(),
                                     slo=True, flight=True, device="cpu")
    restored = fd2._streams
    assert set(restored) == {st["req_id"] for st in snap["inflight"]}
    for rid, stream in restored.items():
        assert list(stream._buf) == before[rid]
    fd2.run_until_idle()
    got = {str(r.req_id): list(r.tokens) for r in fd2.engine.completed}
    for s, w in zip(streams, want):
        rid = str(s.request.req_id)
        assert (got[rid] if rid in got else list(s.request.tokens)) == w
    reg = fd2.engine.obs.registry
    assert reg.get("serving_restores_total").value() == 1


def test_probe_leaves_excluded_rows_unchanged(models):
    """A bisect probe dispatches one quantum with the other rows staged
    done: their lengths, mirrors and pool rows come out unchanged, and
    their done flags are restored."""
    model = models["port"][0]
    prompts, max_new = _workload()
    eng = P.ServingEngine(model, num_slots=3, block_size=4, prefill_chunk=4,
                          decode_quantum=3, device="cpu",
                          resilience=P.ResiliencePolicy(sleep=_nosleep))
    reqs = [eng.submit(p, max_new_tokens=m + 6)
            for p, m in zip(prompts, max_new)]
    while not all(r.slot is not None and not eng.scheduler.prefilling()
                  for r in reqs):
        eng.step()
    rows = eng.scheduler.decoding()
    assert len(rows) == 3
    keep, out = rows[:1], rows[1:]
    slots = [r.slot for r in out]
    before = {k: getattr(eng, "_" + k)[slots].copy()
              for k in ("seq_lens", "last_tok", "n_gen", "done")}
    k_before = [t.clone() for t in eng.pool.k_pools]
    tokens_before = [list(r.tokens) for r in out]
    kept_len = int(eng._seq_lens[keep[0].slot])
    addrs = eng._pool_ptrs()
    assert eng._probe(keep) is False
    for k, v in before.items():
        np.testing.assert_array_equal(getattr(eng, "_" + k)[slots], v)
    assert [list(r.tokens) for r in out] == tokens_before
    assert int(eng._seq_lens[keep[0].slot]) == kept_len + 3
    for r in out:
        for blk in eng.pool._tables[r.req_id]:
            for t, tb in zip(eng.pool.k_pools, k_before):
                assert torch.equal(t[blk], tb[blk])
    assert eng._pool_ptrs() == addrs


def test_default_engine_stays_disarmed(models):
    """A default engine: a disarmed injector, no policy, no watchdog, no
    checksums; its streams equal a resilience=True engine's."""
    model = models["port"][0]
    prompts, max_new = _workload()
    runs = []
    for res in (None, True):
        eng = P.ServingEngine(model, num_slots=3, block_size=4,
                              prefill_chunk=4, decode_quantum=3,
                              prefix_cache=True, resilience=res,
                              multi_quantum=2, device="cpu")
        reqs = [eng.submit(p, max_new_tokens=m)
                for p, m in zip(prompts, max_new)]
        eng.run()
        runs.append(([list(r.tokens) for r in reqs], eng))
    (plain, d), (armed, r) = runs
    assert plain == armed
    assert not d.faults.armed and d.resilience is None and d.watchdog is None
    assert not d.pool.kv_checksums and r.pool.kv_checksums
    assert d.resilience_report()["faults"]["journal_len"] == 0
    assert d.engine_stats()["resilience"] == d.resilience_report()


# ------------------------------------------------ the soak
@pytest.fixture(scope="module")
def ref_soak(models):
    return ref_run_soak(models["ref"][0], rounds=12, seed=4)


def test_soak_report_equals_reference(models, ref_soak):
    rep = P.run_soak(models["port"][0], rounds=12, seed=4, device="cpu")
    assert rep == ref_soak
    assert rep["faults_injected"] > 0 and rep["poisoned"]
    assert rep["bitexact_streams"] == rep["requests"] - len(rep["poisoned"])
    subs, plan = P.soak_plan(4, 12, 128)
    r_subs, r_plan = R.soak.soak_plan(4, 12, 128)
    assert [repr(s) for s in plan] == [repr(s) for s in r_plan]
    assert len(subs) == len(r_subs) == rep["requests"]
