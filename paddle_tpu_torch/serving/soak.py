"""Seeded chaos soak of the resilience tier (counterpart of
``paddle_tpu/serving/soak.py``): faults x speculative decoding x preemption
x copy-on-write prefix sharing, replayable from its seed.

:func:`run_soak` drives TWO engines over the SAME seeded workload:

- the CLEAN arm runs fault-free and gives the reference streams;
- the FAULTED arm runs the same submissions under an armed
  :class:`~paddle_tpu_torch.serving.FaultInjector` (transient raises, slow
  dispatches, allocation failures, cached-KV bit flips, poisons) and seeded
  preemptions, with the resilience tier containing everything.

Greedy rows do not depend on the batch, and recompute-on-resume continues a
stream exactly, so every NON-POISONED request of the faulted arm must equal
the clean arm's (in f32 on the card, where the mixed batches' composition
does not move cuBLAS's rounding of a row; in bf16 it can). Every request
must end with a definite ``finish_reason``, and the pools must leak nothing
(blocks in use at drain == the scratch block + the prefix index's blocks).
Any failure replays from ``seed`` alone.
"""
from __future__ import annotations

import numpy as np

from .engine import ServingEngine
from .faults import FaultInjector, FaultSpec
from .resilience import ResiliencePolicy

__all__ = ["soak_plan", "run_soak"]

# block-aligned tail lengths: ragged enough to exercise COW + chunked
# prefill, few enough distinct mixed-step shapes that the CPU soak's
# compile count stays bounded (every combo amortizes over the run)
_PROMPT_LENS = (4, 8)


def _no_sleep(_s):
    return None


def soak_plan(seed, rounds, vocab_size, spec=False):
    """The seeded workload + fault plan: a list of per-round
    submissions (round, req_id, prompt, max_new, poison) and the
    injector's :class:`FaultSpec` list. Pure function of the
    arguments — the replay contract."""
    rng = np.random.RandomState(seed)
    prefix = rng.randint(1, vocab_size, 8).astype(np.int32)
    subs = []
    i = 0
    for rnd in range(rounds):
        n_new = int(rng.random() < 0.7)
        for _ in range(n_new):
            tail_len = int(_PROMPT_LENS[rng.randint(len(_PROMPT_LENS))])
            tail = rng.randint(1, vocab_size, tail_len).astype(np.int32)
            shared = bool(rng.random() < 0.5)
            prompt = (np.concatenate([prefix, tail]) if shared
                      else tail)
            subs.append({
                "round": rnd,
                "req_id": f"soak-{i}",
                "prompt": prompt,
                "max_new": int(rng.randint(3, 9)),
                "poison": bool(rng.random() < 0.06),
            })
            i += 1
    plan = [
        FaultSpec("decode", "raise", p=0.05),
        FaultSpec("mixed", "raise", p=0.03),
        FaultSpec("alloc", "alloc_fail", p=0.03),
        FaultSpec("kv", "bit_flip", p=0.10),
        FaultSpec("decode", "slow", p=0.02, sleep_s=0.001),
    ]
    if spec:
        plan.append(FaultSpec("spec_round", "raise", p=0.05))
    return subs, plan


def _drain(engine, budget=10000):
    steps = 0
    while engine.step():
        steps += 1
        if steps > budget:
            raise RuntimeError("soak engine failed to drain")
    return steps


def _expected_residency(pool):
    # scratch block + whatever the prefix index still holds
    return 1 + int(getattr(pool, "cached_blocks", 0))


def run_soak(model, spec_draft=None, rounds=50, seed=0, num_slots=3,
             block_size=4, prefill_chunk=4, decode_quantum=3,
             prefix_cache=True, device=None):
    """Run the two-arm chaos soak; returns the report dict and raises
    ``AssertionError`` on any breach. The same (model, arguments, seed)
    give the same faults, streams and report. ``device`` is the engines'
    (default ``cuda``; the models must lie there)."""
    vocab = int(model.config.vocab_size)
    subs, plan = soak_plan(seed, rounds, vocab,
                           spec=spec_draft is not None)
    kwargs = dict(num_slots=num_slots, block_size=block_size,
                  prefill_chunk=prefill_chunk,
                  decode_quantum=decode_quantum,
                  prefix_cache=prefix_cache, obs="off", device=device)

    # clean arm: greedy rows do not depend on the batch, so one drained
    # run over the whole submission list is the per-request reference
    clean = ServingEngine(model, spec_draft=spec_draft, **kwargs)
    for s in subs:
        clean.submit(s["prompt"], max_new_tokens=s["max_new"],
                     req_id=s["req_id"])
    clean.run()
    want = {r.req_id: list(r.tokens) for r in clean.completed}
    assert clean.pool.fragmentation_stats()["blocks_in_use"] == \
        _expected_residency(clean.pool), "clean arm leaked blocks"

    # faulted arm: same submissions on their scheduled rounds, armed
    # injector + resilience, seeded mid-flight preemptions
    inj = FaultInjector(plan=plan, seed=seed, sleep=_no_sleep)
    pol = ResiliencePolicy(max_retries=2, sleep=_no_sleep,
                           spec_fault_threshold=4)
    eng = ServingEngine(model, spec_draft=spec_draft, faults=inj,
                        resilience=pol, **kwargs)
    chaos = np.random.RandomState(seed + 1)
    reqs = {}
    cursor = 0
    for rnd in range(rounds):
        while cursor < len(subs) and subs[cursor]["round"] <= rnd:
            s = subs[cursor]
            req = eng.submit(s["prompt"], max_new_tokens=s["max_new"],
                             req_id=s["req_id"])
            reqs[s["req_id"]] = req
            if s["poison"]:
                inj.poison(req.req_id)
            cursor += 1
        for _ in range(1 + int(chaos.random() < 0.4)):
            eng.step()
        if chaos.random() < 0.12:
            live = [r for r in eng.scheduler.live()
                    if not r.finished and r.slot is not None]
            if live:
                eng.preempt(live[int(chaos.randint(len(live)))])
    drain_steps = _drain(eng)

    poisoned = {s["req_id"] for s in subs if s["poison"]}
    mismatches = []
    for s in subs:
        rid = s["req_id"]
        req = reqs[rid]
        assert req.finished, f"{rid} never finished"
        assert req.finish_reason in ("eos", "stop", "length", "error"), \
            f"{rid} indefinite finish_reason {req.finish_reason!r}"
        if rid in poisoned:
            continue
        assert req.finish_reason != "error", \
            f"non-poisoned {rid} quarantined"
        if list(req.tokens) != want[rid]:
            mismatches.append(rid)
    assert not mismatches, \
        f"non-poisoned streams diverged from clean arm: {mismatches}"
    in_use = eng.pool.fragmentation_stats()["blocks_in_use"]
    assert in_use == _expected_residency(eng.pool), \
        f"faulted arm leaked blocks: {in_use} in use"
    if eng.d_pool is not None:
        d_use = eng.d_pool.fragmentation_stats()["blocks_in_use"]
        assert d_use == _expected_residency(eng.d_pool), \
            f"draft pool leaked blocks: {d_use} in use"

    rep = eng.resilience_report()
    return {
        "seed": seed,
        "rounds": rounds,
        "requests": len(subs),
        "poisoned": sorted(poisoned),
        "quarantined": rep["quarantined"],
        "faults_injected": rep["faults"]["injected_total"],
        "retries": rep["retries_total"],
        "step_skips": rep["step_skips"],
        "spec_disabled": rep["spec_disabled"],
        "pool_rebuilds": rep["pool_rebuilds"],
        "prefix_quarantines": rep["prefix_quarantines"],
        "preemptions": eng.scheduler.preempted_total,
        "drain_steps": drain_steps,
        "bitexact_streams": len(subs) - len(poisoned),
        "journal_len": len(inj.journal),
    }
