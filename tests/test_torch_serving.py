"""The slice as a whole: the port's serving engine held against paddle_tpu's
``ServingEngine`` on the same carried weights (``LlamaConfig.tiny``, f32).

The trace is tests/test_serving.py's ragged greedy oracle: 5 ragged
requests over 3 slots (block size 4, prefill chunk 4, decode quantum 3),
request 0 preempted mid-decode and resumed by re-prefill, request 4
stopped by a stop token; plus an eos run. Greedy token streams, finish
reasons, scheduler counters, engine counters and pool statistics must be
EQUAL (f32 on both sides, so argmax near-ties cannot excuse a mismatch).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu_torch import create_serving_engine
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.serving import ServingEngine

_COUNTERS = ("steps", "mixed_steps", "decode_quanta", "quantum_tokens",
             "prefill_tokens", "generated_tokens", "admitted", "finished",
             "preempted", "resumed")


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


def _ragged_trace(engine, prompts, max_new, stop_tok):
    reqs = [engine.submit(p, max_new_tokens=mn,
                          stop_token_ids=[stop_tok] if i == 4 else None)
            for i, (p, mn) in enumerate(zip(prompts, max_new))]
    while len(reqs[0].tokens) < 2:
        engine.step()
    engine.preempt(reqs[0])
    engine.run()
    return reqs


@pytest.fixture(scope="module")
def ragged(models):
    ref_model, port_model = models
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 128, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7)]
    max_new = [6, 4, 8, 5, 7]
    kw = dict(num_slots=3, block_size=4, prefill_chunk=4, decode_quantum=3)
    # request 4 stops at the 3rd token it would otherwise generate
    probe = create_serving_engine(port_model, device="cpu", **kw)
    probe_reqs = [probe.submit(p, max_new_tokens=mn)
                  for p, mn in zip(prompts, max_new)]
    probe.run()
    stop_tok = probe_reqs[4].tokens[2]
    ref_engine = RefEngine(ref_model, **kw)
    port_engine = create_serving_engine(port_model, device="cpu", **kw)
    out = {}
    for name, engine in (("ref", ref_engine), ("port", port_engine)):
        out[name] = (engine, _ragged_trace(engine, prompts, max_new,
                                           stop_tok))
    return out


def test_ragged_streams_equal_reference(ragged):
    ref_engine, ref_reqs = ragged["ref"]
    port_engine, port_reqs = ragged["port"]
    for r, p in zip(ref_reqs, port_reqs):
        np.testing.assert_array_equal(port_engine.output_tokens(p),
                                      ref_engine.output_tokens(r))
        assert p.finish_reason == r.finish_reason
        assert p.preemptions == r.preemptions
    assert port_reqs[4].finish_reason == "stop"
    assert port_reqs[0].preemptions == 1
    assert [r.finish_reason for r in port_reqs].count("length") == 4


def test_ragged_counters_equal_reference(ragged):
    ref_st = ragged["ref"][0].engine_stats()
    port_st = ragged["port"][0].engine_stats()
    for key in _COUNTERS:
        assert port_st[key] == ref_st[key], key
    assert port_st["preempted"] == 1 and port_st["resumed"] == 1
    assert port_st["decode_quanta"] > 0 and port_st["mixed_steps"] > 0
    assert port_st["mean_occupancy"] == pytest.approx(
        ref_st["mean_occupancy"])


def test_ragged_pool_stats_equal_reference(ragged):
    ref_engine = ragged["ref"][0]
    port_engine = ragged["port"][0]
    st = port_engine.pool.fragmentation_stats()
    assert st == ref_engine.pool.fragmentation_stats()
    assert st["blocks_in_use"] == 1     # only the engine scratch block
    assert st["blocks_freed_total"] > 0
    assert len(port_engine.completed) == 5


def test_eos_retirement_equals_reference(models):
    ref_model, port_model = models
    rng = np.random.RandomState(1)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in (6, 4, 8)]
    kw = dict(num_slots=2, block_size=4, prefill_chunk=3, decode_quantum=4)
    probe = ServingEngine(port_model, device="cpu", **kw)
    first = probe.submit(prompts[0], max_new_tokens=10)
    probe.run()
    eos = first.tokens[3]            # the 4th greedy token becomes "eos"
    runs = []
    for engine in (RefEngine(ref_model, eos_token_id=eos, **kw),
                   ServingEngine(port_model, eos_token_id=eos, device="cpu",
                                 **kw)):
        reqs = [engine.submit(p, max_new_tokens=10) for p in prompts]
        engine.run()
        runs.append((engine, reqs))
    (ref_engine, ref_reqs), (port_engine, port_reqs) = runs
    assert port_reqs[0].finish_reason == "eos"
    for r, p in zip(ref_reqs, port_reqs):
        np.testing.assert_array_equal(port_engine.output_tokens(p),
                                      ref_engine.output_tokens(r))
        assert p.finish_reason == r.finish_reason
    for key in _COUNTERS:
        assert port_engine.engine_stats()[key] == \
            ref_engine.engine_stats()[key], key
    assert port_engine.pool.fragmentation_stats() == \
        ref_engine.pool.fragmentation_stats()


def test_engine_refuses_later_slices_and_bad_input(models):
    _, port_model = models
    with pytest.raises(ValueError, match="sampling"):
        ServingEngine(port_model, per_request_sampling=True, device="cpu")
    with pytest.raises(ValueError, match="per_request_sampling"):
        ServingEngine(port_model, num_slots=2, block_size=4,
                      device="cpu").submit(np.arange(1, 5, dtype=np.int32),
                                           temperature=0.7)
    with pytest.raises(ValueError, match="greedy|sampling"):
        ServingEngine(port_model, decode_strategy="beam", device="cpu")
    with pytest.raises(TypeError, match="spec_draft"):
        ServingEngine(port_model, device="cpu", spec_draft=port_model)
    engine = ServingEngine(port_model, num_slots=2, block_size=4,
                           max_context=32, device="cpu")
    with pytest.raises(ValueError, match="max_context"):
        engine.submit(np.arange(1, 30, dtype=np.int32), max_new_tokens=8)
    with pytest.raises(ValueError, match="unsupported device"):
        ServingEngine(port_model, device="meta")
    assert isinstance(engine.pool.k_pools[0], torch.Tensor)


# ------------------------------------------------ sampling arm
# the reference's sampling oracles (tests/test_serving.py): its
# _SAMPLING_KW and prompts; streams are the port's own (no threefry)
_SAMPLING_KW = dict(num_slots=2, block_size=4, prefill_chunk=4,
                    decode_strategy="sampling", top_k=8, temperature=0.9,
                    device="cpu")


@pytest.fixture(scope="module")
def sampling_prompts():
    rng = np.random.RandomState(2)
    return [rng.randint(1, 128, n).astype(np.int32) for n in (5, 7, 3)]


def _sample(model, prompts, decode_quantum=3, preempt=False, per_request=False,
            multi_quantum=1, **kw):
    engine = ServingEngine(model, decode_quantum=decode_quantum,
                           per_request_sampling=per_request,
                           multi_quantum=multi_quantum,
                           **dict(_SAMPLING_KW, **kw))
    temp = {"temperature": _SAMPLING_KW["temperature"]} if per_request else {}
    reqs = [engine.submit(p, max_new_tokens=5, seed=i, **temp)
            for i, p in enumerate(prompts)]
    if preempt:
        while len(reqs[0].tokens) < 2:
            engine.step()
        assert not reqs[0].finished
        engine.preempt(reqs[0])
    engine.run()
    if preempt:
        assert engine.scheduler.preempted_total == 1
        assert engine.scheduler.resumed_total == 1
    return [engine.output_tokens(r).tolist() for r in reqs]


@pytest.fixture(scope="module")
def plain_sampling_outputs(models, sampling_prompts):
    return _sample(models[1], sampling_prompts)


def test_top_k_1_sampling_equals_greedy_engine(models, sampling_prompts):
    _, port_model = models
    greedy = ServingEngine(port_model, decode_quantum=3, device="cpu",
                           **{k: v for k, v in _SAMPLING_KW.items()
                              if k in ("num_slots", "block_size",
                                       "prefill_chunk")})
    reqs = [greedy.submit(p, max_new_tokens=5) for p in sampling_prompts]
    greedy.run()
    want = [greedy.output_tokens(r).tolist() for r in reqs]
    for seed_shift in (0, 1):
        got = _sample(port_model, sampling_prompts, top_k=1)
        assert got == want, seed_shift


@pytest.mark.parametrize("decode_quantum,preempt", [(1, False), (4, False),
                                                    (3, True), (1, True)])
def test_sampling_stream_invariant_to_quantum_and_preemption(
        models, sampling_prompts, plain_sampling_outputs, decode_quantum,
        preempt):
    """Each draw is keyed by (request seed, tokens emitted so far): a
    mid-run preemption (re-prefill on resume), the grouping of steps
    into quanta and of quanta into multi-quantum dispatches leave a
    fixed-seed stream unchanged."""
    for multi_quantum in (1, 4):
        got = _sample(models[1], sampling_prompts,
                      decode_quantum=decode_quantum, preempt=preempt,
                      multi_quantum=multi_quantum)
        assert got == plain_sampling_outputs, multi_quantum


def test_per_request_temperature_replays_engine_wide(models, sampling_prompts,
                                                     plain_sampling_outputs):
    """tests/test_serving.py::test_preemption_and_temperature_sampling_
    bit_exact: a uniform per-request temperature, with a preemption,
    replays the engine-wide run; other temperatures and seeds change it."""
    got = _sample(models[1], sampling_prompts, preempt=True,
                  per_request=True)
    assert got == plain_sampling_outputs
    hot = ServingEngine(models[1], decode_quantum=3, per_request_sampling=True,
                        **_SAMPLING_KW)
    reqs = [hot.submit(p, max_new_tokens=5, seed=i + 10, temperature=5.0)
            for i, p in enumerate(sampling_prompts)]
    hot.run()
    assert [hot.output_tokens(r).tolist() for r in reqs] \
        != plain_sampling_outputs
