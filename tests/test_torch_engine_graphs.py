"""The engine remainder on the CPU, held against paddle_tpu's engine on the
same carried weights (``LlamaConfig.tiny``, f32): ``multi_quantum=``,
``attn_impl=``, ``step_dispatch`` / ``step_collect`` and the fused paged
decode attention.

The trace and knobs are tests/test_multiquantum.py's (5 ragged requests
over 2 slots, block size 4, prefill chunk 4, decode quantum 3; 4 requests
for int8). On the CPU the quantum's body runs eagerly: it is the same
function the card captures as a CUDA graph. Greedy streams must be EQUAL
to the reference engine's (f32 on both sides) for every K x attention x
KV dtype, and ``decode_quanta`` equal to the reference's for the same K.
The fused attention: f32 ``2e-6`` against the reference's, bf16 bit-equal
after the output cast.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import engine as ref_engine_mod
from paddle_tpu_torch import create_serving_engine
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.nlp import generation as G
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import engine as port_engine_mod

KW = dict(num_slots=2, block_size=4, prefill_chunk=4, decode_quantum=3)
KV = {"float": {}, "int8": dict(quantize="weight_only_int8",
                                kv_dtype="int8")}
_COUNTERS = ("steps", "mixed_steps", "decode_quanta", "quantum_tokens",
             "prefill_tokens", "generated_tokens")


def _ref_model():
    """A fresh reference model (a quantized engine sweeps its model in
    place); the same seed gives the same weights."""
    paddle.seed(0)
    model = RefLM(RefConfig.tiny(tensor_parallel=False))
    model.eval()
    return model


@pytest.fixture(scope="module")
def arrays():
    return {k: v.numpy() for k, v in _ref_model().state_dict().items()}


def _port_model(arrays):
    model = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                             device="cpu")
    return load_paddle_tpu_arrays(model, arrays)


def _requests(kv, seed=None):
    """tests/test_multiquantum.py's ``_ragged``: 5 requests (float, rng
    0) or 4 (int8, rng 4)."""
    rng = np.random.RandomState((0 if kv == "float" else 4)
                                if seed is None else seed)
    n = 5 if kv == "float" else 4
    prompts = [rng.randint(1, 128, p).astype(np.int32)
               for p in (5, 9, 3, 12, 7)[:n]]
    return list(zip(prompts, (9, 6, 11, 7, 8)[:n]))


def _drive(engine, requests):
    reqs = [engine.submit(p, max_new_tokens=mn) for p, mn in requests]
    engine.run()
    return ([list(map(int, engine.output_tokens(r))) for r in reqs],
            engine.engine_stats())


@pytest.fixture(scope="module")
def reference():
    """The reference engine's streams and stats per (K, KV dtype), run
    once each (its jit compile dominates)."""
    cache, shared = {}, {}

    def get(k, kv):
        if (k, kv) not in cache:
            if kv == "float":
                model = shared.setdefault("float", _ref_model())
            else:
                model = _ref_model()
            cache[k, kv] = _drive(
                RefEngine(model, multi_quantum=k, **KW, **KV[kv]),
                _requests(kv))
        return cache[k, kv]

    return get


@pytest.fixture(scope="module")
def port_float(arrays):
    return _port_model(arrays)


# ------------------------------------------------ the greedy matrix
@pytest.mark.parametrize("kv", ["float", "int8"])
@pytest.mark.parametrize("attn_impl", ["gather", "fused"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_greedy_matrix_equals_reference(reference, arrays, port_float, k,
                                        attn_impl, kv):
    """K x attention x KV dtype: streams, ``decode_quanta`` and the other
    counters equal the reference engine's at the same K (the reference's
    streams do not depend on K or on the attention, its own oracle)."""
    want, want_stats = reference(k, kv)
    model = port_float if kv == "float" else _port_model(arrays)
    engine = ServingEngine(model, multi_quantum=k, attn_impl=attn_impl,
                           device="cpu", **KW, **KV[kv])
    got, stats = _drive(engine, _requests(kv))
    assert got == want
    for key in _COUNTERS:
        assert stats[key] == want_stats[key], key
    assert stats["pool"]["blocks_in_use"] == 1
    if k > 1:
        # the K-quanta dispatch engaged: fewer host steps than quanta
        # plus mixed steps
        assert stats["steps"] < stats["decode_quanta"] + stats["mixed_steps"]


def test_three_way_greedy_oracle(reference, port_float):
    """The port engine's greedy streams equal the reference engine's AND
    the port's own ``generate_on_device`` on each prompt alone."""
    want, _ = reference(1, "float")
    got, _ = _drive(ServingEngine(port_float, device="cpu", **KW),
                    _requests("float"))
    assert got == want
    for (prompt, mn), stream in zip(_requests("float"), got):
        alone = G.generate_on_device(port_float, prompt[None],
                                     max_new_tokens=mn)
        assert alone[0].tolist() == stream


# ------------------------------------------------ preemption, dispatch
def test_multiquantum_preemption(port_float):
    """tests/test_multiquantum.py::test_multiquantum_preemption: evict a
    request while the K=4 engine decodes and resume it by re-prefill;
    the streams equal the K=1 engine's under the same eviction."""
    requests = list(zip(
        [p for p, _ in _requests("float", seed=5)][:4], (16, 12, 14, 10)))

    def arm(k, attn_impl):
        eng = ServingEngine(port_float, multi_quantum=k, attn_impl=attn_impl,
                            device="cpu", **KW)
        reqs = [eng.submit(p, max_new_tokens=mn) for p, mn in requests]
        while len(reqs[0].tokens) < 2:
            eng.step()
        assert not reqs[0].finished
        eng.preempt(reqs[0])
        eng.run()
        assert eng.scheduler.preempted_total == 1
        return [list(map(int, eng.output_tokens(r))) for r in reqs]

    base = arm(1, "gather")
    assert arm(4, "gather") == base
    assert arm(4, "fused") == base


def test_two_engines_dispatch_dispatch_collect_collect(port_float):
    """Two engines driven dispatch, dispatch, collect, collect give the
    streams and counters each gives alone through ``step()``."""
    traces = (_requests("float"), _requests("float", seed=9))
    kws = (dict(KW), dict(KW, multi_quantum=2))
    alone = [_drive(ServingEngine(port_float, device="cpu", **kw), tr)
             for kw, tr in zip(kws, traces)]
    engines = [ServingEngine(port_float, device="cpu", **kw) for kw in kws]
    reqs = [[e.submit(p, max_new_tokens=mn) for p, mn in tr]
            for e, tr in zip(engines, traces)]
    decode_dispatches = 0
    while any(e.has_work for e in engines):
        pending = [e.step_dispatch() if e.has_work else None
                   for e in engines]
        decode_dispatches += sum(p is not None for p in pending)
        for e, p in zip(engines, pending):
            e.step_collect(p)
    assert decode_dispatches > 0
    for e, rs, (want, want_stats) in zip(engines, reqs, alone):
        assert [list(map(int, e.output_tokens(r))) for r in rs] == want
        stats = e.engine_stats()
        for key in _COUNTERS:
            assert stats[key] == want_stats[key], key


# ------------------------------------------ scheduling + accounting
def test_steady_state_predicate(port_float):
    """tests/test_multiquantum.py::test_steady_state_predicate: the K gate
    is True exactly when nothing waits, no slot is mid-prefill and one
    decodes."""
    eng = ServingEngine(port_float, device="cpu", **KW)
    sched = eng.scheduler
    assert not sched.steady_state()  # idle: nothing decoding
    rng = np.random.RandomState(6)
    r0 = eng.submit(rng.randint(1, 128, 6).astype(np.int32),
                    max_new_tokens=12)
    assert not sched.steady_state()  # waiting for admission
    while sched.waiting or sched.prefilling():
        eng.step()
    assert sched.steady_state()      # one slot, pure decode
    eng.submit(rng.randint(1, 128, 6).astype(np.int32), max_new_tokens=4)
    assert not sched.steady_state()  # admission pending again
    eng.run()
    assert not sched.steady_state()  # drained
    assert r0.finished


def test_multiquantum_accounting_conserved(port_float):
    """tests/test_multiquantum.py::test_multiquantum_accounting_conserved:
    a K-quanta dispatch accounts every quantum that ran (more quanta than
    host steps), and every emitted token is counted exactly once."""
    rng = np.random.RandomState(7)
    eng = ServingEngine(port_float, multi_quantum=4, device="cpu", **KW)
    reqs = [eng.submit(rng.randint(1, 128, 5).astype(np.int32),
                       max_new_tokens=24) for _ in range(2)]
    steps = 0
    while eng.has_work:
        eng.step()
        steps += 1
    assert eng.stats["decode_quanta"] > steps, "K>1 folding never engaged"
    emitted = sum(len(r.tokens) for r in reqs)
    assert eng.stats["generated_tokens"] == emitted == 48
    t, s = KW["decode_quantum"], KW["num_slots"]
    assert eng.stats["quantum_tokens"] == eng.stats["decode_quanta"] * t * s


def test_multiquantum_and_attn_impl_refusals(port_float):
    """tests/test_multiquantum.py::test_multiquantum_rejects_bad_args,
    with the reference's messages (the facade forwards the options)."""
    with pytest.raises(ValueError, match="multi_quantum must be >= 1"):
        ServingEngine(port_float, multi_quantum=0, device="cpu")
    with pytest.raises(ValueError, match="attn_impl must be gather|fused"):
        ServingEngine(port_float, attn_impl="flash", device="cpu")
    with pytest.raises(ValueError, match="multi_quantum must be >= 1"):
        create_serving_engine(port_float, multi_quantum=-1, device="cpu")
    eng = create_serving_engine(port_float, multi_quantum=3,
                                attn_impl="fused", device="cpu", **KW)
    assert (eng._mq_max, eng.attn_impl) == (3, "fused")
    assert eng._state.dev["toks"].shape == (3, 3, 2)


# ------------------------------------------------ fused attention unit
def _paged_inputs(rng, s, w, bs, hq, hk, d, b, lens, int8=False):
    q = rng.randn(s, hq, d).astype(np.float32)
    if int8:
        kp = rng.randint(-127, 128, (b, bs, hk, d)).astype(np.int8)
        vp = rng.randint(-127, 128, (b, bs, hk, d)).astype(np.int8)
    else:
        kp = rng.randn(b, bs, hk, d).astype(np.float32)
        vp = rng.randn(b, bs, hk, d).astype(np.float32)
    tables = rng.randint(0, b, (s, w)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def test_fused_attention_matches_reference():
    """tests/test_multiquantum.py::test_fused_attention_matches_gather_unit:
    ragged lengths (a 1-token row, a full table), GQA 4/2; the port's
    fused stream against the reference's, f32 at 2e-6, bf16 bit-equal."""
    rng = np.random.RandomState(9)
    q, kp, vp, tables, lens = _paged_inputs(rng, 4, 5, 4, 4, 2, 16, 24,
                                            [7, 20, 1, 13])
    ref = ref_engine_mod._fused_paged_decode_attn(
        *map(jnp.asarray, (q, kp, vp, tables, lens)))
    got = port_engine_mod._fused_paged_decode_attn(
        *map(torch.from_numpy, (q, kp, vp, tables, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)
    ref_b = ref_engine_mod._fused_paged_decode_attn(
        *(jnp.asarray(x).astype(jnp.bfloat16) for x in (q, kp, vp)),
        jnp.asarray(tables), jnp.asarray(lens))
    got_b = port_engine_mod._fused_paged_decode_attn(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, kp, vp)),
        torch.from_numpy(tables), torch.from_numpy(lens))
    assert got_b.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got_b.view(torch.int16).numpy(),
        np.asarray(ref_b).view(np.int16))


def test_fused_attention_int8_pools_matches_reference():
    """tests/test_multiquantum.py::test_fused_attention_int8_pools_unit:
    int8 pools with per-row f32 scale pools, dequantized per streamed
    block; f32 at 2e-6 against the reference's."""
    rng = np.random.RandomState(10)
    q, kq, vq, tables, lens = _paged_inputs(rng, 3, 4, 4, 4, 2, 8, 16,
                                            [5, 16, 2], int8=True)
    ks = (rng.rand(16, 4, 2) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.rand(16, 4, 2) * 0.02 + 1e-3).astype(np.float32)
    args = (q, kq, vq, tables, lens)
    ref = ref_engine_mod._fused_paged_decode_attn(
        *map(jnp.asarray, args), ks=jnp.asarray(ks), vs=jnp.asarray(vs))
    got = port_engine_mod._fused_paged_decode_attn(
        *map(torch.from_numpy, args), ks=torch.from_numpy(ks),
        vs=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-6,
                               atol=2e-6)
    # and the port's gather path (K2's plain per-row version) agrees
    gather = port_engine_mod._paged_attn(
        *map(torch.from_numpy, args), torch.from_numpy(ks),
        torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=2e-6,
                               atol=2e-6)
