"""int8 serving on the port held against paddle_tpu's engine
(``LlamaConfig.tiny``, f32, the same carried weights).

- ``quantize="weight_only_int8"``: the port engine's streams equal the
  port's float engine over the dequantized weights (the reference's own
  oracle, ``test_weight_only_engine_bit_exact_vs_dequant_float``), greedy
  and sampled;
- ``quantize=`` with and without ``kv_dtype="int8"``: greedy streams,
  finish reasons, engine counters and pool statistics equal the
  reference engines'; ``top_k=1`` sampling gives the greedy streams;
- the int8-KV stream does not depend on how a sequence is cut into
  prefill chunks and decode quanta (a row's scale is its own).
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
from paddle_tpu_torch.nn.quant import QuantizedLinear, quantize_for_serving
from paddle_tpu_torch.ops.paged_attention import (
    _paged_decode_attention_rows)

KW = dict(num_slots=2, block_size=4, prefill_chunk=4, decode_quantum=3)
W8 = dict(quantize="weight_only_int8")
W8KV8 = dict(quantize="weight_only_int8", kv_dtype="int8")
SAMPLING = dict(decode_strategy="sampling", top_k=8, temperature=0.9)
_COUNTERS = ("steps", "mixed_steps", "decode_quanta", "quantum_tokens",
             "prefill_tokens", "generated_tokens", "admitted", "finished")


def _ref_model():
    """Each quantized engine needs its own model: the sweep rewrites the
    Linears in place. The same seed gives the same weights."""
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


def _dequantized(model):
    """The oracle: every Linear's weight replaced by the dequantized
    product the int8 layer multiplies by, in the model's dtype."""
    for mod in list(model.modules()):
        for sub in mod.children():
            if isinstance(sub, torch.nn.Linear):
                q = QuantizedLinear.from_linear(sub)
                with torch.no_grad():
                    sub.weight.copy_(q.dequantized_weight(sub.weight.dtype))
    return model


def _prompts(seed=0, lens=(5, 9, 3)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 128, n).astype(np.int32) for n in lens]


MAX_NEW = [6, 5, 7]


def _run(engine, prompts, max_new=MAX_NEW, preempt=False):
    reqs = [engine.submit(p, max_new_tokens=mn, req_id=f"r{i}", seed=i)
            for i, (p, mn) in enumerate(zip(prompts, max_new))]
    if preempt:
        while len(reqs[0].tokens) < 2:
            engine.step()
        engine.preempt(reqs[0])
    engine.run()
    return reqs


def _streams(reqs):
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module")
def ref_runs(arrays):
    out = {}
    for name, extra in (("w8", W8), ("w8kv8", W8KV8)):
        engine = RefEngine(_ref_model(), **KW, **extra)
        out[name] = (engine, _run(engine, _prompts(), preempt=True))
    return out


@pytest.mark.parametrize("arm", ["w8", "w8kv8"])
def test_int8_engines_equal_reference(arrays, ref_runs, arm):
    ref_engine, ref_reqs = ref_runs[arm]
    engine = create_serving_engine(_port_model(arrays), device="cpu", **KW,
                                   **(W8 if arm == "w8" else W8KV8))
    reqs = _run(engine, _prompts(), preempt=True)
    assert _streams(reqs) == _streams(ref_reqs)
    assert [r.finish_reason for r in reqs] == \
        [r.finish_reason for r in ref_reqs]
    assert reqs[0].preemptions == 1
    st, ref_st = engine.engine_stats(), ref_engine.engine_stats()
    for key in _COUNTERS:
        assert st[key] == ref_st[key], key
    assert st["pool"] == ref_st["pool"]
    assert engine.pool.quantized == (arm == "w8kv8")
    assert st["pool"]["kv_dtype"] == ("int8" if arm == "w8kv8"
                                      else "float32")
    assert not any(isinstance(m, torch.nn.Linear)
                   for m in engine.model.modules())


def test_int8_kv_pool_bytes_against_float_pool(arrays, ref_runs):
    """Per allocated block the int8 pool holds under half the float
    pool's bytes (here D = 16 f32: (16 + 4) / 64)."""
    st_f = ref_runs["w8"][0].pool
    engine = create_serving_engine(_port_model(arrays), device="cpu", **KW,
                                   **W8KV8)
    engine.pool.ensure("x", 9)
    per_q = engine.pool.bytes_in_use() / engine.pool.blocks_in_use
    per_f = st_f.bytes_in_use() / max(st_f.blocks_in_use, 1)
    assert per_q * 64 == per_f * 20


@pytest.mark.parametrize("sampling", [False, True])
def test_weight_only_engine_equals_dequantized_float_engine(arrays,
                                                            sampling):
    """The weight-only int8 engine and a float engine holding the
    dequantized weights run the same products: equal streams, greedy and
    sampled with fixed seeds."""
    extra = SAMPLING if sampling else {}
    want = _streams(_run(create_serving_engine(
        _dequantized(_port_model(arrays)), device="cpu", **KW, **extra),
        _prompts(1)))
    engine = create_serving_engine(_port_model(arrays), device="cpu", **KW,
                                   **W8, **extra)
    assert _streams(_run(engine, _prompts(1))) == want
    assert isinstance(engine.model.lm_head, QuantizedLinear)


def test_int8_kv_top_k_1_sampling_equals_reference_greedy(arrays,
                                                          ref_runs):
    engine = create_serving_engine(
        _port_model(arrays), device="cpu", **KW, **W8KV8,
        decode_strategy="sampling", top_k=1)
    reqs = _run(engine, _prompts(), preempt=True)
    assert _streams(reqs) == _streams(ref_runs["w8kv8"][1])


def test_int8_kv_stream_independent_of_chunk_and_quantum(arrays,
                                                         monkeypatch):
    """The same requests cut into other prefill chunks and decode quanta
    give the same streams; the quantum's attention is K2's per-row
    mode (its plain version here)."""
    from paddle_tpu_torch.serving import engine as engine_mod

    calls = []

    def counted(*args, **kw):
        calls.append(1)
        return _paged_decode_attention_rows(*args, **kw)

    monkeypatch.setattr(engine_mod, "_paged_decode_attention_rows", counted)
    prompts = _prompts(4, (6, 10))
    runs = []
    for chunk, quantum in ((4, 3), (8, 2)):
        engine = create_serving_engine(
            _port_model(arrays), device="cpu", **W8KV8, num_slots=2,
            block_size=4, prefill_chunk=chunk, decode_quantum=quantum)
        runs.append(_streams(_run(engine, prompts, [6, 5])))
    assert runs[0] == runs[1]
    assert calls


def test_engine_options_are_checked(arrays):
    model = _port_model(arrays)
    with pytest.raises(ValueError, match="kv_dtype"):
        create_serving_engine(model, device="cpu", kv_dtype="fp8")
    with pytest.raises(ValueError, match="algo"):
        create_serving_engine(model, device="cpu", quantize="int4")
    # an already swept model serves as it is (the sweep is idempotent)
    quantize_for_serving(model)
    engine = create_serving_engine(model, device="cpu", **KW, **W8)
    assert engine.pool.k_pools[0].dtype == torch.float32
