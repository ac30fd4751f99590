"""The port's LoRA (``paddle_tpu_torch.peft``), its train step's
frozen-parameter rule and ``obs.InstrumentedTrainStep`` held against
paddle_tpu's, on ``LlamaConfig.tiny``.

The cases of ``tests/test_peft_lora.py`` that need no mesh run on both
packages. A's draws differ (torch's generator against threefry), so A and
B are carried from the reference LoRA model into the port's with
``load_paddle_tpu_arrays`` (its keys, only the base Linears transposed).

The frozen rule: the port's ``JittedTrainStep`` differentiates and updates
only ``requires_grad`` parameters, as the reference's eager loop does;
the reference's jitted step updates every parameter, frozen ones included
(pinned below, so a fix of the reference shows).

Tolerances, each with its reason:
- forwards in f32: ``1e-5`` (two decoder layers of f32 products summed in
  other orders);
- losses of three steps: ``1e-5`` relative (f32 losses);
- adapters after three AdamW steps: ``1e-5`` of the tensor's largest
  |value| (f32 updates of gradients that agree to about 1e-6);
- frozen parameters: bit-equal to their start;
- merge / unmerge in f32: ``2e-5`` (the reference's own bound, one f32
  rounding of W + delta);
- InstrumentedTrainStep under one patched clock: registry snapshots and
  ``report()`` EQUAL.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import JittedTrainStep as RefStep
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import LlamaPretrainingCriterion as RefCriterion
from paddle_tpu.obs import InstrumentedTrainStep as RefInst
from paddle_tpu.obs import MetricsRegistry as RefRegistry
from paddle_tpu.obs import TraceRecorder as RefTracer
import paddle_tpu.obs.train as ref_obs_train
from paddle_tpu.peft import LoRAConfig as RefLoRAConfig
from paddle_tpu.peft import get_lora_model as ref_get_lora_model
from paddle_tpu.peft import lora_state_dict as ref_lora_state_dict
from paddle_tpu_torch.jit import JittedTrainStep
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  LlamaPretrainingCriterion,
                                  load_paddle_tpu_arrays,
                                  paddle_tpu_arrays_to_port)
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.nn.quant import QuantizedLinear
from paddle_tpu_torch.obs import (InstrumentedTrainStep, MetricsRegistry,
                                  TraceRecorder)
import paddle_tpu_torch.obs.train as port_obs_train
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.peft import (LoRAConfig, LoRALinear, LoRAModel,
                                   get_lora_model, lora_state_dict,
                                   mark_only_lora_as_trainable)

LR = 1e-2
STEPS = 3


def _arrays(model):
    return {k: np.asarray(v.numpy()) for k, v in model.state_dict().items()}


def _pair(r=4, alpha=8, **cfg):
    """(reference LoRA model, port LoRA model) on the same weights: the
    reference's base and adapters carried into the port's."""
    paddle.seed(0)
    ref = ref_get_lora_model(
        RefLM(RefConfig.tiny(tensor_parallel=False, **cfg)),
        RefLoRAConfig(r=r, lora_alpha=alpha))
    port = get_lora_model(
        LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False, **cfg),
                         device="cpu"),
        LoRAConfig(r=r, lora_alpha=alpha))
    load_paddle_tpu_arrays(port, _arrays(ref))
    return ref, port


def _perturb_adapters(ref, seed=3):
    """B != 0, so the delta carries signal (it starts at zero)."""
    rng = np.random.RandomState(seed)
    for n, p in ref.named_parameters():
        if "lora_" in n:
            p.set_value(p.numpy()
                        + rng.randn(*p.shape).astype("float32") * 0.05)


def _ids(seed, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, 128, shape)


def _out(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x.numpy()


def test_lora_starts_equal_and_wraps_the_same_layers():
    paddle.seed(0)
    ref_base = RefLM(RefConfig.tiny(tensor_parallel=False))
    port_base = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                                 device="cpu")
    load_paddle_tpu_arrays(port_base, _arrays(ref_base))
    ids = _ids(0)
    base_out = ref_base(paddle.to_tensor(ids)).numpy()
    ref = ref_get_lora_model(ref_base, RefLoRAConfig(r=4, lora_alpha=8))
    port = get_lora_model(port_base, LoRAConfig(r=4, lora_alpha=8))
    assert port.wrapped_names == ref.wrapped_names
    # B starts at zero: the adapted model equals the base, whatever A is
    np.testing.assert_allclose(_out(port(torch.from_numpy(ids))), base_out,
                               rtol=1e-5, atol=1e-5)
    trainable = [n for n, p in port.named_parameters() if p.requires_grad]
    assert trainable == [n for n, p in ref.named_parameters()
                         if not p.stop_gradient]
    assert trainable and all("lora_" in n for n in trainable)
    n_train = sum(p.numel() for p in port.parameters() if p.requires_grad)
    assert n_train < 0.1 * sum(p.numel() for p in port.parameters())
    assert sorted(lora_state_dict(port)) == sorted(ref_lora_state_dict(ref))
    # the layout: A (in, r), B (r, out), the base keeps torch's (out, in)
    q = port.model.llama.layers[0].self_attn.q_proj
    assert isinstance(q, LoRALinear) and isinstance(q.base, Linear)
    assert tuple(q.lora_A.shape) == (64, 4) and tuple(q.lora_B.shape) == (
        4, 64)
    assert q.lora_A.dtype == torch.float32 and not q.lora_B.any()


def test_lora_carry_round_trips():
    """A reference LoRA model's arrays carry into the port's as they are
    (only the base Linears transposed) and back."""
    ref, port = _pair()
    _perturb_adapters(ref)
    arrays = _arrays(ref)
    load_paddle_tpu_arrays(port, arrays)
    mapped = paddle_tpu_arrays_to_port(port, arrays)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), mapped[k], err_msg=k)
        if "lora_" in k:
            np.testing.assert_array_equal(v.numpy(), arrays[k], err_msg=k)
        elif k.endswith("proj.base.weight"):
            np.testing.assert_array_equal(v.numpy(), arrays[k].T, err_msg=k)
    ids = _ids(4)
    np.testing.assert_allclose(_out(port(torch.from_numpy(ids))),
                               ref(paddle.to_tensor(ids)).numpy(),
                               rtol=1e-5, atol=1e-5)


def _ref_eager(ref, ids_np, steps=STEPS):
    crit = RefCriterion()
    opt = paddle.optimizer.AdamW(
        LR, parameters=[p for _, p in ref.named_parameters()
                        if not p.stop_gradient])
    ids = paddle.to_tensor(ids_np)
    losses = []
    for _ in range(steps):
        loss = crit(ref(ids), ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def test_jitted_step_on_lora_matches_reference_eager_loop():
    """The frozen rule: the port's JittedTrainStep against the reference's
    eager loop on the same carried weights, three steps."""
    ref, port = _pair()
    frozen0 = {n: p.detach().clone() for n, p in port.named_parameters()
               if not p.requires_grad}
    ids_np = _ids(1, (2, 16))
    ref_losses = _ref_eager(ref, ids_np)
    crit = LlamaPretrainingCriterion()
    opt = AdamW(LR, parameters=[p for p in port.parameters()
                                if p.requires_grad])
    step = JittedTrainStep(port, lambda o, lb: crit(o, lb), opt)
    assert len(step.params) == 8  # the adapters only: 2 layers x q, v x A, B
    ids = torch.from_numpy(ids_np)
    losses = [float(step(ids, ids)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    want = paddle_tpu_arrays_to_port(port, _arrays(ref))
    for n, p in port.named_parameters():
        if p.requires_grad:
            w = want[n]
            bound = 1e-5 * max(1.0, float(np.abs(w).max()))
            assert float(np.abs(p.detach().numpy() - w).max()) <= bound, n
        else:
            assert torch.equal(p, frozen0[n]), n
            np.testing.assert_array_equal(p.detach().numpy(), want[n],
                                          err_msg=n)
    # frozen parameters got no optimizer state either
    assert set(map(id, step.params)) == {id(p) for p in port.parameters()
                                         if p.requires_grad}


def test_reference_jitted_step_moves_frozen_weights():
    """Pins the reference's jitted step (paddle_tpu/jit/train.py:50,
    :113-122): it differentiates and updates every named parameter, so the
    frozen base weights move too. A fixed reference fails this test; the
    port's rule (above) then matches it as well."""
    ref, _ = _pair()
    frozen0 = {n: p.numpy().copy() for n, p in ref.named_parameters()
               if p.stop_gradient}
    crit = RefCriterion()
    opt = paddle.optimizer.AdamW(
        LR, parameters=[p for _, p in ref.named_parameters()
                        if not p.stop_gradient])
    step = RefStep(ref, lambda o, lb: crit(o, lb), opt)
    ids = paddle.to_tensor(_ids(1, (2, 16)))
    for _ in range(2):
        step(ids, ids)
    step.sync_to_model()
    moved = [n for n, p in ref.named_parameters()
             if p.stop_gradient and not np.array_equal(p.numpy(),
                                                       frozen0[n])]
    assert len(moved) == len(frozen0) > 0


def test_lora_merge_and_unmerge_match_reference():
    ref, port = _pair()
    _perturb_adapters(ref)
    load_paddle_tpu_arrays(port, _arrays(ref))
    ids = _ids(5)
    adapted = _out(port(torch.from_numpy(ids)))
    merged = _out(port.merge()(torch.from_numpy(ids)))
    ref_merged = ref.merge()(paddle.to_tensor(ids)).numpy()
    np.testing.assert_allclose(merged, adapted, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(merged, ref_merged, rtol=2e-5, atol=2e-5)
    want = paddle_tpu_arrays_to_port(port, _arrays(ref))
    w = port.model.llama.layers[0].self_attn.q_proj.base.weight
    key = "model.llama.layers.0.self_attn.q_proj.base.weight"
    np.testing.assert_allclose(w.detach().numpy(), want[key], rtol=1e-6,
                               atol=1e-6)
    port.unmerge()
    ref.unmerge()
    np.testing.assert_allclose(_out(port(torch.from_numpy(ids))), adapted,
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        w.detach().numpy(),
        paddle_tpu_arrays_to_port(port, _arrays(ref))[key], rtol=1e-6,
        atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_lora_merge_folds_in_the_base_dtype(dtype):
    """merge / unmerge fold the delta in the base weight's dtype: the
    merged weight is W + round(delta), and unmerge leaves W within one
    ulp of that dtype at the larger of |W| and |W + delta| (two roundings,
    each at most half an ulp of its result)."""
    torch.manual_seed(0)
    base = Linear(32, 16).to(dtype)
    w0 = base.weight.detach().clone()
    lora = LoRALinear(base, r=4, lora_alpha=8)
    with torch.no_grad():
        lora.lora_B.normal_(0, 0.05)
    delta = (lora.lora_A @ lora.lora_B * 2.0).t().to(dtype)
    lora.merge()
    assert base.weight.dtype == dtype
    merged = base.weight.detach().clone()
    assert torch.equal(merged, w0 + delta)
    lora.unmerge()
    ulp = torch.finfo(dtype).eps * torch.maximum(
        w0.float().abs(), merged.float().abs()).clamp_min(
        torch.finfo(dtype).tiny)
    assert bool(((base.weight.float() - w0.float()).abs() <= ulp).all())


def test_lora_bad_targets_raise():
    for build, get, cfg in (
            (lambda: RefLM(RefConfig.tiny(tensor_parallel=False)),
             ref_get_lora_model, RefLoRAConfig),
            (lambda: LlamaForCausalLM(LlamaConfig.tiny(
                tensor_parallel=False), device="cpu"), get_lora_model,
             LoRAConfig)):
        with pytest.raises(ValueError, match="matched no"):
            get(build(), cfg(target_modules=[".*nonexistent"]))
    with pytest.raises(ValueError, match="rank must be >= 1"):
        LoRAConfig(r=0)


def test_lora_trainable_bias_scoped_to_wrapped_layers():
    ref, port = (None, None)
    paddle.seed(0)
    ref = ref_get_lora_model(
        RefLM(RefConfig.tiny(tensor_parallel=False, attention_bias=True)),
        RefLoRAConfig(r=2, trainable_bias=True))
    port = get_lora_model(
        LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False,
                                          attention_bias=True),
                         device="cpu"),
        LoRAConfig(r=2, trainable_bias=True))
    trainable = [n for n, p in port.named_parameters() if p.requires_grad]
    assert trainable == [n for n, p in ref.named_parameters()
                         if not p.stop_gradient]
    for n in trainable:
        if n.endswith(".bias"):
            assert ".base." in n, n
    sd = lora_state_dict(port)
    assert sorted(sd) == sorted(ref_lora_state_dict(ref))
    assert any(k.endswith(".bias") for k in sd)
    assert all("lora_" in k or ".base." in k for k in sd)
    # mark_only_lora_as_trainable on its own, without the biases
    mark_only_lora_as_trainable(port)
    assert all("lora_" in n for n, p in port.named_parameters()
               if p.requires_grad)


def test_lora_rejects_quantized_linear_base():
    m = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                         device="cpu")
    attn = m.llama.layers[0].self_attn
    attn.q_proj = QuantizedLinear.from_linear(attn.q_proj)
    with pytest.raises(ValueError, match="QuantizedLinear.*QLoRA"):
        get_lora_model(m, LoRAConfig(r=2))


def test_lora_state_dict_round_trip():
    """The adapter artifact loaded onto a fresh base + fresh wrap restores
    the trained forward exactly."""
    ref, port = _pair()
    _perturb_adapters(ref)
    load_paddle_tpu_arrays(port, _arrays(ref))
    ids = torch.from_numpy(_ids(4, (2, 10)))
    want = _out(port(ids))
    sd = {k: v.clone() for k, v in lora_state_dict(port).items()}
    fresh = get_lora_model(
        LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                         device="cpu"), LoRAConfig(r=4, lora_alpha=8))
    base = {k: v for k, v in port.state_dict().items() if k not in sd}
    fresh.load_state_dict(base, strict=False)
    assert np.abs(_out(fresh(ids)) - want).max() > 1e-5
    missing, unexpected = fresh.load_state_dict(sd, strict=False)
    assert not unexpected
    np.testing.assert_array_equal(_out(fresh(ids)), want)


def test_lora_a_init_variance_is_one_over_r():
    torch.manual_seed(7)
    r = 16
    lora = LoRALinear(Linear(512, 64), r=r, lora_alpha=32)
    a = lora.lora_A.detach().numpy()
    assert a.shape == (512, r)
    expected = (1.0 / r) ** 0.5
    assert abs(a.std() - expected) < 0.1 * expected
    assert a.std() > 2.0 * (1.0 / r)


def test_lora_model_forwards_attributes_and_generator():
    m = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                         device="cpu")
    a = get_lora_model(m, LoRAConfig(r=2),
                       generator=torch.Generator().manual_seed(1))
    b = get_lora_model(
        LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                         device="cpu"), LoRAConfig(r=2),
        generator=torch.Generator().manual_seed(1))
    assert isinstance(a, LoRAModel) and a.config is m.config
    assert a.lm_head is m.lm_head
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n


# ------------------------------------------------------- obs/train.py
class _Clock:
    """perf_counter for both packages' obs.train: 0.25 s a reading."""

    def __init__(self):
        self.t = 10.0

    def perf_counter(self):
        self.t += 0.25
        return self.t


def test_instrumented_train_step_matches_reference(monkeypatch):
    """tests/test_obs.py's test_instrumented_train_step on both packages
    under one patched clock: metric names, counters, histogram, gauges,
    report() and trace spans equal."""
    paddle.seed(0)
    ref_model = paddle.nn.Linear(8, 8)
    port_model = Linear(8, 8)
    with torch.no_grad():
        port_model.weight.copy_(torch.from_numpy(
            ref_model.weight.numpy().T.copy()))
        port_model.bias.copy_(torch.from_numpy(
            ref_model.bias.numpy().copy()))

    def crit(out, label):
        d = out - label
        return (d * d).mean()

    ref_step = RefStep(ref_model, crit,
                       paddle.optimizer.AdamW(
                           1e-3, parameters=ref_model.parameters()))
    port_step = JittedTrainStep(port_model, crit,
                                AdamW(1e-3,
                                      parameters=port_model.parameters()))
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8).astype("f4")
    y = rng.randn(2, 8).astype("f4")
    runs = []
    for mod, step, Reg, Tr, inst_cls, xs in (
            (ref_obs_train, ref_step, RefRegistry, RefTracer, RefInst,
             (paddle.to_tensor(x), paddle.to_tensor(y))),
            (port_obs_train, port_step, MetricsRegistry, TraceRecorder,
             InstrumentedTrainStep, (torch.from_numpy(x),
                                     torch.from_numpy(y)))):
        monkeypatch.setattr(mod, "time", _Clock())
        reg, tracer = Reg(), Tr(epoch=0.0)
        inst = inst_cls(step, registry=reg, tokens_per_step=16,
                        tracer=tracer)
        losses = [float(np.asarray(_out(inst(*xs)))) for _ in range(2)]
        assert reg.get("train_steps_total").value() == 2
        assert reg.get("train_step_seconds").count() == 2
        assert reg.get("train_tokens_total").value() == 32
        assert reg.get("train_tokens_per_second").value() == 16 / 0.25
        assert len(tracer.events) >= 2
        assert "train_step_seconds" in reg.prometheus()
        runs.append((losses, reg.snapshot(), inst.report(),
                     [(e["name"], e["ph"], e.get("ts"), e.get("dur"))
                      for e in tracer.events]))
    (rl, rs, rr, rt), (pl, ps, pr, pt) = runs
    np.testing.assert_allclose(pl, rl, rtol=1e-6)
    assert ps == rs
    assert pr == rr and pr["n_steps_timed"] == 2 and pr["tokens_per_sec"]
    assert pt == rt
    # attributes pass through to the wrapped step
    inst = InstrumentedTrainStep(port_step)
    assert inst.params is port_step.params
    assert inst.run_steps.__self__ is port_step
    assert inst.report() == {}


def test_for_transformer_flops_accounting():
    calls = []

    class FakeStep:
        def __call__(self, inputs, labels):
            calls.append(1)
            return torch.tensor(0.0)

    for cls, mod in ((RefInst, None), (InstrumentedTrainStep, None)):
        inst = cls.for_transformer(FakeStep(), n_params=1000,
                                   tokens_per_step=64, num_layers=2,
                                   seq_len=32, hidden=16, sync=False)
        # 6NT + 12 L S E T / 2 (causal)
        assert inst.model_flops_per_step == 6.0 * 1000 * 64 + (
            12.0 * 2 * 32 * 16 * 64 * 0.5)
    ref = RefInst.for_transformer(FakeStep(), n_params=10,
                                  tokens_per_step=8, sync=False)
    port = InstrumentedTrainStep.for_transformer(FakeStep(), n_params=10,
                                                 tokens_per_step=8,
                                                 sync=False)
    assert port.model_flops_per_step == ref.model_flops_per_step
    port(None, None)
    assert port.registry.get("train_model_tflops_per_second").value() > 0
    assert port.report()["mfu"] is None  # no peak without a card
