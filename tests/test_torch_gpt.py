"""The port's GPT-2 family held against paddle_tpu's on the CPU:
``GPTConfig.tiny`` (2 layers, hidden 64, 4 heads) built by the reference
from its seed and carried with ``nlp.convert``; token ids from
``np.random.RandomState``.

Tolerances, each with its reason:
- f32 logits: ``1e-5`` absolute and relative (the same f32 products and
  LayerNorms summed in other orders);
- three AdamW steps through ``JittedTrainStep``: losses within ``1e-5``
  relative; parameters within ``1e-5`` of each tensor's largest |value|
  (f32 updates of the same gradients). Adam's first steps move an
  element by about ``lr`` times the sign of its gradient, and some
  gradients are rounding noise of either sign, so every element is held
  within ``2 * lr * steps`` and all but 0.1% of each tensor's elements
  (at least one) within ``1e-5``, so no whole tensor can be wrong. The
  key part of ``qkv.bias`` is left out of that count: its gradient is zero in
  exact arithmetic (a bias on every key adds the same q.b to all of a
  query's scores, which the softmax cancels), so all of it is noise;
- recompute against plain: losses within ``1e-5``, gradients ``1e-4``
  relative and ``1e-6`` absolute (the reference's own test's bounds);
- bf16 logits: ``2^-7`` of the largest |logit| (one bf16 rounding step of
  the result, beyond the roundings the two packages share);
- greedy streams: equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import JittedTrainStep as RefStep
from paddle_tpu.nlp import GPTConfig as RefConfig
from paddle_tpu.nlp import GPTForCausalLM as RefLM
from paddle_tpu_torch.incubate.nn.functional import fused_linear_cross_entropy
from paddle_tpu_torch.jit import JittedTrainStep
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM,
                                  load_paddle_tpu_arrays,
                                  paddle_tpu_arrays_to_port)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
STEPS = 3


def _ids(b=2, s=16, seed=0, vocab=128):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(
        np.int64)


def _pair(seed=0, dtype="float32", **kw):
    """The reference's tiny GPT from ``seed`` and the port's with its
    weights."""
    paddle.seed(seed)
    ref = RefLM(RefConfig.tiny(**kw))
    if dtype != "float32":
        ref.astype(dtype)
    arrays = {k: np.asarray(v._value, np.float32)
              for k, v in ref.state_dict().items()}
    model = GPTForCausalLM(GPTConfig.tiny(dtype=dtype, **kw), device="cpu")
    load_paddle_tpu_arrays(model, arrays)
    return ref, model


def test_tiny_logits_match_reference_f32():
    ref, model = _pair()
    ids = _ids()
    want = ref(paddle.to_tensor(ids)).numpy()
    got = model(torch.from_numpy(ids)).detach().numpy()
    assert got.shape == (2, 16, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # the blocks carry the reference's names
    assert [n for n, _ in model.named_parameters()][2] == "gpt.h.0.ln_1.weight"
    assert model.gpt.blocks[0] is model.gpt.h[0]


def test_bf16_logits_within_one_rounding():
    ref, model = _pair(dtype="bfloat16")
    ids = _ids(seed=1)
    want = np.asarray(ref(paddle.to_tensor(ids))._value, np.float32)
    got = model(torch.from_numpy(ids)).detach().float().numpy()
    assert model.lm_head.weight.dtype == torch.bfloat16
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def _crit(cfg, lm_head):
    """scripts/bench_suite.py's criterion: the fused lm-head + CE over the
    flattened hidden states against the ids."""
    def crit(out, labels):
        return fused_linear_cross_entropy(
            out.reshape(-1, cfg.hidden_size), lm_head.weight,
            labels.reshape(-1), chunk_rows=cfg.lce_chunk_rows)
    return crit


@pytest.mark.parametrize("fuse", [False, True])
def test_train_steps_match_reference(fuse):
    kw = dict(fuse_linear_cross_entropy=fuse, lce_chunk_rows=8)
    ref, model = _pair(**kw)
    ids = _ids()
    if fuse:
        from paddle_tpu.incubate.nn.functional import (
            fused_linear_cross_entropy as ref_flce)

        def ref_crit(out, labels):
            return ref_flce(out.reshape([-1, 64]), ref.lm_head.weight,
                            labels.reshape([-1]), chunk_rows=8)
        crit = _crit(model.config, model.lm_head)
    else:
        ref_ce = paddle.nn.CrossEntropyLoss()

        def ref_crit(out, labels):
            return ref_ce(out.reshape([-1, 128]), labels.reshape([-1]))

        def crit(out, labels):
            return F.cross_entropy(out.reshape(-1, 128), labels.reshape(-1))
    ref_step = RefStep(ref, ref_crit,
                       paddle.optimizer.AdamW(LR, parameters=ref.parameters()))
    ids_r = paddle.to_tensor(ids)
    ref_losses = [float(ref_step(ids_r, ids_r)) for _ in range(STEPS)]
    step = JittedTrainStep(model, crit,
                           AdamW(LR, parameters=model.parameters()))
    ids_t = torch.from_numpy(ids)
    losses = [float(step(ids_t, ids_t)) for _ in range(STEPS)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    assert losses[-1] < losses[0]
    names = [n for n, _ in ref.named_parameters()]
    want = paddle_tpu_arrays_to_port(
        model, {n: np.asarray(v) for n, v in zip(names, ref_step.params)})
    for name, p in model.named_parameters():
        diff = np.abs(p.detach().numpy() - want[name])
        assert diff.max() <= 2 * LR * STEPS, name
        if name.endswith("qkv.bias"):
            diff = np.delete(diff, slice(64, 128))  # (3, H, D): q, k, v
        far = int((diff > 1e-5 * np.abs(want[name]).max()).sum())
        assert far <= max(1, 1e-3 * diff.size), (name, far, diff.size)


def test_fused_lce_contract():
    """With fuse_linear_cross_entropy forward returns the hidden states,
    and the fused criterion over them with the lm head's weight is the
    loss of the unfused logits."""
    ids = torch.from_numpy(_ids())
    fused = GPTForCausalLM(GPTConfig.tiny(fuse_linear_cross_entropy=True,
                                          lce_chunk_rows=8), device="cpu")
    plain = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    plain.load_state_dict(fused.state_dict())
    hidden = fused(ids)
    assert hidden.shape == (2, 16, 64)
    loss = _crit(fused.config, fused.lm_head)(hidden, ids)
    want = F.cross_entropy(plain(ids).reshape(-1, 128), ids.reshape(-1))
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=1e-5)
    # the carried lm head is the reference's (H, V) weight transposed: the
    # (V, H) layout the fused criterion takes
    ref, model = _pair()
    np.testing.assert_array_equal(model.lm_head.weight.detach().numpy(),
                                  ref.lm_head.weight.numpy().T)


def test_recompute_matches_plain():
    """Mirrors tests/test_nlp_models.py's recompute test on the port."""
    ids = torch.from_numpy(_ids())

    def loss_with(recompute, gran="full"):
        m = GPTForCausalLM(GPTConfig.tiny(use_recompute=recompute,
                                          recompute_granularity=gran),
                           device="cpu",
                           generator=torch.Generator().manual_seed(0))
        loss = F.cross_entropy(m(ids).reshape(-1, 128), ids.reshape(-1))
        loss.backward()
        return float(loss.detach()), m.gpt.blocks[0].qkv.weight.grad.numpy()

    l0, g0 = loss_with(False)
    for gran in ("full", "selective"):
        l1, g1 = loss_with(True, gran)
        assert abs(l0 - l1) < 1e-5, gran
        np.testing.assert_allclose(g0, g1, rtol=1e-4, atol=1e-6,
                                   err_msg=gran)
    with pytest.raises(ValueError, match="recompute_granularity"):
        loss_with(True, "core_attn")


def test_greedy_generate_matches_reference():
    ref, model = _pair(seed=3)
    ids = _ids(b=2, s=6, seed=4)
    want = ref.generate(paddle.to_tensor(ids), max_new_tokens=5).numpy()
    got = model.generate(torch.from_numpy(ids), max_new_tokens=5)
    assert got.shape == (2, 11)
    np.testing.assert_array_equal(got.numpy(), want)
    # eos: stops once every row emitted it
    eos = int(want[0, 6])
    if (want[:, 6] == eos).all():
        assert model.generate(torch.from_numpy(ids), 5,
                              eos_token_id=eos).shape == (2, 7)
    with pytest.raises(TypeError, match="unsupported kwargs"):
        model.generate(torch.from_numpy(ids), 2, top_k=3)
    with pytest.raises(TypeError, match="unsupported kwargs"):
        ref.generate(paddle.to_tensor(ids), 2, top_k=3)
    for m, i in ((model, torch.from_numpy(ids)), (ref, paddle.to_tensor(ids))):
        with pytest.raises(NotImplementedError, match="greedy_search only"):
            m.generate(i, 2, decode_strategy="sampling")


def test_tensor_parallel_refuses():
    with pytest.raises(NotImplementedError, match="A7"):
        GPTForCausalLM(GPTConfig.tiny(tensor_parallel=True), device="cpu")


def test_gelu_is_erf_and_layer_norm_matches_reference():
    import paddle_tpu.nn.functional as RF

    r = np.random.RandomState(5)
    x = r.randn(3, 7, 16).astype(np.float32) * 3
    w, b = r.randn(16).astype(np.float32), r.randn(16).astype(np.float32)
    xt = torch.from_numpy(x)
    for approx in (False, True):
        np.testing.assert_allclose(
            F.gelu(xt, approximate=approx).numpy(),
            RF.gelu(paddle.to_tensor(x), approximate=approx).numpy(),
            rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        F.layer_norm(xt, 16, torch.from_numpy(w), torch.from_numpy(b)).numpy(),
        RF.layer_norm(paddle.to_tensor(x), 16, paddle.to_tensor(w),
                      paddle.to_tensor(b)).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(F.tanh(xt).numpy(), np.tanh(x), rtol=1e-6)
    assert torch.equal(F.dropout(xt, 0.5, training=False), xt)
    kept = F.dropout(xt, 0.5, generator=torch.Generator().manual_seed(0))
    assert set(np.unique(np.round(kept.numpy() / np.where(x == 0, 1, x),
                                  5))) <= {0.0, 2.0}
