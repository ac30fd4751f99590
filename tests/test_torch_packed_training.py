"""Packed (cu_seqlens) Llama pretraining and recompute in the port, held
against paddle_tpu: rotary positions restarting per segment, attention
that never crosses a segment (F.flash_attn_unpadded: K3 forward, K8
backward, their plain versions on the CPU), the packed criterion (unfused
masked mean and fused ``ignore_index``), a packed ``JittedTrainStep``, and
recompute at the reference's four granularities.

Inputs and weights are made with numpy (or by the reference from its seed
and carried over) and fed to both packages. Tolerances, each with its
reason:
- logits: ``2e-4`` (the reference's own packed-vs-alone tolerance: two
  decoder layers of f32 products summed in other orders);
- losses: ``1e-6`` relative at step 1, ``1e-5`` over three steps (f32
  losses of the same parameters, summed in another order);
- step-1 gradients: ``1e-5`` of each tensor's largest |g|;
- recompute against no recompute: equal (the same arithmetic run again).
"""
import numpy as np
import pytest
import torch
from torch import nn

import paddle_tpu as paddle
from paddle_tpu.jit.train import JittedTrainStep as RefStep
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import LlamaPretrainingCriterion as RefCriterion
from paddle_tpu.nlp.llama import packed_position_ids as ref_position_ids
from paddle_tpu_torch.distributed.fleet.utils import (recompute,
                                                      recompute_sequential)
from paddle_tpu_torch.jit import JittedTrainStep
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  LlamaPretrainingCriterion,
                                  load_paddle_tpu_arrays,
                                  packed_position_ids,
                                  paddle_tpu_arrays_to_port)
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-3
STEPS = 3
LENS = [20, 25, 19]        # T = 64, the reference's packed train test
LENS_ALONE = [5, 9, 2]     # tests/test_nlp_models.py's packed-vs-alone


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _ref_arrays(ref):
    return {k: np.asarray(v.numpy()) for k, v in ref.state_dict().items()}


def _pair(seed=0, **overrides):
    """The reference model and the port carrying its weights."""
    paddle.seed(seed)
    ref = RefLM(RefConfig.tiny(tensor_parallel=False, **overrides))
    port = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False,
                                             **overrides), device="cpu")
    load_paddle_tpu_arrays(port, _ref_arrays(ref))
    return ref, port


def test_packed_position_ids_match_reference():
    cu = _cu([5, 0, 9, 2, 0])
    want = np.asarray(ref_position_ids(paddle.to_tensor(cu), 19).numpy())
    got = packed_position_ids(torch.from_numpy(cu), 19)
    assert got.shape == (1, 19)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [None, 6])
def test_packed_logits_equal_each_segment_alone(window):
    """Each packed segment's logits equal that segment forwarded alone,
    and the reference's packed logits; with a window shorter than some
    segments, the band applies per segment."""
    lens = LENS_ALONE if window is None else [9, 4, 14]
    ref, port = _pair(11, sliding_window=window)
    rng = np.random.RandomState(3 if window is None else 7)
    ids = rng.randint(1, 128, (1, sum(lens))).astype(np.int64)
    cu = _cu(lens)
    want = np.asarray(ref(paddle.to_tensor(ids),
                          cu_seqlens=paddle.to_tensor(cu)).numpy())
    with torch.no_grad():
        got = port(torch.from_numpy(ids),
                   cu_seqlens=torch.from_numpy(cu)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        for a, b in zip(cu[:-1], cu[1:]):
            alone = port(torch.from_numpy(ids[:, a:b])).numpy()
            np.testing.assert_allclose(got[:, a:b], alone, rtol=2e-4,
                                       atol=2e-4)


@pytest.mark.parametrize("fuse", [False, True])
def test_packed_criterion_is_the_per_segment_mean(fuse):
    """The packed criterion leaves the cross-segment targets out: it is
    the mean over segments' own shifted targets, and equals the
    reference's packed criterion."""
    ref, port = _pair(11, fuse_linear_cross_entropy=fuse)
    ids = np.random.RandomState(3).randint(1, 128, (1, 16)).astype(np.int64)
    cu = _cu(LENS_ALONE)
    ref_crit = RefCriterion(ref.config, lm_head=ref.lm_head if fuse
                            else None)
    want = float(ref_crit(ref(paddle.to_tensor(ids),
                              cu_seqlens=paddle.to_tensor(cu)),
                          paddle.to_tensor(ids),
                          cu_seqlens=paddle.to_tensor(cu)))
    crit = LlamaPretrainingCriterion(port.config, lm_head=port.lm_head
                                     if fuse else None)
    ids_t, cu_t = torch.from_numpy(ids), torch.from_numpy(cu)
    with torch.no_grad():
        got = float(crit(port(ids_t, cu_seqlens=cu_t), ids_t,
                         cu_seqlens=cu_t))
        per_tok = []
        for a, b in zip(cu[:-1], cu[1:]):
            seg = ids_t[:, a:b]
            if seg.shape[1] < 2:
                continue
            logits = port.lm_head(port.llama(seg)[0]) if fuse else port(seg)
            per_tok.append(torch.nn.functional.cross_entropy(
                logits[0, :-1].float(), seg[0, 1:], reduction="none"))
        mean = float(torch.cat(per_tok).mean())
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, mean, rtol=1e-6)


class _RefPacked(paddle.nn.Layer):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, cu):
        return self.m(ids, cu_seqlens=cu)


class _Packed(nn.Module):
    """``model(ids, cu)``: the packed call as a train step makes it."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, cu):
        return self.m(ids, cu_seqlens=cu)


def _packed_models(fuse, seed=0):
    ref, port = _pair(seed, fuse_linear_cross_entropy=fuse)
    ref_crit = RefCriterion(ref.config, lm_head=ref.lm_head if fuse
                            else None)
    crit = LlamaPretrainingCriterion(port.config, lm_head=port.lm_head
                                     if fuse else None)
    return ref, ref_crit, port, crit


def _packed_batch():
    ids = np.random.RandomState(0).randint(0, 128, (1, sum(LENS)))
    return ids, _cu(LENS)


@pytest.mark.parametrize("fuse", [False, True])
def test_packed_step1_grads_match_reference(fuse):
    ids, cu = _packed_batch()
    ref, ref_crit, port, crit = _packed_models(fuse)
    loss_ref = ref_crit(ref(paddle.to_tensor(ids),
                            cu_seqlens=paddle.to_tensor(cu)),
                        paddle.to_tensor(ids),
                        cu_seqlens=paddle.to_tensor(cu))
    loss_ref.backward()
    want = paddle_tpu_arrays_to_port(
        port, {n: np.asarray(p.grad._value)
               for n, p in ref.named_parameters()})
    ids_t, cu_t = torch.from_numpy(ids), torch.from_numpy(cu)
    loss = crit(port(ids_t, cu_seqlens=cu_t), ids_t, cu_seqlens=cu_t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-6)
    for name, p in port.named_parameters():
        w = want[name]
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("fuse", [False, True])
def test_packed_train_step_matches_reference(fuse):
    """Three packed steps through ``run_steps`` with the ids and the
    cu_seqlens stacked along the step axis, as the reference's packed
    benchmark feeds them."""
    ids, cu = _packed_batch()
    ref, ref_crit, port, crit = _packed_models(fuse)
    ref_model = _RefPacked(ref)
    ref_step = RefStep(ref_model, lambda o, l, c: ref_crit(o, l,
                                                           cu_seqlens=c),
                       paddle.optimizer.AdamW(
                           LR, parameters=ref_model.parameters()))
    ids_r, cu_r = paddle.to_tensor(ids), paddle.to_tensor(cu)
    ref_losses = [float(ref_step([ids_r, cu_r], [ids_r, cu_r]))
                  for _ in range(STEPS)]

    model = _Packed(port)
    step = JittedTrainStep(model, lambda o, l, c: crit(o, l, cu_seqlens=c),
                           AdamW(LR, parameters=model.parameters()))
    ids_t = torch.from_numpy(ids)[None].expand(STEPS, 1, -1)
    cu_t = torch.from_numpy(cu)[None].expand(STEPS, -1)
    losses = step.run_steps([ids_t, cu_t], [ids_t, cu_t])
    assert losses.shape == (STEPS,)
    np.testing.assert_allclose(losses.numpy(), ref_losses, rtol=1e-5)
    assert float(losses[-1]) < float(losses[0])


def _recompute_run(gran, use_recompute, packed=True):
    """Step-1 grads and three losses of the tiny model, packed."""
    torch.manual_seed(0)
    cfg = LlamaConfig.tiny(tensor_parallel=False,
                           use_recompute=use_recompute,
                           recompute_granularity=gran)
    model = LlamaForCausalLM(cfg, device="cpu")
    crit = LlamaPretrainingCriterion(cfg)
    ids, cu = _packed_batch()
    ids_t = torch.from_numpy(ids)
    cu_t = torch.from_numpy(cu) if packed else None
    loss = crit(model(ids_t, cu_seqlens=cu_t), ids_t, cu_seqlens=cu_t)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    wrapped = _Packed(model)
    step = JittedTrainStep(wrapped,
                           lambda o, l, c: crit(o, l, cu_seqlens=c),
                           AdamW(LR, parameters=wrapped.parameters()))
    losses = [float(step([ids_t, torch.from_numpy(cu)],
                         [ids_t, torch.from_numpy(cu)]))
              for _ in range(STEPS)]
    return grads, losses


@pytest.mark.parametrize("gran", ["full", "full_attn", "core_attn",
                                  "selective"])
def test_recompute_granularities_match_no_recompute(gran):
    grads, losses = _recompute_run(gran, True)
    want_grads, want_losses = _recompute_run(gran, False)
    assert losses == want_losses
    for name, g in grads.items():
        torch.testing.assert_close(g, want_grads[name], rtol=0, atol=0,
                                   msg=name)


def test_recompute_unpacked_matches_reference_losses():
    """Recompute on the unpacked path tracks the reference's recompute
    losses (tests/test_nlp_models.py's granularity test)."""
    ids = np.random.RandomState(3).randint(0, 128, (2, 32))
    paddle.seed(0)
    cfg = RefConfig.tiny(tensor_parallel=False, use_recompute=True,
                         recompute_granularity="full")
    ref = RefLM(cfg)
    port = LlamaForCausalLM(LlamaConfig.tiny(
        tensor_parallel=False, use_recompute=True,
        recompute_granularity="full"), device="cpu")
    # carried before the reference's step, which donates its arrays
    load_paddle_tpu_arrays(port, _ref_arrays(ref))
    ref_crit = RefCriterion()
    ref_step = RefStep(ref, lambda o, l: ref_crit(o, l),
                       paddle.optimizer.AdamW(LR,
                                              parameters=ref.parameters()))
    ids_r = paddle.to_tensor(ids)
    want = [float(ref_step(ids_r, ids_r)) for _ in range(2)]
    crit = LlamaPretrainingCriterion()
    step = JittedTrainStep(port, crit, AdamW(LR,
                                             parameters=port.parameters()))
    ids_t = torch.from_numpy(ids)
    got = [float(step(ids_t, ids_t)) for _ in range(2)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bad_recompute_granularity_raises():
    cfg = LlamaConfig.tiny(tensor_parallel=False, use_recompute=True,
                           recompute_granularity="bogus")
    model = LlamaForCausalLM(cfg, device="cpu")
    with pytest.raises(ValueError, match="recompute_granularity"):
        model(torch.zeros(1, 8, dtype=torch.long))


def test_core_attn_recompute_grads_flow():
    """Attention-only recompute still reaches the attention's weights."""
    cfg = LlamaConfig.tiny(tensor_parallel=False, use_recompute=True,
                           recompute_granularity="core_attn")
    model = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 128,
                                                            (2, 16)))
    LlamaPretrainingCriterion()(model(ids), ids).backward()
    q = model.llama.layers[0].self_attn.q_proj.weight
    assert q.grad is not None and float(q.grad.abs().sum()) > 0


def test_recompute_sequential_matches_the_plain_chain():
    torch.manual_seed(1)
    layers = nn.Sequential(*[nn.Linear(8, 8) for _ in range(5)])
    x = torch.randn(3, 8, requires_grad=True)
    out = recompute_sequential({"segments": 2}, layers, x)
    out.sum().backward()
    got = [x.grad.clone()] + [p.grad.clone() for p in layers.parameters()]
    x.grad = None
    layers.zero_grad()
    layers(x).sum().backward()
    want = [x.grad] + [p.grad for p in layers.parameters()]
    torch.testing.assert_close(out, layers(x), rtol=0, atol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # a bound method, the reference's use_reentrant flag taken and ignored
    y = recompute(layers[0].forward, x, use_reentrant=True)
    torch.testing.assert_close(y, layers[0](x), rtol=0, atol=0)


def test_packed_path_refuses_caches_and_batches():
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    cu = torch.tensor([0, 3, 8], dtype=torch.int32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        model(torch.zeros(1, 8, dtype=torch.long),
              caches=model.init_caches(1, 8), cu_seqlens=cu)
    with pytest.raises(ValueError, match=r"\(1, T\)"):
        model(torch.zeros(2, 8, dtype=torch.long), cu_seqlens=cu)
    with pytest.raises(ValueError, match="batch 1"):
        LlamaPretrainingCriterion()(torch.zeros(2, 8, 128),
                                    torch.zeros(2, 8, dtype=torch.long),
                                    cu_seqlens=cu)
