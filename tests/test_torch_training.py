"""The port's training slice held against paddle_tpu's: AdamW (f32, and
multi_precision with bf16 moments), the learning-rate schedules, global
norm clipping, the pretraining criterion (fused and unfused) and
JittedTrainStep end to end on ``LlamaConfig.tiny``.

Inputs and weights are made with numpy (or by the reference from its seed
and carried over) and fed to both packages. Tolerances, each with its
reason:
- optimizer updates in f32: ``1e-6`` relative (the same f32 formula with
  the same f32 scalars; the two libraries' elementwise kernels may still
  differ in the last bit);
- bf16 parameters: one bf16 rounding step (``2^-7``) of the f32 masters,
  which agree to ``1e-6``;
- step-1 gradients: ``1e-5`` of each tensor's largest |g| (two decoder
  layers of f32 products summed in other orders);
- losses of three steps: ``1e-5`` relative (f32 losses of the same
  parameters, summed in another order);
- parameters after three steps: Adam's first steps move a parameter by
  about ``lr * sign(g)``, so a gradient within rounding of zero may take
  the other sign on the other side and move that element by up to
  ``2 * lr`` per step. The test holds every element within
  ``2 * lr * steps`` and all but 0.1% of them within ``1e-5``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import JittedTrainStep as RefStep
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import LlamaPretrainingCriterion as RefCriterion
from paddle_tpu.optimizer import lr as ref_lr
from paddle_tpu.optimizer.clip import ClipGradByGlobalNorm as RefClip
from paddle_tpu_torch.jit import JittedTrainStep
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  LlamaPretrainingCriterion,
                                  load_paddle_tpu_arrays,
                                  paddle_tpu_arrays_to_port)
from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, lr
from paddle_tpu_torch.profiler import MFUMeter, transformer_train_flops

LR = 1e-3
STEPS = 3


# ------------------------------------------------------------ optimizer
def _opt_data(seed=0):
    r = np.random.RandomState(seed)
    shapes = {"w0": (8, 16), "w1": (16,), "bias": (5,)}
    params = {n: r.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: r.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(STEPS)]
    return params, grads


def _run_ref(params, grads, dtype, make_opt):
    ps = {}
    for n, a in params.items():
        t = paddle.to_tensor(a)
        if dtype != "float32":
            t = t.astype(dtype)
        t.stop_gradient = False
        t.name = n
        ps[n] = t
    opt = make_opt(list(ps.values()))
    for g in grads:
        loss = sum((ps[n].astype("float32") * paddle.to_tensor(g[n])).sum()
                   for n in ps)
        loss.backward()
        opt.step()
        opt.clear_grad()
        _step_lr(opt)
    masters = {n: np.asarray(opt._states[id(p)].get("master", p._value),
                             np.float32) for n, p in ps.items()}
    return {n: np.asarray(p._value, np.float32) for n, p in ps.items()}, \
        masters


def _run_port(params, grads, dtype, make_opt):
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    ps = {n: torch.nn.Parameter(torch.from_numpy(a.copy()).to(tdt))
          for n, a in params.items()}
    opt = make_opt(list(ps.items()))
    for g in grads:
        loss = sum((ps[n].float() * torch.from_numpy(g[n])).sum()
                   for n in ps)
        loss.backward()
        opt.step()
        opt.clear_grad()
        _step_lr(opt)
    masters = {n: opt._states[id(p)].get("master", p).detach().float()
               .numpy() for n, p in ps.items()}
    return {n: p.detach().float().numpy() for n, p in ps.items()}, masters


def _step_lr(opt):
    sched = opt._lr
    if hasattr(sched, "step"):
        sched.step()


def _no_bias(name):
    return name != "bias"


@pytest.mark.parametrize("variant", ["f32", "bf16_master", "clip_sched"])
def test_adamw_matches_reference(variant):
    params, grads = _opt_data()
    dtype = "float32" if variant != "bf16_master" else "bfloat16"
    kw = dict(weight_decay=0.01, apply_decay_param_fun=_no_bias)
    if variant == "bf16_master":
        kw.update(multi_precision=True, moment_dtype="bfloat16")

    def ref_opt(ps):
        extra = {}
        rate = 0.05
        if variant == "clip_sched":
            extra["grad_clip"] = RefClip(1.0)
            rate = ref_lr.LinearWarmup(
                ref_lr.CosineAnnealingDecay(0.05, T_max=4), 2, 0.0, 0.05)
        return paddle.optimizer.AdamW(rate, parameters=ps, **kw, **extra)

    def port_opt(ps):
        extra = {}
        rate = 0.05
        if variant == "clip_sched":
            extra["grad_clip"] = ClipGradByGlobalNorm(1.0)
            rate = lr.LinearWarmup(lr.CosineAnnealingDecay(0.05, T_max=4),
                                   2, 0.0, 0.05)
        return AdamW(rate, parameters=ps, **kw, **extra)

    ref_p, ref_m = _run_ref(params, grads, dtype, ref_opt)
    got_p, got_m = _run_port(params, grads, dtype, port_opt)
    for n in params:
        np.testing.assert_allclose(got_m[n], ref_m[n], rtol=1e-6, atol=1e-7)
        if dtype == "bfloat16":
            np.testing.assert_allclose(got_p[n], ref_p[n], rtol=2.0 ** -7)
        else:
            np.testing.assert_allclose(got_p[n], ref_p[n], rtol=1e-6,
                                       atol=1e-7)
    assert not np.allclose(got_m["w0"], params["w0"], atol=1e-3)


def test_lr_schedules_match_reference():
    pairs = [
        (lr.LinearWarmup(0.1, 3, 0.0, 0.1),
         ref_lr.LinearWarmup(0.1, 3, 0.0, 0.1)),
        (lr.CosineAnnealingDecay(0.1, T_max=5, eta_min=0.01),
         ref_lr.CosineAnnealingDecay(0.1, T_max=5, eta_min=0.01)),
        (lr.LinearWarmup(lr.CosineAnnealingDecay(0.1, T_max=6), 2, 0.0, 0.1),
         ref_lr.LinearWarmup(ref_lr.CosineAnnealingDecay(0.1, T_max=6), 2,
                             0.0, 0.1)),
    ]
    for port, ref in pairs:
        got, want = [], []
        for _ in range(10):
            got.append(port())
            want.append(ref())
            port.step()
            ref.step()
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_clip_grad_by_global_norm_matches_reference():
    r = np.random.RandomState(4)
    grads = [r.randn(3, 4).astype(np.float32) * 3, r.randn(7).astype(
        np.float32)]
    want = RefClip(1.5).clip_values([paddle.to_tensor(g)._value
                                     for g in grads])
    got = ClipGradByGlobalNorm(1.5).clip_values(
        [torch.from_numpy(g) for g in grads])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_mfu_meter_without_a_known_card():
    flops = transformer_train_flops(1000, 64, num_layers=2, seq_len=64,
                                    hidden=16)
    assert flops == 6.0 * 1000 * 64 + 0.5 * 12.0 * 2 * 64 * 16 * 64
    res = MFUMeter(flops, 64).measure(lambda: None, warmup=1, iters=3,
                                      sync=lambda r: None)
    assert res["mfu"] is None and res["n_steps_timed"] == 3


# --------------------------------------------------------- whole slice
def _ids():
    return np.random.RandomState(0).randint(0, 128, (2, 64))


def _ref_model(fuse):
    paddle.seed(0)
    cfg = RefConfig.tiny(tensor_parallel=False,
                         fuse_linear_cross_entropy=fuse)
    model = RefLM(cfg)
    crit = RefCriterion(cfg, lm_head=model.lm_head if fuse else None)
    return model, crit


def _port_model(ref, fuse):
    cfg = LlamaConfig.tiny(tensor_parallel=False,
                           fuse_linear_cross_entropy=fuse)
    model = LlamaForCausalLM(cfg, device="cpu")
    load_paddle_tpu_arrays(model, {k: np.asarray(v.numpy()) for k, v in
                                   ref.state_dict().items()})
    crit = LlamaPretrainingCriterion(cfg,
                                     lm_head=model.lm_head if fuse else None)
    return model, crit


@pytest.mark.parametrize("fuse", [False, True])
def test_criterion_step1_grads_match_reference(fuse):
    ids = _ids()
    ref, ref_crit = _ref_model(fuse)
    loss_ref = ref_crit(ref(paddle.to_tensor(ids)), paddle.to_tensor(ids))
    loss_ref.backward()
    ref_grads = paddle_tpu_arrays_to_port(
        _port_model(ref, fuse)[0],
        {n: np.asarray(p.grad._value) for n, p in ref.named_parameters()})
    model, crit = _port_model(ref, fuse)
    ids_t = torch.from_numpy(ids)
    loss = crit(model(ids_t), ids_t)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref),
                               rtol=1e-6)
    for name, p in model.named_parameters():
        want = ref_grads[name]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


@pytest.mark.parametrize("fuse", [False, True])
def test_train_step_matches_reference(fuse):
    ids = _ids()
    ref, ref_crit = _ref_model(fuse)
    model, crit = _port_model(ref, fuse)
    ref_opt = paddle.optimizer.AdamW(LR, parameters=ref.parameters())
    ref_step = RefStep(ref, lambda o, l: ref_crit(o, l), ref_opt)
    ids_r = paddle.to_tensor(ids)
    ref_losses = [float(ref_step(ids_r, ids_r)) for _ in range(STEPS)]

    step = JittedTrainStep(model, crit, AdamW(LR,
                                              parameters=model.parameters()))
    ids_t = torch.from_numpy(ids)
    losses = [step(ids_t, ids_t) for _ in range(STEPS)]
    assert all(l.dim() == 0 for l in losses)
    np.testing.assert_allclose([float(l) for l in losses], ref_losses,
                               rtol=1e-5)

    names = [n for n, _ in ref.named_parameters()]
    want = paddle_tpu_arrays_to_port(
        model, {n: np.asarray(v) for n, v in zip(names, ref_step.params)})
    far = total = 0
    for name, p in zip([n for n, _ in model.named_parameters()],
                       step.params):
        diff = np.abs(p.detach().numpy() - want[name])
        assert diff.max() <= 2 * LR * STEPS, name
        far += int((diff > 1e-5).sum())
        total += diff.size
    assert far <= 1e-3 * total, (far, total)


def test_run_steps_equals_single_steps_and_syncs_state():
    ids = torch.from_numpy(_ids())
    losses = []
    for stacked in (False, True):
        ref, _ = _ref_model(False)
        model, crit = _port_model(ref, False)
        opt = AdamW(LR, parameters=model.named_parameters(),
                    multi_precision=True)
        step = JittedTrainStep(model, crit, opt)
        if stacked:
            losses.append(step.run_steps(torch.stack([ids] * STEPS),
                                         torch.stack([ids] * STEPS)))
        else:
            losses.append(torch.stack([step(ids, ids)
                                       for _ in range(STEPS)]))
        step.sync_to_model()
        assert opt._step_count == STEPS
        assert len(opt.state_dict()) == 1 + 2 * len(step.params)
    assert losses[0].shape == (STEPS,)
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)
    assert float(losses[0][-1]) < float(losses[0][0])


def test_train_step_refuses_mesh_options():
    """The mesh options are ported (tests/test_torch_fleet.py runs them
    across ranks); without a mesh they change nothing, as in the
    reference (``paddle_tpu/jit/train.py``: ``if state_sharding_axis and
    mesh_state.has_mesh()``)."""
    ids = torch.from_numpy(np.random.RandomState(3).randint(0, 128, (2, 16)))
    losses = []
    for kw in ({}, {"state_sharding_axis": "sharding",
                    "input_batch_axes": ("dp",)}):
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        opt = AdamW(LR, parameters=model.parameters())
        step = JittedTrainStep(model, LlamaPretrainingCriterion(), opt, **kw)
        losses.append([float(step(ids, ids)) for _ in range(2)])
        assert step._optimizer is opt
    assert losses[0] == losses[1]
