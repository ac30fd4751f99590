"""The port's optimizers, weight decays, learning-rate schedules, gradient
clips and ``incubate.optimizer`` held against paddle_tpu's.

Every optimizer runs 6 seeded steps on both packages from the same f32
parameters with the same gradients (injected exactly: the loss is
``sum(p * G)``, so the gradient is ``G``). Tolerances, each with its
reason:
- f32 parameters, accumulators and masters: ``1e-6`` relative and
  absolute (the same f32 formula with the same f32 scalars; the two
  libraries' elementwise kernels may differ in the last bit);
- bf16 parameters: one bf16 rounding step (``2^-7`` relative) of masters
  that agree to ``1e-6``;
- LBFGS: ``1e-5`` (its direction is a chain of f32 dot products, summed
  in other orders);
- learning-rate sequences: ``1e-12`` (the same Python-float formulas).
"""
import math
import types

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.incubate.optimizer as ref_incubate
import paddle_tpu.optimizer as ref_optimizer
import paddle_tpu.optimizer.clip as ref_clip
import paddle_tpu.optimizer.lr as ref_lr
import paddle_tpu.regularizer as ref_regularizer
import paddle_tpu_torch.incubate.optimizer as port_incubate
import paddle_tpu_torch.optimizer as port_optimizer
import paddle_tpu_torch.optimizer.clip as port_clip
import paddle_tpu_torch.optimizer.lr as port_lr
import paddle_tpu_torch.regularizer as port_regularizer

STEPS = 6
REF = types.SimpleNamespace(opt=ref_optimizer, reg=ref_regularizer,
                            clip=ref_clip, lr=ref_lr, inc=ref_incubate)
PORT = types.SimpleNamespace(opt=port_optimizer, reg=port_regularizer,
                             clip=port_clip, lr=port_lr, inc=port_incubate)


def _data(seed=0, steps=STEPS):
    r = np.random.RandomState(seed)
    shapes = {"w0": (8, 16), "w1": (16,), "b": (5,)}
    params = {n: r.randn(*s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: r.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(steps)]
    return params, grads


def _run(ns, make, params, grads, dtype="float32", sched=None):
    """``steps`` eager steps; returns (params as f32 numpy, optimizer,
    param handles)."""
    port = ns is PORT
    ps = {}
    for n, a in params.items():
        if port:
            t = torch.from_numpy(a.copy()).to(getattr(torch, dtype))
            t.requires_grad_()
        else:
            t = paddle.to_tensor(a)
            if dtype != "float32":
                t = t.astype(dtype)
            t.stop_gradient = False
            t.name = n
        ps[n] = t
    opt = make(ns, list(ps.items()) if port else list(ps.values()))
    for g in grads:
        if port:
            loss = sum((ps[n].float() * torch.from_numpy(g[n])).sum()
                       for n in ps)
        else:
            loss = sum((ps[n].astype("float32") * paddle.to_tensor(g[n]))
                       .sum() for n in ps)
        loss.backward()
        opt.step()
        opt.clear_grad()
        if sched is not None:
            opt._lr.step()
    out = {n: (t.detach().float().numpy() if port
               else np.asarray(t._value, np.float32)) for n, t in ps.items()}
    return out, opt, ps


def _state_np(opt, ps, port):
    out = {}
    for n, p in ps.items():
        for k, v in opt._states.get(id(p), {}).items():
            out[f"{n}_{k}"] = (v.detach().float().numpy() if port
                               else np.asarray(v, np.float32))
    return out


CASES = {
    "sgd": lambda ns, ps: ns.opt.SGD(0.1, parameters=ps),
    "sgd_l2": lambda ns, ps: ns.opt.SGD(
        0.1, parameters=ps, weight_decay=ns.reg.L2Decay(0.01)),
    "sgd_l1": lambda ns, ps: ns.opt.SGD(
        0.1, parameters=ps, weight_decay=ns.reg.L1Decay(0.01)),
    "sgd_float_decay": lambda ns, ps: ns.opt.SGD(0.1, parameters=ps,
                                                 weight_decay=0.02),
    "momentum": lambda ns, ps: ns.opt.Momentum(0.1, 0.9, parameters=ps),
    "momentum_nesterov_l2": lambda ns, ps: ns.opt.Momentum(
        0.1, 0.9, parameters=ps, use_nesterov=True,
        weight_decay=ns.reg.L2Decay(0.005)),
    "adam": lambda ns, ps: ns.opt.Adam(0.01, parameters=ps),
    "adam_l1": lambda ns, ps: ns.opt.Adam(
        0.01, parameters=ps, weight_decay=ns.reg.L1Decay(0.003)),
    "adamw_lr_ratio_decay_fun": lambda ns, ps: ns.opt.AdamW(
        0.01, parameters=ps, weight_decay=0.05, lr_ratio=lambda p: 0.5,
        apply_decay_param_fun=lambda n: n != "b"),
    "adamax": lambda ns, ps: ns.opt.Adamax(0.01, parameters=ps),
    "adagrad": lambda ns, ps: ns.opt.Adagrad(
        0.1, parameters=ps, initial_accumulator_value=0.1),
    "adadelta": lambda ns, ps: ns.opt.Adadelta(1.0, rho=0.9, parameters=ps),
    "rmsprop": lambda ns, ps: ns.opt.RMSProp(0.01, parameters=ps),
    "rmsprop_centered_momentum": lambda ns, ps: ns.opt.RMSProp(
        0.01, momentum=0.9, centered=True, parameters=ps),
    "lamb": lambda ns, ps: ns.opt.Lamb(
        0.01, parameters=ps,
        exclude_from_weight_decay_fn=lambda p: len(p.shape) == 1),
    "lars_momentum": lambda ns, ps: ns.opt.LarsMomentum(0.1,
                                                        parameters=ps),
    "rprop": lambda ns, ps: ns.opt.Rprop(0.01, parameters=ps),
    "nadam": lambda ns, ps: ns.opt.NAdam(0.01, parameters=ps),
    "radam": lambda ns, ps: ns.opt.RAdam(0.01, parameters=ps),
    "asgd": lambda ns, ps: ns.opt.ASGD(0.1, batch_num=3, parameters=ps),
    "adam_clip_value": lambda ns, ps: ns.opt.Adam(
        0.01, parameters=ps, grad_clip=ns.clip.ClipGradByValue(0.5)),
    "sgd_clip_norm": lambda ns, ps: ns.opt.SGD(
        0.1, parameters=ps, grad_clip=ns.clip.ClipGradByNorm(1.0)),
    "adamw_clip_global_norm": lambda ns, ps: ns.opt.AdamW(
        0.01, parameters=ps, grad_clip=ns.clip.ClipGradByGlobalNorm(1.0)),
    "sgd_step_decay": lambda ns, ps: ns.opt.SGD(
        ns.lr.StepDecay(0.1, step_size=2, gamma=0.5), parameters=ps),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_reference_f32(case):
    params, grads = _data(1)
    sched = "decay" in case and "step" in case
    want, ref_opt, ref_ps = _run(REF, CASES[case], params, grads,
                                 sched=sched or None)
    got, opt, ps = _run(PORT, CASES[case], params, grads,
                        sched=sched or None)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-6, atol=1e-6,
                                   err_msg=n)
    ref_st, st = _state_np(ref_opt, ref_ps, False), _state_np(opt, ps, True)
    assert sorted(st) == sorted(ref_st)
    for k in st:
        np.testing.assert_allclose(st[k], ref_st[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert opt._step_count == ref_opt._step_count == STEPS


@pytest.mark.parametrize("case", ["sgd", "momentum", "adamw", "lamb",
                                  "rprop", "asgd"])
def test_multi_precision_masters_match_reference(case):
    """bf16 parameters with f32 masters: masters within 1e-6, parameters
    within one bf16 step. SGD without masters rounds its learning rate to
    bf16 first, as the reference does."""
    make = {
        "sgd": lambda ns, ps: ns.opt.SGD(0.1, parameters=ps,
                                         multi_precision=True),
        "momentum": lambda ns, ps: ns.opt.Momentum(
            0.1, 0.9, parameters=ps, multi_precision=True),
        "adamw": lambda ns, ps: ns.opt.AdamW(
            0.01, parameters=ps, multi_precision=True),
        "lamb": lambda ns, ps: ns.opt.Lamb(0.01, parameters=ps,
                                           multi_precision=True),
        "rprop": lambda ns, ps: ns.opt.Rprop(0.01, parameters=ps,
                                             multi_precision=True),
        "asgd": lambda ns, ps: ns.opt.ASGD(0.1, batch_num=2, parameters=ps,
                                           multi_precision=True),
    }[case]
    params, grads = _data(2)
    want, ref_opt, ref_ps = _run(REF, make, params, grads, "bfloat16")
    got, opt, ps = _run(PORT, make, params, grads, "bfloat16")
    ref_st, st = _state_np(ref_opt, ref_ps, False), _state_np(opt, ps, True)
    assert sorted(st) == sorted(ref_st)
    assert any(k.endswith("_master") for k in st)
    for k in st:
        np.testing.assert_allclose(st[k], ref_st[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=2.0 ** -7,
                                   atol=1e-6, err_msg=n)


def test_sgd_bf16_without_masters_matches_reference():
    params, grads = _data(3)
    make = CASES["sgd"]
    want, _, _ = _run(REF, make, params, grads, "bfloat16")
    got, _, _ = _run(PORT, make, params, grads, "bfloat16")
    for n in want:
        np.testing.assert_array_equal(got[n], want[n], err_msg=n)


@pytest.mark.parametrize("case", ["adam", "momentum", "nadam", "rprop"])
def test_state_dict_resume_matches_uninterrupted_run(case):
    """state_dict after 3 steps holds the reference's keys; a fresh
    optimizer loaded with it (set_state_dict) continues as the
    uninterrupted run does."""
    params, grads = _data(4)
    make = CASES[case]
    full, _, _ = _run(PORT, make, params, grads)
    half, opt, ps = _run(PORT, make, params, grads[:3])
    _, ref_opt, _ = _run(REF, make, params, grads[:3])
    sd = opt.state_dict()
    assert sorted(sd) == sorted(ref_opt.state_dict())
    fresh_ps = [(n, torch.from_numpy(half[n].copy()).requires_grad_())
                for n in ps]
    fresh = make(PORT, fresh_ps)
    fresh.set_state_dict({k: v.clone() if isinstance(v, torch.Tensor)
                          else v for k, v in sd.items()})
    assert fresh._step_count == 3
    for g in grads[3:]:
        sum((p * torch.from_numpy(g[n])).sum()
            for n, p in fresh_ps).backward()
        fresh.step()
        fresh.clear_grad()
    for n, p in fresh_ps:
        np.testing.assert_array_equal(p.detach().numpy(), full[n],
                                      err_msg=n)
    with pytest.warns(RuntimeWarning, match="not found"):
        make(PORT, fresh_ps).set_state_dict({"step_count": 1})


def test_lbfgs_matches_reference():
    r = np.random.RandomState(5)
    a = r.randn(10, 6).astype(np.float32)
    b = r.randn(10).astype(np.float32)
    x0 = r.randn(6).astype(np.float32)
    runs = []
    for ns in (REF, PORT):
        port = ns is PORT
        if port:
            x = torch.from_numpy(x0.copy()).requires_grad_()
            A, B = torch.from_numpy(a), torch.from_numpy(b)
        else:
            x = paddle.to_tensor(x0, stop_gradient=False)
            A, B = paddle.to_tensor(a), paddle.to_tensor(b)
        opt = ns.opt.LBFGS(learning_rate=0.1, max_iter=3, history_size=4,
                           parameters=[x])

        def closure():
            opt.clear_grad()
            if port:
                res = A @ x - B
            else:
                res = paddle.matmul(A, x) - B
            loss = (res * res).sum()
            loss.backward()
            return loss

        losses = [float(opt.step(closure).detach()) for _ in range(5)]
        val = x.detach().numpy() if port else x.numpy()
        runs.append((losses, np.asarray(val), len(opt._hist)))
    (rl, rx, rh), (pl, px, ph) = runs
    np.testing.assert_allclose(pl, rl, rtol=1e-5)
    np.testing.assert_allclose(px, rx, rtol=1e-5, atol=1e-5)
    assert ph == rh > 0 and pl[-1] < pl[0]
    with pytest.raises(ValueError, match="closure"):
        port_optimizer.LBFGS(parameters=[torch.zeros(2)]).step()


def _sched_args(ns):
    return {
        "NoamDecay": lambda: ns.lr.NoamDecay(64, 4, learning_rate=2.0),
        "PiecewiseDecay": lambda: ns.lr.PiecewiseDecay([3, 6],
                                                       [0.1, 0.05, 0.01]),
        "NaturalExpDecay": lambda: ns.lr.NaturalExpDecay(0.1, 0.3),
        "InverseTimeDecay": lambda: ns.lr.InverseTimeDecay(0.1, 0.3),
        "PolynomialDecay": lambda: ns.lr.PolynomialDecay(0.1, 5, 0.001,
                                                         power=2.0),
        "PolynomialDecay_cycle": lambda: ns.lr.PolynomialDecay(
            0.1, 4, 0.001, cycle=True),
        "LinearWarmup": lambda: ns.lr.LinearWarmup(
            ns.lr.CosineAnnealingDecay(0.1, T_max=6), 3, 0.0, 0.1),
        "LinearWarmup_float": lambda: ns.lr.LinearWarmup(0.1, 3, 0.01, 0.1),
        "ExponentialDecay": lambda: ns.lr.ExponentialDecay(0.1, 0.8),
        "MultiStepDecay": lambda: ns.lr.MultiStepDecay(0.1, [2, 5, 9]),
        "StepDecay": lambda: ns.lr.StepDecay(0.1, 3, gamma=0.5),
        "LambdaDecay": lambda: ns.lr.LambdaDecay(0.1,
                                                 lambda e: 0.9 ** e),
        "MultiplicativeDecay": lambda: ns.lr.MultiplicativeDecay(
            0.1, lambda e: 0.95),
        "CosineAnnealingDecay": lambda: ns.lr.CosineAnnealingDecay(
            0.1, T_max=7, eta_min=0.001),
        "CosineAnnealingWarmRestarts": lambda:
            ns.lr.CosineAnnealingWarmRestarts(0.1, T_0=3, T_mult=2),
        "LinearLR": lambda: ns.lr.LinearLR(0.1, total_steps=6),
        "OneCycleLR": lambda: ns.lr.OneCycleLR(0.1, total_steps=10),
        "OneCycleLR_linear": lambda: ns.lr.OneCycleLR(
            0.1, total_steps=10, anneal_strategy="linear"),
        "CyclicLR": lambda: ns.lr.CyclicLR(0.01, 0.1, 3),
        "CyclicLR_triangular2": lambda: ns.lr.CyclicLR(
            0.01, 0.1, 2, step_size_down=3, mode="triangular2"),
        "CyclicLR_exp_range": lambda: ns.lr.CyclicLR(
            0.01, 0.1, 2, mode="exp_range", exp_gamma=0.9),
    }


@pytest.mark.parametrize("name", sorted(_sched_args(PORT)))
def test_schedule_matches_reference(name):
    seqs = []
    for ns in (REF, PORT):
        s = _sched_args(ns)[name]()
        seq = [s()]
        for _ in range(14):
            s.step()
            seq.append(s())
        seqs.append(seq)
    np.testing.assert_allclose(seqs[1], seqs[0], rtol=1e-12, atol=1e-12)


def test_every_reference_schedule_is_ported():
    assert sorted(port_lr.__all__) == sorted(ref_lr.__all__)
    assert sorted(port_optimizer.optimizer.__all__) == sorted(
        set(ref_optimizer.optimizer.__all__) | {"L1Decay", "L2Decay"})


def test_reduce_on_plateau_matches_reference():
    metrics = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8, 0.9,
               0.9]
    seqs = []
    for ns in (REF, PORT):
        s = ns.lr.ReduceOnPlateau(0.1, patience=1, cooldown=1, factor=0.5)
        seq = []
        for m in metrics:
            s.step(torch.tensor(m) if ns is PORT else m)
            seq.append((s(), s.num_bad_epochs, s.cooldown_counter))
        s.step()  # no metric: only the epoch moves
        seqs.append((seq, s.last_epoch))
    assert seqs[1] == seqs[0]


def test_schedule_state_dict_round_trip():
    s = port_lr.LinearWarmup(port_lr.StepDecay(0.1, 2), 2, 0.0, 0.1)
    for _ in range(5):
        s.step()
    sd = s.state_dict()
    t = port_lr.LinearWarmup(port_lr.StepDecay(0.1, 2), 2, 0.0, 0.1)
    t.set_state_dict(dict(sd))
    assert t() == s() and t.last_epoch == s.last_epoch
    s.step()
    t.step()
    assert t() == s()


@pytest.mark.parametrize("clip", ["value", "value_min", "norm",
                                  "global_norm"])
def test_clips_match_reference(clip):
    make = {
        "value": lambda ns: ns.clip.ClipGradByValue(0.3),
        "value_min": lambda ns: ns.clip.ClipGradByValue(0.5, min=-0.1),
        "norm": lambda ns: ns.clip.ClipGradByNorm(1.5),
        "global_norm": lambda ns: ns.clip.ClipGradByGlobalNorm(2.0),
    }[clip]
    _, grads = _data(6, steps=1)
    arrays = list(grads[0].values())
    want = make(REF).clip_values([paddle.to_tensor(a)._value
                                  for a in arrays])
    got = make(PORT).clip_values([torch.from_numpy(a) for a in arrays])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    # the eager (param, grad) pairs form
    pairs = make(PORT)([(i, torch.from_numpy(a))
                        for i, a in enumerate(arrays)])
    assert [p for p, _ in pairs] == [0, 1, 2]
    for (_, g), w in zip(pairs, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def test_bad_grad_clip_raises():
    with pytest.raises(TypeError, match="ClipGradBy"):
        port_optimizer.SGD(0.1, parameters=[torch.zeros(2)], grad_clip=1.0)


# ------------------------------------------------------ incubate.optimizer
def _steps_with(ns, wrap, params, grads):
    port = ns is PORT
    ps = {}
    for n, a in params.items():
        if port:
            ps[n] = torch.from_numpy(a.copy()).requires_grad_()
        else:
            ps[n] = paddle.to_tensor(a, stop_gradient=False)
            ps[n].name = n
    inner = ns.opt.SGD(0.1, parameters=list(ps.items()) if port
                       else list(ps.values()))
    outer = wrap(ns, inner, list(ps.values()))
    seen = []
    for g in grads:
        if port:
            loss = sum((ps[n] * torch.from_numpy(g[n])).sum() for n in ps)
        else:
            loss = sum((ps[n] * paddle.to_tensor(g[n])).sum() for n in ps)
        loss.backward()
        if isinstance(outer, (port_incubate.LookAhead,
                              ref_incubate.LookAhead)):
            outer.step()
        else:
            inner.step()
            outer.step()
        inner.clear_grad()
        seen.append({n: (p.detach().numpy().copy() if port
                         else np.asarray(p.numpy()).copy())
                     for n, p in ps.items()})
    return outer, ps, seen


@pytest.mark.parametrize("kind", ["lookahead", "model_average", "ema"])
def test_incubate_optimizers_match_reference(kind):
    wrap = {
        "lookahead": lambda ns, inner, ps: ns.inc.LookAhead(inner, 0.4, 2),
        "model_average": lambda ns, inner, ps: ns.inc.ModelAverage(
            0.15, parameters=ps),
        "ema": lambda ns, inner, ps: ns.inc.ExponentialMovingAverage(
            ps, decay=0.8),
    }[kind]
    params, grads = _data(7, steps=5)
    outs = [_steps_with(ns, wrap, params, grads) for ns in (REF, PORT)]
    (r_outer, r_ps, r_seen), (p_outer, p_ps, p_seen) = outs
    for rs, ps_ in zip(r_seen, p_seen):
        for n in rs:
            np.testing.assert_allclose(ps_[n], rs[n], rtol=1e-6, atol=1e-6,
                                       err_msg=n)
    if kind == "lookahead":
        return
    # apply swaps the averages in, restore puts the weights back
    before = {n: p.detach().numpy().copy() for n, p in p_ps.items()}
    r_outer.apply()
    p_outer.apply()
    for n in p_ps:
        np.testing.assert_allclose(p_ps[n].detach().numpy(),
                                   np.asarray(r_ps[n].numpy()), rtol=1e-6,
                                   atol=1e-6, err_msg=n)
    p_outer.restore()
    for n in p_ps:
        np.testing.assert_array_equal(p_ps[n].detach().numpy(), before[n])


def test_lookahead_syncs_the_master():
    p = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    inner = port_optimizer.SGD(0.5, parameters=[p], multi_precision=True)
    la = port_incubate.LookAhead(inner, alpha=0.5, k=1)
    (p.float() * torch.ones(3)).sum().backward()
    la.step()
    assert torch.equal(inner._states[id(p)]["master"], p.detach().float())
    assert la.get_lr() == 0.5
    sd = la.state_dict()
    assert sd["step"] == 1 and "inner" in sd


def test_model_average_needs_parameters():
    with pytest.raises(ValueError, match="parameters="):
        port_incubate.ModelAverage()


def test_set_lr_and_scheduler():
    p = torch.zeros(2, requires_grad=True)
    opt = port_optimizer.Adam(0.1, parameters=[p])
    opt.set_lr(0.2)
    assert opt.get_lr() == 0.2
    opt.set_lr_scheduler(port_lr.ExponentialDecay(0.3, 0.5))
    assert opt.get_lr() == 0.3
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    assert math.isclose(opt.state_dict()["LR_Scheduler"]["base_lr"], 0.3)
