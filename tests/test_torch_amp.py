"""The port's amp (``paddle_tpu_torch.amp``) held against paddle_tpu's: the
cast rule of each op name, the casts the tiny Llama's forward makes under
``auto_cast`` (O1 and O2, bf16 and fp16) and the logits they give,
``decorate`` at O2, the custom lists and their unknown-name warning, and
``GradScaler``'s arithmetic over a seeded run with injected infs.

The reference's casts are recorded by wrapping its
``paddle_tpu.amp.cast_inputs_for_op`` (monkeypatch; its dispatch seam's
cached binding is reset so the wrapper is seen), the port's by wrapping
``paddle_tpu_torch.amp.cast_inputs_for_op``, which every port seam calls
through the module. Weights are the reference's, carried with
``load_paddle_tpu_arrays``.

Tolerances, each with its reason:
- logits under amp: ``2^-6`` (bf16) / ``2^-9`` (fp16) of the largest
  |logit|, about two rounding steps of the amp dtype at the logits' scale:
  both sides round the same products to the same dtype, but the two
  libraries' bf16 / fp16 products accumulate in other orders, so a value
  near a rounding boundary may round one step apart and carry that
  through two layers;
- the loss: the same bound relative to the loss;
- GradScaler runs in f32: scales and counters exactly equal, parameters
  within ``1e-6`` relative (one f32 SGD update per good step).
"""
import collections
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.amp as ref_amp
import paddle_tpu.core.dispatch as ref_dispatch
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import LlamaPretrainingCriterion as RefCriterion
import paddle_tpu_torch.amp as amp
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  LlamaPretrainingCriterion,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD

# the seams the Llama path reaches (the reference also casts its
# elementwise ops under O2; the port's follow torch's promotion)
PATH_OPS = ("embedding", "rms_norm", "linear",
            "scaled_dot_product_attention", "cross_entropy")
TOL = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}


def _dt(x):
    return str(x.dtype).replace("torch.", "").replace("paddle.", "")


def _ref_model(**kw):
    paddle.seed(0)
    return RefLM(RefConfig.tiny(tensor_parallel=False, **kw))


def _port_from(ref, **kw):
    m = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False, **kw),
                         device="cpu")
    load_paddle_tpu_arrays(m, {k: v.numpy()
                               for k, v in ref.state_dict().items()})
    return m


def _ids(seed=0, shape=(2, 12)):
    return np.random.RandomState(seed).randint(0, 128, shape)


@pytest.fixture
def recorders(monkeypatch):
    """(reference records, port records): one (op name, input float
    dtypes, output float dtypes) per seam call."""
    ref_rec, port_rec = [], []

    def floats(vals):
        return tuple(_dt(v) for v in vals
                     if v is not None and hasattr(v, "dtype")
                     and "float" in _dt(v))

    ref_orig = ref_amp.cast_inputs_for_op

    def ref_wrap(name, vals):
        out = ref_orig(name, vals)
        ref_rec.append((name, floats(vals), floats(out)))
        return out

    port_orig = amp.cast_inputs_for_op

    def port_wrap(name, *vals):
        out = port_orig(name, *vals)
        port_rec.append((name, floats(vals), floats(out)))
        return out

    monkeypatch.setattr(ref_amp, "cast_inputs_for_op", ref_wrap)
    monkeypatch.setattr(ref_dispatch, "_amp_cache", None)
    monkeypatch.setattr(amp, "cast_inputs_for_op", port_wrap)
    return ref_rec, port_rec


def _census(records):
    return collections.Counter(r for r in records if r[0] in PATH_OPS)


def test_lists_are_the_references():
    assert amp.WHITE_LIST == ref_amp.WHITE_LIST
    assert amp.BLACK_LIST == ref_amp.BLACK_LIST


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("name", sorted(ref_amp.WHITE_LIST
                                        | ref_amp.BLACK_LIST
                                        | {"embedding", "reshape", "silu"}))
def test_cast_rule_matches_reference(level, dtype, name):
    """One op name, every input kind: f32, bf16, fp16 and int32 arrays go
    to the same dtypes on both sides."""
    kinds = ("float32", "bfloat16", "float16", "int32")
    ref_in = [paddle.zeros([2], dtype=k)._value for k in kinds]
    port_in = [torch.zeros(2, dtype=getattr(torch, k)) for k in kinds]
    with ref_amp.auto_cast(level=level, dtype=dtype):
        want = [_dt(v) for v in ref_amp.cast_inputs_for_op(name, ref_in)]
    with amp.auto_cast(level=level, dtype=dtype):
        got = [_dt(v) for v in amp.cast_inputs_for_op(name, *port_in)]
    assert got == want


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_llama_casts_and_logits_match_reference(recorders, level, dtype):
    ref_rec, port_rec = recorders
    ref = _ref_model()
    port = _port_from(ref)
    ids = _ids()
    with ref_amp.auto_cast(level=level, dtype=dtype):
        rl = ref(paddle.to_tensor(ids))
        r_loss = RefCriterion()(rl, paddle.to_tensor(ids))
    with amp.auto_cast(level=level, dtype=dtype):
        pl = port(torch.from_numpy(ids))
        p_loss = LlamaPretrainingCriterion()(pl, torch.from_numpy(ids))
    # the same (op, input dtypes) -> output dtypes at every seam of the path
    assert _census(port_rec) == _census(ref_rec)
    assert {r[0] for r in port_rec} >= set(PATH_OPS)
    assert _dt(pl) == _dt(rl) == dtype and _dt(p_loss) == "float32"
    want = np.asarray(rl.astype("float32").numpy())
    got = pl.detach().float().numpy()
    tol = TOL[dtype] * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol
    assert abs(float(p_loss.detach()) - float(r_loss)) <= TOL[dtype] * float(r_loss)
    # amp off again: f32 logits, no seam call
    n = len(port_rec)
    assert port(torch.from_numpy(ids)).dtype == torch.float32
    assert len(port_rec) == n


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_decorate_o2_matches_reference(recorders, dtype):
    """decorate(O2) casts every floating parameter; the decorated model
    under auto_cast(O2) casts and computes as the reference's."""
    ref_rec, port_rec = recorders
    ref = _ref_model()
    port = _port_from(ref)
    assert ref_amp.decorate(ref, level="O2", dtype=dtype) is ref
    assert amp.decorate(port, level="O2", dtype=dtype) is port
    want_dt = {k: _dt(v) for k, v in ref.state_dict().items()}
    assert {k: _dt(v) for k, v in port.state_dict().items()} == want_dt
    assert set(want_dt.values()) == {dtype}
    opt = SGD(0.1, parameters=port.parameters())
    assert amp.decorate(port, opt, level="O2", dtype=dtype) == (port, opt)
    ids = _ids(1)
    with ref_amp.auto_cast(level="O2", dtype=dtype):
        rl = ref(paddle.to_tensor(ids))
    with amp.auto_cast(level="O2", dtype=dtype):
        pl = port(torch.from_numpy(ids))
    assert _census(port_rec) == _census(ref_rec)
    want = np.asarray(rl.astype("float32").numpy())
    tol = TOL[dtype] * float(np.abs(want).max())
    assert float(np.abs(pl.detach().float().numpy() - want).max()) <= tol


@pytest.mark.parametrize("white,black", [
    ({"rms_norm"}, ()),           # a custom white entry beats the black list
    ((), {"linear"}),             # a custom black entry beats the white list
    ({"embedding"}, {"scaled_dot_product_attention"}),
])
def test_custom_lists_match_reference(recorders, white, black):
    ref_rec, port_rec = recorders
    ref = _ref_model()
    port = _port_from(ref)
    ids = _ids(2)
    kw = dict(custom_white_list=white, custom_black_list=black,
              dtype="bfloat16")
    with ref_amp.auto_cast(**kw):
        rl = ref(paddle.to_tensor(ids))
    with amp.auto_cast(**kw):
        pl = port(torch.from_numpy(ids))
    assert _census(port_rec) == _census(ref_rec)
    assert _dt(pl) == _dt(rl)


def test_unknown_custom_names_warn_on_both():
    for mod in (ref_amp, amp):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with mod.auto_cast(custom_white_list={"matmul"},
                               custom_black_list={"softmax"}):
                pass
        assert not [x for x in w if issubclass(x.category, RuntimeWarning)]
        with pytest.warns(RuntimeWarning,
                          match=r"not \(yet\) in the op registry"):
            with mod.auto_cast(custom_white_list={"not_a_real_op_qq"}):
                pass


def test_auto_cast_restores_and_amp_guard_is_auto_cast():
    assert amp.amp_guard is amp.auto_cast
    x = torch.ones(2, 2)
    with amp.auto_cast(dtype="bfloat16"):
        assert F.matmul(x, x).dtype == torch.bfloat16
        assert F.softmax(F.matmul(x, x)).dtype == torch.float32
        with amp.auto_cast(enable=False):
            assert F.matmul(x, x).dtype == torch.float32
        assert amp.amp_state.enabled
    assert not amp.amp_state.enabled
    assert F.matmul(x, x).dtype == torch.float32


@pytest.mark.parametrize("op", ["linear", "matmul"])
def test_mixed_dtype_products_promote_as_reference(op):
    """Outside amp a bf16 operand times an f32 one computes in f32 and
    returns the left operand's dtype when it is bf16 (the reference's
    f32-accumulated product cast back), f32 when the left is f32."""
    r = np.random.RandomState(3)
    xa, wa = r.randn(3, 8).astype(np.float32), r.randn(8, 5).astype(
        np.float32)
    ba = r.randn(5).astype(np.float32)
    for left, right in (("bfloat16", "float32"), ("float32", "bfloat16"),
                        ("float16", "bfloat16")):
        rx = paddle.to_tensor(xa).astype(left)
        rw = paddle.to_tensor(wa).astype(right)
        px = torch.from_numpy(xa).to(getattr(torch, left))
        pw = torch.from_numpy(wa).to(getattr(torch, right))
        if op == "linear":
            want = paddle.nn.functional.linear(rx, rw, paddle.to_tensor(ba))
            got = F.linear(px, pw, torch.from_numpy(ba))
        else:
            want = paddle.matmul(rx, rw)
            got = F.matmul(px, pw)
        assert _dt(got) == _dt(want), (left, right)
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype("float32").numpy()),
            rtol=2.0 ** -7, atol=2.0 ** -7)


# ------------------------------------------------------------- GradScaler
def _scaler_run(mod, params_np, steps, inf_steps, **kw):
    """An f32 Linear-like least-squares run under a GradScaler: the loss
    of the steps in ``inf_steps`` is multiplied by inf. Returns the
    per-step (scale, good, bad, found_inf) and the parameters."""
    r = np.random.RandomState(5)
    xs = [r.randn(4, 3).astype(np.float32) for _ in range(steps)]
    if mod is ref_amp:
        w = paddle.to_tensor(params_np, stop_gradient=False)
        opt = paddle.optimizer.SGD(0.05, parameters=[w])
        sc = ref_amp.GradScaler(**kw)
    else:
        w = torch.tensor(params_np, requires_grad=True)
        opt = SGD(0.05, parameters=[w])
        sc = amp.GradScaler(**kw)
    trace = []
    for i, x in enumerate(xs):
        if mod is ref_amp:
            out = paddle.matmul(paddle.to_tensor(x), w)
        else:
            out = torch.from_numpy(x) @ w
        loss = (out * out).mean()
        if i in inf_steps:
            loss = loss * float("inf")
        if i % 2:
            scaled = sc.scale(loss)
            scaled.backward()
            sc.step(opt)
            sc.update()
            opt.clear_grad()
        else:
            sc.minimize(opt, sc.scale(loss))
        trace.append((sc._scale, sc._good_steps, sc._bad_steps,
                      bool(sc._found_inf)))
    val = w.numpy() if mod is ref_amp else w.detach().numpy()
    return trace, np.asarray(val, np.float32), sc


def test_grad_scaler_matches_reference_with_injected_infs():
    w0 = np.random.RandomState(4).randn(3, 2).astype(np.float32)
    kw = dict(init_loss_scaling=2.0 ** 10, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    inf_steps = {1, 2, 5, 9, 10, 11}
    ref_trace, ref_w, ref_sc = _scaler_run(ref_amp, w0, 14, inf_steps, **kw)
    trace, w, sc = _scaler_run(amp, w0, 14, inf_steps, **kw)
    assert trace == ref_trace
    assert [t[3] for t in trace] == [i in inf_steps for i in range(14)]
    # the scale went both ways
    scales = [t[0] for t in trace]
    steps = list(zip(scales, scales[1:]))
    assert any(b < a for a, b in steps) and any(b > a for a, b in steps)
    np.testing.assert_allclose(w, ref_w, rtol=1e-6, atol=1e-6)
    assert sc.state_dict() == ref_sc.state_dict()
    assert float(sc.get_loss_scaling()) == float(
        np.asarray(ref_sc.get_loss_scaling()._value))


def test_grad_scaler_skipped_step_leaves_parameters_bit_equal():
    w0 = np.random.RandomState(6).randn(3, 2).astype(np.float32)
    trace, w, _ = _scaler_run(amp, w0, 1, {0})
    assert trace[0][3] and np.array_equal(w, w0)


def test_grad_scaler_state_dict_round_trip():
    sc = amp.GradScaler(init_loss_scaling=64.0, incr_every_n_steps=2)
    sc._good_steps, sc._bad_steps = 1, 0
    sd = sc.state_dict()
    other = amp.GradScaler()
    other.load_state_dict(sd)
    assert other.state_dict() == sd == {
        "scale": 64.0, "incr_ratio": 2.0, "decr_ratio": 0.5,
        "incr_count": 1, "decr_count": 0}
    ref = ref_amp.GradScaler()
    ref.load_state_dict(sd)
    assert ref.state_dict() == sd


def test_grad_scaler_skips_inf_reference_scenario():
    """tests/test_optimizer.py's test_grad_scaler_skips_inf on both
    packages."""
    for mod in (ref_amp, amp):
        if mod is ref_amp:
            p = paddle.to_tensor([1.0], stop_gradient=False)
            opt = paddle.optimizer.SGD(0.1, parameters=[p])
        else:
            p = torch.tensor([1.0], requires_grad=True)
            opt = SGD(0.1, parameters=[p])
        scaler = mod.GradScaler(init_loss_scaling=4.0)
        loss = (p * float("inf")).sum()
        scaler.minimize(opt, scaler.scale(loss))
        val = p.numpy() if mod is ref_amp else p.detach().numpy()
        np.testing.assert_allclose(val, [1.0])
        assert scaler._scale == 4.0


def test_grad_scaler_disabled_and_static():
    w = torch.tensor([2.0], requires_grad=True)
    opt = SGD(0.5, parameters=[w])
    sc = amp.GradScaler(enable=False)
    assert not sc.is_enable() and sc.scale(torch.tensor(3.0)) == 3.0
    loss = (w * w).sum()
    sc.minimize(opt, sc.scale(loss))
    assert float(w.detach()) == 0.0  # 2 - 0.5 * 4
    st = amp.GradScaler(init_loss_scaling=8.0,
                        use_dynamic_loss_scaling=False)
    assert not st.is_use_dynamic_loss_scaling()
    st._found_inf = True
    st.update()
    assert st._scale == 8.0
    st.set_init_loss_scaling(16.0)
    assert float(st.get_loss_scaling()) == 16.0
