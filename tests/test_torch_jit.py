"""``paddle_tpu_torch.jit`` held against ``paddle_tpu.jit`` on the CPU:
``to_static`` (TorchDynamo, ``aot_eager`` on the CPU), gradients through
it, retracing, the graph text, ``jit.save`` / ``load`` /
``TranslatedLayer`` and ``functional_call``, the kernels' custom ops
(``torch.library.opcheck``), and the tiny Llama through ``to_static``
(zero graph breaks), ``jit.save`` and ``inference.Predictor`` against the
reference's ``jit.save`` / ``load`` of the same weights. Tolerances: 1e-6
relative for the same function compiled and eager (the same ops in the
same order), 1e-5 for the port against the reference (f32 in other
orders)."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch import inference, jit, ops
from paddle_tpu_torch.core import place as _place
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.static import InputSpec


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = _place._current
    T.set_device("cpu")
    yield
    _place._current = saved


def _net(mod):
    class Net(mod.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = mod.nn.Linear(4, 8)
            self.fc2 = mod.nn.Linear(8, 2)

        def forward(self, x):
            return self.fc2(mod.nn.functional.relu(self.fc1(x)))

    return Net()


def _nets():
    """The port's Net carrying the reference Net's weights (paddle's
    Linear keeps (in, out); the port's is torch's (out, in))."""
    ref = _net(P)
    net = _net(T)
    with torch.no_grad():
        for name, p in net.named_parameters():
            a = np.array(ref.state_dict()[name]._value)
            p.copy_(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))
    return ref, net


def _x(shape=(3, 4), seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _graph_targets(gm):
    return {str(n.target) for m in gm.modules() if hasattr(m, "graph")
            for n in m.graph.nodes}


def test_to_static_matches_eager_and_reference():
    ref, net = _nets()
    x = _x()
    want = ref(P.to_tensor(x)).numpy()
    y0 = net(torch.from_numpy(x))
    snet = jit.to_static(net)
    assert snet is net and isinstance(net.forward, jit.StaticFunction)
    y1 = snet(torch.from_numpy(x))
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(y1.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6)
    assert net.forward.graph_breaks == [] and len(net.forward.graphs) == 1


def test_to_static_function():
    @jit.to_static
    def f(a, b):
        return a * b + a

    out = f(torch.ones(2), torch.tensor([2.0, 3.0]))
    ref = P.jit.to_static(lambda a, b: a * b + a)(
        P.ones([2]), P.to_tensor([2.0, 3.0]))
    np.testing.assert_allclose(out.numpy(), ref.numpy())


def test_to_static_grad_flow_matches_eager_and_reference():
    ref, net = _nets()
    x = _x()
    rsnet = P.jit.to_static(ref)
    rsnet(P.to_tensor(x)).sum().backward()
    snet = jit.to_static(net)
    snet(torch.from_numpy(x)).sum().backward()
    g_static = net.fc1.weight.grad.clone()
    net.clear_gradients()
    jit.enable_to_static(False)
    try:
        net(torch.from_numpy(x)).sum().backward()
    finally:
        jit.enable_to_static(True)
    np.testing.assert_allclose(g_static.numpy(), net.fc1.weight.grad.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(g_static.numpy().T,
                               ref.fc1.weight.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_to_static_retraces_on_a_new_shape():
    """The reference counts its traces by a side effect inside the
    function; Dynamo replays Python side effects on every call, so the
    port counts the graphs it compiled (a deliberate difference)."""
    calls = []

    @P.jit.to_static
    def rf(a):
        calls.append(1)
        return a * 2

    @jit.to_static
    def f(a):
        return a * 2

    for n in (2, 2, 3):
        rf(P.ones([n]))
        f(torch.ones(n))
    assert len(f.graphs) == len(calls) == 2


def test_graph_text_counterpart_of_stablehlo():
    _, net = _nets()
    snet = jit.to_static(net)
    text = snet.forward.get_stablehlo(torch.randn(2, 4))
    assert "def forward" in text and "linear" in text
    assert snet.forward.lowered(torch.randn(2, 4)) is snet.forward.graphs[-1]


def test_jit_save_load_matches_reference(tmp_path):
    ref, net = _nets()
    ref.eval()
    x = _x((2, 4), seed=1)
    P.jit.save(ref, str(tmp_path / "ref"),
               input_spec=[P.static.InputSpec([2, 4])])
    want = P.jit.load(str(tmp_path / "ref"))(P.to_tensor(x)).numpy()
    jit.save(net, str(tmp_path / "model"), input_spec=[InputSpec([2, 4])])
    loaded = jit.load(str(tmp_path / "model"))
    assert isinstance(loaded, jit.TranslatedLayer)
    assert loaded._n_inputs == 1 and loaded.eval() is loaded
    y = loaded(torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), net(torch.from_numpy(x)).detach()
                               .numpy(), rtol=1e-6)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loaded.forward(x).numpy(), y.numpy())


def test_jit_save_dynamic_dims_and_refusals(tmp_path):
    _, net = _nets()
    jit.save(net, str(tmp_path / "dyn"), input_spec=[InputSpec([None, 4])])
    loaded = jit.load(str(tmp_path / "dyn"))
    for b in (1, 5, 9):
        x = torch.from_numpy(_x((b, 4), seed=b))
        np.testing.assert_allclose(loaded(x).numpy(),
                                   net(x).detach().numpy(), rtol=1e-6)
    with pytest.raises(TypeError, match="Layer"):
        jit.save(lambda x: x, str(tmp_path / "f"), input_spec=[])
    with pytest.raises(ValueError, match="input_spec"):
        jit.save(net, str(tmp_path / "g"))


def test_functional_call_matches_reference():
    ref, net = _nets()
    x = _x()
    rvals = [P.to_tensor(np.asarray(p._value) * 2)
             for _, p in ref.named_parameters()]
    rout, _ = P.jit.functional_call(ref, ref.forward, [P.to_tensor(x)], {},
                                    [v._value for v in rvals], [])
    vals = [p.detach() * 2 for _, p in net.named_parameters()]
    out, bufs = jit.functional_call(net, net.forward, [torch.from_numpy(x)],
                                    {}, vals, [])
    assert bufs == []
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(rout._value),
                               rtol=1e-5, atol=1e-6)
    out2, _ = jit.functional_call(net, lambda v: net(v) + 1,
                                  [torch.from_numpy(x)], {}, vals, [])
    np.testing.assert_allclose(out2.detach().numpy(),
                               out.detach().numpy() + 1, rtol=1e-6)
    # the layer's own parameters are back
    assert torch.equal(net.fc1.weight, vals[0] / 2)


def test_functional_call_returns_updated_buffers():
    bn = T.nn.BatchNorm1D(3)
    vals = [p.detach().clone() for p in bn.parameters()]
    bufs = [b.clone() for b in bn.buffers()]
    x = torch.from_numpy(_x((8, 3)) + 2.0)
    _, new = jit.functional_call(bn, bn.forward, [x], {}, vals, bufs)
    assert len(new) == len(bufs)
    assert not torch.equal(new[0], torch.zeros(3))


def test_not_to_static_ignore_module_and_enable_flag():
    @jit.not_to_static
    def helper(x):
        return x + 1

    assert helper._not_to_static

    @jit.to_static
    def f(x):
        return helper(x) * 2

    np.testing.assert_allclose(f(torch.ones(2)).numpy(), [4.0, 4.0])
    assert f.graph_breaks  # the helper runs outside the graph
    assert jit.ignore_module([np]) is P.jit.ignore_module([np]) is None
    jit.enable_to_static(False)
    try:
        @jit.to_static
        def g(x):
            return x * 3

        np.testing.assert_allclose(g(torch.ones(2)).numpy(), [3.0, 3.0])
        assert g.graphs == []
    finally:
        jit.enable_to_static(True)


@pytest.mark.parametrize("module", ["jit", "static", "static.nn",
                                    "inference"])
def test_reference_names_present_and_callable(module):
    import importlib

    ref = importlib.import_module(f"paddle_tpu.{module}")
    port = importlib.import_module(f"paddle_tpu_torch.{module}")
    for name in ref.__all__:
        assert callable(getattr(port, name, None)), f"{module}.{name}"
        assert name in port.__all__, f"{module}.{name}"


_B, _D, _S, _H, _HK, _W = 2, 16, 5, 4, 2, 3


def _op_cases():
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    x, w = r(3, 8), r(8)
    q, k, v = r(_B, _S, _H, _D), r(_B, 7, _HK, _D), r(_B, 7, _HK, _D)
    out, lse = ops.flash_attention(q, k, v, True, None, None,
                                   return_lse=True)
    do = r(*out.shape)
    delta = ops.flash_attention_bwd_delta(out, do)
    vq, vk, vv = r(12, _H, _D), r(12, _HK, _D), r(12, _HK, _D)
    cu = torch.tensor([0, 5, 12], dtype=torch.int32)
    vout, vlse = ops.varlen_flash_attention(vq, vk, vv, cu, cu, True,
                                            return_lse=True)
    vdo = r(*vout.shape)
    vdelta = ops.varlen_flash_attention_bwd_delta(vout, vdo)
    op = torch.ops.paddle_tpu_torch
    return [
        ("rms_norm", op.rms_norm.default, (x, w, 1e-6)),
        ("rms_norm_bwd", op.rms_norm_bwd.default,
         (x, w, torch.rand(3, generator=g) + 0.5, r(3, 8))),
        ("flash_attention", op.flash_attention.default,
         (q, k, v, True, 0.25, 0)),
        ("flash_attention_window", op.flash_attention.default,
         (q, k, v, True, 0.25, _W)),
        ("flash_attention_bwd", op.flash_attention_bwd.default,
         (q, k, v, do, lse, delta, True, 0.25, 0)),
        ("varlen_flash_attention", op.varlen_flash_attention.default,
         (vq, vk, vv, cu, cu, True, 0.25, 0)),
        ("varlen_flash_attention_bwd", op.varlen_flash_attention_bwd.default,
         (vq, vk, vv, vdo, vlse, vdelta, cu, cu, True, 0.25, 0)),
    ]


@pytest.mark.parametrize("case", range(7), ids=[
    "rms_norm", "rms_norm_bwd", "flash_attention", "flash_attention_window",
    "flash_attention_bwd", "varlen_flash_attention",
    "varlen_flash_attention_bwd"])
def test_custom_op_opcheck(case):
    name, op, args = _op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), (name, result)


def test_custom_ops_cpu_equal_plain_versions():
    """On CPU tensors each op IS the plain version."""
    for name, op, args in _op_cases():
        got = op(*args)
        if name.startswith("rms_norm_bwd"):
            want = ops.rms_norm_bwd_plain(*args)
        elif name == "rms_norm":
            want = ops.rms_norm_plain(*args)
        elif name.startswith("flash_attention_bwd"):
            q, k, v, do, lse, delta, c, s, w = args
            want = ops.flash_attention_bwd_plain(q, k, v, None, lse, do, c,
                                                 s, w or None, delta)
        elif name.startswith("flash_attention"):
            want = ops.flash_attention_plain(*args[:5], args[5] or None)
        elif name == "varlen_flash_attention_bwd":
            q, k, v, do, lse, delta, cq, ck, c, s, w = args
            want = ops.varlen_flash_attention_bwd_plain(
                q, k, v, None, lse, do, cq, ck, c, s, w or None, delta)
        else:
            want = ops.varlen_flash_attention_plain(*args[:7],
                                                    args[7] or None)
        for a, b in zip(got, want):
            assert torch.equal(a, b), name


# -- the tiny Llama ---------------------------------------------------------
@pytest.fixture(scope="module")
def llama_pair(tmp_path_factory):
    """The reference's tiny Llama and the port's carrying its weights,
    the reference's jit.save / load of it, and the ids."""
    pcfg = P.nlp.LlamaConfig.tiny()
    P.seed(3)
    ref = P.nlp.LlamaForCausalLM(pcfg)
    ref.eval()
    port = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    load_paddle_tpu_arrays(port, {k: np.asarray(v._value)
                                  for k, v in ref.state_dict().items()})
    ids = np.random.RandomState(4).randint(
        0, pcfg.vocab_size, (2, 12)).astype(np.int64)
    d = tmp_path_factory.mktemp("ref_llama")
    P.jit.save(ref, str(d / "llama"),
               input_spec=[P.static.InputSpec([2, 12], "int64")])
    want = np.asarray(P.jit.load(str(d / "llama"))(P.to_tensor(ids))._value)
    return port, ids, want


def test_tiny_llama_to_static_zero_breaks_matches_reference(llama_pair):
    port, ids, want = llama_pair
    t = torch.from_numpy(ids)
    eager = port(t).detach()
    explain = torch._dynamo.explain(port.forward)(t)
    assert explain.graph_break_count == 0 and explain.graph_count == 1
    sf = jit.StaticFunction(port.forward, layer=port)
    logits = sf(t)
    assert sf.graph_breaks == [] and len(sf.graphs) == 1
    assert any("paddle_tpu_torch.rms_norm" in t_
               for t_ in _graph_targets(sf.graphs[0]))
    np.testing.assert_allclose(logits.detach().numpy(), eager.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)


def test_tiny_llama_save_load_predictor_match_reference(llama_pair,
                                                        tmp_path):
    port, ids, want = llama_pair
    prefix = str(tmp_path / "llama")
    jit.save(port, prefix, input_spec=[InputSpec([None, None], "int64")])
    exported = jit.read_program(prefix + ".pdmodel")
    assert any("paddle_tpu_torch.rms_norm" in str(n.target)
               for n in exported.graph.nodes)
    loaded = jit.load(prefix)
    np.testing.assert_allclose(loaded(torch.from_numpy(ids)).numpy(), want,
                               rtol=1e-5, atol=1e-5)
    # another batch and length through the same dynamic program
    ids2 = np.random.RandomState(5).randint(
        0, port.config.vocab_size, (3, 7)).astype(np.int64)
    np.testing.assert_allclose(loaded(torch.from_numpy(ids2)).numpy(),
                               port(torch.from_numpy(ids2)).detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    cfg = inference.Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.enable_use_gpu(100, 0)
    cfg.switch_ir_optim(True)
    assert cfg.ignored_options == ["enable_use_gpu", "switch_ir_optim"]
    pred = inference.create_predictor(cfg)
    (logits,) = pred.run([ids])
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)
    # handles, and a clone sharing the program
    clone = pred.clone()
    assert clone._layer is pred._layer
    h = clone.get_input_handle(clone.get_input_names()[0])
    h.copy_from_cpu(ids2)
    assert h.shape() == [3, 7]
    assert clone.run() is True
    out = clone.get_output_handle(clone.get_output_names()[0]).copy_to_cpu()
    np.testing.assert_allclose(out, loaded(torch.from_numpy(ids2)).numpy())


def test_llama_d64_to_static_runs_the_attention_op_and_grads():
    """At D = 64 attention reaches K4 / K7's custom ops (the plain
    versions on the CPU) inside the compiled graph, forward and
    backward."""
    cfg = LlamaConfig.tiny(tensor_parallel=False, hidden_size=128,
                           num_attention_heads=2, num_key_value_heads=1)
    torch.manual_seed(0)
    m = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.from_numpy(np.random.RandomState(6).randint(
        0, cfg.vocab_size, (2, 12)).astype(np.int64))
    eager = m(ids)
    eager.float().square().mean().backward()
    grads = {n: p.grad.clone() for n, p in m.named_parameters()}
    m.zero_grad()
    sf = jit.StaticFunction(m.forward, layer=m)
    out = sf(ids)
    out.float().square().mean().backward()
    targets = _graph_targets(sf.graphs[0])
    assert any("flash_attention" in t for t in targets), sorted(targets)
    assert sf.graph_breaks == []
    np.testing.assert_allclose(out.detach().numpy(), eager.detach().numpy(),
                               rtol=1e-6, atol=1e-6)
    for n, p in m.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[n].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=n)


def _decode_inputs():
    g = torch.Generator().manual_seed(1)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    q, cache = r(2, 4, 64), r(2, 8, 2, 64)
    lens = torch.tensor([3, 8], dtype=torch.int32)
    tables = torch.tensor([[0, 2], [1, 3]], dtype=torch.int32)
    pool = r(4, 4, 2, 64)
    pool8 = (pool * 30).to(torch.int8)
    hs = torch.rand(2, generator=g) + 0.5
    rows = torch.rand(4, 4, 2, generator=g) * 0.05
    return q, cache, lens, tables, pool, pool8, hs, rows


def _decode_op_cases():
    """K2's and K5's ops: (name, op, args, the plain version's output)."""
    from paddle_tpu_torch.ops import paged_attention as pa

    q, cache, lens, tables, pool, pool8, hs, rows = _decode_inputs()
    op = torch.ops.paddle_tpu_torch
    return [
        ("decode_attention", op.decode_attention.default,
         (q, cache, cache, lens, 0.125),
         ops.decode_attention_plain(q, cache, cache, lens, 0.125)),
        ("paged_decode_attention", op.paged_decode_attention.default,
         (q, pool, pool, tables, lens, 0.125, None, None),
         ops.paged_decode_attention_plain(q, pool, pool, tables, lens,
                                          0.125)),
        ("paged_decode_attention_scaled", op.paged_decode_attention.default,
         (q, pool, pool, tables, lens, 0.125, hs, hs.flip(0)),
         ops.paged_decode_attention_plain(q, pool, pool, tables, lens,
                                          0.125, hs, hs.flip(0))),
        ("paged_decode_attention_int8", op.paged_decode_attention.default,
         (q, pool8, pool8, tables, lens, 0.125, hs, hs),
         ops.paged_decode_attention_plain(q, pool8, pool8, tables, lens,
                                          0.125, hs, hs)),
        ("paged_decode_attention_int8_rows",
         op._paged_decode_attention_rows.default,
         (q, pool8, pool8, rows, rows, tables, lens, 0.125),
         pa._paged_decode_attention_rows_plain(q, pool8, pool8, rows, rows,
                                               tables, lens, 0.125)),
    ]


_DECODE_IDS = ["decode_attention", "paged_decode_attention",
               "paged_decode_attention_scaled",
               "paged_decode_attention_int8",
               "paged_decode_attention_int8_rows"]


@pytest.mark.parametrize("case", range(5), ids=_DECODE_IDS)
def test_decode_custom_op_opcheck(case):
    """K2 (every mode) and K5 as custom ops: torch.library's checks pass,
    and on CPU tensors each op IS the plain version."""
    name, op, args, want = _decode_op_cases()[case]
    result = torch.library.opcheck(op, args)
    assert all(v == "SUCCESS" for v in result.values()), (name, result)
    assert torch.equal(op(*args), want), name


def test_decode_kernels_trace_and_export_round_trip(tmp_path):
    """K2 and K5 as custom ops: a compiled step holds K5's op with no
    graph break and equals eager; ``jit.save`` / ``load`` of a Layer
    that calls K5, K2 over float pools and K2's per-row int8 mode
    exports the ops and gives eager's outputs back."""
    from paddle_tpu_torch.ops.paged_attention import \
        _paged_decode_attention_rows

    q, cache, lens, tables, pool, pool8, hs, rows = _decode_inputs()

    def step(q, kc, vc, lens):
        return ops.decode_attention(q, kc, vc, lens)

    sf = jit.StaticFunction(step)
    torch.testing.assert_close(sf(q, cache, cache, lens),
                               step(q, cache, cache, lens), rtol=0, atol=0)
    assert sf.graph_breaks == []
    assert any("decode_attention" in t for t in _graph_targets(
        sf.graphs[0])), sorted(_graph_targets(sf.graphs[0]))

    class K5(torch.nn.Module):
        def forward(self, q):
            return ops.decode_attention(q[:, None], cache, cache, lens)

    class K2(torch.nn.Module):
        def forward(self, q):
            return ops.paged_decode_attention(q, pool, pool, tables, lens)

    class K2Rows(torch.nn.Module):
        def forward(self, q):
            return _paged_decode_attention_rows(q, pool8, pool8, rows, rows,
                                                tables, lens)

    for layer, op in ((K5(), "decode_attention"),
                      (K2(), "paged_decode_attention"),
                      (K2Rows(), "_paged_decode_attention_rows")):
        prefix = str(tmp_path / type(layer).__name__)
        jit.save(layer, prefix, input_spec=[InputSpec([2, 4, 64],
                                                      "float32")])
        loaded = jit.load(prefix)
        targets = {str(n.target) for n in loaded._exported.graph.nodes}
        assert f"paddle_tpu_torch.{op}.default" in targets, targets
        torch.testing.assert_close(loaded(q), layer(q), rtol=0, atol=0)
