"""The core of the port's Paddle API held against the reference on the
CPU: the manifests' names, places, seeds and flags, the random ops (by
reproducibility at a seed and by moments: the draws are torch's, not
threefry's), paddle's tensor methods on ``torch.Tensor``, ``nn.Layer`` /
``ParamAttr`` and the initializers, ``autograd`` (``PyLayer``,
``jacobian``, ``hessian``, ``vjp``, ``jvp``), ``device`` and the op
registry."""
import math
import os

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch import _later
from paddle_tpu_torch.core import place as _place

MANIFESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "manifests")
# every stand-in among the manifests' names, with its ROADMAP item
STAND_INS = {
    "top_level.txt": {},
    "linalg.txt": {"to_jax_dtype": "A9", "cholesky_fn": "A9"},
}


@pytest.fixture(autouse=True)
def _cpu_place():
    saved = _place._current
    T.set_device("cpu")
    yield
    _place._current = saved


def _names(fname):
    with open(os.path.join(MANIFESTS, fname)) as f:
        return [ln.strip() for ln in f if ln.strip()]


def _is_stand_in(fn):
    return getattr(fn, "__code__", None) is _later.not_ported(
        "x", "y").__code__


@pytest.mark.parametrize("fname,ns", [("top_level.txt", T),
                                      ("linalg.txt", T.linalg)],
                         ids=["top_level", "linalg"])
def test_manifest_names_are_ported_or_listed_stand_ins(fname, ns):
    names = _names(fname)
    missing = [n for n in names if not callable(getattr(ns, n, None))]
    assert not missing, missing
    stand_ins = {n for n in names if _is_stand_in(getattr(ns, n))}
    assert stand_ins == set(STAND_INS[fname]), stand_ins
    for n, item in STAND_INS[fname].items():
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            getattr(ns, n)()
    assert sum(len(v) for v in STAND_INS.values()) <= 10


def test_nn_has_layer_paramattr_and_clips():
    for n in ("Layer", "ParamAttr", "ClipGradByGlobalNorm",
              "ClipGradByNorm", "ClipGradByValue"):
        assert callable(getattr(T.nn, n)), n
    assert T.nn.ClipGradByNorm is T.optimizer.clip.ClipGradByNorm


# -- dtypes, places, flags --------------------------------------------------
@pytest.mark.parametrize("name", ["float32", "bfloat16", "float16",
                                  "float64", "int8", "int32", "int64",
                                  "uint8", "bool", "complex64",
                                  "float8_e4m3fn", "float8_e5m2"])
def test_dtypes_name_the_reference_dtypes(name):
    attr = "bool" if name == "bool" else name
    assert T.dtype(name) == getattr(T, attr)
    assert str(getattr(T, attr)) == f"torch.{getattr(P, attr).name}"
    assert T.to_tensor([1], dtype=name).dtype == getattr(T, attr)


def test_dtype_aliases_default_dtype_and_info():
    assert T.dtype("fp16") is torch.float16 and T.dtype("bf16") is \
        torch.bfloat16 and T.dtype(float) is torch.float32
    assert T.dtype(np.int16) is torch.int16
    assert T.get_default_dtype() == P.get_default_dtype() == "float32"
    try:
        T.set_default_dtype("float64")
        P.set_default_dtype("float64")
        assert T.get_default_dtype() == P.get_default_dtype()
        assert T.to_tensor(1.5).dtype == torch.float64
        assert T.zeros([2]).dtype == torch.float64
    finally:
        T.set_default_dtype("float32")
        P.set_default_dtype("float32")
    with pytest.raises(TypeError):
        T.set_default_dtype("int32")
    for d in ("float32", "bfloat16", "float16"):
        tf, rf = T.finfo(d), P.finfo(d)
        assert (tf.eps, tf.max, tf.min, tf.tiny, tf.bits) == (
            float(rf.eps), float(rf.max), float(rf.min), float(rf.tiny),
            rf.bits), d
    for d in ("int8", "int32", "uint8"):
        assert (T.iinfo(d).min, T.iinfo(d).max) == (P.iinfo(d).min,
                                                    P.iinfo(d).max)


def test_places_and_set_device():
    assert T.CPUPlace() == T.CPUPlace() and T.CUDAPlace(1) != T.CUDAPlace(0)
    assert isinstance(T.TPUPlace(0), T.CUDAPlace)
    assert T.TPUPlace(0).is_tpu_place() and T.CPUPlace().is_cpu_place()
    assert repr(T.CPUPlace()) == repr(P.CPUPlace()) == "Place(cpu)"
    assert T.set_device("cpu") == T.CPUPlace()
    assert T.get_device() == "cpu"
    assert T.set_device("gpu:1") == T.CUDAPlace(1)
    assert T.get_device() == "gpu:1"
    assert T.set_device("tpu") == T.CUDAPlace(0)
    assert T.get_device() == "gpu:0"
    assert T.core.place.device_for_place() == torch.device("cuda", 0)
    assert T.device.get_device() == "gpu:0"
    assert T.set_device(T.CPUPlace()) == T.CPUPlace()
    x = T.to_tensor([1.0])
    assert x.place == T.CPUPlace() and x.device.type == "cpu"
    assert T.to_tensor([1.0], place=T.CPUPlace()).device.type == "cpu"
    assert T.to_tensor([1.0], place="cpu").device.type == "cpu"


def test_unset_place_is_cuda():
    _place._current = None
    assert T.core.place.device_for_place() == torch.device("cuda")
    assert T.get_device() == "gpu:0"
    assert T.core.place.current_place() == T.CUDAPlace(0)


def test_flags_match_reference():
    names = ["FLAGS_check_nan_inf", "FLAGS_allocator_strategy",
             "FLAGS_cudnn_deterministic"]
    assert T.get_flags(names) == P.get_flags(names)
    T.set_flags({"FLAGS_cudnn_deterministic": "1", "my_vendor_flag": 3})
    P.set_flags({"FLAGS_cudnn_deterministic": "1", "my_vendor_flag": 3})
    try:
        got = T.get_flags(["cudnn_deterministic", "FLAGS_my_vendor_flag"])
        assert got == P.get_flags(["cudnn_deterministic",
                                   "FLAGS_my_vendor_flag"])
        assert got["FLAGS_cudnn_deterministic"] is True
    finally:
        for m in (T, P):
            m.set_flags({"FLAGS_cudnn_deterministic": False})
    assert T.core.flags.define_flag("tier_probe", 2) == 2


# -- seeds and random ops -----------------------------------------------------
def test_seed_repeats_draws_and_rng_state_round_trips():
    T.seed(123)
    a = T.rand([64])
    T.seed(123)
    assert torch.equal(T.rand([64]), a)
    state = T.get_rng_state()
    b = T.randn([32])
    T.set_rng_state(state)
    assert torch.equal(T.randn([32]), b)
    g = T.core.random.Generator(7)
    assert g.initial_seed() == 7 and isinstance(g, torch.Generator)
    assert T.seed(5) is T.core.random.default_generator


def test_rng_state_tracker_streams():
    tracker = T.distributed.fleet.layers.mpu.get_rng_state_tracker()
    tracker.reset()
    tracker.add("local_seed", 11)
    with pytest.raises(ValueError):
        tracker.add("local_seed", 12)
    T.seed(0)
    before = T.get_rng_state()
    with tracker.rng_state("local_seed"):
        x = T.rand([8])
    after = T.get_rng_state()
    assert all(torch.equal(u, v) for u, v in zip(before, after))
    with tracker.rng_state("local_seed"):
        y = T.rand([8])
    T.seed(11)
    assert torch.equal(torch.cat([x, y]), T.rand([16]))
    tracker.reset()


# (name, draw(n) -> tensor, mean, variance)
_RANDOM = [
    ("rand", lambda n: T.rand([n]), 0.5, 1 / 12),
    ("uniform", lambda n: T.uniform([n], min=-2.0, max=4.0), 1.0, 3.0),
    ("randn", lambda n: T.randn([n]), 0.0, 1.0),
    ("standard_normal", lambda n: T.standard_normal([n]), 0.0, 1.0),
    ("normal", lambda n: T.normal(2.0, 3.0, [n]), 2.0, 9.0),
    ("normal_tensor", lambda n: T.normal(T.full([n], 1.0), 2.0), 1.0, 4.0),
    ("randint", lambda n: T.randint(0, 10, [n]).float(), 4.5, 99 / 12),
    ("randint_like", lambda n: T.randint_like(T.zeros([n]), 0, 4), 1.5,
     15 / 12),
    ("rand_like", lambda n: T.rand_like(T.zeros([n])), 0.5, 1 / 12),
    ("randn_like", lambda n: T.randn_like(T.zeros([n])), 0.0, 1.0),
    ("bernoulli", lambda n: T.bernoulli(T.full([n], 0.3)), 0.3, 0.21),
    ("poisson", lambda n: T.poisson(T.full([n], 4.0)), 4.0, 4.0),
    ("multinomial", lambda n: T.multinomial(
        T.to_tensor([0.2, 0.3, 0.5]), n, replacement=True).float(),
     1.3, 0.61),
    ("randperm", lambda n: T.randperm(n).float(), None, None),
    ("uniform_", lambda n: T.uniform_(T.zeros([n]), 0.0, 2.0), 1.0, 1 / 3),
    ("normal_", lambda n: T.normal_(T.zeros([n]), 1.0, 0.5), 1.0, 0.25),
    ("exponential_", lambda n: T.exponential_(T.zeros([n]), 2.0), 0.5,
     0.25),
    ("gumbel_softmax", lambda n: T.gumbel_softmax(T.zeros([n, 2]))[:, 0],
     0.5, None),
]


@pytest.mark.parametrize("case", _RANDOM, ids=[c[0] for c in _RANDOM])
def test_random_ops_repeat_at_a_seed_and_hold_their_moments(case):
    name, draw, mean, var = case
    n = 20000
    T.seed(2024)
    a = draw(n)
    T.seed(2024)
    b = draw(n)
    assert torch.equal(a, b), name
    assert not torch.equal(draw(n), a), name
    v = a.double()
    if name == "randperm":
        assert torch.equal(torch.sort(a).values, torch.arange(n).float())
        return
    if mean is not None:
        sd = math.sqrt(var if var is not None else float(v.var()))
        assert abs(float(v.mean()) - mean) <= 5 * sd / math.sqrt(n), name
    if var is not None:
        # the variance of a sample variance: (mu4 - var^2) / n; bounded
        # here by the sample's own fourth moment
        mu4 = float(((v - v.mean()) ** 4).mean())
        assert abs(float(v.var()) - var) <= 5 * math.sqrt(
            (mu4 - var ** 2) / n) + 1e-12, name


def test_multinomial_without_replacement_and_seeded_uniform():
    T.seed(0)
    picks = T.multinomial(T.to_tensor([[0.1, 0.2, 0.3, 0.4]] * 50), 4)
    assert all(sorted(r) == [0, 1, 2, 3] for r in picks.tolist())
    a = T.uniform([16], seed=42)
    b = T.uniform([16], seed=42)
    assert torch.equal(a, b) and float(a.min()) >= -1 and float(a.max()) < 1


# -- tensor methods -----------------------------------------------------------
def test_tensor_methods_attach_paddle_names_only_where_torch_has_none():
    x = T.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    r = P.to_tensor(np.arange(6, dtype=np.float32).reshape(2, 3))
    assert x.stop_gradient and not x.trainable
    x.stop_gradient = False
    assert x.requires_grad and x.trainable and not x.stop_gradient
    assert x.astype("float16").dtype == torch.float16
    assert x.cast("int32").dtype == torch.int32
    assert x.place == T.CPUPlace() and x.is_tensor
    p = T.Parameter(np.ones(3, np.float32), name="w0", trainable=False)
    assert isinstance(p, torch.nn.Parameter) and isinstance(p, T.Parameter)
    assert p.param_name == "w0" and p.stop_gradient
    assert isinstance(torch.nn.Parameter(torch.ones(1)), T.Parameter)
    (x * 2).sum().backward()
    assert x.grad is not None
    x.clear_grad()
    assert x.grad is None
    y = T.zeros([2, 3])
    assert y.set_value(np.ones((2, 3), np.float32)) is y
    assert float(y.sum()) == 6.0
    with pytest.raises(ValueError):
        y.set_value(np.ones((3, 2)))
    # torch's meanings stay where both have the name
    assert x.shape == torch.Size([2, 3]) and r.shape == [2, 3]
    assert x.size() == torch.Size([2, 3]) and r.size == 6
    assert x.numel() == 6
    # op methods paddle adds
    np.testing.assert_array_equal(
        x.detach().scale(2.0, 1.0).numpy(), r.scale(2.0, 1.0).numpy())
    np.testing.assert_allclose(x.detach().stanh().numpy(),
                               r.stanh().numpy(), rtol=1e-6)
    z = T.ones([3])
    assert z.scale_(3.0) is z and z.tolist() == [3.0, 3.0, 3.0]
    assert torch.equal(T.ones([2]).clip_(0.0, 0.5), T.full([2], 0.5))


# -- Layer, ParamAttr, initializers ---------------------------------------
def _user_layer(m):
    class Block(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([4, 3])
            self.b = self.create_parameter([3], is_bias=True)
            self.scale = self.create_parameter(
                [3], attr=m.ParamAttr(name="gain", initializer=(
                    m.nn.initializer.Constant(2.0))))
            self.register_buffer("steps", m.zeros([1]))

        def forward(self, x):
            return m.matmul(x, self.w) * self.scale + self.b

    class Net(m.nn.Layer):
        def __init__(self):
            super().__init__()
            self.first = Block()
            self.add_sublayer("second", Block())
            self.head = m.nn.Linear(3, 2)

        def forward(self, x):
            return self.head(self.second(m.nn.functional.relu(
                self.first(x))[:, :3].reshape([-1, 3]).matmul(
                    m.ones([3, 4]))))

    return Net()


def test_user_layer_state_dict_keys_match_reference():
    port, ref = _user_layer(T), _user_layer(P)
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    assert isinstance(port, T.nn.Layer) and isinstance(port, torch.nn.Module)
    assert [n for n, _ in port.named_sublayers()] == \
        [n for n, _ in ref.named_sublayers()]
    assert len(port.sublayers()) == len(ref.sublayers())
    assert port.first.scale.param_name == "gain" == \
        ref.first.scale.name
    assert port.first.w.param_name.endswith(".w_0") and \
        port.first.b.param_name.endswith(".b_1")
    assert torch.equal(port.first.b, torch.zeros(3))
    assert torch.equal(port.first.scale, torch.full((3,), 2.0))
    # carry the reference's values across (torch's Linear holds its
    # weight as (out, in), paddle's as (in, out)) and run both
    missing, unexpected = port.set_state_dict(
        {k: v.numpy().T if k == "head.weight" else v.numpy()
         for k, v in ref.state_dict().items()})
    assert not missing and not unexpected
    x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
    np.testing.assert_allclose(port(T.to_tensor(x)).detach().numpy(),
                               ref(P.to_tensor(x)).numpy(), rtol=1e-5,
                               atol=1e-6)
    port.clear_gradients()
    seen = []
    h = port.register_forward_post_hook(lambda m, i, o: seen.append(o.shape))
    port(T.to_tensor(x))
    h.remove()
    port(T.to_tensor(x))
    assert seen == [torch.Size([5, 2])]
    assert port.astype("bfloat16").head.weight.dtype == torch.bfloat16


def test_port_layers_and_models_are_layers():
    assert isinstance(T.nn.Linear(2, 3), T.nn.Layer)
    assert isinstance(T.nn.Sequential(T.nn.ReLU()), T.nn.Layer)
    assert isinstance(T.nn.LayerNorm(4), T.nn.Layer)
    cfg = T.LlamaConfig.tiny()
    model = T.LlamaForCausalLM(cfg, device="cpu")
    assert isinstance(model, T.nn.Layer)
    assert all(isinstance(m, T.nn.Layer) for m in model.modules())
    ref = P.nlp.LlamaForCausalLM(P.nlp.LlamaConfig.tiny())
    assert sorted(model.state_dict()) == sorted(ref.state_dict())


_DETERMINISTIC = [
    ("Constant", lambda m: m.nn.initializer.Constant(0.25), (3, 4)),
    ("Assign", lambda m: m.nn.initializer.Assign(
        np.arange(12, dtype=np.float32)), (3, 4)),
    ("Dirac", lambda m: m.nn.initializer.Dirac(), (4, 3, 3, 3)),
]


@pytest.mark.parametrize("case", _DETERMINISTIC,
                         ids=[c[0] for c in _DETERMINISTIC])
def test_deterministic_initializers_equal_reference(case):
    name, make, shape = case
    port = make(T)(list(shape))
    ref = np.asarray(make(P)(list(shape)))
    np.testing.assert_array_equal(port.numpy(), ref)
    filled = make(T)(torch.empty(shape))
    np.testing.assert_array_equal(filled.numpy(), ref)


# (name, initializer, shape, mean, variance): the reference's parameters
_RANDOM_INIT = [
    ("Normal", lambda m: m.nn.initializer.Normal(0.5, 2.0), (200, 100),
     0.5, 4.0),
    ("TruncatedNormal", lambda m: m.nn.initializer.TruncatedNormal(
        0.0, 1.0), (200, 100), 0.0, 0.7737413),
    ("Uniform", lambda m: m.nn.initializer.Uniform(-1.0, 3.0), (200, 100),
     1.0, 16 / 12),
    ("XavierNormal", lambda m: m.nn.initializer.XavierNormal(), (200, 100),
     0.0, 2.0 / 300),
    ("XavierUniform", lambda m: m.nn.initializer.XavierUniform(),
     (200, 100), 0.0, 6.0 / 300 / 3),
    ("KaimingNormal", lambda m: m.nn.initializer.KaimingNormal(),
     (64, 32, 3, 3), 0.0, 2.0 / 288),
    ("KaimingUniform", lambda m: m.nn.initializer.KaimingUniform(),
     (64, 32, 3, 3), 0.0, 2.0 * 3.0 / 288 / 3),
]


@pytest.mark.parametrize("case", _RANDOM_INIT,
                         ids=[c[0] for c in _RANDOM_INIT])
def test_random_initializers_hold_reference_moments(case):
    name, make, shape, mean, var = case
    T.seed(0)
    port = make(T)(list(shape)).double()
    ref = np.asarray(make(P)(list(shape)), np.float64)
    n = port.numel()
    for v in (port.numpy(), ref):
        assert abs(v.mean() - mean) <= 5 * math.sqrt(var / n), name
        mu4 = ((v - v.mean()) ** 4).mean()
        assert abs(v.var() - var) <= 5 * math.sqrt((mu4 - var ** 2) / n), \
            name
    assert port.shape == torch.Size(shape)


def test_orthogonal_initializer_and_gain_match_reference():
    q = T.nn.initializer.Orthogonal(gain=2.0)([6, 10])
    np.testing.assert_allclose((q @ q.T).numpy(), 4.0 * np.eye(6),
                               atol=1e-5)
    for nl, p in (("relu", None), ("tanh", None), ("leaky_relu", 0.2),
                  ("selu", None)):
        assert T.nn.initializer.calculate_gain(nl, p) == \
            P.nn.initializer.calculate_gain(nl, p)
    T.nn.initializer.set_global_initializer(T.nn.initializer.Constant(1.0))
    T.nn.initializer.set_global_initializer(None)


# -- autograd -----------------------------------------------------------------
def _cube_layer(m):
    class Cube(m.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3.0 * x * x * ctx.k + 1.0   # +1: the custom rule

    return Cube


def test_pylayer_matches_reference():
    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    px = T.to_tensor(x, stop_gradient=False)
    out = _cube_layer(T).apply(px, 2.0)
    out.sum().backward()
    rx = P.to_tensor(x)
    rx.stop_gradient = False
    rout = _cube_layer(P).apply(rx, 2.0)
    (rg,) = P.grad(rout.sum(), [rx])
    np.testing.assert_allclose(out.detach().numpy(), rout.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(px.grad.numpy(), rg.numpy(), rtol=1e-6)


def _f_vec(m):
    return lambda x: m.sin(x) * x * x


def _f_scalar(m):
    return lambda x: (m.exp(x * 0.5) * x).sum()


def _f_two(m):
    return lambda x, y: m.matmul(x, y).sum(axis=0)


def test_functional_autograd_matches_reference():
    rs = np.random.RandomState(1)
    x = rs.randn(4).astype(np.float32)
    a, b = rs.randn(2, 3).astype(np.float32), rs.randn(3, 2).astype(
        np.float32)
    v = rs.randn(4).astype(np.float32)

    def both(fn):
        return fn(T, T.to_tensor), fn(P, P.to_tensor)

    def cmp(port, ref):
        if isinstance(ref, (list, tuple)):
            for p_, r_ in zip(port, ref):
                cmp(p_, r_)
            return
        np.testing.assert_allclose(port.detach().numpy(), ref.numpy(),
                                   rtol=1e-5, atol=1e-6)

    cmp(*both(lambda m, t: m.autograd.jacobian(_f_vec(m), t(x))))
    cmp(*both(lambda m, t: m.autograd.jacobian(_f_two(m), (t(a), t(b)))))
    cmp(*both(lambda m, t: m.autograd.hessian(_f_scalar(m), t(x))))
    cmp(*both(lambda m, t: m.autograd.vjp(_f_vec(m), t(x), t(v))))
    cmp(*both(lambda m, t: m.autograd.vjp(_f_vec(m), t(x))))
    cmp(*both(lambda m, t: m.autograd.jvp(_f_vec(m), t(x), t(v))))
    cmp(*both(lambda m, t: m.autograd.jvp(_f_two(m), (t(a), t(b)))))


def test_grad_modes_and_paddle_grad_match_reference():
    x = np.random.RandomState(2).randn(3).astype(np.float32)
    px = T.to_tensor(x, stop_gradient=False)
    rx = P.to_tensor(x)
    rx.stop_gradient = False
    (pg,) = T.grad(T.exp(px) * px, px)        # non-scalar: ones cotangent
    (rg,) = P.grad(P.exp(rx) * rx, rx)
    np.testing.assert_allclose(pg.numpy(), rg.numpy(), rtol=1e-6)
    assert px.grad is None
    with T.no_grad():
        assert not (px * 2).requires_grad and not T.is_grad_enabled()

    @T.no_grad()
    def f(t):
        return t * 2

    assert not f(px).requires_grad
    with T.set_grad_enabled(False):
        with T.enable_grad():
            assert (px * 2).requires_grad
    unused = T.to_tensor([1.0], stop_gradient=False)
    assert T.grad((px * 2).sum(), [px, unused], allow_unused=True)[1] is None
    with pytest.raises(RuntimeError):
        T.grad((px * 2).sum(), [unused])
    T.autograd.backward([(px * px).sum()])
    np.testing.assert_allclose(px.grad.numpy(), 2 * x, rtol=1e-6)


# -- device and the registry --------------------------------------------------
def test_device_module_without_cuda():
    assert T.device_count() == torch.cuda.device_count()
    assert T.device.device_count("cpu") == 0
    assert "cpu" in T.device.get_all_device_type()
    T.device.empty_cache()
    assert callable(T.device.cuda.max_memory_allocated)
    assert T.get_cudnn_version() is None or isinstance(
        T.get_cudnn_version(), int)
    assert T.in_dynamic_mode() and T.disable_static() is None
    reader = T.batch(lambda: iter(range(5)), 2)
    assert list(reader()) == list(P.batch(lambda: iter(range(5)), 2)())


def test_op_registry_matches_reference_surface():
    assert len(T.OP_REGISTRY) >= 400
    for name in ("matmul", "concat", "exp", "functional.softmax",
                 "functional.relu", "linalg.svd"):
        assert name in T.OP_REGISTRY, name
        assert name in P.OP_REGISTRY, name
    assert T.utils.get_op_callable("matmul") is T.matmul
    ops = T.utils.get_registered_ops()
    assert ops == sorted(ops)
    T.register_op("custom_probe_op", abs)
    assert T.OP_REGISTRY.pop("custom_probe_op") is abs
    with pytest.raises(KeyError):
        T.utils.get_op_callable("definitely_not_an_op_xyz")
    assert T.apply(lambda a: a + 1, T.ones([2]), op_name="probe").tolist() \
        == [2.0, 2.0]
    assert "probe" in T.utils.get_registered_ops()


def test_amp_custom_lists_validated_against_registry():
    import warnings

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        with T.amp.auto_cast(custom_white_list={"matmul", "exp"}):
            pass
    assert not [x for x in w if issubclass(x.category, RuntimeWarning)]
    with pytest.warns(RuntimeWarning, match=r"not \(yet\) in the op registry"):
        with T.amp.auto_cast(custom_white_list={"not_a_real_op_qq"}):
            pass
