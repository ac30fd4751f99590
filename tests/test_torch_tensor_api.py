"""The Paddle tensor API tier of the port held against the reference on
the CPU: every op of ``paddle_tpu_torch``'s op corpus and ``linalg`` gets
the same seeded numpy inputs as ``paddle_tpu``'s, and their outputs (and,
for the differentiable ones, their gradients through ``backward()``
against the reference's ``paddle.grad``) must agree.

Tolerances: integer and bool results exactly; floats within ``rtol``
times the largest |reference| value (1e-6 in f32 unless the case states
otherwise: special functions, decompositions and long reductions, each
with its reason). Dtypes must agree up to the reference's 64-bit
canonicalization: JAX runs with 64-bit mode off, so where paddle (and the
port) return int64 / float64 the reference returns int32 / float32."""
import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu_torch.core import place as _place

_CANON = {"int64": "int32", "float64": "float32", "complex128": "complex64",
          "uint64": "uint32"}


@pytest.fixture(autouse=True)
def _cpu_place():
    """Every test runs the port on the CPU; the place before it comes
    back after it."""
    saved = _place._current
    T.set_device("cpu")
    yield
    _place._current = saved


def _np(x):
    """An output of either package as numpy (nested structures kept)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    if isinstance(x, P.Tensor):
        return np.asarray(x.numpy())
    if isinstance(x, (list, tuple)):
        return type(x)(_np(e) for e in x)
    if isinstance(x, (bool, int, float, np.generic)):
        return np.asarray(x)
    return x


def _same(port, ref, rtol, where="out"):
    if isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)), (where, type(port))
        assert len(port) == len(ref), (where, len(port), len(ref))
        for i, (a, b) in enumerate(zip(port, ref)):
            _same(a, b, rtol, f"{where}[{i}]")
        return
    a, b = np.asarray(port), np.asarray(ref)
    assert a.shape == b.shape, (where, a.shape, b.shape)
    assert _CANON.get(a.dtype.name, a.dtype.name) == b.dtype.name, (
        where, a.dtype, b.dtype)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=where)
        return
    fin = np.isfinite(b)
    np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=where)
    np.testing.assert_array_equal(a[~fin], b[~fin], err_msg=where)
    scale = max(1.0, float(np.max(np.abs(b[fin])))) if fin.any() else 1.0
    err = float(np.max(np.abs(a[fin] - b[fin]))) if fin.any() else 0.0
    assert err <= rtol * scale, f"{where}: max err {err} > {rtol} x {scale}"


def _rs(seed=0):
    return np.random.RandomState(seed)


def _f(*shape, seed=0, lo=-2.0, hi=2.0):
    return _rs(seed).uniform(lo, hi, shape).astype(np.float32)


def _i(*shape, seed=0, lo=-5, hi=6):
    return _rs(seed).randint(lo, hi, shape).astype(np.int64)


def _b(*shape, seed=0):
    return _rs(seed).rand(*shape) > 0.5


def _run(case_fn, arrays, grad=False):
    """``case_fn(module, *tensors)`` on both packages; with ``grad`` the
    float inputs require grad and the gradients of sum(out * w) (w seeded)
    come back too."""
    pt = [T.to_tensor(a, stop_gradient=not (grad and a.dtype.kind == "f"))
          for a in arrays]
    rt = [P.to_tensor(a) for a in arrays]
    if grad:
        for t, a in zip(rt, arrays):
            t.stop_gradient = a.dtype.kind != "f"
    port, ref = case_fn(T, *pt), case_fn(P, *rt)
    if not grad:
        return _np(port), _np(ref), None, None
    w = _rs(99).uniform(0.5, 1.5, tuple(port.shape)).astype(np.float32)
    (port * T.to_tensor(w)).sum().backward()
    diff = [t for t, a in zip(rt, arrays) if a.dtype.kind == "f"]
    ref_g = P.grad((ref * P.to_tensor(w)).sum(), diff)
    port_g = [t.grad for t, a in zip(pt, arrays) if a.dtype.kind == "f"]
    return _np(port), _np(ref), _np(port_g), _np(list(ref_g))


def _check(case_fn, arrays, rtol=1e-6, grad=False, grad_rtol=None):
    port, ref, pg, rg = _run(case_fn, arrays, grad)
    _same(port, ref, rtol)
    if grad:
        _same(pg, rg, grad_rtol or rtol, "grad")


# -- elementwise unary ------------------------------------------------------
_POS = dict(lo=0.1, hi=3.0)
_UNIT = dict(lo=-0.9, hi=0.9)
_UNARY = [
    ("exp", {}, 1e-6), ("expm1", {}, 1e-6), ("log", _POS, 1e-6),
    ("log2", _POS, 1e-6), ("log10", _POS, 1e-6), ("log1p", _POS, 1e-6),
    ("sqrt", _POS, 1e-6), ("rsqrt", _POS, 1e-6), ("square", {}, 1e-6),
    ("abs", {}, 1e-6), ("neg", {}, 1e-6), ("sign", {}, 1e-6),
    ("floor", {}, 1e-6), ("ceil", {}, 1e-6), ("round", {}, 1e-6),
    ("trunc", {}, 1e-6), ("frac", {}, 1e-6), ("sin", {}, 1e-6),
    ("cos", {}, 1e-6), ("tan", {}, 1e-6), ("asin", _UNIT, 1e-6),
    ("acos", _UNIT, 1e-6), ("atan", {}, 1e-6), ("sinh", {}, 1e-6),
    ("cosh", {}, 1e-6), ("tanh", {}, 1e-6), ("asinh", {}, 1e-6),
    ("acosh", dict(lo=1.1, hi=4.0), 1e-6), ("atanh", _UNIT, 1e-6),
    ("erf", {}, 1e-6), ("sigmoid", {}, 1e-6), ("reciprocal", _POS, 1e-6),
    ("deg2rad", {}, 1e-6), ("rad2deg", {}, 1e-6),
    ("logit", dict(lo=0.05, hi=0.95), 1e-6), ("positive", {}, 1e-6),
    ("stanh", {}, 1e-6), ("sgn", {}, 1e-6),
    # special functions: the two libraries' series and rational
    # approximations agree to a few f32 ulps of the result
    ("erfinv", _UNIT, 1e-5), ("digamma", _POS, 1e-5),
    ("lgamma", _POS, 1e-5), ("gammaln", _POS, 1e-5), ("i0", {}, 1e-5),
    ("i0e", {}, 1e-5), ("i1", {}, 1e-5), ("i1e", {}, 1e-5),
]
_NO_GRAD = {"sign", "floor", "ceil", "round", "trunc", "sgn", "i1",
            "i0", "i0e", "i1e", "erfinv", "digamma", "lgamma", "gammaln"}


@pytest.mark.parametrize("name,dom,rtol", _UNARY, ids=[c[0] for c in _UNARY])
def test_unary_matches_reference(name, dom, rtol):
    x = _f(3, 4, 5, **dom)
    _check(lambda m, t: getattr(m, name)(t), [x], rtol,
           grad=name not in _NO_GRAD, grad_rtol=max(rtol, 1e-5))


@pytest.mark.parametrize("name", ["isnan", "isinf", "isfinite", "isposinf",
                                  "isneginf", "isreal", "signbit"])
def test_predicates_match_reference(name):
    x = _f(4, 6)
    x[0, :3] = [np.nan, np.inf, -np.inf]
    _check(lambda m, t: getattr(m, name)(t), [x])


@pytest.mark.parametrize("name", ["real", "imag", "conj", "angle", "abs"])
def test_complex_parts_match_reference(name):
    z = (_f(3, 4) + 1j * _f(3, 4, seed=1)).astype(np.complex64)
    _check(lambda m, t: getattr(m, name)(t), [z])


# -- elementwise binary -----------------------------------------------------
_BINARY = [
    ("add", {}, {}), ("subtract", {}, {}), ("multiply", {}, {}),
    ("divide", {}, _POS), ("pow", _POS, dict(lo=-1.5, hi=1.5)),
    ("maximum", {}, {}), ("minimum", {}, {}), ("fmax", {}, {}),
    ("fmin", {}, {}), ("atan2", {}, {}), ("hypot", {}, {}),
    ("logaddexp", {}, {}), ("copysign", {}, {}), ("mod", {}, _POS),
    ("remainder", {}, _POS), ("floor_mod", {}, _POS),
    ("floor_divide", {}, _POS), ("heaviside", {}, {}),
    ("nextafter", {}, {}),
]
_BINARY_GRAD = {"add", "subtract", "multiply", "divide", "pow", "maximum",
                "minimum", "atan2", "hypot", "logaddexp"}


@pytest.mark.parametrize("name,dx,dy", _BINARY, ids=[c[0] for c in _BINARY])
def test_binary_matches_reference(name, dx, dy):
    x, y = _f(3, 4, 5, **dx), _f(4, 5, seed=1, **dy)  # broadcast
    _check(lambda m, a, b: getattr(m, name)(a, b), [x, y],
           grad=name in _BINARY_GRAD, grad_rtol=1e-5)


@pytest.mark.parametrize("name", ["add", "subtract", "multiply", "divide",
                                  "pow", "maximum", "mod"])
def test_binary_with_python_scalar_keeps_dtype(name):
    x = _f(3, 4, **_POS)
    _check(lambda m, a: getattr(m, name)(a, 2.0), [x])
    _check(lambda m, a: getattr(m, name)(a, 3), [x])


@pytest.mark.parametrize("name", ["add", "subtract", "multiply",
                                  "floor_divide", "mod", "maximum", "gcd",
                                  "lcm", "bitwise_and", "bitwise_or",
                                  "bitwise_xor", "equal", "not_equal",
                                  "greater_than", "greater_equal",
                                  "less_than", "less_equal"])
def test_integer_binary_matches_reference(name):
    x = _i(4, 5, lo=1, hi=40)
    y = _i(4, 5, seed=1, lo=1, hi=12)
    _check(lambda m, a, b: getattr(m, name)(a, b), [x, y])


@pytest.mark.parametrize("name", ["bitwise_left_shift",
                                  "bitwise_right_shift"])
def test_shifts_match_reference(name):
    x = _i(4, 5, lo=0, hi=1000).astype(np.int32)
    y = _i(4, 5, seed=1, lo=0, hi=8).astype(np.int32)
    _check(lambda m, a, b: getattr(m, name)(a, b), [x, y])


@pytest.mark.parametrize("name", ["logical_and", "logical_or",
                                  "logical_xor", "bitwise_and",
                                  "bitwise_or", "bitwise_xor"])
def test_logical_matches_reference(name):
    _check(lambda m, a, b: getattr(m, name)(a, b), [_b(4, 5),
                                                    _b(4, 5, seed=1)])


@pytest.mark.parametrize("name", ["logical_not", "bitwise_not"])
def test_logical_not_matches_reference(name):
    _check(lambda m, a: getattr(m, name)(a), [_b(4, 5)])
    if name == "bitwise_not":
        _check(lambda m, a: getattr(m, name)(a), [_i(4, 5)])


@pytest.mark.parametrize("name", ["igamma", "igammac", "gammainc",
                                  "gammaincc"])
def test_incomplete_gamma_matches_reference(name):
    # series / continued fractions: agreement to a few f32 ulps
    _check(lambda m, a, b: getattr(m, name)(a, b),
           [_f(3, 4, lo=0.5, hi=4.0), _f(3, 4, seed=1, lo=0.1, hi=5.0)],
           rtol=1e-5)


@pytest.mark.parametrize("name", ["inner", "outer", "kron"])
def test_products_match_reference(name):
    _check(lambda m, a, b: getattr(m, name)(a, b),
           [_f(3, 4), _f(2, 4, seed=1)], grad=True, grad_rtol=1e-5)


def test_ldexp_and_comparisons_match_reference():
    _check(lambda m, a, b: m.ldexp(a, b), [_f(3, 4), _i(3, 4, lo=-3, hi=4)])
    _check(lambda m, a, b: m.isclose(a, b), [_f(3, 4), _f(3, 4)])
    _check(lambda m, a, b: m.allclose(a, b), [_f(3, 4), _f(3, 4)])
    _check(lambda m, a, b: m.equal_all(a, b), [_f(3, 4), _f(3, 4, seed=1)])


# -- reductions ---------------------------------------------------------------
_REDUCE = ["sum", "mean", "prod", "nansum", "nanmean", "max", "min", "amax",
           "amin", "logsumexp"]
_AXES = [None, 0, -1, [0, 2]]


@pytest.mark.parametrize("keepdim", [False, True])
@pytest.mark.parametrize("axis", _AXES, ids=str)
@pytest.mark.parametrize("name", _REDUCE)
def test_reductions_match_reference(name, axis, keepdim):
    x = _f(3, 4, 5, lo=0.5, hi=1.5)
    # sums of 60 f32 terms in other orders; keepdim moves no gradient, so
    # the gradient is held once per axis
    _check(lambda m, t: getattr(m, name)(t, axis=axis, keepdim=keepdim), [x],
           rtol=1e-5, grad=not keepdim, grad_rtol=1e-5)


@pytest.mark.parametrize("name", ["sum", "prod", "max", "min"])
def test_integer_reductions_match_reference(name):
    x = _i(3, 4, lo=1, hi=4)
    _check(lambda m, t: getattr(m, name)(t, axis=1), [x])
    _check(lambda m, t: getattr(m, name)(t), [x])


@pytest.mark.parametrize("axis", [None, 0, [0, 1]], ids=str)
@pytest.mark.parametrize("name", ["all", "any", "count_nonzero"])
def test_boolean_reductions_match_reference(name, axis):
    _check(lambda m, t: getattr(m, name)(t, axis=axis), [_b(3, 4)])
    _check(lambda m, t: getattr(m, name)(t, axis=axis, keepdim=True),
           [_b(3, 4)])


@pytest.mark.parametrize("unbiased", [True, False])
@pytest.mark.parametrize("name", ["std", "var"])
def test_moments_match_reference(name, unbiased):
    x = _f(4, 6)
    _check(lambda m, t: getattr(m, name)(t, axis=1, unbiased=unbiased), [x],
           rtol=1e-5, grad=True, grad_rtol=1e-5)
    _check(lambda m, t: getattr(m, name)(t, unbiased=unbiased), [x],
           rtol=1e-5)


@pytest.mark.parametrize("case", [
    ("cumsum", lambda m, t: m.cumsum(t, axis=1)),
    ("cumsum_flat", lambda m, t: m.cumsum(t)),
    ("cumprod", lambda m, t: m.cumprod(t, dim=1)),
    ("logcumsumexp", lambda m, t: m.logcumsumexp(t, axis=1)),
    ("diff", lambda m, t: m.diff(t, axis=1)),
    ("trapezoid", lambda m, t: m.trapezoid(t, dx=0.5, axis=1)),
    ("cumulative_trapezoid", lambda m, t: m.cumulative_trapezoid(t, axis=1)),
], ids=lambda c: c[0])
def test_scans_match_reference(case):
    _check(case[1], [_f(3, 6, lo=0.5, hi=1.5)], rtol=1e-5, grad=True,
           grad_rtol=1e-5)


@pytest.mark.parametrize("name", ["cummax", "cummin"])
def test_cummax_cummin_match_reference(name):
    x = _i(3, 8, lo=0, hi=4).astype(np.float32)  # ties
    _check(lambda m, t: getattr(m, name)(t, axis=1), [x])
    _check(lambda m, t: getattr(m, name)(t), [x])


# -- manipulation -------------------------------------------------------------
_X = _f(2, 3, 4)
_MANIP = [
    ("reshape", lambda m, t: m.reshape(t, [0, 12])),
    ("reshape_neg", lambda m, t: m.reshape(t, [-1, 4])),
    ("transpose", lambda m, t: m.transpose(t, [2, 0, 1])),
    ("permute", lambda m, t: m.permute(t, 1, 0, 2)),
    ("moveaxis", lambda m, t: m.moveaxis(t, 0, 2)),
    ("squeeze", lambda m, t: m.squeeze(m.unsqueeze(t, [0, 2]), [0, 2])),
    ("unsqueeze", lambda m, t: m.unsqueeze(t, [0, -1])),
    ("concat", lambda m, t: m.concat([t, t * 2], axis=1)),
    ("stack", lambda m, t: m.stack([t, t * 2], axis=-1)),
    ("split", lambda m, t: m.split(t, [1, -1, 1], axis=2)),
    ("split_n", lambda m, t: m.split(t, 2, axis=2)),
    ("chunk", lambda m, t: m.chunk(t, 3, axis=1)),
    ("unbind", lambda m, t: m.unbind(t, axis=1)),
    ("unstack", lambda m, t: m.unstack(t, axis=0)),
    ("flatten", lambda m, t: m.flatten(t, 1, 2)),
    ("flip", lambda m, t: m.flip(t, [0, 2])),
    ("rot90", lambda m, t: m.rot90(t, 1, (1, 2))),
    ("roll", lambda m, t: m.roll(t, 2, axis=2)),
    ("roll_flat", lambda m, t: m.roll(t, 3)),
    ("tile", lambda m, t: m.tile(t, [2, 1, 1])),
    ("expand", lambda m, t: m.expand(m.unsqueeze(t, 0), [3, -1, -1, -1])),
    ("expand_as", lambda m, t: m.expand_as(t[0:1], t)),
    ("broadcast_to", lambda m, t: m.broadcast_to(t[:, :1], [2, 3, 4])),
    ("broadcast_tensors", lambda m, t: m.broadcast_tensors([t, t[:, :1]])),
    ("slice", lambda m, t: m.slice(t, [1, 2], [0, 1], [2, 3])),
    ("strided_slice", lambda m, t: m.strided_slice(t, [2], [0], [4], [2])),
    ("strided_slice_neg",
     lambda m, t: m.strided_slice(t, [2], [3], [0], [-1])),
    ("crop", lambda m, t: m.crop(t, [2, 2, 2], [0, 1, 1])),
    ("pad_full", lambda m, t: m.pad(t, [0, 0, 1, 2, 2, 1])),
    ("pad_reflect", lambda m, t: m.pad(t, [1, 1], mode="reflect")),
    ("pad_replicate", lambda m, t: m.pad(t, [2, 1], mode="replicate")),
    ("pad_circular", lambda m, t: m.pad(t, [1, 2], mode="circular")),
    ("diagonal", lambda m, t: m.diagonal(t, 0, 1, 2)),
    ("atleast_3d", lambda m, t: m.atleast_3d(t[0, 0])),
    ("atleast_1d", lambda m, t: m.atleast_1d(t[0, 0, 0])),
    ("atleast_2d", lambda m, t: m.atleast_2d(t[0, 0])),
    ("unfold", lambda m, t: m.unfold(m.reshape(t, [1, 2, 3, 4]), 2)),
    ("unfold_strided", lambda m, t: m.unfold(
        m.reshape(t, [2, 1, 3, 4]), [2, 3], strides=[1, 2], paddings=1)),
    ("view", lambda m, t: m.view(t, [4, 6])),
    ("view_as", lambda m, t: m.view_as(t, t.reshape([6, 4]))),
    ("hstack", lambda m, t: m.hstack([t, t])),
    ("column_stack", lambda m, t: m.column_stack([t[0], t[1]])),
    ("row_stack", lambda m, t: m.row_stack([t[0], t[1]])),
    ("tensor_split", lambda m, t: m.tensor_split(t, 3, axis=2)),
    ("hsplit", lambda m, t: m.hsplit(t, [1])),
    ("vsplit", lambda m, t: m.vsplit(t, 2)),
    ("dsplit", lambda m, t: m.dsplit(t, [1, 3])),
    ("unflatten", lambda m, t: m.unflatten(t, 2, [2, 2])),
    ("as_strided", lambda m, t: m.as_strided(t, [3, 4], [4, 1], 2)),
    ("diag_embed", lambda m, t: m.diag_embed(t, offset=1)),
    ("repeat_interleave", lambda m, t: m.repeat_interleave(t, 2, axis=1)),
    ("block_diag", lambda m, t: m.block_diag([t[0], t[1, :2]])),
    ("select_scatter",
     lambda m, t: m.select_scatter(t, t[:, 0] * 0.0, 1, 0)),
    ("slice_scatter", lambda m, t: m.slice_scatter(
        t, t[:, :, 0:2] * 2.0, [2], [0], [4], [2])),
    ("diagonal_scatter",
     lambda m, t: m.diagonal_scatter(t[0], t[0].diagonal() * 3.0)),
    ("tril", lambda m, t: m.tril(t[0], -1)),
    ("triu", lambda m, t: m.triu(t[0], 1)),
    ("diag_vec", lambda m, t: m.diag(t[0, 0], offset=1)),
    ("diag_mat", lambda m, t: m.diag(t[0])),
    ("diagflat", lambda m, t: m.diagflat(t[0, :2])),
    ("trace", lambda m, t: m.trace(t[0])),
    ("cast", lambda m, t: m.cast(t, "float64")),
    ("renorm", lambda m, t: m.renorm(t, 2.0, 0, 2.0)),
    ("clip", lambda m, t: m.clip(t, -0.5, 0.7)),
    ("scale", lambda m, t: m.scale(t, 2.0, 0.5)),
    ("scale_before", lambda m, t: m.scale(t, 2.0, 0.5,
                                          bias_after_scale=False)),
    ("lerp", lambda m, t: m.lerp(t, t * 3.0, 0.25)),
    ("nan_to_num", lambda m, t: m.nan_to_num(m.log(t))),
    ("add_n", lambda m, t: m.add_n([t, t * 2.0, t * 3.0])),
    ("masked_fill", lambda m, t: m.masked_fill(t, t > 0, -1.0)),
    ("where", lambda m, t: m.where(t > 0, t, t * -2.0)),
    ("addmm", lambda m, t: m.addmm(t[0, :, :3], t[0], t[1].T[:, :3])),
    ("vander", lambda m, t: m.vander(t[0, 0], 3)),
    ("einsum", lambda m, t: m.einsum("bij,bkj->bik", t, t)),
    ("tensordot", lambda m, t: m.tensordot(t, t, [[1, 2], [1, 2]])),
    ("matmul", lambda m, t: m.matmul(t, t, transpose_y=True)),
    ("matmul_tx", lambda m, t: m.matmul(t, t, transpose_x=True)),
    ("mm", lambda m, t: m.mm(t[0], t[1].T)),
    ("bmm", lambda m, t: m.bmm(t, m.transpose(t, [0, 2, 1]))),
    ("mv", lambda m, t: m.mv(t[0], t[1, 0])),
    ("dot", lambda m, t: m.dot(t[0], t[1])),
    ("multi_dot", lambda m, t: m.multi_dot([t[0], t[1].T, t[0]])),
    ("cross", lambda m, t: m.cross(t[:, :, :3], t[:, :, 1:])),
    ("cdist", lambda m, t: m.cdist(t[0], t[1])),
    ("cdist_p1", lambda m, t: m.cdist(t[0], t[1], p=1.0)),
    ("norm", lambda m, t: m.norm(t)),
    ("norm_axis", lambda m, t: m.norm(t, p=1, axis=2)),
    ("norm_mat", lambda m, t: m.norm(t, p="fro", axis=[1, 2])),
    ("dist", lambda m, t: m.dist(t[0], t[1], p=3)),
    ("t", lambda m, t: m.t(t[0])),
    ("transpose_last", lambda m, t: m.transpose_last(t)),
]
_MANIP_NO_GRAD = {"split", "split_n", "chunk", "unbind", "unstack",
                  "broadcast_tensors", "tensor_split", "hsplit", "vsplit",
                  "dsplit", "cast", "nan_to_num", "strided_slice_neg"}


@pytest.mark.parametrize("case", _MANIP, ids=[c[0] for c in _MANIP])
def test_manipulation_and_products_match_reference(case):
    name, fn = case
    _check(fn, [_X], rtol=1e-5 if name in ("cdist", "renorm") else 1e-6,
           grad=name not in _MANIP_NO_GRAD, grad_rtol=1e-5)


_IDX = [
    ("gather", lambda m, t, i: m.gather(t, i[:3] % 3, axis=1)),
    ("gather_nd", lambda m, t, i: m.gather_nd(t, m.stack(
        [i[:4] % 2, i[1:5] % 3], axis=1))),
    ("index_select", lambda m, t, i: m.index_select(t, i[:5] % 4, axis=2)),
    ("index_sample", lambda m, t, i: m.index_sample(
        t[0], m.reshape(i[:6] % 4, [3, 2]))),
    ("take_along_axis", lambda m, t, i: m.take_along_axis(
        t, m.reshape(i[:6] % 3, [1, 3, 2]), axis=2)),
    ("put_along_axis", lambda m, t, i: m.put_along_axis(
        t[0], m.reshape(i[:3] % 4, [3, 1]), 9.0, axis=1)),
    ("put_along_axis_add", lambda m, t, i: m.put_along_axis(
        t[0], m.reshape(m.concat([i, i])[:12] % 4, [3, 4]), 9.0, axis=1,
        reduce="add")),
    ("scatter", lambda m, t, i: m.scatter(t[0], i[:2] % 3, t[1, :2] * 5.0)),
    ("scatter_add", lambda m, t, i: m.scatter(
        t[0], i[:2] % 3, t[1, :2] * 5.0, overwrite=False)),
    ("scatter_nd", lambda m, t, i: m.scatter_nd(
        m.reshape(i[:4] % 3, [4, 1]), t[0, :, :].reshape([3, 4])[[0, 1, 2,
                                                                  0]],
        [3, 4])),
    ("scatter_nd_add", lambda m, t, i: m.scatter_nd_add(
        t[0], m.reshape(i[:2] % 3, [2, 1]), t[1, :2])),
    ("index_put", lambda m, t, i: m.index_put(
        t[0], (i[:2] % 3, i[2:4] % 4), t[1, 0, :2], accumulate=True)),
    ("index_fill", lambda m, t, i: m.index_fill(t, i[:2] % 4, 2, -7.0)),
    ("masked_select", lambda m, t, i: m.masked_select(t, t > 0.2)),
    ("masked_scatter", lambda m, t, i: m.masked_scatter(t, t > 0.2,
                                                        t * 10.0)),
    ("take", lambda m, t, i: m.take(t, m.reshape(i[:6] % 24, [2, 3]))),
    ("take_wrap", lambda m, t, i: m.take(t, i[:6] - 3, mode="wrap")),
    ("multiplex", lambda m, t, i: m.multiplex(
        [t[0], t[1]], m.reshape(i[:3] % 2, [3, 1]))),
    ("shard_index", lambda m, t, i: m.shard_index(
        m.reshape(i % 20, [-1, 1]), 20, 2, 1)),
]


@pytest.mark.parametrize("case", _IDX, ids=[c[0] for c in _IDX])
def test_indexing_ops_match_reference(case):
    name, fn = case
    idx = _i(8, seed=3, lo=0, hi=50)
    _check(fn, [_X, idx], grad=name not in ("shard_index", "put_along_axis",
                                           "masked_select", "scatter_nd",
                                           "scatter_nd_add", "index_fill"),
           grad_rtol=1e-5)


# -- search, sort and statistics ----------------------------------------------
_SEARCH = [
    ("argmax", lambda m, t: m.argmax(t, axis=1)),
    ("argmax_flat", lambda m, t: m.argmax(t)),
    ("argmin_keep", lambda m, t: m.argmin(t, axis=-1, keepdim=True)),
    ("argsort", lambda m, t: m.argsort(t, axis=1)),
    ("argsort_desc", lambda m, t: m.argsort(t, axis=-1, descending=True)),
    ("sort", lambda m, t: m.sort(t, axis=1)),
    ("sort_desc", lambda m, t: m.sort(t, axis=0, descending=True)),
    ("topk", lambda m, t: m.topk(t, 2, axis=1)),
    ("topk_small", lambda m, t: m.topk(t, 3, largest=False)),
    ("nonzero", lambda m, t: m.nonzero(t > 0.5)),
    ("nonzero_tuple", lambda m, t: m.nonzero(t > 0.5, as_tuple=True)),
    ("where_cond", lambda m, t: m.where(t > 0.5)),
    ("kthvalue", lambda m, t: m.kthvalue(t, 2, axis=1)),
    ("median", lambda m, t: m.median(t, axis=1)),
    ("median_flat", lambda m, t: m.median(t)),
    ("median_min", lambda m, t: m.median(t, axis=0, mode="min")),
    ("quantile", lambda m, t: m.quantile(t, 0.3, axis=1)),
    ("quantile_list", lambda m, t: m.quantile(t, [0.2, 0.9], axis=0)),
    ("nanquantile", lambda m, t: m.nanquantile(t, 0.5, axis=1)),
    ("nanmedian", lambda m, t: m.nanmedian(t, axis=1)),
]


@pytest.mark.parametrize("case", _SEARCH, ids=[c[0] for c in _SEARCH])
def test_search_and_sort_match_reference(case):
    x = _rs(5).permutation(40).reshape(5, 8).astype(np.float32) / 7.0
    _check(case[1], [x])


def test_index_add_matches_numpy():
    """The reference's ``index_add`` calls its own ``slice`` op where it
    means the builtin and raises, so numpy's ``add.at`` is the oracle."""
    x, v = _f(3, 4), _f(3, 2, seed=1)
    idx = np.array([3, 1])
    want = x.copy()
    np.add.at(want, (slice(None), idx), v)
    got = T.index_add(T.to_tensor(x), T.to_tensor(idx), 1, T.to_tensor(v))
    _same(_np(got), want, 1e-6)
    dup = np.array([1, 1])
    want = x.copy()
    np.add.at(want, (slice(None), dup), v)
    _same(_np(T.index_add(T.to_tensor(x), T.to_tensor(dup), 1,
                          T.to_tensor(v))), want, 1e-6)


def test_searchsorted_bucketize_mode_and_unique_match_reference():
    s = np.sort(_f(10))
    v = _f(3, 4, seed=1)
    _check(lambda m, a, b: m.searchsorted(a, b), [s, v])
    _check(lambda m, a, b: m.searchsorted(a, b, right=True, out_int32=True),
           [s, v])
    _check(lambda m, a, b: m.bucketize(b, a), [s, v])
    ties = _i(4, 9, lo=0, hi=4).astype(np.float32)
    _check(lambda m, t: m.mode(t, axis=1), [ties])
    _check(lambda m, t: m.mode(t, axis=0, keepdim=True), [ties])
    _check(lambda m, t: m.unique(t, return_index=True, return_inverse=True,
                                 return_counts=True), [ties])
    _check(lambda m, t: m.unique(t, return_counts=True, axis=0), [ties])
    _check(lambda m, t: m.unique_consecutive(t, return_inverse=True,
                                             return_counts=True), [ties])
    _check(lambda m, t: m.unique_consecutive(t, return_counts=True, axis=1),
           [ties])


def test_histograms_match_reference():
    x = _f(50)
    _check(lambda m, t: m.histogram(t, bins=7), [x])
    _check(lambda m, t: m.histogram(t, bins=5, min=-1, max=1), [x])
    _check(lambda m, t: m.bincount(t), [_i(30, lo=0, hi=9)])
    _check(lambda m, t, w: m.bincount(t, weights=w, minlength=12),
           [_i(30, lo=0, hi=9), _f(30)])
    _check(lambda m, t: m.histogramdd(t, bins=4)[0], [_f(40, 2)])
    _check(lambda m, t: m.corrcoef(t), [_f(3, 10)], rtol=1e-5)
    _check(lambda m, t: m.cov(t), [_f(3, 10)], rtol=1e-5)
    _check(lambda m, t: m.cov(t, rowvar=False, ddof=False), [_f(10, 3)],
           rtol=1e-5)


# -- linalg -----------------------------------------------------------------
def _spd(n, seed=0):
    a = _f(n, n, seed=seed)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


# decompositions in f32: LAPACK's and XLA's orders of operations agree to
# ~1e-5 of the largest entry at these sizes
_LINALG = [
    ("inv", lambda m, a: m.linalg.inv(a), [_spd(5)]),
    ("inverse", lambda m, a: m.inverse(a), [_spd(4)]),
    ("det", lambda m, a: m.linalg.det(a), [_spd(4)]),
    ("slogdet", lambda m, a: m.linalg.slogdet(a), [_spd(4)]),
    ("cholesky", lambda m, a: m.linalg.cholesky(a), [_spd(5)]),
    ("cholesky_upper", lambda m, a: m.linalg.cholesky(a, upper=True),
     [_spd(5)]),
    ("solve", lambda m, a, b: m.linalg.solve(a, b), [_spd(5), _f(5, 2)]),
    ("triangular_solve", lambda m, a, b: m.linalg.triangular_solve(
        m.triu(a), b), [_spd(4), _f(4, 3)]),
    ("triangular_solve_lower_t", lambda m, a, b: m.linalg.triangular_solve(
        m.tril(a), b, upper=False, transpose=True), [_spd(4), _f(4, 3)]),
    ("cholesky_solve", lambda m, a, b: m.linalg.cholesky_solve(
        b, m.linalg.cholesky(a)), [_spd(4), _f(4, 2)]),
    ("pinv", lambda m, a: m.linalg.pinv(a), [_f(5, 3)]),
    ("matrix_power", lambda m, a: m.linalg.matrix_power(a, 3), [_f(4, 4)]),
    ("matrix_rank", lambda m, a: m.linalg.matrix_rank(a), [_f(5, 3)]),
    ("matrix_exp", lambda m, a: m.linalg.matrix_exp(a * 0.3), [_f(4, 4)]),
    ("cond", lambda m, a: m.linalg.cond(a), [_spd(4)]),
    ("eigvalsh", lambda m, a: m.linalg.eigvalsh(a), [_spd(5)]),
    ("lstsq", lambda m, a, b: m.linalg.lstsq(a, b)[0], [_f(6, 3),
                                                       _f(6, 2, seed=1)]),
    ("lu", lambda m, a: m.linalg.lu(a), [_f(4, 4)]),
    ("lu_unpack", lambda m, a: m.linalg.lu_unpack(*m.linalg.lu(a)),
     [_f(4, 4)]),
    ("householder_product", lambda m, a, t: m.linalg.householder_product(
        a, t), [_f(5, 3), _f(3, seed=1, lo=0.5, hi=1.5)]),
]


@pytest.mark.parametrize("case", _LINALG, ids=[c[0] for c in _LINALG])
def test_linalg_matches_reference(case):
    name, fn, arrays = case
    _check(fn, arrays, rtol=2e-5)


def test_decompositions_match_reference_up_to_signs():
    a, s = _f(5, 3), _spd(5)
    pu, ps, pv = [_np(o) for o in T.linalg.svd(T.to_tensor(a))]
    ru, rs, rv = [_np(o) for o in P.linalg.svd(P.to_tensor(a))]
    _same(ps, rs, 2e-5)
    _same((pu * ps) @ pv, (ru * rs) @ rv, 2e-5)
    pq, pr = [_np(o) for o in T.linalg.qr(T.to_tensor(a))]
    rq, rr = [_np(o) for o in P.linalg.qr(P.to_tensor(a))]
    _same(np.abs(pr), np.abs(rr), 2e-5)
    _same(pq @ pr, rq @ rr, 2e-5)
    pw, pvec = [_np(o) for o in T.linalg.eigh(T.to_tensor(s))]
    rw, rvec = [_np(o) for o in P.linalg.eigh(P.to_tensor(s))]
    _same(pw, rw, 2e-5)
    _same(np.abs(pvec.T @ rvec), np.eye(5, dtype=np.float32), 2e-4)
    ev = np.sort_complex(_np(T.linalg.eigvals(T.to_tensor(s))))
    rev = np.sort_complex(_np(P.linalg.eigvals(P.to_tensor(s))))
    _same(ev, rev, 2e-5)
    w, _ = T.linalg.eig(T.to_tensor(s))
    _same(np.sort_complex(_np(w)), rev, 2e-5)


def test_linalg_gradients_match_reference():
    _check(lambda m, a: m.linalg.inv(a), [_spd(4)], rtol=2e-5, grad=True,
           grad_rtol=2e-5)
    _check(lambda m, a: m.linalg.det(a), [_spd(3)], rtol=2e-5, grad=True,
           grad_rtol=2e-5)
    _check(lambda m, a, b: m.linalg.solve(a, b), [_spd(4), _f(4, 2)],
           rtol=2e-5, grad=True, grad_rtol=2e-5)


# -- creation ---------------------------------------------------------------
_CREATE = [
    ("zeros", lambda m: m.zeros([2, 3])),
    ("ones_int", lambda m: m.ones([2, 3], dtype="int32")),
    ("full", lambda m: m.full([2, 2], 1.5)),
    ("full_int", lambda m: m.full([2, 2], 3)),
    ("full_bool", lambda m: m.full([2], True)),
    ("empty", lambda m: m.empty([3]) * 0),
    ("arange", lambda m: m.arange(5)),
    ("arange_float", lambda m: m.arange(0.0, 2.0, 0.25)),
    ("arange_steps", lambda m: m.arange(2, 11, 3)),
    ("linspace", lambda m: m.linspace(0, 1, 7)),
    ("logspace", lambda m: m.logspace(0, 2, 5)),
    ("eye", lambda m: m.eye(3, 4)),
    ("tril_indices", lambda m: m.tril_indices(4, 4, -1)),
    ("triu_indices", lambda m: m.triu_indices(4, 5, 1)),
    ("to_tensor_float", lambda m: m.to_tensor([1.5, 2.0])),
    ("to_tensor_int", lambda m: m.to_tensor([[1, 2], [3, 4]])),
    ("to_tensor_bool", lambda m: m.to_tensor([True, False])),
    ("to_tensor_scalar", lambda m: m.to_tensor(3.25)),
    ("to_tensor_dtype", lambda m: m.to_tensor([1, 2], dtype="float32")),
    ("to_tensor_f16", lambda m: m.to_tensor([1.1, 2.2], dtype="float16")),
    ("shape", lambda m: m.shape(m.zeros([2, 5, 3]))),
    ("rank", lambda m: m.rank(m.zeros([2, 5, 3]))),
    ("one_hot_top", lambda m: m.one_hot(m.to_tensor([3, 0]), 4)),
    ("meshgrid", lambda m: m.meshgrid(m.arange(3), m.arange(2))),
    ("cartesian_prod", lambda m: m.cartesian_prod([m.arange(3),
                                                   m.arange(2)])),
    ("combinations", lambda m: m.combinations(m.arange(4), 2)),
    ("combinations_rep", lambda m: m.combinations(
        m.arange(3), 2, with_replacement=True)),
    ("numel", lambda m: m.numel(m.zeros([2, 5]))),
    ("is_empty", lambda m: m.is_empty(m.zeros([0, 5]))),
    ("assign", lambda m: m.assign(np.arange(4.0, dtype=np.float32))),
    ("complex", lambda m: m.complex(m.ones([2]), m.full([2], 2.0))),
    ("polar", lambda m: m.polar(m.ones([2]), m.full([2], 0.5))),
    ("as_real", lambda m: m.as_real(m.complex(m.ones([2]),
                                              m.full([2], 2.0)))),
    ("as_complex", lambda m: m.as_complex(m.ones([3, 2]))),
    ("frexp", lambda m: m.frexp(m.to_tensor([0.75, 10.0, -3.0]))),
]


@pytest.mark.parametrize("case", _CREATE, ids=[c[0] for c in _CREATE])
def test_creation_matches_reference(case):
    _same(_np(case[1](T)), _np(case[1](P)), 1e-6)


def test_like_creation_and_predicates_match_reference():
    x = _f(2, 3)
    for name in ("zeros_like", "ones_like", "empty_like"):
        _check(lambda m, t: getattr(m, name)(t) * 1, [x])
    _check(lambda m, t: m.full_like(t, 7.0), [x])
    _check(lambda m, t: m.zeros_like(t, dtype="int32"), [x])
    _check(lambda m, t: m.clone(t), [x])
    for name in ("is_floating_point", "is_complex", "is_integer"):
        for arr in (x, _i(3)):
            assert getattr(T, name)(T.to_tensor(arr)) == \
                bool(getattr(P, name)(P.to_tensor(arr))), name
    assert T.is_tensor(T.to_tensor(x)) and not T.is_tensor(x)
    assert T.broadcast_shape([2, 1, 3], [4, 3]) == P.broadcast_shape(
        [2, 1, 3], [4, 3])
    assert T.tolist(T.to_tensor(x)) == P.tolist(P.to_tensor(x))


def test_special_long_tail_matches_reference():
    x = _f(3, 4, lo=1.5, hi=4.0)
    _check(lambda m, t: m.polygamma(t, 1), [x], rtol=1e-5)
    _check(lambda m, t: m.multigammaln(t, 3), [x], rtol=1e-5)
    _check(lambda m, t: m.increment(t * 1.0, 2.0), [x])


@pytest.mark.parametrize("case", [
    ("reshape_", lambda m, t: t * 1.0, lambda m, v: m.reshape_(v, [4, 6])),
    ("squeeze_", lambda m, t: m.reshape(t, [1, 24]),
     lambda m, v: m.squeeze_(v, 0)),
    ("unsqueeze_", lambda m, t: t * 1.0, lambda m, v: m.unsqueeze_(v, 1)),
    ("rsqrt_", lambda m, t: m.abs(t) + 0.5, lambda m, v: m.rsqrt_(v)),
    ("scatter_", lambda m, t: t[0] * 1.0, lambda m, v: m.scatter_(
        v, m.to_tensor([2, 0]), v[:2] * 3.0)),
], ids=lambda c: c[0])
def test_inplace_ops_match_reference_and_write_in_place(case):
    """The port's in-place ops return the tensor they are given, written
    (the reference rebinds its tensor's value), equal to the
    reference's."""
    name, prep, op = case
    target = prep(T, T.to_tensor(_X))
    out = op(T, target)
    assert out is target
    _same(_np(out), _np(op(P, prep(P, P.to_tensor(_X)))), 1e-6)
