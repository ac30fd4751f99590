"""Math ops (the reference's ``paddle_tpu/tensor/math.py``) on torch:
paddle's signatures (``axis`` / ``keepdim``, python scalars kept raw so a
tensor keeps its dtype) over torch's ops. Integer sums and products give
int64, as paddle's do (the reference, with JAX's 64-bit mode off, gives
int32)."""
from __future__ import annotations

import builtins
import itertools

import torch

from ._helpers import (apply, axes_arg, default_float, ensure_tensor,
                       is_scalar, to_torch_dtype)


def _unary(tfn, name):
    def op(x, name=None):
        return apply(tfn, ensure_tensor(x), op_name=op.__name__)

    op.__name__ = op.__qualname__ = name
    return op


def _binary(tfn, name):
    def op(x, y, name=None):
        # a python scalar becomes a 0-d tensor on the other operand's
        # device: it promotes as a scalar, so the tensor keeps its dtype
        if is_scalar(x) and not is_scalar(y):
            y = ensure_tensor(y)
            x = torch.as_tensor(x, device=y.device)
        else:
            x = ensure_tensor(x)
            y = (torch.as_tensor(y, device=x.device) if is_scalar(y)
                 else ensure_tensor(y, like=x))
        return apply(tfn, x, y, op_name=op.__name__)

    op.__name__ = op.__qualname__ = name
    return op


def _float(v):
    """Integer and bool inputs compute in the default float dtype, as
    jnp's transcendental ops do."""
    return v if (v.is_floating_point() or v.is_complex()) else \
        v.to(default_float())


_HALF = (torch.float16, torch.bfloat16)


def _special(fn):
    """A special function computed in f32 for 16-bit inputs (torch has no
    16-bit CUDA kernel for some) and rounded back; integers take the
    default float dtype."""
    def op(*vs):
        out_dt = vs[0].dtype if vs[0].dtype in _HALF else None
        vs = [v.float() if v.dtype in _HALF else _float(v) for v in vs]
        out = fn(*vs)
        return out.to(out_dt) if out_dt is not None else out

    return op


# -- elementwise unary -------------------------------------------------------
exp = _unary(torch.exp, "exp")
expm1 = _unary(torch.expm1, "expm1")
log = _unary(torch.log, "log")
log2 = _unary(torch.log2, "log2")
log10 = _unary(torch.log10, "log10")
log1p = _unary(torch.log1p, "log1p")
sqrt = _unary(torch.sqrt, "sqrt")
rsqrt = _unary(torch.rsqrt, "rsqrt")
square = _unary(torch.square, "square")
abs = _unary(torch.abs, "abs")
neg = _unary(torch.neg, "neg")
sign = _unary(torch.sign, "sign")
floor = _unary(torch.floor, "floor")
ceil = _unary(torch.ceil, "ceil")
round = _unary(torch.round, "round")
trunc = _unary(torch.trunc, "trunc")
frac = _unary(lambda v: v - torch.trunc(v), "frac")
sin = _unary(torch.sin, "sin")
cos = _unary(torch.cos, "cos")
tan = _unary(torch.tan, "tan")
asin = _unary(torch.asin, "asin")
acos = _unary(torch.acos, "acos")
atan = _unary(torch.atan, "atan")
sinh = _unary(torch.sinh, "sinh")
cosh = _unary(torch.cosh, "cosh")
tanh = _unary(torch.tanh, "tanh")
asinh = _unary(torch.asinh, "asinh")
acosh = _unary(torch.acosh, "acosh")
atanh = _unary(torch.atanh, "atanh")
erf = _unary(torch.erf, "erf")
erfinv = _unary(_special(torch.erfinv), "erfinv")
sigmoid = _unary(torch.sigmoid, "sigmoid")
reciprocal = _unary(lambda v: 1.0 / v, "reciprocal")
digamma = _unary(_special(torch.digamma), "digamma")
lgamma = _unary(_special(torch.lgamma), "lgamma")
i0 = _unary(_special(torch.special.i0), "i0")
deg2rad = _unary(lambda v: torch.deg2rad(_float(v)), "deg2rad")
rad2deg = _unary(lambda v: torch.rad2deg(_float(v)), "rad2deg")
angle = _unary(_special(torch.angle), "angle")
conj = _unary(torch.conj_physical, "conj")
real = _unary(torch.real, "real")
imag = _unary(torch.imag, "imag")
logit = _unary(torch.logit, "logit")


def rsqrt_(x):
    return x.rsqrt_()


# -- elementwise binary ------------------------------------------------------
add = _binary(torch.add, "add")
subtract = _binary(torch.subtract, "subtract")
multiply = _binary(torch.multiply, "multiply")
divide = _binary(torch.true_divide, "divide")
floor_divide = _binary(torch.floor_divide, "floor_divide")
mod = _binary(torch.remainder, "mod")
remainder = mod
floor_mod = mod
pow = _binary(torch.pow, "pow")
maximum = _binary(torch.maximum, "maximum")
minimum = _binary(torch.minimum, "minimum")
fmax = _binary(torch.fmax, "fmax")
fmin = _binary(torch.fmin, "fmin")
atan2 = _binary(torch.atan2, "atan2")
hypot = _binary(torch.hypot, "hypot")
positive = _unary(torch.positive, "positive")
logaddexp = _binary(torch.logaddexp, "logaddexp")
heaviside = _binary(lambda a, b: torch.heaviside(a, b.to(a.dtype)),
                    "heaviside")
copysign = _binary(torch.copysign, "copysign")
nextafter = _binary(torch.nextafter, "nextafter")
ldexp = _binary(lambda a, b: a * torch.pow(2.0, b).to(_float(a).dtype),
                "ldexp")
gcd = _binary(torch.gcd, "gcd")
lcm = _binary(torch.lcm, "lcm")
inner = _binary(torch.inner, "inner")
outer = _binary(lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)),
                "outer")
kron = _binary(torch.kron, "kron")


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    x = ensure_tensor(x)
    s = scale if isinstance(scale, torch.Tensor) else float(scale)

    def fn(v):
        return v * s + bias if bias_after_scale else (v + bias) * s

    return apply(fn, x, op_name="scale")


def clip(x, min=None, max=None, name=None):
    return apply(lambda v: torch.clamp(v, min, max), ensure_tensor(x),
                 op_name="clip")


def lerp(x, y, weight, name=None):
    x = ensure_tensor(x)
    y = ensure_tensor(y, like=x)
    return apply(lambda a, b: a + weight * (b - a), x, y, op_name="lerp")


def multiplex(inputs, index, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    idx = ensure_tensor(index, like=ts[0]).reshape(-1).long()
    stacked = torch.stack(ts, dim=0)
    return stacked[idx, torch.arange(ts[0].shape[0], device=idx.device)]


def nan_to_num(x, nan=0.0, posinf=None, neginf=None, name=None):
    return apply(torch.nan_to_num, ensure_tensor(x), nan=nan, posinf=posinf,
                 neginf=neginf, op_name="nan_to_num")


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return apply(lambda v: scale_b * torch.tanh(scale_a * v),
                 ensure_tensor(x), op_name="stanh")


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    input = ensure_tensor(input)
    return apply(lambda i, a, b: beta * i + alpha * (a @ b), input,
                 ensure_tensor(x, like=input), ensure_tensor(y, like=input),
                 op_name="addmm")


# -- reductions --------------------------------------------------------------
def _dims(v, axis):
    ax = axes_arg(axis)
    if ax is None:
        return tuple(range(v.ndim))
    return (ax,) if isinstance(ax, int) else ax


def _reduce(tfn, name, int_promote=False, as_float=False):
    def op(x, axis=None, keepdim=False, name=None, dtype=None):
        x = ensure_tensor(x)
        dt = to_torch_dtype(dtype)

        def fn(v):
            if dt is not None:
                v = v.to(dt)
            elif int_promote and not (v.is_floating_point()
                                      or v.is_complex()):
                v = v.to(torch.int64)
            elif as_float:
                v = _float(v)
            return tfn(v, _dims(v, axis), keepdim)

        return apply(fn, x, op_name=op.__name__)

    op.__name__ = op.__qualname__ = name
    return op


def _prod(v, dims, keepdim):
    for d in sorted((d % builtins.max(v.ndim, 1) for d in dims),
                    reverse=True):
        v = torch.prod(v, d, keepdim=keepdim)
    return v


sum = _reduce(lambda v, d, k: torch.sum(v, d, keepdim=k), "sum",
              int_promote=True)
mean = _reduce(lambda v, d, k: torch.mean(v, d, keepdim=k), "mean",
               as_float=True)
prod = _reduce(_prod, "prod", int_promote=True)
nansum = _reduce(lambda v, d, k: torch.nansum(v, d, keepdim=k), "nansum")
nanmean = _reduce(lambda v, d, k: torch.nanmean(v, d, keepdim=k), "nanmean",
                  as_float=True)


def max(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply(lambda v: torch.amax(v, _dims(v, axis), keepdim=keepdim),
                 x, op_name="max")


def min(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply(lambda v: torch.amin(v, _dims(v, axis), keepdim=keepdim),
                 x, op_name="min")


def amax(x, axis=None, keepdim=False, name=None):
    return max(x, axis, keepdim)


def amin(x, axis=None, keepdim=False, name=None):
    return min(x, axis, keepdim)


def logsumexp(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return apply(lambda v: torch.logsumexp(_float(v), _dims(v, axis),
                                           keepdim=keepdim),
                 x, op_name="logsumexp")


def _scan(fn, v, dim):
    """A running sum, product or log-sum-exp: 16-bit inputs accumulate in
    f32 and round once (torch's CUDA scans would carry the partial results
    in 16 bits)."""
    if v.dtype in _HALF:
        return fn(v.float(), dim).to(v.dtype)
    return fn(v, dim)


def cumsum(x, axis=None, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = to_torch_dtype(dtype)
    v = x.reshape(-1) if axis is None else x
    out = _scan(torch.cumsum, v, 0 if axis is None else int(axis))
    return out.to(dt) if dt is not None else out


def cumprod(x, dim=None, dtype=None, name=None):
    x = ensure_tensor(x)
    dt = to_torch_dtype(dtype)
    out = _scan(torch.cumprod, x, int(dim))
    return out.to(dt) if dt is not None else out


def cummax(x, axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    v = x.reshape(-1) if axis is None else x
    vals, idx = torch.cummax(v, 0 if axis is None else int(axis))
    return vals, idx.to(to_torch_dtype(dtype))


def cummin(x, axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    v = x.reshape(-1) if axis is None else x
    vals, idx = torch.cummin(v, 0 if axis is None else int(axis))
    return vals, idx.to(to_torch_dtype(dtype))


def count_nonzero(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    dims = _dims(x, axis)
    out = torch.count_nonzero(x, dims)
    if keepdim:
        for d in sorted(a % x.ndim for a in dims):
            out = out.unsqueeze(d)
    return out


def all(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return torch.all(x, _dims(x, axis), keepdim=keepdim)


def any(x, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    return torch.any(x, _dims(x, axis), keepdim=keepdim)


# -- tests -------------------------------------------------------------------
isnan = _unary(torch.isnan, "isnan")
isinf = _unary(torch.isinf, "isinf")
isfinite = _unary(torch.isfinite, "isfinite")


def isclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    x = ensure_tensor(x)
    return torch.isclose(x, ensure_tensor(y, like=x), rtol=rtol, atol=atol,
                         equal_nan=equal_nan)


def allclose(x, y, rtol=1e-5, atol=1e-8, equal_nan=False, name=None):
    x = ensure_tensor(x)
    return torch.as_tensor(
        torch.allclose(x, ensure_tensor(y, like=x), rtol=rtol, atol=atol,
                       equal_nan=equal_nan), device=x.device)


def equal_all(x, y, name=None):
    x = ensure_tensor(x)
    return torch.as_tensor(torch.equal(x, ensure_tensor(y, like=x)),
                           device=x.device)


# -- misc --------------------------------------------------------------------
def increment(x, value=1.0, name=None):
    return x.add_(value)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    x = ensure_tensor(x)
    pre = None if prepend is None else ensure_tensor(prepend, like=x)
    app = None if append is None else ensure_tensor(append, like=x)
    return torch.diff(x, n=n, dim=axis, prepend=pre, append=app)


def trapezoid(y, x=None, dx=None, axis=-1, name=None):
    y = ensure_tensor(y)
    if x is not None:
        return torch.trapezoid(y, ensure_tensor(x, like=y), dim=axis)
    return torch.trapezoid(y, dx=1.0 if dx is None else dx, dim=axis)


def take(x, index, mode="raise", name=None):
    """Indices into the flattened ``x``. ``mode`` 'raise' checks the range
    on the host and then clamps, as the reference does (a negative index
    reads element 0 under 'raise' and 'clip'); 'wrap' wraps."""
    x = ensure_tensor(x)
    index = ensure_tensor(index, like=x).long()
    n = x.numel()
    if mode == "raise":
        if index.numel() and (int(index.max()) >= n
                              or int(index.min()) < -n):
            raise IndexError(
                f"take: index out of range for tensor with {n} elements")
        mode = "clip"
    flat_idx = (index.clamp(0, n - 1) if mode == "clip"
                else torch.remainder(index, n))
    return x.reshape(-1)[flat_idx.reshape(-1)].reshape(index.shape)


def polygamma(x, n, name=None):
    order = int(n)
    if order < 0:
        raise ValueError(f"polygamma order must be >= 0, got {order}")
    return apply(_special(lambda v: torch.special.polygamma(order, v)),
                 ensure_tensor(x), op_name="polygamma")


def igamma(x, y, name=None):
    """Regularized upper incomplete gamma Q(x, y) (paddle.igamma)."""
    x = ensure_tensor(x)
    return _special(torch.special.gammaincc)(x, ensure_tensor(y, like=x))


def igammac(x, y, name=None):
    """Regularized lower incomplete gamma P(x, y) (paddle.igammac)."""
    x = ensure_tensor(x)
    return _special(torch.special.gammainc)(x, ensure_tensor(y, like=x))


gammaln = _unary(_special(torch.special.gammaln), "gammaln")
gammainc = igammac  # paddle.gammainc(x, y) = P(x, y)
gammaincc = igamma
i0e = _unary(_special(torch.special.i0e), "i0e")
i1e = _unary(_special(torch.special.i1e), "i1e")


def multigammaln(x, p, name=None):
    """Log of the multivariate gamma function."""
    order = int(p)

    def fn(v):
        acc = torch.full_like(v, 0.25 * order * (order - 1)
                              * float(torch.log(torch.tensor(torch.pi))))
        for i in range(order):
            acc = acc + torch.special.gammaln(v - 0.5 * i)
        return acc

    return apply(_special(fn), ensure_tensor(x), op_name="multigammaln")


isposinf = _unary(torch.isposinf, "isposinf")
isneginf = _unary(torch.isneginf, "isneginf")
isreal = _unary(torch.isreal, "isreal")


def frexp(x, name=None):
    """(mantissa, exponent), the exponent in the input's dtype."""
    m, e = torch.frexp(ensure_tensor(x))
    return m, e.to(m.dtype)


def combinations(x, r=2, with_replacement=False, name=None):
    """All r-combinations of a 1-D tensor's elements, in itertools'
    order."""
    xt = ensure_tensor(x)
    if xt.ndim != 1:
        raise ValueError("combinations expects a 1-D tensor")
    picker = (itertools.combinations_with_replacement if with_replacement
              else itertools.combinations)
    idx = list(picker(range(xt.shape[0]), int(r)))
    if not idx:
        return xt.new_zeros((0, int(r)))
    return xt[torch.tensor(idx, dtype=torch.long, device=xt.device)]


def cumulative_trapezoid(y, x=None, dx=None, axis=-1, name=None):
    yt = ensure_tensor(y)
    if yt.dtype in _HALF:
        out = cumulative_trapezoid(yt.float(), None if x is None else
                                   ensure_tensor(x, like=yt).float(), dx,
                                   axis)
        return out.to(yt.dtype)
    if x is not None:
        return torch.cumulative_trapezoid(yt, ensure_tensor(x, like=yt),
                                          dim=axis)
    return torch.cumulative_trapezoid(yt, dx=1.0 if dx is None else dx,
                                      dim=axis)


__all__ = [
    n for n, v in list(globals().items())
    if not n.startswith("_") and callable(v)
    and getattr(v, "__module__", None) == __name__
]
