"""Linear algebra (the reference's ``paddle_tpu/tensor/linalg.py``) on
torch, exposed as ``paddle_tpu_torch.linalg``. The reference computes the
decompositions with ``jnp.linalg`` outside any Pallas kernel; their
counterparts here are ``torch.linalg``'s. Products of bf16 / fp16 inputs
accumulate in f32 and round once, as the reference asks of the MXU
(``preferred_element_type``)."""
from __future__ import annotations

import torch

from .._later import not_ported
from ..core.tensor import Tensor  # noqa: F401  (the reference namespace has it)
from ._helpers import apply, ensure_tensor

__all__ = [
    "matmul", "mm", "bmm", "dot", "t", "transpose_last", "norm", "dist",
    "cross", "cholesky", "inv", "pinv", "det", "slogdet", "solve",
    "triangular_solve", "cholesky_solve", "svd", "qr", "eig", "eigh",
    "eigvals", "eigvalsh", "matrix_power", "matrix_rank", "mv",
    "histogram", "bincount", "corrcoef", "cov", "lstsq", "lu", "multi_dot",
    "einsum", "cond", "lu_unpack", "householder_product", "matrix_exp",
    "inverse", "cdist", "cholesky_fn", "to_jax_dtype",
]

# JAX-only names of the reference's namespace: a jnp dtype converter and
# the jnp-level Cholesky closure
to_jax_dtype = not_ported("linalg.to_jax_dtype", "A9 (JAX-only; use "
                          "core.dtype.to_torch_dtype)")
cholesky_fn = not_ported("linalg.cholesky_fn", "A9 (JAX-only; use "
                         "linalg.cholesky)")


def _pair(x, y):
    x = ensure_tensor(x)
    return x, ensure_tensor(y, like=x)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    x, y = _pair(x, y)

    def fn(a, b):
        if transpose_x and a.ndim >= 2:
            a = a.transpose(-1, -2)
        if transpose_y and b.ndim >= 2:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)

    return apply(fn, x, y, op_name="matmul")


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return apply(torch.mv, *_pair(x, vec), op_name="mv")


def dot(x, y, name=None):
    x, y = _pair(x, y)
    return torch.sum(x * y, dim=-1)


def t(input, name=None):
    x = ensure_tensor(input)
    if x.ndim > 2:
        raise ValueError("paddle.t expects ndim <= 2")
    return x.t() if x.ndim == 2 else x


def transpose_last(x):
    return ensure_tensor(x).transpose(-1, -2)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    x = ensure_tensor(x)
    if p is None:
        p = "fro" if (axis is None or isinstance(axis, (list, tuple))) else 2
    if axis is None:
        flat = x.reshape(-1)
        if p in ("fro", 2):
            return torch.sqrt(torch.sum(flat * flat))
        if p == float("inf"):
            return torch.amax(flat.abs())
        if p == float("-inf"):
            return torch.amin(flat.abs())
        if p == 0:
            return torch.sum((flat != 0).to(x.dtype))
        if p == 1:
            return torch.sum(flat.abs())
        return torch.pow(torch.sum(torch.pow(flat.abs(), p)), 1.0 / p)
    ax = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    if p == "fro":
        return torch.sqrt(torch.sum(x * x, dim=ax, keepdim=keepdim))
    if isinstance(ax, tuple):
        return torch.linalg.matrix_norm(x, ord=p, dim=ax, keepdim=keepdim)
    return torch.linalg.vector_norm(x, ord=p, dim=ax, keepdim=keepdim)


def dist(x, y, p=2, name=None):
    x, y = _pair(x, y)
    return norm(x - y, p=p)


def cross(x, y, axis=9, name=None):
    x, y = _pair(x, y)
    ax = axis
    if ax == 9:  # paddle's default: the first axis of size 3
        ax = next(i for i, s in enumerate(x.shape) if s == 3)
    return torch.linalg.cross(x, y, dim=ax)


def cholesky(x, upper=False, name=None):
    return torch.linalg.cholesky(ensure_tensor(x), upper=upper)


def inv(x, name=None):
    return torch.linalg.inv(ensure_tensor(x))


def det(x, name=None):
    return torch.linalg.det(ensure_tensor(x))


def slogdet(x, name=None):
    sign, logabs = torch.linalg.slogdet(ensure_tensor(x))
    return sign, logabs


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return torch.linalg.pinv(ensure_tensor(x), rtol=rcond,
                             hermitian=hermitian)


def solve(x, y, name=None):
    return torch.linalg.solve(*_pair(x, y))


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    a, b = _pair(x, y)
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


def cholesky_solve(x, y, upper=False, name=None):
    b, factor = _pair(x, y)
    return torch.cholesky_solve(b, factor, upper=upper)


def svd(x, full_matrices=False, name=None):
    u, s, vh = torch.linalg.svd(ensure_tensor(x),
                                full_matrices=full_matrices)
    return u, s, vh


def qr(x, mode="reduced", name=None):
    out = torch.linalg.qr(ensure_tensor(x), mode=mode)
    return out.R if mode == "r" else (out.Q, out.R)


def eig(x, name=None):
    w, v = torch.linalg.eig(ensure_tensor(x))
    return w, v


def eigh(x, UPLO="L", name=None):
    w, v = torch.linalg.eigh(ensure_tensor(x), UPLO=UPLO)
    return w, v


def eigvals(x, name=None):
    return torch.linalg.eigvals(ensure_tensor(x))


def eigvalsh(x, UPLO="L", name=None):
    return torch.linalg.eigvalsh(ensure_tensor(x), UPLO=UPLO)


def matrix_power(x, n, name=None):
    return torch.linalg.matrix_power(ensure_tensor(x), n)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return torch.linalg.matrix_rank(ensure_tensor(x), rtol=tol,
                                    hermitian=hermitian)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    """Counts over ``bins`` equal bins of [min, max] (the data's range when
    both are 0); int64 counts unless weighted or ``density``."""
    x = ensure_tensor(input)
    lo, hi = float(min), float(max)
    if lo == 0 and hi == 0:
        lo, hi = float(x.min()), float(x.max())
    v = x.reshape(-1).float()
    if weight is None and not density:
        return torch.histc(v, bins=bins, min=lo, max=hi).to(torch.int64)
    w = None if weight is None else ensure_tensor(weight, like=x).reshape(-1)
    h, _ = torch.histogram(v.cpu(), bins=bins, range=(lo, hi),
                           weight=None if w is None else w.float().cpu(),
                           density=density)
    return h.to(x.device)


def bincount(x, weights=None, minlength=0, name=None):
    x = ensure_tensor(x)
    w = None if weights is None else ensure_tensor(weights, like=x)
    return torch.bincount(x.reshape(-1), None if w is None
                          else w.reshape(-1), minlength=minlength)


def corrcoef(x, rowvar=True, name=None):
    x = ensure_tensor(x)
    return torch.corrcoef(x if rowvar else x.t())


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    x = ensure_tensor(x)
    return torch.cov(x if rowvar else x.t(), correction=1 if ddof else 0)


def lstsq(x, y, rcond=None, driver=None, name=None):
    a, b = _pair(x, y)
    # gelsd (SVD: the reference's jnp.linalg.lstsq) on the CPU; CUDA has
    # only gels
    driver = driver or ("gelsd" if a.device.type == "cpu" else "gels")
    out = torch.linalg.lstsq(a, b, rcond=rcond, driver=driver)
    return out.solution, out.residuals, out.rank, out.singular_values


def lu(x, pivot=True, get_infos=False, name=None):
    """(packed LU, 1-based int32 pivots), as the reference returns."""
    x = ensure_tensor(x)
    lu_, piv = torch.linalg.lu_factor(x, pivot=pivot)
    piv = piv.to(torch.int32)
    if get_infos:
        return lu_, piv, torch.zeros((), dtype=torch.int32, device=x.device)
    return lu_, piv


def multi_dot(x, name=None):
    return torch.linalg.multi_dot([ensure_tensor(t) for t in x])


def einsum(equation, *operands):
    return torch.einsum(equation, *[ensure_tensor(t) for t in operands])


def cond(x, p=None, name=None):
    return torch.linalg.cond(ensure_tensor(x), p=2 if p is None else p)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(packed LU, pivots) -> (P, L, U); a flag off leaves its outputs
    None."""
    lu_, piv = _pair(x, y)
    P, L, U = torch.lu_unpack(lu_, piv.to(torch.int32),
                              unpack_data=unpack_ludata,
                              unpack_pivots=unpack_pivots)
    return (P if unpack_pivots else None,
            L if unpack_ludata else None, U if unpack_ludata else None)


def householder_product(x, tau, name=None):
    return torch.linalg.householder_product(*_pair(x, tau))


def matrix_exp(x, name=None):
    return torch.linalg.matrix_exp(ensure_tensor(x))


def inverse(x, name=None):
    return inv(x)


def cdist(x, y, p=2.0, compute_mode="use_mm_for_euclid_dist_if_necessary",
          name=None):
    """Pairwise p-norm distances of row batches: (..., P, M) and (..., R,
    M) -> (..., P, R); p = 2 by the reference's product form, |a|^2 +
    |b|^2 - 2ab, unless ``compute_mode`` forbids it. 16-bit inputs compute
    in f32 (the product form cancels) and round once."""
    a, b = _pair(x, y)
    if a.dtype in (torch.float16, torch.bfloat16):
        return cdist(a.float(), b.float(), p, compute_mode).to(a.dtype)
    if p == 2.0 and compute_mode != "donot_use_mm_for_euclid_dist":
        a2 = torch.sum(a * a, dim=-1, keepdim=True)
        b2 = torch.sum(b * b, dim=-1)[..., None, :]
        ab = torch.matmul(a, b.transpose(-1, -2))
        return torch.sqrt(torch.clamp(a2 + b2 - 2.0 * ab, min=0.0))
    diff = (a[..., :, None, :] - b[..., None, :, :]).abs()
    if p == 0.0:
        return torch.sum((diff != 0).to(a.dtype), dim=-1)
    if p == float("inf"):
        return torch.amax(diff, dim=-1)
    return torch.pow(torch.sum(torch.pow(diff, p), dim=-1), 1.0 / p)
