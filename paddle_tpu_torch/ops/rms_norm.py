"""RMSNorm forward and backward: the Hopper kernels K1 and K6, their plain
PyTorch versions, and the autograd Function that joins them.

Counterpart of ``paddle_tpu/ops/pallas/rms_norm.py``. Rows are all leading
dims flattened; the last axis is normalized. Math in f32:

    r  = rsqrt(mean(x^2) + eps)        y  = x * r * w
    g  = dy * w                        dx = g * r - x * r^3 * mean(g * x)
    dw = sum_rows(dy * x * r)

:class:`RMSNormFunction` mirrors the reference's ``custom_vjp``: the
forward saves x, w and the per-row r, the backward is K6 (its plain
version on CPU tensors). The CUDA source of both kernels is
``paddle_tpu_torch/csrc/rms_norm.cu``; K6 follows the host plan
:class:`BwdPlan`, which ``tests/test_torch_rms_norm_plan.py`` rehearses
on the CPU.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from . import _library as L
from . import split_decode as sd

__all__ = ["rms_norm", "rms_norm_plain", "rms_norm_bwd", "rms_norm_bwd_plain",
           "RMSNormFunction", "BwdPlan", "bwd_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K6's plan constants; csrc/rms_norm.cu holds the same (kBwd*, kRed*)
BWD_MAX_THREADS = 256           # threads of a row CTA, at most
BWD_VPT = (1, 2, 4, 8)          # 16-byte vectors a thread owns (instances)
BWD_MAX_ELEMS = 32              # elements of a row a thread holds, at most
BWD_STAGES = 2                  # rows a CTA's copy ring holds
BWD_SMEM_PER_SM = 227 * 1024    # shared memory of an SM's CTAs
BWD_REGS_PER_SM = 65536
CTAS_PER_SM = 2                 # row CTAs an SM holds, at most
RED_WARPS = 16                  # warps of a dw-reduction CTA
RED_COLS = 32                   # columns of a dw-reduction CTA (its lanes)


@dataclass(frozen=True)
class BwdPlan:
    """K6's launch plan (``csrc/rms_norm.cu`` follows it).

    Two launches. The row pass: ``ctas`` persistent CTAs of ``threads``
    threads; CTA ``b`` walks the contiguous rows :meth:`row_range`
    ``(b)`` one after another and writes one f32 row of dw partial sums,
    ``part[b]``. On the vector path (``vpt > 0``) thread ``t`` owns the
    16-byte column vectors ``j * threads + t`` for ``j < vpt`` (a warp's
    accesses coalesce), holds its slice of w and its dw sums in
    registers, and stages each row's x and dy through a ring of
    ``BWD_STAGES`` rows in shared memory, one row ahead of the one it
    works on. The general path (``vpt == 0``: a width that does
    not split into 16-byte vectors, or a misaligned tensor) gives thread
    ``t`` the columns ``t, t + threads, ...`` and keeps its dw sums in
    ``part[b]`` itself. Both sum g·x of a row per thread in column order,
    across a warp by butterfly, then the warp sums in warp order.

    The reduction: ``red_ctas`` CTAs of ``RED_WARPS`` warps, each taking
    ``RED_COLS`` columns, one a lane. Warp ``k`` sums the partial rows
    ``k, k + RED_WARPS, ...`` in order; the warp sums then meet in a
    fixed pairwise tree (:meth:`red_tree`). Nothing depends on which CTA
    runs when: dw is bit-equal across calls."""

    rows: int
    n: int
    vec: int        # elements of one 16-byte vector
    ctas: int
    threads: int
    vpt: int        # 0: the general path
    per_sm: int     # row CTAs an SM holds (the plan's assumption)

    @property
    def nvec(self):
        return self.n // self.vec

    @property
    def ring_bytes(self):
        """Shared memory of a row CTA on the vector path."""
        return BWD_STAGES * 2 * self.n * (16 // self.vec)

    @property
    def red_ctas(self):
        return -(-self.n // RED_COLS)

    def row_range(self, b):
        """Rows ``[lo, hi)`` of row CTA ``b``: a balanced split, every
        CTA at least one row."""
        return b * self.rows // self.ctas, (b + 1) * self.rows // self.ctas

    def thread_columns(self, t):
        """The columns thread ``t`` of a row CTA owns, in the order it
        sums them."""
        if not self.vpt:
            return list(range(t, self.n, self.threads))
        cols = []
        for j in range(self.vpt):
            c = j * self.threads + t
            if c < self.nvec:
                cols.extend(range(c * self.vec, (c + 1) * self.vec))
        return cols

    @staticmethod
    def red_warp(p):
        """The warp of a reduction CTA that sums partial row ``p``."""
        return p % RED_WARPS

    @staticmethod
    def red_tree():
        """The steps ``(k, k + h)`` of the warp sums' tree, in order: at
        each level ``h`` every warp ``k < h`` adds warp ``k + h``'s sum to
        its own; warp 0 holds the total."""
        steps, h = [], RED_WARPS // 2
        while h:
            steps.append([(k, k + h) for k in range(h)])
            h //= 2
        return steps


def bwd_plan(rows: int, n: int, elem_bytes: int, aligned: bool,
             num_sms: int) -> BwdPlan:
    """K6's plan for ``rows`` rows of width ``n`` (elements of
    ``elem_bytes`` bytes), ``aligned`` when x, w, dy and dx all start on
    16 bytes, on a card of ``num_sms`` SMs. A pure function."""
    if rows < 1 or n < 1:
        raise ValueError(f"rms_norm_bwd plan: rows {rows}, width {n}")
    vec = 16 // elem_bytes
    nvec = n // vec
    vpt = next((v for v in BWD_VPT if nvec <= BWD_MAX_THREADS * v
                and v * vec <= BWD_MAX_ELEMS), 0)
    if not aligned or n % vec:
        vpt = 0
    if vpt:
        threads = -(-nvec // (32 * vpt)) * 32
        # registers a thread holds: w, its dw sums and a row's x and g in
        # f32, and about 48 of its own; each of an SM's four schedulers
        # holds the registers of its warps
        regs = 4 * vpt * vec + 48
        warps = 4 * (BWD_REGS_PER_SM // 4 // (32 * regs))
        per_sm = min(CTAS_PER_SM, warps // (threads // 32),
                     BWD_SMEM_PER_SM // (BWD_STAGES * 2 * n * elem_bytes))
    else:
        threads, per_sm = BWD_MAX_THREADS, CTAS_PER_SM
    per_sm = max(per_sm, 1)
    return BwdPlan(rows, n, vec, min(rows, num_sms * per_sm), threads, vpt,
                   per_sm)


@functools.lru_cache(maxsize=1024)
def _plan_on(rows, n, elem_bytes, aligned, index):
    return bwd_plan(rows, n, elem_bytes, aligned, sd._sm_count(index))


def rms_norm_plain(x, weight, epsilon=1e-6):
    """Plain version of K1: returns ``(y, rstd)``, ``rstd`` shaped
    ``x.shape[:-1]`` in f32."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + epsilon)
    y = (xf * r * weight.float()).to(x.dtype)
    return y, r.squeeze(-1)


def _check(x, weight):
    if weight.dim() != 1 or x.shape[-1] != weight.shape[0]:
        raise ValueError(
            f"rms_norm: weight {tuple(weight.shape)} does not match the last "
            f"axis of x {tuple(x.shape)}")


def _check_kernel_inputs(name, x, weight, *others):
    if x.dtype not in _DTYPES or weight.dtype != x.dtype:
        raise TypeError(
            f"{name} kernel takes float32 or bfloat16 x with a weight of "
            f"the same dtype, got {x.dtype} and {weight.dtype}")
    if any(t.device != x.device for t in (weight, *others)):
        raise ValueError(f"{name}: inputs lie on different devices")
    if not all(t.is_contiguous() for t in (x, weight, *others)):
        raise ValueError(f"{name} kernel needs contiguous inputs")


def _rms_norm_cuda(x: torch.Tensor, weight: torch.Tensor,
                   epsilon: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 as a custom op: ``(y, rstd)``. On CUDA tensors it launches the
    kernel; on CPU tensors it is :func:`rms_norm_plain`."""
    _check_kernel_inputs("rms_norm", x, weight)
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    y = torch.empty_like(x)
    r = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    status = L.library().ptt_rms_norm(
        x.data_ptr(), weight.data_ptr(), y.data_ptr(), r.data_ptr(), rows,
        n, float(epsilon), _DTYPES[x.dtype], L.cuda_stream(x))
    L.check_status("rms_norm", status)
    L.LAUNCHES["rms_norm"] += 1
    return y, r


_rms_norm_op = L.custom_op("rms_norm", _rms_norm_cuda)


@_rms_norm_op.register_kernel("cpu")
def _(x, weight, epsilon):
    y, r = rms_norm_plain(x, weight, epsilon)
    return y.contiguous(), r.contiguous()


@_rms_norm_op.register_fake
def _(x, weight, epsilon):
    if x.device.type == "cuda":
        _check_kernel_inputs("rms_norm", x, weight)
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            x.new_empty(x.shape[:-1], dtype=torch.float32))


def rms_norm(x, weight, epsilon=1e-6, return_rstd=False):
    """RMSNorm over the last axis; ``x`` (..., N), ``weight`` (N,).

    Runs the custom op ``paddle_tpu_torch::rms_norm``: CUDA tensors
    launch the kernel, or raise on a dtype, shape or layout it does not
    take (also when traced); CPU tensors run :func:`rms_norm_plain`. With
    ``return_rstd`` also returns the per-row ``rsqrt(mean(x^2) + eps)``
    that the backward takes. The result carries no autograd history on
    the kernel path: differentiate through :class:`RMSNormFunction`."""
    _check(x, weight)
    how = L.route(x, weight)
    if how == "plain":
        y, r = rms_norm_plain(x, weight, epsilon)
    else:
        fn = (_rms_norm_cuda if how == "kernel"
              else torch.ops.paddle_tpu_torch.rms_norm.default)
        y, r = fn(x, weight, float(epsilon))
    return (y, r) if return_rstd else y


def rms_norm_bwd_plain(x, weight, rstd, dy):
    """Plain version of K6 (the reference's ``_bwd_kernel``) in f32:
    returns ``(dx, dw)``, dx in x's dtype, dw summed over every row in
    f32 and cast to the weight's dtype."""
    n = x.shape[-1]
    xf, dyf = x.float().reshape(-1, n), dy.float().reshape(-1, n)
    r = rstd.float().reshape(-1, 1)
    g = dyf * weight.float()
    mean_gx = (g * xf).mean(dim=-1, keepdim=True)
    dx = g * r - xf * (r * r * r) * mean_gx
    dw = (dyf * xf * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dw.to(weight.dtype)


def _check_bwd_kernel_inputs(x, weight, rstd, dy):
    _check_kernel_inputs("rms_norm_bwd", x, weight, dy, rstd)
    if dy.dtype != x.dtype or rstd.dtype != torch.float32:
        raise TypeError(
            f"rms_norm_bwd kernel takes dy in x's dtype and f32 rstd, got "
            f"{dy.dtype} and {rstd.dtype}")


def _rms_norm_bwd_cuda(x: torch.Tensor, weight: torch.Tensor,
                       rstd: torch.Tensor,
                       dy: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K6 as a custom op: ``(dx, dw)``. On CUDA tensors it launches the
    kernel as :func:`bwd_plan` plans it; on CPU tensors it is
    :func:`rms_norm_bwd_plain`."""
    _check_bwd_kernel_inputs(x, weight, rstd, dy)
    n = x.shape[-1]
    rows = x.numel() // n if n else 0
    dx = torch.empty_like(x)
    dw = torch.empty_like(weight)
    if rows == 0:
        return dx, dw.zero_()
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, weight, dy, dx))
    plan = _plan_on(rows, n, x.element_size(), aligned, x.device.index)
    part = torch.empty((plan.ctas, n), dtype=torch.float32, device=x.device)
    status = L.library().ptt_rms_norm_bwd(
        x.data_ptr(), weight.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dw.data_ptr(), rows, n, plan.ctas,
        plan.threads, plan.vpt, _DTYPES[x.dtype], L.cuda_stream(x))
    L.check_status("rms_norm_bwd", status)
    L.LAUNCHES["rms_norm_bwd"] += 1
    return dx, dw


_rms_norm_bwd_op = L.custom_op("rms_norm_bwd", _rms_norm_bwd_cuda)


@_rms_norm_bwd_op.register_kernel("cpu")
def _(x, weight, rstd, dy):
    dx, dw = rms_norm_bwd_plain(x, weight, rstd, dy)
    return dx.contiguous(), dw.contiguous()


@_rms_norm_bwd_op.register_fake
def _(x, weight, rstd, dy):
    if x.device.type == "cuda":
        _check_bwd_kernel_inputs(x, weight, rstd, dy)
    return (torch.empty_like(x, memory_format=torch.contiguous_format),
            torch.empty_like(weight, memory_format=torch.contiguous_format))


def rms_norm_bwd(x, weight, rstd, dy):
    """RMSNorm backward: ``(dx, dw)`` from x (..., N), weight (N,), the
    forward's ``rstd`` (x.shape[:-1], f32) and the upstream ``dy`` (like
    x). Runs the custom op ``paddle_tpu_torch::rms_norm_bwd``: CUDA
    tensors launch K6 as :func:`bwd_plan` plans it (a row pass writing dx
    and one dw partial row per CTA, then a fixed-order reduction of the
    partials: deterministic, no atomics) or raise; CPU tensors run
    :func:`rms_norm_bwd_plain`."""
    _check(x, weight)
    if dy.shape != x.shape or rstd.shape != x.shape[:-1]:
        raise ValueError(
            f"rms_norm_bwd: dy {tuple(dy.shape)} and rstd "
            f"{tuple(rstd.shape)} do not match x {tuple(x.shape)}")
    how = L.route(x, weight, rstd, dy)
    if how == "plain":
        return rms_norm_bwd_plain(x, weight, rstd, dy)
    fn = (_rms_norm_bwd_cuda if how == "kernel"
          else torch.ops.paddle_tpu_torch.rms_norm_bwd.default)
    return fn(x, weight, rstd, dy)


class RMSNormFunction(torch.autograd.Function):
    """``y = rms_norm(x, weight, epsilon)`` with K6 as its backward (the
    reference's ``_rms_norm_2d`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        y, r = rms_norm(x, weight, epsilon, return_rstd=True)
        ctx.save_for_backward(x, weight, r)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, r = ctx.saved_tensors
        dx, dw = rms_norm_bwd(x, weight, r, dy.contiguous().to(x.dtype))
        return dx, dw, None
