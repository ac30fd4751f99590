"""The launch plan of the RMSNorm backward kernel K6
(``paddle_tpu_torch.ops.rms_norm.BwdPlan``) and a plain rehearsal of the
order in which its kernels (``csrc/rms_norm.cu``) sum, on the CPU.

The plan tests walk every CTA as the kernels do: the row CTAs' row ranges
cover every row exactly once, each thread's columns cover the width
exactly once, and the reduction reads every partial row once for each
column.

The rehearsal repeats the kernels' arithmetic order in numpy f32 (a fused
multiply-add as one rounding of the exact f64 value): each thread sums
g·x over its columns in the plan's order, a warp adds its lanes by
butterfly, the CTA adds its warp sums in warp order; each row CTA adds
dy·x·r over its rows in row order into one partial row; the reduction's
warp ``k`` adds the partial rows ``k, k + 16, ...`` and the warp sums meet
in the plan's pairwise tree. It is held to the JAX package's Pallas
backward ``_rms_bwd`` (interpret mode off the TPU, as
tests/test_torch_backward.py runs it) and to ``rms_norm_bwd_plain``
within f32 ``2e-4`` of each output's largest value (``GTOL`` of
tests/test_pallas_kernels.py: the sums run in other orders).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.rms_norm import _rms_bwd, _rms_fwd

# the module (the ops package re-exports the function over its name)
R = importlib.import_module("paddle_tpu_torch.ops.rms_norm")

H100_SMS = 132
RTOL_OF_MAX = 2e-4
WIDTHS = [64, 100, 2048, 4096, 5120, 8192]
f32 = np.float32


# ---------------------------------------------------------------- plan
@pytest.mark.parametrize("rows", [1, 2, 7, 100, 263, 264, 265, 4096, 5000])
@pytest.mark.parametrize("num_sms", [H100_SMS, 3])
def test_row_ranges_cover_every_row_once(rows, num_sms):
    for elem, n in ((2, 4096), (4, 4096), (2, 100), (2, 8192)):
        plan = R.bwd_plan(rows, n, elem, True, num_sms)
        assert 1 <= plan.ctas <= min(rows, num_sms * plan.per_sm)
        seen = np.zeros(rows, np.int64)
        for b in range(plan.ctas):
            lo, hi = plan.row_range(b)
            assert hi > lo, "a row CTA without a row"
            seen[lo:hi] += 1
        assert (seen == 1).all()
        sizes = [np.subtract(*plan.row_range(b))
                 for b in range(plan.ctas)]
        assert max(sizes) - min(sizes) <= 1    # balanced


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("n", WIDTHS + [8, 3072, 4104, 16384, 20000])
@pytest.mark.parametrize("aligned", [True, False])
def test_threads_cover_every_column_once(elem, n, aligned):
    plan = R.bwd_plan(64, n, elem, aligned, H100_SMS)
    vec = 16 // elem
    assert plan.threads % 32 == 0 and 32 <= plan.threads \
        <= R.BWD_MAX_THREADS
    if plan.vpt:
        assert aligned and n % vec == 0
        assert plan.vpt in R.BWD_VPT
        assert plan.nvec <= plan.threads * plan.vpt
        # the least VPT that covers the width, and no warp without a vector
        assert plan.nvec > R.BWD_MAX_THREADS * (plan.vpt // 2)
        assert plan.nvec > plan.threads - 32
        assert plan.vpt * vec <= R.BWD_MAX_ELEMS
        assert plan.ring_bytes * plan.per_sm <= R.BWD_SMEM_PER_SM
    else:
        assert not aligned or n % vec or \
            n > R.BWD_MAX_THREADS * R.BWD_MAX_ELEMS
    seen = np.zeros(n, np.int64)
    for t in range(plan.threads):
        cols = plan.thread_columns(t)
        assert cols == sorted(cols)
        seen[cols] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("elem,n,vpt,threads,per_sm", [
    (2, 2048, 1, 256, 2), (2, 4096, 2, 256, 2), (2, 5120, 4, 160, 1),
    (2, 8192, 4, 256, 1), (4, 2048, 2, 256, 2), (4, 4096, 4, 256, 2),
    (4, 5120, 8, 160, 1), (4, 8192, 8, 256, 1),
])
def test_llama_widths_stay_in_registers(elem, n, vpt, threads, per_sm):
    """The Llama widths (941M 2,048; 7B 4,096; 13B 5,120; 70B 8,192) take
    the vector path at 16 rows a CTA or fewer on the H100's 132 SMs."""
    plan = R.bwd_plan(4096, n, elem, True, H100_SMS)
    assert (plan.vpt, plan.threads, plan.per_sm) == (vpt, threads, per_sm)
    assert plan.ctas == H100_SMS * per_sm


@pytest.mark.parametrize("nparts", [1, 5, 16, 17, 132, 264])
def test_reduction_reads_every_partial_once(nparts):
    warps = [[p for p in range(nparts) if R.BwdPlan.red_warp(p) == k]
             for k in range(R.RED_WARPS)]
    assert sorted(sum(warps, [])) == list(range(nparts))
    # the tree folds every warp's sum into warp 0 exactly once
    held = {k: {k} for k in range(R.RED_WARPS)}
    for level in R.BwdPlan.red_tree():
        for k, other in level:
            held[k] |= held.pop(other)
    assert held == {0: set(range(R.RED_WARPS))}
    plan = R.bwd_plan(nparts, 4096, 2, True, H100_SMS)
    assert plan.red_ctas * R.RED_COLS >= 4096


def test_plan_refuses_empty_shapes():
    with pytest.raises(ValueError):
        R.bwd_plan(0, 64, 4, True, H100_SMS)
    with pytest.raises(ValueError):
        R.bwd_plan(4, 0, 4, True, H100_SMS)


# ----------------------------------------------------------- rehearsal
def _fma(a, b, c):
    return (a.astype(np.float64) * b + c).astype(f32)


def kernel_model(plan, x, w, r, dy):
    """dx and dw as K6's kernels sum them, in numpy f32."""
    rows, n = x.shape
    cols = [plan.thread_columns(t) for t in range(plan.threads)]
    width = max(len(c) for c in cols)
    own = np.full((plan.threads, width), -1)
    for t, c in enumerate(cols):
        own[t, :len(c)] = c
    a = (dy * w).astype(f32)                     # dv * wv
    gx = np.zeros((rows, plan.threads), f32)
    for e in range(width):
        live = own[:, e] >= 0
        c = own[live, e]
        gx[:, live] = _fma(a[:, c], x[:, c], gx[:, live])
    gx = gx.reshape(rows, plan.threads // 32, 32)
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        gx = (gx + gx[..., lane ^ o]).astype(f32)
    tot = np.zeros(rows, f32)
    for k in range(plan.threads // 32):
        tot = (tot + gx[:, k, 0]).astype(f32)
    inv_n = f32(1) / f32(n)
    cf = ((r * r).astype(f32) * r).astype(f32)
    cf = ((cf * tot).astype(f32) * inv_n).astype(f32)
    dx = _fma(a, r[:, None], -(x * cf[:, None]).astype(f32))

    part = np.zeros((plan.ctas, n), f32)
    dyx = (dy * x).astype(f32)
    for b in range(plan.ctas):
        for row in range(*plan.row_range(b)):
            part[b] = _fma(dyx[row], r[row], part[b])
    sums = np.zeros((R.RED_WARPS, n), f32)
    for p in range(plan.ctas):
        k = R.BwdPlan.red_warp(p)
        sums[k] = (sums[k] + part[p]).astype(f32)
    for level in R.BwdPlan.red_tree():
        for k, other in level:
            sums[k] = (sums[k] + sums[other]).astype(f32)
    return dx, sums[0]


def _inputs(rows, n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(rows, n).astype(f32)
    w = rng.randn(n).astype(f32)
    dy = rng.randn(rows, n).astype(f32)
    return x, w, dy


def _assert_close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=RTOL_OF_MAX * scale)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("path", ["vector", "general"])
def test_kernel_order_matches_pallas_and_plain(n, path):
    # 40 rows over 18 SMs: 36 (or 18) CTAs of one to three rows, so the
    # reduction's warps hold one to three partials each
    rows = 40
    plan = R.bwd_plan(rows, n, 4, path == "vector", 18)
    assert bool(plan.vpt) == (path == "vector")
    x, w, dy = _inputs(rows, n, seed=n)
    _, r = _rms_fwd(jnp.asarray(x), jnp.asarray(w), 1e-6, 8)
    r = np.array(r, f32).reshape(rows)
    dx, dw = kernel_model(plan, x, w, r, dy)
    ref_dx, ref_dw = _rms_bwd(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(r).reshape(rows, 1),
                              jnp.asarray(dy), 8)
    _assert_close(dx, np.asarray(ref_dx))
    _assert_close(dw, np.asarray(ref_dw).reshape(n))
    plain_dx, plain_dw = R.rms_norm_bwd_plain(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(r),
        torch.from_numpy(dy))
    _assert_close(dx, plain_dx.numpy())
    _assert_close(dw, plain_dw.numpy())


@pytest.mark.parametrize("n", [100, 4096])
def test_kernel_order_gives_the_same_bits_twice(n):
    rows = 300
    plan = R.bwd_plan(rows, n, 4, True, H100_SMS)
    x, w, dy = _inputs(rows, n, seed=7)
    r = (1 / np.sqrt((x.astype(np.float64) ** 2).mean(-1) + 1e-6)).astype(f32)
    first = kernel_model(plan, x, w, r, dy)
    second = kernel_model(plan, x, w, r, dy)
    for a, b in zip(first, second):
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
