"""A CPU rehearsal of the f32 attention forward tile loop (dense K4 and
varlen K3 in f32, ``csrc/flash_f32.cuh``): 3xTF32 products in the
kernels' order, held against paddle_tpu's Pallas forwards
(``flash_attention``, ``varlen_flash_attention``; interpret mode on the
CPU, as the reference's own tests run them).

The emulation repeats, in numpy f32, what one CTA does on the card for a
64-row query tile: it walks the key range its rows can see (K4:
``key_range`` from positions; K3: ``VarlenBwdSchedule.key_range``, the
same ``key_range_of``) in 64-key tiles from the range's first key, skips
a tile with no live pair, and per tile computes S = Q K^T and O += P V as
3xTF32 products (``tf32x3_numpy.mma``), masks dead pairs to -inf, and
runs the online softmax in f32 (running max m and sum l, the accumulator
rescaled by exp2((m - m_new) log2 e), P = exp2(s scale log2 e - m log2
e)). The output is O / l and the log-sum-exp m + log l; a row with no
live key gives zeros and lse about -1e30.

Tolerances: out within 2e-5 of the reference (the port's CPU f32
tolerance), lse within 1e-5 of the log-sum-exp of the live scaled scores
in f64. A case with one TF32 product (big b_big alone) misses the out
tolerance, so the split is what keeps f32 results.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from paddle_tpu.ops.pallas.varlen_flash_attention import (
    varlen_flash_attention as jax_varlen,
)
from paddle_tpu_torch.ops.flash_attention import band_mask
from paddle_tpu_torch.ops.varlen_flash_attention import (VarlenBwdSchedule,
                                                         segment_mask)
from tf32x3_numpy import F32, mma

OUT = dict(rtol=2e-5, atol=2e-5)
LSE = dict(rtol=1e-5, atol=1e-5)
TILE = 64  # query rows per CTA and keys per tile (flash_f32.cuh)
LOG2E = F32(1.4426950408889634)


def attend(q, k, v, lo, hi, live, scale, terms=3):
    """One CTA: q (64, D) its rows, k / v (Tk, D) the keys of its head,
    keys [lo, hi) walked in 64-key tiles, live (64, Tk) its live pairs.
    Returns (out (64, D), lse (64,))."""
    d = q.shape[1]
    m = np.full(TILE, -1e30, F32)
    l = np.zeros(TILE, F32)
    o = np.zeros((TILE, d), F32)
    sl = F32(scale) * LOG2E
    for k0 in range(lo, hi, TILE):
        keys = np.arange(k0, k0 + TILE)
        ok = keys < hi
        lv = np.zeros((TILE, TILE), bool)
        lv[:, ok] = live[:, keys[ok]]
        if not lv.any():
            continue  # a dead tile: no K/V byte read
        kt = np.zeros((TILE, d), F32)
        vt = np.zeros((TILE, d), F32)
        kt[ok], vt[ok] = k[keys[ok]], v[keys[ok]]
        s = mma(np.zeros((TILE, TILE), F32), q, kt.T.copy(), terms)
        s = np.where(lv, s, F32(-np.inf))
        m_new = np.maximum(m, s.max(1) * F32(scale)).astype(F32)
        with np.errstate(over="ignore", invalid="ignore"):
            alpha = np.exp2((m - m_new) * LOG2E).astype(F32)
            # fmaf(s, scale log2 e, -m log2 e): one rounding
            arg = (s.astype(np.float64) * sl
                   - (m_new * LOG2E).astype(np.float64)[:, None])
            p = np.where(lv, np.exp2(arg.astype(F32)), F32(0)).astype(F32)
        l = (alpha * l + p.sum(1, dtype=F32)).astype(F32)
        m = m_new
        o = (o * alpha[:, None]).astype(F32)
        o = mma(o, p, vt, terms)
    lc = np.maximum(l, F32(1e-30))
    return (o / lc[:, None]).astype(F32), (m + np.log(lc)).astype(F32)


def _rows(x, r0, n):
    """Rows r0 .. r0 + 63 of x, zero past n."""
    out = np.zeros((TILE,) + x.shape[1:], x.dtype)
    m = max(0, min(TILE, n - r0))
    out[:m] = x[r0:r0 + m]
    return out


def _lse64(q, k, live, scale):
    """log-sum-exp of the live scaled scores in f64 (rows (Tq,), heads
    shared); -inf where a row sees no key."""
    s = np.einsum("qd,kd->qk", q.astype(np.float64),
                  k.astype(np.float64)) * scale
    s = np.where(live, s, -np.inf)
    mx = s.max(1)
    fin = np.isfinite(mx)
    out = np.full(s.shape[0], -np.inf)
    out[fin] = mx[fin] + np.log(np.exp(s[fin] - mx[fin, None]).sum(1))
    return out


# ------------------------------------------------------------------ dense
def dense_key_range(sq, sk, q0, causal, window):
    """flash_mma.cuh ``key_range`` for the 64 rows from q0."""
    lo, hi = 0, sk
    if causal:
        hi = min(hi, min(q0 + TILE, sq) - 1 + (sk - sq) + 1)
        if window:
            lo = max(0, q0 + (sk - sq) - window + 1)
    return lo, hi


def fwd_dense(q, k, v, causal, window, terms=3):
    """The dense f32 kernel K4: every (batch, head, 64-row query tile)."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    scale = 1.0 / np.sqrt(d)
    mask = band_mask(sq, sk, causal, window).numpy()
    out = np.zeros_like(q)
    lse = np.zeros((b, h, sq), F32)
    for bi in range(b):
        for head in range(h):
            kvh = head // (h // hk)
            for q0 in range(0, sq, TILE):
                n = min(TILE, sq - q0)
                lo, hi = dense_key_range(sq, sk, q0, causal, window)
                o, ls = attend(_rows(q[bi, :, head], q0, sq),
                               k[bi, :, kvh], v[bi, :, kvh], lo, hi,
                               _rows(mask, q0, sq).astype(bool), scale,
                               terms)
                out[bi, q0:q0 + n, head] = o[:n]
                lse[bi, head, q0:q0 + n] = ls[:n]
    return out, lse


# (B, Sq, Sk, H, HK, causal, window, D)
DENSE = {
    "causal_d64": (2, 130, 130, 2, 2, True, None, 64),
    "noncausal_d128": (1, 100, 100, 2, 2, False, None, 128),
    "window_d64": (1, 200, 200, 4, 2, True, 48, 64),
    "gqa4_d128": (1, 160, 160, 4, 1, True, None, 128),
    "bottom_right_sq_lt_sk": (1, 64, 192, 2, 1, True, None, 128),
    "rows_without_keys_sq_gt_sk": (1, 150, 70, 2, 2, True, None, 64),
    "noncausal_sq_ne_sk": (1, 96, 200, 4, 2, False, None, 64),
}


def _dense_case(name, seed=0):
    b, sq, sk, h, hk, causal, window, d = DENSE[name]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(F32)
    k = rng.randn(b, sk, hk, d).astype(F32)
    v = rng.randn(b, sk, hk, d).astype(F32)
    want = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window_size=window))
    return (q, k, v, causal, window), want


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_3xtf32_forward_matches_pallas(name):
    (q, k, v, causal, window), want = _dense_case(name)
    out, lse = fwd_dense(q, k, v, causal, window)
    np.testing.assert_allclose(out, want, **OUT)
    b, sq, h, d = q.shape
    mask = band_mask(sq, k.shape[1], causal, window).numpy()
    for bi in range(b):
        for head in range(h):
            kvh = head // (h // k.shape[2])
            ref = _lse64(q[bi, :, head], k[bi, :, kvh], mask,
                         1.0 / np.sqrt(d))
            seen = np.isfinite(ref)
            np.testing.assert_allclose(lse[bi, head, seen], ref[seen], **LSE)
            assert (lse[bi, head, ~seen] < -1e29).all()
            assert (out[bi, ~seen, head] == 0).all()


# ----------------------------------------------------------------- varlen
def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def fwd_varlen(q, k, v, cu_q, cu_k, causal, window, terms=3):
    """The varlen f32 kernel K3: every (head, 64-row query tile); rows at
    or past cu_q[-1] are padding and give zeros."""
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    scale = 1.0 / np.sqrt(d)
    mask = segment_mask(torch.from_numpy(cu_q), torch.from_numpy(cu_k), tq,
                        tk, causal, window).numpy()
    sched = VarlenBwdSchedule(cu_q, cu_k, tq, tk, h, hk, causal, window, d)
    out = np.zeros_like(q)
    lse = np.full((h, tq), -1e30, F32)
    for i in range(-(-tq // TILE)):
        q0 = i * TILE
        n = min(TILE, tq - q0)
        lo, hi = sched.key_range(i) if q0 < sched.qend else (0, 0)
        for head in range(h):
            kvh = head // (h // hk)
            o, ls = attend(_rows(q[:, head], q0, tq), k[:, kvh], v[:, kvh],
                           lo, hi, _rows(mask, q0, tq).astype(bool), scale,
                           terms)
            out[q0:q0 + n, head] = o[:n]
            lse[head, q0:q0 + n] = ls[:n]
    return out, lse


# (lens_q, lens_k or None for the same, H, HK, D, causal, window, pad)
VARLEN = {
    "ragged_gqa": ([13, 37, 1, 77], None, 4, 2, 64, True, None, 0),
    "noncausal": ([13, 37, 1, 77], None, 4, 2, 64, False, None, 0),
    "cross_lengths": ([9, 25, 70], [17, 25, 91], 4, 4, 64, True, None, 0),
    # a 10-token segment across the first tile edge, a window
    "short_across_tile_edge_window": ([60, 10, 90, 30], None, 4, 2, 64,
                                      True, 16, 0),
    "empty_segments_d128": ([20, 0, 33, 0, 11], None, 4, 1, 128, True,
                            None, 0),
    "gqa4_d128_window": ([100, 60, 40], None, 4, 1, 128, True, 32, 0),
    # rows with no key (a query segment over an empty key segment), and
    # padding rows past cu_q[-1]
    "rows_without_keys_padding": ([6, 10, 12], [9, 0, 4], 4, 2, 64, True,
                                  None, 5),
}


def _varlen_case(name, seed=0):
    lens_q, lens_k, h, hk, d, causal, window, pad = VARLEN[name]
    cu_q = _cu(lens_q)
    cu_k = cu_q if lens_k is None else _cu(lens_k)
    tq, tk = int(cu_q[-1]) + pad, int(cu_k[-1])
    rng = np.random.RandomState(seed)
    q = rng.randn(tq, h, d).astype(F32)
    k = rng.randn(tk, hk, d).astype(F32)
    v = rng.randn(tk, hk, d).astype(F32)
    want = np.asarray(jax_varlen(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu_q),
        jnp.asarray(cu_k), causal=causal, window_size=window))
    return (q, k, v, cu_q, cu_k, causal, window), want


@pytest.mark.parametrize("name", list(VARLEN))
def test_varlen_3xtf32_forward_matches_pallas(name):
    (q, k, v, cu_q, cu_k, causal, window), want = _varlen_case(name)
    out, lse = fwd_varlen(q, k, v, cu_q, cu_k, causal, window)
    real = int(cu_q[-1])
    np.testing.assert_allclose(out[:real], want[:real], **OUT)
    assert (out[real:] == 0).all()
    mask = segment_mask(torch.from_numpy(cu_q), torch.from_numpy(cu_k),
                        q.shape[0], k.shape[0], causal, window).numpy()
    h, hk = q.shape[1], k.shape[1]
    for head in range(h):
        ref = _lse64(q[:, head], k[:, head // (h // hk)], mask,
                     1.0 / np.sqrt(q.shape[2]))
        seen = np.isfinite(ref)
        np.testing.assert_allclose(lse[head, seen], ref[seen], **LSE)
        assert (lse[head, ~seen] < -1e29).all()
        assert (out[~seen, head] == 0).all()


# ------------------------------------------------------- why three terms
@pytest.mark.parametrize("name", ["causal_d64", "gqa4_d128"])
def test_one_tf32_product_misses_the_forward_tolerance(name):
    (q, k, v, causal, window), want = _dense_case(name)
    one, _ = fwd_dense(q, k, v, causal, window, terms=1)
    three, _ = fwd_dense(q, k, v, causal, window)
    err_one = float(np.abs(one - want).max())
    err_three = float(np.abs(three - want).max())
    assert err_one > OUT["atol"] * 4, err_one
    assert err_three * 10 < err_one, (err_three, err_one)


def test_one_tf32_product_misses_the_forward_tolerance_varlen():
    (q, k, v, cu_q, cu_k, causal, window), want = _varlen_case("ragged_gqa")
    one, _ = fwd_varlen(q, k, v, cu_q, cu_k, causal, window, terms=1)
    assert float(np.abs(one - want).max()) > OUT["atol"] * 4
