"""A CPU rehearsal of the fused f32 attention backward kernels' arithmetic
(dense K7 and varlen K8 in f32, ``csrc/bwd_f32.cuh``): 3xTF32 products in
the fused kernels' work order, held against ``jax.grad`` of paddle_tpu's
Pallas kernels (``_flash_bwd``, ``_varlen_bwd``; interpret mode on the
CPU, as the reference's own tests run them).

The emulation repeats, in numpy f32, what the kernels do on the card
(the 3xTF32 helpers are ``tf32x3_numpy.py``'s):

- TF32 rounding as ``cvt.rna.tf32.f32`` (round to nearest, ties away from
  zero, 10 mantissa bits kept), and each operand split into big =
  tf32(x) and small = x - big, exact in f32, whose low 13 bits the tensor
  core drops as it reads the operand (``trunc``);
- each product a chain of 8-wide reduction steps, each adding
  a_small b_big, a_big b_small and a_big b_big to an f32 accumulator in
  that order (``mma3``);
- the work order of ``BwdSchedule`` / ``VarlenBwdSchedule`` at the f32
  kernels' key tiles: each key tile walks its query tiles and heads,
  sums dk and dv in f32, and adds its dq partial into dq in the tile's
  fixed order (the first contributor stores, each later one adds).

Tolerance: each gradient within 1e-4 of its largest |g| (the card's
phase-8 check), absolute. A case with one TF32 product (big b_big alone)
misses that tolerance, so the split is what keeps f32 results.
"""
import jax
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
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops.flash_attention import (BwdSchedule, band_mask,
                                                  bwd_block_k)
from paddle_tpu_torch.ops.varlen_flash_attention import (VarlenBwdSchedule,
                                                         segment_mask)
from tf32x3_numpy import F32, mma, split, tf32, trunc

REL = 1e-4  # of each gradient's largest |g|


def _pad(x, axis, n):
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - x.shape[axis])
    return np.pad(x, pad)


def _step(kt, vt, qt, dot, lse, delta, live, scale, adk, adv, terms):
    """One step of a key tile's walk: P^T, dV, dP^T, dS^T, dK and the dq
    partial (``bwd_f32.cuh``); returns the partial."""
    bk, bq = live.shape
    st = mma(np.zeros((bk, bq), F32), kt, qt.T, terms)
    with np.errstate(over="ignore"):  # dead rows: lse ~ -1e30
        p = np.where(live, np.exp(st * F32(scale) - lse[None]), F32(0))
    mma(adv, p.astype(F32), dot, terms)
    dpt = mma(np.zeros((bk, bq), F32), vt, dot.T, terms)
    dst = (p * (dpt - delta[None]) * F32(scale)).astype(F32)
    mma(adk, dst, qt, terms)
    return mma(np.zeros((bq, kt.shape[1]), F32), dst.T.copy(), kt, terms)


def fused_dense(q, k, v, do, lse, delta, causal, window, terms=3):
    """The dense f32 kernel's arithmetic in BwdSchedule's order."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    g = h // hk
    scale = 1.0 / np.sqrt(d)
    s = BwdSchedule(b, sq, sk, h, hk, causal, window,
                    block_k=bwd_block_k(torch.float32, d))
    bq, bk = s.block_q, s.block_k
    nq, nk = s.n_q * bq, s.n_k * bk
    qp, dop = _pad(q, 1, nq), _pad(do, 1, nq)
    kp, vp = _pad(k, 1, nk), _pad(v, 1, nk)
    lp, dlp = _pad(lse, 2, nq), _pad(delta, 2, nq)
    mask = _pad(_pad(band_mask(sq, sk, causal, window).numpy(), 0, nq), 1,
                nk)
    dq = np.zeros((b, nq, h, d), F32)
    dk = np.zeros((b, nk, hk, d), F32)
    dv = np.zeros((b, nk, hk, d), F32)
    landed = {}  # (batch, head, query tile) -> adds landed (its counter)
    for ticket in range(s.n_items):
        j, bi, kvh = s.item(ticket)
        ks = slice(j * bk, (j + 1) * bk)
        adk = np.zeros((bk, d), F32)
        adv = np.zeros((bk, d), F32)
        for i, gi in s.walk(j):
            head = kvh * g + gi
            qs = slice(i * bq, (i + 1) * bq)
            part = _step(kp[bi, ks, kvh], vp[bi, ks, kvh], qp[bi, qs, head],
                         dop[bi, qs, head], lp[bi, head, qs],
                         dlp[bi, head, qs], mask[qs, ks].T, scale, adk, adv,
                         terms)
            # the kernel waits until the counter reaches its rank: the
            # ranks of a tile land 0, 1, ... in ticket order
            rank, n = s.rank(i, j)
            count = landed.get((bi, head, i), 0)
            assert rank == count < n, (i, j, rank, count)
            landed[(bi, head, i)] = count + 1
            tile = dq[bi, qs, head]
            if rank == 0:
                tile[...] = part
            else:
                tile += part
        dk[bi, ks, kvh] = adk
        dv[bi, ks, kvh] = adv
    # every contributor of every tile added
    for (bi, head, i), count in landed.items():
        assert count == s.rank(i, s.key_tiles(i)[0])[1]
    return dq[:, :sq], dk[:, :sk], dv[:, :sk]


def fused_varlen(q, k, v, do, lse, delta, cu_q, cu_k, causal, window,
                 terms=3):
    """The varlen f32 kernel's arithmetic in VarlenBwdSchedule's order."""
    tq, h, d = q.shape
    tk, hk = k.shape[0], k.shape[1]
    g = h // hk
    scale = 1.0 / np.sqrt(d)
    s = VarlenBwdSchedule(cu_q, cu_k, tq, tk, h, hk, causal, window, d=d)
    bq, bk = s.block_q, s.block_k
    nq, nk = s.n_q * bq, s.n_k * bk
    qp, dop = _pad(q, 0, nq), _pad(do, 0, nq)
    kp, vp = _pad(k, 0, nk), _pad(v, 0, nk)
    lp, dlp = _pad(lse, 1, nq), _pad(delta, 1, nq)
    mask = segment_mask(torch.from_numpy(cu_q), torch.from_numpy(cu_k), tq,
                        tk, causal, window).numpy()
    mask = _pad(_pad(mask, 0, nq), 1, nk)
    dq = np.zeros((nq, h, d), F32)
    dk = np.zeros((nk, hk, d), F32)
    dv = np.zeros((nk, hk, d), F32)
    last_add = {}  # (head, query tile) -> 1 + key tile of the last add
    for ticket in range(s.n_items):
        j, kvh = s.item(ticket)
        ks = slice(j * bk, (j + 1) * bk)
        adk = np.zeros((bk, d), F32)
        adv = np.zeros((bk, d), F32)
        for i, gi in s.walk(j):
            head = kvh * g + gi
            qs = slice(i * bq, (i + 1) * bq)
            part = _step(kp[ks, kvh], vp[ks, kvh], qp[qs, head],
                         dop[qs, head], lp[head, qs], dlp[head, qs],
                         mask[qs, ks].T, scale, adk, adv, terms)
            # the kernel waits until the counter holds 1 + prev
            prev, _ = s.order(i, j)
            assert last_add.get((head, i), 0) == prev + 1, (i, j, prev)
            last_add[(head, i)] = j + 1
            tile = dq[qs, head]
            if prev < 0:
                tile[...] = part
            else:
                tile += part
        dk[ks, kvh] = adk
        dv[ks, kvh] = adv
    for (head, i), last in last_add.items():
        assert last == s.contributors(i)[-1] + 1
    return dq[:tq], dk[:tk], dv[:tk]


def _worst(got, want):
    """The largest |got - want| of each gradient over its largest |want|."""
    return [float(np.abs(gg - w).max() / max(np.abs(w).max(), 1e-30))
            for gg, w in zip(got, want)]


# ------------------------------------------------------------------ dense
# (B, Sq, Sk, H, HK, causal, window, D)
DENSE = {
    "causal_d64": (2, 128, 128, 2, 2, True, None, 64),
    "noncausal_d64": (1, 100, 100, 2, 2, False, None, 64),
    "gqa4_d128": (1, 160, 160, 4, 1, True, None, 128),
    "window_d64": (1, 200, 200, 4, 2, True, 48, 64),
    "bottom_right_sq_lt_sk": (1, 64, 192, 2, 1, True, None, 128),
    "rows_without_keys_sq_gt_sk": (1, 150, 70, 2, 2, True, None, 64),
    "noncausal_sq_ne_sk_d128": (1, 96, 200, 4, 2, False, None, 128),
}


def _dense_inputs(b, sq, sk, h, hk, causal, window, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(F32)
    k = rng.randn(b, sk, hk, d).astype(F32)
    v = rng.randn(b, sk, hk, d).astype(F32)
    t = rng.randn(b, sq, h, d).astype(F32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_flash_attention(
            q, k, v, causal=causal, window_size=window) * t),
        (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, lse = ops.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal, window_size=window)
    delta = ops.flash_attention_bwd_delta(out, torch.from_numpy(t))
    return (q, k, v, t, lse.numpy(), delta.numpy()), [np.asarray(w)
                                                      for w in want]


@pytest.mark.parametrize("name", list(DENSE))
def test_dense_3xtf32_matches_pallas(name):
    b, sq, sk, h, hk, causal, window, d = DENSE[name]
    args, want = _dense_inputs(b, sq, sk, h, hk, causal, window, d)
    got = fused_dense(*args, causal, window)
    for x in got:
        assert np.isfinite(x).all()
    worst = _worst(got, want)
    assert max(worst) <= REL, (name, worst)


# ----------------------------------------------------------------- varlen
# (lens_q, lens_k or None for the same, H, HK, D, causal, window)
VARLEN = {
    "ragged_gqa": ([13, 37, 1, 77], None, 4, 2, 64, True, None),
    "noncausal": ([13, 37, 1, 77], None, 4, 2, 64, False, None),
    "cross_lengths": ([9, 25, 70], [17, 25, 91], 4, 4, 64, True, None),
    "window": ([50, 7, 90, 30], None, 4, 2, 64, True, 16),
    "empty_segment_d128": ([20, 0, 33, 0, 11], None, 4, 1, 128, True,
                           None),
    "gqa4_d128_window": ([100, 60, 40], None, 4, 1, 128, True, 32),
}


def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _varlen_inputs(lens_q, lens_k, h, hk, d, causal, window, seed=0):
    lens_k = lens_q if lens_k is None else lens_k
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    rng = np.random.RandomState(seed)
    q = rng.randn(tq, h, d).astype(F32)
    k = rng.randn(tk, hk, d).astype(F32)
    v = rng.randn(tk, hk, d).astype(F32)
    t = rng.randn(tq, h, d).astype(F32)
    want = jax.grad(
        lambda q, k, v: jnp.sum(jax_varlen(
            q, k, v, jnp.asarray(cu_q), jnp.asarray(cu_k), causal=causal,
            window_size=window) * t),
        (0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    cq, ck = torch.from_numpy(cu_q), torch.from_numpy(cu_k)
    out, lse = ops.varlen_flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), cq,
        ck, causal, window_size=window)
    delta = ops.varlen_flash_attention_bwd_delta(out, torch.from_numpy(t))
    return (q, k, v, t, lse.numpy(), delta.numpy(), cu_q, cu_k), \
        [np.asarray(w) for w in want]


@pytest.mark.parametrize("name", list(VARLEN))
def test_varlen_3xtf32_matches_pallas(name):
    lens_q, lens_k, h, hk, d, causal, window = VARLEN[name]
    args, want = _varlen_inputs(lens_q, lens_k, h, hk, d, causal, window)
    got = fused_varlen(*args, causal, window)
    for x in got:
        assert np.isfinite(x).all()
    worst = _worst(got, want)
    assert max(worst) <= REL, (name, worst)


# ------------------------------------------------------- why three terms
def test_tf32_rounds_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's last kept bit at 1.0
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4, 3.0e-39], F32)
    want = np.array([one + ulp, -(one + ulp), one, one + ulp, 0.0], F32)
    got = tf32(x)
    assert np.array_equal(got[:4], want[:4])
    # a subnormal keeps its top 10 bits (none here)
    assert abs(got[4]) < 3.0e-39
    x = np.array([np.pi, -1e-3, 123.456], F32)
    big, small = split(x)
    assert np.array_equal(tf32(big), big) and np.array_equal(big + small, x)
    # what the tensor core reads of the two parts leaves < 2^-20 of x
    rest = x - big - trunc(small)
    assert (np.abs(rest) <= 2.0 ** -20 * np.abs(big)).all()
    assert np.array_equal(trunc(big), big)


@pytest.mark.parametrize("name", ["causal_d64", "gqa4_d128"])
def test_one_tf32_product_misses_the_tolerance(name):
    b, sq, sk, h, hk, causal, window, d = DENSE[name]
    args, want = _dense_inputs(b, sq, sk, h, hk, causal, window, d)
    one = _worst(fused_dense(*args, causal, window, terms=1), want)
    three = _worst(fused_dense(*args, causal, window), want)
    assert max(one) > REL, one
    assert max(three) <= REL and max(three) * 10 < max(one), (three, one)


def test_one_tf32_product_misses_the_tolerance_varlen():
    lens_q, lens_k, h, hk, d, causal, window = VARLEN["ragged_gqa"]
    args, want = _varlen_inputs(lens_q, lens_k, h, hk, d, causal, window)
    one = _worst(fused_varlen(*args, causal, window, terms=1), want)
    assert max(one) > REL, one
