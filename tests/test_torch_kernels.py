"""The port's kernels K1-K3 (paddle_tpu_torch.ops) held against the Pallas
kernels of paddle_tpu, on the shapes the reference's own kernel tests use.

On the CPU the port's wrappers run their plain PyTorch versions and the
Pallas kernels run in interpret mode, so these tests check the plain
versions' arithmetic (the oracle the CUDA kernels are held to on the
card). Tolerances: f32 ``2e-5`` (the reference tests' own; only the
summation order differs), bf16 one bf16 rounding step (both sides compute
in f32 and round the result once). tests/test_torch_cuda.py holds each
CUDA kernel against its plain version on the card.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.ops.pallas.paged_attention import (
    paged_cache_write as jax_paged_cache_write,
    paged_decode_attention as jax_paged_decode_attention,
)
from paddle_tpu.ops.pallas.rms_norm import _rms_fwd
from paddle_tpu.ops.pallas.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu.ops.pallas.varlen_flash_attention import (
    varlen_flash_attention as jax_varlen_flash_attention,
)
from paddle_tpu_torch import ops
from paddle_tpu_torch.ops import _library

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=8e-3, atol=1e-2)   # one bf16 rounding step (2^-7)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_np(a):
    """float32 values exactly representable in bf16 (same bits both sides)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# ------------------------------------------------------------------ K1
@pytest.mark.parametrize("shape", [(4, 128, 512), (3, 100, 256), (7, 64)])
def test_rms_norm_plain_matches_pallas(shape):
    rng = np.random.RandomState(2)
    x = rng.randn(*shape).astype("f4")
    w = rng.randn(shape[-1]).astype("f4")
    want = np.asarray(jax_rms_norm(jnp.asarray(x), jnp.asarray(w)))
    y, r = ops.rms_norm(_t(x), _t(w), return_rstd=True)
    np.testing.assert_allclose(y.numpy(), want, **F32)
    _, r_ref = _rms_fwd(jnp.asarray(x.reshape(-1, shape[-1])),
                        jnp.asarray(w), 1e-6, 8)
    np.testing.assert_allclose(r.reshape(-1).numpy(),
                               np.asarray(r_ref)[:, 0], **F32)


def test_rms_norm_plain_matches_pallas_bf16():
    rng = np.random.RandomState(3)
    x = _bf16_np(rng.randn(8, 256).astype("f4"))
    w = _bf16_np(rng.randn(256).astype("f4"))
    want = jax_rms_norm(jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(w, jnp.bfloat16))
    got = ops.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_rms_norm_rejects_mismatched_weight():
    with pytest.raises(ValueError, match="weight"):
        ops.rms_norm(torch.zeros(2, 8), torch.ones(4))


# ------------------------------------------------------------------ K2
def _paged_setup(rng, lens, h, hk, d, bs, num_blocks=64, garbage=True):
    """A pool holding each sequence's K/V through a shuffled block table;
    entries past each length hold ids far outside the pool."""
    b = len(lens)
    w = max(-(-ln // bs) for ln in lens) + 2
    kp = rng.randn(num_blocks, bs, hk, d).astype("f4")
    vp = rng.randn(num_blocks, bs, hk, d).astype("f4")
    perm = rng.permutation(num_blocks)
    tables = np.full((b, w), 10 ** 6 if garbage else 0, np.int32)
    nxt = 0
    for i, ln in enumerate(lens):
        n = -(-ln // bs)
        tables[i, :n] = perm[nxt:nxt + n]
        nxt += n
        if garbage and n < w:
            tables[i, n] = -7
    q = rng.randn(b, h, d).astype("f4")
    return q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens,h,hk,d,bs", [
    ([7, 32, 57, 128], 8, 4, 64, 32),    # the reference test's shape, GQA
    ([1, 40, 33], 4, 4, 64, 16),         # MHA, ragged tails
    ([5, 100], 8, 1, 32, 32),            # MQA
])
def test_paged_plain_matches_pallas(lens, h, hk, d, bs):
    rng = np.random.RandomState(0)
    q, kp, vp, tables, sl = _paged_setup(rng, lens, h, hk, d, bs)
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(sl))
    got = ops.paged_decode_attention(_t(q), _t(kp), _t(vp), _t(tables),
                                     _t(sl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    # the (B, 1, H, D) query layout round-trips its rank
    got4 = ops.paged_decode_attention(_t(q)[:, None], _t(kp), _t(vp),
                                      _t(tables), _t(sl))
    assert got4.shape == (len(lens), 1, h, d)
    np.testing.assert_array_equal(got4[:, 0].numpy(), got.numpy())


def test_paged_plain_matches_pallas_bf16():
    rng = np.random.RandomState(1)
    q, kp, vp, tables, sl = _paged_setup(rng, [9, 64, 70], 8, 2, 64, 32)
    q, kp, vp = _bf16_np(q), _bf16_np(kp), _bf16_np(vp)
    want = jax_paged_decode_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(tables), jnp.asarray(sl))
    got = ops.paged_decode_attention(
        _t(q).bfloat16(), _t(kp).bfloat16(), _t(vp).bfloat16(), _t(tables),
        _t(sl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_paged_cache_write_matches_reference():
    rng = np.random.RandomState(4)
    q, kp, vp, tables, sl = _paged_setup(rng, [15, 40], 4, 2, 16, 8,
                                         garbage=False)
    k_new = rng.randn(2, 2, 16).astype("f4")
    v_new = rng.randn(2, 2, 16).astype("f4")
    pos = np.asarray([15, 39], np.int32)
    kw, vw = jax_paged_cache_write(jnp.asarray(kp), jnp.asarray(vp),
                                   jnp.asarray(k_new), jnp.asarray(v_new),
                                   jnp.asarray(tables), jnp.asarray(pos))
    kt, vt = _t(kp.copy()), _t(vp.copy())
    out = ops.paged_cache_write(kt, vt, _t(k_new), _t(v_new), _t(tables),
                                _t(pos))
    assert out[0] is kt and out[1] is vt          # written in place
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kw))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vw))


def test_paged_rejects_int8_scales():
    with pytest.raises(NotImplementedError, match="int8"):
        ops.paged_decode_attention(
            torch.zeros(1, 2, 16), torch.zeros(4, 8, 2, 16),
            torch.zeros(4, 8, 2, 16), torch.zeros(1, 1, dtype=torch.int32),
            torch.ones(1, dtype=torch.int32), k_scale=torch.ones(2))


# ------------------------------------------------------------------ K3
def _cu(lens):
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _varlen_case(rng, lens_q, lens_k, h, hk, d):
    cu_q, cu_k = _cu(lens_q), _cu(lens_k)
    q = rng.randn(int(cu_q[-1]), h, d).astype("f4")
    k = rng.randn(int(cu_k[-1]), hk, d).astype("f4")
    v = rng.randn(int(cu_k[-1]), hk, d).astype("f4")
    return q, k, v, cu_q, cu_k


def _both(q, k, v, cu_q, cu_k, **kw):
    want = jax_varlen_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(cu_q),
        jnp.asarray(cu_k), **kw)
    kw.pop("block_q", None)
    kw.pop("block_k", None)
    got, lse = ops.varlen_flash_attention(
        _t(q), _t(k), _t(v), _t(cu_q), _t(cu_k), return_lse=True, **kw)
    return np.asarray(want), got, lse


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_plain_matches_pallas(causal):
    rng = np.random.RandomState(0)
    lens = [13, 37, 1, 77]            # ragged, incl. a length-1 sequence
    q, k, v, cu, _ = _varlen_case(rng, lens, lens, 4, 2, 64)  # GQA group 2
    want, got, lse = _both(q, k, v, cu, cu, causal=causal,
                           sm_scale=64 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # lse is the log-sum-exp of the live scaled scores, row by row
    seg = np.searchsorted(cu[1:], np.arange(cu[-1]), side="right")
    kr = np.repeat(k, 2, axis=1)
    for t in (0, 14, 50, 51, int(cu[-1]) - 1):
        lo, hi = cu[seg[t]], cu[seg[t] + 1]
        hi = t + 1 if causal else hi
        s = np.einsum("hd,khd->hk", q[t], kr[lo:hi]) * 64 ** -0.5
        mx = s.max(-1)
        ref = mx + np.log(np.exp(s - mx[:, None]).sum(-1))
        np.testing.assert_allclose(lse[:, t].numpy(), ref, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_varlen_plain_matches_pallas_cross_lengths(causal):
    """q shorter than k per segment: bottom-right causal alignment, the
    chunked-prefill shape (cache + new tokens)."""
    rng = np.random.RandomState(1)
    q, k, v, cu_q, cu_k = _varlen_case(rng, [9, 25, 40], [17, 25, 61],
                                       4, 4, 64)
    want, got, _ = _both(q, k, v, cu_q, cu_k, causal=causal,
                         sm_scale=64 ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_varlen_plain_matches_pallas_sliding_window():
    rng = np.random.RandomState(6)
    lens = [50, 7, 90, 30]
    q, k, v, cu, _ = _varlen_case(rng, lens, lens, 4, 2, 64)
    want, got, _ = _both(q, k, v, cu, cu, causal=True, window_size=16,
                         block_q=128, block_k=128)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    full = ops.varlen_flash_attention(_t(q), _t(k), _t(v), _t(cu), _t(cu),
                                      causal=True)
    assert np.abs(got.numpy() - full.numpy()).max() > 1e-3
    with pytest.raises(ValueError, match="causal"):
        ops.varlen_flash_attention(_t(q), _t(k), _t(v), _t(cu), _t(cu),
                                   window_size=16)


def test_varlen_plain_matches_pallas_bf16():
    rng = np.random.RandomState(7)
    q, k, v, cu_q, cu_k = _varlen_case(rng, [20, 64], [52, 64], 8, 2, 64)
    q, k, v = _bf16_np(q), _bf16_np(k), _bf16_np(v)
    want = jax_varlen_flash_attention(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.asarray(cu_q), jnp.asarray(cu_k),
        causal=True)
    got = ops.varlen_flash_attention(
        _t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), _t(cu_q),
        _t(cu_k), causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)


def test_varlen_rows_without_keys_are_zero():
    """A segment with fewer keys than queries leaves its first rows with
    no live key under bottom-right causality: out 0, as the kernels do."""
    rng = np.random.RandomState(8)
    q, k, v, cu_q, cu_k = _varlen_case(rng, [6], [3], 2, 2, 16)
    out = ops.varlen_flash_attention(_t(q), _t(k), _t(v), _t(cu_q),
                                     _t(cu_k), causal=True)
    np.testing.assert_array_equal(out[:3].numpy(), 0.0)
    assert np.abs(out[3:].numpy()).min() > 0


def test_cpu_path_never_builds_the_kernels():
    ops.rms_norm(torch.ones(2, 16), torch.ones(16))
    assert _library._lib is None
