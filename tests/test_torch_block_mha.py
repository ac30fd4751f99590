"""The port's ``block_multihead_attention`` held against paddle_tpu's on the
float cases of tests/test_paged_attention.py: the same numpy inputs go
through both ops (the reference's Pallas kernels in interpret mode, the
port's plain versions); outputs and the pools left behind must agree
within f32 ``2e-5`` (the reference tests' tolerance; only summation
order differs)."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.incubate.nn.functional import (
    block_multihead_attention as ref_block_mha,
)
from paddle_tpu_torch.incubate.nn.functional import block_multihead_attention

TOL = dict(rtol=2e-5, atol=2e-5)
H, HK, D, BS = 4, 2, 64, 32


class _Both:
    """One reference pool pair (paddle Tensors) and one port pool pair
    (torch tensors) holding the same values."""

    def __init__(self, num_blocks, kc=None, vc=None):
        shape = (num_blocks, BS, HK, D)
        kc = np.zeros(shape, "f4") if kc is None else kc
        vc = np.zeros(shape, "f4") if vc is None else vc
        self.ref = (paddle.to_tensor(kc), paddle.to_tensor(vc))
        self.port = (torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()))

    def call(self, qkv, enc, dec, this, tables, **kw):
        ref_kw = {k: (paddle.to_tensor(v) if isinstance(v, np.ndarray)
                      else v) for k, v in kw.items()}
        port_kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                       else v) for k, v in kw.items()}
        lens = [np.asarray(a, "i4") for a in (enc, dec, this)]
        want = ref_block_mha(
            paddle.to_tensor(qkv), *self.ref,
            *[paddle.to_tensor(a) for a in lens],
            block_tables=paddle.to_tensor(tables),
            num_heads=H, kv_num_heads=HK, **ref_kw).numpy()
        got = block_multihead_attention(
            torch.from_numpy(qkv), *self.port, *lens,
            block_tables=tables, num_heads=H, kv_num_heads=HK, **port_kw)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        for r, p in zip(self.ref, self.port):
            np.testing.assert_allclose(p.numpy(), r.numpy(), **TOL)
        return got


def _cached(rng, num_blocks, table, n):
    """Pools holding ``n`` cached tokens of one sequence at ``table``."""
    kc = np.zeros((num_blocks, BS, HK, D), "f4")
    vc = np.zeros_like(kc)
    for pos in range(n):
        kc[table[pos // BS], pos % BS] = rng.randn(HK, D) * 0.5
        vc[table[pos // BS], pos % BS] = rng.randn(HK, D) * 0.5
    return kc, vc


def test_prefill_then_decode():
    rng = np.random.RandomState(2)
    lens = [9, 21]
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    both = _Both(16)
    qkv = rng.randn(sum(lens), (H + 2 * HK) * D).astype("f4")
    both.call(qkv, lens, [0, 0], lens, tables)
    qkv_dec = rng.randn(2, (H + 2 * HK) * D).astype("f4")
    both.call(qkv_dec, [0, 0], lens, [1, 1], tables)


def test_mixed_prefill_decode_batch():
    rng = np.random.RandomState(3)
    tables = np.asarray([[1, 0], [2, 0]], np.int32)
    kc, vc = _cached(rng, 16, tables[1], 16)    # row 1 holds 16 tokens
    both = _Both(16, kc, vc)
    qkv = rng.randn(9, (H + 2 * HK) * D).astype("f4")   # 8 + 1 tokens
    both.call(qkv, [8, 0], [0, 16], [8, 1], tables)


def test_chunked_prefill_attends_cache():
    """A prefill row with cached tokens (chunked prefill) attends cache +
    new tokens, bottom-right aligned; here the chunk crosses a block."""
    rng = np.random.RandomState(4)
    tables = np.asarray([[5, 2, 7]], np.int32)
    kc, vc = _cached(rng, 8, tables[0], 30)
    both = _Both(8, kc, vc)
    qkv = rng.randn(6, (H + 2 * HK) * D).astype("f4")
    both.call(qkv, [6], [30], [6], tables)


def test_inactive_rows_skipped():
    rng = np.random.RandomState(5)
    tables = np.asarray([[0, 0], [3, 0]], np.int32)
    kc, vc = _cached(rng, 8, tables[1], 12)
    both = _Both(8, kc, vc)
    qkv = rng.randn(1, (H + 2 * HK) * D).astype("f4")
    both.call(qkv, [0, 0], [0, 12], [0, 1], tables)


@pytest.mark.parametrize("neox", [True, False])
def test_fused_rope_and_bias(neox):
    rng = np.random.RandomState(5)
    lens = [7, 13]
    inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
    ang = np.outer(np.arange(64), inv)
    rot = np.stack([np.cos(ang), np.sin(ang)]).astype("f4")
    bias = (rng.randn((H + 2 * HK) * D) * 0.1).astype("f4")
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    both = _Both(16)
    fused = dict(rotary_embs=rot, qkv_bias=bias, use_neox_rotary_style=neox)
    qkv = rng.randn(sum(lens), (H + 2 * HK) * D).astype("f4")
    both.call(qkv, lens, [0, 0], lens, tables, **fused)
    qkv_dec = rng.randn(2, (H + 2 * HK) * D).astype("f4")
    both.call(qkv_dec, [0, 0], lens, [1, 1], tables, **fused)
    with pytest.raises(ValueError, match="rotary_embs table length"):
        both.call(qkv_dec, [0, 0], [70, 70], [1, 1],
                  np.asarray([[0, 1, 4], [2, 3, 5]], np.int32), **fused)


def test_quant_kwargs_belong_to_a_later_slice():
    z = torch.zeros(4, BS, HK, D)
    lens = np.asarray([1], "i4")
    with pytest.raises(NotImplementedError, match="int8"):
        block_multihead_attention(
            torch.zeros(1, (H + 2 * HK) * D), z, z.clone(), lens * 0,
            lens * 0, lens, block_tables=np.zeros((1, 1), "i4"),
            num_heads=H, kv_num_heads=HK,
            cache_k_quant_scales=torch.ones(HK),
            cache_v_quant_scales=torch.ones(HK))
