"""The port's ``block_multihead_attention`` held against paddle_tpu's on the
cases of tests/test_paged_attention.py, float and int8: the same numpy
inputs go through both ops (the reference's Pallas kernels in interpret
mode, the port's plain versions); outputs and the pools left behind must
agree within f32 ``2e-5`` (the reference tests' tolerance; only summation
order differs), int8 pools and per-row scale pools exactly."""
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
    (torch tensors) holding the same values; ``dtype="i1"`` makes int8
    pools, and ``scale_pools`` adds per-row scale pools passed as
    ``cache_k/v_scale_pool``."""

    def __init__(self, num_blocks, kc=None, vc=None, dtype="f4",
                 scale_pools=False):
        shape = (num_blocks, BS, HK, D)
        kc = np.zeros(shape, dtype) if kc is None else kc
        vc = np.zeros(shape, dtype) if vc is None else vc
        self.ref = [paddle.to_tensor(kc), paddle.to_tensor(vc)]
        self.port = [torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())]
        if scale_pools:
            z = np.zeros(shape[:3], "f4")
            self.ref_scales = [paddle.to_tensor(z), paddle.to_tensor(z)]
            self.port_scales = [torch.from_numpy(z.copy()) for _ in range(2)]

    def call(self, qkv, enc, dec, this, tables, out_tol=TOL, **kw):
        ref_kw = {k: (paddle.to_tensor(v) if isinstance(v, np.ndarray)
                      else v) for k, v in kw.items()}
        port_kw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
                       else v) for k, v in kw.items()}
        if hasattr(self, "ref_scales"):
            names = ("cache_k_scale_pool", "cache_v_scale_pool")
            ref_kw.update(zip(names, self.ref_scales))
            port_kw.update(zip(names, self.port_scales))
        lens = [np.asarray(a, "i4") for a in (enc, dec, this)]
        want = ref_block_mha(
            paddle.to_tensor(qkv), *self.ref,
            *[paddle.to_tensor(a) for a in lens],
            block_tables=paddle.to_tensor(tables),
            num_heads=H, kv_num_heads=HK, **ref_kw).numpy()
        got = block_multihead_attention(
            torch.from_numpy(qkv), *self.port, *lens,
            block_tables=tables, num_heads=H, kv_num_heads=HK, **port_kw)
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        if out_tol is not None:
            np.testing.assert_allclose(got.numpy(), want, **out_tol)
        self.last = (got.numpy(), want)
        for r, p in zip(self.ref, self.port):
            assert (p.dtype == torch.int8) == (r.numpy().dtype == np.int8)
            if p.dtype == torch.int8:
                np.testing.assert_array_equal(p.numpy(), r.numpy())
            else:
                np.testing.assert_allclose(p.numpy(), r.numpy(), **TOL)
        for r, p in zip(getattr(self, "ref_scales", ()),
                        getattr(self, "port_scales", ())):
            np.testing.assert_array_equal(p.numpy(), r.numpy())
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
    """The quant kwargs this slice once refused now follow the reference:
    static quant scales over float pools raise its ValueError, with its
    message."""
    z = np.zeros((4, BS, HK, D), "f4")
    lens = [np.asarray(a, "i4") for a in ([0], [0], [1])]
    qkv = np.zeros((1, (H + 2 * HK) * D), "f4")
    kw = dict(cache_k_quant_scales=np.ones(HK, "f4"),
              cache_v_quant_scales=np.ones(HK, "f4"))
    with pytest.raises(ValueError) as want:
        ref_block_mha(paddle.to_tensor(qkv), paddle.to_tensor(z),
                      paddle.to_tensor(z), *map(paddle.to_tensor, lens),
                      block_tables=paddle.to_tensor(np.zeros((1, 1), "i4")),
                      num_heads=H, kv_num_heads=HK,
                      **{k: paddle.to_tensor(v) for k, v in kw.items()})
    with pytest.raises(ValueError, match="not int8") as got:
        block_multihead_attention(
            torch.from_numpy(qkv), torch.from_numpy(z), torch.from_numpy(z),
            *lens, block_tables=np.zeros((1, 1), "i4"), num_heads=H,
            kv_num_heads=HK, **{k: torch.from_numpy(v) for k, v in
                                kw.items()})
    assert str(got.value) == str(want.value)


def _on_grid(rng, total):
    """qkv whose k/v lanes are multiples of 0.5 in [-60, 60]: exact on the
    int8 grid of quant scale 2.0 (the reference test's lossless case)."""
    qkv = rng.randn(total, (H + 2 * HK) * D).astype("f4")
    qkv[:, H * D:] = rng.randint(-120, 121, (total, 2 * HK * D)) / 2.0
    return qkv


def test_static_int8_lossless_grid_equals_float():
    """Static quant scales on qkv that sit on the int8 grid: the int8
    pools dequantize to exactly the float pools, so prefill (K3 over the
    dequantized context) and decode (K2's int8 arm) give the float
    path's output, as tests/test_paged_attention.py asks of the
    reference; the int8 run also equals the reference's."""
    lens = [9, 21]
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    qs = np.full(HK, 2.0, "f4")
    quant = dict(cache_k_quant_scales=qs, cache_v_quant_scales=qs)
    outs = []
    for dtype in ("i1", "f4"):
        rng = np.random.RandomState(6)
        both = _Both(16, dtype=dtype)
        kw = quant if dtype == "i1" else {}
        pre = both.call(_on_grid(rng, sum(lens)), lens, [0, 0], lens, tables,
                        **kw)
        dec = both.call(_on_grid(rng, 2), [0, 0], lens, [1, 1], tables, **kw)
        outs.append((pre.numpy(), dec.numpy(), both.port[0].numpy()))
    assert outs[0][2].dtype == np.int8
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    np.testing.assert_allclose(outs[0][1], outs[1][1], **TOL)
    np.testing.assert_array_equal(outs[0][2].astype("f4") / 2.0, outs[1][2])


@pytest.mark.parametrize("dequant", [False, True])
def test_static_int8_random_matches_reference(dequant):
    """Off-grid values: quantize on write with ``k * qs``, dequant scales
    given or defaulting to ``1 / qs``; prefill, decode and a mixed batch
    whose decode row runs K2's int8 arm."""
    rng = np.random.RandomState(11)
    qs = (rng.rand(HK) * 20 + 10).astype("f4")
    kw = dict(cache_k_quant_scales=qs, cache_v_quant_scales=qs * 1.5)
    if dequant:
        kw.update(cache_k_dequant_scales=(1.0 / qs * 1.01).astype("f4"),
                  cache_v_dequant_scales=(1.0 / qs).astype("f4"))
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    both = _Both(16, dtype="i1")
    lens = [9, 21]
    qkv = rng.randn(sum(lens), (H + 2 * HK) * D).astype("f4")
    both.call(qkv, lens, [0, 0], lens, tables, **kw)
    both.call(rng.randn(2, (H + 2 * HK) * D).astype("f4"), [0, 0], lens,
              [1, 1], tables, **kw)
    # a mixed batch: row 0 prefills 6 more tokens, row 1 decodes
    both.call(rng.randn(7, (H + 2 * HK) * D).astype("f4"), [6, 0],
              [10, 22], [6, 1], tables, **kw)


def test_float_pools_ignore_dequant_scales_as_the_reference():
    """Dequant scales without quant scales over float pools: the
    reference applies them only to an int8 cache, so prefill and decode
    rows alike run unscaled; the same calls without the scales give the
    same output."""
    rng = np.random.RandomState(13)
    ds = dict(cache_k_dequant_scales=(rng.rand(HK) + 0.5).astype("f4"),
              cache_v_dequant_scales=(rng.rand(HK) + 0.5).astype("f4"))
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    lens = [9, 21]
    calls = [(rng.randn(sum(lens), (H + 2 * HK) * D).astype("f4"), lens,
              [0, 0], lens),
             (rng.randn(2, (H + 2 * HK) * D).astype("f4"), [0, 0], lens,
              [1, 1]),
             (rng.randn(7, (H + 2 * HK) * D).astype("f4"), [6, 0],
              [10, 22], [6, 1])]
    scaled, plain = _Both(16), _Both(16)
    for qkv, enc, dec, this in calls:
        got = scaled.call(qkv, enc, dec, this, tables, **ds)
        np.testing.assert_array_equal(
            got.numpy(), plain.call(qkv, enc, dec, this, tables).numpy())


@pytest.mark.parametrize("neox", [None, True])
def test_dynamic_scale_pools_match_reference(neox):
    """Per-row scale pools (the serving engine's): every written row
    quantizes by its own abs-max and its scale lands beside it; decode
    rows run as 1-token prefill rows. Outputs agree within f32, the int8
    pools and scale pools exactly."""
    rng = np.random.RandomState(12)
    fused = {}
    if neox is not None:
        inv = 1.0 / (10000.0 ** (np.arange(0, D, 2) / D))
        ang = np.outer(np.arange(64), inv)
        fused = dict(rotary_embs=np.stack([np.cos(ang), np.sin(ang)])
                     .astype("f4"), use_neox_rotary_style=neox)
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    both = _Both(16, dtype="i1", scale_pools=True)
    lens = [9, 21]
    both.call(rng.randn(sum(lens), (H + 2 * HK) * D).astype("f4"), lens,
              [0, 0], lens, tables, **fused)
    both.call(rng.randn(2, (H + 2 * HK) * D).astype("f4"), [0, 0], lens,
              [1, 1], tables, **fused)
    both.call(rng.randn(7, (H + 2 * HK) * D).astype("f4"), [6, 0],
              [10, 22], [6, 1], tables, **fused)
    assert (both.port_scales[0].numpy()[[0, 2]] > 0).any()


def test_qkv_out_scale_matches_reference():
    rng = np.random.RandomState(8)
    lens = [7, 12]
    nchan = (H + 2 * HK) * D
    qkv_int = rng.randint(-1000, 1000, (sum(lens), nchan)).astype("f4")
    scale = (0.001 * (1 + np.arange(nchan) % 5)).astype("f4")
    bias = (rng.randn(nchan) * 0.1).astype("f4")
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    both = _Both(16)
    fused = both.call(qkv_int, lens, [0, 0], lens, tables,
                      qkv_out_scale=scale, qkv_bias=bias)
    outside = _Both(16).call(qkv_int * scale[None, :], lens, [0, 0], lens,
                             tables, qkv_bias=bias)
    np.testing.assert_allclose(fused.numpy(), outside.numpy(), **TOL)


def test_out_quant_epilogue_matches_reference():
    """out_shift, out_smooth and an int8 out_scale: the port's int8 output
    against the reference's, and against quantizing the float output
    outside the op (a value on a .5 boundary may round one step apart
    after f32 noise, as the reference test allows)."""
    rng = np.random.RandomState(9)
    lens = [9, 14]
    qkv = rng.randn(sum(lens), (H + 2 * HK) * D).astype("f4")
    shift = (rng.randn(H * D) * 0.1).astype("f4")
    smooth = (1.0 + rng.rand(H * D)).astype("f4")
    tables = np.asarray([[0, 1], [2, 3]], np.int32)
    plain = _Both(16).call(qkv, lens, [0, 0], lens, tables).numpy()
    both = _Both(16)
    got = both.call(qkv, lens, [0, 0], lens, tables, out_tol=None,
                    out_shift=shift, out_smooth=smooth, out_scale=0.02)
    assert got.dtype == torch.int8
    expect = np.clip(np.round((plain + shift[None]) * smooth[None] / 0.02),
                     -128, 127).astype(np.int8)
    for other in (both.last[1], expect):
        diff = np.abs(got.numpy().astype(np.int32) - other.astype(np.int32))
        assert diff.max() <= 1 and (diff == 0).mean() > 0.999


_ONES = np.ones(HK, "f4")


@pytest.mark.parametrize("pool_dtype,kw,match", [
    ("f4", dict(cache_k_quant_scales=_ONES), "BOTH cache_k_quant"),
    ("i1", {}, "need cache_k/v_quant_scales"),
    ("f4", dict(cache_k_quant_scales=_ONES, cache_v_quant_scales=_ONES),
     "not int8"),
    ("i1", dict(cache_k_scale_pool=np.zeros((2, BS, HK), "f4")),
     "BOTH cache_k_scale_pool"),
    ("i1", dict(cache_k_quant_scales=_ONES, cache_v_quant_scales=_ONES,
                cache_k_scale_pool=np.zeros((2, BS, HK), "f4"),
                cache_v_scale_pool=np.zeros((2, BS, HK), "f4")),
     "not both"),
])
def test_quant_validation_errors_match_reference(pool_dtype, kw, match):
    """The reference's refusals, with its messages, on both sides."""
    z = np.zeros((2, BS, HK, D), pool_dtype)
    lens = [np.asarray(a, "i4") for a in ([0], [0], [1])]
    qkv = np.zeros((1, (H + 2 * HK) * D), "f4")
    tables = np.zeros((1, 1), "i4")
    with pytest.raises(ValueError, match=match) as want:
        ref_block_mha(paddle.to_tensor(qkv), paddle.to_tensor(z),
                      paddle.to_tensor(z), *map(paddle.to_tensor, lens),
                      block_tables=paddle.to_tensor(tables), num_heads=H,
                      kv_num_heads=HK,
                      **{k: paddle.to_tensor(v) for k, v in kw.items()})
    with pytest.raises(ValueError, match=match) as got:
        block_multihead_attention(
            torch.from_numpy(qkv), torch.from_numpy(z), torch.from_numpy(z),
            *lens, block_tables=tables, num_heads=H, kv_num_heads=HK,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert str(got.value) == str(want.value)
