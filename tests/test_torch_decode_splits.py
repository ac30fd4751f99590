"""The split plan of the decode attention kernels K2 and K5
(``paddle_tpu_torch.ops.split_decode``) and a plain rehearsal of the
order in which their kernel (``csrc/split_decode.cuh``) sums, on the CPU.

The plan tests walk every CTA of a launch as the kernel does (split ``s``
of a sequence reads the positions ``DecodeSplits.span(s, len)`` and the
table entries under them) and check that every live token is read exactly
once and no table entry at or past ``ceil(len / block_size)`` is read.

The rehearsal repeats the kernel's arithmetic order in numpy f32: each
stretch of ``DecodeSplits`` is streamed in ring tiles, each of the four
warps takes its rows of every tile in steps (an online softmax in the log2
domain per step), the warps merge in warp order, and the stretches merge
in split order; dequant scales fold into the score and into p as the
kernel folds them. It is held against the JAX package's Pallas kernels
(interpret mode off the TPU) and the reference engine's per-row gather
within f32 ``2e-5``, the tolerance of tests/test_torch_kernels.py. The
tensor-core path (bf16 queries) walks 64-row tiles in 16-row steps, the
CUDA-core path (f32 queries) 32-row tiles in 4-row steps; both orders are
rehearsed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.ops.pallas.decode_attention import (
    decode_attention as jax_decode_attention,
)
from paddle_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention,
)
from paddle_tpu.serving.engine import _xla_paged_decode_attn
from paddle_tpu_torch.ops import split_decode as SD

F32 = dict(rtol=2e-5, atol=2e-5)
NEG_INF = np.float32(-1e30)
LOG2E = np.float32(1.4426950408889634)
# (tile rows, rows per warp, rows per step): the tensor-core and the
# CUDA-core paths
GEOMETRIES = {"tensor_cores": (64, 16, 16), "cuda_cores": (32, 8, 4)}


# ---------------------------------------------------------------- plan
def _walk(splits, length, table_row, bs):
    """The positions and the block ids the CTAs of one (sequence, KV
    head) pair read, in launch order."""
    positions, ids = [], set()
    for split in range(splits.nsplit):
        span = splits.span(split, length)
        if span is None:
            continue
        for pos in range(*span):
            positions.append(pos)
            ids.add(table_row[pos // bs])
    return positions, ids


@pytest.mark.parametrize("pairs", [1, 2, 3, 8, 32, 100, 256])
@pytest.mark.parametrize("bs", [16, 32, 64])
def test_plan_reads_every_live_token_once(pairs, bs):
    """Page boundaries, lens 0 and 1, a stretch length +- 1 and the
    table's full reach, with stale ids past each length, for B x HK from
    1 to 256 and block sizes 16, 32 and 64."""
    for width, num_sms in ((2048 // bs, 132), (7, 132), (2048 // bs, 4)):
        reach = width * bs
        splits = SD.plan(pairs, reach, 512, num_sms)
        st = splits.stretch
        lens = {0, 1, bs - 1, bs, bs + 1, st - 1, st, st + 1, 2 * st - 1,
                2 * st + 1, reach - 1, reach}
        for length in sorted(x for x in lens if 0 <= x <= reach):
            nblk = -(-length // bs)
            # live ids, then stale ones (negative, past the pool)
            live_ids = [3 * i + 1 for i in range(nblk)]
            table_row = live_ids + [-5 if i % 2 else 10 ** 6
                                    for i in range(width - nblk)]
            positions, ids = _walk(splits, length, table_row, bs)
            assert positions == list(range(length))
            assert ids == set(live_ids)
            assert splits.live(length) <= splits.nsplit


@pytest.mark.parametrize("row_bytes", [128, 256, 512, 1024])
def test_plan_stays_in_the_kernel_limits(row_bytes):
    """Every plan is one the kernel takes: stretches of a multiple of 64
    tokens up to MAX_STRETCH, at most MAX_SPLITS of them, covering the
    reach with no empty split."""
    for pairs in (1, 2, 7, 32, 256, 1024, 2048, 65535):
        for reach in (1, 63, 64, 65, 2048, 4096, 32768, 524288):
            s = SD.plan(pairs, reach, row_bytes, 132)
            assert s.stretch % SD.STRETCH_UNIT == 0
            assert SD.STRETCH_UNIT <= s.stretch <= SD.MAX_STRETCH
            assert 1 <= s.nsplit <= SD.MAX_SPLITS
            assert s.nsplit * s.stretch >= reach > (s.nsplit - 1) * s.stretch


def test_plan_shortens_stretches_at_small_b_hk():
    """Short stretches where B x HK is small (at least MIN_STRETCH),
    longer ones as it grows, capped at 256 KiB of K and V per CTA (512
    bf16 tokens at D = 128)."""
    row = 2 * 128 * 2
    stretches = [SD.plan(p, 2048, row, 132).stretch
                 for p in (1, 8, 32, 64, 256, 1024, 2048)]
    assert stretches == sorted(stretches)
    assert stretches[0] == SD.MIN_STRETCH
    assert stretches[-1] == 512
    # the generate run (4 x 8 pairs, 4,096 tokens) and the serving run (8
    # x 32 pairs, a 2,048-token table)
    assert SD.plan(32, 4096, row, 132) == SD.DecodeSplits(128, 32)
    assert SD.plan(256, 2048, row, 132) == SD.DecodeSplits(512, 4)
    # int8 rows are half as long: longer stretches at the same bytes
    assert SD.plan(2048, 2048, row // 2, 132).stretch == 1024


def test_plan_refuses_a_reach_past_the_kernel():
    with pytest.raises(ValueError, match="reach"):
        SD.plan(1, SD.MAX_SPLITS * SD.MAX_STRETCH + 1, 512, 132)


# ----------------------------------------------------------- merge tickets
# Fake stream handles: the rule is a pure function of the handle's value.
STREAMS = (0, 0x7f3a10, 0x7f3a20, 2 ** 47 + 16)


@pytest.mark.parametrize("pairs", [1, 7, 256, 1023, 1024, 1025, 4096, 70000])
def test_ticket_key_is_a_pure_function(pairs):
    key = SD.ticket_key(0, STREAMS[1], pairs)
    assert key == SD.ticket_key(0, STREAMS[1], pairs)
    index, stream, cap = key
    assert (index, stream) == (0, STREAMS[1])
    # a power of two that holds the pairs, never below the floor
    assert cap >= max(pairs, SD.MIN_TICKETS) and cap & (cap - 1) == 0
    assert cap == SD.MIN_TICKETS or cap < 2 * pairs


@pytest.mark.parametrize("pairs", [8, 1024, 5000])
def test_two_streams_never_share_tickets(pairs):
    keys = {SD.ticket_key(dev, s, pairs) for dev in (0, 1) for s in STREAMS}
    assert len(keys) == 2 * len(STREAMS)
    # nor do launches of different sizes on two streams
    assert SD.ticket_key(0, STREAMS[1], pairs) != SD.ticket_key(
        0, STREAMS[2], 2 * pairs)


def test_ticket_buffers_are_never_replaced(monkeypatch):
    import torch

    monkeypatch.setattr(SD, "_TICKETS", {})
    dev = torch.device("cpu")
    # a small launch, one past the floor, then a small one again
    seen = {}
    for pairs in (8, 1024, 1025, 8, 5000, 1025, 64):
        t = SD.tickets_for(dev, STREAMS[1], pairs)
        assert t.dtype == torch.int32 and t.numel() >= pairs
        assert int(t.abs().sum()) == 0
        key = SD.ticket_key(None, STREAMS[1], pairs)
        # the same buffer, at the same address, at every later use
        assert seen.setdefault(key, (t, t.data_ptr()))[1] == t.data_ptr()
        assert seen[key][0] is t
    assert len(SD._TICKETS) == 3  # 1024, 2048 and 8192 tickets
    other = SD.tickets_for(dev, STREAMS[2], 8)
    assert other.data_ptr() != SD.tickets_for(dev, STREAMS[1], 8).data_ptr()
    assert len(SD._TICKETS) == 4



# ----------------------------------------------------------- rehearsal
def _pair(q, k, v, ok, ks, vs, splits, sm_scale, geometry):
    """The kernel's order for one (sequence, KV head) pair: q (G, D), the
    pair's rows k, v (L, D) by position, ``ok`` whether each has a pool
    row, ks / vs the dequant scale of each (ones without scales)."""
    tile, warp_rows, step = geometry
    g, d = q.shape
    length = k.shape[0]
    if length <= 0:
        return np.zeros((g, d), np.float32)
    qscale = np.float32(sm_scale) * LOG2E
    parts = []
    for split in range(splits.live(length)):
        t0, t1 = splits.span(split, length)
        n = t1 - t0
        warps = []
        for w in range(4):
            m = np.full(g, NEG_INF, np.float32)
            l = np.zeros(g, np.float32)
            acc = np.zeros((g, d), np.float32)
            for r0 in range(0, n, tile):
                for a in range(r0 + w * warp_rows, r0 + (w + 1) * warp_rows,
                               step):
                    idx = [t0 + i for i in range(a, a + step)
                           if i < n and ok[t0 + i]]
                    if not idx:
                        continue
                    s = (q @ k[idx].T) * (qscale * ks[idx])
                    m_new = np.maximum(m, s.max(axis=1))
                    alpha = np.exp2(m - m_new)
                    p = np.exp2(s - m_new[:, None])
                    l = alpha * l + p.sum(axis=1)
                    acc = acc * alpha[:, None] + (p * vs[idx]) @ v[idx]
                    m = m_new
            warps.append((m, l, acc))
        mx = np.max([w[0] for w in warps], axis=0)
        a = np.zeros((g, d), np.float32)
        l = np.zeros(g, np.float32)
        for wm, wl, wacc in warps:
            f = np.exp2(wm - mx)
            a = a + wacc * f[:, None]
            l = l + wl * f
        parts.append((mx, l, a))
    mx = np.max([p[0] for p in parts], axis=0)
    a = np.zeros((g, d), np.float32)
    l = np.zeros(g, np.float32)
    for pm, pl, pa in parts:
        f = np.exp2(pm - mx)
        a = a + pa * f[:, None]
        l = l + pl * f
    return a / np.maximum(l, np.float32(1e-30))[:, None]


def rehearse_paged(q, kp, vp, tables, lens, splits, geometry,
                   k_scale=None, v_scale=None, row_scales=None):
    """K2 in the kernel's order: each position's pool row through the
    table (entries below ceil(len / block_size) only; a stale id is
    skipped), (HK,) scales or per-row (k, v) scale pools folded."""
    b, h, d = q.shape
    nb, bs, hk, _ = kp.shape
    width = tables.shape[1]
    group = h // hk
    out = np.zeros((b, h, d), np.float32)
    kr = kp.reshape(nb * bs, hk, d).astype(np.float32)
    vr = vp.reshape(nb * bs, hk, d).astype(np.float32)
    for bi in range(b):
        length = max(0, min(int(lens[bi]), width * bs))
        pos = np.arange(length)
        blk = tables[bi, pos // bs]
        ok = (blk >= 0) & (blk < nb)
        row = np.where(ok, blk * bs + pos % bs, 0)
        for kvh in range(hk):
            ones = np.ones(length, np.float32)
            ks = ones * (1 if k_scale is None else k_scale[kvh])
            vs = ones * (1 if v_scale is None else v_scale[kvh])
            if row_scales is not None:
                ks = row_scales[0].reshape(-1, hk)[row, kvh]
                vs = row_scales[1].reshape(-1, hk)[row, kvh]
            heads = slice(kvh * group, (kvh + 1) * group)
            out[bi, heads] = _pair(
                q[bi, heads], kr[row, kvh], vr[row, kvh], ok,
                ks.astype(np.float32), vs.astype(np.float32), splits,
                1 / math.sqrt(d), geometry)
    return out


def _paged_case(rng, lens, h, hk, d, bs, stale=True, num_blocks=64):
    b = len(lens)
    w = max(-(-ln // bs) for ln in lens) + 2
    kp = rng.randn(num_blocks, bs, hk, d).astype("f4")
    vp = rng.randn(num_blocks, bs, hk, d).astype("f4")
    perm = rng.permutation(num_blocks)
    tables = np.full((b, w), 10 ** 6 if stale else 0, np.int32)
    nxt = 0
    for i, ln in enumerate(lens):
        n = -(-ln // bs)
        tables[i, :n] = perm[nxt:nxt + n]
        nxt += n
        if stale and n < w:
            tables[i, n] = -7
    q = rng.randn(b, h, d).astype("f4")
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _splits(kind, pairs, reach):
    """The shortest stretches (the most splits to merge), or the plan of
    a launch at these shapes on a 132-SM card."""
    if kind == "shortest":
        return SD.DecodeSplits(SD.STRETCH_UNIT, -(-reach // SD.STRETCH_UNIT))
    return SD.plan(pairs, reach, 512, 132)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("kind", ["shortest", "planned"])
@pytest.mark.parametrize("lens,h,hk,d,bs", [
    ([0, 1, 63, 64, 65, 200], 8, 4, 64, 32),   # GQA, lens around a stretch
    ([7, 130, 33], 4, 4, 64, 16),               # MHA
    ([5, 190], 7, 1, 128, 32),                  # MQA, a group of 7
])
def test_rehearsal_matches_pallas_paged(geometry, kind, lens, h, hk, d, bs):
    rng = np.random.RandomState(11)
    q, kp, vp, tables, sl = _paged_case(rng, lens, h, hk, d, bs)
    splits = _splits(kind, len(lens) * hk, tables.shape[1] * bs)
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(sl))
    got = rehearse_paged(q, kp, vp, tables, sl, splits, GEOMETRIES[geometry])
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("int8", [False, True])
def test_rehearsal_matches_pallas_static_scales(geometry, int8):
    """The has_scales arm: (HK,) scales over float pools (K2's scaled
    mode) and over int8 pools (its static int8 arm)."""
    rng = np.random.RandomState(12)
    q, kp, vp, tables, sl = _paged_case(rng, [1, 64, 129, 250], 8, 2, 64,
                                        32)
    if int8:
        kp, vp = (np.clip(np.round(p * 40), -128, 127).astype(np.int8)
                  for p in (kp, vp))
        ks = (rng.rand(2) * 0.05 + 0.01).astype("f4")
        vs = (rng.rand(2) * 0.05 + 0.01).astype("f4")
    else:
        ks, vs = np.asarray([0.5, 2.0], "f4"), np.asarray([1.5, 0.25], "f4")
    splits = _splits("shortest", 8, tables.shape[1] * 32)
    want = jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(sl), k_scale=jnp.asarray(ks),
        v_scale=jnp.asarray(vs))
    got = rehearse_paged(q, kp, vp, tables, sl, splits, GEOMETRIES[geometry],
                         k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_rehearsal_matches_reference_engine_row_scales(geometry):
    """K2's per-row mode against the reference engine's gather over
    per-row scale pools (tables padded with block 0, as the engine pads
    them: the gather reads every entry)."""
    rng = np.random.RandomState(13)
    q, kp, vp, tables, sl = _paged_case(rng, [3, 64, 140, 200], 8, 4, 64,
                                        16, stale=False)
    kq, vq = (np.clip(np.round(p * 40), -128, 127).astype(np.int8)
              for p in (kp, vp))
    ks = (rng.rand(*kp.shape[:3]) * 0.05 + 0.01).astype("f4")
    vs = (rng.rand(*kp.shape[:3]) * 0.05 + 0.01).astype("f4")
    splits = _splits("shortest", 16, tables.shape[1] * 16)
    want = _xla_paged_decode_attn(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq),
        jnp.asarray(tables), jnp.asarray(sl), ks=jnp.asarray(ks),
        vs=jnp.asarray(vs))
    got = rehearse_paged(q, kq, vq, tables, sl, splits, GEOMETRIES[geometry],
                         row_scales=(ks, vs))
    np.testing.assert_allclose(got, np.asarray(want), **F32)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("kind", ["shortest", "planned"])
def test_rehearsal_matches_pallas_contiguous(geometry, kind):
    """K5: row b * S_max + pos of the contiguous cache, lens 0, 1, a
    stretch + 1 and S_max."""
    rng = np.random.RandomState(14)
    b, h, hk, d, s_max = 4, 8, 2, 64, 300
    q = rng.randn(b, h, d).astype("f4")
    kc = rng.randn(b, s_max, hk, d).astype("f4")
    vc = rng.randn(b, s_max, hk, d).astype("f4")
    lens = np.asarray([0, 1, 65, s_max], np.int32)
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens)))
    # a contiguous cache is a pool of one block per sequence
    tables = np.arange(b, dtype=np.int32)[:, None]
    got = rehearse_paged(q, kc, vc, tables, lens,
                         _splits(kind, b * hk, s_max), GEOMETRIES[geometry])
    np.testing.assert_allclose(got[1:], want[1:], **F32)
    assert (got[0] == 0).all()
