"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the serving engine's, ``generate``'s and the training
step's kernel paths against their plain paths. Skips where no CUDA device is present (a CUDA kernel has no CPU
mode). Imports neither jax nor paddle_tpu, so on a machine with a GPU and
no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 ``1e-5`` (summation order only, full-f32 products), bf16
``2e-2`` (about two bf16 rounding steps at |x| ~ 1); engine streams in
f32 must be equal.
"""
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch import create_serving_engine, ops
from paddle_tpu_torch.jit import JittedTrainStep
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  LlamaPretrainingCriterion)
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask
from paddle_tpu_torch.optimizer import AdamW


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rnd(g, dtype, *shape):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_kernels_match_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(0)
    for rows, n in ((37, 4096), (3, 64), (5, 100)):
        x, w = _rnd(g, dtype, rows, n), _rnd(g, dtype, n)
        y, r = ops.rms_norm(x, w, return_rstd=True)
        y_ref, r_ref = ops.rms_norm_plain(x, w)
        torch.testing.assert_close(y.float(), y_ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(r, r_ref, atol=1e-5, rtol=1e-5)

    # groups of 1, 4, 4, 7 (Qwen2-7B's 28 over 4) and 3: a group that is
    # no power of two runs in the next one's slot
    for h, hk, bs in ((32, 32, 32), (32, 8, 16), (4, 1, 4), (28, 4, 16),
                      (6, 2, 16)):
        lens = torch.tensor([1, 31, 32, 300], dtype=torch.int32,
                            device=cuda)
        w = -(-300 // bs) + 2
        nb = 4 * w + 1
        kp, vp = _rnd(g, dtype, nb, bs, hk, 128), _rnd(g, dtype, nb, bs, hk,
                                                       128)
        tables = torch.randperm(nb, device=cuda)[:4 * w].view(4, w).int()
        for i, ln in enumerate(lens.tolist()):
            tables[i, -(-ln // bs):] = 10 ** 6      # never read
        q = _rnd(g, dtype, 4, h, 128)
        out = ops.paged_decode_attention(q, kp, vp, tables, lens)
        assert torch.equal(out, ops.paged_decode_attention(q, kp, vp, tables,
                                                           lens))
        ref = ops.paged_decode_attention_plain(q, kp, vp, tables, lens)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)

    cu_q = torch.tensor([0, 128, 129, 200, 203], dtype=torch.int32,
                        device=cuda)
    cu_k = torch.tensor([0, 300, 301, 600, 601], dtype=torch.int32,
                        device=cuda)
    for hk, d in ((8, 128), (32, 64)):
        q, k, v = (_rnd(g, dtype, 203, 32, d), _rnd(g, dtype, 601, hk, d),
                   _rnd(g, dtype, 601, hk, d))
        for causal, window in ((True, None), (True, 64), (False, None)):
            out, lse = ops.varlen_flash_attention(
                q, k, v, cu_q, cu_k, causal=causal, window_size=window,
                return_lse=True)
            ref, lse_ref = ops.varlen_flash_attention_plain(
                q, k, v, cu_q, cu_k, causal=causal, window_size=window)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)
            torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_paged_int8_matches_plain(cuda, dtype, tol):
    """K2's int8 arm (static (HK,) scales, one given) and its per-row
    mode against their plain versions: groups 1, 4, 7 (in the 8-row
    slot) and 8, head dims 64 and 128. Outputs are compared relative to
    the largest dequantized |v| (up to 128 without a v scale), the scale
    of f32 rounding in a weighted sum of V rows."""
    from paddle_tpu_torch.ops.paged_attention import (
        _paged_decode_attention_rows, _paged_decode_attention_rows_plain)

    g = torch.Generator(device=cuda).manual_seed(3)
    for h, hk in ((32, 32), (32, 8), (28, 4), (16, 2)):
        for d, bs in ((64, 16), (128, 32)):
            lens = torch.tensor([1, 31, 32, 300], dtype=torch.int32,
                                device=cuda)
            w = -(-300 // bs) + 2
            nb = 4 * w + 1
            kp, vp = (torch.randint(-128, 128, (nb, bs, hk, d), generator=g,
                                    device=cuda, dtype=torch.int8)
                      for _ in range(2))
            tables = torch.randperm(nb, device=cuda)[:4 * w].view(4, w).int()
            for i, ln in enumerate(lens.tolist()):
                tables[i, -(-ln // bs):] = 10 ** 6      # never read
            q = _rnd(g, dtype, 4, h, d)
            ks = torch.rand(hk, generator=g, device=cuda) * 0.02 + 0.005
            vs = torch.rand(hk, generator=g, device=cuda) * 0.02 + 0.005
            # raw int8 keys (no k_scale: scale 1) take a smaller query,
            # or the scores reach ~200 and f32 rounding alone moves them
            for kw, qq in ((dict(k_scale=ks, v_scale=vs), q),
                           (dict(v_scale=vs), q * 0.02),
                           (dict(k_scale=ks), q)):
                out = ops.paged_decode_attention(qq, kp, vp, tables, lens,
                                                 **kw)
                assert torch.equal(out, ops.paged_decode_attention(
                    qq, kp, vp, tables, lens, **kw))
                ref = ops.paged_decode_attention_plain(qq, kp, vp, tables,
                                                       lens, **kw)
                vmax = 128 * float(kw.get("v_scale", torch.ones(1)).max())
                torch.testing.assert_close(out.float() / vmax,
                                           ref.float() / vmax, atol=tol,
                                           rtol=tol)
            rks = torch.rand(nb, bs, hk, generator=g, device=cuda) * 0.02
            rvs = torch.rand(nb, bs, hk, generator=g, device=cuda) * 0.02
            out = _paged_decode_attention_rows(q, kp, vp, rks, rvs, tables,
                                               lens)
            assert torch.equal(out, _paged_decode_attention_rows(
                q, kp, vp, rks, rvs, tables, lens))
            ref = _paged_decode_attention_rows_plain(q, kp, vp, rks, rvs,
                                                     tables, lens)
            vmax = 128 * float(rvs.max())
            torch.testing.assert_close(out.float() / vmax, ref.float() / vmax,
                                       atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_paged_float_scaled_matches_plain(cuda, dtype, tol):
    """K2's static-scale mode over float pools (the TPU kernel applies
    (HK,) scales to any pool): both scales, one of them, groups 1, 4 and 7
    (in the 8-row slot), head dims 64 and 128, against the plain version;
    it counts its launches under its own name."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for h, hk in ((32, 32), (32, 8), (28, 4)):
        for d, bs in ((64, 16), (128, 32)):
            lens = torch.tensor([1, 31, 32, 300], dtype=torch.int32,
                                device=cuda)
            w = -(-300 // bs) + 2
            nb = 4 * w + 1
            kp, vp = _rnd(g, dtype, nb, bs, hk, d), _rnd(g, dtype, nb, bs,
                                                         hk, d)
            tables = torch.randperm(nb, device=cuda)[:4 * w].view(4, w).int()
            for i, ln in enumerate(lens.tolist()):
                tables[i, -(-ln // bs):] = 10 ** 6      # never read
            q = _rnd(g, dtype, 4, h, d)
            ks = torch.rand(hk, generator=g, device=cuda) * 1.5 + 0.25
            vs = torch.rand(hk, generator=g, device=cuda) * 1.5 + 0.25
            for kw in (dict(k_scale=ks, v_scale=vs), dict(v_scale=vs),
                       dict(k_scale=ks)):
                ops.reset_launches()
                out = ops.paged_decode_attention(q, kp, vp, tables, lens,
                                                 **kw)
                assert ops.LAUNCHES["paged_decode_attention_scaled"] == 1
                assert ops.LAUNCHES["paged_decode_attention"] == 0
                assert torch.equal(out, ops.paged_decode_attention(
                    q, kp, vp, tables, lens, **kw))
                ref = ops.paged_decode_attention_plain(q, kp, vp, tables,
                                                       lens, **kw)
                vmax = float(kw.get("v_scale", torch.ones(1)).max())
                torch.testing.assert_close(out.float() / vmax,
                                           ref.float() / vmax, atol=tol,
                                           rtol=tol)


@pytest.mark.cuda
def test_cuda_int8_engine_kernel_path_equals_plain_path(cuda):
    """The int8 engine (int8 weights, int8 KV pools) on the card: the
    quantum runs K2's per-row mode and no float K2, and its f32 streams
    equal the plain path's."""
    model = LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=512),
        generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, n).astype(np.int32)
               for n in (5, 40, 3, 77, 18)]
    streams = []
    for plain in (False, True):
        ops.reset_launches()
        engine = create_serving_engine(
            model, num_slots=3, block_size=16, prefill_chunk=32,
            decode_quantum=4, quantize="weight_only_int8", kv_dtype="int8")
        reqs = [engine.submit(p, max_new_tokens=9) for p in prompts]
        if plain:
            with ops.plain_versions():
                engine.run()
            assert all(n == 0 for n in ops.LAUNCHES.values())
        else:
            engine.run()
            assert ops.LAUNCHES["paged_decode_attention_int8_rows"] > 0
            assert ops.LAUNCHES["paged_decode_attention"] == 0
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
def test_cuda_engine_kernel_path_equals_plain_path(cuda):
    model = LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=512),
        generator=torch.Generator(device=cuda).manual_seed(0))
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 512, n).astype(np.int32)
               for n in (5, 40, 3, 77, 18)]
    streams = []
    for plain in (False, True):
        ops.reset_launches()
        engine = create_serving_engine(model, num_slots=3, block_size=16,
                                       prefill_chunk=32, decode_quantum=4)
        reqs = [engine.submit(p, max_new_tokens=9) for p in prompts]
        if plain:
            with ops.plain_versions():
                engine.run()
            assert all(n == 0 for n in ops.LAUNCHES.values())
        else:
            engine.run()
            # an f32 model: K3's f32 forward, never the bf16 one
            assert all(ops.LAUNCHES[k] > 0 for k in (
                "rms_norm", "paged_decode_attention",
                "varlen_flash_attention_f32"))
            assert ops.LAUNCHES["varlen_flash_attention"] == 0
        streams.append([r.tokens for r in reqs])
    assert streams[0] == streams[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_flash_attention_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(1)
    # (B, Sq, Sk, H, HK, D, causal, window): dense, ragged, bottom-right
    # causal, GQA/MQA, a window band, and Sq > Sk (rows with no live key);
    # then shapes across the bf16 kernel's 128-row and 128-key tile edges:
    # Sq 1, 65, 127, 129 and 383, windows 127, 128 and 129, GQA groups 1,
    # 4 and 7 (28 / 4), B = 3, D 64 and 128, Sq < Sk and Sq > Sk
    for b, sq, sk, h, hk, d, causal, window in (
            (2, 128, 128, 4, 2, 64, True, None),
            (2, 100, 100, 4, 4, 128, True, None),
            (1, 64, 1024, 8, 2, 128, True, None),
            (2, 96, 200, 4, 2, 64, False, None),
            (2, 300, 300, 8, 1, 128, True, 17),
            (1, 200, 130, 4, 4, 64, True, None),
            (3, 1, 1, 4, 4, 128, True, None),
            (3, 1, 300, 28, 4, 64, True, 129),
            (3, 65, 65, 28, 4, 64, True, 127),
            (1, 127, 300, 8, 2, 128, True, 128),
            (2, 129, 129, 8, 8, 64, True, 129),
            (3, 383, 383, 28, 4, 128, True, None),
            (1, 383, 383, 8, 2, 128, True, 128),
            (2, 383, 200, 4, 1, 128, True, None),
            (1, 129, 1000, 8, 2, 64, False, None),
            (3, 127, 127, 4, 1, 128, False, None)):
        q = _rnd(g, dtype, b, sq, h, d)
        k, v = _rnd(g, dtype, b, sk, hk, d), _rnd(g, dtype, b, sk, hk, d)
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       window_size=window, return_lse=True)
        ref, lse_ref = ops.flash_attention_plain(q, k, v, causal=causal,
                                                 window_size=window)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_is_deterministic(cuda, dtype):
    """Two calls of the forward (bf16, and the f32 3xTF32 kernel) on the
    same inputs are bit-equal in out and lse (no reduction across CTAs:
    each output is written once), at Llama's dense causal shape and at
    GQA 7 with a window."""
    g = torch.Generator(device=cuda).manual_seed(8)
    for b, s, h, hk, window in ((1, 2048, 32, 32, None),
                                (2, 1000, 28, 4, 129)):
        q = _rnd(g, dtype, b, s, h, 128)
        k, v = (_rnd(g, dtype, b, s, hk, 128) for _ in range(2))
        runs = [ops.flash_attention(q, k, v, causal=True, window_size=window,
                                    return_lse=True) for _ in range(2)]
        for a, c in zip(*runs):
            assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_f32_flash_attention_across_tile_edges(cuda, d):
    """The f32 forward K4 (flash_f32.cuh: 64-row query tiles, 64-key
    tiles, 3xTF32) across its tile edges: Sq 1, 63, 65, 127 and 129,
    windows at the tile width and one off it (63, 64, 65), GQA 7 (28 / 4),
    Sq < Sk and Sq > Sk; exactly one f32 launch a call, no bf16 one."""
    g = torch.Generator(device=cuda).manual_seed(9)
    for b, sq, sk, h, hk, causal, window in (
            (2, 1, 1, 4, 4, True, None),
            (2, 63, 63, 28, 4, True, None),
            (1, 65, 65, 8, 2, True, 63),
            (2, 127, 127, 4, 1, True, 64),
            (1, 129, 129, 28, 4, True, 65),
            (2, 63, 300, 8, 2, True, 65),
            (1, 129, 64, 4, 4, True, None),
            (3, 65, 129, 28, 4, False, None),
            (1, 300, 300, 8, 8, True, 63)):
        q = _rnd(g, torch.float32, b, sq, h, d)
        k, v = (_rnd(g, torch.float32, b, sk, hk, d) for _ in range(2))
        ops.reset_launches()
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       window_size=window, return_lse=True)
        assert ops.LAUNCHES["flash_attention_f32"] == 1
        assert ops.LAUNCHES["flash_attention"] == 0
        ref, lse_ref = ops.flash_attention_plain(q, k, v, causal=causal,
                                                 window_size=window)
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_decode_attention_matches_plain(cuda, dtype, tol):
    g = torch.Generator(device=cuda).manual_seed(2)
    # groups of 4, 1, 7, 5, 6 and 8
    for b, h, hk, d, s_max, lens in ((4, 32, 8, 128, 4096,
                                      [1, 700, 4095, 4096]),
                                     (2, 8, 8, 64, 300, [0, 257]),
                                     (3, 28, 4, 128, 700, [1, 129, 700]),
                                     (2, 10, 2, 64, 300, [300, 5]),
                                     (2, 12, 2, 128, 257, [256, 257]),
                                     (3, 8, 1, 128, 513, [513, 1, 256])):
        q = _rnd(g, dtype, b, h, d)
        kc, vc = (_rnd(g, dtype, b, s_max, hk, d),
                  _rnd(g, dtype, b, s_max, hk, d))
        sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
        out = ops.decode_attention(q, kc, vc, sl)
        assert torch.equal(out, ops.decode_attention(q, kc, vc, sl))
        ref = ops.decode_attention_plain(q, kc, vc, sl)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
    # a bf16 query over f32 caches (greedy_search's caches), 4-D query
    q4 = _rnd(g, torch.bfloat16, b, 1, h, d)
    kc, vc = kc.float(), vc.float()
    out = ops.decode_attention(q4, kc, vc, sl)
    assert out.shape == q4.shape and out.dtype == torch.bfloat16
    torch.testing.assert_close(
        out.float(), ops.decode_attention_plain(q4, kc, vc, sl).float(),
        atol=2e-2, rtol=2e-2)


def _split_lens(stretch, reach):
    """Lens at the decode kernel's split boundaries: 0, 1, a stretch +- 1,
    two stretches + 1 and the table's reach."""
    return [x for x in (0, 1, stretch - 1, stretch, stretch + 1,
                        2 * stretch + 1, reach) if x <= reach]


# (B, H, HK, D, block size, table width): the plan's extremes (one
# sequence and head over 4,096 tokens: 64 stretches of 64; B x HK =
# 2,048: one or two long stretches), then groups 1-8 at D 64 and 128
SPLIT_SHAPES = ([(1, 1, 1, 128, 32, 128), (64, 32, 32, 128, 16, 20)]
                + [(7, 2 * gr, 2, 64 if gr % 2 else 128, 16, 24)
                   for gr in range(1, 9)])


def _paged_call(mode, g, dtype, b, h, hk, d, bs, lens, width):
    """(kernel, plain, vmax) of K2 in ``mode`` over fresh pools: vmax is
    the largest dequantized |v| scale the outputs are compared at."""
    from paddle_tpu_torch.ops.paged_attention import (
        _paged_decode_attention_rows, _paged_decode_attention_rows_plain)

    dev = g.device
    nb = b * width + 1
    int8 = mode.startswith("int8")
    if int8:
        kp, vp = (torch.randint(-128, 128, (nb, bs, hk, d), generator=g,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
    else:
        kp, vp = _rnd(g, dtype, nb, bs, hk, d), _rnd(g, dtype, nb, bs, hk, d)
    tables = torch.randperm(nb, device=dev)[:b * width].view(b, width).int()
    for i, ln in enumerate(lens):
        tables[i, -(-ln // bs):] = 10 ** 6      # stale: never read
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = _rnd(g, dtype, b, h, d)
    if mode == "int8_rows":
        rks, rvs = (torch.rand(nb, bs, hk, generator=g, device=dev) * 0.02
                    + 0.005 for _ in range(2))
        args = (q, kp, vp, rks, rvs, tables, lens)
        return (lambda: _paged_decode_attention_rows(*args),
                lambda: _paged_decode_attention_rows_plain(*args),
                128 * float(rvs.max()))
    kw = {}
    if mode != "float":
        lo, span = (0.005, 0.02) if int8 else (0.25, 1.5)
        kw = {k: torch.rand(hk, generator=g, device=dev) * span + lo
              for k in ("k_scale", "v_scale")}
    vmax = (128 if int8 else 1) * float(kw["v_scale"].max()) if kw else 1.0
    args = (q, kp, vp, tables, lens)
    return (lambda: ops.paged_decode_attention(*args, **kw),
            lambda: ops.paged_decode_attention_plain(*args, **kw), vmax)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float", "scaled", "int8_static",
                                  "int8_rows"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_paged_decode_splits_match_plain(cuda, mode, dtype, tol):
    """K2 in each of its modes at the split plan's extremes, at every
    group of 1-8 query heads with D 64 and 128, and at lens around the
    split boundaries, against its plain version (outputs relative to the
    largest dequantized |v|); two calls are bit-equal."""
    from paddle_tpu_torch.ops import split_decode as SD

    g = torch.Generator(device=cuda).manual_seed(5)
    esize = 1 if mode.startswith("int8") else (4 if dtype == torch.float32
                                               else 2)
    for b, h, hk, d, bs, width in SPLIT_SHAPES:
        reach = width * bs
        st = SD.plan_for(b * hk, reach, 2 * d * esize, cuda).stretch
        base = _split_lens(st, reach)
        lens = [reach] if b == 1 else [base[i % len(base)] for i in range(b)]
        kernel, plain, vmax = _paged_call(mode, g, dtype, b, h, hk, d, bs,
                                          lens, width)
        out = kernel()
        assert torch.equal(out, kernel())
        torch.testing.assert_close(out.float() / vmax,
                                   plain().float() / vmax, atol=tol,
                                   rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_decode_attention_splits_match_plain(cuda, dtype, tol):
    """K5 at the split plan's extremes, at every group of 1-8 query heads
    with D 64 and 128, and at lens around the split boundaries; two calls
    are bit-equal."""
    from paddle_tpu_torch.ops import split_decode as SD

    g = torch.Generator(device=cuda).manual_seed(6)
    esize = 4 if dtype == torch.float32 else 2
    for b, h, hk, d, bs, width in SPLIT_SHAPES:
        s_max = bs * width
        st = SD.plan_for(b * hk, s_max, 2 * d * esize, cuda).stretch
        base = _split_lens(st, s_max)
        lens = [s_max] if b == 1 else [base[i % len(base)] for i in range(b)]
        q = _rnd(g, dtype, b, h, d)
        kc, vc = (_rnd(g, dtype, b, s_max, hk, d),
                  _rnd(g, dtype, b, s_max, hk, d))
        sl = torch.tensor(lens, dtype=torch.int32, device=cuda)
        out = ops.decode_attention(q, kc, vc, sl)
        assert torch.equal(out, ops.decode_attention(q, kc, vc, sl))
        torch.testing.assert_close(
            out.float(), ops.decode_attention_plain(q, kc, vc, sl).float(),
            atol=tol, rtol=tol)


def _decode_call(mode, g, dtype, b, h, hk, d, bs, lens, width):
    """(kernel, plain) of K2 in ``mode`` or, for "contiguous", of K5 over a
    cache of ``bs * width`` positions."""
    if mode != "contiguous":
        return _paged_call(mode, g, dtype, b, h, hk, d, bs, lens, width)[:2]
    s_max = bs * width
    q = _rnd(g, dtype, b, h, d)
    kc, vc = (_rnd(g, dtype, b, s_max, hk, d) for _ in range(2))
    sl = torch.tensor(lens, dtype=torch.int32, device=g.device)
    return (lambda: ops.decode_attention(q, kc, vc, sl),
            lambda: ops.decode_attention_plain(q, kc, vc, sl))


def _tickets_zero():
    from paddle_tpu_torch.ops import split_decode as SD

    torch.cuda.synchronize()
    return all(int(t.abs().sum()) == 0 for t in SD._TICKETS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float", "scaled", "int8_static",
                                  "int8_rows", "contiguous"])
def test_cuda_decode_two_streams_equal_alone(cuda, mode):
    """K2 in each mode and K5 launched on two streams at once, each with
    its own inputs: every result equals, bit for bit, the same call made
    alone (the streams count their merges in tickets of their own), and
    the tickets read zero after."""
    g = torch.Generator(device=cuda).manual_seed(11)
    b, h, hk, d, bs, width = 8, 32, 8, 128, 16, 128
    calls = [_decode_call(mode, g, torch.bfloat16, b, h, hk, d, bs,
                          [bs * width - 9 * i - r for i in range(b)],
                          width)[0] for r in range(2)]
    alone = [c() for c in calls]
    assert _tickets_zero()
    streams = [torch.cuda.Stream(cuda) for _ in calls]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[], []]
    for _ in range(25):
        for i, (c, s) in enumerate(zip(calls, streams)):
            with torch.cuda.stream(s):
                outs[i].append(c())
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        for o in got:
            assert torch.equal(o, want)
    assert _tickets_zero()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float", "contiguous"])
def test_cuda_decode_past_1024_pairs_then_smaller(cuda, mode):
    """K2 and K5 over 2,048 (sequence, KV head) pairs, then fewer, then
    1,280, then 2 again: each against its plain version, the tickets zero
    after each call, and no ticket buffer replaced (the addresses of the
    first round stay those of the second)."""
    from paddle_tpu_torch.ops import split_decode as SD

    g = torch.Generator(device=cuda).manual_seed(12)
    bs, width, d = 16, 20, 128
    addresses = []
    for _ in range(2):
        for b, h, hk in ((64, 32, 32), (4, 8, 2), (40, 32, 32), (1, 4, 2)):
            lens = [(37 * i) % (bs * width) + 1 for i in range(b)]
            kernel, plain = _decode_call(mode, g, torch.float32, b, h, hk,
                                         d, bs, lens, width)
            torch.testing.assert_close(kernel(), plain(), atol=1e-5,
                                       rtol=1e-5)
            assert _tickets_zero()
        addresses.append({k: t.data_ptr() for k, t in SD._TICKETS.items()})
    assert addresses[0] == addresses[1]


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24])
def test_cuda_generate_kernel_path_equals_plain_path(cuda, window):
    from paddle_tpu_torch.nlp.generation import generate

    model = LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=512,
                         sliding_window=window),
        generator=torch.Generator(device=cuda).manual_seed(0))
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(1, 512, (3, 40))).to(cuda)
    streams = []
    for plain in (False, True):
        ops.reset_launches()
        if plain:
            with ops.plain_versions():
                streams.append(generate(model, ids, max_new_tokens=12))
            assert all(n == 0 for n in ops.LAUNCHES.values())
        else:
            streams.append(generate(model, ids, max_new_tokens=12))
            assert ops.LAUNCHES["flash_attention_f32"] == (2 if window
                                                           else 0)
            assert ops.LAUNCHES["flash_attention"] == 0
            assert ops.LAUNCHES["decode_attention"] == 2 * 11
    assert torch.equal(streams[0], streams[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_rms_norm_backward_matches_plain(cuda, dtype, tol):
    """K6 at the training shapes (Llama-2-7B's 4,096 and the packed 941M
    row's 2,048 over 4,096 rows), the 3B, 13B and 70B widths, one row, rows
    below the plan's partial count, widths off the vector path (100 in
    bf16, 16,384) and a misaligned x and dy (the general kernel); two calls
    give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(3)
    for rows, n, offset in ((37, 4096, 0), (3, 64, 0), (5, 100, 0),
                            (1000, 512, 0), (4096, 4096, 0), (4096, 2048, 0),
                            (64, 5120, 0), (64, 8192, 0), (1, 4096, 0),
                            (100, 4096, 0), (37, 4096, 1), (300, 3072, 0),
                            (7, 16384, 0)):
        def rnd(*shape):
            flat = _rnd(g, dtype, offset + int(np.prod(shape)))
            return flat[offset:].view(*shape)

        x, w, dy = rnd(rows, n), _rnd(g, dtype, n), rnd(rows, n)
        _, r = ops.rms_norm(x, w, return_rstd=True)
        dx, dw = ops.rms_norm_bwd(x, w, r, dy)
        dx_ref, dw_ref = ops.rms_norm_bwd_plain(x, w, r, dy)
        torch.testing.assert_close(dx.float(), dx_ref.float(), atol=tol,
                                   rtol=tol)
        # dw sums ``rows`` terms: the tolerance scales with the sum
        scale = float(dw_ref.float().abs().max())
        torch.testing.assert_close(dw.float(), dw_ref.float(),
                                   atol=tol * scale, rtol=tol)
        dx2, dw2 = ops.rms_norm_bwd(x, w, r, dy)
        assert torch.equal(dx, dx2) and torch.equal(dw, dw2), (rows, n)


@pytest.mark.cuda
def test_cuda_rms_norm_backward_plan_fits_the_card(cuda):
    """K6's host plan assumes ``per_sm`` row CTAs an SM: the card holds at
    least that many of the kernel instance it picks (registers and shared
    memory as ptxas compiled them), at the Llama widths in both dtypes."""
    from paddle_tpu_torch.ops import _library as lib
    R = sys.modules["paddle_tpu_torch.ops.rms_norm"]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for elem, dtype in ((4, 0), (2, 1)):
        for n in (2048, 4096, 5120, 8192):
            plan = R.bwd_plan(4096, n, elem, True, sms)
            assert plan.vpt, plan
            fit = lib.library().ptt_rms_norm_bwd_fit(
                n, plan.threads, plan.vpt, dtype)
            assert fit >= plan.per_sm, (plan, fit)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_rms_norm_forward_training_rows(cuda, dtype, tol):
    """K1 at the training path's 4,096 rows (past the L2 in both dtypes):
    equal to its plain version, the same bits twice."""
    g = torch.Generator(device=cuda).manual_seed(4)
    for n in (4096, 2048):
        x, w = _rnd(g, dtype, 4096, n), _rnd(g, dtype, n)
        y, r = ops.rms_norm(x, w, return_rstd=True)
        y_ref, r_ref = ops.rms_norm_plain(x, w)
        torch.testing.assert_close(y.float(), y_ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(r, r_ref, atol=1e-5, rtol=1e-5)
        y2, r2 = ops.rms_norm(x, w, return_rstd=True)
        assert torch.equal(y, y2) and torch.equal(r, r2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_flash_attention_backward_matches_plain(cuda, dtype, tol):
    """One launch of the fused K7 for dq, dk and dv: the wgmma kernel in
    bf16, the 3xTF32 one in f32."""
    g = torch.Generator(device=cuda).manual_seed(4)
    # (B, Sq, Sk, H, HK, D, causal, window): GQA groups 1, 4 and 7 at D 64
    # and 128, a window band, ragged lengths, bottom-right causal (Sq <
    # Sk), Sq > Sk (query tiles no key tile reaches), not causal, and the
    # training shape (Llama-2-7B width, S = 4,096)
    for b, sq, sk, h, hk, d, causal, window in (
            (2, 128, 128, 4, 4, 64, True, None),
            (2, 100, 100, 8, 2, 128, True, None),
            (1, 190, 190, 7, 1, 128, True, None),
            (1, 333, 333, 7, 1, 64, True, None),
            (2, 96, 200, 4, 2, 64, False, None),
            (1, 260, 390, 8, 2, 128, False, None),
            (1, 300, 300, 8, 2, 128, True, 17),
            (1, 640, 640, 8, 2, 64, True, 200),
            (1, 64, 1024, 8, 2, 128, True, None),
            (1, 200, 130, 4, 4, 64, True, None),
            (1, 400, 70, 4, 1, 128, True, None),
            (1, 4096, 4096, 32, 32, 128, True, None)):
        ops.reset_launches()
        q = _rnd(g, dtype, b, sq, h, d)
        k, v = _rnd(g, dtype, b, sk, hk, d), _rnd(g, dtype, b, sk, hk, d)
        do = _rnd(g, dtype, b, sq, h, d)
        out, lse = ops.flash_attention(q, k, v, causal=causal,
                                       window_size=window, return_lse=True)
        got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal,
                                      window_size=window)
        want = ops.flash_attention_bwd_plain(q, k, v, out, lse, do, causal,
                                             window_size=window)
        bf16 = dtype == torch.bfloat16
        assert ops.LAUNCHES["flash_attention_bwd"] == int(bf16)
        assert ops.LAUNCHES["flash_attention_bwd_f32"] == int(not bf16)
        for a, ref in zip(got, want):
            assert a.dtype == dtype and a.shape == ref.shape
            scale = max(1.0, float(ref.float().abs().max()))
            torch.testing.assert_close(a.float(), ref.float(),
                                       atol=tol * scale, rtol=tol)
        # the public parts return the same values
        delta = ops.flash_attention_bwd_delta(out, do)
        args = (q, k, v, do, lse, delta, causal)
        dq = ops.flash_attention_bwd_dq(*args, window_size=window)
        dk, dv = ops.flash_attention_bwd_dkv(*args, window_size=window)
        for a, ref in zip((dq, dk, dv), got):
            assert torch.equal(a, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_attention_backward_is_deterministic(cuda, dtype):
    """Two calls of the fused backward (bf16 or f32) on the same inputs
    are bit-equal in dq, dk and dv: its dq adds across CTAs land in a
    fixed order (at the training shape, and at GQA 4 with a window)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    for b, s, h, hk, window in ((1, 4096, 32, 32, None),
                                (1, 2304, 32, 8, 1024)):
        q, do = (_rnd(g, dtype, b, s, h, 128) for _ in range(2))
        k, v = (_rnd(g, dtype, b, s, hk, 128) for _ in range(2))
        out, lse = ops.flash_attention(q, k, v, causal=True,
                                       window_size=window, return_lse=True)
        runs = [ops.flash_attention_bwd(q, k, v, out, lse, do, True,
                                        window_size=window)
                for _ in range(2)]
        for a, c in zip(*runs):
            assert torch.equal(a, c)


@pytest.mark.cuda
def test_cuda_wrappers_carry_a_grad_fn_or_refuse(cuda):
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    w = torch.ones(64, device=cuda, requires_grad=True)
    assert F.rms_norm(x, w).grad_fn is not None
    q = torch.randn(1, 32, 4, 64, device=cuda, requires_grad=True)
    kv = torch.randn(1, 32, 2, 64, device=cuda, requires_grad=True)
    out = F.scaled_dot_product_attention(q, kv, kv, is_causal=True)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and kv.grad is not None
    lens = torch.tensor([5], dtype=torch.int32, device=cuda)
    qd = torch.randn(1, 4, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="inference-only"):
        ops.decode_attention(qd, kv.detach(), kv.detach(), lens)
    cu = torch.tensor([0, 32], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError,
                       match="VarlenFlashAttentionFunction"):
        ops.varlen_flash_attention(q[0], kv[0], kv[0], cu, cu, causal=True)
    out, _ = F.flash_attn_unpadded(q[0], kv[0], kv[0], cu, cu, 32, 32,
                                   0.125, causal=True)
    assert out.grad_fn is not None
    pool = torch.randn(3, 16, 2, 64, device=cuda, requires_grad=True)
    tables = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    with pytest.raises(NotImplementedError, match="inference-only"):
        ops.paged_decode_attention(qd.detach(), pool, pool, tables, lens)
    with torch.no_grad():
        ops.decode_attention(qd, kv.detach(), kv.detach(), lens)


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_cuda_train_step_kernel_path_equals_plain_path(cuda, fuse):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, vocab_size=512,
                           tensor_parallel=False,
                           fuse_linear_cross_entropy=fuse, lce_chunk_rows=48)
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 512, (2, 96))).to(cuda)
    runs = []
    for plain in (False, True):
        model = LlamaForCausalLM(
            cfg, generator=torch.Generator(device=cuda).manual_seed(0))
        crit = LlamaPretrainingCriterion(
            cfg, lm_head=model.lm_head if fuse else None)
        step = JittedTrainStep(model, crit,
                               AdamW(1e-3, parameters=model.parameters()))
        ops.reset_launches()
        if plain:
            with ops.plain_versions():
                losses = [step(ids, ids) for _ in range(3)]
            assert all(n == 0 for n in ops.LAUNCHES.values())
        else:
            losses = [step(ids, ids) for _ in range(3)]
            # f32: one launch of the f32 forward K4 and of the f32 fused
            # K7 per layer and step, never the bf16 kernels
            want = {"rms_norm": 15, "flash_attention_f32": 6,
                    "flash_attention": 0,
                    "rms_norm_bwd": 15, "flash_attention_bwd": 0,
                    "flash_attention_bwd_f32": 6}
            assert {k: ops.LAUNCHES[k] for k in want} == want
        runs.append((torch.stack(losses), [p.detach().clone()
                                           for p in step.params]))
    torch.testing.assert_close(runs[0][0], runs[1][0], rtol=1e-5, atol=0)
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=6e-3)


def _cu(lens, device):
    return torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                        dtype=torch.int32, device=device)


class _Packed(torch.nn.Module):
    """``model(ids, cu)``: the packed call as a train step makes it."""

    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, ids, cu):
        return self.m(ids, cu_seqlens=cu)


# (lens_q, lens_k or None, H, HK, causal, window, padding rows): query
# tiles straddling two segments and segments shorter than a tile, empty
# segments, cross lengths (causal and not), a window over cross lengths,
# a window with a GQA group of 8, rows without keys and padding rows, and
# the serving mix (128-token chunks over cached contexts)
VARLEN_CASES = (
    ([13, 37, 1, 77, 150], None, 4, 2, True, None, 0),
    ([200, 0, 130, 64, 1, 0], None, 4, 4, True, None, 0),
    ([9, 25, 140], [17, 125, 61], 4, 4, True, None, 0),
    ([9, 25, 140], [17, 125, 61], 4, 4, False, None, 0),
    ([90, 25, 140, 0], [17, 125, 61, 30], 8, 2, True, 20, 0),
    ([300, 70, 190], None, 8, 1, True, 48, 0),
    ([6, 10, 12], [9, 0, 4], 4, 2, True, None, 5),
    ([128, 128, 128], [128, 320, 1000], 4, 4, True, None, 0),
    # windows one off the 64-key tile, GQA 7 (28 / 4)
    ([63, 65, 129, 1], None, 28, 4, True, 65, 0),
    ([64, 127, 200], None, 8, 2, True, 63, 0),
)


@pytest.mark.cuda
@pytest.mark.parametrize("d", range(16, 129, 16))
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_varlen_forward_matches_plain_every_head_dim(cuda, dtype, tol,
                                                          d):
    """K3 at every head dim it takes (d % 16 == 0 up to 128: the bf16 path
    zero-fills a narrower head to its padded width 64 or 128) over the
    segment layouts of VARLEN_CASES; rows that see no key are zeros."""
    g = torch.Generator(device=cuda).manual_seed(d)
    for lens_q, lens_k, h, hk, causal, window, pad in VARLEN_CASES:
        cu_q = _cu(lens_q, cuda)
        cu_k = cu_q if lens_k is None else _cu(lens_k, cuda)
        tq, tk = int(cu_q[-1]) + pad, int(cu_k[-1])
        q = _rnd(g, dtype, tq, h, d)
        k, v = _rnd(g, dtype, tk, hk, d), _rnd(g, dtype, tk, hk, d)
        ops.reset_launches()
        out, lse = ops.varlen_flash_attention(
            q, k, v, cu_q, cu_k, causal=causal, window_size=window,
            return_lse=True)
        f32 = dtype == torch.float32
        assert ops.LAUNCHES["varlen_flash_attention_f32"] == int(f32)
        assert ops.LAUNCHES["varlen_flash_attention"] == int(not f32)
        ref, lse_ref = ops.varlen_flash_attention_plain(
            q, k, v, cu_q, cu_k, causal=causal, window_size=window)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=1e-4)
        if pad:
            assert float(out[int(cu_q[-1]):].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_cuda_varlen_forward_past_65535_query_tiles(cuda, dtype, tol):
    """K3 over 65,600 causal 64-token segments (4.2M query rows, 65,600
    query tiles: more than a grid's y dimension and more than the tile
    order kernel ranks in shared memory, which then keeps the packing
    order) equals one batched causal SDPA call over the segments."""
    g = torch.Generator(device=cuda).manual_seed(7)
    nseg, n, d = 65600, 64, 16
    cu = torch.arange(0, (nseg + 1) * n, n, dtype=torch.int32, device=cuda)
    q, k, v = (_rnd(g, dtype, nseg * n, 1, d) for _ in range(3))
    out = ops.varlen_flash_attention(q, k, v, cu, cu, causal=True)
    seg = [t.view(nseg, n, d).float() for t in (q, k, v)]
    ref = torch.nn.functional.scaled_dot_product_attention(*seg,
                                                           is_causal=True)
    torch.testing.assert_close(out.view(nseg, n, d).float(), ref, atol=tol,
                               rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_varlen_kernels_are_deterministic(cuda, dtype):
    """Two calls of K3 (out, lse) and of the backward (dq, dk, dv: K8,
    whose dq adds across CTAs land in a fixed order in bf16 and in f32)
    on the same inputs are bit-equal (no free atomics: recompute relies on
    it), at the packed 941M row's segments with a GQA group of 4."""
    g = torch.Generator(device=cuda).manual_seed(6)
    cu = _cu([1600, 800, 600, 400, 300, 200, 120, 76], cuda)
    t = int(cu[-1])
    q, do = _rnd(g, dtype, t, 8, 64), _rnd(g, dtype, t, 8, 64)
    k, v = _rnd(g, dtype, t, 2, 64), _rnd(g, dtype, t, 2, 64)
    runs = []
    for _ in range(2):
        out, lse = ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                              return_lse=True)
        runs.append((out, lse) + ops.varlen_flash_attention_bwd(
            q, k, v, out, lse, do, cu, cu, True))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# chip_smoke's K8 shapes: (lens_q, lens_k or None, H, HK, window) at the
# packed 941M row, GQA with a window, cross lengths and empty segments
K8_SHAPES = {
    "packed_941m": ([1600, 800, 600, 400, 300, 200, 120, 76], None, 32, 32,
                    None),
    "gqa_window": ([1600, 800, 600, 400, 300, 200, 120, 76], None, 32, 8,
                   512),
    "cross_lengths": ([1024, 512, 300, 76], [1600, 512, 700, 76], 32, 32,
                      None),
    "empty_segments": ([1600, 0, 800, 600, 0, 400, 300, 200, 120, 76, 0],
                       None, 32, 32, None),
}


def _close_k8(a, ref, dtype):
    """bf16: chip_smoke's tolerance for kernels that round P and dS to
    bf16 before a product (``close(..., p_rounded=True)``: one bf16
    rounding step plus 1e-2); f32: 1e-4 of the largest |g| and 1e-4
    relative (the f32 backward tests' tolerance)."""
    assert a.dtype == dtype and a.shape == ref.shape
    if dtype == torch.bfloat16:
        torch.testing.assert_close(a.float(), ref.float(), atol=1e-2,
                                   rtol=2.0 ** -7)
    else:
        scale = max(1.0, float(ref.abs().max()))
        torch.testing.assert_close(a, ref, atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("shape", list(K8_SHAPES))
def test_cuda_varlen_fused_backward_matches_plain(cuda, shape, d, dtype):
    """K8 against the plain backward at chip_smoke's shapes, in bf16 (the
    wgmma kernel) and f32 (the 3xTF32 one): one launch for dq, dk and
    dv."""
    lens_q, lens_k, h, hk, window = K8_SHAPES[shape]
    g = torch.Generator(device=cuda).manual_seed(8)
    cu_q = _cu(lens_q, cuda)
    cu_k = cu_q if lens_k is None else _cu(lens_k, cuda)
    tq, tk = int(cu_q[-1]), int(cu_k[-1])
    q, do = (_rnd(g, dtype, tq, h, d) for _ in range(2))
    k, v = (_rnd(g, dtype, tk, hk, d) for _ in range(2))
    out, lse = ops.varlen_flash_attention(q, k, v, cu_q, cu_k, causal=True,
                                          window_size=window,
                                          return_lse=True)
    delta = ops.varlen_flash_attention_bwd_delta(out, do)
    ops.reset_launches()
    got = ops.varlen_flash_attention_bwd_fused(
        q, k, v, do, lse, delta, cu_q, cu_k, True, window_size=window)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert ops.LAUNCHES["varlen_flash_attention_bwd"] == int(not f32)
    assert ops.LAUNCHES["varlen_flash_attention_bwd_f32"] == int(f32)
    want = ops.varlen_flash_attention_bwd_plain(
        q, k, v, out, lse, do, cu_q, cu_k, True, window_size=window,
        delta=delta)
    for a, ref in zip(got, want):
        _close_k8(a, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_varlen_fused_backward_many_short_segments(cuda, d, dtype):
    """K8 over 1,500 segments of 0-8 tokens (several in one query tile,
    empty ones among them), GQA 4/2, causal and with a window of 3,
    against the plain backward with the fused test's tolerance."""
    g = torch.Generator(device=cuda).manual_seed(10)
    lens = np.random.default_rng(10).integers(0, 9, size=1500)
    cu = _cu(lens, cuda)
    t = int(cu[-1])
    q, do = (_rnd(g, dtype, t, 4, d) for _ in range(2))
    k, v = (_rnd(g, dtype, t, 2, d) for _ in range(2))
    for window in (None, 3):
        out, lse = ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                              window_size=window,
                                              return_lse=True)
        delta = ops.varlen_flash_attention_bwd_delta(out, do)
        got = ops.varlen_flash_attention_bwd_fused(
            q, k, v, do, lse, delta, cu, cu, True, window_size=window)
        want = ops.varlen_flash_attention_bwd_plain(
            q, k, v, out, lse, do, cu, cu, True, window_size=window,
            delta=delta)
        for a, ref in zip(got, want):
            _close_k8(a, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_varlen_fused_backward_zeroes_rows_without_keys(cuda, dtype):
    """K8 writes dq = 0 on rows that see no key and on padding rows past
    cu_q[-1], also where a whole query tile has no key tile to add to it
    (a segment without keys, more queries than keys, 100 padding rows),
    into a dq whose memory held NaNs before."""
    g = torch.Generator(device=cuda).manual_seed(9)
    lens_q, lens_k, pad = [6, 130, 12, 70], [9, 0, 4, 20], 100
    cu_q, cu_k = _cu(lens_q, cuda), _cu(lens_k, cuda)
    tq, tk = int(cu_q[-1]) + pad, int(cu_k[-1])
    q, do = (_rnd(g, dtype, tq, 4, 64) for _ in range(2))
    k, v = (_rnd(g, dtype, tk, 2, 64) for _ in range(2))
    out, lse = ops.varlen_flash_attention(q, k, v, cu_q, cu_k, causal=True,
                                          return_lse=True)
    delta = ops.varlen_flash_attention_bwd_delta(out, do)
    # the allocator hands the freed NaN block to the kernel's dq
    torch.full_like(q, float("nan"))
    dq, dk, dv = ops.varlen_flash_attention_bwd_fused(
        q, k, v, do, lse, delta, cu_q, cu_k, True)
    sees = segment_mask(cu_q, cu_k, tq, tk, True).any(1)
    assert not sees[6:136].any() and not sees[-pad:].any()
    assert float(dq[~sees].float().abs().max()) == 0.0
    want = ops.varlen_flash_attention_bwd_plain(
        q, k, v, out, lse, do, cu_q, cu_k, True, delta=delta)
    for a, ref in zip((dq, dk, dv), want):
        assert torch.isfinite(a).all()
        _close_k8(a, ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_cuda_varlen_backward_matches_plain(cuda, dtype, tol):
    """One launch of the fused K8 for dq, dk and dv: the wgmma kernel in
    bf16, the 3xTF32 one in f32."""
    g = torch.Generator(device=cuda).manual_seed(5)
    # (lens_q, lens_k or None, H, HK, D, causal, window, padding rows):
    # ragged GQA, empty segments at D=128, cross lengths (causal and not),
    # a window band with a group of 8 (also over cross lengths), and rows
    # that see no key (a segment without keys, more queries than keys,
    # padding past cu[-1]), a walk over many live query tiles of a group
    # of 4, and key tiles dead inside a query tile's key range (a segment
    # without queries; a window behind more keys than queries)
    for lens_q, lens_k, h, hk, d, causal, window, pad in (
            ([13, 37, 1, 77], None, 4, 2, 64, True, None, 0),
            ([700, 300, 5], None, 8, 2, 64, True, None, 0),
            ([200, 0, 130, 64, 1, 0], None, 8, 2, 128, True, None, 0),
            ([9, 25, 140], [17, 125, 61], 4, 4, 64, True, None, 0),
            ([9, 25, 140], [17, 125, 61], 4, 4, 64, False, None, 0),
            ([90, 25, 140, 0], [17, 125, 61, 30], 8, 2, 64, True, 20, 0),
            ([300, 70, 190], None, 8, 1, 128, True, 48, 0),
            ([6, 10, 12], [9, 0, 4], 4, 2, 64, True, None, 5),
            ([100, 0, 100, 60], [100, 300, 100, 60], 4, 2, 128, True, None,
             0),
            ([40, 100], [40, 1000], 4, 2, 64, True, 64, 0)):
        cu_q = _cu(lens_q, cuda)
        cu_k = cu_q if lens_k is None else _cu(lens_k, cuda)
        tq, tk = int(cu_q[-1]) + pad, int(cu_k[-1])
        q, do = _rnd(g, dtype, tq, h, d), _rnd(g, dtype, tq, h, d)
        k, v = _rnd(g, dtype, tk, hk, d), _rnd(g, dtype, tk, hk, d)
        out, lse = ops.varlen_flash_attention(
            q, k, v, cu_q, cu_k, causal=causal, window_size=window,
            return_lse=True)
        # the forward K3 on the same rows: padding rows past cu_q[-1] and
        # rows without keys see nothing in both
        ref_out, ref_lse = ops.varlen_flash_attention_plain(
            q, k, v, cu_q, cu_k, causal=causal, window_size=window)
        torch.testing.assert_close(out.float(), ref_out.float(), atol=tol,
                                   rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-4)
        ops.reset_launches()
        got = ops.varlen_flash_attention_bwd(q, k, v, out, lse, do, cu_q,
                                             cu_k, causal,
                                             window_size=window)
        bf16 = dtype == torch.bfloat16
        assert ops.LAUNCHES["varlen_flash_attention_bwd"] == int(bf16)
        assert ops.LAUNCHES["varlen_flash_attention_bwd_f32"] == \
            int(not bf16)
        want = ops.varlen_flash_attention_bwd_plain(
            q, k, v, out, lse, do, cu_q, cu_k, causal, window_size=window)
        # the public dk / dv part on its own, from the same lse and delta
        delta = ops.varlen_flash_attention_bwd_delta(out, do)
        dkv = ops.varlen_flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, cu_q, cu_k, causal, window_size=window)
        for a, ref in zip(got + dkv, want + want[1:]):
            assert a.dtype == dtype and a.shape == ref.shape
            assert torch.isfinite(a).all()
            scale = max(1.0, float(ref.float().abs().max()))
            torch.testing.assert_close(a.float(), ref.float(),
                                       atol=tol * scale, rtol=tol)
        if pad:
            assert float(got[0][int(cu_q[-1]):].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [False, True])
def test_cuda_packed_train_step_kernel_path_equals_plain_path(cuda,
                                                               recompute):
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, vocab_size=512,
                           tensor_parallel=False, use_recompute=recompute)
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(0, 512, (1, 96))).to(cuda)
    cu = _cu([40, 0, 30, 26], cuda)
    runs = []
    for plain in (False, True):
        model = _Packed(LlamaForCausalLM(
            cfg, generator=torch.Generator(device=cuda).manual_seed(0)))
        crit = LlamaPretrainingCriterion(cfg)
        step = JittedTrainStep(
            model, lambda out, lb: crit(out, lb, cu_seqlens=cu),
            AdamW(1e-3, parameters=model.parameters()))
        ops.reset_launches()
        if plain:
            with ops.plain_versions():
                losses = [step([ids, cu], ids) for _ in range(3)]
            assert all(n == 0 for n in ops.LAUNCHES.values())
        else:
            losses = [step([ids, cu], ids) for _ in range(3)]
            # 2 layers: forward K1 5 and the f32 K3 2 per step, again for
            # the recomputed blocks; backward K6 5 and the f32 K8 2, never
            # the bf16 K3 or K8
            fwd = 2 if recompute else 1
            want = {"rms_norm": 15 + 12 * (fwd - 1),
                    "varlen_flash_attention_f32": 6 * fwd,
                    "varlen_flash_attention": 0,
                    "rms_norm_bwd": 15, "varlen_flash_attention_bwd_f32": 6,
                    "varlen_flash_attention_bwd": 0,
                    "flash_attention": 0}
            assert {k: ops.LAUNCHES[k] for k in want} == want
        runs.append(torch.stack(losses))
    torch.testing.assert_close(runs[0], runs[1], rtol=1e-5, atol=0)


# ------------------------------------------------ captured decode graphs
def _tiny_cuda_model(cuda, dtype="float32"):
    return LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=512, dtype=dtype),
        generator=torch.Generator(device=cuda).manual_seed(0))


_GRAPH_PROMPTS = [np.random.RandomState(0).randint(1, 512, n).astype(np.int32)
                  for n in (5, 40, 3, 77, 18)]
_GRAPH_KW = dict(num_slots=3, block_size=16, prefill_chunk=32,
                 decode_quantum=4)


def _graph_run(model, eager, **kw):
    engine = create_serving_engine(model, **_GRAPH_KW, **kw)
    engine._eager = eager
    reqs = [engine.submit(p, max_new_tokens=9 + i, seed=i)
            for i, p in enumerate(_GRAPH_PROMPTS)]
    ops.reset_launches()
    engine.run()
    return engine, [r.tokens for r in reqs], dict(ops.LAUNCHES)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["greedy", "sampling", "per_request",
                                 "int8", "k3", "fused_bf16"])
def test_cuda_captured_quantum_equals_eager(cuda, arm):
    """The decode quantum as a captured CUDA graph against the same body
    run eagerly: equal streams, equal counters and equal launch counts
    (each replay adds the launches its capture recorded), for greedy,
    sampling (engine-wide and per-request), int8 weights and KV, three
    quanta per dispatch, and bf16 pools with attn_impl='fused'."""
    kw = {"greedy": {},
          "sampling": dict(decode_strategy="sampling", top_k=50, top_p=0.9,
                           temperature=0.8),
          "per_request": dict(decode_strategy="sampling", top_k=50,
                              per_request_sampling=True),
          "int8": dict(quantize="weight_only_int8", kv_dtype="int8"),
          "k3": dict(multi_quantum=3),
          "fused_bf16": dict(attn_impl="fused")}[arm]
    model = _tiny_cuda_model(cuda, "bfloat16" if arm == "fused_bf16"
                             else "float32")
    runs = [_graph_run(model, eager, **kw) for eager in (True, False)]
    (eager_eng, eager_streams, eager_l), (eng, streams, launches) = runs
    assert eager_eng._graph is None and eng._graph is not None
    assert streams == eager_streams
    assert launches == eager_l
    k2 = ("paged_decode_attention_int8_rows" if arm == "int8"
          else "paged_decode_attention")
    layers, t = model.config.num_hidden_layers, _GRAPH_KW["decode_quantum"]
    assert eng._graph.launches == {"rms_norm": (2 * layers + 1) * t,
                                   k2: layers * t}
    for key in ("steps", "mixed_steps", "decode_quanta", "quantum_tokens"):
        assert eng.stats[key] == eager_eng.stats[key], key
    if arm == "k3":
        assert eng.stats["decode_quanta"] > eng.stats["steps"] - \
            eng.stats["mixed_steps"]


@pytest.mark.cuda
def test_cuda_quantum_captures_on_its_own_stream_after_the_ticket_warm_up(
        cuda):
    """The graph is captured on a fresh side stream, after the warm-up
    quantum made K2's ticket buffer of that stream: the buffer exists,
    keyed by the capture stream, and replays leave it zero."""
    from paddle_tpu_torch.ops import split_decode as SD

    model = _tiny_cuda_model(cuda)
    engine, streams, _ = _graph_run(model, eager=False)
    stream = engine._graph.stream
    assert stream.cuda_stream != torch.cuda.current_stream().cuda_stream
    keys = [k for k in SD._TICKETS if k[1] == stream.cuda_stream]
    assert keys, "no ticket buffer was made for the capture stream"
    torch.cuda.synchronize()
    assert all(int(SD._TICKETS[k].abs().sum()) == 0 for k in keys)
    assert engine.stats["decode_quanta"] > 1   # replays ran
    assert streams == _graph_run(model, eager=True)[1]


@pytest.mark.cuda
def test_cuda_replays_are_counted_once_each(cuda):
    """ops.LAUNCHES counts at Python call time; a replay adds its graph's
    launches once, the capture itself adds none."""
    model = _tiny_cuda_model(cuda)
    engine = create_serving_engine(model, **_GRAPH_KW)
    for p in _GRAPH_PROMPTS[:3]:
        engine.submit(p, max_new_tokens=30)
    while engine.scheduler.prefilling() or engine.scheduler.waiting:
        engine.step()
    ops.reset_launches()
    engine.step()                       # warm-up quantum + capture
    first = dict(ops.LAUNCHES)
    per_quantum = engine._graph.launches
    assert first == {k: per_quantum.get(k, 0) for k in first}
    ops.reset_launches()
    engine.step()                       # one replay
    assert dict(ops.LAUNCHES) == first


_CAPTURE_FAILURE = """
import sys
import numpy as np
import torch
sys.path.insert(0, {root!r})
from paddle_tpu_torch import create_serving_engine
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

model = LlamaForCausalLM(
    LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                     num_key_value_heads=2, vocab_size=512),
    generator=torch.Generator(device="cuda").manual_seed(0))
engine = create_serving_engine(model, num_slots=3, block_size=16,
                               prefill_chunk=32, decode_quantum=4)
select = engine._select

def syncing(logits, slots, steps):
    steps.sum().item()      # a host sync: refused while the stream captures
    return select(logits, slots, steps)

engine._select = syncing
engine.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=20)
try:
    engine.run()
    print("NO-RAISE")
except RuntimeError:
    assert engine._graph is None and engine._graph_error is not None
    torch.cuda.synchronize()
    try:
        engine.step()
        print("DECODED-AFTER-FAILURE")
    except RuntimeError as exc:
        print("REFUSED:", exc)
"""


@pytest.mark.cuda
def test_cuda_capture_failure_raises_without_eager_fallback(cuda):
    """A host sync inside the quantum makes the capture fail: the step
    raises, and the engine refuses to decode afterwards instead of
    running the body eagerly. In a child process: a failed capture leaves
    PyTorch's default CUDA generator marked as capturing, so later random
    draws in the same process raise."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c",
                          _CAPTURE_FAILURE.format(root=root)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "REFUSED:" in out.stdout and "failed to capture" in out.stdout, \
        out.stdout[-2000:]


@pytest.mark.cuda
def test_cuda_replay_refuses_reallocated_pools(cuda):
    model = _tiny_cuda_model(cuda)
    engine = create_serving_engine(model, **_GRAPH_KW)
    engine.submit(_GRAPH_PROMPTS[0], max_new_tokens=30)
    while engine._graph is None:
        engine.step()
    engine.pool.k_pools[0] = engine.pool.k_pools[0].clone()
    with pytest.raises(RuntimeError, match="reallocated"):
        engine.step()


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24])
def test_cuda_captured_generate_equals_eager(cuda, window, monkeypatch):
    """generate's decode step as a captured graph against the eager step:
    greedy and sampling, on a windowed model past its window; the launch
    counts are those of every step run eagerly. A second call with the
    same key only replays the kept graph, with the same stream and
    counts."""
    from paddle_tpu_torch.nlp import generation as G

    model = LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=512,
                         sliding_window=window),
        generator=torch.Generator(device=cuda).manual_seed(0))
    ids = torch.from_numpy(
        np.random.RandomState(1).randint(1, 512, (3, 40))).to(cuda)
    for kw in (dict(), dict(decode_strategy="sampling", top_k=20,
                            temperature=0.7, seed=3)):
        runs, kept = [], []
        for eager in (True, False, False):
            monkeypatch.setattr(G, "_EAGER", eager)
            ops.reset_launches()
            runs.append((G.generate(model, ids, max_new_tokens=30,
                                    eos_token_id=7, **kw),
                         dict(ops.LAUNCHES)))
            kept.append(G._STEPS.get(model))
        assert torch.equal(runs[0][0], runs[1][0])
        assert torch.equal(runs[0][0], runs[2][0])
        assert runs[0][1] == runs[1][1] == runs[2][1]
        assert runs[1][1]["decode_attention"] == 2 * 29
        assert kept[1] is kept[2] and kept[1].graph.graph is not None
