"""The port's CUDA kernels on the card: each kernel against its plain
PyTorch version, and the serving engine's, ``generate``'s and the training
step's kernel paths against their plain paths. Skips where no CUDA device is present (a CUDA kernel has no CPU
mode). Imports neither jax nor paddle_tpu, so on a machine with a GPU and
no JAX it runs without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: f32 ``1e-5`` (summation order only, full-f32 products), bf16
``2e-2`` (about two bf16 rounding steps at |x| ~ 1), fp16 ``4e-3`` (about
four fp16 steps; a probability on a rounding boundary may round one step
apart); engine streams in f32 must be equal.
"""
import sys
import warnings

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
                                       (torch.bfloat16, 2e-2),
                                       (torch.float16, 4e-3)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
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
                                       (torch.bfloat16, 3e-2),
                                       (torch.float16, 6e-3)])
def test_cuda_flash_attention_backward_matches_plain(cuda, dtype, tol):
    """One launch of the fused K7 for dq, dk and dv: the wgmma kernel in
    bf16 and fp16, the 3xTF32 one in f32."""
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
        for name, dt in (("flash_attention_bwd", torch.bfloat16),
                         ("flash_attention_bwd_f16", torch.float16),
                         ("flash_attention_bwd_f32", torch.float32)):
            assert ops.LAUNCHES[name] == int(dtype == dt), name
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
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.float16])
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
def test_cuda_flash_attention_f16_against_f32(cuda):
    """K4 and K7 in fp16 (amp's O1 attention) held to the plain version in
    f32 on the same fp16-rounded inputs, at phase 2's training shape
    (Llama-2-7B width, S = 4,096, causal) and a GQA window: the only
    differences are fp16's roundings of P and dS and of the outputs.
    Bounds: out 4e-3 (one fp16 step of |out| < 4 plus P's rounding), dq /
    dk / dv 1e-2 of the tensor's largest |value| (dS's rounding in fp16,
    which keeps 3 more bits than bf16, through sums over 4,096 keys)."""
    g = torch.Generator(device=cuda).manual_seed(19)
    for b, s, h, hk, window in ((1, 4096, 32, 32, None),
                                (1, 1000, 28, 4, 129)):
        q, do = (_rnd(g, torch.float16, b, s, h, 128) for _ in range(2))
        k, v = (_rnd(g, torch.float16, b, s, hk, 128) for _ in range(2))
        out, lse = ops.flash_attention(q, k, v, causal=True,
                                       window_size=window, return_lse=True)
        ref, lse_ref = ops.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=True, window_size=window)
        torch.testing.assert_close(out.float(), ref, atol=4e-3, rtol=4e-3)
        torch.testing.assert_close(lse, lse_ref, atol=1e-3, rtol=1e-4)
        got = ops.flash_attention_bwd(q, k, v, out, lse, do, True,
                                      window_size=window)
        want = ops.flash_attention_bwd_plain(
            q.float(), k.float(), v.float(), ref, lse_ref, do.float(), True,
            window_size=window)
        for a, w in zip(got, want):
            assert a.dtype == torch.float16 and bool(a.isfinite().all())
            bound = 1e-2 * float(w.abs().max())
            assert float((a.float() - w).abs().max()) <= bound


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


# ------------------------------------------------ prefix cache, captured
def _prefix_prompts():
    """A 32-token system prompt (2 blocks of 16) with tails; the bare
    system prompt (fully cached: its last token is prefilled again into a
    shared block) and a repeat of the first prompt."""
    rng = np.random.RandomState(3)
    system = rng.randint(1, 512, 32).astype(np.int32)
    first = np.concatenate([system, rng.randint(1, 512, 16)]).astype(
        np.int32)
    tails = [rng.randint(1, 512, n).astype(np.int32) for n in (5, 21, 40)]
    return [first] + [np.concatenate([system, t]) for t in tails] + [
        system.copy(), first.copy()]


def _prefix_run(model, eager=False, pairs=False, **kw):
    """The first prompt runs to its first token (its chain is published),
    then the rest are submitted. Every pool tensor must keep its address,
    every copy-on-write must hold its source's rows (scale rows included);
    each copied source is returned with its rows at the copy, so that the
    caller can show they never change while the index holds it."""
    engine = create_serving_engine(model, **_GRAPH_KW, **kw)
    engine._eager = eager
    pool = engine.pool
    tensors = pool._pool_tensors()
    ptrs, copies = engine._pool_ptrs(), []
    orig = pool.make_writable

    def audited(seq_id, start, end):
        table = list(pool._tables.get(seq_id, ()))
        n = orig(seq_id, start, end)
        assert engine._pool_ptrs() == ptrs
        for old, new in zip(table, pool._tables.get(seq_id, ())):
            if old != new:
                rows = [t[old].clone() for t in tensors]
                assert all(torch.equal(t[new], r)
                           for t, r in zip(tensors, rows))
                copies.append((old, rows))
        return n

    pool.make_writable = audited
    prompts = _prefix_prompts()
    first = engine.submit(prompts[0], max_new_tokens=12, seed=0)
    while not first.tokens:
        engine.step()
    reqs = [first] + [engine.submit(p, max_new_tokens=9 + i, seed=i)
                      for i, p in enumerate(prompts[1:])]
    ops.reset_launches()
    while engine.has_work:
        if pairs:
            pending = engine.step_dispatch()
            engine.step_collect(pending)
        else:
            engine.step()
    assert engine._pool_ptrs() == ptrs
    assert engine._graph_pools in (None, ptrs)
    assert pool.blocks_in_use == 1 + pool.cached_blocks
    return engine, [r.tokens for r in reqs], dict(ops.LAUNCHES), copies


@pytest.mark.cuda
def test_cuda_captured_prefix_engine_equals_eager_and_unshared(cuda):
    """The prefix cache under the captured quantum, tiny and in f32: the
    captured engine's streams and launches equal its eager body's and its
    streams equal the unshared engine's; copies are made in place (no pool
    tensor moves) and the shared sources keep their rows."""
    model = _tiny_cuda_model(cuda)
    eager, e_streams, e_launches, _ = _prefix_run(model, eager=True,
                                                  prefix_cache=True)
    eng, streams, launches, copies = _prefix_run(model, prefix_cache=True)
    base, b_streams, _, _ = _prefix_run(model)
    assert eager._graph is None and eng._graph is not None
    assert streams == e_streams == b_streams
    assert launches == e_launches
    st = eng.engine_stats()["prefix_cache"]
    assert st["hits"] > 0 and st["cow_copies"] == len(copies) >= 2
    assert eng.stats["prefill_tokens"] < base.stats["prefill_tokens"]
    # the copied sources are still cached, and no later write reached them
    kept = [(b, rows) for b, rows in copies if b in eng.pool._cached_blocks]
    assert kept
    for b, rows in kept:
        assert all(torch.equal(t[b], r)
                   for t, r in zip(eng.pool.k_pools + eng.pool.v_pools, rows))


@pytest.mark.cuda
def test_cuda_prefix_cow_under_multi_quantum_dispatch_collect(cuda):
    """Copy-on-write under ``multi_quantum=4`` driven by ``step_dispatch``
    / ``step_collect``, int8 KV pools included (scale rows are copied
    too): streams equal ``step()`` at K=1 and the graph keeps its pool
    addresses."""
    model = _tiny_cuda_model(cuda)
    for kw in ({}, dict(kv_dtype="int8")):
        one, want, _, _ = _prefix_run(model, prefix_cache=True, **kw)
        eng, got, launches, copies = _prefix_run(
            model, pairs=True, prefix_cache=True, multi_quantum=4, **kw)
        assert got == want
        assert eng._graph is not None and len(copies) >= 2
        assert eng.stats["decode_quanta"] > eng.stats["steps"] - \
            eng.stats["mixed_steps"]
        k2 = ("paged_decode_attention_int8_rows" if kw
              else "paged_decode_attention")
        assert launches[k2] > 0
        if kw:
            # the copied scale rows are live ones
            assert all(rows[-1].abs().sum() > 0 for _, rows in copies)


# ------------------------------------------------ speculative round, captured
def _tiny_cuda_draft(cuda, dtype="float32"):
    return LlamaForCausalLM(
        LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                         num_key_value_heads=2, vocab_size=512,
                         num_hidden_layers=1, dtype=dtype),
        generator=torch.Generator(device=cuda).manual_seed(1))


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["greedy", "sampling", "target_draft",
                                 "int8", "bf16"])
def test_cuda_captured_spec_round_equals_eager(cuda, arm):
    """The speculative round as one captured CUDA graph against the same
    body run eagerly: equal streams, counters and launch counts (each
    replay adds its capture's launches: K1 in every norm of the draft's
    γ+1 steps and of the verify, K2 in each draft step). Greedy streams
    also equal the plain engine's in f32 (an independent draft and the
    target as its own draft); the sampling arm with the target as its own
    draft replays the plain sampling engine."""
    dtype = "bfloat16" if arm == "bf16" else "float32"
    model = _tiny_cuda_model(cuda, dtype)
    draft = model if arm == "target_draft" else _tiny_cuda_draft(cuda, dtype)
    kw = {"sampling": dict(decode_strategy="sampling", top_k=50,
                           temperature=0.8),
          "int8": dict(quantize="weight_only_int8", kv_dtype="int8")}.get(
              arm, {})
    gamma = 3
    runs = [_graph_run(model, eager, spec_draft=draft, spec_gamma=gamma,
                       **kw) for eager in (True, False)]
    (eager_eng, eager_streams, eager_l), (eng, streams, launches) = runs
    assert eager_eng._graph is None and eng._graph is not None
    assert streams == eager_streams
    assert launches == eager_l
    for key in ("steps", "mixed_steps", "spec_rounds", "spec_proposed",
                "spec_accepted", "quantum_tokens"):
        assert eng.stats[key] == eager_eng.stats[key], key
    k2 = ("paged_decode_attention_int8_rows" if arm == "int8"
          else "paged_decode_attention")
    t_layers = model.config.num_hidden_layers
    d_layers = draft.config.num_hidden_layers
    assert eng._graph.launches == {
        "rms_norm": (gamma + 1) * (2 * d_layers + 1) + 2 * t_layers + 1,
        k2: (gamma + 1) * d_layers}
    k3 = ("varlen_flash_attention" if dtype == "bfloat16"
          else "varlen_flash_attention_f32")
    assert launches[k3] > 0
    for pool in (eng.pool, eng.d_pool):
        assert pool.blocks_in_use == 1
    if arm in ("greedy", "target_draft"):
        _, plain_streams, _ = _graph_run(model, False)
        assert streams == plain_streams
    if arm == "target_draft":
        assert eng.stats["spec_accepted"] == eng.stats["spec_proposed"]
    if arm == "sampling":
        _, plain_streams, _ = _graph_run(model, False, **kw)
        _, same, _ = _graph_run(model, False, spec_draft=model,
                                spec_gamma=gamma, **kw)
        assert same == plain_streams


@pytest.mark.cuda
def test_cuda_spec_prefix_cow_keeps_both_pools(cuda):
    """The prefix cache under the captured round: both pools copy on
    write in place (no pool tensor of either moves, the engine's address
    check covers both), and the streams equal the eager round's and the
    unshared speculative engine's."""
    model, draft = _tiny_cuda_model(cuda), _tiny_cuda_draft(cuda)
    kw = dict(spec_draft=draft, spec_gamma=3)
    d_copies = []

    def run(eager=False, **extra):
        engine, streams, launches, copies = _prefix_run(
            model, eager=eager, **kw, **extra)
        if extra.get("prefix_cache"):
            assert engine.d_pool.blocks_in_use == \
                1 + engine.d_pool.cached_blocks
            d_copies.append(engine.engine_stats()["draft_prefix_cache"])
        return engine, streams, launches, copies

    eager, e_streams, e_launches, _ = run(eager=True, prefix_cache=True)
    eng, streams, launches, copies = run(prefix_cache=True)
    _, b_streams, _, _ = run()
    assert eng._graph is not None and len(copies) >= 2
    assert eng._graph_pools == eng._pool_ptrs()
    assert len(eng._pool_ptrs()) == len(eng.pool._pool_tensors()) + len(
        eng.d_pool._pool_tensors())
    assert streams == e_streams == b_streams
    assert launches == e_launches
    assert d_copies[-1]["cow_copies"] == \
        eng.engine_stats()["prefix_cache"]["cow_copies"] >= 2


_DEAD_ENGINE = """
import gc
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
kw = dict(num_slots=3, block_size=16, prefill_chunk=32, decode_quantum=4)
prompt = np.arange(1, 6, dtype=np.int32)

def run(engine):
    req = engine.submit(prompt, max_new_tokens=12)
    engine.run()
    assert engine._graph is not None
    return req.tokens

dead = [create_serving_engine(model, **kw)]
want = run(dead[0])
engine = create_serving_engine(model, **kw)
select = engine._select
dropped = []

def dropping(logits, slots, steps):
    # inside the capture: drop the last reference to the other engine (a
    # cycle holding a captured graph) and make the collector run often
    if torch.cuda.is_current_stream_capturing() and dead:
        dead.clear()
        gc.set_threshold(1, 1, 1)
        dropped.extend({{"i": i}} for i in range(1000))
    return select(logits, slots, steps)

engine._select = dropping
try:
    got = run(engine)
finally:
    gc.set_threshold(700, 10, 10)
assert dropped and got == want, (got, want)
print("CAPTURED")
"""


@pytest.mark.cuda
def test_cuda_capture_survives_a_dropped_engine(cuda):
    """A dropped engine holding a captured graph is a reference cycle. One
    dropped inside another engine's capture, with the collector set to
    run at every allocation, must not break that capture: the capture
    holds the collector off. In a child process: a failed capture leaves
    PyTorch's CUDA generator marked as capturing."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c",
                          _DEAD_ENGINE.format(root=root)],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "CAPTURED" in out.stdout, out.stdout[-2000:]


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hk", [(32, 32), (32, 8)])
def test_cuda_verify_attention_bf16_rows_equal_f32_rows(cuda, hq, hk):
    """The speculative verify attention takes Q·Kᵀ on bf16 pool rows with
    f32 accumulation and output on the card; the same inputs cast to f32
    (the path of f32 pools and of the CPU) give the same products up to
    summation order, so the bf16 result is within one bf16 rounding step
    of the f32 one. Masked rows, a chunk at the table's end, GQA."""
    from paddle_tpu_torch.serving import engine as engine_mod

    g = torch.Generator(device=cuda).manual_seed(5)
    s, c, d, bs, w = 4, 5, 128, 32, 9
    nb = s * w + 1
    kp = _rnd(g, torch.bfloat16, nb, bs, hk, d)
    vp = _rnd(g, torch.bfloat16, nb, bs, hk, d)
    q = _rnd(g, torch.bfloat16, s, c, hq, d)
    tables = torch.randperm(nb, generator=g, device=cuda)[:s * w].view(
        s, w).int()
    base = torch.tensor([0, 100, w * bs - c, 37], dtype=torch.int32,
                        device=cuda)
    out = engine_mod._paged_chunk_attn(q, kp, vp, tables, base)
    ref = engine_mod._paged_chunk_attn(q.float(), kp.float(), vp.float(),
                                       tables, base)
    assert out.dtype == torch.bfloat16 and ref.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref, atol=1e-3, rtol=2 ** -8)


# ------------------------------------------------ the serving front door
def _syncs_by_step(model, **kw):
    """Run ``_GRAPH_PROMPTS`` through the engine; per step, whether it
    dispatched the decode quantum, the synchronizing calls PyTorch's sync
    debug mode reports inside it, and the CUDA events it waited on (the
    decode dispatch's one host sync)."""
    engine = create_serving_engine(model, **_GRAPH_KW, **kw)
    for i, p in enumerate(_GRAPH_PROMPTS):
        engine.submit(p, max_new_tokens=9 + i)
    step, dispatch = engine.step, engine._decode_dispatch
    event_sync = torch.cuda.Event.synchronize
    state, steps = {}, []

    def flagged_dispatch():
        state["decode"] = True
        return dispatch()

    def counted_event_sync(ev):
        state["events"] += 1
        return event_sync(ev)

    engine._decode_dispatch = flagged_dispatch
    torch.cuda.Event.synchronize = counted_event_sync
    try:
        while engine.has_work:
            state.update(decode=False, events=0)
            # set before the recording starts: the mode's first setting in
            # a process warns by itself
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs = sum("synchronizing" in str(w.message) for w in caught)
            steps.append((state["decode"], syncs, state["events"]))
    finally:
        torch.cuda.Event.synchronize = event_sync
    return engine, steps


@pytest.mark.cuda
def test_cuda_obs_adds_no_sync_to_a_dispatch(cuda):
    """The observability hooks read only host values: with obs, the trace,
    the SLOs and the flight recorder on, every step makes the same
    synchronizing calls as with ``obs="off"``, and a decode dispatch waits
    on exactly one event."""
    model = _tiny_cuda_model(cuda)
    on, on_steps = _syncs_by_step(model, trace=True, slo=True, flight=True)
    off, off_steps = _syncs_by_step(model, obs="off")
    assert on._graph is not None and off._graph is not None
    assert on_steps == off_steps
    decode = [s for s in on_steps if s[0]]
    assert len(decode) > 3
    assert all(events == 1 for _, _, events in decode[1:])
    assert on.obs.registry.get("serving_quantum_seconds").count(
        kind="decode") == on.stats["decode_quanta"]
    assert on.health()["state"] in ("ok", "warn", "critical")


@pytest.mark.cuda
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_cuda_preempted_stream_under_captured_quantum(cuda, prefix_cache):
    """Through the front door, INTERACTIVE arrivals preempt BATCH requests
    decoding in the captured quantum; the victims re-prefill and rejoin
    the replayed graph, and every stream equals an undisturbed engine's
    (f32). With the prefix cache the requests share a system prompt."""
    from paddle_tpu_torch.inference import serve
    from paddle_tpu_torch.serving import BATCH, INTERACTIVE, FrontDoorPolicy

    model = _tiny_cuda_model(cuda)
    rng = np.random.RandomState(3)
    system = rng.randint(1, 512, 40).astype(np.int32)
    prompts = [np.concatenate([system, rng.randint(1, 512, n).astype(
        np.int32)]) for n in (7, 21, 12, 3)]
    kw = dict(num_slots=2, block_size=16, prefill_chunk=32,
              decode_quantum=4, prefix_cache=prefix_cache)
    calm = create_serving_engine(model, **kw)
    want = [calm.submit(p, max_new_tokens=14) for p in prompts]
    calm.run()
    fd = serve(model, policy=FrontDoorPolicy(shed_on_warn=(),
                                             shed_on_critical=()), **kw)
    low = [fd.submit(p, max_new_tokens=14, priority=BATCH)
           for p in prompts[:2]]
    while len(low[1].request.tokens) < 6:
        fd.pump()
    assert fd.engine._graph is not None
    high = [fd.submit(p, max_new_tokens=14, priority=INTERACTIVE)
            for p in prompts[2:]]
    fd.run_until_idle()
    assert [s.request.tokens for s in low + high] == [r.tokens for r in want]
    st = fd.stats()
    assert st["preempted"] >= 1 and st["resumed"] == st["preempted"]
    assert fd.engine.obs.registry.get(
        "serving_tokens_recomputed_total").value() > 0
    if prefix_cache:
        assert st["prefix_cache"]["hits"] > 0
    pool = fd.engine.pool
    assert pool.fragmentation_stats()["blocks_in_use"] == \
        1 + pool.cached_blocks


# ------------------------------------------------ the resilience tier
def _nosleep(_s):
    return None


@pytest.mark.cuda
def test_cuda_bit_flip_in_place_keeps_pools_and_replays(cuda):
    """A bit flipped in a cached block on the card: every pool tensor keeps
    its address, the captured quantum replays after the flip, the next
    attach quarantines the flipped chain, and every stream equals an
    unfaulted engine's (f32)."""
    from paddle_tpu_torch.serving import (FaultInjector, FaultSpec,
                                          ResiliencePolicy)

    model = _tiny_cuda_model(cuda)
    prompts = _prefix_prompts()
    calm = create_serving_engine(model, prefix_cache=True, **_GRAPH_KW)
    want = [calm.submit(p, max_new_tokens=8) for p in prompts]
    calm.run()
    inj = FaultInjector(plan=[FaultSpec("kv", "bit_flip", times=1)], seed=0)
    engine = create_serving_engine(
        model, prefix_cache=True, faults=inj,
        resilience=ResiliencePolicy(sleep=_nosleep), **_GRAPH_KW)
    ptrs = engine._pool_ptrs()
    first = engine.submit(prompts[0], max_new_tokens=8)
    engine.run()                      # its chain is published, now cached
    graph = engine._graph
    assert graph is not None
    rest = [engine.submit(p, max_new_tokens=8) for p in prompts[1:]]
    quanta = engine.stats["decode_quanta"]
    engine.run()
    flips = [j for j in inj.journal if "block" in j]
    assert len(flips) == 1
    assert engine._pool_ptrs() == ptrs
    assert engine._graph is graph
    assert engine.stats["decode_quanta"] > quanta
    assert engine.resilience_report()["prefix_quarantines"] >= 1
    assert [r.tokens for r in [first] + rest] == [r.tokens for r in want]
    assert engine.pool.fragmentation_stats()["blocks_in_use"] == \
        1 + engine.pool.cached_blocks


@pytest.mark.cuda
def test_cuda_probe_under_graph_leaves_excluded_rows(cuda):
    """A bisect probe replays the captured quantum once with the other rows
    staged done: their lengths, host mirrors and pool rows come out
    unchanged, and no graph is captured again."""
    from paddle_tpu_torch.serving import ResiliencePolicy

    model = _tiny_cuda_model(cuda)
    engine = create_serving_engine(
        model, resilience=ResiliencePolicy(sleep=_nosleep), **_GRAPH_KW)
    reqs = [engine.submit(p, max_new_tokens=40) for p in _GRAPH_PROMPTS[:3]]
    while engine.scheduler.prefilling() or engine._graph is None:
        engine.step()
    rows = engine.scheduler.decoding()
    assert len(rows) == 3
    graph = engine._graph
    keep, out = rows[:1], rows[1:]
    slots = [r.slot for r in out]
    before = {k: getattr(engine, "_" + k)[slots].copy()
              for k in ("seq_lens", "last_tok", "n_gen", "done")}
    blocks = sorted({b for r in out for b in engine.pool._tables[r.req_id]})
    pools = engine.pool._pool_tensors()
    rows_before = [t[blocks].clone() for t in pools]
    kept = int(engine._seq_lens[keep[0].slot])
    tokens = [list(r.tokens) for r in out]
    ptrs = engine._pool_ptrs()
    assert engine._probe(keep) is False
    torch.cuda.synchronize()
    for k, v in before.items():
        np.testing.assert_array_equal(getattr(engine, "_" + k)[slots], v)
    for t, tb in zip(pools, rows_before):
        assert torch.equal(t[blocks], tb)
    assert [list(r.tokens) for r in out] == tokens
    assert int(engine._seq_lens[keep[0].slot]) == \
        kept + _GRAPH_KW["decode_quantum"]
    assert engine._graph is graph and engine._pool_ptrs() == ptrs
    engine.run()
    assert all(len(r.tokens) == 40 for r in reqs)


@pytest.mark.cuda
def test_cuda_resilience_dispatch_keeps_one_event_wait(cuda):
    """A default engine's decode dispatch and a ``resilience=True``
    engine's each wait on one event and make no other sync; both capture
    the same launches a replay."""
    model = _tiny_cuda_model(cuda)
    plain, plain_steps = _syncs_by_step(model)
    armed, armed_steps = _syncs_by_step(model, resilience=True)
    assert plain._graph is not None and armed._graph is not None
    assert plain_steps == armed_steps
    decode = [s for s in armed_steps if s[0]]
    assert len(decode) > 3
    assert all(events == 1 for _, _, events in decode[1:])
    assert plain._graph.launches == armed._graph.launches
    assert armed.resilience_report()["watchdog"]["trips_total"] == 0


@pytest.mark.cuda
def test_cuda_two_replicas_on_one_stream_equal_one(cuda, monkeypatch):
    """Two replicas whose graphs were captured on ONE stream (so they share
    K2's merge tickets) and replay on one stream, driven by the cluster
    pump (every replica dispatched before any is collected): the streams
    equal a single replica's (f32)."""
    from paddle_tpu_torch.ops import split_decode
    from paddle_tpu_torch.serving import (ClusterFrontDoor, ClusterReplica,
                                          ClusterRouter, no_shed_policy)

    model = _tiny_cuda_model(cuda)
    prompts = _prefix_prompts()[1:5] + _GRAPH_PROMPTS[:4]

    def run(n):
        reps = [ClusterReplica(f"r{i}", create_serving_engine(
            model, prefix_cache=True, **_GRAPH_KW), policy=no_shed_policy())
            for i in range(n)]
        cfd = ClusterFrontDoor(ClusterRouter(reps, affinity_blocks=1,
                                             strategy="round_robin"))
        streams = [cfd.submit(p, max_new_tokens=10) for p in prompts]
        cfd.run_until_idle()
        return [list(s.result()) for s in streams], reps

    want, _ = run(1)
    shared = torch.cuda.Stream(cuda)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a, **k: shared)
    got, reps = run(2)
    assert got == want
    assert all(r.engine._graph is not None for r in reps)
    assert all(r.engine._graph.stream is shared for r in reps)
    assert sum(k[1] == shared.cuda_stream
               for k in split_decode._TICKETS) == 1


@pytest.mark.cuda
def test_cuda_spec_disable_mid_run_captures_plain_quantum(cuda):
    """Speculative-round faults past the threshold mid-run: the engine
    drops the round's graph, captures the plain quantum at its next
    dispatch and goes on equal to the plain engine (f32); both pools
    drain."""
    from paddle_tpu_torch.serving import (FaultInjector, FaultSpec,
                                          ResiliencePolicy)

    model, draft = _tiny_cuda_model(cuda), _tiny_cuda_draft(cuda)
    prompts = _GRAPH_PROMPTS[:3]
    plain = create_serving_engine(model, **_GRAPH_KW)
    want = [plain.submit(p, max_new_tokens=24) for p in prompts]
    plain.run()
    inj = FaultInjector(seed=0)
    engine = create_serving_engine(
        model, spec_draft=draft, spec_gamma=2, faults=inj,
        resilience=ResiliencePolicy(max_retries=0, spec_fault_threshold=2,
                                    sleep=_nosleep), **_GRAPH_KW)
    reqs = [engine.submit(p, max_new_tokens=24) for p in prompts]
    while engine.stats["spec_rounds"] < 3:
        engine.step()
    spec_graph = engine._graph
    assert spec_graph is not None and not engine._spec_disabled
    inj.plan.append(FaultSpec("spec_round", "raise", times=2))
    engine.run()
    assert engine._spec_disabled
    assert engine._graph is not None and engine._graph is not spec_graph
    assert engine._body == engine._quantum_body
    assert engine.stats["decode_quanta"] > 0
    assert [r.tokens for r in reqs] == [r.tokens for r in want]
    for pool in engine._pools():
        assert pool.fragmentation_stats()["blocks_in_use"] == 1


@pytest.mark.cuda
def test_cuda_lora_step_keeps_frozen_weights_bit_equal(cuda):
    """The frozen rule on the card: LoRA under amp O2 bf16 through
    JittedTrainStep moves the adapters only, every frozen weight stays
    bit-equal; per step K1 and K6 run their f32 arms (rms_norm is
    black-listed) at every norm, K6 at all but layer 0's input norm, and
    the bf16 K4 / K7 once a layer."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.peft import LoRAConfig, get_lora_model

    model = amp.decorate(_tiny_cuda_model(cuda), level="O2",
                         dtype="bfloat16")
    lora = get_lora_model(model, LoRAConfig(r=4, lora_alpha=8),
                          generator=torch.Generator(device=cuda)
                          .manual_seed(1))
    frozen = {n: p.detach().clone() for n, p in lora.named_parameters()
              if not p.requires_grad}
    adapters = [p for p in lora.parameters() if p.requires_grad]
    start = [p.detach().clone() for p in adapters]
    crit = LlamaPretrainingCriterion(model.config)
    step = JittedTrainStep(lora, lambda o, lb: crit(o, lb),
                           AdamW(1e-3, parameters=adapters,
                                 multi_precision=True))
    ids = torch.randint(0, 512, (2, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(2))
    with amp.auto_cast(level="O2", dtype="bfloat16"):
        step(ids, ids)
        ops.reset_launches()
        losses = [float(step(ids, ids)) for _ in range(2)]
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    assert launches == {"rms_norm": 10, "rms_norm_bwd": 8,
                        "flash_attention": 4, "flash_attention_bwd": 4}
    assert all(np.isfinite(losses))
    for n, p in lora.named_parameters():
        if n in frozen:
            assert torch.equal(p, frozen[n]), n
    assert all(not torch.equal(p, s) for p, s in zip(adapters, start))


@pytest.mark.cuda
def test_cuda_amp_off_keeps_the_quantum_launches(cuda, monkeypatch):
    """With amp off the seams cost one attribute read: no cast runs in the
    serving quantum, and a replay launches what the quantum did before
    amp existed, K1 at every norm (2 L + 1) and K2 once a layer, per
    decode step of the quantum."""
    from paddle_tpu_torch import amp

    def no_cast(*a, **k):
        raise AssertionError("amp cast with amp off")

    monkeypatch.setattr(amp, "cast_inputs_for_op", no_cast)
    model = _tiny_cuda_model(cuda)
    engine = create_serving_engine(model, **_GRAPH_KW)
    for p in _GRAPH_PROMPTS[:3]:
        engine.submit(p, max_new_tokens=30)
    while engine.scheduler.prefilling() or engine.scheduler.waiting:
        engine.step()
    engine.step()                       # warm-up quantum + capture
    ops.reset_launches()
    engine.step()                       # one replay
    q, layers = _GRAPH_KW["decode_quantum"], model.config.num_hidden_layers
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
        "rms_norm": (2 * layers + 1) * q, "paged_decode_attention": layers * q}


def _fmt_calls(fmt, xs, max_len, dtype, lens=None):
    """Prefill, chunk and decode calls over fresh caches; the outputs and
    the caches."""
    caches = fmt.gen_cache(xs[0].shape[0], max_len, dtype)
    outs, off = [], 0
    for x in xs:
        kw = {"seq_lens": lens(off)} if x.shape[1] == 1 and lens else {}
        out, caches = fmt(x, caches=caches, time_step=off, **kw)
        outs.append(out)
        off += x.shape[1]
    return outs, caches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("int8", [False, True])
def test_cuda_fused_multi_transformer_kernel_matches_plain(cuda, dtype, tol,
                                                          int8):
    """FusedMultiTransformer at D = 128 with GQA 8 / 2: prefill, a chunked
    prefill and decode steps with per-row lengths, the kernels (K1, K4,
    K5) against their plain versions, float and weight-only int8."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer

    fmt = FusedMultiTransformer(
        1024, 8, 2048, num_layers=2, norm_type="rmsnorm",
        activation="swiglu", num_key_value_heads=2, dtype=dtype,
        device=cuda, generator=torch.Generator(device=cuda).manual_seed(0))
    if int8:
        fmt.quantize_weight_only()
    g = torch.Generator(device=cuda).manual_seed(1)
    xs = [_rnd(g, dtype, 2, s, 1024) for s in (40, 24, 1, 1, 1)]

    def lens(off):
        return torch.tensor([off + 1, off - 3], dtype=torch.int32,
                            device=cuda)

    name = "flash_attention_f32" if dtype == torch.float32 else \
        "flash_attention"
    with torch.no_grad():
        ops.reset_launches()
        outs, caches = _fmt_calls(fmt, xs, 128, dtype, lens)
        assert ops.LAUNCHES[name] == 4
        assert ops.LAUNCHES["decode_attention"] == 6
        assert ops.LAUNCHES["rms_norm"] == 20
        with ops.plain_versions():
            pouts, pcaches = _fmt_calls(fmt, xs, 128, dtype, lens)
    for o, p in zip(list(outs) + list(caches), list(pouts) + list(pcaches)):
        torch.testing.assert_close(o.float(), p.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("recompute", [False, True])
def test_cuda_gpt_step_launches_flash_kernels(cuda, recompute):
    """One bf16 GPT train step at D = 64: K4 forward and K7 backward per
    layer (full recompute relaunches K4 in the backward), nothing else."""
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM

    cfg = GPTConfig(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                    num_attention_heads=4, max_position_embeddings=256,
                    dtype="bfloat16", use_recompute=recompute)
    model = GPTForCausalLM(cfg, device=cuda)
    step = JittedTrainStep(model, lambda o, y: F.cross_entropy(
        o.float().reshape(-1, 512), y.reshape(-1)), AdamW(
            1e-3, parameters=model.parameters(), multi_precision=True))
    ids = torch.randint(0, 512, (2, 128), device=cuda)
    ops.reset_launches()
    loss = step(ids, ids)
    torch.cuda.synchronize()
    want = {k: 0 for k in ops.LAUNCHES}
    want.update(flash_attention=4 if recompute else 2,
                flash_attention_bwd=2)
    assert dict(ops.LAUNCHES) == want
    assert torch.isfinite(loss)
    ops.reset_launches()
    with torch.no_grad():
        out = model.generate(ids[:, :16], max_new_tokens=2)
    assert out.shape == (2, 18) and ops.LAUNCHES["flash_attention"] == 4


@pytest.mark.cuda
def test_cuda_moe_grouped_matches_einsum(cuda):
    from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer

    res = {}
    for mode in ("einsum", "grouped"):
        moe = MoELayer(256, 512, 8, gate="gshard", activation="swiglu",
                       capacity_factor=0.5, dispatch_mode=mode, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(3))
        x = torch.randn(512, 256, device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(4))
        x.requires_grad_()
        y = moe(x)
        ((y * y).mean() + 0.01 * moe.l_aux).backward()
        res[mode] = [y.detach(), x.grad] + [p.grad for p in moe.parameters()]
    for a, b in zip(res["grouped"], res["einsum"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_head_dim_16_takes_the_plain_path_and_k5_refuses_a10(cuda):
    """D = 16 (the tiny configs) takes the reference's gate on the card:
    SDPA sends it to the plain attention, so the tiny GPT and
    FusedMultiTransformer's prefill answer and equal their plain-version
    runs; the fused stack's decode step calls K5 directly, which has no
    D = 16 arm, and raises, with no fallback."""
    from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
    from paddle_tpu_torch.nlp import GPTConfig, GPTForCausalLM

    model = GPTForCausalLM(GPTConfig.tiny(), device=cuda)
    ids = torch.randint(0, 128, (2, 8), device=cuda)
    ops.reset_launches()
    with torch.no_grad():
        logits = model(ids)
        assert not any(ops.LAUNCHES.values())
        with ops.plain_versions():
            assert torch.equal(logits, model(ids))
    fmt = FusedMultiTransformer(64, 4, 128, num_layers=1, device=cuda)
    x = torch.randn(2, 8, 64, device=cuda)
    with torch.no_grad():
        out = fmt(x)
        with ops.plain_versions():
            assert torch.equal(out, fmt(x))
        caches = fmt.gen_cache(2, 16)
        _, caches = fmt(x, caches=caches, time_step=0)
        with pytest.raises(NotImplementedError, match="A10"):
            fmt(torch.randn(2, 1, 64, device=cuda), caches=caches,
                time_step=8)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h", [(2, 4096, 4096, 5), (2, 4096, 77, 5),
                                       (2, 64, 64, 20)])
def test_cuda_flash_attention_at_unet_shapes(cuda, b, sq, sk, h):
    """K4 at the SD UNet's attention (bf16, non-causal, HK = H): the 64 x
    64 level's self- and cross-attention (77 keys: a partial key tile) and
    the 8 x 8 level's self-attention."""
    g = torch.Generator(device=cuda).manual_seed(sq + sk + h)
    q = _rnd(g, torch.bfloat16, b, sq, h, 64)
    k, v = (_rnd(g, torch.bfloat16, b, sk, h, 64) for _ in range(2))
    out = ops.flash_attention(q, k, v)
    ref = ops.flash_attention_plain(q, k, v)[0]
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_cuda_ddim_sampler_captured_equals_eager(cuda):
    """The SD sampler's whole loop as one CUDA graph: its latents equal
    the eager loop's bit for bit, a repeated call replays the cached
    graph, and every self- and cross-attention of every step went through
    K4 (7 blocks x 2 x 3 steps)."""
    from paddle_tpu_torch.vision.models import (SDUNetConfig,
                                                UNet2DConditionModel,
                                                ddim_sample, sd_unet)

    cfg = SDUNetConfig(block_out_channels=(64, 128), attention_head_dim=64,
                       cross_attention_dim=64, norm_num_groups=8,
                       sample_size=16)
    unet = UNet2DConditionModel(cfg, device=cuda).to(torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(0)
    lat = _rnd(g, torch.bfloat16, 2, 4, 16, 16)
    ctx = _rnd(g, torch.bfloat16, 2, 77, 64)
    ops.reset_launches()
    first = ddim_sample(unet, lat, ctx, num_inference_steps=3)
    ops.reset_launches()
    again = ddim_sample(unet, lat, ctx, num_inference_steps=3)
    assert dict(ops.LAUNCHES)["flash_attention"] == 42
    loop = next(iter(unet._ddim_loops.values()))
    assert len(unet._ddim_loops) == 1 and loop.graph.graph is not None
    sd_unet._EAGER = True
    try:
        eager = ddim_sample(unet, lat, ctx, num_inference_steps=3)
    finally:
        sd_unet._EAGER = False
    assert torch.equal(first, again) and torch.equal(first, eager)
    assert torch.isfinite(first).all()


@pytest.mark.cuda
def test_cuda_resnet18_step(cuda):
    """One Momentum step of resnet18 on the card: a finite loss, moved
    running statistics, and a bf16 eval forward."""
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    model = resnet18(num_classes=10, device=cuda)
    opt = Momentum(0.1, parameters=model.parameters())
    g = torch.Generator(device=cuda).manual_seed(1)
    x = _rnd(g, torch.float32, 8, 3, 64, 64)
    y = torch.randint(0, 10, (8,), device=cuda, generator=g)
    loss = CrossEntropyLoss()(model(x), y)
    loss.backward()
    opt.step()
    assert torch.isfinite(loss) and float(model.bn1._mean.abs().max()) > 0
    model.to(torch.bfloat16).eval()
    with torch.no_grad():
        assert torch.isfinite(model(x.bfloat16())).all()


@pytest.mark.cuda
def test_cuda_ernie_step_matches_cpu(cuda):
    """One Engine.fit step of a 2-layer ERNIE (hidden 128, D = 64; its
    masked attention is plain on every device) on the card against the
    same step on the CPU (f32, TF32 off): the loss within 1e-5; every
    element of every parameter within 2 lr, and all but 0.1% of each
    tensor's elements (the key biases' gradients, zero in exact
    arithmetic, left out) within 1e-5 of its largest |value| (Adam's first
    step moves an element by ~lr times its gradient's sign, and where a
    gradient is rounding noise the two devices may draw other signs);
    no kernel launched."""
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.io import TensorDataset
    from paddle_tpu_torch.nlp import (BertPretrainingCriterion, ErnieConfig,
                                      ErnieForPretraining)

    cfg = ErnieConfig.tiny(hidden_size=128, intermediate_size=256,
                           vocab_size=500)
    rng = np.random.RandomState(0)
    ids = rng.randint(1, 500, (4, 64)).astype(np.int64)
    labels = np.full_like(ids, -100)
    labels[:, ::7] = ids[:, ::7]
    crit = BertPretrainingCriterion()
    runs = {}
    for dev in ("cpu", cuda):
        model = ErnieForPretraining(cfg, device="cpu")
        model.to(dev)
        eng = Engine(model, lambda out, lb: crit(out[0], out[1], lb),
                     AdamW(1e-4, parameters=model.parameters()), device=dev)
        ops.reset_launches()
        hist = eng.fit(TensorDataset([ids, labels]), batch_size=4,
                       shuffle=False, verbose=0)
        runs[str(dev)] = (hist["loss"][0], {
            n: p.detach().cpu() for n, p in model.named_parameters()})
        assert not any(ops.LAUNCHES.values())
        assert model.cls.decoder_weight is \
            model.bert.embeddings.word_embeddings.weight
    (cpu_loss, cpu_p), (gpu_loss, gpu_p) = runs["cpu"], runs[str(cuda)]
    assert abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss)
    for n, want in cpu_p.items():
        err = (gpu_p[n] - want).abs()
        assert float(err.max()) <= 2e-4, n
        if n.endswith("k_proj.bias"):
            continue  # a zero gradient in exact arithmetic: all noise
        far = int((err > 1e-5 * float(want.abs().max())).sum())
        assert far <= max(1, want.numel() // 1000), n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_cuda_multi_head_attention_takes_k4_and_k7(cuda, dtype, tol):
    """nn.MultiHeadAttention without a mask (D = 64): forward K4 and
    backward K7, once each, against the plain path; with a mask, no
    kernel."""
    from paddle_tpu_torch import nn

    torch.manual_seed(0)
    mha = nn.MultiHeadAttention(128, 2, device=cuda, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    q, kv = _rnd(g, dtype, 2, 96, 128), _rnd(g, dtype, 2, 160, 128)

    def run():
        mha.zero_grad()
        out = mha(q, kv)
        out.float().square().mean().backward()
        # the key bias's gradient is zero in exact arithmetic: left out
        return out.detach(), {n: p.grad.clone() for n, p in
                              mha.named_parameters() if n != "k_proj.bias"}

    ops.reset_launches()
    out, grads = run()
    fwd, bwd = (("flash_attention", "flash_attention_bwd")
                if dtype == torch.bfloat16 else
                ("flash_attention_f32", "flash_attention_bwd_f32"))
    assert {k: v for k, v in ops.LAUNCHES.items() if v} == {fwd: 1, bwd: 1}
    with ops.plain_versions():
        want, want_grads = run()
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    for n, ref in want_grads.items():
        assert float((grads[n].float() - ref.float()).norm()
                     / ref.float().norm()) <= tol, n
    ops.reset_launches()
    mask = torch.zeros(96, 160, device=cuda)
    mha(q, kv, attn_mask=mask)
    assert not any(ops.LAUNCHES.values())


@pytest.mark.cuda
def test_cuda_transformer_decoder_cached_steps_take_k4(cuda):
    """The decoder's cached steps (Cache + StaticCache, no mask) in bf16:
    two K4 launches a layer and step (Sq = 1), outputs against the plain
    path; the causal training forward's self-attention stays plain."""
    from paddle_tpu_torch import nn

    torch.manual_seed(2)
    dec = nn.TransformerDecoder(nn.TransformerDecoderLayer(
        128, 2, 256, dropout=0.0, device=cuda, dtype=torch.bfloat16), 2)
    g = torch.Generator(device=cuda).manual_seed(3)
    tgt, mem = (_rnd(g, torch.bfloat16, 2, n, 128) for n in (6, 40))

    def decode():
        cache = dec.gen_cache(mem)
        outs = []
        for i in range(tgt.shape[1]):
            out, cache = dec(tgt[:, i:i + 1], mem, cache=cache)
            outs.append(out)
        return torch.cat(outs, 1)

    with torch.no_grad():
        ops.reset_launches()
        got = decode()
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
            "flash_attention": 2 * 2 * 6}
        with ops.plain_versions():
            want = decode()
        ops.reset_launches()
        full = dec(tgt, mem, nn.Transformer.generate_square_subsequent_mask(
            6, device=cuda))
        assert {k: v for k, v in ops.LAUNCHES.items() if v} == {
            "flash_attention": 2}  # the cross-attention only
    assert float((got.float() - want.float()).norm()
                 / want.float().norm()) <= 2.0 ** -5
    assert float((got.float() - full.float()).norm()
                 / full.float().norm()) <= 2.0 ** -5


@pytest.mark.cuda
def test_cuda_fleet_one_nccl_rank_matches_serial(cuda):
    """One NCCL rank (fleet.init at degree 1, stage-3 sharding): the mp
    layers and a stage-3 sharded MLP with its sharded AdamW step against
    the plain serial layers on the card, f32 within 1e-5; every
    collective runs, over groups of one rank."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        ShardedOptimizer, group_sharded)

    strategy = fleet.DistributedStrategy()
    strategy.sharding = True
    strategy.sharding_configs = {"stage": 3}
    fleet.init(is_collective=True, strategy=strategy)
    try:
        assert dist.get_backend() == "nccl"
        g = torch.Generator(device=cuda).manual_seed(0)
        col = ColumnParallelLinear(64, 128, has_bias=True,
                                   gather_output=False, device=cuda)
        row = RowParallelLinear(128, 64, has_bias=True,
                                input_is_parallel=True, device=cuda)
        emb = VocabParallelEmbedding(100, 64, device=cuda)
        with torch.no_grad():
            for p in (*col.parameters(), *row.parameters(), emb.weight):
                p.copy_(_rnd(g, torch.float32, *p.shape))
        x = _rnd(g, torch.float32, 8, 64).requires_grad_(True)
        ids = torch.randint(0, 100, (4, 5), device=cuda, generator=g)
        out = row(col(x)) + emb(ids[:1, :1]).reshape(1, 64)
        xs = x.detach().clone().requires_grad_(True)
        ref = torch.nn.functional.linear(
            torch.nn.functional.linear(xs, col.weight, col.bias),
            row.weight, row.bias) + emb.weight[ids[0, 0]]
        # f32, TF32 off: within 1e-5 of the largest value (sums of 64 and
        # 128 products in other orders: addmm against mm, then the add;
        # an element near zero after cancellation carries the error of
        # the largest terms). The printed ratio is the margin.
        def within(got, want, what):
            scale = float(want.abs().max())
            print(f"{what}: max|diff| / max|ref| = "
                  f"{float((got - want).abs().max()) / scale:.3e}")
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)

        within(out, ref, "out")
        out.square().sum().backward()
        ref.square().sum().backward()
        within(x.grad, xs.grad, "x.grad")
        torch.testing.assert_close(emb(ids), emb.weight[ids])

        def mlp():
            torch.manual_seed(1)
            return torch.nn.Sequential(torch.nn.Linear(64, 96),
                                       torch.nn.ReLU(),
                                       torch.nn.Linear(96, 8)).to(cuda)

        serial, sharded = mlp(), mlp()
        group_sharded.shard_model_params_stage3(sharded)
        assert all(p.dim() == 1 for p in sharded.parameters())
        opts = [AdamW(1e-2, parameters=m.named_parameters())
                for m in (serial, sharded)]
        opts[1] = ShardedOptimizer(opts[1], 2)
        xb = _rnd(g, torch.float32, 16, 64)
        for _ in range(2):
            for m, opt in zip((serial, sharded), opts):
                m(xb).square().mean().backward()
                opt.step()
                opt.clear_grad()
        full = group_sharded.full_state_dict(sharded)
        for name, p in serial.named_parameters():
            torch.testing.assert_close(full[name], p, atol=1e-5, rtol=1e-5)
        assert group_sharded.stage3_stats()["live"] == 0
    finally:
        dist.destroy_process_group()


# -- the Paddle tensor API tier ----------------------------------------------
@pytest.mark.cuda
def test_cuda_tensor_api_places_on_the_card_by_default(cuda):
    """With no place set, ``to_tensor``, the creation ops, the random ops,
    ``Parameter`` and ``Layer.create_parameter`` all land on the card, and
    the ops follow their inputs there."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import place

    saved = place._current
    place._current = None
    try:
        made = [paddle.to_tensor([1.0, 2.0]), paddle.zeros([2, 3]),
                paddle.full([2], 3.0), paddle.arange(5), paddle.eye(3),
                paddle.rand([4]), paddle.randint(0, 5, [3]),
                paddle.Parameter(np.ones(3, np.float32)),
                paddle.nn.Layer().create_parameter([2, 2])]
        assert all(t.device.type == "cuda" for t in made)
        assert paddle.get_device() == "gpu:0"
        x = made[0]
        assert x.place == paddle.CUDAPlace(0)
        out = paddle.matmul(paddle.reshape(x, [1, 2]),
                            paddle.ones([2, 2]))
        assert out.device.type == "cuda" and out.tolist() == [[3.0, 3.0]]
        assert paddle.to_tensor([1.0], place=paddle.CPUPlace()).device.type \
            == "cpu"
    finally:
        place._current = saved


@pytest.mark.cuda
def test_cuda_public_api_resnet_step_equals_direct_path(cuda):
    """Phase 23 (b) at a small size: resnet18 through the public API
    (``paddle.seed``, ``to_tensor``, ``nn.CrossEntropyLoss``,
    ``optimizer.Momentum``) against the direct-path model carrying its
    weights: three steps' losses bit-equal (cuDNN deterministic), and the
    same kernel launches a step under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.nn import CrossEntropyLoss
    from paddle_tpu_torch.optimizer import Momentum
    from paddle_tpu_torch.vision.models import resnet18

    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        paddle.seed(0)
        model = resnet18()
        ce = paddle.nn.CrossEntropyLoss()
        opt = paddle.optimizer.Momentum(0.1, parameters=model.parameters())
        rng = np.random.RandomState(0)
        x = paddle.to_tensor(rng.randn(4, 3, 64, 64).astype("f4"))
        y = paddle.to_tensor(rng.randint(0, 1000, 4).astype("i8"))
        direct = resnet18(device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(25))
        direct.load_state_dict(model.state_dict())
        d_ce, d_opt = CrossEntropyLoss(), Momentum(
            0.1, parameters=direct.parameters())

        def step(m, c, o):
            loss = c(m(x), y)
            loss.backward()
            o.step()
            o.clear_grad()
            return float(loss)

        api = [step(model, ce, opt) for _ in range(3)]
        ref = [step(direct, d_ce, d_opt) for _ in range(3)]
        assert api == ref

        def launches(m, c, o):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                step(m, c, o)
                torch.cuda.synchronize()
            return sum(ev.count for ev in prof.key_averages()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)

        assert launches(model, ce, opt) == launches(direct, d_ce, d_opt)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


@pytest.mark.cuda
def test_cuda_device_module_streams_events_and_memory(cuda):
    """``paddle.device`` on ``torch.cuda``: a Stream and Event order work,
    the allocator's statistics see an allocation, properties name the
    card."""
    import paddle_tpu_torch as paddle

    dev = paddle.device
    assert dev.device_count() == torch.cuda.device_count() >= 1
    assert dev.get_device_properties().name == torch.cuda.get_device_name(0)
    before = dev.memory_allocated()
    x = torch.ones(1 << 20, device=cuda)
    assert dev.memory_allocated() >= before + x.numel() * 4
    assert dev.max_memory_allocated() >= dev.memory_allocated()
    s = dev.Stream()
    ev = dev.Event(enable_timing=True)
    with torch.cuda.stream(s):
        y = x * 2
        ev.record()
    ev.synchronize()
    dev.synchronize()
    assert float(y.sum()) == 2 * x.numel()
    assert dev.cuda.Stream is dev.Stream and ev.query()
    dev.empty_cache()


def _static_llama(cuda):
    """A small Llama at head width 128 (hidden 256, 2 heads, 1 KV head) in
    bf16: its attention reaches K4 / K7, its norms K1 / K6."""
    cfg = LlamaConfig.tiny(tensor_parallel=False, hidden_size=256,
                           num_attention_heads=2, num_key_value_heads=1,
                           dtype="bfloat16")
    model = LlamaForCausalLM(cfg, generator=torch.Generator(
        device=cuda).manual_seed(0))
    ids = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    return model, ids


def _counts():
    return {k: v for k, v in ops.LAUNCHES.items() if v}


@pytest.mark.cuda
def test_cuda_custom_op_launches_under_to_static_equal_eager(cuda):
    """The kernels' custom ops count real launches: a to_static forward
    and train step launch what the eager ones launch, and the compiled
    forward under plain_versions() (a recompile) launches nothing."""
    from paddle_tpu_torch import jit

    model, ids = _static_llama(cuda)
    with torch.no_grad():
        ops.reset_launches()
        eager = model(ids)
        eager_fwd = _counts()
    ops.reset_launches()
    model(ids).float().square().mean().backward()
    eager_step = _counts()
    assert eager_fwd == {"rms_norm": 5, "flash_attention": 2}
    assert eager_step == {**eager_fwd, "rms_norm_bwd": 5,
                          "flash_attention_bwd": 2}
    jit.to_static(model)
    with torch.no_grad():
        ops.reset_launches()
        out = model(ids)
        assert _counts() == eager_fwd
        with ops.plain_versions():
            ops.reset_launches()
            plain = model(ids)
            assert _counts() == {}
    ops.reset_launches()
    model(ids).float().square().mean().backward()
    assert _counts() == eager_step
    assert model.forward.graph_breaks == []
    torch.testing.assert_close(out.float(), eager.float(), atol=6e-2,
                               rtol=2e-2)
    torch.testing.assert_close(plain.float(), out.float(), atol=6e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_cuda_llama_jit_save_predictor_round_trip_equals_eager(cuda,
                                                               tmp_path):
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec

    model, ids = _static_llama(cuda)
    with torch.no_grad():
        eager = model(ids).float().cpu().numpy()
    prefix = str(tmp_path / "llama")
    jit.save(model, prefix, input_spec=[InputSpec([None, None], "int64")])
    pred = inference.create_predictor(inference.Config(prefix))
    ops.reset_launches()
    (logits,) = pred.run([ids.cpu().numpy()])
    assert _counts() == {"rms_norm": 5, "flash_attention": 2}
    np.testing.assert_allclose(logits, eager, atol=2e-2, rtol=2e-2)
    loaded = jit.load(prefix)
    assert loaded._device.type == "cuda"
    short = ids[:1, :64].contiguous()
    with torch.no_grad():
        want = model(short).float()
    torch.testing.assert_close(loaded(short).float(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
def test_cuda_decode_kernels_refuse_jit_save(cuda, tmp_path):
    """K2 and K5 are not custom ops yet: a jit.save of a Layer that
    reaches them raises, naming the ROADMAP item."""
    from paddle_tpu_torch import jit
    from paddle_tpu_torch.static import InputSpec

    g = torch.Generator(device=cuda).manual_seed(0)
    cache = _rnd(g, torch.bfloat16, 2, 64, 2, 128)
    lens = torch.tensor([3, 64], dtype=torch.int32, device=cuda)
    pool = _rnd(g, torch.bfloat16, 4, 32, 2, 128)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32, device=cuda)

    class K5(torch.nn.Module):
        def forward(self, q):
            return ops.decode_attention(q, cache, cache, lens)

    class K2(torch.nn.Module):
        def forward(self, q):
            return ops.paged_decode_attention(q, pool, pool, tables, lens)

    for layer in (K5(), K2()):
        with torch.no_grad():
            layer(_rnd(g, torch.bfloat16, 2, 4, 128))  # eager runs
        with pytest.raises(Exception, match="K2 / K5 as custom ops"):
            jit.save(layer, str(tmp_path / type(layer).__name__),
                     input_spec=[InputSpec([2, 4, 128], "bfloat16")])
