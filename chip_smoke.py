#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, and the build of the hand-written kernels from
   ``paddle_tpu_torch/csrc`` (nvcc, sm_90a) with its time;
2. each kernel against its plain PyTorch version on the card, at the
   serving, generation and training paths' shapes, in bf16 and f32
   (K4 also at the training shape against one ``is_causal`` SDPA call,
   in bf16 and f32; the backward as the fused kernel K7, in bf16 on wgmma
   and in f32 as 3xTF32; K7 also at
   Mistral's GQA width with its window; K1 also at the training path's
   4,096 rows, past the L2; K6 also at the packed width 2,048 and at phase
   8's f32 rows; the varlen backward in bf16 as the
   fused kernel K8 at the packed 941M row, with GQA and a window, with
   unequal query and key lengths, and with empty segments, in f32 as the
   fused 3xTF32 kernel at the packed row; K3 also at the packed 941M row
   (bf16 and f32) and
   with GQA and a window; K2's int8 arm with static (HK,) scales and with
   per-row scale pools at the serving shape and at GQA 32/8, and K2's
   static scales over float pools; K2 also over one sequence and one KV
   head of 4,096 tokens, K5 also at the generate run's own step, 4 rows
   of 4,096 live tokens): max error, kernel / plain /
   library-call device times (torch.profiler, summed kernel durations;
   CUDA events where the profiler records none, as ``timers`` says; where
   several library calls compute the same function the fastest counts,
   and ``library_call`` names it), the kernel's CUDA-event time over
   back-to-back calls (launch gaps included), the least time the card
   could take (``bound_ms``), its share of the kernel's time
   (``bound_share``) and the kernel's time over the library call's
   (``vs_library``);
3. the serving main path end to end: full Llama-2-7B in bf16 (32 layers,
   seeded random weights) through ``create_serving_engine``, 16 requests,
   the decode quantum as the engine's captured CUDA graph (each replay
   adds its capture's launches to the counters); launch counters zeroed
   just before and read just after; the same requests again with the
   sampling arm (top-k, top-p, temperature); then a torch.profiler
   breakdown of one mixed step and one replayed decode quantum, greedy
   and sampled;
4. the kernel path against the plain path end to end, at full width and
   4 layers in f32 (no argmax near-ties): greedy streams must be equal;
5. contiguous-cache generation end to end: full Mistral-7B in bf16 (32
   layers, seeded random weights) through ``LlamaForCausalLM.generate``,
   4 rows of 4,608-token prompts (the prefill band clips at the 4,096
   window and the decode buffer wraps) and 64 new tokens, the decode step
   a captured CUDA graph; launch counters zeroed just before and read
   just after; the same run with eager decode steps (equal streams, and
   every step's logits); then ``top_k=1`` sampling, whose stream must
   equal the greedy one (up to exact argmax ties), phase 13's generate
   half, and a torch.profiler breakdown of one prefill and one eager
   decode step;
6. generation's kernel path against its plain path (Mistral width, 4
   layers, f32, greedy streams equal), and one fixed-seed sampling
   serving run repeated (Llama-2-7B width, 4 layers: equal streams);
7. the training main path: Llama-2-7B width with 4 layers in bf16
   (bench.py's configuration: f32 master weights, bf16 AdamW moments,
   weight decay 0.01, no recompute, B=1, S=4,096, one seeded batch)
   through ``JittedTrainStep``: 2 warm-up steps, then 10 steps in one
   ``run_steps`` call with the launch counters zeroed just before and read
   just after (exactly K1 9, K4 4, K6 9, K7 4 per step), step
   time, tokens/s, MFU and peak memory; the loss must fall. Then the same
   configuration with ``fuse_linear_cross_entropy`` (its step-1 loss
   within bf16 rounding of the unfused one, its peak memory), and a
   torch.profiler breakdown of one unfused step;
8. the training kernel path against its plain path in f32 (Llama-2-7B
   width, 2 layers, S=1,024; the backward's f32 route, the fused f32 K7,
   exactly one launch per layer and backward, and never the bf16 K7):
   step-1 gradients per tensor within 1e-4 of the tensor's largest |g|,
   and the losses of 3 steps within 1e-4; each step's wall time, then
   one more step under the profiler;
9. packed (cu_seqlens) training, ``scripts/bench_suite.py``'s
   llama_941m_packed_varlen_train_mfu on the port: hidden 2,048, 16
   layers, 32 heads, bf16 with f32 masters and bf16 moments, one row of 8
   segments (T = 4,096), the model called as ``model(ids, cu)`` and the
   packed criterion on f32 logits: 2 warm-up steps, then 10 in one
   ``run_steps`` with the counters zeroed just before and read just after
   (exactly K1 33, K6 33, K3 16, K8 16 per step and no f32 K8, K4 or
   K7),
   step time, tokens/s, MFU (attention at the effective length
   sum(len^2) / T), peak memory and a step profile; the loss must fall.
   Then the same configuration with full recompute for 3 steps from the
   same weights and batches: its losses beside the first run's, a lower
   peak, and K1 65 and K3 32 launches per step;
10. packed training's kernel path against its plain path in f32 (the same
    width, 2 layers, T = 1,024 in 4 segments; the backward's f32 route,
    the fused f32 K8, exactly one launch per layer and backward, and never
    the bf16 K8): step-1 gradients per tensor within 1e-5 of the tensor's
    largest |g|, the losses of 3 steps within 1e-6; step walls and one
    profiled step, as in phase 8;
11. int8 serving at full width: Llama-2-7B in bf16 (32 layers, seeded
    weights), phase 3's knobs and requests, three engines through
    ``create_serving_engine``: ``quantize="weight_only_int8"`` (the entry
    point sweeps the model), the float engine over the dequantized
    weights (its greedy streams must be equal), and
    ``quantize="weight_only_int8", kv_dtype="int8"`` (the main path of
    K2's per-row mode: counters zeroed just before and read just after;
    it must launch K1, K3 and K2's per-row mode and no float K2). Per
    arm: tokens/s, peak memory, the pool's bytes in use after a fixed
    step, the float / int8 residency ratio, the int8-KV arm's token
    agreement with the weight-only arm; then profiles of its mixed step
    and replayed decode quantum, and of the w8 arm's quantum run eagerly
    with the weight dequantization as its own range (a replay runs no
    Python, so it has no such range);
12. int8 parity in f32 (Llama-2-7B width, 4 layers), kernel path against
    plain path: the weight-only int8 engine (equal greedy streams), the
    int8-KV engine (equal streams up to partings at near-ties, each a
    swap of the two best tokens: an f32 rounding difference can move a
    KV element to the neighbouring int8 value), and one
    ``block_multihead_attention`` mixed batch over int8 pools with static
    quant scales at the serving shape (8 slots, 128-token prefill chunks
    and decode rows), the path of K2's static int8 arm, and one decode
    step of 8 sequences through ``paged_decode_attention`` with (HK,)
    scales over f32 pools (the public op that applies such scales to any
    pool), the path of K2's static-scale mode over float pools: kernel
    path vs plain within f32 1e-4, equal pools. The two int8 engines
    record each step's two best tokens on the host, so the kernel and
    plain runs that compare them run their quantum eagerly; each engine
    also runs first on its kernel path as the card runs it, the quantum
    captured, and its streams must equal the eager kernel run's;
13. the decode graphs at full width (the card's name and power limit
    beside every timing). Serving: Llama-2-7B bf16 with phase 3's knobs
    and requests, the captured quantum against its eager body (greedy;
    sampled at fixed seeds), ``multi_quantum=4`` against 1 (equal streams
    and ``decode_quanta``), two engines driven dispatch, dispatch,
    collect, collect against ``step()``, and phase 11's w8kv8 engine
    captured against eager: streams equal token for token; then the
    decode dispatch's wall, host and device ms, busy share and replays,
    eager and captured, float and w8kv8. Generate (in phase 5, on its
    Mistral-7B): ``sampling_search`` captured against eager (equal
    streams), and greedy ``generate`` through its entry point, eagerly
    and as replays of the step it captured and kept: per decode step the
    stream's ms, the host's enqueue ms and the device ms, with its busy
    share.

The line before the last is the ``{"kernels": [...]}`` record (each
kernel's launches come from the run of the path that carries it: K1-K3
the serving run of phase 3, K4-K5 the generation run of phase 5, K6 and
K7 the training run of phase 7, the f32 K7 and K4 the f32 kernel run of
phase 8, K8 the packed training run of phase 9, the f32 K8 and K3 the f32
packed kernel run of phase 10, K2's per-row int8 mode the int8-KV serving run
of phase 11, its static int8 arm and its float-pool scaled mode the two
runs of phase 12; ``launches_by_path`` has every path's count); the last
line is ``{"ok": true, "device": {...}}``.
Without CUDA it prints no result and exits 2.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12,    # f32 outside the tensor cores
              "tfloat32": 495e12}  # dense TF32 tensor-core rate
SEED = 0
# phase 5: rows, prompt tokens (past Mistral's 4,096 window), new tokens
GENERATE_SHAPE = (4, 4608, 64)
# phase 6: the same for the f32 kernel-vs-plain generate run
GENERATE_PARITY_SHAPE = (2, 4352, 16)
# phase 7: batch, sequence, warm-up steps, timed steps (one run_steps)
TRAIN_SHAPE = (1, 4096, 2, 10)
# phase 8: sequence and steps of the f32 kernel-vs-plain training run
TRAIN_PARITY_SHAPE = (1024, 3)
# phase 9: the packed row of scripts/bench_suite.py's 941M configuration
# (T = 4,096) and its steps: warm-up, timed (one run_steps), with recompute
PACKED_LENS = [1600, 800, 600, 400, 300, 200, 120, 76]
PACKED_TRAIN_STEPS = (2, 10, 3)
# phase 10: the f32 kernel-vs-plain packed run's segments and steps
PACKED_PARITY = ([500, 300, 150, 74], 3)
# the serving sampling arm's knobs (phases 3 and 6)
SAMPLING = dict(decode_strategy="sampling", top_k=50, top_p=0.9,
                temperature=0.8)


def emit(record):
    print(json.dumps(record), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(nbytes, flops, f32):
    """bound_ms of an attention kernel doing ``flops`` (bf16) operations;
    in f32 each product is three TF32 products (3xTF32)."""
    return (bound_ms(nbytes, 3 * flops, "tfloat32") if f32 else
            bound_ms(nbytes, flops, "bfloat16"))


def device_ms(torch, fn, iters=10):
    """(GPU time of one call, timer). The time is the summed durations of
    every kernel the call launches (torch.profiler), without the launch
    gaps between them. Now and then the profiler on this stack records no
    device time for a whole profile (once a library call, once a port
    kernel): the profile is then taken again, three times in all, and
    after that the call is timed by CUDA events (launch gaps included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us = sum(_device_us(ev) for ev in prof.key_averages()
                       if ev.device_type == torch.autograd.DeviceType.CUDA)
        if total_us > 0:
            return total_us / iters / 1e3, "profiler"
    return cuda_ms(torch, fn), "cuda_events"


def _device_us(ev):
    return getattr(ev, "self_device_time_total",
                   getattr(ev, "self_cuda_time_total", 0))


def cuda_ms(torch, fn, iters=20, warmup=3):
    """CUDA-event time per call over back-to-back calls: includes the
    gaps when the host enqueues slower than the card runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def close(torch, out, ref, dtype, p_rounded=False):
    """(max abs error, within tolerance) over one output or a tuple of
    them. f32: 1e-4 relative + absolute (summation order only). bf16: one
    rounding step of the reference value (both sides compute in f32 and
    round once), plus 1e-2 absolute where probabilities or their
    gradients are rounded to bf16 before a product (K3, K4, K7, K8, as the
    TPU kernels do): a p on a rounding boundary may round one step
    differently when the f32 scores differ in their last bits, which
    moves the output by up to 2^-8 * |v|. A 1-D output (K6's dw, a sum
    over every row) takes the absolute term times its largest value."""
    if dtype != torch.bfloat16:
        rtol, atol = 1e-4, 1e-4
    else:
        rtol, atol = 2.0 ** -7, (1e-2 if p_rounded else 1e-3)
    if isinstance(out, torch.Tensor):
        out, ref = (out,), (ref,)
    err, ok = 0.0, True
    for o, r in zip(out, ref):
        # a sum over many rows (K6's dw) is held relative to its size
        a = atol * max(1.0, float(r.float().abs().max())) if r.dim() == 1 \
            else atol
        diff = (o.float() - r.float()).abs()
        ok &= bool((diff <= a + rtol * r.float().abs()).all())
        err = max(err, float(diff.max()))
    return err, ok, {"rtol": rtol, "atol": atol}


def env_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from paddle_tpu_torch.ops import _library

    nvcc = subprocess.run([_library._nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    t0 = time.perf_counter()
    _library.library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _library.BUILD_INFO["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    emit({"phase": "env", "gpu": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "nvcc": nvcc.stdout.strip()
          .splitlines()[-1], "python": sys.version.split()[0],
          "kernel_build_s": build_s,
          "built_here": _library.BUILD_INFO["built"], "ptxas": ptxas})
    return smi


# ------------------------------------------------------------ phase 2
def k1_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    for dtype in (torch.bfloat16, torch.float32):
        # 1,024 rows (the primary, in the L2 across back-to-back calls) and
        # the training path's 4,096 (67 MB in bf16: past the 50 MB L2)
        for rows in (8, 1024, 4096):
            n = 4096
            x = torch.randn(rows, n, generator=g, device=dev).to(dtype)
            w = torch.randn(n, generator=g, device=dev).to(dtype)
            e = x.element_size()
            nbytes = (2 * rows * n + n) * e
            yield dict(
                name="rms_norm", dtype=dtype, shape=f"rows={rows},N={n}",
                primary=(rows == 1024 and dtype == torch.bfloat16),
                kernel=lambda: ops.rms_norm(x, w),
                plain=lambda: ops.rms_norm_plain(x, w)[0],
                library=lambda: tF.rms_norm(x, (n,), w, 1e-6),
                bound=bound_ms(nbytes, 4.0 * rows * n, "float32"))


def _paged_inputs(torch, g, dev, dtype, b, h, hk, d, bs, lens_list,
                  pool_dtype=None, reach=2048):
    """q in ``dtype`` over pools of ``pool_dtype`` (default q's; int8 pools
    hold the whole int8 range), tables of ``reach`` tokens."""
    w = reach // bs
    num_blocks = b * w + 1
    shape = (num_blocks, bs, hk, d)
    if pool_dtype == torch.int8:
        kp, vp = (torch.randint(-128, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
    else:
        kp = torch.randn(*shape, generator=g, device=dev).to(dtype)
        vp = torch.randn(*shape, generator=g, device=dev).to(dtype)
    perm = torch.randperm(num_blocks - 1, generator=g, device=dev) + 1
    tables = torch.full((b, w), 10 ** 7, dtype=torch.int32, device=dev)
    nxt = 0
    for i, ln in enumerate(lens_list):
        nb = -(-ln // bs)
        tables[i, :nb] = perm[nxt:nxt + nb].int()
        nxt += nb
        if nb < w:
            tables[i, nb:] = -3 - i   # garbage past the length, never read
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
    return q, kp, vp, tables, lens


def k2_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    d, bs = 128, 32
    # B=8 sequences of 1-2,048 tokens; then one sequence and one head over
    # 4,096 tokens (the split plan's smallest B x HK), bf16 only
    shapes = [(8, [1, 31, 32, 33, 500, 1024, 2047, 2048], dtype, h, hk)
              for dtype in (torch.bfloat16, torch.float32)
              # MHA, GQA 4, and Qwen2-7B's group of 7 (28 query heads over 4)
              for h, hk in ((32, 32), (32, 8), (28, 4))]
    shapes.append((1, [4096], torch.bfloat16, 1, 1))
    for b, lens_list, dtype, h, hk in shapes:
        q, kp, vp, tables, lens = _paged_inputs(
            torch, g, dev, dtype, b, h, hk, d, bs, lens_list,
            reach=max(2048, lens_list[-1]))
        # the library yardstick: SDPA over the dense gathered cache
        lmax = max(lens_list)
        nb = -(-lmax // bs)
        safe = torch.where(
            torch.arange(nb, device=dev)[None] * bs < lens[:, None],
            tables[:, :nb], 0).long()
        kd = kp[safe].reshape(b, nb * bs, hk, d).repeat_interleave(
            h // hk, dim=2).transpose(1, 2).contiguous()
        vd = vp[safe].reshape(b, nb * bs, hk, d).repeat_interleave(
            h // hk, dim=2).transpose(1, 2).contiguous()
        mask = (torch.arange(nb * bs, device=dev)[None]
                < lens[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        e = q.element_size()
        live = sum(lens_list)
        nbytes = (2 * b * h * d + 2 * live * hk * d) * e \
            + 4 * (b + sum(-(-ln // bs) for ln in lens_list))
        yield dict(
            name="paged_decode_attention", dtype=dtype,
            shape=f"B={b},H={h},HK={hk},D={d},BS={bs},lens={lens_list}",
            primary=(hk == 32 and dtype == torch.bfloat16),
            kernel=lambda: ops.paged_decode_attention(q, kp, vp, tables,
                                                      lens),
            plain=lambda: ops.paged_decode_attention_plain(
                q, kp, vp, tables, lens),
            library=lambda: tF.scaled_dot_product_attention(
                q4, kd, vd, attn_mask=mask),
            bound=bound_ms(nbytes, 4.0 * live * h * d,
                           str(dtype).removeprefix("torch.")))
        if hk != 32:
            continue
        # the static-scale mode over float pools: (HK,) k and v scales
        # (the TPU kernel's has_scales arm on a float pool); the
        # yardstick scales the gathered dense cache, then one SDPA call
        ks = torch.rand(hk, generator=g, device=dev) * 1.5 + 0.25
        vs = torch.rand(hk, generator=g, device=dev) * 1.5 + 0.25
        ksr = ks.repeat_interleave(h // hk)[None, :, None, None]
        vsr = vs.repeat_interleave(h // hk)[None, :, None, None]
        yield dict(
            name="paged_decode_attention_scaled", dtype=dtype,
            shape=f"B={b},H={h},HK={hk},D={d},BS={bs},lens={lens_list},"
                  f"(HK,) scales",
            primary=(dtype == torch.bfloat16),
            kernel=lambda: ops.paged_decode_attention(
                q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
            plain=lambda: ops.paged_decode_attention_plain(
                q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
            library=lambda: tF.scaled_dot_product_attention(
                q4, (kd * ksr).to(dtype), (vd * vsr).to(dtype),
                attn_mask=mask),
            bound=bound_ms(nbytes + 2 * 4 * hk, 4.0 * live * h * d,
                           str(dtype).removeprefix("torch.")))


def k2_int8_cases(torch, g, dev):
    """K2's int8 arm: int8 pools dequantized by static (HK,) scales (the
    TPU kernel's arm) and by per-row scale pools (the int8 engine's
    quantum), at the K2 serving shape and at GQA 32/8. The library
    yardstick gathers the live blocks, dequantizes them and runs one
    SDPA call, all inside the timed function (SDPA takes no int8)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.paged_attention import (
        _paged_decode_attention_rows, _paged_decode_attention_rows_plain)
    import torch.nn.functional as tF

    b, d, bs = 8, 128, 32
    lens_list = [1, 31, 32, 33, 500, 1024, 2047, 2048]
    live = sum(lens_list)
    live_blocks = sum(-(-ln // bs) for ln in lens_list)
    for dtype in (torch.bfloat16, torch.float32):
        for h, hk in ((32, 32), (32, 8)):
            q, kp, vp, tables, lens = _paged_inputs(
                torch, g, dev, dtype, b, h, hk, d, bs, lens_list,
                pool_dtype=torch.int8)
            nb_pool = kp.shape[0]
            ks = torch.rand(hk, generator=g, device=dev) * 0.02 + 0.005
            vs = torch.rand(hk, generator=g, device=dev) * 0.02 + 0.005
            rks = torch.rand(nb_pool, bs, hk, generator=g, device=dev) \
                * 0.02 + 0.005
            rvs = torch.rand(nb_pool, bs, hk, generator=g, device=dev) \
                * 0.02 + 0.005
            nb = -(-max(lens_list) // bs)
            safe = torch.where(
                torch.arange(nb, device=dev)[None] * bs < lens[:, None],
                tables[:, :nb], 0).long()
            mask = (torch.arange(nb * bs, device=dev)[None]
                    < lens[:, None])[:, None, None, :]
            q4 = q[:, :, None, :]

            def library(k_sc, v_sc, safe=safe, kp=kp, vp=vp, hk=hk, h=h,
                        mask=mask, q4=q4):
                def dense(pool, sc):
                    x = pool[safe].float() * sc
                    return x.reshape(b, nb * bs, hk, d).to(q4.dtype) \
                        .repeat_interleave(h // hk, dim=2).transpose(1, 2)
                return tF.scaled_dot_product_attention(
                    q4, dense(kp, k_sc(safe)), dense(vp, v_sc(safe)),
                    attn_mask=mask)

            e = q.element_size()
            common = dict(dtype=dtype, primary=(hk == 32
                                                and dtype == torch.bfloat16))
            shape = (f"B={b},H={h},HK={hk},D={d},BS={bs},lens={lens_list},"
                     f"int8 pools")
            # q and out, int8 K/V rows, tables and lens
            nbytes = 2 * b * h * d * e + 2 * live * hk * d \
                + 4 * (b + live_blocks)
            ddt = str(dtype).removeprefix("torch.")
            yield dict(
                name="paged_decode_attention_int8",
                shape=shape + ", (HK,) scales",
                kernel=lambda: ops.paged_decode_attention(
                    q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
                plain=lambda: ops.paged_decode_attention_plain(
                    q, kp, vp, tables, lens, k_scale=ks, v_scale=vs),
                library=lambda: library(lambda i: ks[:, None],
                                        lambda i: vs[:, None]),
                bound=bound_ms(nbytes + 2 * 4 * hk, 4.0 * live * h * d,
                               ddt), **common)
            yield dict(
                name="paged_decode_attention_int8_rows",
                shape=shape + ", (NB, BS, HK) row scales",
                kernel=lambda: _paged_decode_attention_rows(
                    q, kp, vp, rks, rvs, tables, lens),
                plain=lambda: _paged_decode_attention_rows_plain(
                    q, kp, vp, rks, rvs, tables, lens),
                library=lambda: library(lambda i: rks[i][..., None],
                                        lambda i: rvs[i][..., None]),
                bound=bound_ms(nbytes + 2 * 4 * live * hk,
                               4.0 * live * h * d, ddt), **common)


def k3_cases(torch, g, dev):
    """K3 at the serving path's shape (8 x 128-token chunks over cached
    contexts; the primary), at the packed training path's row (the 941M
    configuration: D = 64, causal) and with GQA and a window at D = 128.
    The serving case's library yardstick is one SDPA call over the
    segments padded to a batch; the packed cases' the faster of one
    block-diagonal-masked SDPA call over the row and the per-segment SDPA
    forwards (``is_causal`` where no window cuts)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask
    import torch.nn.functional as tF

    d, chunk = 128, 128
    cached = [0, 64, 192, 320, 448, 640, 896, 1920]   # mixed-step rows
    lq = [chunk] * len(cached)
    lk = [c + chunk for c in cached]
    cu_q = torch.tensor([0] + list(_cumsum(lq)), dtype=torch.int32,
                        device=dev)
    cu_k = torch.tensor([0] + list(_cumsum(lk)), dtype=torch.int32,
                        device=dev)
    tq, tk = sum(lq), sum(lk)
    pairs = int(segment_mask(cu_q, cu_k, tq, tk, True).sum())
    for dtype in (torch.bfloat16, torch.float32):
        for h, hk in ((32, 32), (32, 8)):
            q = torch.randn(tq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            # library yardstick: one SDPA call over the segments padded
            # to a batch, with the same bottom-right causal mask
            nseg, kmax = len(lq), max(lk)
            qb = q.view(nseg, chunk, h, d).transpose(1, 2).contiguous()
            kb = torch.zeros(nseg, kmax, hk, d, device=dev, dtype=dtype)
            vb = torch.zeros_like(kb)
            for i, (a, n) in enumerate(zip(cu_k.tolist()[:-1], lk)):
                kb[i, :n] = k[a:a + n]
                vb[i, :n] = v[a:a + n]
            kb = kb.repeat_interleave(h // hk, dim=2).transpose(1, 2)
            vb = vb.repeat_interleave(h // hk, dim=2).transpose(1, 2)
            kb, vb = kb.contiguous(), vb.contiguous()
            lk_t = torch.tensor(lk, device=dev)
            rel_q = (torch.arange(chunk, device=dev)[None]
                     + lk_t[:, None] - chunk)
            kpos = torch.arange(kmax, device=dev)
            mask = ((kpos[None, None] <= rel_q[:, :, None])
                    & (kpos[None, None] < lk_t[:, None, None]))[:, None]
            e = q.element_size()
            nbytes = (2 * tq * h * d + 2 * tk * hk * d) * e \
                + 4 * (tq * h + 2 * (nseg + 1))
            yield dict(
                name="varlen_flash_attention", dtype=dtype,
                shape=f"H={h},HK={hk},D={d},chunk={chunk},cached={cached}",
                primary=(hk == 32 and dtype == torch.bfloat16),
                kernel=lambda: ops.varlen_flash_attention(
                    q, k, v, cu_q, cu_k, causal=True),
                plain=lambda: ops.varlen_flash_attention_plain(
                    q, k, v, cu_q, cu_k, causal=True)[0],
                library=lambda: tF.scaled_dot_product_attention(
                    qb, kb, vb, attn_mask=mask),
                bound=attention_bound(nbytes, 4.0 * pairs * h * d,
                                      dtype == torch.float32))
    # (label, lens, H, HK, D, window, dtypes)
    for label, lens, h, hk, d, window, dtypes in (
            ("packed_941m", PACKED_LENS, 32, 32, 64, None,
             (torch.bfloat16, torch.float32)),
            ("gqa_window", PACKED_LENS, 32, 8, 128, 512, (torch.bfloat16,))):
        cu = torch.tensor([0] + list(_cumsum(lens)), dtype=torch.int32,
                          device=dev)
        t = sum(lens)
        pairs = int(segment_mask(cu, cu, t, t, True, window).sum())
        for dtype in dtypes:
            q = torch.randn(t, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(t, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(t, hk, d, generator=g, device=dev).to(dtype)
            e = q.element_size()
            nbytes = (2 * t * h * d + 2 * t * hk * d) * e \
                + 4 * (t * h + 2 * (len(lens) + 1))
            f32 = dtype == torch.float32
            yield dict(
                name="varlen_flash_attention", dtype=dtype,
                shape=f"{label}:lens={lens},H={h},HK={hk},D={d},causal,"
                      f"window={window}",
                # K3's f32 forward (flash_f32.cuh) at the packed row has
                # its own row
                primary=f32 and label == "packed_941m",
                row="varlen_flash_attention_f32" if f32
                else "varlen_flash_attention",
                kernel=lambda q=q, k=k, v=v, cu=cu, window=window:
                    ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                               window_size=window),
                plain=lambda q=q, k=k, v=v, cu=cu, window=window:
                    ops.varlen_flash_attention_plain(
                        q, k, v, cu, cu, causal=True,
                        window_size=window)[0],
                library=_segment_forward_library(torch, q, k, v, lens,
                                                 window),
                bound=attention_bound(nbytes, 4.0 * pairs * h * d, f32))


def _segment_forward_library(torch, q, k, v, lens, window):
    """K3's library yardsticks on a packed row (equal query and key
    lengths): one SDPA call over the row under the block-diagonal causal
    (banded) mask, and the per-segment SDPA forwards (``is_causal``, or
    the segment's band under a window)."""
    from paddle_tpu_torch.ops.flash_attention import band_mask
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask
    import torch.nn.functional as tF

    dev = q.device
    h, hk = q.shape[1], k.shape[1]
    cu = torch.tensor([0] + list(_cumsum(lens)), device=dev)
    qt = q.transpose(0, 1)[None].contiguous()
    kt = _sdpa_layout(torch, k[None], h // hk).contiguous()
    vt = _sdpa_layout(torch, v[None], h // hk).contiguous()
    mask = segment_mask(cu, cu, q.shape[0], k.shape[0], True, window)
    segs = [tuple(x[:, :, a:b].contiguous() for x in (qt, kt, vt))
            + (None if window is None
               else band_mask(b - a, b - a, True, window, dev),)
            for a, b in zip(cu.tolist(), cu.tolist()[1:]) if b > a]

    def per_segment():
        return [tF.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
                if band is None else
                tF.scaled_dot_product_attention(qs, ks, vs, attn_mask=band)
                for qs, ks, vs, band in segs]
    return {
        "sdpa_block_diagonal_mask": lambda: tF.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask),
        "sdpa_per_segment": per_segment}


def _sdpa_layout(torch, x, rep):
    """(B, S, HK, D) -> (B, H, S, D) with each KV head repeated ``rep``
    times (the library call's layout)."""
    return x.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()


def k4_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.flash_attention import band_mask
    import torch.nn.functional as tF

    d = 128
    # (label, B, Sq, Sk, H, HK, window, dtypes): Mistral prefill (the
    # primary), Llama-2 no-cache dense causal, bottom-right causal (Sq <
    # Sk), and the training shape (Llama-2-7B width, S = 4,096), where one
    # is_causal SDPA call computes the same function
    both = (torch.bfloat16, torch.float32)
    for label, b, sq, sk, h, hk, window, dtypes in (
            ("mistral_prefill", 1, 4608, 4608, 32, 8, 4096, both),
            ("dense_causal", 1, 2048, 2048, 32, 32, None, both),
            ("bottom_right", 1, 64, 1024, 32, 8, None, both),
            ("train", 1, 4096, 4096, 32, 32, None, both)):
        mask = band_mask(sq, sk, True, window, dev)
        pairs = int(mask.sum())
        for dtype in dtypes:
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sk, hk, d, generator=g, device=dev).to(dtype)
            qt = q.transpose(1, 2).contiguous()
            kt, vt = _sdpa_layout(torch, k, h // hk), _sdpa_layout(
                torch, v, h // hk)
            if sq == sk and window is None:
                library = (lambda qt=qt, kt=kt, vt=vt:
                           tF.scaled_dot_product_attention(
                               qt, kt, vt, is_causal=True))
            else:
                library = (lambda qt=qt, kt=kt, vt=vt:
                           tF.scaled_dot_product_attention(
                               qt, kt, vt, attn_mask=mask))
            e = q.element_size()
            nbytes = (2 * b * sq * h * d + 2 * b * sk * hk * d) * e \
                + 4 * b * h * sq
            yield dict(
                name="flash_attention", dtype=dtype,
                shape=f"{label}:B={b},Sq={sq},Sk={sk},H={h},HK={hk},D={d},"
                      f"causal,window={window}",
                primary=(label == "mistral_prefill"
                         and dtype == torch.bfloat16)
                or (label == "train" and dtype == torch.float32),
                # the f32 forward (flash_f32.cuh) has its own row
                row="flash_attention_f32" if dtype == torch.float32
                else "flash_attention",
                kernel=lambda q=q, k=k, v=v: ops.flash_attention(
                    q, k, v, causal=True, window_size=window),
                plain=lambda q=q, k=k, v=v: ops.flash_attention_plain(
                    q, k, v, causal=True, window_size=window)[0],
                library=library,
                bound=attention_bound(nbytes, 4.0 * pairs * b * h * d,
                                      dtype == torch.float32))


def k5_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    b, d, s_max = 4, 128, 4096
    # Mistral's GQA 4, MHA, and Qwen2-7B's group of 7 over 1-4,096 live
    # tokens; then the generate run's own step (4 rows of 4,096 live tokens
    # in the rolling 4,096-token buffer), bf16
    shapes = [([1, 1500, 3000, 4096], h, hk, dtype)
              for h, hk in ((32, 8), (32, 32), (28, 4))
              for dtype in (torch.bfloat16, torch.float32)]
    shapes.append(([s_max] * b, 32, 8, torch.bfloat16))
    for lens_list, h, hk, dtype in shapes:
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        mask = (torch.arange(s_max, device=dev)[None]
                < lens[:, None])[:, None, None, :]
        q = torch.randn(b, h, d, generator=g, device=dev).to(dtype)
        kc = torch.randn(b, s_max, hk, d, generator=g,
                         device=dev).to(dtype)
        vc = torch.randn(b, s_max, hk, d, generator=g,
                         device=dev).to(dtype)
        q4 = q[:, :, None, :]
        kt, vt = _sdpa_layout(torch, kc, h // hk), _sdpa_layout(
            torch, vc, h // hk)
        e = q.element_size()
        live = sum(lens_list)
        nbytes = (2 * b * h * d + 2 * live * hk * d) * e + 4 * b
        yield dict(
            name="decode_attention", dtype=dtype,
            shape=f"B={b},H={h},HK={hk},D={d},S_max={s_max},"
                  f"lens={lens_list}",
            primary=(hk == 8 and dtype == torch.bfloat16
                     and lens_list[0] == 1),
            kernel=lambda q=q, kc=kc, vc=vc, lens=lens:
                ops.decode_attention(q, kc, vc, lens),
            plain=lambda q=q, kc=kc, vc=vc, lens=lens:
                ops.decode_attention_plain(q, kc, vc, lens),
            library=lambda q4=q4, kt=kt, vt=vt, mask=mask:
                tF.scaled_dot_product_attention(q4, kt, vt,
                                                attn_mask=mask),
            bound=bound_ms(nbytes, 4.0 * live * h * d,
                           str(dtype).removeprefix("torch.")))


def k6_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    import torch.nn.functional as tF

    # the training path's rows (B=1, S=4,096) at Llama-2-7B's width, the
    # packed path's at the 941M width, and phase 8's f32 rows (S=1,024)
    for dtype, rows, n in ((torch.bfloat16, 4096, 4096),
                           (torch.float32, 4096, 4096),
                           (torch.bfloat16, 4096, 2048),
                           (torch.float32, 1024, 4096)):
        x = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        w = torch.randn(n, generator=g, device=dev).to(dtype)
        dy = torch.randn(rows, n, generator=g, device=dev).to(dtype)
        _, r = ops.rms_norm_plain(x, w)
        # the library yardstick: F.rms_norm's backward through autograd
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        yl = tF.rms_norm(xl, (n,), wl, 1e-6)
        e = x.element_size()
        nbytes = (3 * rows * n + 2 * n) * e + 4 * rows
        yield dict(
            name="rms_norm_bwd", dtype=dtype, shape=f"rows={rows},N={n}",
            primary=(dtype == torch.bfloat16 and n == 4096),
            kernel=lambda x=x, w=w, r=r, dy=dy: ops.rms_norm_bwd(x, w, r, dy),
            plain=lambda x=x, w=w, r=r, dy=dy: ops.rms_norm_bwd_plain(
                x, w, r, dy),
            library=lambda yl=yl, xl=xl, wl=wl, dy=dy: torch.autograd.grad(
                yl, (xl, wl), dy, retain_graph=True),
            bound=bound_ms(nbytes, 8.0 * rows * n, "float32"))


def k7_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.flash_attention import band_mask
    import torch.nn.functional as tF

    d = 128
    # (label, B, S, H, HK, window, dtypes): the training path (Llama-2-7B
    # width, S=4,096, causal; the fused kernel K7 is the primary in bf16
    # and in f32, its 3xTF32 kernel) and Mistral's GQA
    # width with its window
    for label, b, sq, h, hk, window, dtypes in (
            ("train", 1, 4096, 32, 32, None,
             (torch.bfloat16, torch.float32)),
            ("mistral_gqa_window", 1, 4608, 32, 8, 4096,
             (torch.bfloat16,))):
        mask = band_mask(sq, sq, True, window, dev)
        pairs = int(mask.sum())
        for dtype in dtypes:
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sq, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sq, hk, d, generator=g, device=dev).to(dtype)
            do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            out, lse = ops.flash_attention(q, k, v, causal=True,
                                           window_size=window,
                                           return_lse=True)
            delta = ops.flash_attention_bwd_delta(out, do)
            # the library yardstick: SDPA's whole backward (dq, dk, dv)
            # through autograd on the same inputs
            qt = q.transpose(1, 2).contiguous().requires_grad_()
            kt = _sdpa_layout(torch, k, h // hk).requires_grad_()
            vt = _sdpa_layout(torch, v, h // hk).requires_grad_()
            lo = (tF.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                  if window is None else
                  tF.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask))
            dot = do.transpose(1, 2).contiguous()
            e = q.element_size()
            f32 = dtype == torch.float32
            common = dict(
                dtype=dtype, primary=label == "train",
                shape=f"{label}:B={b},S={sq},H={h},HK={hk},D={d},causal,"
                      f"window={window}",
                library=lambda lo=lo, qt=qt, kt=kt, vt=vt, dot=dot:
                    torch.autograd.grad(lo, (qt, kt, vt), dot,
                                        retain_graph=True))
            args = (q, k, v, do, lse, delta, True)

            def plain(q=q, k=k, v=v, out=out, lse=lse, do=do, delta=delta,
                      window=window):
                return ops.flash_attention_bwd_plain(
                    q, k, v, out, lse, do, True, window_size=window,
                    delta=delta)
            # q, do, dq and k, v, dk, dv once each, lse and delta
            nbytes = (3 * b * sq * h * d + 4 * b * sq * hk * d) * e \
                + 8 * b * h * sq
            # K7: S^T, dP^T, dV, dK, dQ: 10 * D flops per live pair; in
            # f32 each product is three TF32 products (3xTF32)
            flops = 10.0 * d * pairs * b * h
            yield dict(
                name="flash_attention_bwd_f32" if f32 else
                     "flash_attention_bwd",
                kernel=lambda args=args, window=window:
                    ops.flash_attention_bwd_fused(*args,
                                                  window_size=window),
                plain=plain,
                bound=attention_bound(nbytes, flops, f32),
                **common)


def _segment_library(torch, q, k, v, do, lens_q, lens_k, window):
    """The library yardsticks of K8 (bf16 and f32): SDPA's whole backward
    (dq, dk, dv) through autograd on the same inputs, once over the packed
    row under a block-diagonal causal (banded) mask and once as the sum of
    per-segment SDPA backwards (``is_causal`` where a segment's query and
    key lengths agree and no window cuts, else its bottom-right band)."""
    from paddle_tpu_torch.ops.flash_attention import band_mask
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask
    import torch.nn.functional as tF

    dev = q.device
    h, hk = q.shape[1], k.shape[1]
    cu_q = torch.tensor([0] + list(_cumsum(lens_q)), device=dev)
    cu_k = torch.tensor([0] + list(_cumsum(lens_k)), device=dev)
    qt = q.transpose(0, 1)[None].contiguous().requires_grad_()
    kt = _sdpa_layout(torch, k[None], h // hk).requires_grad_()
    vt = _sdpa_layout(torch, v[None], h // hk).requires_grad_()
    mask = segment_mask(cu_q, cu_k, q.shape[0], k.shape[0], True, window)
    lo = tF.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    dot = do.transpose(0, 1)[None].contiguous()
    outs, ins, grads = [], [], []
    for a, b, c, e in zip(cu_q.tolist(), cu_q.tolist()[1:], cu_k.tolist(),
                          cu_k.tolist()[1:]):
        if b == a or e == c:
            continue
        qs, ks, vs = (x.detach()[:, :, lo_:hi_].clone().requires_grad_()
                      for x, lo_, hi_ in ((qt, a, b), (kt, c, e), (vt, c, e)))
        if b - a == e - c and window is None:
            o = tF.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
        else:
            o = tF.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=band_mask(b - a, e - c, True, window,
                                                dev))
        outs.append(o)
        ins += [qs, ks, vs]
        grads.append(dot[:, :, a:b])
    return {
        "sdpa_block_diagonal_mask": lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dot, retain_graph=True),
        "sdpa_per_segment": lambda: torch.autograd.grad(
            outs, ins, grads, retain_graph=True)}


def k8_cases(torch, g, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.ops.varlen_flash_attention import segment_mask

    # (label, lens_q, lens_k or None, H, HK, D, window, dtypes): the packed
    # training path (the 941M configuration's row; the fused bf16 kernel K8
    # is the primary in bf16 and in f32, its 3xTF32 kernel),
    # GQA with a window shorter than the long segments, unequal query and
    # key lengths, and empty segments
    for label, lens_q, lens_k, h, hk, d, window, dtypes in (
            ("packed_941m", PACKED_LENS, None, 32, 32, 64, None,
             (torch.bfloat16, torch.float32)),
            ("gqa_window", PACKED_LENS, None, 32, 8, 128, 512,
             (torch.bfloat16,)),
            ("cross_lengths", [1024, 512, 300, 76], [1600, 512, 700, 76],
             32, 32, 64, None, (torch.bfloat16,)),
            ("empty_segments", [1600, 0, 800, 600, 0, 400, 300, 200, 120,
                                76, 0], None, 32, 32, 64, None,
             (torch.bfloat16,))):
        lens_k = lens_q if lens_k is None else lens_k
        cu_q = torch.tensor([0] + list(_cumsum(lens_q)), dtype=torch.int32,
                            device=dev)
        cu_k = torch.tensor([0] + list(_cumsum(lens_k)), dtype=torch.int32,
                            device=dev)
        tq, tk = sum(lens_q), sum(lens_k)
        pairs = int(segment_mask(cu_q, cu_k, tq, tk, True, window).sum())
        for dtype in dtypes:
            q = torch.randn(tq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            v = torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
            do = torch.randn(tq, h, d, generator=g, device=dev).to(dtype)
            out, lse = ops.varlen_flash_attention(
                q, k, v, cu_q, cu_k, causal=True, window_size=window,
                return_lse=True)
            delta = ops.varlen_flash_attention_bwd_delta(out, do)
            e = q.element_size()
            common = dict(
                dtype=dtype, primary=label == "packed_941m",
                shape=f"{label}:lens_q={lens_q},lens_k={lens_k},H={h},"
                      f"HK={hk},D={d},causal,window={window}",
                library=_segment_library(torch, q, k, v, do, lens_q, lens_k,
                                         window))
            args = (q, k, v, do, lse, delta, cu_q, cu_k, True)

            def plain(args=args, out=out, window=window):
                q, k, v, do, lse, delta, cu_q, cu_k, causal = args
                return ops.varlen_flash_attention_bwd_plain(
                    q, k, v, out, lse, do, cu_q, cu_k, causal,
                    window_size=window, delta=delta)
            # K8: q, do, dq and k, v, dk, dv once each, lse and delta;
            # S^T, dP^T, dV, dK, dQ: 10 * D flops per live pair; in f32
            # each product is three TF32 products (3xTF32)
            f32 = dtype == torch.float32
            nbytes = (3 * tq * h * d + 4 * tk * hk * d) * e + 8 * h * tq
            flops = 10.0 * d * pairs * h
            yield dict(
                name="varlen_flash_attention_bwd_f32" if f32 else
                     "varlen_flash_attention_bwd",
                kernel=lambda args=args, window=window:
                    ops.varlen_flash_attention_bwd_fused(
                        *args, window_size=window),
                plain=plain,
                bound=attention_bound(nbytes, flops, f32),
                **common)


def _cumsum(xs):
    t = 0
    for x in xs:
        t += x
        yield t


KERNELS = {
    "rms_norm": ("cuda", "paddle_tpu_torch/csrc/rms_norm.cu",
                 "paddle_tpu/ops/pallas/rms_norm.py:67"),
    "paged_decode_attention": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    # K2's int8 arm (_paged_kernel's has_scales, lines 53-58): static
    # (HK,) scales, and the per-row scale pools of the int8 engine
    "paged_decode_attention_int8": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    "paged_decode_attention_int8_rows": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    # the same arm's static scales over float pools
    "paged_decode_attention_scaled": (
        "cuda", "paddle_tpu_torch/csrc/paged_attention.cu",
        "paddle_tpu/ops/pallas/paged_attention.py:157"),
    "varlen_flash_attention": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:160"),
    "flash_attention": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:225"),
    "decode_attention": (
        "cuda", "paddle_tpu_torch/csrc/decode_attention.cu",
        "paddle_tpu/ops/pallas/decode_attention.py:128"),
    "rms_norm_bwd": ("cuda", "paddle_tpu_torch/csrc/rms_norm.cu",
                     "paddle_tpu/ops/pallas/rms_norm.py:91"),
    # K7, the fused bf16 backward: both TPU kernels of `_flash_bwd`
    "flash_attention_bwd": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:402, :425"),
    # K7 in f32 (3xTF32), the route of an f32 model (phase 8)
    "flash_attention_bwd_f32": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:402, :425"),
    # K4's f32 forward (flash_f32.cuh, 3xTF32), the route of an f32 model
    # (phase 8)
    "flash_attention_f32": (
        "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
        "paddle_tpu/ops/pallas/flash_attention.py:225"),
    # K8, the fused bf16 varlen backward: both TPU kernels of `_varlen_bwd`
    "varlen_flash_attention_bwd": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:336, :376"),
    # K8 in f32 (3xTF32), the route of an f32 model (phase 10)
    "varlen_flash_attention_bwd_f32": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention_bwd.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:336, :376"),
    # K3's f32 forward (flash_f32.cuh, 3xTF32), the route of an f32 model
    # (phase 10)
    "varlen_flash_attention_f32": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:160"),
}
# the kernels each main path must launch
SERVING_KERNELS = ("rms_norm", "paged_decode_attention",
                   "varlen_flash_attention")
GENERATE_KERNELS = ("rms_norm", "flash_attention", "decode_attention")
# the same paths of an f32 model (phases 4 and 6): the f32 forwards
SERVING_F32_KERNELS = ("rms_norm", "paged_decode_attention",
                       "varlen_flash_attention_f32")
GENERATE_F32_KERNELS = ("rms_norm", "flash_attention_f32",
                        "decode_attention")
TRAIN_KERNELS = ("rms_norm_bwd", "flash_attention_bwd")
TRAIN_F32_KERNELS = ("rms_norm_bwd", "flash_attention_f32",
                     "flash_attention_bwd_f32")
PACKED_KERNELS = ("varlen_flash_attention_bwd",)
PACKED_F32_KERNELS = ("varlen_flash_attention_f32",
                      "varlen_flash_attention_bwd_f32")
INT8_SERVING_KERNELS = ("rms_norm", "varlen_flash_attention",
                        "paged_decode_attention_int8_rows")
STATIC_INT8_KERNELS = ("paged_decode_attention_int8",
                       "varlen_flash_attention_f32")
SCALED_FLOAT_KERNELS = ("paged_decode_attention_scaled",)
# the path whose run gives each kernel's launches in the kernels line
KERNEL_PATH = {"flash_attention_bwd_f32": "train_f32_parity",
               "flash_attention_f32": "train_f32_parity",
               "varlen_flash_attention_bwd_f32": "packed_f32_parity",
               "varlen_flash_attention_f32": "packed_f32_parity",
               "paged_decode_attention_int8": "block_mha_static_int8",
               "paged_decode_attention_int8_rows": "int8_serving",
               "paged_decode_attention_scaled": "scaled_float_decode"}


def kernel_phase(torch, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    primary = {}
    # one case at a time: each case's inputs live only while it runs
    for case in itertools.chain(k1_cases(torch, g, dev),
                                k2_cases(torch, g, dev),
                                k2_int8_cases(torch, g, dev),
                                k3_cases(torch, g, dev),
                                k4_cases(torch, g, dev),
                                k5_cases(torch, g, dev),
                                k6_cases(torch, g, dev),
                                k7_cases(torch, g, dev),
                                k8_cases(torch, g, dev)):
        out = case["kernel"]()
        ref = case["plain"]()
        torch.cuda.synchronize()
        err, ok, tol = close(torch, out, ref, case["dtype"],
                             "flash_attention" in case["name"])
        ms, ms_timer = device_ms(torch, case["kernel"])
        plain_ms, plain_timer = device_ms(torch, case["plain"], iters=3)
        # several library calls compute the same function: the fastest
        # one is the yardstick, and the record says which
        libs = case["library"]
        if not isinstance(libs, dict):
            libs = {"library": libs}
        lib_times = {k: device_ms(torch, fn) for k, fn in libs.items()}
        lib_call = min(lib_times, key=lambda k: lib_times[k][0])
        lib_ms, lib_timer = lib_times[lib_call]
        rec = {"phase": "kernel_check", "name": case["name"],
               "dtype": str(case["dtype"]).removeprefix("torch."),
               "shape": case["shape"], "max_abs_err": err, "tol": tol,
               "ok": ok, "ms": ms, "plain_ms": plain_ms,
               "library_ms": lib_ms,
               "timers": {"ms": ms_timer, "plain_ms": plain_timer,
                          "library_ms": lib_timer},
               "event_ms": cuda_ms(torch, case["kernel"]),
               "bound_ms": case["bound"][0], "bound_by": case["bound"][1],
               # the share of the card's peak the kernel reaches, and its
               # time over the library call's
               "bound_share": case["bound"][0] / ms,
               "vs_library": ms / lib_ms}
        if len(libs) > 1:
            rec["library_call"] = lib_call
            rec["library_calls_ms"] = {k: v[0] for k, v in lib_times.items()}
        emit(rec)
        check(ok, f"{case['name']} disagrees with its plain version: {rec}")
        if case["primary"]:
            primary[case.get("row", case["name"])] = rec
        del out, ref, case, libs
    torch.cuda.empty_cache()
    return primary


# ------------------------------------------------------------ phase 3, 4
def make_requests(vocab, n=16):
    import numpy as np

    rng = np.random.RandomState(SEED)
    lens = np.exp(rng.uniform(math.log(64), math.log(512), n)).astype(int)
    max_new = rng.randint(32, 65, n)
    return [dict(prompt=rng.randint(1, vocab, int(ln)).astype(np.int32),
                 max_new_tokens=int(mn)) for ln, mn in zip(lens, max_new)]


def serve(torch, model, requests, residency_at=None, on_engine=None,
          eager=False, **kw):
    """Drive ``requests`` through a fresh engine; returns the engine, the
    requests, the wall time and the mixed-step / decode-dispatch time
    split (with ``residency_at``, also the pool's bytes in use after that
    step). ``on_engine`` is called with the engine before the run;
    ``eager`` runs the quantum's body eagerly (the oracle of the captured
    graph, the engine's decode path on the card)."""
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, **serve_kw(**kw))
    engine._eager = eager
    if on_engine is not None:
        on_engine(engine)
    # the peak from here on: weights, pools and the run (not the sweep of
    # a model that the engine quantized)
    torch.cuda.reset_peak_memory_stats()
    split = {"mixed_s": 0.0, "decode_s": 0.0}
    if residency_at is not None:
        step, steps = engine.step, [0]

        def counted():
            more = step()
            steps[0] += 1
            if steps[0] == residency_at:
                split["pool_bytes"] = engine.pool.bytes_in_use()
            return more

        engine.step = counted

    def timed(fn, key):
        def run():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
        return run

    engine._mixed_step = timed(engine._mixed_step, "mixed_s")
    dispatch, collect = engine._decode_dispatch, engine._decode_collect

    def timed_dispatch():
        t0 = time.perf_counter()
        pending = dispatch()
        pending["t0"] = t0
        return pending

    def timed_collect(pending):
        collect(pending)
        torch.cuda.synchronize()
        split["decode_s"] += time.perf_counter() - pending["t0"]

    engine._decode_dispatch = timed_dispatch
    engine._decode_collect = timed_collect
    reqs = [engine.submit(**r) for r in requests]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return engine, reqs, wall, split


def check_run(engine, reqs, vocab):
    for r in reqs:
        check(r.finished and r.finish_reason == "length"
              and len(r.tokens) == r.max_new_tokens,
              f"request {r.req_id} ended {r.finish_reason} with "
              f"{len(r.tokens)}/{r.max_new_tokens} tokens")
        check(all(0 <= t < vocab for t in r.tokens),
              f"request {r.req_id} emitted a token outside the vocabulary")
    st = engine.pool.fragmentation_stats()
    check(st["blocks_in_use"] == 1,
          f"pool did not drain to the scratch block: {st}")


def e2e_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    requests = make_requests(cfg.vocab_size)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    engine, reqs, wall, split = serve(torch, model, requests)
    launches = dict(ops.LAUNCHES)
    for name in SERVING_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the serving path")
    check(engine._graph is not None,
          "the serving path's decode quantum did not run as a graph")
    check_run(engine, reqs, cfg.vocab_size)
    st = engine.engine_stats()
    gen = sum(len(r.tokens) for r in reqs)
    emit({"phase": "e2e_llama2_7b_bf16", "layers": cfg.num_hidden_layers,
          "requests": len(reqs), "prompt_tokens": sum(
              len(r["prompt"]) for r in requests),
          "generated_tokens": gen, "wall_s": wall,
          "generated_tok_per_s": gen / wall,
          "prefill_tok_per_s": st["prefill_tokens"] / split["mixed_s"],
          "mixed_step_s": split["mixed_s"], "decode_quanta_s": split[
              "decode_s"], "mixed_steps": st["mixed_steps"],
          "decode_quanta": st["decode_quanta"],
          "decode_steps": st["decode_quanta"] * engine.config.decode_quantum,
          "decode_graph_launches_per_replay": engine._graph.launches,
          "prefill_tokens": st["prefill_tokens"], "launches": launches,
          "model_init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    del engine
    # the same requests sampled: the per-step draw's cost beside greedy
    sampled = [dict(r, seed=i) for i, r in enumerate(requests)]
    engine, reqs, swall, ssplit = serve(torch, model, sampled, **SAMPLING)
    check_run(engine, reqs, cfg.vocab_size)
    st = engine.engine_stats()
    emit({"phase": "e2e_llama2_7b_bf16_sampling", **SAMPLING,
          "generated_tokens": sum(len(r.tokens) for r in reqs),
          "wall_s": swall, "greedy_wall_s": wall,
          "generated_tok_per_s": gen / swall,
          "mixed_step_s": ssplit["mixed_s"],
          "decode_quanta_s": ssplit["decode_s"],
          "greedy_decode_quanta_s": split["decode_s"],
          "mixed_steps": st["mixed_steps"],
          "decode_quanta": st["decode_quanta"]})
    del engine
    profile_phase(torch, model, requests)
    profile_phase(torch, model, sampled, labels=("decode_quantum",),
                  tag="_sampling", **SAMPLING)
    del model
    torch.cuda.empty_cache()
    return launches


def _kernel_family(name):
    # K6 is two launches: the row pass (rms_norm_bwd_rows_kernel, or
    # rms_norm_bwd_any_kernel off the vector path) and the dw reduction
    for key, fam in (("rms_norm_bwd_", "K6 rms_norm_bwd"),
                     ("rms_norm_dw_kernel", "K6 rms_norm_bwd"),
                     ("rms_norm_kernel", "K1 rms_norm"),
                     ("varlen_bwd_fused_f32",
                      "K8 f32 varlen_flash_attention_bwd_f32"),
                     ("varlen_bwd_fused_", "K8 varlen_flash_attention_bwd"),
                     ("tile_order_kernel", "K3 tile order"),
                     ("bwd_fused_f32", "K7 f32 flash_attention_bwd_f32"),
                     ("bwd_fused_", "K7 flash_attention_bwd"),
                     ("PagedRows<1>", "K2-int8 static"),
                     ("PagedRows<2>", "K2-int8 rows"),
                     ("PagedRows", "K2 paged_decode"),
                     ("varlen_fwd_", "K3 varlen_flash"),
                     ("flash_fwd_", "K4 flash_attention"),
                     ("ContiguousRows", "K5 decode_attention"),
                     ("gemm", "matmul"), ("nvjet", "matmul"),
                     ("cutlass", "matmul"), ("xmma", "matmul")):
        if key in name:
            return fam
    return "other"


def profile_phase(torch, model, requests,
                  labels=("mixed_step", "decode_quantum"), tag="",
                  eager=False, **kw):
    """Where one mixed step and one decode quantum spend device time:
    torch.profiler over a single engine step each (the main run's counts
    are read before this). Device busy share = summed kernel time over the
    step's wall time under the profiler. The quantum profiled is a replay
    of its captured graph (the first decode step, which captures it, runs
    before), or with ``eager`` its body run eagerly. A weight-only int8
    model's dequantization runs under its own record_function range and is
    reported as "dequant" (its kernels are elementwise ones, named like
    "other"); a replay runs no Python, so only an eager profile splits it
    out."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.nn.quant import QuantizedLinear

    dequant = QuantizedLinear.dequantized_weight

    def traced_dequant(self, dtype):
        with record_function("dequant"):
            return dequant(self, dtype)

    engine = create_serving_engine(model, **serve_kw(**kw))
    engine._eager = eager
    for r in requests[:8]:
        engine.submit(**r)
    for label in labels:
        if label == "decode_quantum":
            # admission happens inside step(): run until every admitted
            # request has finished its prefill, then one decode step (the
            # capture)
            while (engine.scheduler.prefilling()
                   or not engine.scheduler.decoding()):
                engine.step()
            engine.step()
            check(eager or engine._graph is not None,
                  "the decode quantum was not captured")
        torch.cuda.synchronize()
        QuantizedLinear.dequantized_weight = traced_dequant
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                engine.step()
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
        finally:
            QuantizedLinear.dequantized_weight = dequant
        rec = _profile_record(torch, prof, label + tag, wall_us,
                              ranges=("dequant",))
        if kw.get("quantize"):
            rec["dequant_device_ms"] = _split_range(torch, prof, rec,
                                                    "dequant", "dequant")
        emit(rec)
    del engine


def _profile_record(torch, prof, label, wall_us, ranges=()):
    """Device time by kernel family. ``ranges`` names record_function
    ranges: their device-side annotation spans are no kernels and are
    left out of the sums."""
    fams, n_kernels = {}, 0
    for ev in prof.key_averages():
        dev_us = _device_us(ev)
        if ev.key in ranges:
            continue
        if ev.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            fam = _kernel_family(ev.key)
            fams[fam] = fams.get(fam, 0.0) + dev_us
            n_kernels += ev.count
    busy = sum(fams.values())
    return {"phase": "profile", "step": label,
            "wall_ms_under_profiler": wall_us / 1e3,
            "device_ms": busy / 1e3 if busy else "not measured",
            "device_busy_share": busy / wall_us if busy else "not measured",
            "kernels_launched": n_kernels,
            "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
                fams.items(), key=lambda kv: -kv[1])}}


def serve_kw(**kw):
    return dict(num_slots=8, block_size=32, max_context=2048,
                prefill_chunk=128, decode_quantum=8, **kw)


def parity_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, dtype="float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    requests = make_requests(cfg.vocab_size)
    streams, launches = [], []
    for plain in (False, True):
        ops.reset_launches()
        if plain:
            with ops.plain_versions():
                engine, reqs, wall, _ = serve(torch, model, requests)
        else:
            engine, reqs, wall, _ = serve(torch, model, requests)
        check_run(engine, reqs, cfg.vocab_size)
        streams.append([list(r.tokens) for r in reqs])
        launches.append(dict(ops.LAUNCHES))
        emit({"phase": "parity_f32_4layer", "path": "plain" if plain
              else "kernels", "wall_s": wall, "launches": launches[-1]})
        del engine
    check(all(launches[0][k] > 0 for k in SERVING_F32_KERNELS)
          and launches[0]["varlen_flash_attention"] == 0,
          f"kernel path missed a kernel: {launches[0]}")
    check(all(n == 0 for n in launches[1].values()),
          f"plain path launched a kernel: {launches[1]}")
    same = [a == b for a, b in zip(*streams)]
    emit({"phase": "parity_f32_4layer", "streams_equal": all(same),
          "requests_equal": sum(same), "requests": len(same)})
    check(all(same), "kernel and plain greedy streams differ")
    # fixed-seed sampling serving, twice: the same streams
    sampled = []
    for _ in range(2):
        engine, reqs, wall, _ = serve(
            torch, model, [dict(r, seed=i) for i, r in enumerate(requests)],
            **SAMPLING)
        check_run(engine, reqs, cfg.vocab_size)
        sampled.append([list(r.tokens) for r in reqs])
        del engine
    emit({"phase": "sampling_serving_f32_4layer", "wall_s": wall,
          "streams_equal": sampled[0] == sampled[1],
          "differs_from_greedy": sum(a != b for a, b in
                                     zip(sampled[0], streams[0]))})
    check(sampled[0] == sampled[1], "fixed-seed sampling streams differ")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 5, 6
def _mistral_prompts(vocab, b, s):
    import numpy as np

    return np.random.RandomState(SEED).randint(1, vocab, (b, s))


def _timed_generate(torch, model, ids, eager=False, logits=False, **kw):
    """``model.generate`` timed: CUDA events at its start, after the
    prefill forward (run inside the record_function range
    "generate_prefill") and at its end, and the host's clock when the
    prefill returns and when generate returns. Returns the output, the
    wall, prefill and decode seconds with the host's decode seconds (the
    time to enqueue the decode steps), and, with ``logits``, each
    forward's last-position logits (call 0 the prefill; only eager
    steps run a forward in Python). The decode step runs as the entry
    point's captured graph, or with ``eager`` as eager steps on buffers
    of the call's own."""
    from torch.profiler import record_function
    from paddle_tpu_torch.nlp import generation

    calls = []
    orig = model.forward

    def forward(*args, **kwargs):
        if calls:
            out = orig(*args, **kwargs)
        else:
            with record_function("generate_prefill"):
                out = orig(*args, **kwargs)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        calls.append((ev, out[0][:, -1].clone() if logits else None,
                      time.perf_counter()))
        if not logits:
            del model.forward   # a capture must record no event
        return out

    model.forward = forward
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    prev, generation._EAGER = generation._EAGER, eager
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        out = model.generate(ids, **kw)
        t_ret = time.perf_counter()
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        generation._EAGER = prev
        model.__dict__.pop("forward", None)
    timing = {"wall_s": wall,
              "prefill_s": start.elapsed_time(calls[0][0]) / 1e3,
              "decode_s": calls[0][0].elapsed_time(end) / 1e3,
              "host_decode_s": t_ret - calls[0][2],
              "decode_steps": kw["max_new_tokens"] - 1}
    return out, timing, [lg for _, lg, _ in calls]


def _same_up_to_ties(torch, greedy, sampled, logits, s_in):
    """Row by row, the top_k=1 sampled stream equals the greedy one until
    a step whose greedy logits tie at the maximum; there the sampled token
    must be one of the tied maxima (the two runs shared every earlier
    token, so they saw the same logits), and the rows may part. Returns
    (rows equal, ties met) or raises."""
    equal = ties = 0
    for r in range(greedy.shape[0]):
        diff = (greedy[r, s_in:] != sampled[r, s_in:]).nonzero()
        if diff.numel() == 0:
            equal += 1
            continue
        t = int(diff[0])
        lg = logits[t][r].float()
        check(lg[greedy[r, s_in + t]] == lg.max()
              and lg[sampled[r, s_in + t]] == lg.max(),
              f"row {r}: top_k=1 sampling left greedy at step {t} without "
              f"an argmax tie")
        ties += 1
    return equal, ties


def generate_phase(torch, dev, smi):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.mistral_7b(dtype="bfloat16")
    b, s_in, new = GENERATE_SHAPE
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    model.eval()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = torch.from_numpy(_mistral_prompts(cfg.vocab_size, b, s_in)).to(dev)
    layers = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    out, timing, _ = _timed_generate(torch, model, ids, max_new_tokens=new)
    launches = dict(ops.LAUNCHES)
    steps = new - 1
    want = dict.fromkeys(launches, 0)
    want.update({"flash_attention": layers,
                 "decode_attention": layers * steps,
                 "rms_norm": (2 * layers + 1) * new})
    check(launches == want, f"generate launches {launches}, expected {want}")
    check(tuple(out.shape) == (b, s_in + new)
          and bool((out[:, :s_in] == ids).all())
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"generate returned {tuple(out.shape)} or ids outside the vocab")
    # the eager steps: the captured graph's oracle, and the logits of
    # every step for the top_k=1 run's tie check
    eager_out, eager_timing, logits = _timed_generate(
        torch, model, ids, eager=True, logits=True, max_new_tokens=new)
    same = bool(torch.equal(out, eager_out))
    del eager_out
    emit({"phase": "e2e_mistral_7b_bf16_generate", "layers": layers,
          "batch": b, "prompt_tokens": s_in, "new_tokens": new,
          "window": cfg.sliding_window, **timing,
          "captured_equals_eager": same,
          "eager_decode_s": eager_timing["decode_s"],
          "prefill_tok_per_s": b * s_in / timing["prefill_s"],
          "decode_tok_per_s": b * steps / timing["decode_s"],
          "generated_tok_per_s": b * new / timing["wall_s"],
          "launches": launches, "model_init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    check(same, "generate's captured decode steps part from the eager ones")
    sampled, stiming, _ = _timed_generate(
        torch, model, ids, max_new_tokens=new, decode_strategy="sampling",
        top_k=1, seed=7)
    equal, ties = _same_up_to_ties(torch, out, sampled, logits, s_in)
    emit({"phase": "e2e_mistral_7b_bf16_sampling_top_k_1",
          "wall_s": stiming["wall_s"], "rows_equal_to_greedy": equal,
          "rows_parted_at_an_argmax_tie": ties, "rows": b})
    del logits, sampled
    generate_graphs(torch, model, ids, smi)
    generate_profile(torch, model, ids)
    del model
    torch.cuda.empty_cache()
    return launches


def _generate_timing(torch, model, ids, eager, timed=2):
    """Greedy ``generate`` through its entry point, its decode steps
    eager or replays of the step the entry point captured and kept: one
    call to warm up (the captured arm's capture), ``timed`` calls timed
    (``_timed_generate``), one under torch.profiler. Per decode step and
    timed call: the stream's ms between the events after the prefill
    and at the end (the decode's wall on the card) and the host's ms to
    enqueue it; the device ms (the profiled call's kernels outside the
    prefill's range) with its share of the last timed call's stream
    ms."""
    from torch.profiler import ProfilerActivity, profile

    new = GENERATE_SHAPE[2]
    _timed_generate(torch, model, ids, eager=eager, max_new_tokens=new)
    runs = [_timed_generate(torch, model, ids, eager=eager,
                            max_new_tokens=new)[1] for _ in range(timed)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _timed_generate(torch, model, ids, eager=eager, max_new_tokens=new)
        wall_us = 1e6 * (time.perf_counter() - t0)
    rec = _profile_record(torch, prof, "generate", wall_us,
                          ranges=("generate_prefill",))
    prefill = _split_range(torch, prof, rec, "generate_prefill", "prefill")
    steps = new - 1
    stream = [1e3 * t["decode_s"] / steps for t in runs]
    measured = "not measured" not in (rec["device_ms"], prefill)
    dev_ms = ((rec["device_ms"] - prefill) / steps if measured
              else "not measured")
    return {"stream_ms_per_step": stream,
            "host_ms_per_step": [1e3 * t["host_decode_s"] / steps
                                 for t in runs],
            "device_ms_per_step": dev_ms,
            "device_busy_share": (dev_ms / stream[-1] if measured
                                  else "not measured"),
            "replays": 0 if eager else steps, "steps": steps,
            "call_wall_s": [t["wall_s"] for t in runs],
            "prefill_s": [t["prefill_s"] for t in runs],
            "profiled_prefill_device_ms": prefill}


def generate_graphs(torch, model, ids, smi):
    """Phase 13 (generate): ``sampling_search`` with its decode step
    captured against eager (equal streams), then greedy ``generate``
    through its entry point, eager and captured (``_generate_timing``)."""
    from paddle_tpu_torch.nlp import generation

    new = GENERATE_SHAPE[2]
    outs, walls = [], []
    for eager in (True, False):
        prev, generation._EAGER = generation._EAGER, eager
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(generation.sampling_search(
                model, ids, max_new_tokens=new, seed=11, top_k=50,
                top_p=0.9, temperature=0.8))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        finally:
            generation._EAGER = prev
    same = bool(torch.equal(outs[0], outs[1]))
    b, s_in = ids.shape
    timing = {("eager" if eager else "captured"):
              _generate_timing(torch, model, ids, eager)
              for eager in (True, False)}
    emit({"phase": "graphs_mistral_7b_generate", "gpu": smi,
          "batch": b, "prompt_tokens": s_in, "new_tokens": new,
          "sampling_search_captured_equals_eager": same,
          "sampling_search_wall_s": {"eager": walls[0],
                                     "captured": walls[1]},
          "generate_decode": timing})
    check(same, "sampling_search: captured and eager streams differ")
    del outs


def generate_profile(torch, model, ids):
    """Where one Mistral prefill and one decode step spend device time."""
    from torch.profiler import ProfilerActivity, profile

    b, s_in = ids.shape
    with torch.no_grad():
        caches = model.init_caches(b, s_in + 2)
        for label in ("generate_prefill", "generate_decode_step"):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if label == "generate_prefill":
                    logits, caches = model(ids, 0, caches)
                else:
                    logits, caches = model(tok, s_in, caches)
                torch.cuda.synchronize()
                wall_us = 1e6 * (time.perf_counter() - t0)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            emit(_profile_record(torch, prof, label, wall_us))
    del caches


def generate_parity_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.mistral_7b(num_hidden_layers=4, dtype="float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    model.eval()
    b, s_in, new = GENERATE_PARITY_SHAPE
    ids = torch.from_numpy(_mistral_prompts(cfg.vocab_size, b, s_in)).to(dev)
    outs, launches = [], []
    for plain in (False, True):
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if plain:
            with ops.plain_versions():
                outs.append(model.generate(ids, max_new_tokens=new))
        else:
            outs.append(model.generate(ids, max_new_tokens=new))
        torch.cuda.synchronize()
        launches.append(dict(ops.LAUNCHES))
        emit({"phase": "generate_parity_f32_4layer",
              "path": "plain" if plain else "kernels",
              "wall_s": time.perf_counter() - t0, "launches": launches[-1]})
    check(all(launches[0][k] > 0 for k in GENERATE_F32_KERNELS)
          and launches[0]["flash_attention"] == 0,
          f"generate kernel path missed a kernel: {launches[0]}")
    check(all(n == 0 for n in launches[1].values()),
          f"generate plain path launched a kernel: {launches[1]}")
    same = bool(torch.equal(outs[0], outs[1]))
    emit({"phase": "generate_parity_f32_4layer", "streams_equal": same})
    check(same, "generate kernel and plain greedy streams differ")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 7, 8
def _train_setup(torch, dev, cfg, seed):
    """bench.py's training setup on the port: model, criterion (the
    unfused one on f32 logits), AdamW with f32 master weights for a bf16
    model, and the step."""
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import (LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(seed))
    fused = cfg.fuse_linear_cross_entropy
    crit = LlamaPretrainingCriterion(cfg,
                                     lm_head=model.lm_head if fused else None)
    bf16 = cfg.dtype == "bfloat16"
    opt = AdamW(1e-4, parameters=model.named_parameters(), weight_decay=0.01,
                multi_precision=bf16,
                moment_dtype="bfloat16" if bf16 else "float32")
    step = JittedTrainStep(
        model, crit if fused else (lambda out, lb: crit(out.float(), lb)),
        opt)
    return model, step


def _train_ids(torch, dev, vocab, b, s):
    import numpy as np

    return torch.from_numpy(
        np.random.RandomState(SEED).randint(0, vocab, (b, s))).to(dev)


def train_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig
    from paddle_tpu_torch.profiler import MFUMeter, transformer_train_flops

    b, seq, warm, steps = TRAIN_SHAPE
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, tensor_parallel=False,
                                dtype="bfloat16")
    layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    model, step = _train_setup(torch, dev, cfg, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids = _train_ids(torch, dev, cfg.vocab_size, b, seq)
    n_params = sum(p.numel() for p in model.parameters())
    tokens = b * seq
    flops = transformer_train_flops(n_params, tokens, num_layers=layers,
                                    seq_len=seq, hidden=cfg.hidden_size)
    torch.cuda.reset_peak_memory_stats()
    losses = [step(ids, ids) for _ in range(warm)]
    stacked = ids[None].expand(steps, b, seq)
    ops.reset_launches()
    meter = MFUMeter(flops * steps, tokens * steps)
    timed = []
    res = meter.measure(lambda: timed.append(step.run_steps(stacked,
                                                            stacked)),
                        warmup=0, iters=1)
    launches = dict(ops.LAUNCHES)
    per_step = {"rms_norm": 2 * layers + 1, "flash_attention": layers,
                "rms_norm_bwd": 2 * layers + 1,
                "flash_attention_bwd": layers}
    want = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == want, f"train launches {launches}, expected {want}")
    losses = torch.cat([torch.stack(losses), timed[0]]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    check(float(losses[-1]) < float(losses[0]),
          f"the loss did not fall over {len(losses)} steps: {losses}")
    step_s = res["step_time_s"] / steps
    emit({"phase": "train_llama2_7b_width_bf16", "layers": layers,
          "params": n_params, "batch": b, "seq": seq,
          "warmup_steps": warm, "timed_steps": steps, "step_ms": 1e3 * step_s,
          "train_tok_per_s": tokens / step_s,
          "model_tflops_per_step": flops / 1e12,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "mfu_meter": res["mfu"], "losses": [float(x) for x in losses],
          "launches": launches, "model_init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    train_profile(torch, step, ids, ids)
    unfused_loss1 = float(losses[0])
    del model, step, timed, stacked
    torch.cuda.empty_cache()

    # the same configuration with the chunked fused lm-head + loss
    fcfg = LlamaConfig.llama2_7b(num_hidden_layers=4, tensor_parallel=False,
                                 dtype="bfloat16",
                                 fuse_linear_cross_entropy=True)
    model, step = _train_setup(torch, dev, fcfg, SEED)
    torch.cuda.reset_peak_memory_stats()
    floss = [float(step(ids, ids)) for _ in range(warm)]
    torch.cuda.synchronize()
    rel = abs(floss[0] - unfused_loss1) / abs(unfused_loss1)
    emit({"phase": "train_llama2_7b_width_bf16_fused_lce",
          "chunk_rows": fcfg.lce_chunk_rows, "losses": floss,
          "unfused_step1_loss": unfused_loss1, "step1_rel_diff": rel,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    check(rel <= 2.0 ** -7, f"fused step-1 loss {floss[0]} is not within "
          f"bf16 rounding of the unfused {unfused_loss1}")
    del model, step
    torch.cuda.empty_cache()
    return launches


def train_profile(torch, step, inputs, labels, label="train_step"):
    """Where one training step spends device time: torch.profiler over a
    single step, the optimizer update under its own record_function range
    (its kernels are elementwise ones that fall under "other" by name)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    opt = step._optimizer
    apply = opt.apply

    def traced_apply(*a, **kw):
        with record_function("optimizer_update"):
            return apply(*a, **kw)

    opt.apply = traced_apply
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(inputs, labels)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    del opt.apply
    rec = _profile_record(torch, prof, label, wall_us,
                          ranges=("optimizer_update",))
    # the update's kernels are elementwise ones, named like "other"
    rec["optimizer_device_ms"] = _split_range(
        torch, prof, rec, "optimizer_update", "optimizer (AdamW update)")
    emit(rec)


def _split_range(torch, prof, rec, name, family):
    """Move the device time of the kernels that ran inside the
    record_function range ``name`` from "other" to ``family`` in a profile
    record: each kernel within one of the range's device-side annotation
    spans, once (the spans themselves are no kernels); returns it in ms,
    or "not measured"."""
    cuda = torch.autograd.DeviceType.CUDA
    events = [ev for ev in prof.events() if ev.device_type == cuda]
    spans = [(ev.time_range.start, ev.time_range.end) for ev in events
             if ev.name == name]
    us = sum(ev.time_range.end - ev.time_range.start for ev in events
             if ev.name != name
             and any(a <= ev.time_range.start and ev.time_range.end <= b
                     for a, b in spans))
    fams = rec["device_ms_by_family"]
    if us and "other" in fams:
        fams[family] = us / 1e3
        fams["other"] -= us / 1e3
    return us / 1e3 if us else "not measured"


def _timed_steps(step, inputs, labels, n):
    """The losses of ``n`` steps and each step's wall ms (reading the loss
    waits for the step's work on the card)."""
    losses, walls = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        losses.append(float(step(inputs, labels)))
        walls.append(1e3 * (time.perf_counter() - t0))
    return losses, walls


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def train_parity_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig

    seq, steps = TRAIN_PARITY_SHAPE
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, tensor_parallel=False,
                                dtype="float32")
    ids = _train_ids(torch, dev, cfg.vocab_size, 1, seq)
    runs = []
    for plain in (False, True):
        model, step = _train_setup(torch, dev, cfg, SEED + 3)
        ops.reset_launches()
        with (ops.plain_versions() if plain else contextlib.nullcontext()):
            loss = step._criterion(model(ids), ids)
            loss.backward()
            grads = _grads(model)
            model.zero_grad(set_to_none=True)
            losses, walls = _timed_steps(step, ids, ids, steps)
        launches = dict(ops.LAUNCHES)
        emit({"phase": "train_parity_f32_2layer",
              "path": "plain" if plain else "kernels", "seq": seq,
              "losses": losses, "step_wall_ms": walls,
              "launches": launches})
        if not plain:
            # one more step under the profiler: the f32 step's device time
            train_profile(torch, step, ids, ids, label="train_f32_step")
        if plain:
            check(all(n == 0 for n in launches.values()),
                  f"plain training path launched a kernel: {launches}")
        else:
            check(all(launches[k] > 0 for k in TRAIN_F32_KERNELS
                      + ("rms_norm",)),
                  f"training kernel path missed a kernel: {launches}")
            # one f32 forward per attention layer and forward (one loss,
            # then one per step), never the bf16 K4
            check(launches["flash_attention_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["flash_attention"] == 0,
                  f"the f32 forward is not one f32 launch per layer: "
                  f"{launches}")
            # one fused f32 backward per attention layer and backward
            # (one loss.backward, then one per step), never the bf16 K7
            check(launches["flash_attention_bwd_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["flash_attention_bwd"] == 0,
                  f"the f32 backward is not one fused f32 launch per "
                  f"layer: {launches}")
            kernel_launches = launches
        runs.append((grads, losses))
        del model, step, loss
        torch.cuda.empty_cache()
    (gk, lk), (gp, lp) = runs
    worst = max(float((gk[n] - gp[n]).abs().max())
                / max(float(gp[n].abs().max()), 1e-30) for n in gp)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    emit({"phase": "train_parity_f32_2layer", "grad_worst_rel_to_max": worst,
          "loss_worst_rel": loss_rel})
    check(worst <= 1e-4, f"kernel and plain step-1 grads differ: {worst}")
    check(loss_rel <= 1e-4, f"kernel and plain losses differ: {lk} {lp}")
    return kernel_launches


# ----------------------------------------------------------- phase 9, 10
def _packed_cfg(torch, **overrides):
    """The reference's packed configuration, ``scripts/bench_suite.py``'s
    llama_941m_packed_varlen_train_mfu: hidden 2,048, intermediate 5,504,
    16 layers, 32 heads (head dim 64), vocab 32,000, no recompute."""
    from paddle_tpu_torch.nlp import LlamaConfig

    cfg = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
               num_hidden_layers=16, num_attention_heads=32,
               max_position_embeddings=4096, tensor_parallel=False,
               use_recompute=False, dtype="bfloat16")
    cfg.update(overrides)
    return LlamaConfig(**cfg)


def _packed_setup(torch, dev, cfg, seed):
    """The reference benchmark's packed training on the port: the model
    wrapped as ``_Packed`` (``model(ids, cu)``), the unfused packed
    criterion on f32 logits, AdamW with f32 master weights for a bf16
    model (bf16 moments), weight decay 0.01, lr 1e-4, and the step."""
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import (LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    class Packed(torch.nn.Module):
        def __init__(self, m):
            super().__init__()
            self.m = m

        def forward(self, ids, cu):
            return self.m(ids, cu_seqlens=cu)

    model = Packed(LlamaForCausalLM(
        cfg, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed)))
    crit = LlamaPretrainingCriterion()
    bf16 = cfg.dtype == "bfloat16"
    opt = AdamW(1e-4, parameters=model.named_parameters(), weight_decay=0.01,
                multi_precision=bf16,
                moment_dtype="bfloat16" if bf16 else "float32")
    step = JittedTrainStep(
        model, lambda out, labels, cu: crit(out.float(), labels,
                                            cu_seqlens=cu), opt)
    return model, step


def _packed_batches(torch, dev, vocab, n, lens):
    """(n, 1, T) token rows and the (n, nseg + 1) int32 cu_seqlens stacked
    beside them, as the reference's packed benchmark feeds ``run_steps``.
    One seeded row (the reference's RandomState(1) draw) repeated, as
    phase 7 repeats its batch: on fresh random rows a randomly initialised
    model's loss only wanders around log(vocab), and a repeated row shows
    the steps learn."""
    import numpy as np

    t = sum(lens)
    ids = torch.from_numpy(np.random.RandomState(1).randint(
        0, vocab, (1, 1, t))).to(dev)
    cu = torch.tensor([0] + list(_cumsum(lens)), dtype=torch.int32,
                      device=dev)
    return (ids.expand(n, 1, t).contiguous(),
            cu[None].expand(n, -1).contiguous())


def packed_train_phase(torch, dev):
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.profiler import MFUMeter, transformer_train_flops

    warm, steps, rsteps = PACKED_TRAIN_STEPS
    cfg = _packed_cfg(torch)
    layers = cfg.num_hidden_layers
    t = sum(PACKED_LENS)
    t0 = time.perf_counter()
    model, step = _packed_setup(torch, dev, cfg, SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ids, cu = _packed_batches(torch, dev, cfg.vocab_size, warm + steps,
                              PACKED_LENS)
    n_params = sum(p.numel() for p in model.parameters())
    # attention FLOPs scale with sum(len^2): the reference folds them into
    # an effective sequence length (bench_suite.py)
    eff_seq = sum(ln * ln for ln in PACKED_LENS) / t
    flops = transformer_train_flops(n_params, t, num_layers=layers,
                                    seq_len=eff_seq, hidden=cfg.hidden_size,
                                    causal=True)
    torch.cuda.reset_peak_memory_stats()
    losses = [step([ids[i], cu[i]], [ids[i], cu[i]]) for i in range(warm)]
    ops.reset_launches()
    meter = MFUMeter(flops * steps, t * steps)
    timed = []
    res = meter.measure(lambda: timed.append(step.run_steps(
        [ids[warm:], cu[warm:]], [ids[warm:], cu[warm:]])), warmup=0,
        iters=1)
    launches = dict(ops.LAUNCHES)
    per_step = {"rms_norm": 2 * layers + 1, "rms_norm_bwd": 2 * layers + 1,
                "varlen_flash_attention": layers,
                "varlen_flash_attention_bwd": layers}
    want = {k: per_step.get(k, 0) * steps for k in launches}
    check(launches == want,
          f"packed train launches {launches}, expected {want}")
    losses = torch.cat([torch.stack(losses), timed[0]]).float().cpu()
    check(bool(torch.isfinite(losses).all()), f"non-finite loss: {losses}")
    check(float(losses[-1]) < float(losses[0]),
          f"the loss did not fall over {len(losses)} steps: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_s = res["step_time_s"] / steps
    emit({"phase": "train_llama_941m_packed_bf16", "layers": layers,
          "params": n_params, "segments": PACKED_LENS, "tokens": t,
          "eff_seq": eff_seq, "warmup_steps": warm, "timed_steps": steps,
          "step_ms": 1e3 * step_s, "train_tok_per_s": t / step_s,
          "model_tflops_per_step": flops / 1e12,
          "model_tflop_per_s": flops / step_s / 1e12,
          "mfu_vs_989_tflops": flops / step_s / PEAK_FLOPS["bfloat16"],
          "mfu_meter": res["mfu"], "losses": [float(x) for x in losses],
          "launches": launches,
          "launches_per_step": {k: v / steps for k, v in launches.items()},
          "model_init_s": init_s, "peak_mem_gb": peak})
    train_profile(torch, step, [ids[0], cu[0]], [ids[0], cu[0]],
                  label="packed_train_step")
    del model, step, timed
    torch.cuda.empty_cache()

    # the same configuration with full recompute, from the same weights
    # and batches: the same losses, a lower peak, K1 and K3 run again
    model, step = _packed_setup(
        torch, dev, _packed_cfg(torch, use_recompute=True,
                                recompute_granularity="full"), SEED)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    rlosses = step.run_steps([ids[:rsteps], cu[:rsteps]],
                             [ids[:rsteps], cu[:rsteps]]).float().cpu()
    torch.cuda.synchronize()
    rlaunches = dict(ops.LAUNCHES)
    rpeak = torch.cuda.max_memory_allocated() / 2 ** 30
    per_step.update(rms_norm=4 * layers + 1, varlen_flash_attention=2 *
                    layers)
    rwant = {k: per_step.get(k, 0) * rsteps for k in rlaunches}
    diff = float((rlosses - losses[:rsteps]).abs().max())
    emit({"phase": "train_llama_941m_packed_bf16_recompute_full",
          "steps": rsteps, "losses": [float(x) for x in rlosses],
          "no_recompute_losses": [float(x) for x in losses[:rsteps]],
          "losses_bit_equal": bool(torch.equal(rlosses, losses[:rsteps])),
          "max_loss_diff": diff, "peak_mem_gb": rpeak,
          "no_recompute_peak_mem_gb": peak, "launches": rlaunches,
          "launches_per_step": {k: v / rsteps for k, v in rlaunches.items()}})
    check(rlaunches == rwant,
          f"recompute launches {rlaunches}, expected {rwant}")
    check(diff <= 2.0 ** -7 * float(losses[:rsteps].abs().max()),
          f"recompute losses {rlosses} part from {losses[:rsteps]}")
    check(rpeak < peak, f"recompute peak {rpeak} GiB is not below {peak}")
    del model, step
    torch.cuda.empty_cache()
    return launches


def packed_parity_phase(torch, dev):
    from paddle_tpu_torch import ops

    lens, steps = PACKED_PARITY
    cfg = _packed_cfg(torch, num_hidden_layers=2, dtype="float32")
    ids, cu = _packed_batches(torch, dev, cfg.vocab_size, 1, lens)
    inputs = [ids[0], cu[0]]
    runs = []
    for plain in (False, True):
        model, step = _packed_setup(torch, dev, cfg, SEED + 4)
        ops.reset_launches()
        with (ops.plain_versions() if plain else contextlib.nullcontext()):
            loss = step._criterion(model(*inputs), *inputs)
            loss.backward()
            grads = _grads(model)
            model.zero_grad(set_to_none=True)
            losses, walls = _timed_steps(step, inputs, inputs, steps)
        launches = dict(ops.LAUNCHES)
        emit({"phase": "train_packed_parity_f32_2layer",
              "path": "plain" if plain else "kernels", "segments": lens,
              "losses": losses, "step_wall_ms": walls,
              "launches": launches})
        if not plain:
            # one more step under the profiler: the f32 step's device time
            train_profile(torch, step, inputs, inputs,
                          label="packed_f32_step")
        if plain:
            check(all(n == 0 for n in launches.values()),
                  f"plain packed path launched a kernel: {launches}")
        else:
            check(all(launches[k] > 0 for k in PACKED_F32_KERNELS + (
                "rms_norm", "rms_norm_bwd")),
                  f"packed kernel path missed a kernel: {launches}")
            # one f32 forward per attention layer and forward, never the
            # bf16 K3
            check(launches["varlen_flash_attention_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["varlen_flash_attention"] == 0,
                  f"the f32 packed forward is not one f32 launch per "
                  f"layer: {launches}")
            # one fused f32 backward per attention layer and backward,
            # never the bf16 K8
            check(launches["varlen_flash_attention_bwd_f32"]
                  == cfg.num_hidden_layers * (1 + steps)
                  and launches["varlen_flash_attention_bwd"] == 0,
                  f"the f32 packed backward is not one fused f32 launch "
                  f"per layer: {launches}")
            kernel_launches = launches
        runs.append((grads, losses))
        del model, step, loss
        torch.cuda.empty_cache()
    (gk, lk), (gp, lp) = runs
    worst = max(float((gk[n] - gp[n]).abs().max())
                / max(float(gp[n].abs().max()), 1e-30) for n in gp)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    emit({"phase": "train_packed_parity_f32_2layer",
          "grad_worst_rel_to_max": worst, "loss_worst_rel": loss_rel})
    check(worst <= 1e-5, f"packed kernel and plain grads differ: {worst}")
    check(loss_rel <= 1e-6,
          f"packed kernel and plain losses differ: {lk} {lp}")
    return kernel_launches


# ---------------------------------------------------------- phase 11, 12
INT8_ARMS = (("w8", dict(quantize="weight_only_int8")),
             ("float_dequantized", {}),
             ("w8kv8", dict(quantize="weight_only_int8", kv_dtype="int8")))
# the engine step after which each arm's pool residency is read (the arms
# schedule identically: no eos, the same token counts)
RESIDENCY_STEP = 8


def _dequantized_float_model(torch, qmodel):
    """The float oracle of a weight-only int8 model: a copy whose every
    QuantizedLinear is a float Linear holding the dequantized product it
    multiplies by (in the model's dtype), so the same cuBLAS products
    run."""
    import copy

    from paddle_tpu_torch.nn.quant import QuantizedLinear

    model = copy.deepcopy(qmodel)
    dtype = model.config.torch_dtype
    for mod in list(model.modules()):
        for name, sub in list(mod.named_children()):
            if isinstance(sub, QuantizedLinear):
                lin = torch.nn.Linear(sub.in_features, sub.out_features,
                                      bias=sub.bias is not None,
                                      device=sub.quant_weight.device,
                                      dtype=dtype)
                with torch.no_grad():
                    lin.weight.copy_(sub.dequantized_weight(dtype))
                    if sub.bias is not None:
                        lin.bias.copy_(sub.bias)
                setattr(mod, name, lin)
    return model


def _agreement(a, b):
    """Share of tokens equal before each stream's first difference."""
    same = total = 0
    for x, y in zip(a, b):
        n = 0
        while n < min(len(x), len(y)) and x[n] == y[n]:
            n += 1
        same += n
        total += len(x)
    return same / total


def int8_serving_phase(torch, dev):
    """Phase 11: int8 serving at full Llama-2-7B width and depth through
    ``create_serving_engine``: weight-only int8 (the entry point sweeps the
    seeded model), the float engine over the dequantized weights (its
    oracle: equal greedy streams), and int8 weights with int8 KV pools
    (the main path of K2's per-row mode, counters zeroed just before and
    read just after)."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    qmodel = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
    requests = make_requests(cfg.vocab_size)
    streams, records, launches, graphs = {}, {}, {}, True
    for arm, kw in INT8_ARMS:
        model = (_dequantized_float_model(torch, qmodel)
                 if arm == "float_dequantized" else qmodel)
        # the previous arm's engine sits in a reference cycle (its timed
        # methods close over it): free it before this arm's peak
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        engine, reqs, wall, split = serve(
            torch, model, requests, residency_at=RESIDENCY_STEP, **kw)
        launches[arm] = dict(ops.LAUNCHES)
        graphs = graphs and engine._graph is not None
        check_run(engine, reqs, cfg.vocab_size)
        st = engine.engine_stats()
        gen = sum(len(r.tokens) for r in reqs)
        streams[arm] = [list(r.tokens) for r in reqs]
        records[arm] = {
            "phase": "int8_serving_llama2_7b", "arm": arm, **kw,
            "layers": cfg.num_hidden_layers, "requests": len(reqs),
            "generated_tokens": gen, "wall_s": wall,
            "generated_tok_per_s": gen / wall,
            "prefill_tok_per_s": st["prefill_tokens"] / split["mixed_s"],
            "mixed_step_s": split["mixed_s"],
            "decode_quanta_s": split["decode_s"],
            "decode_steps": st["decode_quanta"] * engine.config.decode_quantum,
            "pool_kv_dtype": st["pool"]["kv_dtype"],
            "pool_bytes_in_use_at_step": {RESIDENCY_STEP:
                                          split["pool_bytes"]},
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": launches[arm]}
        del engine
        if arm == "float_dequantized":
            del model
    equal = streams["w8"] == streams["float_dequantized"]
    f_bytes = records["w8"]["pool_bytes_in_use_at_step"][RESIDENCY_STEP]
    q_bytes = records["w8kv8"]["pool_bytes_in_use_at_step"][RESIDENCY_STEP]
    records["w8"]["streams_equal_dequantized_float"] = equal
    records["w8kv8"]["residency_ratio_float_over_int8"] = f_bytes / q_bytes
    records["w8kv8"]["token_agreement_with_w8"] = _agreement(
        streams["w8kv8"], streams["w8"])
    for arm, _ in INT8_ARMS:
        emit(records[arm])
    check(equal, "weight-only int8 greedy streams differ from the "
          "dequantized float engine's")
    main_path = launches["w8kv8"]
    check(graphs, "an int8 engine's decode quantum did not run as a graph")
    for name in INT8_SERVING_KERNELS:
        check(main_path[name] > 0,
              f"kernel {name} was not launched by the int8 serving path")
    check(main_path["paged_decode_attention"] == 0
          and main_path["paged_decode_attention_int8"] == 0,
          f"the int8 KV engine launched a float or static K2: {main_path}")
    profile_phase(torch, qmodel, requests, tag="_w8kv8",
                  **dict(INT8_ARMS)["w8kv8"])
    # the dequantization's share: only an eager quantum runs its range
    profile_phase(torch, qmodel, requests, labels=("decode_quantum",),
                  tag="_w8_eager", eager=True, **dict(INT8_ARMS)["w8"])
    del qmodel
    torch.cuda.empty_cache()
    return main_path


# cached tokens of the 8 rows of phase 12's batches
STATIC_BATCH_CACHED = (0, 320, 896, 1792, 31, 500, 1024, 2046)


def _static_scale_batch(torch, g, dev):
    """One block_multihead_attention mixed batch over int8 pools with
    static per-head quant scales (K2's static int8 arm) at the serving
    shape: 8 slots, 4 of them prefilling 128-token chunks over cached
    contexts, 4 decoding one token; H = HK = 32, D = 128, block size 32,
    f32."""
    import numpy as np
    from paddle_tpu_torch.incubate.nn.functional import (
        block_multihead_attention)

    h = hk = 32
    d, bs, w = 128, 32, 64
    this = [128, 128, 128, 128, 1, 1, 1, 1]
    num_blocks = 8 * w + 1
    shape = (num_blocks, bs, hk, d)
    kp, vp = (torch.randint(-128, 128, shape, generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2))
    perm = torch.randperm(num_blocks - 1, generator=g, device=dev) + 1
    tables = perm[:8 * w].view(8, w).int().cpu().numpy()
    qkv = torch.randn(sum(this), (h + 2 * hk) * d, generator=g, device=dev)
    qs = torch.rand(hk, generator=g, device=dev) * 20 + 30
    args = dict(
        seq_lens_encoder=np.asarray([t if t > 1 else 0 for t in this],
                                    np.int32),
        seq_lens_decoder=np.asarray(STATIC_BATCH_CACHED, np.int32),
        seq_lens_this_time=np.asarray(this, np.int32), block_tables=tables,
        num_heads=h, kv_num_heads=hk, head_dim=d,
        cache_k_quant_scales=qs, cache_v_quant_scales=qs * 0.8)

    def run():
        pools = (kp.clone(), vp.clone())
        out = block_multihead_attention(qkv, *pools, **args)
        return out, pools

    return run


def _scaled_float_decode(torch, g, dev):
    """One decode step of 8 sequences through the public
    ``paged_decode_attention`` with (HK,) k and v scales over f32 pools
    (the reference's op applies such scales to any pool dtype;
    block_multihead_attention passes them only to int8 pools): the
    static batch's cached lengths plus the new token, H = HK = 32, D =
    128, block size 32."""
    from paddle_tpu_torch import ops

    h = hk = 32
    d, bs, w = 128, 32, 64
    num_blocks = 8 * w + 1
    kp, vp = (torch.randn((num_blocks, bs, hk, d), generator=g, device=dev)
              for _ in range(2))
    perm = torch.randperm(num_blocks - 1, generator=g, device=dev) + 1
    tables = perm[:8 * w].view(8, w).int()
    lens = torch.tensor([c + 1 for c in STATIC_BATCH_CACHED],
                        dtype=torch.int32, device=dev)
    q = torch.randn(8, h, d, generator=g, device=dev)
    ks = torch.rand(hk, generator=g, device=dev) * 1.5 + 0.25
    vs = ks * 0.8

    def run():
        return ops.paged_decode_attention(q, kp, vp, tables, lens,
                                          k_scale=ks, v_scale=vs)

    return run


def _record_runner_up(engine, table):
    """Wrap the engine's token choice to keep, for every (request, tokens
    emitted so far), the top two token ids and their logit gap. The
    record reads them on the host at every step, so the engine runs its
    quantum eagerly (phase 12 holds the captured quantum to this eager
    kernel run in a run of its own)."""
    engine._eager = True
    select = engine._select

    def traced(logits, slots, steps):
        top = logits.float().topk(2, dim=-1)
        ids, vals = top.indices.tolist(), top.values.tolist()
        owner = {r.slot: r for r in engine.scheduler.live()}
        rows = range(engine.config.num_slots) if slots is None else slots
        for i, (slot, step) in enumerate(zip(rows, steps.tolist())):
            if slot in owner:
                table[(owner[slot].req_id, int(step))] = (
                    ids[i][0], ids[i][1], vals[i][0] - vals[i][1])
        return select(logits, slots, steps)

    engine._select = traced


def _partings(streams, tables, reqs):
    """Each request's first differing token between two runs, with both
    runs' (best, runner-up, gap) there; a parting is a runner-up swap
    when each run's token is the other run's second choice."""
    out = []
    for (a, b), r0, r1 in zip(zip(*streams), *reqs):
        j = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        t0, t1 = tables[0][(r0.req_id, j)], tables[1][(r1.req_id, j)]
        out.append({"request": len(out), "token": j, "kernel": t0,
                    "plain": t1, "swap": (t0[0], t0[1]) == (a[j], b[j])
                    and (t1[0], t1[1]) == (b[j], a[j])})
    return out


def int8_parity_phase(torch, dev):
    """Phase 12: f32 parity at Llama-2-7B width with 4 layers, kernel path
    against plain path: the weight-only int8 engine (equal greedy
    streams), the int8-KV engine, then STATIC (HK,) scales (the TPU
    kernel's own has_scales arm) in a block_multihead_attention mixed
    batch over int8 pools and in a paged_decode_attention step over f32
    pools, within f32 1e-4, their counters zeroed just before and read
    just after each kernel-path call. The int8-KV engine's streams are
    equal up to partings at near-ties: a 1-ulp difference before
    ``quantize_kv_rows`` can round a KV element to the neighbouring int8
    value (1/127 of its row's range), so each parting must be a runner-up
    swap (each path's token the other's second choice) and the share of
    equal tokens is reported."""
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(num_hidden_layers=4, dtype="float32")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    requests = make_requests(cfg.vocab_size)
    for arm, kw in (INT8_ARMS[0], INT8_ARMS[2]):
        # the kernel path as the card runs it: the quantum captured
        ops.reset_launches()
        engine, reqs, wall, _ = serve(torch, model, requests, **kw)
        check_run(engine, reqs, cfg.vocab_size)
        check(engine._graph is not None,
              f"{arm}: the decode quantum was not captured")
        captured = [list(r.tokens) for r in reqs]
        captured_launches = dict(ops.LAUNCHES)
        emit({"phase": "int8_parity_f32_4layer", "arm": arm,
              "path": "kernels_captured", "wall_s": wall,
              "launches": captured_launches})
        del engine
        streams, launches, tables, reqs_by_path = [], [], [], []
        for plain in (False, True):
            table = {}
            ops.reset_launches()
            with (ops.plain_versions() if plain
                  else contextlib.nullcontext()):
                engine, reqs, wall, _ = serve(
                    torch, model, requests,
                    on_engine=lambda e, t=table: _record_runner_up(e, t),
                    **kw)
            check_run(engine, reqs, cfg.vocab_size)
            streams.append([list(r.tokens) for r in reqs])
            launches.append(dict(ops.LAUNCHES))
            tables.append(table)
            reqs_by_path.append(reqs)
            emit({"phase": "int8_parity_f32_4layer", "arm": arm,
                  "path": "plain" if plain else "kernels", "wall_s": wall,
                  "launches": launches[-1]})
            del engine
        check(all(n == 0 for n in launches[1].values()),
              f"plain path launched a kernel: {launches[1]}")
        partings = _partings(streams, tables, reqs_by_path)
        emit({"phase": "int8_parity_f32_4layer", "arm": arm,
              "captured_equals_eager_kernels": captured == streams[0],
              "streams_equal": not partings,
              "requests_equal": len(requests) - len(partings),
              "requests": len(requests),
              "token_agreement": _agreement(*streams),
              "partings": partings})
        check(captured == streams[0], f"{arm}: the captured quantum's "
              f"streams differ from the eager kernel path's")
        if arm == "w8":
            check(launches[0]["paged_decode_attention"] > 0
                  and captured_launches["paged_decode_attention"] > 0,
                  f"kernel path missed K2: {launches[0]}, "
                  f"{captured_launches}")
            check(not partings, "weight-only int8 engine: kernel and plain "
                  "greedy streams differ")
        else:
            check(launches[0]["paged_decode_attention_int8_rows"] > 0
                  and captured_launches[
                      "paged_decode_attention_int8_rows"] > 0,
                  f"kernel path missed K2's per-row mode: {launches[0]}, "
                  f"{captured_launches}")
            check(all(p["swap"] for p in partings),
                  f"int8-KV engine: a parting is no runner-up swap: "
                  f"{partings}")
    del model
    gc.collect()
    torch.cuda.empty_cache()

    launches = {}
    for label, kernels, make in (
            ("block_mha_static_int8", STATIC_INT8_KERNELS,
             _static_scale_batch),
            ("scaled_float_decode", SCALED_FLOAT_KERNELS,
             _scaled_float_decode)):
        run = make(torch, torch.Generator(device=dev).manual_seed(SEED + 2),
                   dev)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = run()
        torch.cuda.synchronize()
        launches[label] = dict(ops.LAUNCHES)
        with ops.plain_versions():
            ref = run()
        if isinstance(out, tuple):  # block_multihead_attention's pools
            (out, pools), (ref, ref_pools) = out, ref
            pools_equal = all(torch.equal(a, b)
                              for a, b in zip(pools, ref_pools))
        else:
            pools_equal = True
        err, ok, tol = close(torch, out, ref, torch.float32)
        ok = ok and bool(torch.isfinite(out).all())
        emit({"phase": label + "_f32", "max_abs_err": err, "tol": tol,
              "ok": ok, "pools_equal": pools_equal,
              "launches": launches[label]})
        check(ok and pools_equal,
              f"{label}: kernel path differs from plain (err {err}, pools "
              f"equal {pools_equal})")
        for name in kernels:
            check(launches[label][name] > 0,
                  f"kernel {name} was not launched by the {label} run")
        del run, out, ref
    return launches


# ---------------------------------------------------------------- phase 13
def _quantum_timing(torch, model, requests, eager, smi, n=3, **kw):
    """The decode dispatch, eagerly or as replays of its captured graph,
    on phase 3's knobs and first 8 requests: after the prefill and one
    decode step (the capture), ``n`` dispatches each timed from
    ``step_dispatch`` (host ms: until it returns) to the end of
    ``step_collect`` (wall ms), then one more under torch.profiler
    (device ms and busy share, as ``profile_phase``)."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, **serve_kw(**kw))
    engine._eager = eager
    for r in requests[:8]:
        engine.submit(**r)
    while engine.scheduler.prefilling() or not engine.scheduler.decoding():
        engine.step()
    engine.step()
    host, wall, replays = [], [], []
    for _ in range(n + 1):
        torch.cuda.synchronize()
        prof = None
        if len(wall) == n:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        pending = engine.step_dispatch()
        t1 = time.perf_counter()
        check(pending is not None, "a timed step was no decode dispatch")
        engine.step_collect(pending)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
            rec = _profile_record(torch, prof, "decode_quantum", 1e6 * (
                t2 - t0))
        else:
            host.append(1e3 * (t1 - t0))
            wall.append(1e3 * (t2 - t0))
            replays.append(0 if eager else pending["k"])
    del engine
    return {"gpu": smi, "wall_ms": wall, "host_ms_per_dispatch": host,
            "replays_per_dispatch": replays,
            "profiled_wall_ms": rec["wall_ms_under_profiler"],
            "device_ms": rec["device_ms"],
            "device_busy_share": rec["device_busy_share"],
            "kernels_launched": rec["kernels_launched"],
            "device_ms_by_family": rec["device_ms_by_family"]}


def _overlapped(torch, model, traces):
    """Two engines (one per (requests, knobs) trace) on one model, driven
    dispatch, dispatch, collect, collect until both are idle; returns
    each engine's streams and the wall."""
    from paddle_tpu_torch import create_serving_engine

    engines = [create_serving_engine(model, **serve_kw(**kw))
               for _, kw in traces]
    reqs = [[e.submit(**r) for r in tr] for e, (tr, _) in zip(engines,
                                                              traces)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while any(e.has_work for e in engines):
        pending = [e.step_dispatch() if e.has_work else None
                   for e in engines]
        for e, p in zip(engines, pending):
            e.step_collect(p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(e._graph is not None for e in engines),
          "an overlapped engine did not capture its quantum")
    streams = [[list(r.tokens) for r in rs] for rs in reqs]
    del engines
    return streams, wall


def graphs_serving_phase(torch, dev, smi):
    """Phase 13 (serving): full Llama-2-7B bf16, phase 3's knobs and
    requests. The captured quantum against its eager body (greedy,
    sampled at fixed seeds), ``multi_quantum=4`` against 1, two engines
    driven dispatch, dispatch, collect, collect against ``step()``, and
    phase 11's w8kv8 engine captured against eager: streams equal token
    for token. Then the decode dispatch's wall, host, device ms and busy
    share, eager and captured, float and w8kv8."""
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    requests = make_requests(cfg.vocab_size)
    sampled = [dict(r, seed=i) for i, r in enumerate(requests)]
    w8kv8 = dict(INT8_ARMS)["w8kv8"]
    arms = (("greedy", requests, {}, (True, False)),
            ("sampling", sampled, SAMPLING, (True, False)),
            ("multi_quantum_4", requests, dict(multi_quantum=4), (False,)),
            ("w8kv8", requests, w8kv8, (True, False)))
    runs, timing = {}, {}
    model = None
    for name, reqs, kw, modes in arms:
        if model is None or name == "w8kv8":
            # the w8kv8 engine sweeps its model in place: a fresh one
            del model
            gc.collect()
            torch.cuda.empty_cache()
            model = LlamaForCausalLM(
                cfg, generator=torch.Generator(device=dev).manual_seed(SEED))
        for eager in modes:
            gc.collect()
            torch.cuda.empty_cache()
            engine, rs, wall, split = serve(torch, model, reqs, eager=eager,
                                            **kw)
            check_run(engine, rs, cfg.vocab_size)
            check(eager == (engine._graph is None),
                  f"{name}: eager={eager} but graph {engine._graph}")
            st = engine.engine_stats()
            runs[name, eager] = {
                "streams": [list(r.tokens) for r in rs], "wall_s": wall,
                "decode_dispatch_s": split["decode_s"],
                "mixed_step_s": split["mixed_s"],
                "decode_quanta": st["decode_quanta"], "steps": st["steps"]}
            del engine
        if name in ("greedy", "w8kv8"):
            timing[name] = {("eager" if eager else "captured"):
                            _quantum_timing(torch, model, requests, eager,
                                            smi, **kw)
                            for eager in (True, False)}
        if name == "sampling":
            overlapped, o_wall = _overlapped(
                torch, model, ((requests, {}), (sampled, SAMPLING)))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    equal = {name: runs[name, True]["streams"] == runs[name, False]["streams"]
             for name in ("greedy", "sampling", "w8kv8")}
    greedy = runs["greedy", False]
    mq = runs["multi_quantum_4", False]
    equal["multi_quantum_4_vs_1"] = mq["streams"] == greedy["streams"]
    equal["dispatch_collect_vs_step"] = overlapped == [
        greedy["streams"], runs["sampling", False]["streams"]]
    emit({"phase": "graphs_llama2_7b_serving", "gpu": smi,
          "streams_equal": equal,
          "w8kv8_token_agreement": _agreement(
              runs["w8kv8", False]["streams"],
              runs["w8kv8", True]["streams"]),
          "decode_quanta": {"k1": greedy["decode_quanta"],
                            "k4": mq["decode_quanta"]},
          "host_steps": {"k1": greedy["steps"], "k4": mq["steps"]},
          "overlapped_wall_s": o_wall,
          "runs": {f"{n}_{'eager' if e else 'captured'}":
                   {k: v for k, v in r.items() if k != "streams"}
                   for (n, e), r in runs.items()}})
    for name, rec in timing.items():
        emit({"phase": "graphs_llama2_7b_decode_dispatch", "engine": name,
              **rec})
    check(all(equal.values()), f"captured and eager streams differ: {equal}")
    check(mq["decode_quanta"] == greedy["decode_quanta"],
          f"multi_quantum=4 ran {mq['decode_quanta']} quanta, K=1 "
          f"{greedy['decode_quanta']}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import paddle_tpu_torch  # noqa: F401  (fails outside a checkout)

    # full f32 products on the card (the f32 parity phase relies on it)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = env_phase(torch)
    primary = kernel_phase(torch, dev)
    launches = e2e_phase(torch, dev)
    parity_phase(torch, dev)
    gen_launches = generate_phase(torch, dev, smi)
    generate_parity_phase(torch, dev)
    train_launches = train_phase(torch, dev)
    parity_launches = train_parity_phase(torch, dev)
    packed_launches = packed_train_phase(torch, dev)
    packed_parity_launches = packed_parity_phase(torch, dev)
    int8_launches = int8_serving_phase(torch, dev)
    batch_launches = int8_parity_phase(torch, dev)
    graphs_serving_phase(torch, dev, smi)
    paths = {"serving": launches, "generate": gen_launches,
             "train": train_launches, "train_f32_parity": parity_launches,
             "packed_train": packed_launches,
             "packed_f32_parity": packed_parity_launches,
             "int8_serving": int8_launches, **batch_launches}
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        rec = primary[name]
        path = KERNEL_PATH.get(name) or (
            "serving" if name in SERVING_KERNELS else
            "train" if name in TRAIN_KERNELS else
            "packed_train" if name in PACKED_KERNELS else "generate")
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": paths[path][name],
            "launches_path": path,
            "launches_by_path": {k: v[name] for k, v in paths.items()},
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "event_ms": rec["event_ms"], "timers": rec["timers"],
            "dtype": rec["dtype"], "shape": rec["shape"],
            **({"library_call": rec["library_call"],
                "library_calls_ms": rec["library_calls_ms"]}
               if "library_call" in rec else {})})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
