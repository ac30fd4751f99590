#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. environment: the card's name and power limit, torch / CUDA / nvcc
   versions, and the build of the hand-written kernels from
   ``paddle_tpu_torch/csrc`` (nvcc, sm_90a) with its time;
2. each kernel against its plain PyTorch version on the card, at the
   serving path's shapes, in bf16 and f32: max error, kernel / plain /
   library-call device times (torch.profiler, summed kernel durations),
   the kernel's CUDA-event time over back-to-back calls (launch gaps
   included) and the least time the card could take (``bound_ms``);
3. the serving main path end to end: full Llama-2-7B in bf16 (32 layers,
   seeded random weights) through ``create_serving_engine``, 16 requests;
   launch counters zeroed just before and read just after; then a
   torch.profiler breakdown of one mixed step and one decode quantum;
4. the kernel path against the plain path end to end, at full width and
   4 layers in f32 (no argmax near-ties): greedy streams must be equal.

The line before the last is the ``{"kernels": [...]}`` record; the last
line is ``{"ok": true, "device": {...}}``. Without CUDA it prints no
result and exits 2.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # f32 outside the tensor cores
SEED = 0


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


def device_ms(torch, fn, iters=10):
    """GPU time of one call: the summed durations of every kernel the call
    launches (torch.profiler), without the launch gaps between them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(_device_us(ev) for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA)
    check(total_us > 0, "the profiler recorded no device time")
    return total_us / iters / 1e3


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
    """(max abs error, within tolerance). f32: 1e-4 relative + absolute
    (summation order only). bf16: one rounding step of the reference
    value (both sides compute in f32 and round once), plus 1e-2 absolute
    where the probabilities are rounded to bf16 before P.V (K3, as the
    TPU kernel does): a p on a rounding boundary may round one step
    differently when the f32 scores differ in their last bits, which
    moves the output by up to 2^-8 * |v|."""
    if dtype != torch.bfloat16:
        rtol, atol = 1e-4, 1e-4
    else:
        rtol, atol = 2.0 ** -7, (1e-2 if p_rounded else 1e-3)
    diff = (out.float() - ref.float()).abs()
    ok = bool((diff <= atol + rtol * ref.float().abs()).all())
    return float(diff.max()), ok, {"rtol": rtol, "atol": atol}


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
        for rows in (8, 1024):
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


def _paged_inputs(torch, g, dev, dtype, b, h, hk, d, bs, lens_list):
    w = 2048 // bs
    num_blocks = b * w + 1
    kp = torch.randn(num_blocks, bs, hk, d, generator=g, device=dev)
    vp = torch.randn(num_blocks, bs, hk, d, generator=g, device=dev)
    kp, vp = kp.to(dtype), vp.to(dtype)
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

    b, d, bs = 8, 128, 32
    lens_list = [1, 31, 32, 33, 500, 1024, 2047, 2048]
    for dtype in (torch.bfloat16, torch.float32):
        for h, hk in ((32, 32), (32, 8)):
            q, kp, vp, tables, lens = _paged_inputs(
                torch, g, dev, dtype, b, h, hk, d, bs, lens_list)
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


def k3_cases(torch, g, dev):
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
                bound=bound_ms(nbytes, 4.0 * pairs * h * d,
                               str(dtype).removeprefix("torch.")))


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
    "varlen_flash_attention": (
        "cuda", "paddle_tpu_torch/csrc/varlen_flash_attention.cu",
        "paddle_tpu/ops/pallas/varlen_flash_attention.py:160"),
}


def kernel_phase(torch, dev):
    g = torch.Generator(device=dev).manual_seed(SEED)
    primary = {}
    # one case at a time: each case's inputs live only while it runs
    for case in itertools.chain(k1_cases(torch, g, dev),
                                k2_cases(torch, g, dev),
                                k3_cases(torch, g, dev)):
        out = case["kernel"]()
        ref = case["plain"]()
        torch.cuda.synchronize()
        err, ok, tol = close(torch, out, ref, case["dtype"],
                             case["name"] == "varlen_flash_attention")
        rec = {"phase": "kernel_check", "name": case["name"],
               "dtype": str(case["dtype"]).removeprefix("torch."),
               "shape": case["shape"], "max_abs_err": err, "tol": tol,
               "ok": ok,
               "ms": device_ms(torch, case["kernel"]),
               "plain_ms": device_ms(torch, case["plain"], iters=3),
               "library_ms": device_ms(torch, case["library"]),
               "event_ms": cuda_ms(torch, case["kernel"]),
               "bound_ms": case["bound"][0], "bound_by": case["bound"][1]}
        emit(rec)
        check(ok, f"{case['name']} disagrees with its plain version: {rec}")
        if case["primary"]:
            primary[case["name"]] = rec
        del out, ref
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


def serve(torch, model, requests):
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, num_slots=8, block_size=32,
                                   max_context=2048, prefill_chunk=128,
                                   decode_quantum=8)
    split = {"mixed_s": 0.0, "decode_s": 0.0}

    def timed(fn, key):
        def run():
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            split[key] += time.perf_counter() - t0
        return run

    engine._mixed_step = timed(engine._mixed_step, "mixed_s")
    engine._decode_quantum = timed(engine._decode_quantum, "decode_s")
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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
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
          "prefill_tokens": st["prefill_tokens"], "launches": launches,
          "model_init_s": init_s,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30})
    del engine
    profile_phase(torch, model, requests)
    del model
    torch.cuda.empty_cache()
    return launches


def _kernel_family(name):
    for key, fam in (("rms_norm_kernel", "K1 rms_norm"),
                     ("paged_split_kernel", "K2 paged_decode"),
                     ("paged_merge_kernel", "K2 paged_decode"),
                     ("varlen_fwd_", "K3 varlen_flash"),
                     ("gemm", "matmul"), ("nvjet", "matmul"),
                     ("cutlass", "matmul"), ("xmma", "matmul")):
        if key in name:
            return fam
    return "other"


def profile_phase(torch, model, requests):
    """Where one mixed step and one decode quantum spend device time:
    torch.profiler over a single engine step each (the main run's counts
    are read before this). Device busy share = summed kernel time over the
    step's wall time under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    from paddle_tpu_torch import create_serving_engine

    engine = create_serving_engine(model, num_slots=8, block_size=32,
                                   max_context=2048, prefill_chunk=128,
                                   decode_quantum=8)
    for r in requests[:8]:
        engine.submit(**r)
    for label in ("mixed_step", "decode_quantum"):
        if label == "decode_quantum":
            while engine.scheduler.prefilling():
                engine.step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        fams, n_kernels = {}, 0
        for ev in prof.key_averages():
            dev_us = _device_us(ev)
            if ev.device_type == torch.autograd.DeviceType.CUDA \
                    and dev_us > 0:
                fam = _kernel_family(ev.key)
                fams[fam] = fams.get(fam, 0.0) + dev_us
                n_kernels += ev.count
        busy = sum(fams.values())
        emit({"phase": "profile", "step": label,
              "wall_ms_under_profiler": wall_us / 1e3,
              "device_ms": busy / 1e3 if busy else "not measured",
              "device_busy_share": busy / wall_us if busy
              else "not measured",
              "kernels_launched": n_kernels,
              "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
                  fams.items(), key=lambda kv: -kv[1])}})
    del engine


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
    check(all(n > 0 for n in launches[0].values()),
          f"kernel path missed a kernel: {launches[0]}")
    check(all(n == 0 for n in launches[1].values()),
          f"plain path launched a kernel: {launches[1]}")
    same = [a == b for a, b in zip(*streams)]
    emit({"phase": "parity_f32_4layer", "streams_equal": all(same),
          "requests_equal": sum(same), "requests": len(same)})
    check(all(same), "kernel and plain greedy streams differ")
    del model
    torch.cuda.empty_cache()


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
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        rec = primary[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "event_ms": rec["event_ms"], "dtype": rec["dtype"],
            "shape": rec["shape"]})
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
