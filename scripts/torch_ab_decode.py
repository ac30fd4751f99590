"""Time the decode attention kernels of the PyTorch port on one GPU (K2 in
its four modes, K5), for an A/B of two trees of the repository on one
card.

Run from the root of the tree to time (``paddle_tpu_torch`` is imported
from the current directory, and the tree builds its own kernel library),
alternating trees on one card, e.g. parent, change, change, parent:

    (cd parent_tree && python /path/to/torch_ab_decode.py parent)

Seeded random inputs, D = 128, block size 32. The cases:
- ``phase2_*``: chip_smoke.py's phase-2 shapes: K2 over B = 8 sequences
  of 1-2,048 tokens (table width 64) at H / HK = 32/32, 32/8 and 28/4
  (float pools; the scaled mode and both int8 modes at 32/32 and, for
  int8, 32/8), K5 over B = 4 rows of a 4,096-token cache of 1-4,096 live
  tokens at 32/8, 32/32 and 28/4; bf16 and f32;
- ``serving_*``: the serving run's decode step, B = 8, HK = 32, 200-576
  tokens in a table of width 64 (float bf16 pools and int8 pools with
  per-row scales);
- ``generate``: the generate run's decode step, K5 at B = 4, HK = 8, 4,096
  live tokens in a 4,096-token buffer, bf16;
- ``sweep_b*_hk*``: K2 bf16, group 1, every sequence at the table's full
  reach of 2,048 tokens, from B x HK = 1 to 2,048.
Per case: CUDA-event ms per call over 30 back-to-back calls after 5
warm-up calls (launch gaps included; the median of 5 rounds), the summed
kernel time per call under torch.profiler (``device_ms``), the host's
time per call to enqueue 30 calls (``host_us``: the wrapper's Python and
the launch; the least of the 5 rounds), whether two calls are bit-equal,
and the largest |kernel - plain|. The event time of back-to-back calls
is about the larger of the device time and the host time. Prints one
JSON line with the card's name and power limit. Exits non-zero without a
GPU. ``--quick`` times the phase-2 bf16 cases alone.
"""
import itertools
import json
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
from paddle_tpu_torch import ops  # noqa: E402
from paddle_tpu_torch.ops.paged_attention import (  # noqa: E402
    _paged_decode_attention_rows, _paged_decode_attention_rows_plain)

D, BS = 128, 32
PHASE2_LENS = [1, 31, 32, 33, 500, 1024, 2047, 2048]
SERVING_LENS = [200, 260, 320, 380, 440, 500, 540, 576]
K5_LENS = [1, 1500, 3000, 4096]


def event_ms(fn, iters=30, warmup=5, rounds=5):
    """(CUDA-event ms per call, host us per call): the median event time
    and the least host time over ``rounds`` rounds of ``iters`` calls (the
    host's clock is the noisier: other work on the machine only adds)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ms, host = [], []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        host.append((time.perf_counter() - t0) / iters)
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / iters)
    return sorted(ms)[rounds // 2], min(host) * 1e6


def device_ms(fn, iters=10):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
             for ev in prof.key_averages()
             if ev.device_type == torch.autograd.DeviceType.CUDA)
    return us / iters / 1e3


def paged(g, dev, dtype, b, h, hk, lens, width, int8=False):
    nb = b * width + 1
    shape = (nb, BS, hk, D)
    if int8:
        kp, vp = (torch.randint(-128, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
    else:
        kp, vp = (torch.randn(*shape, generator=g, device=dev).to(dtype)
                  for _ in range(2))
    perm = torch.randperm(nb - 1, generator=g, device=dev) + 1
    tables = torch.full((b, width), 10 ** 7, dtype=torch.int32, device=dev)
    nxt = 0
    for i, ln in enumerate(lens):
        n = -(-ln // BS)
        tables[i, :n] = perm[nxt:nxt + n].int()
        nxt += n
    q = torch.randn(b, h, D, generator=g, device=dev).to(dtype)
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32,
                                           device=dev)


def k2_cases(g, dev, dtypes, quick):
    for dtype in dtypes:
        name = str(dtype).removeprefix("torch.")
        for h, hk in ((32, 32), (32, 8), (28, 4)):
            q, kp, vp, tb, ln = paged(g, dev, dtype, 8, h, hk, PHASE2_LENS,
                                      64)
            yield (f"phase2_k2_{name}_{h}_{hk}",
                   lambda: ops.paged_decode_attention(q, kp, vp, tb, ln),
                   lambda: ops.paged_decode_attention_plain(q, kp, vp, tb,
                                                            ln))
            if hk == 32:
                ks = torch.rand(hk, generator=g, device=dev) + 0.5
                vs = torch.rand(hk, generator=g, device=dev) + 0.5
                yield (f"phase2_k2_scaled_{name}",
                       lambda: ops.paged_decode_attention(
                           q, kp, vp, tb, ln, k_scale=ks, v_scale=vs),
                       lambda: ops.paged_decode_attention_plain(
                           q, kp, vp, tb, ln, k_scale=ks, v_scale=vs))
            if hk == 4:
                continue
            q, kp, vp, tb, ln = paged(g, dev, dtype, 8, h, hk, PHASE2_LENS,
                                      64, int8=True)
            ks = torch.rand(hk, generator=g, device=dev) * 0.02 + 0.005
            vs = torch.rand(hk, generator=g, device=dev) * 0.02 + 0.005
            rks, rvs = (torch.rand(kp.shape[:3], generator=g, device=dev)
                        * 0.02 + 0.005 for _ in range(2))
            yield (f"phase2_k2_int8_static_{name}_{h}_{hk}",
                   lambda: ops.paged_decode_attention(
                       q, kp, vp, tb, ln, k_scale=ks, v_scale=vs),
                   lambda: ops.paged_decode_attention_plain(
                       q, kp, vp, tb, ln, k_scale=ks, v_scale=vs))
            yield (f"phase2_k2_int8_rows_{name}_{h}_{hk}",
                   lambda: _paged_decode_attention_rows(
                       q, kp, vp, rks, rvs, tb, ln),
                   lambda: _paged_decode_attention_rows_plain(
                       q, kp, vp, rks, rvs, tb, ln))
    if quick:
        return
    q, kp, vp, tb, ln = paged(g, dev, torch.bfloat16, 8, 32, 32,
                              SERVING_LENS, 64)
    yield ("serving_k2_bfloat16",
           lambda: ops.paged_decode_attention(q, kp, vp, tb, ln),
           lambda: ops.paged_decode_attention_plain(q, kp, vp, tb, ln))
    q, kp, vp, tb, ln = paged(g, dev, torch.bfloat16, 8, 32, 32,
                              SERVING_LENS, 64, int8=True)
    rks, rvs = (torch.rand(kp.shape[:3], generator=g, device=dev) * 0.02
                + 0.005 for _ in range(2))
    yield ("serving_k2_int8_rows_bfloat16",
           lambda: _paged_decode_attention_rows(q, kp, vp, rks, rvs, tb, ln),
           lambda: _paged_decode_attention_rows_plain(q, kp, vp, rks, rvs,
                                                      tb, ln))
    for b, hk in ((1, 1), (1, 8), (4, 8), (8, 8), (8, 32), (32, 32),
                  (64, 32)):
        q, kp, vp, tb, ln = paged(g, dev, torch.bfloat16, b, hk, hk,
                                  [2048] * b, 64)
        yield (f"sweep_b{b}_hk{hk}",
               lambda: ops.paged_decode_attention(q, kp, vp, tb, ln),
               lambda: ops.paged_decode_attention_plain(q, kp, vp, tb, ln))


def k5_cases(g, dev, dtypes, quick):
    shapes = [(f"phase2_k5_{str(dt).removeprefix('torch.')}_{h}_{hk}", dt,
               h, hk, K5_LENS) for dt in dtypes
              for h, hk in ((32, 8), (32, 32), (28, 4))]
    if not quick:
        shapes.append(("generate", torch.bfloat16, 32, 8, [4096] * 4))
    for name, dtype, h, hk, lens in shapes:
        q = torch.randn(len(lens), h, D, generator=g, device=dev).to(dtype)
        kc, vc = (torch.randn(len(lens), 4096, hk, D, generator=g,
                              device=dev).to(dtype) for _ in range(2))
        ln = torch.tensor(lens, dtype=torch.int32, device=dev)
        yield (name, lambda: ops.decode_attention(q, kc, vc, ln),
               lambda: ops.decode_attention_plain(q, kc, vc, ln))


def main(label, quick):
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dtypes = (torch.bfloat16,) if quick else (torch.bfloat16, torch.float32)
    out = {"tree": label, "gpu": gpu, "cases": {}}
    with torch.no_grad():
        # one case at a time: its inputs live only while it runs
        for name, kernel, plain in itertools.chain(
                k2_cases(g, dev, dtypes, quick),
                k5_cases(g, dev, dtypes, quick)):
            first, second = kernel(), kernel()
            ref = plain()
            ms, host_us = event_ms(kernel)
            out["cases"][name] = {
                "ms": ms, "device_ms": device_ms(kernel), "host_us": host_us,
                "bit_equal": torch.equal(first, second),
                "max_err": float((first.float() - ref.float()).abs().max())}
            del first, second, ref
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--quick"]
    main(args[0] if args else "tree", "--quick" in sys.argv)
