"""Time the varlen (packed) flash-attention backward of the PyTorch port on
one GPU, for an A/B of two trees of the repository on one card.

Run from the root of the tree to time (``paddle_tpu_torch`` is imported
from the current directory, and the tree builds its own kernel library),
alternating trees on one card, e.g. parent, change, change, parent:

    (cd parent_tree && python /path/to/torch_ab_varlen_bwd.py parent)

bf16, seeded random inputs, causal, at chip_smoke's K8 shapes: the packed
941M row (T = 4,096 in 8 segments, H = HK = 32, D = 64), the same row at
GQA 32/8, D = 128 with a window of 512, cross lengths and empty segments.
Per shape: the backward from the forward's lse and delta (one launch of
the fused kernel where the tree has ``varlen_flash_attention_bwd_fused``,
else the dq and the dk/dv kernels), CUDA-event ms per call over 30
back-to-back calls after 5 warm-up calls, whether two calls are bit-equal,
the largest |grad - plain| over dq, dk and dv, and the sum of per-segment
SDPA backwards (dq, dk, dv through autograd) as the library yardstick.
Prints one JSON line with the card's name and power limit. Exits non-zero
without a GPU. Then the f32 route at the packed row (``packed_941m_f32``:
the fused f32 kernel where the tree has it, else K8a and K8b), with the
same fields, its error also over each gradient's largest |plain|, and
K3's f32 forward at the packed row (``packed_941m_f32_fwd``: event ms,
bit equality, its largest |out - plain| and |lse - plain|, and the two
library calls of chip_smoke's K3 f32 row). With
``--hk-sweep`` it times instead the fused kernel alone at the packed row
(D = 64) with 32, 8, 4 and 1 KV heads: the same steps in fewer, longer
CTAs; with ``--f32`` only the f32 route.
"""
import json
import subprocess
import sys

import torch

sys.path.insert(0, ".")
from chip_smoke import _segment_library  # noqa: E402
from paddle_tpu_torch import ops  # noqa: E402

PACKED = [1600, 800, 600, 400, 300, 200, 120, 76]
# (label, lens_q, lens_k or None, H, HK, D, window)
SHAPES = (("packed_941m", PACKED, None, 32, 32, 64, None),
          ("gqa_window", PACKED, None, 32, 8, 128, 512),
          ("cross_lengths", [1024, 512, 300, 76], [1600, 512, 700, 76], 32,
           32, 64, None),
          ("empty_segments", [1600, 0, 800, 600, 0, 400, 300, 200, 120, 76,
                              0], None, 32, 32, 64, None))


def event_ms(fn, iters=30, warmup=5):
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


def _cu(lens, dev):
    out = [0]
    for n in lens:
        out.append(out[-1] + n)
    return torch.tensor(out, dtype=torch.int32, device=dev)


def hk_sweep(dev, g):
    cu = _cu(PACKED, dev)
    t = int(cu[-1])
    out = {}
    for hk in (32, 8, 4, 1):
        q, do = (torch.randn(t, 32, 64, generator=g, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(t, hk, 64, generator=g, device=dev).bfloat16()
                for _ in range(2))
        o, lse = ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                            return_lse=True)
        delta = ops.varlen_flash_attention_bwd_delta(o, do)
        out[f"hk{hk}_ms"] = event_ms(
            lambda: ops.varlen_flash_attention_bwd_fused(
                q, k, v, do, lse, delta, cu, cu, True))
    return out


def f32_forward(dev, g):
    """K3's f32 forward at the packed row: event ms, whether two calls are
    bit-equal, its largest |out - plain| and |lse - plain|, and both
    library yardsticks of chip_smoke's K3 row (one block-diagonal-masked
    SDPA call over the row, the per-segment is_causal SDPA calls)."""
    from chip_smoke import _segment_forward_library

    _, lens, _, h, hk, d, window = SHAPES[0]
    cu = _cu(lens, dev)
    t = int(cu[-1])
    q = torch.randn(t, h, d, generator=g, device=dev)
    k, v = (torch.randn(t, hk, d, generator=g, device=dev)
            for _ in range(2))

    def fwd():
        return ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                          return_lse=True)
    first, second = fwd(), fwd()
    ref = ops.varlen_flash_attention_plain(q, k, v, cu, cu, True)
    lib = _segment_forward_library(torch, q, k, v, lens, window)
    return {"ms": event_ms(fwd),
            "bit_equal": all(torch.equal(a, b)
                             for a, b in zip(first, second)),
            "max_err": float((first[0] - ref[0]).abs().max()),
            "lse_max_err": float((first[1] - ref[1]).abs().max()),
            **{f"{name}_ms": event_ms(fn) for name, fn in lib.items()}}


def main(label, only_f32=False):
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    fused = hasattr(ops, "varlen_flash_attention_bwd_fused")
    # the tree's f32 backward is one fused launch
    fused_f32 = "varlen_flash_attention_bwd_f32" in ops.LAUNCHES
    out = {"tree": label, "gpu": gpu, "fused": fused,
           "fused_f32": fused_f32}
    if label == "--hk-sweep":
        print(json.dumps({**out, **hk_sweep(dev, g)}), flush=True)
        return
    cases = [(name, dt, *rest) for name, *rest in SHAPES
             for dt in (torch.bfloat16,)] * (not only_f32)
    out["packed_941m_f32_fwd"] = f32_forward(dev, g)
    cases.append(("packed_941m_f32", torch.float32, *SHAPES[0][1:]))
    for name, dtype, lens_q, lens_k, h, hk, d, window in cases:
        cu_q = _cu(lens_q, dev)
        cu_k = cu_q if lens_k is None else _cu(lens_k, dev)
        tq, tk = int(cu_q[-1]), int(cu_k[-1])
        q, do = (torch.randn(tq, h, d, generator=g, device=dev).to(dtype)
                 for _ in range(2))
        k, v = (torch.randn(tk, hk, d, generator=g, device=dev).to(dtype)
                for _ in range(2))
        o, lse = ops.varlen_flash_attention(q, k, v, cu_q, cu_k, causal=True,
                                            window_size=window,
                                            return_lse=True)
        delta = ops.varlen_flash_attention_bwd_delta(o, do)
        args = (q, k, v, do, lse, delta, cu_q, cu_k, True)
        if fused and (dtype == torch.bfloat16 or fused_f32):
            def bwd():
                return ops.varlen_flash_attention_bwd_fused(
                    *args, window_size=window)
        else:
            def bwd():
                return (ops.varlen_flash_attention_bwd_dq(
                    *args, window_size=window),
                        *ops.varlen_flash_attention_bwd_dkv(
                            *args, window_size=window))
        first, second = bwd(), bwd()
        ref = ops.varlen_flash_attention_bwd_plain(
            q, k, v, o, lse, do, cu_q, cu_k, True, window_size=window,
            delta=delta)
        out[name] = {
            "ms": event_ms(bwd),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(first, second)),
            "max_err": max(float((a.float() - r.float()).abs().max())
                           for a, r in zip(first, ref)),
            "err_rel_to_max": max(
                float((a.float() - r.float()).abs().max()
                      / r.float().abs().max()) for a, r in zip(first, ref)),
            "sdpa_per_segment_ms": event_ms(_segment_library(
                torch, q, k, v, do, lens_q, lens_k or lens_q,
                window)["sdpa_per_segment"])}
        del q, k, v, do, o, lse, delta, args, first, second, ref
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--f32"]
    main(args[0] if args else "tree", "--f32" in sys.argv[1:])
