"""Time the dense flash-attention kernels of the PyTorch port on one GPU,
for an A/B of two trees of the repository on one card.

Run from the root of the tree to time (``paddle_tpu_torch`` is imported
from the current directory, and the tree builds its own kernel library),
alternating trees on one card, e.g. parent, change, change, parent:

    (cd parent_tree && python /path/to/torch_ab_flash_attention.py parent)

bf16, seeded random inputs. For the forward K4 at the training shape
(B=1, S=4,096, H=HK=32, causal), Mistral's prefill (S=4,608, GQA 32/8,
window 4,096), dense causal 2,048, bottom-right (Sq=64, Sk=1,024, GQA
32/8) and a head width of 64 (B=4, S=2,048, H=16), and for the backward
K7 at the training shape: CUDA-event ms per call over 30 back-to-back
calls after 5 warm-up calls, and the forward's largest |out - plain| and
|lse - plain|. Then the f32 route at the training shape (``f32_train``):
K4's f32 forward (its ms, whether two calls are bit-equal, its largest
|out - plain| and |lse - plain|), the whole f32 backward (``flash_attention_bwd``: the
fused f32 K7 where the tree has it, else K7a and K7b), whether two
backward calls are bit-equal, its largest |grad - plain| over the
gradient's largest |plain|, and one f32 SDPA backward (dq, dk, dv through
autograd) as the library yardstick. Prints one JSON line with the card's
name and power limit. Exits non-zero without a GPU. With ``--f32`` it
times only the f32 route.
"""
import json
import subprocess
import sys

import torch

sys.path.insert(0, ".")
from paddle_tpu_torch import ops  # noqa: E402

# (label, B, Sq, Sk, H, HK, D, window); all causal
SHAPES = (("train", 1, 4096, 4096, 32, 32, 128, None),
          ("mistral", 1, 4608, 4608, 32, 8, 128, 4096),
          ("dense2048", 1, 2048, 2048, 32, 32, 128, None),
          ("bottom_right", 1, 64, 1024, 32, 8, 128, None),
          ("d64", 4, 2048, 2048, 16, 16, 64, None))


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


def f32_train(dev, g):
    """The f32 route at the training shape (B=1, S=4,096, H=HK=32, D=128,
    causal)."""
    import torch.nn.functional as tF

    q, k, v, do = (torch.randn(1, 4096, 32, 128, generator=g, device=dev)
                   for _ in range(4))
    o, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
    o_ref, lse_ref = ops.flash_attention_plain(q, k, v, causal=True)
    fwd_equal = all(torch.equal(a, b) for a, b in zip(
        (o, lse), ops.flash_attention(q, k, v, causal=True, return_lse=True)))
    first, second = (ops.flash_attention_bwd(q, k, v, o, lse, do, True)
                     for _ in range(2))
    ref = ops.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lo = tF.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2).contiguous()
    return {
        "k4_ms": event_ms(lambda: ops.flash_attention(q, k, v,
                                                      causal=True)),
        "k4_bit_equal": fwd_equal,
        "k4_max_err": float((o - o_ref).abs().max()),
        "k4_lse_max_err": float((lse - lse_ref).abs().max()),
        "k7_ms": event_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse,
                                                          do, True)),
        "k7_bit_equal": all(torch.equal(a, b)
                            for a, b in zip(first, second)),
        "k7_err_rel_to_max": max(
            float((a - r).abs().max() / r.abs().max())
            for a, r in zip(first, ref)),
        "sdpa_fwd_ms": event_ms(lambda: tF.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "sdpa_bwd_ms": event_ms(lambda: torch.autograd.grad(
            lo, (qt, kt, vt), dot, retain_graph=True))}


def main(label, only_f32=False):
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": label, "gpu": gpu}
    for name, b, sq, sk, h, hk, d, window in SHAPES * (not only_f32):
        q, k, v = (torch.randn(b, s, n, d, generator=g, device=dev).bfloat16()
                   for s, n in ((sq, h), (sk, hk), (sk, hk)))
        o, lse = ops.flash_attention(q, k, v, causal=True,
                                     window_size=window, return_lse=True)
        ro, rl = ops.flash_attention_plain(q, k, v, causal=True,
                                           window_size=window)
        out[name + "_err"] = [float((o.float() - ro.float()).abs().max()),
                              float((lse - rl).abs().max())]
        out[name] = event_ms(lambda: ops.flash_attention(
            q, k, v, causal=True, window_size=window))
        if name == "train":
            do = torch.randn(q.shape, generator=g, device=dev).bfloat16()
            out["k7_train"] = event_ms(lambda: ops.flash_attention_bwd(
                q, k, v, o, lse, do, True))
        del q, k, v, o, lse, ro, rl
    out["f32_train"] = f32_train(dev, g)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--f32"]
    main(args[0] if args else "tree", "--f32" in sys.argv[1:])
