"""Time variants of the f32 attention forward tile loop
(``csrc/flash_f32.cuh``, K4 f32 and K3 f32) on one GPU: where its time
goes, and which of a few design choices wins.

    python scripts/torch_f32_fwd_variants.py [VARIANT ...]

Each variant is a copy of ``paddle_tpu_torch`` under
``build/f32_fwd_variants/NAME/`` (gitignored) with textual edits of its
CUDA sources, built and timed as ``scripts/torch_f32_bwd_variants.py``
does its own: in parallel, then each in its own process, in the order
given, twice over (so a drift of the card shows). Per variant: CUDA-event ms of
the dense f32 forward (``flash_attention``) at the training shape (B=1,
S=4,096, H=HK=32, D=128, causal) and of the varlen one at the packed 941M
row (T=4,096 in 8 segments, H=HK=32, D=64), each over 20 back-to-back
calls after 3 warm-up calls, and the largest |out - plain|. Some edits
break the arithmetic on purpose (they take a part out to show its cost);
their errors say so. Prints one JSON line per variant and pass, with the
card's name and power limit. Exits non-zero without a GPU or when an
anchor is no longer in the source.
"""
import sys

from torch_f32_bwd_variants import REPO, TF32, main

ROOT = REPO / "build" / "f32_fwd_variants"
LOOP = "csrc/flash_f32.cuh"
BOUNDS = [("csrc/flash_attention.cu",
           "__launch_bounds__(flash_f32::kThreads, D == 64 ? 3 : 2)"),
          ("csrc/varlen_flash_attention.cu",
           "__launch_bounds__(flash_f32::kThreads, DP == 64 ? 3 : 2)")]

# name -> [(file under paddle_tpu_torch/, old, new)]; built and timed by
# torch_f32_bwd_variants.main
VARIANTS = {
    "base": [],
    # one TF32 product instead of three (wrong results): the cost of 3x
    "one_tf32": [(TF32, "  mma_tf32(c, as, bb0, bb1);\n"
                        "  mma_tf32(c, ab, bs0, bs1);\n", "")],
    # no rounding instructions, raw f32 bits as big and small (wrong
    # results): the cost of the split
    "no_split": [(TF32, "  *big = to_tf32(x);\n  *small = __float_as_uint(x"
                        " - __uint_as_float(*big));",
                  "  *big = __float_as_uint(x);\n  *small = *big;")],
    # the softmax's exponentials left out (wrong results): their cost
    "no_exp": [(LOOP, "          const float p = flash::exp2_ftz(fmaf("
                      "sc[nt][e], scale_log2, -ml));",
                "          const float p = fmaf(sc[nt][e], scale_log2, "
                "-ml);")],
    # four CTAs an SM at head width 64 (128 registers, spilling) in place
    # of three (170, no spills)
    "d64_four": [(f, old, old.replace("? 3 : 2", "? 4 : 2"))
                 for f, old in BOUNDS],
}

TIMER = r"""
import json, sys, torch
sys.path.insert(0, ".")
from paddle_tpu_torch import ops
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
g = torch.Generator(device=dev).manual_seed(0)

def event_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters

out = {}
q, k, v = (torch.randn(1, 4096, 32, 128, generator=g, device=dev)
           for _ in range(3))
fn = lambda: ops.flash_attention(q, k, v, causal=True)
out["dense_ms"] = event_ms(fn)
out["dense_err"] = float((fn() - ops.flash_attention_plain(
    q, k, v, causal=True)[0]).abs().max())
del q, k, v
lens = [1600, 800, 600, 400, 300, 200, 120, 76]
cu = torch.tensor([0] + [sum(lens[:i + 1]) for i in range(len(lens))],
                  dtype=torch.int32, device=dev)
q, k, v = (torch.randn(4096, 32, 64, generator=g, device=dev)
           for _ in range(3))
fn = lambda: ops.varlen_flash_attention(q, k, v, cu, cu, causal=True)
out["packed_ms"] = event_ms(fn)
out["packed_err"] = float((fn() - ops.varlen_flash_attention_plain(
    q, k, v, cu, cu, True)[0]).abs().max())
print(json.dumps(out))
"""


if __name__ == "__main__":
    main(sys.argv[1:], VARIANTS, TIMER, ROOT)
