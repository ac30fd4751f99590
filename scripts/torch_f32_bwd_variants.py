"""Time variants of the fused f32 attention backward (``csrc/bwd_f32.cuh``)
on one GPU: where its time goes, and which of a few design choices wins.

    python scripts/torch_f32_bwd_variants.py [VARIANT ...]

Each variant is a copy of ``paddle_tpu_torch`` under
``build/f32_variants/NAME/`` (gitignored) with a textual edit of
``csrc/bwd_f32.cuh``, ``csrc/tf32x3.cuh`` or a kernel source; the copies build in parallel
(one process each), then each is timed in its own process, in the order given, twice over
(first pass, then second, so a drift of the card shows). Per variant:
CUDA-event ms of the dense f32 backward (``flash_attention_bwd_fused``)
at the training shape (B=1, S=4,096, H=HK=32, D=128, causal) and of the
varlen one at the packed 941M row (T=4,096 in 8 segments, H=HK=32,
D=64), each over 20 back-to-back calls after 3 warm-up calls, and the
largest |grad - plain| over each gradient's largest |plain|. Some edits
break the arithmetic on purpose (they take a part out to show its cost);
their errors say so. Prints one JSON line per variant and pass, with the
card's name and power limit. Exits non-zero without a GPU or when an
anchor is no longer in the source.
"""
import json
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ROOT = REPO / "build" / "f32_variants"
HEADER = "paddle_tpu_torch/csrc/bwd_f32.cuh"
TF32 = "csrc/tf32x3.cuh"  # the 3xTF32 products, shared with the forward

# name -> [(old, new)] edits of bwd_f32.cuh, or [(file, old, new)] of
# another file under paddle_tpu_torch/
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
    # the dq add's bulk copies left out, its waits kept (wrong dq)
    "no_dq_add": [("    for (int r = 0; r < n; ++r) {",
                   "    for (int r = 0; r < 0; ++r) {")],
    # small rounded by a second cvt.rna, as big is
    "rna_small": [(TF32,
                   "  *small = __float_as_uint(x - __uint_as_float(*big));",
                   "  *small = to_tf32(x - __uint_as_float(*big));")],
    # big truncated by the tensor core too: small = x - (x with its low 13
    # bits cleared), one integer and one float instruction
    "trunc_big": [(TF32, "  *big = to_tf32(x);\n  *small = __float_as_uint("
                         "x - __uint_as_float(*big));",
                   "  *big = __float_as_uint(x);\n  *small = __float_as_uint("
                   "x - __uint_as_float(*big & 0xffffe000u));")],
    # big rounded by the cvt.rna.tf32.f32 instruction in place of its two
    # integer instructions (bit-identical results)
    "cvt_rna": [(TF32,
                 "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : "
                 "\"=r\"(r) : \"f\"(x));\n  return r;")],
    # dP^T before dV += P^T dO (both kernels)
    "dp_first": [(f, "    bwd32::acc_by_rows<D>(sc, dos, adv);            // dV += P^T dO\n"
                     "    bwd32::rows_by_rows<D>(vs, warp * 16, dos, dp);  // dP^T = V dO^T",
                  "    bwd32::rows_by_rows<D>(vs, warp * 16, dos, dp);  // dP^T = V dO^T\n"
                  "    bwd32::acc_by_rows<D>(sc, dos, adv);            // dV += P^T dO")
                 for f in ("csrc/flash_attention_bwd.cu",
                           "csrc/varlen_flash_attention_bwd.cu")],
    # two 64-key varlen CTAs an SM at D = 64 (255 registers) in place of
    # three (170)
    "varlen_two_ctas": [("csrc/varlen_flash_attention_bwd.cu",
                         "__launch_bounds__(F32<D>::kThreads, D == 64 ? 3 : 1)",
                         "__launch_bounds__(F32<D>::kThreads, D == 64 ? 2 : 1)")],
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

def rel(got, want):
    return max(float((x - r).abs().max() / r.abs().max())
               for x, r in zip(got, want))

out = {}
q, k, v, do = (torch.randn(1, 4096, 32, 128, generator=g, device=dev)
               for _ in range(4))
o, lse = ops.flash_attention(q, k, v, causal=True, return_lse=True)
delta = ops.flash_attention_bwd_delta(o, do)
fn = lambda: ops.flash_attention_bwd_fused(q, k, v, do, lse, delta, True)
out["dense_ms"] = event_ms(fn)
out["dense_err"] = rel(fn(), ops.flash_attention_bwd_plain(
    q, k, v, o, lse, do, True, delta=delta))
del q, k, v, do, o, lse, delta
lens = [1600, 800, 600, 400, 300, 200, 120, 76]
cu = torch.tensor([0] + [sum(lens[:i + 1]) for i in range(len(lens))],
                  dtype=torch.int32, device=dev)
q, k, v, do = (torch.randn(4096, 32, 64, generator=g, device=dev)
               for _ in range(4))
o, lse = ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                    return_lse=True)
delta = ops.varlen_flash_attention_bwd_delta(o, do)
fn = lambda: ops.varlen_flash_attention_bwd_fused(q, k, v, do, lse, delta,
                                                  cu, cu, True)
out["packed_ms"] = event_ms(fn)
out["packed_err"] = rel(fn(), ops.varlen_flash_attention_bwd_plain(
    q, k, v, o, lse, do, cu, cu, True, delta=delta))
print(json.dumps(out))
"""


def make(name, edits, root=ROOT):
    dst = root / name
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(REPO / "paddle_tpu_torch", dst / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for edit in edits:
        rel, (old, new) = ((HEADER, edit) if len(edit) == 2 else
                           ("paddle_tpu_torch/" + edit[0], edit[1:]))
        path = dst / rel
        src = path.read_text()
        if src.count(old) != 1:
            sys.exit(f"{name}: anchor not found once in {rel}: {old!r}")
        path.write_text(src.replace(old, new))
    return dst


def main(names, variants=VARIANTS, timer=TIMER, root=ROOT):
    """Build the named variants (all when none is named) under ``root``
    and time each with ``timer`` (a script printing one JSON line), twice
    over; scripts/torch_f32_fwd_variants.py passes its own."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    names = names or list(variants)
    dirs = {n: make(n, variants[n], root) for n in names}
    build = "from paddle_tpu_torch.ops import _library as L; L.library()"
    procs = {n: subprocess.Popen([sys.executable, "-c", build], cwd=d,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
             for n, d in dirs.items()}
    for n, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            sys.exit(f"{n}: build failed\n{log[-4000:]}")
    for rnd in (1, 2):
        for n, d in dirs.items():
            run = subprocess.run([sys.executable, "-c", timer], cwd=d,
                                 capture_output=True, text=True)
            if run.returncode:
                print(json.dumps({"variant": n, "round": rnd,
                                  "error": run.stderr[-2000:]}), flush=True)
                continue
            print(json.dumps({"variant": n, "round": rnd, "gpu": gpu,
                              **json.loads(run.stdout.splitlines()[-1])}),
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
