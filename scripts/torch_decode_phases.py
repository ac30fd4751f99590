"""Where a CTA of the split-decode kernel (K2 and K5) spends its time, on
one GPU.

    python scripts/torch_decode_phases.py

Copies ``paddle_tpu_torch`` into ``build/decode_phases/`` (gitignored),
puts ``clock()`` probes into that copy of ``csrc/split_decode.cuh`` at the
boundaries of a CTA's phases, builds it there and runs K2 at phase 2's
serving shape (B = 8 sequences of 1-2,048 tokens, H = HK = 32, D = 128,
block size 32) over bf16 pools and over int8 pools with static scales,
and K5 at the generate run's step (B = 4, H = 32, HK = 8, 4,096 live
tokens). Thread 0 of each CTA that holds tokens sums the cycles of each
phase; the sums over all such CTAs of 10 calls are printed as shares of
the total, with the cycles per CTA and call, one JSON line per shape,
with the card's name and power limit. Thread 0 sees its own warp's
arithmetic; the other warps' shows in the next barrier's wait. The
probes change the kernel's timing a little; compare shares, not times.
Exits non-zero without a GPU or when an anchor below is no longer in the
source.
"""
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
COPY = REPO / "build" / "decode_phases"
SRC = "csrc/split_decode.cuh"
# (phase that ends at the anchor, the anchor, probe after (True) or
# before (False) it)
PHASES = (
    ("length", "  const int n = min(stretch, len - t0);\n", True),
    ("queries_and_rows",
     "  const int ntiles = (n + Geo::kRows - 1) / Geo::kRows;\n", False),
    ("first_copies", "  float qscale = sm_scale * flash::kLog2e", False),
    ("tile_wait", "    __syncthreads();  // tile `it` landed; every warp "
                  "left tile it - 1\n", True),
    ("tile_issue_and_math", "              it * Geo::kRows, n, qscale, "
                            "vscale);\n", True),
    ("drain_and_warp_merge", "  if (live == 1) return;\n", False),
    ("partials_and_ticket", "  if (!last) return;\n", False),
)
PROBE = ("{{ const unsigned now_ = clock(); ph_[{n}] += now_ - ph_last_; "
         "ph_last_ = now_; }}")
FLUSH = ("if (threadIdx.x == 0) {{ for (int n_ = 0; n_ <= {n}; ++n_) "
         "atomicAdd(decode_phases + n_, ph_[n_]); "
         "atomicAdd(decode_phases + 15, 1ull); }}")


def instrument():
    """The probed copy of the package; returns its library."""
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(REPO / "paddle_tpu_torch", COPY / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = COPY / "paddle_tpu_torch" / SRC
    src = path.read_text()
    n = len(PHASES)
    start = "  if (split >= live) return;\n"
    if src.count(start) != 1:
        sys.exit(f"anchor not found once in {SRC}: {start!r}")
    src = src.replace(start, start + f"  unsigned long long ph_[{n + 1}] = "
                      "{0};\n  unsigned ph_last_ = clock();\n")
    for k, (_, anchor, after) in enumerate(PHASES):
        if src.count(anchor) != 1:
            sys.exit(f"anchor not found once in {SRC}: {anchor!r}")
        probe = PROBE.format(n=k) + "\n"
        src = src.replace(anchor, anchor + probe if after else
                          probe + anchor)
    # every CTA that held tokens adds its sums where it leaves
    flush = FLUSH.format(n=n)
    for ret in ("  if (live == 1) return;\n", "  if (!last) return;\n"):
        src = src.replace(ret, ret.replace("return;", "{ " + flush +
                                           " return; }"))
    tail = ("    for (int i = 0; i < 4; ++i) ob[4 * c + i] = "
            "from_f32<T>(a[i] / den[g]);\n  }\n")
    if src.count(tail) != 1:
        sys.exit(f"the kernel's end is no longer {tail!r}")
    src = src.replace(tail, tail + "  " + PROBE.format(n=n) + "\n  " + flush
                      + "\n")
    # one copy of the sums in each file that holds the kernel, declared
    # ahead of the kernel
    head = "template <typename C, int N>\n__device__ __forceinline__ void " \
        "load_row("
    if src.count(head) != 1:
        sys.exit(f"anchor not found once in {SRC}: {head!r}")
    src = src.replace(head,
                      "static __device__ unsigned long long "
                      "decode_phases[16];\n\n"
                      "inline int decode_phases_read(void* out) {\n"
                      "  static const unsigned long long zero[16] = {0};\n"
                      "  cudaMemcpyFromSymbol(out, decode_phases, "
                      "sizeof(decode_phases));\n"
                      "  cudaMemcpyToSymbol(decode_phases, zero, "
                      "sizeof(decode_phases));\n"
                      "  return static_cast<int>(cudaGetLastError());\n}\n\n"
                      + head)
    path.write_text(src)
    for name, fn in (("paged_attention.cu", "ptt_decode_phases_paged"),
                     ("decode_attention.cu", "ptt_decode_phases_contiguous")):
        cu = COPY / "paddle_tpu_torch" / "csrc" / name
        cu.write_text(cu.read_text() + f'\nextern "C" int {fn}(void* out) '
                      "{ return sd::decode_phases_read(out); }\n")
    sys.path.insert(0, str(COPY))
    from paddle_tpu_torch.ops import _library
    return _library.library()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    lib = instrument()
    from paddle_tpu_torch import ops
    names = [p for p, _, _ in PHASES] + ["last_cta_merge"]
    buf = np.zeros(16, dtype=np.uint64)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lens = [1, 31, 32, 33, 500, 1024, 2047, 2048]
    nb, bs = 8 * 64 + 1, 32
    tables = (torch.randperm(nb - 1, generator=g, device=dev)[:8 * 64] + 1) \
        .view(8, 64).int()
    sl = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn(8, 32, 128, generator=g, device=dev).bfloat16()
    kp, vp = (torch.randn(nb, bs, 32, 128, generator=g,
                          device=dev).bfloat16() for _ in range(2))
    ki, vi = (torch.randint(-128, 128, (nb, bs, 32, 128), generator=g,
                            device=dev, dtype=torch.int8) for _ in range(2))
    sc = torch.rand(32, generator=g, device=dev) * 0.02 + 0.005
    q5 = torch.randn(4, 32, 128, generator=g, device=dev).bfloat16()
    kc, vc = (torch.randn(4, 4096, 8, 128, generator=g,
                          device=dev).bfloat16() for _ in range(2))
    l5 = torch.full((4,), 4096, dtype=torch.int32, device=dev)
    cases = (
        ("k2_bf16_32_32", lib.ptt_decode_phases_paged,
         lambda: ops.paged_decode_attention(q, kp, vp, tables, sl)),
        ("k2_int8_static_32_32", lib.ptt_decode_phases_paged,
         lambda: ops.paged_decode_attention(q, ki, vi, tables, sl,
                                            k_scale=sc, v_scale=sc)),
        ("k5_generate", lib.ptt_decode_phases_contiguous,
         lambda: ops.decode_attention(q5, kc, vc, l5)),
    )
    with torch.no_grad():
        for label, read, call in cases:
            read.argtypes = [ctypes.c_void_p]
            call()
            torch.cuda.synchronize()
            read(buf.ctypes.data)  # drop the warm-up's sums
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            read(buf.ctypes.data)
            total = float(buf[:len(names)].sum())
            print(json.dumps({
                "shape": label, "gpu": gpu,
                "ctas_per_call": float(buf[15]) / 10,
                "cycles_per_cta": total / float(buf[15]),
                "shares": {n: float(c) / total
                           for n, c in zip(names, buf[:len(names)])}}),
                  flush=True)


if __name__ == "__main__":
    main()
