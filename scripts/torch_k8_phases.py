"""Where a CTA of the fused varlen backward K8 spends its time, on one GPU.

    python scripts/torch_k8_phases.py

Copies ``paddle_tpu_torch`` into ``build/k8_phases/`` (gitignored), puts
``clock()`` probes into that copy of ``csrc/varlen_flash_attention_bwd.cu``
at the boundaries of a step's phases, builds it there and runs K8 at the
packed 941M row (T = 4,096 in 8 segments, H = HK = 32, D = 64, causal)
and at its GQA window case (HK = 8, D = 128, window 512). Thread 0 of
each CTA sums the cycles of each phase over its walk; the sums over all
CTAs of 10 calls are printed as shares of the total, one JSON line per
shape, with the card's name and power limit. The probes change the
kernel's timing a little; compare shares, not times. Exits non-zero
without a GPU or when an anchor below is no longer in the source.
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
COPY = REPO / "build" / "k8_phases"
SRC = "csrc/varlen_flash_attention_bwd.cu"
# (phase that ends here, the source line the probe follows)
PHASES = (
    ("prologue", "  for (int t = 0; cur.i >= 0; ++t) {"),
    ("barrier_and_q_do_wait",
     "    mbar_wait(full + st, (t / 3) & 1);  // this step's Q and dO boxes"),
    ("s_dp_products", "    wg::fence_regs<4 * kNtS>(&sc[0][0]);"),
    ("p_and_dv_issue", "    wg::fence_regs<4 * kNtS>(&dp[0][0]);"),
    ("ds_dk_and_barrier", "    __syncthreads();  // dS^T is complete"),
    ("dq_product", "    wg::fence_regs<4 * kNtQ>(&dqa[0][0]);"),
    ("dq_add", "    cur = nx1;"),
    ("advance", "    nx2 = advance(nx2);"),
)
PROBE = ("{{ const unsigned now_ = clock(); ph_[{n}] += now_ - ph_last_; "
         "ph_last_ = now_; }}")


def instrument():
    """The probed copy of the package; returns its library."""
    if COPY.exists():
        shutil.rmtree(COPY)
    shutil.copytree(REPO / "paddle_tpu_torch", COPY / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    path = COPY / "paddle_tpu_torch" / SRC
    src = path.read_text()
    n = len(PHASES)
    head = "    varlen_bwd_fused_kernel("
    body = src.index("{", src.index(head)) + 1
    src = (src[:body] + f"\n  unsigned ph_[{n + 1}] = {{0}}, "
           "ph_last_ = clock();" + src[body:])
    for k, (_, anchor) in enumerate(PHASES):
        if src.count(anchor) != 1:
            sys.exit(f"anchor not found once in {SRC}: {anchor!r}")
        src = src.replace(anchor, anchor + "\n" + PROBE.format(n=k))
    # the epilogue ends at the kernel's last statement
    tail = "      o[e] = make_uint4(0, 0, 0, 0);\n  }\n"
    if src.count(tail) != 1:
        sys.exit(f"the kernel's end is no longer {tail!r}")
    src = src.replace(tail, tail + "  " + PROBE.format(n=n) + "\n"
                      f"  if (threadIdx.x == 0)\n    for (int n = 0; n <= {n};"
                      " ++n) atomicAdd(k8_phases + n, ph_[n]);\n")
    src = src.replace("// One step of a CTA's walk:",
                      "__device__ unsigned long long k8_phases[16];\n"
                      "// One step of a CTA's walk:")
    src += ('\nextern "C" int ptt_k8_phases(void* out) {\n'
            "  static const unsigned long long zero[16] = {0};\n"
            "  cudaMemcpyFromSymbol(out, k8_phases, sizeof(k8_phases));\n"
            "  cudaMemcpyToSymbol(k8_phases, zero, sizeof(k8_phases));\n"
            "  return static_cast<int>(cudaGetLastError());\n}\n")
    path.write_text(src)
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
    from paddle_tpu_torch.ops.varlen_flash_attention import _bwd_block_k
    fn = lib.ptt_k8_phases
    fn.argtypes = [ctypes.c_void_p]
    names = [p for p, _ in PHASES] + ["epilogue"]
    buf = np.zeros(16, dtype=np.uint64)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    lens = [1600, 800, 600, 400, 300, 200, 120, 76]
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]),
                      dtype=torch.int32, device=dev)
    t = int(cu[-1])
    for label, hk, d, window in (("packed_941m", 32, 64, None),
                                 ("gqa_window", 8, 128, 512)):
        q, do = (torch.randn(t, 32, d, generator=g, device=dev).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(t, hk, d, generator=g, device=dev).bfloat16()
                for _ in range(2))
        out, lse = ops.varlen_flash_attention(q, k, v, cu, cu, causal=True,
                                              window_size=window,
                                              return_lse=True)
        delta = ops.varlen_flash_attention_bwd_delta(out, do)

        def call():
            ops.varlen_flash_attention_bwd_fused(
                q, k, v, do, lse, delta, cu, cu, True, window_size=window)
        call()
        torch.cuda.synchronize()
        fn(buf.ctypes.data)  # drop the warm-up's sums
        for _ in range(10):
            call()
        torch.cuda.synchronize()
        fn(buf.ctypes.data)
        total = float(buf[:len(names)].sum())
        print(json.dumps({
            "shape": label, "gpu": gpu,
            "cycles_per_cta_call":
                total / 10 / (-(-t // _bwd_block_k(d)) * hk),
            "shares": {n: float(c) / total
                       for n, c in zip(names, buf[:len(names)])}}),
              flush=True)


if __name__ == "__main__":
    main()
