"""The host cost of the kernels' custom-op dispatch, one tree at a time.

    (cd TREE && python REPO/scripts/torch_ab_dispatch.py LABEL)

Imports ``chip_smoke`` and ``paddle_tpu_torch`` from the current
directory (a tree: the change, or its parent unpacked under ``build/``),
so one call can time both trees in turns (parent, change, change,
parent) on one card. Prints one JSON line:

- ``mixed_step_ms``: phase 3's mixed steps (``chip_smoke.serve`` on the
  full Llama-2-7B bf16 model and phase 3's 16 requests), their summed
  wall over their count, for each of ``RUNS`` runs after a warm-up run
  (which builds nothing new and captures the decode graph): an eager,
  host-bound step with 97 K1 / K3 calls;
- ``host_us``: host microseconds a call of the K1, K4 and K3 wrappers at
  small shapes (2,000 calls back to back, then one sync: the host's
  enqueue rate, since the card finishes each launch sooner); in a tree
  with the custom ops also K1 through the dispatcher
  (``torch.ops.paddle_tpu_torch.rms_norm``) and its CUDA implementation
  called directly, in one process;
- the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

RUNS = 3
CALLS = 2000


def _host_us(torch, fn):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / CALLS * 1e6


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as C
    from paddle_tpu_torch import ops
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(8, 4096, device=dev, dtype=torch.bfloat16, generator=g)
    w = torch.randn(4096, device=dev, dtype=torch.bfloat16, generator=g)
    q = torch.randn(1, 128, 8, 128, device=dev, dtype=torch.bfloat16,
                    generator=g)
    vq = torch.randn(128, 8, 128, device=dev, dtype=torch.bfloat16,
                     generator=g)
    cu = torch.tensor([0, 64, 128], dtype=torch.int32, device=dev)
    with torch.no_grad():
        host = {
            "rms_norm": _host_us(torch, lambda: ops.rms_norm(x, w)),
            "flash_attention": _host_us(
                torch, lambda: ops.flash_attention(q, q, q, causal=True)),
            "varlen_flash_attention": _host_us(
                torch, lambda: ops.varlen_flash_attention(vq, vq, vq, cu, cu,
                                                          causal=True))}
        op = getattr(torch.ops.paddle_tpu_torch, "rms_norm", None)
        if op is not None:
            # the same launch through the dispatcher: the custom op's
            # host cost over the direct call
            import importlib

            rn = importlib.import_module("paddle_tpu_torch.ops.rms_norm")

            host["rms_norm_op"] = _host_us(
                torch, lambda: op.default(x, w, 1e-6))
            host["rms_norm_direct"] = _host_us(
                torch, lambda: rn._rms_norm_cuda(x, w, 1e-6))
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(C.SEED))
    requests = C.make_requests(cfg.vocab_size)
    mixed = []
    for i in range(RUNS + 1):
        engine, reqs, wall, split = C.serve(torch, model, requests)
        steps = engine.engine_stats()["mixed_steps"]
        if i:
            mixed.append(1e3 * split["mixed_s"] / steps)
        del engine
    print(json.dumps({"label": label, "gpu": smi,
                      "mixed_step_ms": mixed, "mixed_steps": steps,
                      "host_us": host}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
