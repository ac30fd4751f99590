"""Phase 19 of ``chip_smoke.py`` (the GPT-2 family and the incubate fused
tier) alone, on one GPU, with phase 2's cases at the phase's shapes.

    python scripts/torch_gpt_phase.py [--no-kernels]

Builds the kernels, holds K4 and K7 to their plain versions at GPT-2
345M's training shape (B = 16, S = 1,024, H = 16, D = 64), K4 at its
generate's longest forward and at FusedMultiTransformer's prefill, and K5
at FusedMultiTransformer's decode step, all in bf16 and on phase 2's own
inputs (each timed beside its plain version and the library call), then
runs ``chip_smoke.gpt_phase``: (a) GPT-2 345M
training, (b) its greedy generate, (c) FusedMultiTransformer at
Llama-2-7B width, (d) the same in weight-only int8, (e) its f32
kernel-vs-plain parity, (f) MoELayer at Mixtral's layer width. Prints the
phase's JSON records, its launches and its wall.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    import chip_smoke as C

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = C.env_phase(torch)
    if "--no-kernels" not in sys.argv[1:]:
        C.run_kernel_cases(torch, dev, lambda case: case["shape"].startswith(
            C.GPT_PHASE_LABELS))
    t0 = time.perf_counter()
    launches = C.gpt_phase(torch, dev, smi)
    print(json.dumps({"gpt_phase_s": time.perf_counter() - t0,
                      "launches": {k: {n: v for n, v in d.items() if v}
                                   for k, d in launches.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
