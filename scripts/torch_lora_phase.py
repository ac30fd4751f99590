"""Phase 18 of ``chip_smoke.py`` (LoRA fine-tuning of Llama-2-7B under
amp) alone, on one GPU, with phase 2's fp16 K4 and K7 cases.

    python scripts/torch_lora_phase.py [--no-kernels]

Builds the kernels, holds K4's and K7's fp16 arms to their plain versions
at the training shape on phase 2's own inputs (each timed beside its
plain version and fp16 SDPA), then runs ``chip_smoke.lora_phase``: (a) bf16 O2 at full size, (d) merge /
unmerge, (b) the f32 parity at two layers, (c) fp16 O1 with GradScaler.
Prints the phase's JSON records, its launches and its wall.
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
        C.run_kernel_cases(torch, dev,
                           lambda case: case["dtype"] == torch.float16)
    t0 = time.perf_counter()
    launches = C.lora_phase(torch, dev, smi)
    print(json.dumps({"lora_phase_s": time.perf_counter() - t0,
                      "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
