"""Phase 20 of ``chip_smoke.py`` (the vision tier) alone, on one GPU, with
phase 2's K4 cases at the SD UNet's attention shapes.

    python scripts/torch_vision_phase.py [--no-kernels]

Builds the kernels, holds K4 to its plain version at the UNet's
self-attention over the 64 x 64 latents (B = 2, S = 4,096, H = 5, D = 64),
its cross-attention there (Sk = 77) and its self-attention at the 8 x 8
level (S = 64, H = 20), bf16 and non-causal, on phase 2's own inputs
(each timed beside its plain version and one SDPA call), then runs
``chip_smoke.vision_phase``: (a) the SD UNet's captured DDIM sampler at
stable-diffusion-2-base's widths and its f32 parity run, (b) ResNet-50
training at ``resnet50_eager``'s recipe and a bf16 eval forward. Prints
the phase's JSON records, its launches and its wall.
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
            C.UNET_PHASE_LABELS))
    t0 = time.perf_counter()
    launches = C.vision_phase(torch, dev, smi)
    print(json.dumps({"vision_phase_s": time.perf_counter() - t0,
                      "launches": {k: {n: v for n, v in d.items() if v}
                                   for k, d in launches.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
