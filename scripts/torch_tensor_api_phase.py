"""Phase 23 of ``chip_smoke.py`` (the Paddle tensor API tier) alone, on
one GPU.

    python scripts/torch_tensor_api_phase.py

Builds the kernels (``env_phase``), then runs ``chip_smoke.tensor_api_phase``:
(a) every op of the tier on CUDA tensors against the same port function on
a CPU copy in f64, and the random ops by reproducibility and moments; (b)
ResNet-50 through the public API against phase 20's direct path (phase
20's images/s are not taken here, so that field reads "not measured"); (c)
a user-written SwiGLU Layer at Llama-2-7B's width. Prints the phase's JSON
records, its launches and the wall.
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
    t0 = time.perf_counter()
    smi = C.env_phase(torch)
    launches = C.tensor_api_phase(torch, dev, smi)
    print(json.dumps({"tensor_api_launches": launches,
                      "wall_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
