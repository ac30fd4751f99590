"""Phase 22 of ``chip_smoke.py`` (BASELINE config #3's hybrid-parallel
tier, one NCCL rank) alone, on one GPU, after the phase-7 run it holds
its losses and speed to.

    python scripts/torch_fleet_phase.py

Builds the kernels (``env_phase``), runs ``chip_smoke.train_phase``
(phase 7: Llama-2-7B width, 4 layers, bf16, B = 1, S = 4,096), then
``chip_smoke.fleet_phase``: the same configuration through the port's
launcher, ``fleet`` at degree 1 with stage-3 sharding, on NCCL. Prints
the phases' JSON records, the fleet run's launches and the wall.
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
    C.train_phase(torch, dev)
    launches = C.fleet_phase(torch, dev, smi)
    print(json.dumps({"fleet_launches": launches,
                      "wall_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
