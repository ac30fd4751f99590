"""Phase 24 of ``chip_smoke.py`` (the static and deployment tier) alone,
on one GPU.

    python scripts/torch_static_phase.py

Builds the kernels (``env_phase``), then runs ``chip_smoke.static_phase``:
(a) ``jit.to_static``, the backward through it, ``jit.save`` and an
``inference`` Predictor at Llama-2-7B's widths; (b) ResNet-50 through
``jit.save``, a Predictor and the C inference API's client. Prints the
phase's JSON records, its launches and the wall.
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
    launches = C.static_phase(torch, dev, smi)
    print(json.dumps({"static_launches": {
        path: {k: v for k, v in counts.items() if v}
        for path, counts in launches.items()},
        "wall_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
