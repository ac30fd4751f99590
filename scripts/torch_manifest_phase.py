"""Phase 25 of ``chip_smoke.py`` (the manifest tier) alone, on one GPU.

    python scripts/torch_manifest_phase.py [--kernels]

Builds the kernels (``env_phase``), then runs
``chip_smoke.manifest_phase``: (a) K2 and K5 in ``to_static`` graphs and
a ``jit.save`` Predictor at Llama-2-7B's widths, (b)
``flash_attn_qkvpacked``, (c) the RNN family at the large PTB LSTM's
width, (d) ``signal`` and ``fft`` at Whisper's front end, (e) the grid
ops and ``unfold`` / ``fold``, (f) ``sparse.matmul``. With
``--kernels`` it first holds phase 2's K2 and K5 cases against their
plain versions. Prints the phase's JSON records, its launches and the
wall. Alone, phase 13's captured quantum is not run, so (a) prints
None beside the recorded one.
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
    if "--kernels" in sys.argv:
        C.run_kernel_cases(torch, dev,
                           lambda case: "decode_attention" in case["name"])
    launches = C.manifest_phase(torch, dev, smi)
    print(json.dumps({"manifest_launches": {
        path: {k: v for k, v in counts.items() if v}
        for path, counts in launches.items()},
        "wall_s": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
