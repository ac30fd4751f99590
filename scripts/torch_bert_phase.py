"""Phase 21 of ``chip_smoke.py`` (BASELINE config #4 and its layer tier)
alone, on one GPU, with phase 2's K4 / K7 cases at nn.Transformer's
attention shapes.

    python scripts/torch_bert_phase.py [--no-kernels]

Builds the kernels, holds K4 to its plain version at nn.Transformer's
self- / cross-attention (B = 16, S = 512, H = 8, D = 64, non-causal) and
at its cached decode's two calls (Sq = 1 over 512 and 32 keys), K7 at the
training shape, each beside its plain version and one SDPA call, then
runs ``chip_smoke.bert_phase``: (a) ERNIE-3.0 base pretraining through
the auto-parallel ``Engine``, (b) ``nn.Transformer`` in bf16 with its
cached decoder, (c) ``hapi.Model`` with LeNet, (d) T5-small training.
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
        C.run_kernel_cases(torch, dev, lambda case: case["shape"].startswith(
            C.BERT_PHASE_LABELS))
    t0 = time.perf_counter()
    launches = C.bert_phase(torch, dev, smi)
    print(json.dumps({"bert_phase_s": time.perf_counter() - t0,
                      "launches": {k: {n: v for n, v in d.items() if v}
                                   for k, d in launches.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
