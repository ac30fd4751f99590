"""Phase 16 of ``chip_smoke.py`` (the serving front door) alone, on one GPU.

    python scripts/torch_frontdoor_phase.py

Builds the kernels, a fresh seeded Llama-2-7B in bf16 and phase 3's
requests, then runs ``chip_smoke.frontdoor_phase``: (a) the streams
through ``inference.serve`` against the bare engine and under
``run_async``, (b) the observability overhead of a steady decode
dispatch, (c) the overload row's shedding and no-shed arms, (d)
recompute-on-resume under the captured quantum in bf16 and, at 4 layers,
f32. Prints phase 16's JSON records and the phase's launches and wall.
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
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = C.env_phase(torch)
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(C.SEED))
    t0 = time.perf_counter()
    launches = C.frontdoor_phase(torch, dev, smi, model,
                                 C.make_requests(cfg.vocab_size))
    print(json.dumps({"frontdoor_phase_s": time.perf_counter() - t0,
                      "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
