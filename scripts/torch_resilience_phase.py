"""Phase 17 of ``chip_smoke.py`` (resilience, crash recovery and the
cluster) alone, on one GPU.

    python scripts/torch_resilience_phase.py

Builds the kernels, a fresh seeded Llama-2-7B in bf16 and phase 3's
requests, serves them once undisturbed (phase 17 (b) and (c) compare with
those streams), then runs ``chip_smoke.resilience_phase``: (a) the chaos
soaks in f32 at 4 layers, (b) faults at full depth and the resilience
tier's dispatch overhead, (c) snapshot / restore, (d) the cluster, (e)
``python -m paddle_tpu_torch.obs check --device cuda``. Prints phase 17's
JSON records and the phase's launches and wall.
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
    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = C.env_phase(torch)
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(C.SEED))
    requests = C.make_requests(cfg.vocab_size)
    engine = create_serving_engine(model, **C.serve_kw())
    reqs = [engine.submit(**r) for r in requests]
    engine.run()
    want = [list(r.tokens) for r in reqs]
    del engine, reqs
    C._free(torch)
    t0 = time.perf_counter()
    launches = C.resilience_phase(torch, dev, smi, model, requests, want)
    print(json.dumps({"resilience_phase_s": time.perf_counter() - t0,
                      "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
