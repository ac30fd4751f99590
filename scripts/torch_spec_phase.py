"""Phase 15 of ``chip_smoke.py`` (speculative serving) alone, on one GPU.

    python scripts/torch_spec_phase.py

Builds the kernels, a fresh seeded Llama-2-7B in bf16 and phase 3's
requests, then runs ``chip_smoke.spec_phase``: (a) the serving run
through a stand-in draft at γ = 4 beside the plain engine and the eager
round, (b) steady-state decode capacity at γ = 8 for the stand-in and an
independent draft against the plain quantum, with the round's timing and
profile, (c) the f32 4-layer parity. Prints phase 15's JSON records, its
wall time, and a log of the cycle collections that ran within each call of
``_graphs.CapturedStep.capture``: the call's own collection just before
the capture begins (what it collected, dropped engines among it), and no
other, since the collector is held off inside the capture.
"""
from __future__ import annotations

import gc
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
    from paddle_tpu_torch import _graphs
    from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM

    state, log = {"capturing": None, "n": 0}, []
    capture = _graphs.CapturedStep.capture

    def logged(self):
        state["n"] += 1
        state["capturing"] = state["n"]
        try:
            return capture(self)
        finally:
            state["capturing"] = None

    def on_gc(phase, info):
        if state["capturing"] is not None and phase == "stop":
            log.append({"capture": state["capturing"],
                        "generation": info["generation"],
                        "collected": info["collected"]})

    gc.callbacks.append(on_gc)
    _graphs.CapturedStep.capture = logged
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = C.env_phase(torch)
    cfg = LlamaConfig.llama2_7b(dtype="bfloat16")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator(device=dev).manual_seed(C.SEED))
    t0 = time.perf_counter()
    try:
        launches = C.spec_phase(torch, dev, smi, model,
                                C.make_requests(cfg.vocab_size))
        print(json.dumps({"spec_phase_s": time.perf_counter() - t0,
                          "launches": launches}))
    finally:
        print(json.dumps({"captures": state["n"],
                          "collections_during_capture": log}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
