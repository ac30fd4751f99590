"""Time ``generate``'s decode step of the PyTorch port on one GPU, for an
A/B of two trees of the repository on one card.

Run from the root of the tree to time (``paddle_tpu_torch`` is imported
from the current directory), alternating trees on one card, e.g.
parent, change, change, parent:

    (cd parent_tree && python /path/to/torch_ab_generate.py parent)

Mistral-7B width, 32 layers, bf16, seeded random weights, 4 rows of
512-token prompts, 32 new tokens. Four ``generate`` calls; the first is a
warm-up. Prints one JSON line with each timed call's wall time and its
decode ms per step (CUDA events from the end of the prefill forward to
the end of the call, over the 31 decode steps: on a tree whose decode step
is a captured CUDA graph kept per call shape, the warm-up call captures it
and the timed calls only replay it).
"""
import json
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
from paddle_tpu_torch.nlp import LlamaConfig, LlamaForCausalLM  # noqa: E402


def main(label):
    cfg = LlamaConfig.mistral_7b(dtype="bfloat16")
    model = LlamaForCausalLM(
        cfg, generator=torch.Generator("cuda").manual_seed(0))
    model.eval()
    ids = torch.from_numpy(
        np.random.RandomState(0).randint(1, cfg.vocab_size, (4, 512))).cuda()
    forward, marks = model.forward, []

    def timed_forward(*args, **kwargs):
        # only the prefill call is marked: a decode step captured as a
        # CUDA graph calls forward once for its capture, then replays
        out = forward(*args, **kwargs)
        if not marks:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        return out

    model.forward = timed_forward
    runs, new = [], 32
    for _ in range(4):
        marks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.generate(ids, max_new_tokens=new)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        runs.append({"wall_s": time.perf_counter() - t0,
                     "decode_ms_per_step":
                         marks[0].elapsed_time(end) / (new - 1)})
    print(json.dumps({"tree": label, "gpu": torch.cuda.get_device_name(0),
                      "runs": runs[1:]}))


if __name__ == "__main__":
    main(sys.argv[1])
