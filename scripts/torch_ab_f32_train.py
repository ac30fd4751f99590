"""Time the f32 training steps of chip_smoke.py's phases 8 and 10 on one
GPU, for an A/B of two trees of the repository on one card.

Run from the root of the tree to time (``chip_smoke`` and
``paddle_tpu_torch`` are imported from the current directory, and the tree
builds its own kernel library), alternating trees on one card, e.g.
parent, change, change, parent:

    (cd parent_tree && python /path/to/torch_ab_f32_train.py parent)

The configurations are the phases' own (seeded weights, the kernel path):
dense, Llama-2-7B width with 2 layers in f32 and one row of S = 1,024
tokens; packed, the 941M configuration's width with 2 layers in f32 and
one row of T = 1,024 tokens in 4 segments. Per configuration: 2 warm-up
steps, then the wall ms of each of 5 steps (host clock around a step that
ends in a synchronize), and one step under torch.profiler: its device ms,
by kernel family (the attention backward's share among them). Prints one
JSON line with the card's name and power limit. Exits non-zero without a
GPU.
"""
import json
import subprocess
import sys
import time

import torch

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402


def _time(step, inputs, labels, label):
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        step(inputs, labels)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(inputs, labels)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(inputs, labels)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    rec = cs._profile_record(torch, prof, label, wall_us)
    return {"wall_ms": walls, "device_ms": rec["device_ms"],
            "device_ms_by_family": rec["device_ms_by_family"]}


def main(label):
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from paddle_tpu_torch.nlp import LlamaConfig

    dev = torch.device("cuda")
    out = {"tree": label, "gpu": gpu}
    seq, _ = cs.TRAIN_PARITY_SHAPE
    cfg = LlamaConfig.llama2_7b(num_hidden_layers=2, tensor_parallel=False,
                                dtype="float32")
    ids = cs._train_ids(torch, dev, cfg.vocab_size, 1, seq)
    model, step = cs._train_setup(torch, dev, cfg, cs.SEED + 3)
    out["train_f32"] = _time(step, ids, ids, "train_f32_step")
    del model, step
    torch.cuda.empty_cache()
    lens, _ = cs.PACKED_PARITY
    cfg = cs._packed_cfg(torch, num_hidden_layers=2, dtype="float32")
    ids, cu = cs._packed_batches(torch, dev, cfg.vocab_size, 1, lens)
    inputs = [ids[0], cu[0]]
    model, step = cs._packed_setup(torch, dev, cfg, cs.SEED + 4)
    out["packed_f32"] = _time(step, inputs, inputs, "packed_f32_step")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
