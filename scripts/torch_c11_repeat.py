"""Repeat ``tests/test_torch_cuda.py::test_cuda_two_replicas_on_one_stream_equal_one``
(ROADMAP C11) on one GPU and record, for every run, what its suspects
need: each K2 ticket buffer's key, whether it was made inside a CUDA
graph capture and on which stream, and the split plans the launches took.

    python scripts/torch_c11_repeat.py [N] [--keep-tickets]

Runs the test's body N times (default 20) in one process, each with its
own ``pytest.MonkeyPatch``, and reads every ticket buffer before and
after each run (each launch must leave its buffer zero); a failed run
records which streams parted and at which token, and the streams'
handles (PyTorch hands out pooled CUDA streams, so a handle recurs). By default the ticket buffers are dropped
before each run, so every run starts as a fresh process does (the first
K2 launch on a stream makes its buffer); ``--keep-tickets`` keeps them
across runs, as a whole-file pytest run does. Prints one JSON line a run
(pass or the assertion, the buffers made, made inside a capture, the
plans) and a summary line.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def _dirty(torch, split_decode):
    """Ticket buffers that hold a non-zero ticket (each launch must leave
    its buffer zero): key -> (non-zero tickets, their sum)."""
    out = {}
    for key, t in split_decode._TICKETS.items():
        nz = int((t != 0).sum())
        if nz:
            out[str(list(key))] = (nz, int(t.sum()))
    return out


def _first_diff(a, b):
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _body(T, torch, dev, mp):
    """The test's body, returning both runs' streams and the stream
    handles: one replica, then two whose graphs were captured on one
    shared stream and replay on one stream under the cluster pump."""
    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.serving import (ClusterFrontDoor, ClusterReplica,
                                          ClusterRouter, no_shed_policy)

    model = T._tiny_cuda_model(dev)
    prompts = T._prefix_prompts()[1:5] + T._GRAPH_PROMPTS[:4]

    def run(n):
        reps = [ClusterReplica(f"r{i}", create_serving_engine(
            model, prefix_cache=True, **T._GRAPH_KW), policy=no_shed_policy())
            for i in range(n)]
        cfd = ClusterFrontDoor(ClusterRouter(reps, affinity_blocks=1,
                                             strategy="round_robin"))
        streams = [cfd.submit(p, max_new_tokens=10) for p in prompts]
        cfd.run_until_idle()
        return [list(s.result()) for s in streams], reps

    want, reps1 = run(1)
    one = [r.engine._graph.stream.cuda_stream for r in reps1]
    shared = torch.cuda.Stream(dev)
    mp.setattr(torch.cuda, "Stream", lambda *a, **k: shared)
    got, reps = run(2)
    return want, got, {"one_replica": one, "shared": shared.cuda_stream}


def main():
    import pytest
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    import test_torch_cuda as T
    from paddle_tpu_torch.ops import split_decode

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 20
    keep = "--keep-tickets" in sys.argv
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    made, plans = [], set()
    tickets_for, plan_for = split_decode.tickets_for, split_decode.plan_for

    def traced_tickets(device, stream, pairs):
        key = split_decode.ticket_key(device.index, stream, pairs)
        if key not in split_decode._TICKETS:
            made.append({"key": list(key), "in_capture":
                         torch.cuda.is_current_stream_capturing(),
                         "current_stream":
                         torch.cuda.current_stream(device).cuda_stream})
        return tickets_for(device, stream, pairs)

    def traced_plan(pairs, reach, row_bytes, device):
        p = plan_for(pairs, reach, row_bytes, device)
        plans.add((pairs, reach, row_bytes, p.stretch, p.nsplit))
        return p

    split_decode.tickets_for = traced_tickets
    split_decode.plan_for = traced_plan
    failures = 0
    t_all = time.perf_counter()
    for i in range(n):
        if not keep:
            split_decode._TICKETS.clear()
        made.clear()
        plans.clear()
        torch.cuda.synchronize()
        dirty_before = _dirty(torch, split_decode)
        mp = pytest.MonkeyPatch()
        t0 = time.perf_counter()
        try:
            want, got, streams = _body(T, torch, dev, mp)
            parted = [(j, _first_diff(w, g))
                      for j, (w, g) in enumerate(zip(want, got)) if w != g]
            result = "pass" if not parted else f"parted {parted}"
            failures += bool(parted)
        except Exception:
            failures += 1
            parted, streams = None, None
            result = traceback.format_exc(limit=3)[-2000:]
        finally:
            mp.undo()
        torch.cuda.synchronize()
        print(json.dumps({"run": i, "result": result, "streams": streams,
                          "dirty_tickets_before": dirty_before,
                          "dirty_tickets_after": _dirty(torch, split_decode),
                          "s": time.perf_counter() - t0,
                          "tickets_made": list(made),
                          "made_in_capture": sum(m["in_capture"]
                                                 for m in made),
                          "ticket_keys": [list(k) for k in
                                          split_decode._TICKETS],
                          "plans": sorted(plans)}), flush=True)
    print(json.dumps({"c11_runs": n, "failures": failures,
                      "keep_tickets": keep,
                      "wall_s": time.perf_counter() - t_all}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
