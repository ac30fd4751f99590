"""Repeat ``tests/test_torch_cuda.py::test_cuda_two_replicas_on_one_stream_equal_one``
(ROADMAP C11) on one GPU and record, for every run, what its suspects
need: each K2 ticket buffer's key, whether it was made inside a CUDA
graph capture and on which stream, and the split plans the launches took.
Each run takes the one-replica arm twice (does it, not the two-replica
arm, move?), records which replica served each request and each
replica's captured graph (its stream and its replays), and, for a
stream that parts, both runs' tokens up to the parting and the model's
logits there (a full eager forward of the shared prefix: the top three
ids and values, so a parting at a near-tie shows as one).

    python scripts/torch_c11_repeat.py [N] [--keep-tickets]
        [--variant own_streams|sequential|no_prefix|eager|own_models|record|mem_pools|sync_mixed|graph_tickets|keep_cache|mem_snapshots[,...]]
        [--own-models] [--record]

Runs the test's body N times (default 20) in one process, each with its
own ``pytest.MonkeyPatch``, and reads every ticket buffer before and
after each run (each launch must leave its buffer zero); a failed run
records which streams parted and at which token, and the streams'
handles (PyTorch hands out pooled CUDA streams, so a handle recurs). By default the ticket buffers are dropped
before each run, so every run starts as a fresh process does (the first
K2 launch on a stream makes its buffer); ``--keep-tickets`` keeps them
across runs, as a whole-file pytest run does. ``--variant`` changes the
body to localize a parting: ``own_streams`` leaves each replica its own
capture stream, ``sequential`` collects each replica before dispatching
the next (no overlap), ``no_prefix`` turns the prefix cache off,
``eager`` runs the decode quantum eagerly (no graphs), and
``fresh_tickets`` gives every K2 launch a new zeroed ticket buffer (eager
only: a graph keeps the address it captured), and ``poison`` fills the
caching allocator's free memory with NaN before each arm (every block a
later tensor takes holds NaN until written: a read of memory the run
never wrote shows), ``own_models`` (or ``--own-models``) gives each
replica of the two-replica arm its own model, carried from the first
model's ``state_dict()`` (the test shares one model object between the
replicas), and ``record`` (or ``--record``) records every mixed step's
inputs in every arm (per row: its request, ids, the three lengths, its
block-table row, the batch's rows and tokens) and, for each row that takes
a token there, its logits; a parted stream then reports the first mixed
step whose inputs differ between the arms, and for each token the arms
both took in a mixed step, the largest logit difference between them and
from a full eager forward of the shared prefix, and the request's pool
rows after each mixed step (every layer's K and V at every cached
position, gathered on the card with no host sync), diffed between the
arms after the run: the first differing step, layer, position and
blocks. ``mem_pools`` gives each replica's engine (its KV
pools) its own caching-allocator pool (``torch.cuda.MemPool``): a
replica that writes memory the other's pools hold parts with one shared
pool and not with two. ``sync_mixed`` synchronizes the card after every
mixed forward. ``graph_tickets`` gives each captured graph a K2 ticket
buffer of its own (made and zeroed inside its capture) while the
replicas still capture on one stream; ``keep_cache`` makes
``torch.cuda.empty_cache`` (which every capture calls first) do nothing.
``mem_snapshots`` records the caching allocator's history
(``torch.cuda.memory._record_memory_history``) and takes a snapshot
before and after every captured step's warm-up and capture and at the
end of each arm: a block of the shared pool that a step's warm-up or
capture allocated and that is freed while the step's graph lives is a
suspect (a graph keeps the addresses it captured); each run reports the
suspects with the frames that allocated them and, where a later block
took the address, the frames that did. Run the base arm with
``CUBLAS_WORKSPACE_CONFIG=:0:0`` in the environment for no cuBLAS
workspace.
Prints one JSON line a run
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


def _blocks(torch, label):
    """The caching allocator's active blocks (address -> size, pool,
    the allocating frames) at ``label``."""
    out = {}
    for seg in torch.cuda.memory._snapshot()["segments"]:
        pool = list(seg.get("segment_pool_id", (0, 0)))
        for b in seg["blocks"]:
            if b["state"] != "active_allocated":
                continue
            frames = [f"{os.path.basename(f['filename'])}:{f['line']}:"
                      f"{f['name']}" for f in b.get("frames", [])
                      if "paddle_tpu_torch" in f["filename"]
                      or "tests" in f["filename"]][:5]
            out[b["address"]] = (b["size"], pool, frames)
    return label, out


def _suspects(marks, windows):
    """Blocks a captured step's warm-up or capture allocated in the
    shared pool (pool (0, 0)) that a later snapshot no longer holds,
    with the block that took the address next, if any. ``marks`` is the
    ordered list of (label, blocks); ``windows`` maps a step to the
    indices of its (before warm-up, after capture) marks."""
    found = []
    for step, (i0, i1) in windows.items():
        before = marks[i0][1]
        made = {a: v for j in range(i0 + 1, i1 + 1)
                for a, v in marks[j][1].items()
                if a not in before and tuple(v[1]) == (0, 0)}
        for addr, (size, _, frames) in made.items():
            for label, blocks in marks[i1 + 1:]:
                if addr in blocks and blocks[addr][2] == frames:
                    continue
                taker = next(((a, v) for a, v in blocks.items()
                              if a <= addr < a + v[0] or
                              addr <= a < addr + size), None)
                found.append({"step": step, "address": addr, "size": size,
                              "frames": frames, "freed_by": label,
                              "taken_by": None if taker is None else {
                                  "address": taker[0],
                                  "size": taker[1][0],
                                  "frames": taker[1][2]}})
                break
    return found


def _first_diff(a, b):
    return next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _recorder(engine, log):
    """Wrap ``engine``'s mixed forward and token selection so every mixed
    step of its own model appends, per row, the row's inputs to
    ``log[req_id]``, and the selection adds the logits and the token of
    each row that takes one (a replayed quantum runs no Python and
    records nothing)."""
    import numpy as np

    forward, select = engine._mixed_forward, engine._select

    def rec_forward(model, pool, tables, rotary, enc_lens, dec_lens,
                    this_time, ids):
        out = forward(model, pool, tables, rotary, enc_lens, dec_lens,
                      this_time, ids)
        if model is engine.model:
            rows = engine.scheduler.prefilling() + engine.scheduler.decoding()
            cu = np.concatenate([[0], np.cumsum(this_time)]).astype(int)
            for i, r in enumerate(rows):
                table = [int(b) for b in tables[i]]
                log.setdefault(r.req_id, []).append({
                    "ids": [int(t) for t in ids[cu[i]:cu[i + 1]]],
                    "enc": int(enc_lens[i]), "dec": int(dec_lens[i]),
                    "n": int(this_time[i]), "table": table,
                    "batch_rows": len(rows), "batch_tokens": int(cu[-1]),
                    "kv": _pool_rows(pool, table,
                                     int(dec_lens[i]) + int(this_time[i]))})
        return out

    def rec_select(logits, slots, steps):
        out = select(logits, slots, steps)
        if slots is not None:
            for row, slot in enumerate(slots):
                req = engine.scheduler.slots[slot]
                entry = log[req.req_id][-1]
                entry["token_index"] = len(req.tokens)
                entry["token"] = int(out[row])
                entry["logits"] = logits[row].float().cpu().tolist()
        return out

    engine._mixed_forward = rec_forward
    engine._select = rec_select


def _pool_rows(pool, table, n):
    """The request's pool rows at positions ``[0, n)`` after a mixed step:
    (layers, 2, n, HK, D) (K then V), with each position's block id. The
    rows are gathered on the card, in stream order, and stay there: no
    host sync (one takes the parting away); :func:`_first_pool_diff`
    reads them after the run."""
    import torch

    dev = pool.k_pools[0].device
    bs = pool.block_size
    # a pinned source: a copy from pageable memory would sync the stream
    tab = torch.tensor(table, dtype=torch.long).pin_memory().to(
        dev, non_blocking=True)
    pos = torch.arange(n, device=dev)
    b, o = tab[pos // bs], pos % bs
    rows = torch.stack([torch.stack([k[b, o], v[b, o]]) for k, v in
                        zip(pool.k_pools, pool.v_pools)])
    return {"rows": rows, "blocks": [table[p // bs] for p in range(n)]}


def _first_pool_diff(a, b, upto):
    """The first pool row that differs between two arms' snapshots of one
    request, over the mixed steps both arms ran at one position (by the
    cached length before the step) before ``upto``: the step, the layer,
    K or V, the position, each arm's block, and the largest difference
    there; or None. Rows written by decode quanta in between show in the
    next mixed step's snapshot."""
    xa = {e["dec"]: e for e in a if e["dec"] < upto and "kv" in e}
    xb = {e["dec"]: e for e in b if e["dec"] < upto and "kv" in e}
    for dec in sorted(set(xa) & set(xb)):
        ra, rb = xa[dec]["kv"], xb[dec]["kv"]
        n = min(ra["rows"].shape[2], rb["rows"].shape[2])
        diff = (ra["rows"][:, :, :n].cpu()
                - rb["rows"][:, :, :n].cpu()).abs()
        if bool((diff > 0).any()):
            per_pos = diff.amax(dim=(0, 1, 3, 4))
            pos = int((per_pos > 0).nonzero()[0])
            layer, kv = [int(i) for i in
                         (diff[:, :, pos].amax(dim=(2, 3)) > 0).nonzero()[0]]
            return {"step_cached_len": dec, "layer": layer,
                    "kv": "kv"[kv], "position": pos,
                    "blocks": [ra["blocks"][pos], rb["blocks"][pos]],
                    "max_abs_diff": float(diff.max()),
                    "positions_differing": int((per_pos > 0).sum()),
                    "of_positions": n}
    return None


def _first_input_diff(a, b, upto):
    """The first mixed-step row of one request, by its first position,
    whose inputs differ between two arms' records, over the positions
    before ``upto`` that both arms fed in a mixed step (ids, the three
    lengths; the table rows name each arm's own blocks, and a decode token
    may run in a mixed step in one arm and in a quantum in the other):
    both entries, or None."""
    keys = ("ids", "enc", "dec", "n")
    xa = {e["dec"]: e for e in a if e["dec"] < upto}
    xb = {e["dec"]: e for e in b if e["dec"] < upto}
    for pos in sorted(set(xa) & set(xb)):
        x, y = xa[pos], xb[pos]
        if any(x[k] != y[k] for k in keys):
            return {"position": pos, "a": {k: x[k] for k in keys},
                    "b": {k: y[k] for k in keys}}
    return None


def _logit_diffs(a, b, eager):
    """Per token both arms took in a mixed step: the largest |logit|
    difference between them, and of each from ``eager`` (the full eager
    forward's logits at the parting, for that token only)."""
    out = []
    la = {e["token_index"]: e for e in a if "logits" in e}
    lb = {e["token_index"]: e for e in b if "logits" in e}
    for k in sorted(set(la) & set(lb)):
        x, y = la[k]["logits"], lb[k]["logits"]
        rec = {"token": k, "tokens": [la[k]["token"], lb[k]["token"]],
               "batch_rows": [la[k]["batch_rows"], lb[k]["batch_rows"]],
               "max_abs_diff": max(abs(p - q) for p, q in zip(x, y))}
        if k in eager:
            rec["a_vs_eager"] = max(abs(p - q) for p, q in zip(x, eager[k]))
            rec["b_vs_eager"] = max(abs(p - q) for p, q in zip(y, eager[k]))
        out.append(rec)
    return out


def _body(T, torch, dev, mp, variant=()):
    """The test's body, returning the runs' streams and what each run's
    replicas did: one replica twice, then two whose graphs were captured
    on one shared stream and replay on one stream under the cluster
    pump."""
    from paddle_tpu_torch import create_serving_engine
    from paddle_tpu_torch.serving import (ClusterFrontDoor, ClusterReplica,
                                          ClusterRouter, no_shed_policy)

    model = T._tiny_cuda_model(dev)
    prompts = T._prefix_prompts()[1:5] + T._GRAPH_PROMPTS[:4]

    def poison():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        nan = float("nan")
        held = [torch.full((262144,), nan, device=dev) for _ in range(256)]
        held.append(torch.full((1 << 28,), nan, device=dev))
        del held
        torch.cuda.synchronize()

    def own_model():
        m = T._tiny_cuda_model(dev)
        m.load_state_dict(model.state_dict())
        return m

    def replica(i, n, own):
        engine = create_serving_engine(
            own_model() if own else model,
            prefix_cache="no_prefix" not in variant, **T._GRAPH_KW)
        return ClusterReplica(f"r{i}", engine, policy=no_shed_policy())

    def synced(fn):
        def run(*a, **k):
            out = fn(*a, **k)
            torch.cuda.synchronize()
            return out
        return run

    def in_pool(pool, fn):
        def run(*a, **k):
            with torch.cuda.use_mem_pool(pool):
                return fn(*a, **k)
        return run

    def run(n):
        if "poison" in variant:
            poison()
        own = "own_models" in variant and n > 1
        if "mem_pools" in variant:
            # each replica's engine (its KV pools) allocated from a
            # caching-allocator pool of its own; the steps allocate from
            # the shared one (a capture may not run under a MemPool)
            pools = [torch.cuda.MemPool() for _ in range(n)]
            reps = [in_pool(p, replica)(i, n, own)
                    for i, p in enumerate(pools)]
        else:
            pools = None
            reps = [replica(i, n, own) for i in range(n)]
        if "sync_mixed" in variant:
            for rep in reps:
                rep.engine._mixed_forward = synced(rep.engine._mixed_forward)
        logs = {}
        for rep in reps:
            rep.engine._eager = "eager" in variant
            if "record" in variant:
                _recorder(rep.engine, logs.setdefault(rep.name, {}))
        served = {}
        for rep in reps:
            submit = rep.door.submit

            def traced(tokens, *a, _rep=rep, _submit=submit, **kw):
                stream = _submit(tokens, *a, **kw)
                served[stream.request.req_id] = _rep.name
                return stream

            rep.door.submit = traced
        cfd = ClusterFrontDoor(ClusterRouter(reps, affinity_blocks=1,
                                             strategy="round_robin"))
        if "sequential" in variant:
            def pump():
                alive = False
                for rep in cfd.replicas:
                    if rep.engine.has_work:
                        alive = rep.door.pump_collect(
                            rep.door.pump_dispatch()) or alive
                return alive

            cfd.pump = pump
        streams = [cfd.submit(p, max_new_tokens=10) for p in prompts]
        cfd.run_until_idle()
        graphs = {r.name: {
            "stream": (r.engine._graph.stream.cuda_stream
                       if r.engine._graph is not None else None),
            "prefix_cache": r.engine.pool.prefix_cache_stats()
            if r.engine.prefix_cache else None,
            "decode_quanta": r.engine.stats.get("decode_quanta")}
            for r in reps}
        by = [served[s.request.req_id] for s in streams]
        steps = [logs.get(name, {}).get(s.request.req_id, [])
                 for name, s in zip(by, streams)]
        return ([list(s.result()) for s in streams],
                {"served_by": by, "graphs": graphs, "own_models": own,
                 "mixed_steps": steps, "mem_pools": pools})

    want, one = run(1)
    want2, one2 = run(1)
    shared = torch.cuda.Stream(dev)
    if "own_streams" not in variant:
        mp.setattr(torch.cuda, "Stream", lambda *a, **k: shared)
    got, two = run(2)
    return want, want2, got, prompts, model, {
        "one_replica": one, "one_replica_again": one2, "two_replicas": two,
        "shared": shared.cuda_stream}


def _partings(torch, model, prompts, a, b):
    """Each stream where ``a`` and ``b`` part: the token index, both
    runs' tokens up to it, and the logits of a full eager forward of the
    shared prefix there (top three ids and values)."""
    out = []
    for j, (x, y) in enumerate(zip(a, b)):
        if x == y:
            continue
        k = _first_diff(x, y)
        ids = torch.tensor([list(prompts[j]) + x[:k]],
                           device=model.lm_head.weight.device)
        with torch.no_grad():
            logits = model(ids)[0, -1].float()
        top = logits.topk(3)
        out.append({"stream": j, "token": k,
                    "a": [int(t) for t in x[:k + 1]],
                    "b": [int(t) for t in y[:k + 1]],
                    "top_ids": top.indices.tolist(),
                    "top_logits": top.values.tolist(),
                    "eager_logits": logits.tolist()})
    return out


def _diff_records(parted, prompts, one, two):
    """For each parted stream: the first mixed step whose inputs differ
    between the one-replica and the two-replica arm, and the logit
    differences of the tokens both took in a mixed step. Drops the eager
    logits row from ``parted`` once used."""
    for p in parted:
        eager = {p["token"]: p.pop("eager_logits")}
        a = one["mixed_steps"][p["stream"]]
        b = two["mixed_steps"][p["stream"]]
        if not (a or b):
            continue
        upto = len(prompts[p["stream"]]) + p["token"]
        p["first_input_diff"] = _first_input_diff(a, b, upto)
        p["first_pool_diff"] = _first_pool_diff(a, b, upto)
        p["logit_diffs"] = _logit_diffs(a, b, eager)
        p["mixed_step_tokens"] = [[e.get("token_index") for e in a],
                                  [e.get("token_index") for e in b]]


def main():
    import pytest
    import torch

    if not torch.cuda.is_available():
        print("needs CUDA", file=sys.stderr)
        return 2
    import test_torch_cuda as T
    from paddle_tpu_torch.ops import split_decode

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    keep = "--keep-tickets" in sys.argv
    variant = ()
    if "--variant" in sys.argv:
        named = sys.argv[sys.argv.index("--variant") + 1]
        variant = tuple(named.split(","))
        args = [a for a in args if a != named]
    variant += tuple(v for flag, v in (("--own-models", "own_models"),
                                       ("--record", "record"))
                     if flag in sys.argv)
    n = int(args[0]) if args else 20
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    made, plans = [], set()
    tickets_for, plan_for = split_decode.tickets_for, split_decode.plan_for

    if "keep_cache" in variant:
        # no capture releases the allocator's cached blocks to the driver
        torch.cuda.empty_cache = lambda: None
    marks, windows = [], {}
    if "mem_snapshots" in variant:
        from paddle_tpu_torch import _graphs

        torch.cuda.memory._record_memory_history(max_entries=200000)
        warm, cap = _graphs.CapturedStep.warm_up, _graphs.CapturedStep.capture

        def mark(label):
            torch.cuda.synchronize()
            marks.append(_blocks(torch, label))
            return len(marks) - 1

        def marked_warm(self):
            windows[id(self)] = [mark(f"{id(self)}:before_warm_up"), None]
            warm(self)
            mark(f"{id(self)}:after_warm_up")

        def marked_capture(self):
            mark(f"{id(self)}:before_capture")
            cap(self)
            windows[id(self)][1] = mark(f"{id(self)}:after_capture")

        _graphs.CapturedStep.warm_up = marked_warm
        _graphs.CapturedStep.capture = marked_capture
    capturing = {"step": None}
    graph_tickets = {}
    if "graph_tickets" in variant:
        from paddle_tpu_torch import _graphs

        capture = _graphs.CapturedStep.capture

        def own_capture(self):
            capturing["step"] = id(self)
            try:
                return capture(self)
            finally:
                capturing["step"] = None

        _graphs.CapturedStep.capture = own_capture

    def traced_tickets(device, stream, pairs):
        if capturing["step"] is not None:
            # this capture's own buffer, made (and zeroed) inside it
            key = (capturing["step"],) + split_decode.ticket_key(
                device.index, stream, pairs)
            if key not in graph_tickets:
                graph_tickets[key] = torch.zeros(key[-1], dtype=torch.int32,
                                                 device=device)
            return graph_tickets[key]
        if "fresh_tickets" in variant:
            return torch.zeros(split_decode.ticket_key(
                device.index, stream, pairs)[2], dtype=torch.int32,
                device=device)
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
    failures = one_moved = 0
    t_all = time.perf_counter()
    for i in range(n):
        if not keep:
            split_decode._TICKETS.clear()
        marks.clear()
        windows.clear()
        made.clear()
        plans.clear()
        torch.cuda.synchronize()
        dirty_before = _dirty(torch, split_decode)
        mp = pytest.MonkeyPatch()
        t0 = time.perf_counter()
        try:
            want, want2, got, prompts, model, streams = _body(
                T, torch, dev, mp, variant)
            moved = _partings(torch, model, prompts, want, want2)
            parted = _partings(torch, model, prompts, want, got)
            for p in moved:
                p.pop("eager_logits")
            if "record" in variant:
                _diff_records(parted, prompts, streams["one_replica"],
                              streams["two_replicas"])
            else:
                for p in parted:
                    p.pop("eager_logits")
            for arm in ("one_replica", "one_replica_again", "two_replicas"):
                streams[arm].pop("mixed_steps")
                streams[arm].pop("mem_pools", None)
            result = ("pass" if not parted else
                      f"parted {[(p['stream'], p['token']) for p in parted]}")
            failures += bool(parted)
            one_moved += bool(moved)
        except Exception:
            failures += 1
            parted, moved, streams = None, None, None
            result = traceback.format_exc(limit=3)[-2000:]
        finally:
            mp.undo()
        torch.cuda.synchronize()
        suspects = None
        if "mem_snapshots" in variant:
            marks.append(_blocks(torch, "end"))
            suspects = _suspects(marks, {k: tuple(v) for k, v in
                                         windows.items() if v[1]})
        print(json.dumps({"run": i, "result": result, "streams": streams,
                          "suspects": suspects,
                          "captured_steps": list(windows),
                          "partings": parted, "one_replica_moved": moved,
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
                      "one_replica_moved": one_moved,
                      "variant": list(variant),
                      "keep_tickets": keep,
                      "cublas_workspace_config": os.environ.get(
                          "CUBLAS_WORKSPACE_CONFIG"),
                      "wall_s": time.perf_counter() - t_all}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
