"""Multi-rank jobs of the port's distributed tier, on the CPU (gloo).

``run_ranks(job, nprocs, tmp_path, payload)`` starts ``nprocs`` processes
of this file, one rank each, with a ``file://`` store under ``tmp_path``,
one thread each and a deadline: a job that outlives it is killed and the
test fails with the ranks' output. Each rank runs ``job(payload)`` (a
function below) and hands back what it returns; the parent test holds the
ranks' results against the reference and against the port's serial run.
This file imports torch, numpy and the port only (no JAX), so the ranks
start fast.

    python tests/torch_dist_jobs.py JOB PAYLOAD.pkl OUT_DIR
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]


def shared(tmp_path_factory, name, compute):
    """``compute()`` once per test session, also across xdist workers:
    the first worker to ask computes under a file lock and pickles the
    result beside the workers' temp dirs; the others wait and load it (so
    a module's job does not run again on every worker that gets one of
    its tests)."""
    import fcntl

    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = root / f"shared_{name}.pkl"
    with open(root / f"shared_{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return pickle.loads(path.read_bytes())
        result = compute()
        path.write_bytes(pickle.dumps(result))
        return result


def run_ranks(job, nprocs, tmp_path, payload=None, timeout=120):
    """Run ``job`` on ``nprocs`` ranks; returns the ranks' results in rank
    order."""
    tmp_path = Path(tmp_path)
    work = tmp_path / f"job_{job}_{nprocs}"
    work.mkdir(parents=True, exist_ok=True)
    pay = work / "payload.pkl"
    pay.write_bytes(pickle.dumps(payload))
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", PADDLE_DEVICE="cpu",
               PADDLE_TRAINERS_NUM=str(nprocs),
               PADDLE_INIT_METHOD="file://" + str(work / "store"),
               CUDA_VISIBLE_DEVICES="")
    procs, logs = [], []
    for r in range(nprocs):
        log = open(work / f"rank{r}.log", "wb")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), job, str(pay),
             str(work)],
            env=dict(env, PADDLE_TRAINER_ID=str(r), PADDLE_LOCAL_RANK=str(r)),
            stdout=log, stderr=subprocess.STDOUT, cwd=str(work)))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        out = "\n".join(
            f"--- rank {r} (rc {rcs[r]}) ---\n"
            + (work / f"rank{r}.log").read_text(errors="replace")[-4000:]
            for r in range(nprocs))
        raise AssertionError(f"job {job} on {nprocs} ranks failed or "
                             f"timed out after {timeout} s:\n{out}")
    return [pickle.loads((work / f"out{r}.pkl").read_bytes())
            for r in range(nprocs)]


# -- helpers used inside the ranks ----------------------------------------
def _np(t):
    return t.detach().float().cpu().numpy().copy()


def _fleet(dp=1, mp=1, pp=1, sharding=1, acc=1, stage=None):
    from paddle_tpu_torch.distributed import fleet

    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp, "sharding_degree": sharding}
    strategy.pipeline_configs = {"accumulate_steps": acc}
    if stage:
        strategy.sharding = True
        strategy.sharding_configs = {"stage": stage}
    fleet.init(is_collective=True, strategy=strategy, device="cpu")
    return strategy


def _carry(model, arrays, subset=False):
    from paddle_tpu_torch.nlp import load_paddle_tpu_arrays

    return load_paddle_tpu_arrays(model, arrays, subset=subset)


def _full(model):
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        group_sharded)

    return {k: _np(v) for k, v in
            group_sharded.full_state_dict(model).items()}


# -- jobs ------------------------------------------------------------------
def collectives(payload):
    """Every collective of ``paddle_tpu_torch.distributed`` at this world
    size, a 2-rank subgroup, and DataParallel's wrap and gradients."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn

    dist.init_parallel_env()
    r, n = dist.get_rank(), dist.get_world_size()
    out = {"rank": r, "world": n, "backend": dist.get_backend()}
    base = torch.arange(4, dtype=torch.float32) + r
    for name in ("SUM", "MAX", "MIN", "PROD", "AVG"):
        t = base.clone()
        dist.all_reduce(t, op=getattr(dist.ReduceOp, name))
        out["all_reduce_" + name] = t.numpy()
    t = base.clone()
    task = dist.all_reduce(t, sync_op=False)
    out["task"] = (task.wait(), task.is_completed(), t.numpy())
    t = base.clone()
    dist.broadcast(t, src=n - 1)
    out["broadcast"] = t.numpy()
    t = base.clone()
    dist.reduce(t, dst=1)
    out["reduce"] = t.numpy()
    rows = []
    dist.all_gather(rows, base)
    out["all_gather"] = [x.numpy() for x in rows]
    objs = []
    dist.all_gather_object(objs, {"r": r})
    out["all_gather_object"] = objs
    lst = [f"from{r}", r]
    dist.broadcast_object_list(lst, src=1)
    out["broadcast_object_list"] = lst
    got = []
    dist.scatter_object_list(got, [f"item{i}" for i in range(n)]
                             if r == 0 else None, src=0)
    out["scatter_object_list"] = got
    t = torch.zeros(4)
    dist.scatter(t, [torch.full((4,), float(i)) for i in range(n)]
                 if r == 0 else None, src=0)
    out["scatter"] = t.numpy()
    gl = []
    dist.gather(base, gl, dst=n - 1)
    out["gather"] = [x.numpy() for x in gl]
    outs = []
    dist.all_to_all(outs, [torch.full((2,), 10.0 * r + i) for i in range(n)])
    out["all_to_all"] = [x.numpy() for x in outs]
    t = torch.zeros(3)
    if r % 2 == 0:
        dist.send(torch.full((3,), float(r)), dst=r + 1)
    else:
        dist.recv(t, src=r - 1)
    out["recv"] = t.numpy()
    pair = dist.new_group([0, 1])
    t = base.clone()
    if pair.rank >= 0:
        dist.all_reduce(t, group=pair)
    out["subgroup"] = (pair.ranks, pair.rank, pair.nranks, t.numpy())
    dist.barrier()

    # DataParallel: rank 0's weights at wrap, gradients of the global batch
    from paddle_tpu_torch.distributed import fleet

    _fleet()
    torch.manual_seed(100 + r)  # every rank builds different weights
    lin = nn.Linear(4, 3)
    dp = fleet.distributed_model(lin)
    out["dp_type"] = type(dp).__name__
    out["dp_weight"] = _np(lin.weight)
    out["dp_bias"] = _np(lin.bias)
    x = torch.from_numpy(payload["x"])
    loss = dp(x.chunk(n)[r]).square().mean()
    loss.backward()
    out["dp_grad"] = _np(lin.weight.grad)
    return out


def tensor_parallel(payload):
    """mp2: the column / row / vocab layers and ParallelCrossEntropy
    against full inputs, then three SGD steps."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.nn import functional as F

    _fleet(mp=2)
    hcg = fleet.get_hybrid_communicate_group()
    r = dist.get_rank()
    out = {"mp_rank": hcg.get_model_parallel_rank(),
           "mp_world": hcg.get_model_parallel_world_size()}
    x = torch.from_numpy(payload["x"])

    class Pair(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.col = ColumnParallelLinear(8, 16, has_bias=True,
                                            gather_output=False)
            self.row = RowParallelLinear(16, 8, has_bias=True,
                                         input_is_parallel=True)

        def forward(self, v):
            return self.row(self.col(v))

    pair = _carry(Pair(), payload["pair"])
    out["pair"] = _np(pair(x))
    out["col_local"] = tuple(pair.col.weight.shape)
    out["row_local"] = tuple(pair.row.weight.shape)
    out["distributed"] = (pair.col.weight.is_distributed,
                          pair.row.weight.is_distributed)
    out["col_local_out"] = _np(pair.col(x))
    gathered = ColumnParallelLinear(8, 16, has_bias=True, gather_output=True)
    gathered.weight.data.copy_(pair.col.weight.data)
    gathered.bias.data.copy_(pair.col.bias.data)
    out["col_gathered"] = _np(gathered(x))
    split_in = RowParallelLinear(16, 8, has_bias=True,
                                 input_is_parallel=False)
    split_in.weight.data.copy_(pair.row.weight.data)
    split_in.bias.data.copy_(pair.row.bias.data)
    out["row_split_in"] = _np(split_in(torch.from_numpy(payload["h"])))

    emb = VocabParallelEmbedding(16, 8)
    emb = _carry(nn.Sequential(emb), {"0.weight": payload["emb"]})[0]
    out["emb"] = _np(emb(torch.from_numpy(payload["ids"])))
    out["emb_local"] = tuple(emb.weight.shape)

    logits = torch.from_numpy(payload["logits"]).requires_grad_(True)
    local = logits.chunk(2, dim=-1)[hcg.get_model_parallel_rank()]
    local = local.detach().requires_grad_(True)
    loss = ParallelCrossEntropy()(local, torch.from_numpy(payload["labels"]))
    out["pce"] = _np(loss)
    loss.mean().backward()
    out["pce_grad"] = _np(local.grad)

    # three SGD steps, the reference's test_tp_training_matches_serial
    train = _carry(Pair2(), payload["train"])
    opt = optimizer.SGD(0.1, parameters=train.named_parameters())
    xt, yt = torch.from_numpy(payload["xt"]), torch.from_numpy(payload["yt"])
    losses = []
    for _ in range(3):
        l_ = F.cross_entropy(train(xt), yt)
        l_.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(l_))
    out["losses"] = losses
    out["params"] = _full(train)
    out["rank"] = r
    return out


class Pair2(torch.nn.Module):
    """8 -> 16 column-parallel, 16 -> 4 row-parallel (biases on both)."""

    def __init__(self):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet.meta_parallel import (
            ColumnParallelLinear, RowParallelLinear)

        self.col = ColumnParallelLinear(8, 16, has_bias=True,
                                        gather_output=False)
        self.row = RowParallelLinear(16, 4, has_bias=True,
                                     input_is_parallel=True)

    def forward(self, v):
        return self.row(self.col(v))


def _mlp():
    from paddle_tpu_torch import nn

    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


def sharding_stages(payload):
    """Stages os, os_g and p_g_os at sharding 4: each rank trains on its
    quarter of the batch; the losses, the parameters and each rank's
    parameter and state bytes."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        group_sharded)
    from paddle_tpu_torch.distributed.sharding import group_sharded_parallel
    from paddle_tpu_torch.nn import functional as F

    _fleet(sharding=4)
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.from_numpy(payload["x"]).chunk(n)[r]
    y = torch.from_numpy(payload["y"]).chunk(n)[r]
    out = {}
    for level in ("os", "os_g", "p_g_os"):
        m = _carry(_mlp(), payload["arrays"])
        opt = optimizer.Adam(0.05, parameters=m.named_parameters())
        m2, opt, _ = group_sharded_parallel(m, opt, level)
        group_sharded.stage3_stats(reset=True)
        losses = []
        for _ in range(3):
            loss = F.cross_entropy(m2(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            t = loss.detach().clone()
            dist.all_reduce(t, op=dist.ReduceOp.AVG)
            losses.append(float(t))
        params = dict(m.named_parameters())
        out[level] = {
            "losses": losses, "params": _full(m),
            "param_numel": {k: p.numel() for k, p in params.items()},
            "state_numel": {k: {s: v.numel() for s, v in
                                opt._states[id(p)].items()}
                            for k, p in params.items()},
            "stage3": group_sharded.stage3_stats(),
            "is_sharded": {k: bool(getattr(p, "is_sharded", False))
                           for k, p in params.items()}}
    return out


def _pp_descs(tp=False):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet import LayerDesc
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)

    if tp:
        return [LayerDesc(ColumnParallelLinear, 16, 32, gather_output=False),
                LayerDesc(nn.ReLU),
                LayerDesc(RowParallelLinear, 32, 32, input_is_parallel=True),
                LayerDesc(nn.ReLU),
                LayerDesc(ColumnParallelLinear, 32, 32, gather_output=True),
                LayerDesc(nn.ReLU), LayerDesc(nn.Linear, 32, 8)]
    return [LayerDesc(nn.Linear, 16, 32), LayerDesc(nn.ReLU),
            LayerDesc(nn.Linear, 32, 32), LayerDesc(nn.ReLU),
            LayerDesc(nn.Linear, 32, 32), LayerDesc(nn.ReLU),
            LayerDesc(nn.Linear, 32, 8)]


def _pp_train(payload, pp, acc, virtual=None, scaler=None, steps=3,
              descs=None, inject_inf=False):
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet

    strategy = _fleet(pp=pp, acc=acc)
    pipe = fleet.PipelineLayer(layers=descs or _pp_descs(), num_stages=pp,
                               loss_fn=nn.CrossEntropyLoss(),
                               num_virtual_pipeline_stages=virtual)
    if descs is None:
        _carry(pipe, payload["arrays"], subset=True)
    init = {k: _np(v) for k, v in pipe.named_parameters()}
    model = fleet.distributed_model(pipe)
    opt = optimizer.SGD(0.1, parameters=pipe.named_parameters())
    x, y = torch.from_numpy(payload["x"]), torch.from_numpy(payload["y"])
    losses = []
    for _ in range(steps):
        if inject_inf:
            first = next(iter(pipe.parameters()))
            first.register_hook(lambda g: g * float("inf"))
            inject_inf = False
        losses.append(float(model.train_batch([x, y], opt, scaler=scaler)))
    return model, pipe, losses, init


def pipeline(payload):
    """pp4 and pp2 (dp 2) against serial, the interleave's placement and
    losses, eval_batch, the scaler path (a found inf on one stage skips the
    step on every rank), and a shared layer across stages."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import amp, nn
    from paddle_tpu_torch.distributed import fleet

    out = {"rank": dist.get_rank()} if dist.is_initialized() else {}
    out["pp4"] = _pp_train(payload, 4, 2)[2]
    model, pipe, out["pp2"], _ = _pp_train(payload, 2, 4)
    out["pp2_type"] = type(model).__name__
    out["pp2_dp"] = fleet.get_hybrid_communicate_group() \
        .get_data_parallel_world_size()
    out["pp2_eval"] = float(model.eval_batch(
        [torch.from_numpy(payload["x"]), torch.from_numpy(payload["y"])]))
    out["pp2_stage_keys"] = sorted(k for k, _ in pipe.named_parameters())
    model, pipe, out["interleave"], _ = _pp_train(payload, 2, 4, virtual=2)
    out["interleave_type"] = type(model).__name__
    out["chunk_stage"] = [pipe.chunk_stage(c) for c in range(pipe.num_chunks)]
    out["local_chunks"] = [c for c in range(pipe.num_chunks)
                           if pipe.is_local_chunk(c)]
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    out["scaler"] = _pp_train(payload, 2, 2, scaler=scaler, steps=1)[2]
    out["plain_acc2"] = _pp_train(payload, 2, 2, steps=1)[2]
    scaler = amp.GradScaler(init_loss_scaling=128.0)
    pipe = _pp_train(payload, 2, 2, scaler=scaler, steps=1,
                     inject_inf=dist.get_rank() == 0)[1]
    out["inf_skipped"] = {k: _np(v) for k, v in pipe.named_parameters()}
    out["inf_scale"] = scaler.get_loss_scaling()

    # a layer shared by the first and the last stage
    shared = [fleet.SharedLayerDesc("tied", nn.Linear, None, "weight", 16,
                                    16),
              fleet.LayerDesc(nn.ReLU), fleet.LayerDesc(nn.Linear, 16, 16),
              fleet.LayerDesc(nn.ReLU),
              fleet.SharedLayerDesc("tied", nn.Linear, None, "weight", 16,
                                    16),
              fleet.LayerDesc(nn.Linear, 16, 8)]
    torch.manual_seed(3)
    _, pipe, out["shared"], out["shared_init"] = _pp_train(
        payload, 2, 4, descs=shared)
    out["shared_params"] = {k: _np(v) for k, v in pipe.named_parameters()}
    return out


def hybrid(payload):
    """mp2 x pp2 x sharding2 at stages 2 and 3, plain and interleaved."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch import nn, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        PipelineParallel, PipelineParallelWithInterleave)

    out = {}
    x, y = torch.from_numpy(payload["x"]), torch.from_numpy(payload["y"])
    for virtual, stage in ((None, 2), (2, 2), (None, 3), (2, 3)):
        _fleet(mp=2, pp=2, sharding=2, acc=2, stage=stage)
        pipe = fleet.PipelineLayer(layers=_pp_descs(tp=True), num_stages=2,
                                   loss_fn=nn.CrossEntropyLoss(),
                                   num_virtual_pipeline_stages=virtual)
        model = fleet.distributed_model(pipe)
        _carry(pipe, payload["arrays"], subset=True)
        opt = fleet.distributed_optimizer(optimizer.AdamW(
            1e-3, parameters=pipe.named_parameters(), weight_decay=0.01))
        losses = [float(model.train_batch([x, y], opt)) for _ in range(3)]
        want = PipelineParallelWithInterleave if virtual else PipelineParallel
        facts = {"losses": losses, "type_ok": type(model) is want,
                 "numel": {}, "moment_numel": {}, "full_numel": {}}
        for k, p in pipe.named_parameters():
            if getattr(p, "_mp_split", None) is not None:
                facts["numel"][k] = p.numel()
                facts["full_numel"][k] = int(np.prod(p._full_shape))
                facts["moment_numel"][k] = \
                    opt._states[id(p)]["moment1"].numel()
        out[(virtual, stage)] = facts
    out["rank"] = dist.get_rank()
    return out


def llama(payload):
    """The tiny Llama under dp2 x mp2 x sharding2 through JittedTrainStep
    (state sharded over ``sharding``), then the same at stage 3."""
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        group_sharded)
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    out = {}
    ids = torch.from_numpy(payload["ids"])
    for stage in (None, 3):
        _fleet(dp=2, mp=2, sharding=2, stage=stage)
        hcg = fleet.get_hybrid_communicate_group()
        cfg = LlamaConfig.tiny(tensor_parallel=True)
        m = LlamaForCausalLM(cfg, device="cpu")
        facts = {"q_local": tuple(m.llama.layers[0].self_attn.q_proj
                                  .weight.shape),
                 "heads": (m.llama.layers[0].self_attn.num_heads,
                           m.llama.layers[0].self_attn.num_kv_heads)}
        model = m
        if stage == 3:
            model = fleet.distributed_model(m)
            facts["wrapper"] = type(model).__name__
        _carry(m, payload["arrays"])
        crit = LlamaPretrainingCriterion(cfg)
        opt = AdamW(1e-3, parameters=m.named_parameters(), weight_decay=0.01)
        if stage == 3:
            opt = fleet.distributed_optimizer(opt)
        step = JittedTrainStep(model, lambda o, lb: crit(o, lb), opt,
                               state_sharding_axis="sharding")
        group_sharded.stage3_stats(reset=True)
        facts["losses"] = [float(step(ids, ids)) for _ in range(3)]
        facts["stage3"] = group_sharded.stage3_stats()
        if stage is None:
            # run_steps under the mesh: three steps of one dispatch
            m2 = _carry(LlamaForCausalLM(cfg, device="cpu"),
                        payload["arrays"])
            step2 = JittedTrainStep(
                m2, lambda o, lb: crit(o, lb),
                AdamW(1e-3, parameters=m2.named_parameters(),
                      weight_decay=0.01), state_sharding_axis="sharding")
            stacked = ids[None].expand(3, *ids.shape)
            facts["run_steps"] = [float(x) for x in
                                  step2.run_steps(stacked, stacked)]
        q = m.llama.layers[0].self_attn.q_proj.weight
        facts["q_numel"] = q.numel()
        facts["q_full_numel"] = int(np.prod(q._full_shape))
        qi = next(i for i, p in enumerate(step._params) if p is q)
        facts["q_moment_numel"] = step._states[qi]["moment1"].numel()
        facts["params"] = _full(m)
        facts["coord"] = {
            "dp": hcg.get_data_parallel_rank(),
            "mp": hcg.get_model_parallel_rank(),
            "sharding": hcg.get_sharding_parallel_rank(),
            "groups": {a: g.ranks for a, g in (
                ("dp", hcg.get_data_parallel_group()),
                ("mp", hcg.get_model_parallel_group()),
                ("sharding", hcg.get_sharding_parallel_group()),
                ("pp", hcg.get_pipe_parallel_group()))}}
        out[stage] = facts
    out["rank"] = dist.get_rank()
    return out


def spawned_child(path):
    """The target of ``spawn_demo``: one all-reduce, its result written."""
    import paddle_tpu_torch.distributed as dist

    dist.init_parallel_env()
    t = torch.tensor([float(dist.get_rank() + 1)])
    dist.all_reduce(t)
    Path(path, f"spawned{dist.get_rank()}.txt").write_text(
        f"{dist.get_world_size()} {float(t)}")


def spawn_demo(payload):
    """``paddle_tpu_torch.distributed.spawn`` of two CPU ranks."""
    import paddle_tpu_torch.distributed as dist

    where = os.getcwd()
    dist.spawn(spawned_child, args=(where,), nprocs=2, device="cpu")
    return sorted(Path(where, f"spawned{r}.txt").read_text()
                  for r in range(2))


def main(argv):
    job, pay, work = argv[1], argv[2], argv[3]
    payload = pickle.loads(Path(pay).read_bytes())
    if job != "spawn_demo":
        import paddle_tpu_torch.distributed as dist

        dist.init_parallel_env(device="cpu", timeout=90)
    result = globals()[job](payload)
    rank = int(os.environ["PADDLE_TRAINER_ID"])
    Path(work, f"out{rank}.pkl").write_bytes(pickle.dumps(result))
    if job != "spawn_demo":
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv)
