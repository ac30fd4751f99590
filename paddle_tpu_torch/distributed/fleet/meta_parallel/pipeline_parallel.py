"""Pipeline parallelism (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pipeline_parallel.py``).

The reference drives every stage from one controller. Here each rank
runs its own stage's chunks and the activations and gradients travel by
point-to-point messages. The schedule is 1F1B over ``accumulate_steps``
micro-batches and the chunk list (one chunk a stage, or ``num_stages x
num_virtual_pipeline_stages`` chunks placed round robin for the
interleave): each chunk keeps at most its warm-up's micro-batches in
flight. Every rank derives the whole schedule in ticks (:func:`schedule`):
at a tick each chunk takes its next action if its input was made at an
earlier tick. A rank runs its chunks' actions of a tick, then the tick's
messages move in one batch of sends and receives posted in one global
order on both sides, so no rank waits on a message made later than what
it waits with. The shape and dtype of a step's first activation over
each chunk boundary travel ahead of it; the gradients have the shapes of
the activations they answer.

The loss is computed on the last stage, each micro-batch's scaled by
1/m (and by the ``scaler``'s scale) before its backward, and the mean
is broadcast over the pipeline. After the schedule a shared layer's
gradients are summed over its stages and every gradient is averaged over
``dp``; with a ``scaler`` the found-inf flag is all-reduced (max) over
every rank, so all ranks skip the same step.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ....parallel import mesh as mesh_state
from .parallel_layers.pp_layers import PipelineLayer

__all__ = ["PipelineParallel", "PipelineParallelWithInterleave",
           "schedule"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32]
_META_LEN = 10  # dtype code, ndim, up to 8 dims


def schedule(num_chunks, num_micro, train=True):
    """The global 1F1B schedule: a list of (tick, chunk, kind, micro),
    kind ``"F"`` or ``"B"``, in tick order (chunks ascending within a
    tick). Without ``train`` only forwards."""
    acts = []
    for k in range(num_chunks):
        if not train:
            acts.append([("F", i) for i in range(num_micro)])
            continue
        warm = min(num_chunks - k - 1, num_micro)
        seq = [("F", i) for i in range(warm)]
        f, b = warm, 0
        while f < num_micro:
            seq += [("F", f), ("B", b)]
            f, b = f + 1, b + 1
        seq += [("B", i) for i in range(b, num_micro)]
        acts.append(seq)
    done, pos, order, tick = set(), [0] * num_chunks, [], 0
    last = num_chunks - 1
    while any(p < len(a) for p, a in zip(pos, acts)):
        ready = []
        for k in range(num_chunks):
            if pos[k] == len(acts[k]):
                continue
            kind, i = acts[k][pos[k]]
            if kind == "F":
                ok = k == 0 or ("F", k - 1, i) in done
            else:
                ok = (("F", k, i) in done if k == last
                      else ("B", k + 1, i) in done)
            if ok:
                ready.append((k, kind, i))
        if not ready:
            raise RuntimeError("the pipeline schedule stalled")
        for k, kind, i in ready:
            done.add((kind, k, i))
            pos[k] += 1
            order.append((tick, k, kind, i))
        tick += 1
    return order


class PipelineParallel:
    def __init__(self, layers, hcg, strategy):
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        self._layers = layers
        self._hcg = hcg
        self._strategy = strategy
        pp_cfg = strategy.pipeline_configs
        self._acc_steps = int(pp_cfg.get("accumulate_steps", 1))
        self.num_stages = hcg.num_stages
        params = list(layers.parameters())
        self._device = params[0].device if params else torch.device("cpu")

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    # -- helpers -----------------------------------------------------------
    def _rank_of_chunk(self, chunk):
        return self._hcg.get_rank_from_stage(self._layers.chunk_stage(chunk))

    def _split_micro_batches(self, data):
        x, y = data
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        m = self._acc_steps
        if x.shape[0] % m:
            raise ValueError(f"batch {x.shape[0]} not divisible by "
                             f"accumulate_steps {m}")
        mb = x.shape[0] // m
        dev = self._device
        return [(x[i * mb:(i + 1) * mb].to(dev), y[i * mb:(i + 1) * mb].to(dev))
                for i in range(m)]

    def _meta(self, t=None):
        if t is None:
            return torch.zeros(_META_LEN, dtype=torch.int64,
                               device=self._device)
        if t.dim() > _META_LEN - 2:
            raise ValueError("a pipeline activation has too many dims")
        vals = [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        vals += [0] * (_META_LEN - len(vals))
        return torch.tensor(vals, dtype=torch.int64, device=self._device)

    @staticmethod
    def _from_meta(meta):
        vals = meta.tolist()
        return _DTYPES[vals[0]], tuple(vals[2:2 + vals[1]])

    def _exchange(self, msgs, state):
        """Move one tick's messages: ``msgs`` is the tick's (src chunk,
        dst chunk, kind, micro) list in global order. Sends come from
        ``state['out']``; receives land in ``state['in']``."""
        me = dist.get_rank()
        shapes = state["shapes"]
        rounds = ([], [])  # meta round, payload round
        posted = []
        for src, dst, kind, i in msgs:
            s_rank, d_rank = self._rank_of_chunk(src), self._rank_of_chunk(dst)
            if me not in (s_rank, d_rank):
                continue
            key = (kind, src, dst)
            if s_rank == d_rank:  # both chunks on this rank
                state["in"][(kind, dst, i)] = state["out"].pop(
                    (kind, src, i))
                continue
            if me == s_rank:
                t = state["out"].pop((kind, src, i)).contiguous()
                if key not in shapes:
                    shapes[key] = (t.dtype, tuple(t.shape))
                    rounds[0].append(dist.P2POp(dist.isend, self._meta(t),
                                                d_rank))
                rounds[1].append(dist.P2POp(dist.isend, t, d_rank))
            else:
                meta = None
                if key not in shapes:
                    meta = self._meta()
                    rounds[0].append(dist.P2POp(dist.irecv, meta, s_rank))
                posted.append((key, kind, dst, i, s_rank, meta))
        if rounds[0]:
            for w in dist.batch_isend_irecv(rounds[0]):
                w.wait()
        bufs = []
        for key, kind, dst, i, s_rank, meta in posted:
            if meta is not None:
                shapes[key] = self._from_meta(meta)
            dtype, shape = shapes[key]
            buf = torch.empty(shape, dtype=dtype, device=self._device)
            bufs.append(((kind, dst, i), buf))
            rounds[1].append(dist.P2POp(dist.irecv, buf, s_rank))
        if rounds[1]:
            for w in dist.batch_isend_irecv(rounds[1]):
                w.wait()
        for k, buf in bufs:
            state["in"][k] = buf

    def _run(self, micros, train, scale=1.0):
        """The schedule on this rank; returns the sum of the last chunk's
        micro-batch losses over m (on the last stage; None elsewhere) and
        the last chunk's outputs."""
        layers = self._layers
        n, m = layers.num_chunks, len(micros)
        order = schedule(n, m, train)
        state = {"out": {}, "in": {}, "shapes": {}}
        stash, losses, outputs = {}, [], []
        ticks = {}
        for tick, k, kind, i in order:
            ticks.setdefault(tick, []).append((k, kind, i))
        for tick in sorted(ticks):
            msgs = []
            for k, kind, i in ticks[tick]:
                if kind == "F" and k < n - 1:
                    msgs.append((k, k + 1, "F", i))
                elif kind == "B" and k > 0:
                    msgs.append((k, k - 1, "B", i))
                if not layers.is_local_chunk(k):
                    continue
                if kind == "F":
                    self._forward(k, i, micros, train, state, stash,
                                  losses, outputs)
                else:
                    self._backward(k, i, m, scale, state, stash, losses)
            self._exchange(msgs, state)
        if not losses:
            return None, outputs
        return sum(float(l) for l in losses) / m, outputs

    def _forward(self, k, i, micros, train, state, stash, losses, outputs):
        layers = self._layers
        n = layers.num_chunks
        if k == 0:
            x = micros[i][0]
        else:
            x = state["in"].pop(("F", k, i))
            if train and x.is_floating_point():
                x.requires_grad_(True)
        with torch.set_grad_enabled(train):
            out = layers.forward_stage(x, k)
            if k == n - 1:
                loss_fn = layers.loss_fn
                if loss_fn is None:
                    outputs.append(out.detach())
                    return
                loss = loss_fn(out, micros[i][1])
                losses.append(loss.detach())
                if train:
                    stash[(k, i)] = (x, loss, True)
                return
        if isinstance(out, tuple):
            raise NotImplementedError(
                "tuple activations between pipeline stages are not ported "
                "(ROADMAP A7)")
        if train:
            stash[(k, i)] = (x, out, False)
        state["out"][("F", k, i)] = out.detach()

    def _backward(self, k, i, m, scale, state, stash, losses):
        x, out, is_loss = stash.pop((k, i))
        if is_loss:  # the last chunk: out is its loss
            torch.autograd.backward(out * (scale / m))
        else:
            grad = state["in"].pop(("B", k, i))
            torch.autograd.backward(out, grad)
        if k > 0:
            state["out"][("B", k, i)] = (x.grad if x.grad is not None
                                         else torch.zeros_like(x))

    def _broadcast_loss(self, loss):
        pp = mesh_state.axis_group("pp")
        src = self._rank_of_chunk(self._layers.num_chunks - 1)
        t = torch.tensor([0.0 if loss is None else loss],
                         dtype=torch.float64, device=self._device)
        dist.broadcast(t, src, group=pp.process_group)
        return float(t)

    def _sync_grads(self):
        self._layers.sync_shared_grads()
        dp = mesh_state.axis_group("dp")
        for p in self._layers.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, op=dist.ReduceOp.AVG,
                                group=dp.process_group)

    # -- public API --------------------------------------------------------
    def forward_backward_pipeline(self, data, scaler=None):
        """Run the 1F1B schedule; returns the mean micro-batch loss."""
        micros = self._split_micro_batches(data)
        scale = float(scaler.get_loss_scaling()) if scaler is not None \
            and scaler.is_enable() else 1.0
        loss, _ = self._run(micros, True, scale)
        self._sync_grads()
        return self._broadcast_loss(loss)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        self._layers.train()
        loss = self.forward_backward_pipeline(data, scaler)
        if scaler is not None and scaler.is_enable():
            scaler.unscale_(optimizer)
            flag = torch.tensor([float(scaler._found_inf)],
                                device=self._device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            scaler._found_inf = bool(flag.item())
            scaler.step(optimizer)
            scaler.update()
        else:
            optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return torch.tensor(loss, dtype=torch.float32)

    def eval_batch(self, data, compute_loss=True):
        """The mean loss (every rank), or with ``compute_loss=False`` the
        last chunk's outputs (on the last stage; an empty list elsewhere)."""
        self._layers.eval()
        micros = self._split_micro_batches(data)
        if compute_loss:
            loss, _ = self._run(micros, False)
            return torch.tensor(self._broadcast_loss(loss),
                                dtype=torch.float32)
        loss_fn = self._layers._loss_fn
        self._layers._loss_fn = None
        try:
            _, outputs = self._run(micros, False)
        finally:
            self._layers._loss_fn = loss_fn
        return outputs


class PipelineParallelWithInterleave(PipelineParallel):
    """The interleaved schedule: the ``PipelineLayer`` is built with
    ``num_virtual_pipeline_stages > 1`` (chunk c on stage c % S) and the
    same 1F1B runs over the finer chunk list."""

    def __init__(self, layers, hcg, strategy):
        super().__init__(layers, hcg, strategy)
        if layers.num_chunks == layers.num_stages:
            import warnings

            warnings.warn(
                "PipelineParallelWithInterleave without "
                "num_virtual_pipeline_stages>1 degrades to plain 1F1B",
                RuntimeWarning)
