"""Group sharding, ZeRO stages 1-3 (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/sharding/group_sharded.py``).

The reference places arrays over the ``sharding`` mesh axis and lets XLA
insert the collectives. Here they are written out over the ``sharding``
group (``group=`` or the installed mesh's axis), n ranks:

- stage 1 (``os``): each rank keeps the optimizer state of its 1/n of
  every parameter (the flat parameter padded to a multiple of n, rank r's
  chunk r), averages the gradient over the group (all-reduce), updates
  its chunk with the optimizer's own rule, then all-gathers the
  parameter;
- stage 2 (``os_g``): the same, the gradient reduce-scattered (averaged)
  instead, so a rank only ever holds its chunk of the reduced gradient;
- stage 3 (``p_g_os``): the parameters themselves stay 1/n between
  steps. A module's parameters are gathered by a forward pre-hook, one
  unit at a time (each child of a ``ModuleList`` / ``ModuleDict``, such
  as one decoder layer, is a unit; other parameters group by the module
  that owns them), and dropped after its forward. Tensors that autograd
  saves of a gathered parameter are kept as references: backward gathers
  the unit again, and reduce-scatters (averages) the gradients into the
  shards.

The update is the optimizer's own (``optimizer.apply``), run elementwise
on each rank's chunk, so a sharded step equals the serial one element by
element. With mp, a parameter is first split over mp (its slice is the
rank's parameter), then that slice over sharding. A group of one rank
still runs every collective.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch import nn

from .....parallel import mesh as mesh_state
from ....communication.group import all_gather_into as _all_gather
from ....communication.group import reduce_scatter_into as _reduce_scatter
from ...layers.mpu import mp_layers

__all__ = ["group_sharded_parallel", "save_group_sharded_model",
           "GroupShardedStage2", "GroupShardedStage3",
           "GroupShardedOptimizerStage2", "ShardedOptimizer",
           "shard_model_params_stage3", "carry_local", "full_state_dict",
           "stage3_stats"]

# optimizers whose update of an element reads other elements (a norm of
# the whole parameter): a chunk's update would differ from the serial one
_NOT_ELEMENTWISE = ("Lamb", "LarsMomentum", "LBFGS")


def _bounds(numel, n, r):
    """Chunk length (the flat parameter padded to n chunks) and rank r's
    [lo, hi) in the unpadded parameter."""
    c = -(-numel // n)
    lo = min(r * c, numel)
    return c, lo, min(lo + c, numel)


def _sharding_group(group, axis="sharding"):
    g = group if group is not None else mesh_state.axis_group(axis)
    if g is None:
        raise RuntimeError(
            "group sharding needs a sharding group: fleet.init(...) first, "
            "or pass group=")
    return g


class ShardedOptimizer:
    """Stage 1 / 2 over ``optimizer`` (and the update of stage-3 shards,
    whose gradients arrive reduced). Presents the optimizer's interface
    (``step``, ``apply``, ``new_state``, ``get_lr``, ``state_dict``, ...);
    its states are those of this rank's chunks. ``group`` defaults to the
    mesh's ``axis``; ``_grad_synced_axes`` names that axis, whose
    gradients the update averages."""

    def __init__(self, optimizer, stage=1, group=None, axis="sharding"):
        if isinstance(optimizer, ShardedOptimizer):
            optimizer = optimizer._inner
        if type(optimizer).__name__ in _NOT_ELEMENTWISE:
            raise NotImplementedError(
                f"{type(optimizer).__name__} reads whole parameters; its "
                "sharded update is not ported yet (ROADMAP A7)")
        if optimizer._grad_clip is not None:
            raise NotImplementedError(
                "gradient clipping under group sharding needs a norm over "
                "the group; not ported yet (ROADMAP A7)")
        object.__setattr__(self, "_inner", optimizer)
        object.__setattr__(self, "_stage", int(stage))
        object.__setattr__(self, "_group", _sharding_group(group, axis))
        object.__setattr__(self, "_grad_synced_axes", (axis,))

    def __getattr__(self, name):
        return getattr(self.__dict__["_inner"], name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)

    def _chunk(self, p):
        """This rank's chunk of ``p``, a flat view that writes through
        (the whole of a stage-3 shard)."""
        if getattr(p, "_stage3", None) is not None:
            return p.detach()
        _, lo, hi = _bounds(p.numel(), self._group.nranks, self._group.rank)
        return p.detach().view(-1)[lo:hi]

    def new_state(self, p):
        return self._inner.new_state(self._chunk(p))

    def _state_for(self, p):
        states = self._inner._states
        if id(p) not in states:
            states[id(p)] = self.new_state(p)
        return states[id(p)]

    def _reduced_chunk(self, p, g):
        if getattr(p, "_stage3", None) is not None:
            return g
        n, r = self._group.nranks, self._group.rank
        c, lo, hi = _bounds(p.numel(), n, r)
        flat = g.reshape(-1)
        if self._stage == 1:
            flat = flat.clone()
            dist.all_reduce(flat, op=dist.ReduceOp.AVG,
                            group=self._group.process_group)
            return flat[lo:hi]
        buf = torch.zeros(n * c, dtype=flat.dtype, device=flat.device)
        buf[:flat.numel()] = flat
        out = torch.empty(c, dtype=flat.dtype, device=flat.device)
        _reduce_scatter(out, buf, op=dist.ReduceOp.AVG,
                        group=self._group.process_group)
        return out[:hi - lo]

    def _gather(self, p):
        if getattr(p, "_stage3", None) is not None:
            return
        n, r = self._group.nranks, self._group.rank
        c, lo, hi = _bounds(p.numel(), n, r)
        flat = p.detach().view(-1)
        mine = torch.zeros(c, dtype=flat.dtype, device=flat.device)
        mine[:hi - lo] = flat[lo:hi]
        out = torch.empty(n * c, dtype=flat.dtype, device=flat.device)
        _all_gather(out, mine, group=self._group.process_group)
        flat.copy_(out[:flat.numel()])

    @torch.no_grad()
    def apply(self, params, grads, states, lr, step, decay_flags):
        """The optimizer's ``apply`` on this rank's chunks: reduce the
        gradients over the group, update the chunks, gather the
        parameters."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        chunks = [self._chunk(p) for p in params]
        reduced = [self._reduced_chunk(p, g) for p, g in zip(params, grads)]
        self._inner.apply(chunks, reduced, states, lr, step, decay_flags)
        for p in params:
            self._gather(p)

    def step(self):
        inner = self._inner
        live = [(n, p) for n, p in inner._named
                if p.requires_grad and p.grad is not None]
        if not live:
            return
        params = [p for _, p in live]
        self.apply(params, [p.grad for p in params],
                   [self._state_for(p) for p in params], inner.get_lr(),
                   inner._step_count + 1,
                   [inner._decay_enabled(n, p) for n, p in live])
        inner._step_count += 1

    def set_state_dict(self, state_dict):
        for _, p in self._inner._named:
            self._state_for(p)
        return self._inner.set_state_dict(state_dict)


# -- stage 3 -----------------------------------------------------------------
_LIVE = {}  # storage address of a gathered parameter -> (unit, index)
_STATS = {"live": 0, "peak": 0, "gathers": 0}


def stage3_stats(reset=False):
    """``live`` units gathered now, the ``peak`` of that count and the
    number of ``gathers`` (forward and backward) since the last reset."""
    out = dict(_STATS)
    if reset:
        _STATS.update(peak=_STATS["live"], gathers=0)
    return out


class _Packed:
    """A saved tensor of a gathered parameter, kept as where it lies."""

    __slots__ = ("unit", "index", "size", "stride", "offset")

    def __init__(self, unit, index, t):
        self.unit, self.index = unit, index
        self.size, self.stride = t.size(), t.stride()
        self.offset = t.storage_offset()


def _pack(t):
    if t.numel() == 0 or t.layout != torch.strided:
        return t
    hit = _LIVE.get(t.untyped_storage().data_ptr())
    return t if hit is None else _Packed(hit[0], hit[1], t)


def _unpack(x):
    if isinstance(x, _Packed):
        full = x.unit.regathered()[x.index]
        return full.as_strided(x.size, x.stride, x.offset)
    return x


class _Entry:
    __slots__ = ("owner", "name", "shape", "numel", "chunk")

    def __init__(self, owner, name, shape, numel, chunk):
        self.owner, self.name = owner, name
        self.shape, self.numel, self.chunk = shape, numel, chunk


class _Unit:
    """The parameters one forward pre-hook gathers."""

    def __init__(self, group):
        self.group = group
        self.entries = []
        self._regathered = None
        self._saved_hooks = None

    def shards(self):
        return [e.owner._parameters[e.name] for e in self.entries]

    def gather(self, shards):
        n = self.group.nranks
        total = sum(e.chunk for e in self.entries)
        send = torch.cat([s.detach() for s in shards])
        out = torch.empty(n * total, dtype=send.dtype, device=send.device)
        _all_gather(out, send, group=self.group.process_group)
        rows = out.view(n, total)
        fulls, off = [], 0
        for e in self.entries:
            piece = torch.empty((n, e.chunk), dtype=out.dtype,
                                device=out.device)
            piece.copy_(rows[:, off:off + e.chunk])
            fulls.append(piece.view(-1)[:e.numel].view(e.shape))
            off += e.chunk
        _STATS["gathers"] += 1
        return fulls

    def regathered(self):
        if self._regathered is None:
            self._regathered = self.gather(self.shards())
        return self._regathered

    def reduce_scatter(self, grads, like):
        n = self.group.nranks
        total = sum(e.chunk for e in self.entries)
        buf = torch.zeros((n, total), dtype=like.dtype, device=like.device)
        off = 0
        for e, g in zip(self.entries, grads):
            if g is not None:
                padded = torch.zeros(n * e.chunk, dtype=like.dtype,
                                     device=like.device)
                padded[:e.numel] = g.reshape(-1)
                buf[:, off:off + e.chunk] = padded.view(n, e.chunk)
            off += e.chunk
        out = torch.empty(total, dtype=like.dtype, device=like.device)
        _reduce_scatter(out, buf.view(-1), op=dist.ReduceOp.AVG,
                        group=self.group.process_group)
        return list(out.split([e.chunk for e in self.entries]))

    # -- hooks -------------------------------------------------------------
    def pre_forward(self, module, args):
        self._regathered = None
        fulls = _GatherUnit.apply(self, *self.shards())
        for i, (e, f) in enumerate(zip(self.entries, fulls)):
            object.__setattr__(e.owner, e.name, f)
            _LIVE[f.untyped_storage().data_ptr()] = (self, i)
        self._saved_hooks = torch.autograd.graph.saved_tensors_hooks(
            _pack, _unpack)
        self._saved_hooks.__enter__()
        _STATS["live"] += 1
        _STATS["peak"] = max(_STATS["peak"], _STATS["live"])

    def post_forward(self, module, args, output):
        if self._saved_hooks is not None:
            self._saved_hooks.__exit__(None, None, None)
            self._saved_hooks = None
        for e in self.entries:
            f = e.owner.__dict__.pop(e.name, None)
            if f is not None:
                _LIVE.pop(f.untyped_storage().data_ptr(), None)
        _STATS["live"] -= 1


class _GatherUnit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.unit = unit
        return tuple(unit.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        like = next(s for s in unit.shards())
        out = unit.reduce_scatter(grads, like)
        unit._regathered = None
        return (None, *out)


def _unit_modules(model):
    """(module, params it owns for its unit) pairs: each child of a
    ModuleList / ModuleDict with all its parameters, then every other
    module with its own direct parameters."""
    units, inside = [], set()

    def walk(m):
        if id(m) in inside:
            return
        listy = isinstance(m, (nn.ModuleList, nn.ModuleDict))
        if not listy:
            own = [(m, n, p) for n, p in m.named_parameters(recurse=False)]
            if own:
                units.append((m, own))
        for child in m.children():
            if listy:
                if id(child) in inside:
                    continue
                owned = [(sub, n, p) for sub in child.modules()
                         for n, p in sub.named_parameters(recurse=False)]
                for sub in child.modules():
                    inside.add(id(sub))
                if owned:
                    units.append((child, owned))
            else:
                walk(child)

    walk(model)
    return units


def shard_model_params_stage3(model, group=None):
    """Stage 3 over ``model`` in place: every parameter becomes this
    rank's 1/n chunk (a flat Parameter under the same name, ``is_sharded``
    set), gathered around each unit's forward; the model's
    ``_grad_synced_axes`` gains ``sharding``, over which backward averages
    the gradients. Returns the model."""
    group = _sharding_group(group)
    if getattr(getattr(model, "config", None), "use_recompute", False):
        raise NotImplementedError(
            "stage-3 sharding with recompute is not ported yet (ROADMAP A7)")
    n, r = group.nranks, group.rank
    seen = {}
    for module, owned in _unit_modules(model):
        unit = _Unit(group)
        for owner, name, p in owned:
            if id(p) in seen:
                raise NotImplementedError(
                    f"parameter {name} is shared between modules; stage-3 "
                    "sharding of shared parameters is not ported yet "
                    "(ROADMAP A7)")
            seen[id(p)] = p
            c, lo, hi = _bounds(p.numel(), n, r)
            data = torch.zeros(c, dtype=p.dtype, device=p.device)
            data[:hi - lo] = p.detach().reshape(-1)[lo:hi]
            shard = nn.Parameter(data, requires_grad=p.requires_grad)
            shard._stage3 = (tuple(p.shape), p.numel(), n, r, c)
            shard.is_sharded = True
            shard._full_shape = mp_layers.full_shape(p)
            if getattr(p, "_mp_split", None) is not None:
                shard._mp_split = p._mp_split
                shard.is_distributed = True
            owner._parameters[name] = shard
            unit.entries.append(_Entry(owner, name, tuple(p.shape),
                                       p.numel(), c))
        module.register_forward_pre_hook(unit.pre_forward)
        module.register_forward_hook(unit.post_forward, always_call=True)
    model._grad_synced_axes = tuple(
        getattr(model, "_grad_synced_axes", ())) + ("sharding",)
    return model


def carry_local(p, full):
    """This rank's part of ``full`` (the serial tensor, port layout) for
    parameter ``p``: its mp slice, then its stage-3 chunk."""
    local = mp_layers.local_of(p, full)
    meta = getattr(p, "_stage3", None)
    if meta is None:
        return local
    shape, numel, n, r, c = meta
    flat = torch.as_tensor(local).reshape(-1)
    out = torch.zeros(c, dtype=flat.dtype)
    _, lo, hi = _bounds(numel, n, r)
    out[:hi - lo] = flat[lo:hi]
    return out


def _gather_dim(t, dim, group):
    n = group.nranks
    flat = t.contiguous().view(1, -1)
    out = torch.empty((n, flat.shape[1]), dtype=t.dtype, device=t.device)
    _all_gather(out, flat, group=group.process_group)
    return torch.cat([r.view(t.shape) for r in out.unbind(0)], dim=dim)


@torch.no_grad()
def full_state_dict(model):
    """name -> the full (serial) tensor of every parameter: stage-3 chunks
    gathered over sharding, mp slices over mp. Collective: every rank
    calls it."""
    out = {}
    for name, p in model.named_parameters():
        t = p.detach()
        meta = getattr(p, "_stage3", None)
        if meta is not None:
            shape, numel, _, _, _ = meta
            t = _gather_dim(t, 0, _sharding_group(None))
            t = t[:numel].view(shape)
        split = getattr(p, "_mp_split", None)
        if split is not None and split[2] > 1:
            t = _gather_dim(t, split[0], mesh_state.axis_group("mp"))
        out[name] = t
    return out


class _ShardedModelWrapper:
    def __init__(self, layer):
        self._layers = layer

    def __getattr__(self, name):
        return getattr(self.__dict__["_layers"], name)

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)


class GroupShardedStage2(_ShardedModelWrapper):
    pass


class GroupShardedStage3(_ShardedModelWrapper):
    def __init__(self, layer, optimizer=None, group=None, sync_comm=False,
                 segment_size=2**20, **kwargs):
        super().__init__(layer)
        shard_model_params_stage3(layer, group)

    def get_all_parameters(self):
        """The full parameters (collective)."""
        return full_state_dict(self._layers)


class GroupShardedOptimizerStage2(ShardedOptimizer):
    def __init__(self, params, optim, group=None, **kwargs):
        super().__init__(optim, 2, group)


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2**23, segment_size=2**20,
                           sync_comm=False, dp_group=None,
                           exclude_layer=None):
    """``paddle.distributed.sharding.group_sharded_parallel``: level
    ``os`` (stage 1), ``os_g`` (stage 2) or ``p_g_os`` (stage 3). For
    stage 3 the optimizer must be built after this call (its parameters
    are the shards), or be given the model's parameters again: its
    parameter list is rebound here."""
    if level not in ("os", "os_g", "p_g_os"):
        raise ValueError("level must be one of os | os_g | p_g_os")
    if offload:
        raise NotImplementedError(
            "offload under group sharding is not ported (ROADMAP A7)")
    stage = {"os": 1, "os_g": 2, "p_g_os": 3}[level]
    if stage == 3:
        names = {id(p): n for n, p in model.named_parameters()}
        before = [names.get(id(p)) for _, p in optimizer._named]
        model = GroupShardedStage3(model, group=group)
        after = dict(model._layers.named_parameters())
        optimizer._named = [(optimizer._named[i][0], after[n])
                            for i, n in enumerate(before) if n in after]
    else:
        model = GroupShardedStage2(model)
    return model, ShardedOptimizer(optimizer, stage, group), scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Save the full parameters (rank 0 writes; every rank calls)."""
    from .....framework.io import save

    target = model._layers if isinstance(model, _ShardedModelWrapper) \
        else model
    state = full_state_dict(target)
    if dist.get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        save(state, os.path.join(output, "model.pdparams"))
        if optimizer is not None:
            save(optimizer.state_dict(),
                 os.path.join(output, f"model.rank{dist.get_rank()}.pdopt"))
