"""The tensor-parallel collectives (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_ops.py``), written out as
Megatron's autograd functions over the ``mp`` group, where the reference
leaves them to GSPMD:

- ``_c_identity``: identity forward, all-reduce (sum) of the gradient;
- ``_mp_allreduce``: all-reduce (sum) forward, identity backward;
- ``_c_concat``: all-gather along the last dim forward, this rank's slice
  of the gradient backward;
- ``_c_split``: this rank's slice of the last dim forward, all-gather of
  the gradient backward.

``group`` defaults to the installed mesh's ``mp`` axis; without a mesh
each is the identity (serial). A group of one rank still runs its
collective.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .....parallel import mesh as mesh_state
from ....communication.group import all_gather_into

__all__ = ["_c_identity", "_mp_allreduce", "_c_concat", "_c_split"]


def _mp(group):
    return group if group is not None else mesh_state.axis_group("mp")


def _all_reduce(x, group):
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group.process_group)
    return x


def _all_gather_last(x, group):
    n = group.nranks
    flat = x.contiguous().view(1, -1)
    out = torch.empty((n, flat.shape[1]), dtype=x.dtype, device=x.device)
    all_gather_into(out, flat, group=group.process_group)
    return torch.cat([r.view(x.shape) for r in out.unbind(0)], dim=-1)


def _my_slice(x, group):
    n = group.nranks
    return x.chunk(n, dim=-1)[group.rank].contiguous()


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Concat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_gather_last(x, group)

    @staticmethod
    def backward(ctx, g):
        return _my_slice(g, ctx.group), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _my_slice(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group), None


def _c_identity(tensor, group=None, skip_c_identity_dynamic=False):
    group = _mp(group)
    return tensor if group is None else _Identity.apply(tensor, group)


def _mp_allreduce(tensor, group=None, use_calc_stream=True,
                  use_model_parallel=True):
    group = _mp(group)
    return tensor if group is None else _AllReduce.apply(tensor, group)


def _c_concat(tensor, group=None):
    group = _mp(group)
    return tensor if group is None else _Concat.apply(tensor, group)


def _c_split(tensor, group=None):
    group = _mp(group)
    return tensor if group is None else _Split.apply(tensor, group)
