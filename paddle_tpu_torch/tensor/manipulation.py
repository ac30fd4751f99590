"""Shape and layout ops (the reference's
``paddle_tpu/tensor/manipulation.py``) on torch, with paddle's signatures
and semantics (``reshape``'s 0 copies an input dim, ``split``'s -1,
``scatter``'s ``overwrite=False``, full-rank and spatial ``pad``)."""
from __future__ import annotations

import builtins

import numpy as np
import torch
import torch.nn.functional as _F

from ._helpers import (apply, axes_arg, ensure_tensor, shape_arg,
                       to_torch_dtype)

__all__ = [
    "reshape", "reshape_", "transpose", "squeeze", "squeeze_", "unsqueeze",
    "unsqueeze_", "concat", "stack", "split", "chunk", "flatten", "flip",
    "roll", "tile", "expand", "expand_as", "broadcast_to",
    "broadcast_tensors", "gather", "gather_nd", "scatter", "scatter_",
    "scatter_nd", "scatter_nd_add", "index_select", "index_sample",
    "index_add", "index_put", "masked_select", "masked_fill",
    "take_along_axis", "put_along_axis", "unbind", "repeat_interleave",
    "cast", "slice", "strided_slice", "unique", "unique_consecutive",
    "rot90", "as_complex", "as_real", "moveaxis", "unstack", "unfold",
    "view", "view_as", "atleast_1d", "atleast_2d", "atleast_3d", "diagonal",
    "crop", "pad", "hstack", "permute", "tensor_split", "select_scatter",
    "shard_index", "slice_scatter", "as_strided", "diagonal_scatter",
    "column_stack", "row_stack", "cartesian_prod", "block_diag",
]



def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def reshape(x, shape, name=None):
    x = ensure_tensor(x)
    shp = tuple(x.shape[i] if s == 0 and i < x.ndim else s
                for i, s in enumerate(shape_arg(shape)))
    return apply(torch.reshape, x, shp, op_name="reshape")


def reshape_(x, shape, name=None):
    x = ensure_tensor(x)
    shp = tuple(x.shape[i] if s == 0 and i < x.ndim else s
                for i, s in enumerate(shape_arg(shape)))
    return x.set_(x.reshape(shp).contiguous())


def transpose(x, perm, name=None):
    return ensure_tensor(x).permute(*[int(p) for p in perm])


def moveaxis(x, source, destination, name=None):
    return torch.movedim(ensure_tensor(x), source, destination)


def squeeze(x, axis=None, name=None):
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    if ax is None:
        return torch.squeeze(x)
    axes = (ax,) if isinstance(ax, int) else ax
    axes = tuple(a for a in axes if x.shape[a] == 1)
    return torch.squeeze(x, axes) if axes else x


def squeeze_(x, axis=None, name=None):
    return x.set_(squeeze(x, axis).contiguous())


def unsqueeze(x, axis, name=None):
    x = ensure_tensor(x)
    ax = axes_arg(axis)
    axes = (ax,) if isinstance(ax, int) else ax
    out_nd = x.ndim + len(axes)
    for a in sorted(a % out_nd for a in axes):
        x = x.unsqueeze(a)
    return x


def unsqueeze_(x, axis, name=None):
    return x.set_(unsqueeze(x, axis).contiguous())


def concat(x, axis=0, name=None):
    ts = [ensure_tensor(t) for t in x]
    return torch.cat(ts, dim=_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack([ensure_tensor(t) for t in x], dim=int(axis))


def split(x, num_or_sections, axis=0, name=None):
    x = ensure_tensor(x)
    ax = _int(axis)
    dim = x.shape[ax]
    if isinstance(num_or_sections, int):
        if dim % num_or_sections != 0:
            raise ValueError(
                f"split: dimension {dim} along axis {ax} is not divisible "
                f"by num_or_sections={num_or_sections}")
        sizes = [dim // num_or_sections] * num_or_sections
    else:
        sizes = [int(s) for s in num_or_sections]
        if -1 in sizes:
            sizes[sizes.index(-1)] = dim - builtins.sum(
                s for s in sizes if s != -1)
    return list(torch.split(x, sizes, dim=ax))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def unbind(input, axis=0):
    return list(torch.unbind(ensure_tensor(input), dim=axis))


unstack = unbind


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    x = ensure_tensor(x)
    if x.ndim == 0:
        return x.reshape(1)
    return torch.flatten(x, start_axis, stop_axis)


def flip(x, axis, name=None):
    ax = axes_arg(axis)
    return torch.flip(ensure_tensor(x), (ax,) if isinstance(ax, int) else ax)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(ensure_tensor(x), k, list(axes))


def roll(x, shifts, axis=None, name=None):
    x = ensure_tensor(x)
    sh, ax = axes_arg(shifts), axes_arg(axis)
    if ax is None:
        return torch.roll(x.reshape(-1), sh).reshape(x.shape)
    return torch.roll(x, sh, ax)


def tile(x, repeat_times, name=None):
    return torch.tile(ensure_tensor(x), shape_arg(repeat_times))


def expand(x, shape, name=None):
    x = ensure_tensor(x)
    shp = shape_arg(shape)
    shp = tuple(x.shape[i - (len(shp) - x.ndim)] if s == -1 else s
                for i, s in enumerate(shp))
    return x.expand(shp)


def expand_as(x, y, name=None):
    return expand(x, ensure_tensor(y).shape)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(ensure_tensor(x), shape_arg(shape))


def broadcast_tensors(input, name=None):
    return list(torch.broadcast_tensors(*[ensure_tensor(t) for t in input]))


def cast(x, dtype):
    return ensure_tensor(x).to(to_torch_dtype(dtype))


def gather(x, index, axis=0, name=None):
    x = ensure_tensor(x)
    idx = ensure_tensor(index, like=x).reshape(-1).long()
    return torch.index_select(x, _int(axis), idx)


def gather_nd(x, index, name=None):
    x = ensure_tensor(x)
    idx = ensure_tensor(index, like=x).long()
    return x[tuple(idx[..., i] for i in range(idx.shape[-1]))]


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates`` (of a repeated index the
    last row wins, and only it receives a gradient, as in the reference),
    or with ``overwrite=False`` zeroed and then summed into."""
    x = ensure_tensor(x)
    i = ensure_tensor(index, like=x).reshape(-1).long()
    u = ensure_tensor(updates, like=x).to(x.dtype)
    if overwrite:
        pos = torch.arange(i.numel(), device=x.device)
        last = torch.full((x.shape[0],), -1, dtype=torch.long,
                          device=x.device).scatter_reduce(0, i % x.shape[0],
                                                          pos, "amax")
        keep = last[i % x.shape[0]] == pos
        return x.index_put((i[keep],), u[keep])
    return x.index_put((i,), torch.zeros_like(u)).index_put((i,), u,
                                                            accumulate=True)


def scatter_(x, index, updates, overwrite=True, name=None):
    return x.copy_(scatter(x, index, updates, overwrite))


def scatter_nd(index, updates, shape, name=None):
    u = ensure_tensor(updates)
    i = ensure_tensor(index, like=u).long()
    zeros = torch.zeros(shape_arg(shape), dtype=u.dtype, device=u.device)
    return zeros.index_put(tuple(i[..., d] for d in range(i.shape[-1])), u,
                           accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    x = ensure_tensor(x)
    i = ensure_tensor(index, like=x).long()
    return x.index_put(tuple(i[..., d] for d in range(i.shape[-1])),
                       ensure_tensor(updates, like=x), accumulate=True)


def index_select(x, index, axis=0, name=None):
    x = ensure_tensor(x)
    return torch.index_select(x, int(axis),
                              ensure_tensor(index, like=x).reshape(-1).long())


def index_sample(x, index):
    x = ensure_tensor(x)
    return torch.gather(x, 1, ensure_tensor(index, like=x).long())


def index_add(x, index, axis, value, name=None):
    x = ensure_tensor(x)
    return torch.index_add(x, axis,
                           ensure_tensor(index, like=x).reshape(-1).long(),
                           ensure_tensor(value, like=x))


def index_put(x, indices, value, accumulate=False, name=None):
    x = ensure_tensor(x)
    idx = tuple(ensure_tensor(i, like=x) for i in indices)
    idx = tuple(i if i.dtype == torch.bool else i.long() for i in idx)
    return x.index_put(idx, ensure_tensor(value, like=x).to(x.dtype),
                       accumulate=accumulate)


def masked_select(x, mask, name=None):
    x = ensure_tensor(x)
    return torch.masked_select(x, ensure_tensor(mask, like=x))


def masked_fill(x, mask, value, name=None):
    x = ensure_tensor(x)
    m = ensure_tensor(mask, like=x)
    if isinstance(value, torch.Tensor):
        return torch.where(m, value.to(x.dtype), x)
    return x.masked_fill(m, value)


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    arr = ensure_tensor(arr)
    idx = ensure_tensor(indices, like=arr).long()
    if broadcast:
        shape = [builtins.max(a, b) if d != axis % arr.ndim else b
                 for d, (a, b) in enumerate(zip(arr.shape, idx.shape))]
        idx = idx.expand(shape)
        arr = arr.expand([s if d != axis % arr.ndim else arr.shape[d]
                          for d, s in enumerate(shape)])
    return torch.gather(arr, axis, idx)


def put_along_axis(arr, indices, values, axis, reduce="assign",
                   include_self=True, broadcast=True, name=None):
    arr = ensure_tensor(arr)
    idx = ensure_tensor(indices, like=arr).long()
    vals = ensure_tensor(values, like=arr)
    vals = torch.broadcast_to(vals.to(arr.dtype), idx.shape).contiguous()
    if reduce == "assign":
        return torch.scatter(arr, axis, idx, vals)
    mode = {"add": "sum", "multiply": "prod", "mul": "prod", "amax": "amax",
            "amin": "amin"}[reduce]
    return torch.scatter_reduce(arr, axis, idx, vals, mode,
                                include_self=include_self)


def repeat_interleave(x, repeats, axis=None, name=None):
    x = ensure_tensor(x)
    if isinstance(repeats, torch.Tensor):
        return torch.repeat_interleave(x, repeats.to(x.device), dim=axis)
    return torch.repeat_interleave(x, int(repeats), dim=axis)


def slice(input, axes, starts, ends):
    x = ensure_tensor(input)
    sl = [builtins.slice(None)] * x.ndim
    for ax, st, en in zip(axes, starts, ends):
        sl[int(ax)] = builtins.slice(_int(st), _int(en))
    return x[tuple(sl)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing per axis; a negative stride gathers (torch's slices
    take no negative step)."""
    x = ensure_tensor(x)
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        ax, sl = int(ax), builtins.slice(int(st), int(en), int(sd))
        if int(sd) > 0:
            x = x[(builtins.slice(None),) * (ax % x.ndim) + (sl,)]
        else:
            picked = list(range(x.shape[ax]))[sl]
            x = torch.index_select(x, ax, torch.tensor(
                picked, dtype=torch.long, device=x.device))
    return x


def _unique_out(vals, extra, dtype):
    dt = to_torch_dtype(dtype)
    outs = [vals] + [e.to(dt) for e in extra]
    return outs[0] if len(outs) == 1 else tuple(outs)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    vals, inv, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True, dim=axis)
    extra = []
    if return_index:
        inv_flat = inv.reshape(-1)
        first = torch.full((vals.shape[0] if axis is not None
                            else vals.numel(),), inv_flat.numel(),
                           dtype=torch.long, device=x.device)
        first = first.scatter_reduce(
            0, inv_flat, torch.arange(inv_flat.numel(), device=x.device),
            "amin")
        extra.append(first)
    if return_inverse:
        extra.append(inv)
    if return_counts:
        extra.append(counts)
    return _unique_out(vals, extra, dtype)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    x = ensure_tensor(x)
    vals, inv, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    extra = []
    if return_inverse:
        extra.append(inv.reshape(-1) if axis is None else inv)
    if return_counts:
        extra.append(counts)
    return _unique_out(vals, extra, dtype)


def as_complex(x, name=None):
    x = ensure_tensor(x)
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    x = ensure_tensor(x)
    return torch.stack([x.real, x.imag], dim=-1)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return ensure_tensor(x).to(to_torch_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return reshape(x, ensure_tensor(other).shape)


def _atleast(fn):
    def op(*inputs, name=None):
        outs = [fn(ensure_tensor(t)) for t in inputs]
        return outs[0] if len(outs) == 1 else outs

    return op


atleast_1d = _atleast(torch.atleast_1d)
atleast_2d = _atleast(torch.atleast_2d)


def _atleast_3d(v):
    # numpy's rule: (N,) -> (1, N, 1), (M, N) -> (M, N, 1)
    if v.ndim == 0:
        return v.reshape(1, 1, 1)
    if v.ndim == 1:
        return v.reshape(1, -1, 1)
    if v.ndim == 2:
        return v.unsqueeze(-1)
    return v


atleast_3d = _atleast(_atleast_3d)


def diagonal(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(ensure_tensor(x), offset, axis1, axis2)


def crop(x, shape=None, offsets=None, name=None):
    x = ensure_tensor(x)
    shp = shape_arg(shape)
    offs = [0] * x.ndim if offsets is None else [int(o) for o in offsets]
    shp = tuple(x.shape[i] - offs[i] if s == -1 else s
                for i, s in enumerate(shp))
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """paddle.nn.functional.pad's layout rule at tensor level: ``pad`` of
    2 * ndim entries pads every dim in order (before, after); a shorter
    one pads the spatial dims of ``data_format``."""
    x = ensure_tensor(x)
    if isinstance(pad, torch.Tensor):
        pad = pad.tolist()
    pad = [int(p) for p in pad]
    nd = x.ndim
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_spatial = len(pad) // 2
        widths = [(0, 0)] * nd
        dims = (list(range(1, 1 + n_spatial)) if data_format.endswith("C")
                else list(range(nd - n_spatial, nd)))
        for i, d in enumerate(dims):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    if mode == "constant":
        flat = [w for pair in reversed(widths) for w in pair]
        return _F.pad(x, flat, mode="constant", value=value)
    tmode = {"reflect": "reflect", "replicate": "replicate",
             "circular": "circular"}[mode]
    # torch pads the trailing dims of a batched input: move the padded
    # dims last, pad, move back
    dims = [d for d, w in enumerate(widths) if w != (0, 0)]
    rest = [d for d in range(nd) if d not in dims]
    v = x.permute(*rest, *dims)
    lead = v.shape[:len(rest)]
    v = v.reshape((1, -1) + tuple(v.shape[len(rest):]))
    flat = [w for d in reversed(dims) for w in widths[d]]
    v = _F.pad(v, flat, mode=tmode)
    v = v.reshape(tuple(lead) + tuple(v.shape[2:]))
    inv = np.argsort(rest + dims).tolist()
    return v.permute(*inv)


def paddings4(paddings):
    """paddle's im2col paddings (an int, [h, w] or [top, left, bottom,
    right]) as (top, bottom, left, right)."""
    if isinstance(paddings, int):
        return (paddings,) * 4
    if len(paddings) == 2:
        return (paddings[0], paddings[0], paddings[1], paddings[1])
    top, left, bottom, right = paddings
    return (top, bottom, left, right)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: NCHW -> (N, C * kh * kw, L)."""
    x = ensure_tensor(x)
    pads = paddings4(paddings)
    if pads[0] == pads[1] and pads[2] == pads[3]:
        return _F.unfold(x, kernel_sizes, dilation=dilations,
                         padding=(pads[0], pads[2]), stride=strides)
    x = _F.pad(x, (pads[2], pads[3], pads[0], pads[1]))
    return _F.unfold(x, kernel_sizes, dilation=dilations, padding=0,
                     stride=strides)


def hstack(x, name=None):
    return torch.hstack([ensure_tensor(t) for t in x])


def permute(x, *perm, name=None):
    if len(perm) == 1 and isinstance(perm[0], (list, tuple)):
        perm = perm[0]
    return transpose(x, list(perm))


def tensor_split(x, num_or_indices, axis=0, name=None):
    x = ensure_tensor(x)
    arg = (num_or_indices if isinstance(num_or_indices, int)
           else list(num_or_indices))
    return list(torch.tensor_split(x, arg, dim=axis))


def select_scatter(x, values, axis, index, name=None):
    x = ensure_tensor(x)
    return torch.select_scatter(x, ensure_tensor(values, like=x).to(x.dtype),
                                axis, index)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    """Global ids -> ids local to shard ``shard_id`` (others become
    ``ignore_value``)."""
    if not 0 <= shard_id < nshards:
        raise ValueError(
            f"shard_id {shard_id} out of range for nshards {nshards}")
    v = ensure_tensor(input)
    size = (index_num + nshards - 1) // nshards
    lo = size * shard_id
    inside = (v >= lo) & (v < lo + size)
    return torch.where(inside, v - lo,
                       torch.full_like(v, ignore_value)).to(v.dtype)


def slice_scatter(x, value, axes, starts, ends, strides=None, name=None):
    x = ensure_tensor(x)
    value = ensure_tensor(value, like=x)
    strides = strides or [1] * len(axes)
    if not (len(axes) == len(starts) == len(ends) == len(strides)):
        raise ValueError(
            f"slice_scatter: axes/starts/ends/strides lengths differ: "
            f"{len(axes)}/{len(starts)}/{len(ends)}/{len(strides)}")
    idx = [builtins.slice(None)] * x.ndim
    for ax, st, en, sd in zip(axes, starts, ends, strides):
        idx[int(ax)] = builtins.slice(int(st), int(en), int(sd))
    out = x.clone()
    out[tuple(idx)] = value.to(x.dtype)
    return out


def as_strided(x, shape, stride, offset=0, name=None):
    """An element-stride view over the flattened tensor, materialized (the
    reference's arithmetic: offsets into the flat buffer)."""
    x = ensure_tensor(x)
    flat = x.reshape(-1)
    idx = torch.full([int(s) for s in shape], int(offset), dtype=torch.long,
                     device=x.device)
    for d, (sz, sd) in enumerate(zip(shape, stride)):
        br = [1] * len(shape)
        br[d] = int(sz)
        idx = idx + (torch.arange(int(sz), device=x.device)
                     * int(sd)).reshape(br)
    return flat[idx]


def diagonal_scatter(x, y, offset=0, axis1=0, axis2=1, name=None):
    x = ensure_tensor(x)
    return torch.diagonal_scatter(x, ensure_tensor(y, like=x).to(x.dtype),
                                  offset, axis1, axis2)


def column_stack(x, name=None):
    return torch.column_stack([ensure_tensor(t) for t in x])


def row_stack(x, name=None):
    return torch.vstack([ensure_tensor(t) for t in x])


def cartesian_prod(x, name=None):
    ts = [ensure_tensor(t) for t in x]
    if len(ts) == 1:
        return ts[0]
    return torch.cartesian_prod(*ts)


def block_diag(inputs, name=None):
    ts = [ensure_tensor(t) for t in inputs]
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return torch.block_diag(*[torch.atleast_2d(t).to(dt) for t in ts])
