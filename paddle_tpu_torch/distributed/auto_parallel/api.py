"""Auto-parallel tensor API of the port (counterpart of
``paddle_tpu/distributed/auto_parallel/api.py``): the placements
``Shard`` / ``Replicate`` / ``Partial`` and ``shard_tensor``,
``dtensor_from_fn``, ``reshard`` and ``shard_layer``.

On a mesh of one process every placement is the whole tensor: the calls
record ``process_mesh`` and ``placements`` on it and return it. A mesh of
more than one process raises ``NotImplementedError`` (ROADMAP A7: the
port has no multi-rank mesh yet), so no call silently runs the one-rank
code for it.
"""
from __future__ import annotations

import torch

from .process_mesh import ProcessMesh

__all__ = ["shard_tensor", "dtensor_from_fn", "reshard", "shard_layer",
           "Shard", "Replicate", "Partial"]


class Placement:
    pass


class Shard(Placement):
    def __init__(self, dim):
        self.dim = dim

    def __repr__(self):
        return f"Shard(dim={self.dim})"


class Replicate(Placement):
    def __repr__(self):
        return "Replicate()"


class Partial(Placement):
    def __init__(self, reduce_type=None):
        self.reduce_type = reduce_type

    def __repr__(self):
        return "Partial()"


def check_one_rank(mesh, what):
    """Raise ``NotImplementedError`` naming ROADMAP A7 unless ``mesh`` is
    a ``ProcessMesh`` of one process."""
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"{what}: expected a ProcessMesh, got "
                        f"{type(mesh).__name__}")
    if len(mesh.process_ids) > 1:
        raise NotImplementedError(
            f"{what} over a mesh of {len(mesh.process_ids)} processes is "
            f"not ported yet (ROADMAP A7: the multi-process auto_parallel "
            f"mesh)")


def shard_tensor(data, mesh, placements, dtype=None, place=None,
                 stop_gradient=None):
    """``data`` (a tensor, returned itself, or anything ``torch.as_tensor``
    takes) with ``process_mesh`` and ``placements`` recorded, on a mesh of
    one process."""
    check_one_rank(mesh, "shard_tensor")
    if len(placements) != mesh.ndim:
        raise ValueError(f"shard_tensor: {len(placements)} placements for "
                         f"a mesh of {mesh.ndim} dims")
    t = data if isinstance(data, torch.Tensor) else torch.as_tensor(
        data, dtype=dtype)
    for p in placements:
        if isinstance(p, Shard) and not -t.dim() <= p.dim < t.dim():
            raise ValueError(f"shard_tensor: {p} of a {t.dim()}-d tensor")
    if not isinstance(data, torch.Tensor) and stop_gradient is False:
        t.requires_grad_(True)
    t.process_mesh = mesh
    t.placements = list(placements)
    return t


def dtensor_from_fn(fn, mesh, placements, *args, **kwargs):
    return shard_tensor(fn(*args, **kwargs), mesh, placements)


def reshard(dist_tensor, mesh, placements):
    return shard_tensor(dist_tensor, mesh, placements)


def shard_layer(layer, process_mesh, shard_fn=None, input_fn=None,
                output_fn=None):
    """Call ``shard_fn(name, sublayer, process_mesh)`` over ``layer`` and
    its sublayers (the layer itself named ``""``); returns the layer."""
    check_one_rank(process_mesh, "shard_layer")
    if shard_fn is not None:
        for name, sub in layer.named_modules():
            shard_fn(name, sub, process_mesh)
    return layer
