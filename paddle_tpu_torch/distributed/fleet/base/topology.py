"""The hybrid topology (counterpart of
``paddle_tpu/distributed/fleet/base/topology.py``).

``CommunicateTopology`` is the reference's N-D rank grid, ranks in the
order ``("data", "pipe", "sharding", "sep", "model")`` with ``model``
innermost. ``HybridCommunicateGroup`` builds, for every axis, one
``torch.distributed`` group per rank list of that axis, and installs the
hybrid group map (``paddle_tpu_torch.parallel.mesh``) with this rank's
group on each axis. ``new_group`` is collective over the world, so every
rank creates every axis' every group, in one order: the axes in the
topology's order, each axis' lists in ``get_comm_list``'s order.
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from ....parallel import mesh as mesh_state
from ...communication.group import new_group
from .distributed_strategy import DistributedStrategy

__all__ = ["CommunicateTopology", "HybridCommunicateGroup",
           "get_hybrid_communicate_group"]

_HCG = None

# topology axis name -> hybrid mesh axis name
_AXIS = {"data": "dp", "pipe": "pp", "sharding": "sharding", "sep": "sep",
         "model": "mp"}
_NAME = {v: k for k, v in _AXIS.items()}


def _set_hcg(hcg):
    global _HCG
    _HCG = hcg


def get_hybrid_communicate_group():
    return _HCG


class CommunicateTopology:
    def __init__(self, hybrid_group_names=("data", "pipe", "sharding", "sep",
                                           "model"),
                 dims=(1, 1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self._world_size = int(np.prod(self._dims))
        self._coords = np.arange(self._world_size).reshape(self._dims)

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return self._world_size

    def get_rank(self, **kwargs):
        coord = tuple(kwargs[name] for name in self._parallel_names)
        return int(self._coords[coord])

    def get_coord(self, rank):
        idx = np.argwhere(self._coords == rank)[0]
        return dict(zip(self._parallel_names, (int(i) for i in idx)))

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        sl = [slice(None)] * len(self._dims)
        sl[axis] = index
        return [int(r) for r in self._coords[tuple(sl)].reshape(-1)]

    def get_comm_list(self, axis_name):
        """Rank lists along ``axis_name`` (or several names: ranks that
        share every other coordinate), each in grid order."""
        names = ([axis_name] if isinstance(axis_name, str)
                 else list(axis_name))
        axes = [self._parallel_names.index(n) for n in names]
        size = int(np.prod([self._dims[a] for a in axes]))
        moved = np.moveaxis(self._coords, axes,
                            list(range(-len(axes), 0))).reshape(-1, size)
        return [list(map(int, row)) for row in moved]


class HybridCommunicateGroup:
    """The rank grid of a strategy's degrees over the running job
    (``init_parallel_env`` first). As in the reference, ``dp`` grows to
    take the ranks the other degrees leave (their product must divide the
    world size)."""

    def __init__(self, strategy: DistributedStrategy | None = None,
                 topology: CommunicateTopology | None = None):
        if not dist.is_initialized():
            raise RuntimeError(
                "HybridCommunicateGroup needs init_parallel_env() first")
        strategy = strategy or DistributedStrategy()
        hc = strategy.hybrid_configs
        self._dp_degree = int(hc["dp_degree"])
        self._mp_degree = int(hc["mp_degree"])
        self._pp_degree = int(hc["pp_degree"])
        self._sharding_degree = int(hc["sharding_degree"])
        self._sep_degree = int(hc.get("sep_degree", 1))
        world = dist.get_world_size()
        need = (self._dp_degree * self._mp_degree * self._pp_degree
                * self._sharding_degree * self._sep_degree)
        if need > world or world % need:
            raise ValueError(
                f"hybrid degrees need {need} ranks, which does not divide "
                f"the world of {world}; adjust the degrees")
        self._dp_degree *= world // need
        self._topo = topology or CommunicateTopology(
            ("data", "pipe", "sharding", "sep", "model"),
            (self._dp_degree, self._pp_degree, self._sharding_degree,
             self._sep_degree, self._mp_degree))
        self.global_rank = dist.get_rank()
        self._coord = self._topo.get_coord(self.global_rank)
        self._groups = {}
        for name in self._topo.get_hybrid_group_names():
            self._groups[_AXIS[name]] = self._build(name)
        self._fused = {}
        mesh_state.set_mesh(mesh_state.HybridMesh(
            self._groups, fused=self.get_fused_group))
        _set_hcg(self)

    def _build(self, names):
        mine = None
        for ranks in self._topo.get_comm_list(names):
            g = new_group(ranks)
            if self.global_rank in ranks:
                mine = g
        return mine

    def get_fused_group(self, axes):
        """The group over several mesh axes at once (``("dp",
        "sharding")``: the ranks that differ only there), as an
        ``Group``. Collective the first time for a set of axes: every
        rank asks for it, in the same order."""
        axes = tuple(axes)
        if axes not in self._fused:
            self._fused[axes] = self._build([_NAME[a] for a in axes])
        return self._fused[axes]

    @property
    def topology(self):
        return self._topo

    @property
    def num_stages(self):
        return self._pp_degree

    # -- degree accessors (reference API) ------------------------------------
    def get_data_parallel_world_size(self):
        return self._dp_degree

    def get_model_parallel_world_size(self):
        return self._mp_degree

    def get_pipe_parallel_world_size(self):
        return self._pp_degree

    def get_sharding_parallel_world_size(self):
        return self._sharding_degree

    def get_sep_parallel_world_size(self):
        return self._sep_degree

    def get_data_parallel_rank(self):
        return self._coord["data"]

    def get_model_parallel_rank(self):
        return self._coord["model"]

    def get_stage_id(self):
        return self._coord["pipe"]

    def get_sharding_parallel_rank(self):
        return self._coord["sharding"]

    def get_sep_parallel_rank(self):
        return self._coord["sep"]

    def get_data_parallel_group(self):
        return self._groups["dp"]

    def get_model_parallel_group(self):
        return self._groups["mp"]

    def get_pipe_parallel_group(self):
        return self._groups["pp"]

    def get_sharding_parallel_group(self):
        return self._groups["sharding"]

    def get_sep_parallel_group(self):
        return self._groups["sep"]

    def get_check_parallel_group(self, *a, **k):
        return None  # the world

    def get_data_parallel_group_src_rank(self):
        return self._groups["dp"].ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].ranks[0]

    def get_rank_from_stage(self, stage_id, **kwargs):
        """The global rank of pipeline stage ``stage_id`` at this rank's
        other coordinates (``kwargs`` overrides them)."""
        coord = dict(self._coord, pipe=int(stage_id), **kwargs)
        return self._topo.get_rank(**coord)

    def is_first_stage(self):
        return self._coord["pipe"] == 0

    def is_last_stage(self):
        return self._coord["pipe"] == self._pp_degree - 1
