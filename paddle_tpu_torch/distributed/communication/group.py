"""Communication groups (counterpart of
``paddle_tpu/distributed/communication/group.py``). A ``Group`` wraps a
``torch.distributed`` process group with the global ranks it holds
(sorted: a rank's group rank is its position), ``nranks`` and this
process's ``rank`` inside it (-1 outside it)."""
from __future__ import annotations

import torch.distributed as dist

__all__ = ["Group", "new_group", "get_group", "is_initialized",
           "all_gather_into", "reduce_scatter_into"]

# the newer names where torch has them (torch 2.13 warns at the older)
all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
reduce_scatter_into = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

_GROUP_COUNTER = [0]
_GROUPS: dict[int, "Group"] = {}


class Group:
    def __init__(self, rank, ranks, id=0, pg=None, name=None):
        self.rank = rank  # this process's rank inside the group
        self.ranks = list(ranks)
        self.id = id
        self.process_group = pg
        self._name = name or f"group_{id}"

    @property
    def nranks(self):
        return len(self.ranks)

    @property
    def world_size(self):
        return self.nranks

    @property
    def name(self):
        return self._name

    def get_group_rank(self, rank):
        return self.ranks.index(rank) if rank in self.ranks else -1

    def is_member(self):
        return self.rank >= 0

    def __repr__(self):
        return f"Group(id={self.id}, ranks={self.ranks})"


def new_group(ranks=None, backend=None, timeout=None):
    """A group over ``ranks`` (every rank of the world by default).
    Collective over the whole world, as ``torch.distributed.new_group``:
    every process calls it, for every group, in the same order."""
    if not dist.is_initialized():
        raise RuntimeError(
            "new_group needs init_parallel_env() (or fleet.init) first")
    world = dist.get_world_size()
    ranks = sorted(int(r) for r in (range(world) if ranks is None
                                    else ranks))
    kw = {} if timeout is None else {"timeout": timeout}
    pg = dist.new_group(ranks, backend=backend, **kw)
    _GROUP_COUNTER[0] += 1
    gid = _GROUP_COUNTER[0]
    me = dist.get_rank()
    grp = Group(ranks.index(me) if me in ranks else -1, ranks, gid, pg)
    _GROUPS[gid] = grp
    return grp


def get_group(gid=0):
    return _GROUPS.get(gid)


def is_initialized():
    return dist.is_initialized()

