"""``paddle.distributed`` of the port (counterpart of
``paddle_tpu/distributed/__init__.py``).

The reference is one controller over a JAX mesh: its eager collectives
are identities on global arrays, and GSPMD inserts the real ones. The
port runs one process per rank, as PyTorch and upstream Paddle do, and
the collectives below are ``torch.distributed`` calls. The backend comes
from the device: NCCL for ``cuda`` (the default), gloo only when the
caller asks for the CPU (``device="cpu"`` or ``backend="gloo"``). There
is no fallback: a failed NCCL start raises.

Tensors are changed in place, as in Paddle; a call with ``sync_op=False``
returns a :class:`Task`. ``src`` / ``dst`` are global ranks; ``group`` is
a :class:`Group` (an axis of the hybrid mesh is one) or None for the
world.
"""
from __future__ import annotations

import atexit
import datetime
import inspect
import os
import tempfile

import torch
import torch.distributed as _dist

from .communication.group import (Group, get_group, is_initialized,
                                  new_group)

__all__ = [
    "init_parallel_env", "get_rank", "get_world_size", "get_backend",
    "ParallelEnv", "ReduceOp", "Task", "all_reduce", "reduce", "broadcast",
    "barrier", "all_gather", "all_gather_object", "broadcast_object_list",
    "scatter_object_list", "scatter", "gather", "all_to_all", "send",
    "recv", "spawn", "launch", "new_group", "get_group", "is_initialized",
    "destroy_process_group", "Group", "DataParallel", "fleet",
    "auto_parallel", "sharding", "Engine", "ProcessMesh", "shard_tensor",
    "dtensor_from_fn", "reshard", "shard_layer", "Shard", "Replicate",
    "Partial",
]


class ReduceOp:
    SUM = 0
    MAX = 1
    MIN = 2
    PROD = 3
    AVG = 4


_TORCH_OPS = {
    ReduceOp.SUM: _dist.ReduceOp.SUM, ReduceOp.MAX: _dist.ReduceOp.MAX,
    ReduceOp.MIN: _dist.ReduceOp.MIN, ReduceOp.PROD: _dist.ReduceOp.PRODUCT,
    ReduceOp.AVG: _dist.ReduceOp.AVG,
}


def _pg(group):
    """The torch process group of a :class:`Group`; None is the world."""
    return None if group is None else group.process_group


def _env_int(*names, default):
    for n in names:
        if os.environ.get(n, "") != "":
            return int(os.environ[n])
    return default


class ParallelEnv:
    """This process's place in the job: from the process group once it is
    up, from the launcher's environment before."""

    @property
    def rank(self):
        if _dist.is_initialized():
            return _dist.get_rank()
        return _env_int("PADDLE_TRAINER_ID", "RANK", default=0)

    @property
    def world_size(self):
        if _dist.is_initialized():
            return _dist.get_world_size()
        return _env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE", default=1)

    @property
    def local_rank(self):
        return _env_int("PADDLE_LOCAL_RANK", "LOCAL_RANK", default=0)

    @property
    def dev_id(self):
        return self.local_rank

    @property
    def nranks(self):
        return self.world_size

    @property
    def device_type(self):
        return os.environ.get("PADDLE_DEVICE", "cuda")

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:0")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else []


parallel_env = ParallelEnv()


def _backend_for(device, backend):
    device = device or os.environ.get("PADDLE_DEVICE") or (
        "cpu" if backend == "gloo" else "cuda")
    device = torch.device(device).type
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if backend == "nccl" and device != "cuda":
        raise ValueError("the nccl backend needs device='cuda'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "init_parallel_env: the ranks run on CUDA devices by default "
            "and none is available; pass device='cpu' (gloo) to run them "
            "on the CPU")
    return device, backend


def init_parallel_env(backend=None, device=None, timeout=None,
                      init_method=None):
    """Start this rank's process group (once; later calls return the
    environment). Rank and world size come from the launcher's
    environment (``PADDLE_TRAINER_ID`` / ``PADDLE_TRAINERS_NUM``, or
    torch's ``RANK`` / ``WORLD_SIZE``), the rendezvous from
    ``init_method``, ``PADDLE_INIT_METHOD`` (a ``file://`` store) or
    ``MASTER_ADDR`` / ``MASTER_PORT``; a one-rank job with none of them
    keeps its store in memory. ``timeout`` (seconds, default 300) bounds
    every collective's wait. The group is destroyed at the interpreter's
    exit, before its threads would be torn down unjoined."""
    if _dist.is_initialized():
        return parallel_env
    device, backend = _backend_for(device, backend)
    rank = parallel_env.rank
    world = parallel_env.world_size
    kw = {"backend": backend, "rank": rank, "world_size": world,
          "timeout": datetime.timedelta(
              seconds=300.0 if timeout is None else float(timeout))}
    init_method = init_method or os.environ.get("PADDLE_INIT_METHOD")
    if init_method:
        kw["init_method"] = init_method
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        kw["init_method"] = "env://"
    elif world == 1:
        kw["store"] = _dist.HashStore()
    else:
        raise RuntimeError(
            f"init_parallel_env: a {world}-rank job needs a rendezvous "
            "(init_method, PADDLE_INIT_METHOD or MASTER_ADDR / "
            "MASTER_PORT); start it with python -m "
            "paddle_tpu_torch.distributed.launch")
    if backend == "nccl":
        dev = torch.device("cuda", parallel_env.local_rank)
        torch.cuda.set_device(dev)
        if "device_id" in inspect.signature(
                _dist.init_process_group).parameters:
            kw["device_id"] = dev
    _dist.init_process_group(**kw)
    atexit.register(destroy_process_group)
    return parallel_env


def destroy_process_group():
    from ..parallel import mesh as mesh_state

    mesh_state.set_mesh(None)
    if _dist.is_initialized():
        _dist.destroy_process_group()


def get_rank(group=None):
    if group is not None:
        return group.rank
    return parallel_env.rank


def get_world_size(group=None):
    if group is not None:
        return group.nranks
    return parallel_env.world_size


def get_backend(group=None):
    return _dist.get_backend(_pg(group)) if _dist.is_initialized() else None


class Task:
    """The handle of an asynchronous collective (``sync_op=False``)."""

    def __init__(self, work, result=None):
        self._work = work
        self._result = result

    def wait(self):
        if self._work is not None:
            self._work.wait()
        return True

    def is_completed(self):
        return self._work is None or self._work.is_completed()


def _done(work, result, sync_op):
    if sync_op:
        if work is not None:
            work.wait()
        return result
    return Task(work, result)


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    work = _dist.all_reduce(tensor, _TORCH_OPS[op], group=_pg(group),
                            async_op=True)
    return _done(work, tensor, sync_op)


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    work = _dist.reduce(tensor, int(dst), _TORCH_OPS[op], group=_pg(group),
                        async_op=True)
    return _done(work, tensor, sync_op)


def broadcast(tensor, src=0, group=None, sync_op=True):
    work = _dist.broadcast(tensor, int(src), group=_pg(group), async_op=True)
    return _done(work, tensor, sync_op)


def barrier(group=None):
    _dist.barrier(group=_pg(group))


def all_gather(tensor_list, tensor, group=None, sync_op=True):
    """Fills ``tensor_list`` with every rank's ``tensor``, in group-rank
    order."""
    n = _dist.get_world_size(_pg(group))
    rows = [torch.empty_like(tensor) for _ in range(n)]
    work = _dist.all_gather(rows, tensor.contiguous(), group=_pg(group),
                            async_op=True)
    work.wait()
    del tensor_list[:]
    tensor_list.extend(rows)
    return _done(None, tensor_list, sync_op)


def all_gather_object(object_list, obj, group=None):
    n = _dist.get_world_size(_pg(group))
    out = [None] * n
    _dist.all_gather_object(out, obj, group=_pg(group))
    del object_list[:]
    object_list.extend(out)
    return object_list


def broadcast_object_list(object_list, src=0, group=None):
    _dist.broadcast_object_list(object_list, int(src), group=_pg(group))
    return object_list


def scatter_object_list(out_object_list, in_object_list=None, src=0,
                        group=None):
    """Each rank receives ``in_object_list[its group rank]`` from
    ``src``."""
    n = _dist.get_world_size(_pg(group))
    is_src = _dist.get_rank() == int(src)
    if is_src and len(in_object_list or []) != n:
        raise ValueError(
            f"scatter_object_list: src must pass world_size={n} objects, "
            f"got {len(in_object_list or [])}")
    got = [None]
    _dist.scatter_object_list(got, list(in_object_list) if is_src else None,
                              int(src), group=_pg(group))
    del out_object_list[:]
    out_object_list.append(got[0])
    return out_object_list


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    is_src = _dist.get_rank() == int(src)
    rows = ([t.contiguous() for t in tensor_list] if is_src else None)
    work = _dist.scatter(tensor, rows, int(src), group=_pg(group),
                         async_op=True)
    return _done(work, tensor, sync_op)


def gather(tensor, gather_list=None, dst=0, group=None, sync_op=True):
    """Every rank's ``tensor`` into ``gather_list`` on ``dst``; other
    ranks' lists are left as they are."""
    n = _dist.get_world_size(_pg(group))
    is_dst = _dist.get_rank() == int(dst)
    rows = [torch.empty_like(tensor) for _ in range(n)] if is_dst else None
    _dist.gather(tensor.contiguous(), rows, int(dst), group=_pg(group))
    if is_dst and gather_list is not None:
        del gather_list[:]
        gather_list.extend(rows)
    return _done(None, gather_list, sync_op)


def all_to_all(out_tensor_list, in_tensor_list, group=None, sync_op=True):
    """``out[p]`` becomes rank p's ``in_tensor_list[me]``. Rides
    point-to-point pairs, which both backends carry."""
    pg = _pg(group)
    ranks = (list(range(_dist.get_world_size())) if pg is None
             else _dist.get_process_group_ranks(pg))
    me = _dist.get_rank()
    if len(in_tensor_list) != len(ranks):
        raise ValueError(
            f"all_to_all: in_tensor_list must have {len(ranks)} entries, "
            f"got {len(in_tensor_list)}")
    mine = ranks.index(me)
    out = [None] * len(ranks)
    out[mine] = in_tensor_list[mine].clone()
    ops = []
    for i, r in enumerate(ranks):
        if r == me:
            continue
        out[i] = torch.empty_like(in_tensor_list[i])
        ops.append(_dist.P2POp(_dist.isend, in_tensor_list[i].contiguous(),
                               r, group=pg))
        ops.append(_dist.P2POp(_dist.irecv, out[i], r, group=pg))
    if ops:
        for w in _dist.batch_isend_irecv(ops):
            w.wait()
    del out_tensor_list[:]
    out_tensor_list.extend(out)
    return _done(None, out_tensor_list, sync_op)


def send(tensor, dst=0, group=None, sync_op=True):
    if int(dst) == _dist.get_rank():
        raise ValueError(f"send: dst {dst} is this process")
    work = _dist.isend(tensor.contiguous(), int(dst), group=_pg(group))
    return _done(work, tensor, sync_op)


def recv(tensor, src=0, group=None, sync_op=True):
    if int(src) == _dist.get_rank():
        raise ValueError(f"recv: src {src} is this process")
    work = _dist.irecv(tensor, int(src), group=_pg(group))
    return _done(work, tensor, sync_op)


def _spawn_entry(index, func, args, nprocs, init_method, device):
    os.environ.update({
        "PADDLE_TRAINER_ID": str(index), "PADDLE_LOCAL_RANK": str(index),
        "PADDLE_TRAINERS_NUM": str(nprocs), "RANK": str(index),
        "LOCAL_RANK": str(index), "WORLD_SIZE": str(nprocs),
        "PADDLE_INIT_METHOD": init_method, "PADDLE_DEVICE": device})
    func(*args)


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Start ``nprocs`` processes (default: one per CUDA device) that run
    ``func(*args)`` with the launcher's environment set, so that
    ``init_parallel_env()`` inside finds its rank and a ``file://``
    rendezvous. Option: ``device`` (``cuda`` or ``cpu``; ``backend=
    "gloo"`` means ``cpu``). ``func`` must be picklable (defined at a
    module's top)."""
    import torch.multiprocessing as mp

    device = options.get("device") or (
        "cpu" if options.get("backend") == "gloo" else "cuda")
    if nprocs == -1:
        nprocs = torch.cuda.device_count() if device == "cuda" else 1
    store_dir = tempfile.mkdtemp(prefix="paddle_tpu_torch_spawn_")
    init_method = "file://" + os.path.join(store_dir, "store")
    return mp.start_processes(
        _spawn_entry,
        args=(func, tuple(args), nprocs, init_method, device),
        nprocs=nprocs, join=join, daemon=daemon, start_method="spawn")


def launch():
    from .launch.main import main

    main()


# -- submodules --------------------------------------------------------------
from . import auto_parallel, fleet, sharding  # noqa: E402
from .auto_parallel import (Engine, Partial, ProcessMesh,  # noqa: E402
                            Replicate, Shard, dtensor_from_fn, reshard,
                            shard_layer, shard_tensor)
from .parallel import DataParallel  # noqa: E402
