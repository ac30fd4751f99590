"""``paddle.distributed.utils`` of the port (counterpart of
``paddle_tpu/distributed/utils.py``): ``global_scatter`` /
``global_gather``, the MoE token exchange, are ROADMAP A7's expert
parallelism and raise."""
from __future__ import annotations

__all__ = ["get_gpus", "global_scatter", "global_gather"]


def get_gpus(selected_gpus):
    import torch

    if selected_gpus is None:
        return list(range(torch.cuda.device_count()))
    return [int(x) for x in str(selected_gpus).split(",") if x != ""]


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    raise NotImplementedError(
        "global_scatter (MoE expert parallelism) is not ported yet "
        "(ROADMAP A7)")


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    raise NotImplementedError(
        "global_gather (MoE expert parallelism) is not ported yet "
        "(ROADMAP A7)")
