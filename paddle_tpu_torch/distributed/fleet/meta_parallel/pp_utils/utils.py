"""Pipeline helpers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/pp_utils/utils.py``)."""
from __future__ import annotations

from torch import nn

__all__ = ["run_items"]


def run_items(items, x, recompute_interval=0):
    """Run a slice of pipeline items in order; tuple outputs thread
    through as positional arguments. ``items`` holds modules, plain
    callables, or ``(layer, forward_func)`` pairs (a shared layer's
    ``forward_func(layer, x)``); with ``recompute_interval`` every
    interval-th module runs under recompute."""
    from ...utils.recompute import recompute

    for i, item in enumerate(items):
        if isinstance(item, tuple):
            layer, fn = item
            x = fn(layer, *x) if isinstance(x, tuple) else fn(layer, x)
            continue
        use_rc = (recompute_interval > 0 and isinstance(item, nn.Module)
                  and i % recompute_interval == 0)
        args = x if isinstance(x, tuple) else (x,)
        x = recompute(item, *args) if use_rc else item(*args)
    return x
