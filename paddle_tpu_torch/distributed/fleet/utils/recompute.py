"""Recompute (activation checkpointing), the counterpart of
``paddle_tpu/distributed/fleet/utils/recompute.py``.

The reference wraps the Layer's functional form in ``jax.checkpoint`` so
XLA rematerializes its activations in the backward. Here the wrapped call
goes through ``torch.utils.checkpoint.checkpoint`` (non-reentrant): the
forward keeps only the call's inputs, and the backward runs the call again
to rebuild what its gradient needs, kernels included (a recomputed
attention relaunches K3, a recomputed norm K1). Parameters of a wrapped
Module are reached as usual, so their gradients flow.
"""
from __future__ import annotations

from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["recompute", "recompute_sequential", "should_remat_layer"]


def should_remat_layer(config, layer_idx,
                       block_granularities=("full", "selective"),
                       allowed=("full", "selective")):
    """The block-level remat policy: validates
    ``config.recompute_granularity`` against ``allowed`` and answers
    whether layer ``layer_idx`` is wrapped in :func:`recompute`.
    "selective" remats every other layer (about half the activation
    memory for half of "full"'s recompute)."""
    gran = getattr(config, "recompute_granularity", "full")
    if config.use_recompute and gran not in allowed:
        raise ValueError(
            f"recompute_granularity must be one of {'/'.join(allowed)}, "
            f"got {gran!r}")
    if not config.use_recompute or gran not in block_granularities:
        return False
    if gran == "selective":
        return layer_idx % 2 == 0
    return True


def recompute(function, *args, **kwargs):
    """``paddle.distributed.fleet.utils.recompute(layer_or_fn, *inputs)``:
    ``function(*args, **kwargs)`` with its activations rebuilt in the
    backward. ``preserve_rng_state`` (default True) replays the random
    state for the second run; ``use_reentrant`` is taken for the
    reference's signature, and the call is always non-reentrant."""
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **kwargs)


def recompute_sequential(ctx, functions, *args, **kwargs):
    """``recompute_sequential({'segments': k}, nn.Sequential(...), x)``:
    the layers in ``segments`` consecutive chunks, each recomputed as a
    whole."""
    segments = (ctx or {}).get("segments", 1)
    layers = list(functions)
    seg = max(len(layers) // max(segments, 1), 1)
    out = args[0]
    for i in range(0, len(layers), seg):
        out = recompute(nn.Sequential(*layers[i:i + seg]), out, **kwargs)
    return out
