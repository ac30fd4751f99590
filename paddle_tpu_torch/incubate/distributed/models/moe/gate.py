"""MoE gates (counterpart of
``paddle_tpu/incubate/distributed/models/moe/gate.py``).

A gate maps token logits (T, E) to routing decisions with a capacity per
expert. The dense form returns one-hot dispatch and combine masks
(T, E, C) for the einsum tier; the sparse form (``topk_assignments``)
returns each token's k experts and gate values for the grouped tier.
Both queue tokens round-major (every token's r-th choice before any
token's (r+1)-th) and in token order within a round, so both drop the
same overflow tokens; the load-balancing loss (GShard eq. 4) is stored as
``l_aux``. ``torch.topk``'s order at exactly tied probabilities is not
``lax.top_k``'s (ROADMAP queue C); ``argmax`` takes the first index, as
``jnp.argmax`` does.
"""
from __future__ import annotations

import torch

__all__ = ["TopKGate", "GShardGate", "SwitchGate"]


def _capacity(num_tokens, num_experts, capacity_factor, top_k):
    cap = int(num_tokens * top_k * capacity_factor / num_experts)
    return max(cap, top_k)


def _queue(sel, pos_base, capacity):
    """One routing round: ``sel`` (T, E) one-hot f32 picks. Returns the
    (T, E) bool kept picks, each token's position in its expert's queue
    (T,) and the advanced per-expert counters."""
    pos = (torch.cumsum(sel, dim=0) - sel).to(torch.int32) + pos_base[None]
    keep = (sel > 0) & (pos < capacity)
    pos_tok = (pos * sel.to(torch.int32)).sum(dim=1)
    return keep, pos_tok, pos_base + keep.sum(dim=0).to(torch.int32)


def _aux(gates, ce_counts):
    """GShard's loss: E * sum(fraction routed * mean probability)."""
    e = gates.shape[1]
    fraction = ce_counts / ce_counts.sum().clamp_min(1.0)
    return (fraction * gates.mean(dim=0)).sum() * e


def _one_hot_dispatch(gates, top_k, capacity):
    """gates (T, E) softmax probabilities -> (dispatch (T, E, C) bool,
    combine (T, E, C) f32, aux loss)."""
    t, e = gates.shape
    dev = gates.device
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bool, device=dev)
    combine = torch.zeros((t, e, capacity), dtype=torch.float32, device=dev)
    masked = gates
    ce_counts = torch.zeros(e, dtype=torch.float32, device=dev)
    pos_base = torch.zeros(e, dtype=torch.int32, device=dev)
    slots = torch.arange(capacity, device=dev)
    for _ in range(top_k):
        idx = torch.argmax(masked, dim=1)
        sel = torch.nn.functional.one_hot(idx, e).to(torch.float32)
        ce_counts = ce_counts + sel.sum(dim=0)
        keep, pos_tok, pos_base = _queue(sel, pos_base, capacity)
        # a position past the capacity has no slot (jax.nn.one_hot's
        # all-zero row)
        posc = pos_tok[:, None] == slots[None, :]
        disp_k = keep[:, :, None] & posc[:, None, :]
        dispatch = dispatch | disp_k
        gate_val = (gates * sel).sum(dim=1)
        combine = combine + disp_k.to(torch.float32) * gate_val[:, None, None]
        masked = masked.masked_fill(sel > 0, float("-inf"))
    return dispatch, combine, _aux(gates, ce_counts)


class TopKGate:
    """Dense top-k capacity gate."""

    def __init__(self, top_k=2, capacity_factor=1.25):
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.l_aux = None

    def __call__(self, logits):
        """logits (T, E) -> (dispatch, combine, capacity)."""
        t, e = logits.shape
        cap = _capacity(t, e, self.capacity_factor, self.top_k)
        gates = torch.softmax(logits.float(), dim=-1)
        dispatch, combine, self.l_aux = _one_hot_dispatch(gates, self.top_k,
                                                          cap)
        return dispatch, combine, cap

    def topk_assignments(self, logits):
        """The same routing in sparse form: logits (T, E) -> (expert ids
        (T, k), gate values (T, k) with the capacity-dropped slots zeroed,
        aux loss)."""
        t, e = logits.shape
        cap = _capacity(t, e, self.capacity_factor, self.top_k)
        gates = torch.softmax(logits.float(), dim=-1)
        topv, topi = torch.topk(gates, self.top_k, dim=-1)
        ce_counts = torch.zeros(e, dtype=torch.float32, device=gates.device)
        pos_base = torch.zeros(e, dtype=torch.int32, device=gates.device)
        kept = []
        for r in range(self.top_k):
            sel = torch.nn.functional.one_hot(topi[:, r], e).to(torch.float32)
            ce_counts = ce_counts + sel.sum(dim=0)
            keep, _, pos_base = _queue(sel, pos_base, cap)
            kept.append(keep.any(dim=1))
        gate_vals = topv * torch.stack(kept, dim=1).to(topv.dtype)
        self.l_aux = _aux(gates, ce_counts)
        return topi, gate_vals, self.l_aux


class GShardGate(TopKGate):
    def __init__(self, capacity_factor=2.0):
        super().__init__(top_k=2, capacity_factor=capacity_factor)


class SwitchGate(TopKGate):
    def __init__(self, capacity_factor=1.25):
        super().__init__(top_k=1, capacity_factor=capacity_factor)
