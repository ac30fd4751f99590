"""MoELayer, serial (counterpart of
``paddle_tpu/incubate/distributed/models/moe/moe_layer.py``).

The experts are one stacked FFN: ``w1`` (E, d_model, ffn1_out), ``b1``,
``w2`` (E, d_hidden, d_model), ``b2``, in the reference's layout (the
carry copies them as they are), with the gate's ``gate_weight``
(d_model, E). Two dispatch modes compute the same function:

- ``einsum``: the GShard formulation over the gate's one-hot (T, E, C)
  dispatch and combine masks;
- ``grouped``: the T * k routed rows sorted by expert (stable), each
  expert's rows through its own products (a loop of ``torch.matmul``
  over the sorted segments, where the reference calls
  ``lax.ragged_dot``: a library grouped GEMM, no Pallas kernel), then
  scattered back weighted by their gate values (0 for a dropped row).

``gelu`` is the tanh form (``jax.nn.gelu``'s default, which the reference
calls); ``swiglu`` is ``silu(gate) * up``. ``l_aux`` holds the
load-balancing loss, on the autograd tape into ``gate_weight``. Expert
parallelism (``expert_axis``, the reference's shard_map schedule) needs a
device mesh and raises (ROADMAP A7).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ....._device import resolve_device
from ....._later import not_ported
from .....nn import functional as F
from .gate import SwitchGate, TopKGate
from .....nn.layer.layers import Layer

__all__ = ["MoELayer"]


class MoELayer(Layer):
    """MoE FFN block.

    Args:
        d_model: token dim.
        d_hidden: expert FFN hidden dim.
        num_experts: expert count.
        gate: "gshard" | "switch" | "top2" | a gate object.
        activation: "gelu" | "swiglu".
        dispatch_mode: "auto" (grouped when the gate has
            ``topk_assignments``) | "einsum" | "grouped".
        expert_axis: the reference's expert-parallel mesh axis; any value
            raises (ROADMAP A7).
    Built on ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``) in ``dtype`` (default f32), weights drawn from
    ``generator`` (seed 0 when omitted): Xavier-normal per expert, biases
    0.
    """

    def __init__(self, d_model, d_hidden, num_experts, gate="gshard",
                 activation="gelu", capacity_factor=2.0, expert_axis=None,
                 dispatch_mode="auto", name=None, device=None, dtype=None,
                 generator=None):
        super().__init__()
        if expert_axis is not None:
            not_ported("MoELayer expert parallelism (expert_axis over a "
                       "device mesh)", "A7")()
        if activation not in ("gelu", "swiglu"):
            raise ValueError(f"activation must be gelu|swiglu, got "
                             f"{activation!r}")
        if dispatch_mode not in ("auto", "einsum", "grouped"):
            raise ValueError(
                f"dispatch_mode must be auto|einsum|grouped, got "
                f"{dispatch_mode!r}")
        dev = resolve_device(device)
        dt = dtype or torch.float32
        self.d_model = d_model
        self.d_hidden = d_hidden
        self.num_experts = num_experts
        self.activation = activation
        if isinstance(gate, str):
            gate = {"gshard": TopKGate(2, capacity_factor),
                    "switch": SwitchGate(capacity_factor),
                    "top2": TopKGate(2, capacity_factor)}[gate]
        self.gate = gate
        self.l_aux = None
        self.expert_axis = None
        if dispatch_mode == "auto":
            dispatch_mode = ("grouped" if hasattr(gate, "topk_assignments")
                             else "einsum")
        self.dispatch_mode = dispatch_mode
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)

        def xavier(*shape):
            std = math.sqrt(2.0 / (shape[-2] + shape[-1]))
            return nn.Parameter(torch.empty(shape, device=dev, dtype=dt)
                                .normal_(0.0, std, generator=generator))

        ffn1_out = 2 * d_hidden if activation == "swiglu" else d_hidden
        self.gate_weight = xavier(d_model, num_experts)
        self.w1 = xavier(num_experts, d_model, ffn1_out)
        self.b1 = nn.Parameter(torch.zeros(num_experts, ffn1_out,
                                           device=dev, dtype=dt))
        self.w2 = xavier(num_experts, d_hidden, d_model)
        self.b2 = nn.Parameter(torch.zeros(num_experts, d_model, device=dev,
                                           dtype=dt))

    def _act(self, h):
        if self.activation == "swiglu":
            g, u = h.chunk(2, dim=-1)
            return F.silu(g.float()).to(u.dtype) * u
        return F.gelu(h.float(), approximate=True).to(h.dtype)

    def forward(self, x):
        """x (..., d_model) -> the same shape; ``self.l_aux`` holds the
        aux loss."""
        lead = x.shape[:-1]
        xt = x.reshape(-1, self.d_model)
        logits = xt.float() @ self.gate_weight.float()
        if self.dispatch_mode == "grouped":
            y = self._grouped(xt, logits)
        else:
            y = self._einsum(xt, logits)
        return y.reshape(*lead, self.d_model)

    def _einsum(self, xt, logits):
        dt = xt.dtype
        dispatch, combine, _ = self.gate(logits)
        self.l_aux = self.gate.l_aux
        disp = torch.einsum("tec,tm->ecm", dispatch.to(dt), xt)
        h = torch.einsum("ecm,emh->ech", disp, self.w1.to(dt))
        h = self._act(h + self.b1[:, None, :].to(dt))
        out = torch.einsum("ech,ehm->ecm", h, self.w2.to(dt))
        out = out + self.b2[:, None, :].to(dt)
        return torch.einsum("tec,ecm->tm", combine.to(dt), out)

    def _grouped(self, xt, logits):
        dt = xt.dtype
        t, e = xt.shape[0], self.num_experts
        topi, gate_vals, self.l_aux = self.gate.topk_assignments(logits)
        k = topi.shape[1]
        expert_flat = topi.reshape(-1)
        order = torch.argsort(expert_flat, stable=True)
        sorted_tok = torch.arange(t, device=xt.device).repeat_interleave(
            k)[order]
        sorted_gv = gate_vals.reshape(-1)[order].to(dt)
        sizes = torch.bincount(expert_flat, minlength=e).tolist()
        xs = xt[sorted_tok]
        w1, b1 = self.w1.to(dt), self.b1.to(dt)
        w2, b2 = self.w2.to(dt), self.b2.to(dt)
        # each expert's bias is added to its own segment (the reference
        # gathers one bias row per routed row): the same sums, and the
        # bias gradients are reductions, not bf16 scatter-adds
        h = torch.cat([seg @ w1[g] + b1[g] for g, seg in
                       enumerate(torch.split(xs, sizes))])
        h = self._act(h)
        out = torch.cat([seg @ w2[g] + b2[g] for g, seg in
                         enumerate(torch.split(h, sizes))])
        y = torch.zeros((t, self.d_model), dtype=dt, device=xt.device)
        return y.index_add(0, sorted_tok, out * sorted_gv[:, None])
