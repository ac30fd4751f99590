"""LoRA, low-rank adaptation (counterpart of ``paddle_tpu/peft/lora.py``).

``y = base(x) + (x @ A) @ B * (alpha / r)`` with the base Linear frozen:
A is (in, r), drawn N(0, 1/r), B is (r, out) and starts at zero, so the
adapted model starts equal to the base. Both are plain f32 parameters in
the reference's layout (not ``Linear``s), so the weight carry
(``nlp/convert.py``) moves a reference LoRA model's arrays as they are and
transposes only the base Linear's weight. ``merge()`` folds the delta into
the base weight in that weight's dtype; ``unmerge()`` takes it out again.

A's draws come from torch's generator (the global one, or ``generator``),
not the reference's threefry: carry A and B across to compare the two.
"""
from __future__ import annotations

import re

import torch
from torch import nn

from ..nn import functional as F
from ..nn.quant import QuantizedLinear
from ..nn.layer.layers import Layer

__all__ = [
    "LoRAConfig", "LoRALinear", "LoRAModel", "get_lora_model",
    "mark_only_lora_as_trainable", "lora_state_dict",
]


class LoRAConfig:
    """The reference's LoRAConfig fields.

    Args:
        r: rank of the update matrices.
        lora_alpha: scaling numerator (the delta is scaled by alpha / r).
        lora_dropout: dropout on the LoRA input path (training only).
        target_modules: regexes matched (``fullmatch``) against sublayer
            names, full or bare; every matching Linear is wrapped.
        trainable_bias: also leave the biases of wrapped layers trainable.
    """

    def __init__(self, r=8, lora_alpha=16, lora_dropout=0.0,
                 target_modules=(".*q_proj", ".*v_proj"),
                 trainable_bias=False):
        if r < 1:
            raise ValueError(f"LoRA rank must be >= 1, got {r}")
        self.r = int(r)
        self.lora_alpha = float(lora_alpha)
        self.lora_dropout = float(lora_dropout)
        self.target_modules = list(target_modules)
        self.trainable_bias = bool(trainable_bias)


class LoRALinear(Layer):
    """A ``torch.nn.Linear`` wrapped with a low-rank delta; the base keeps
    its weight, frozen. ``generator`` (on the base's device) draws A."""

    def __init__(self, base, r, lora_alpha, lora_dropout=0.0,
                 generator=None):
        super().__init__()
        out_features, in_features = base.weight.shape
        dev = base.weight.device
        self.base = base
        self.r = int(r)
        self.scaling = float(lora_alpha) / float(r)
        self.lora_dropout = float(lora_dropout)
        # A ~ N(0, 1/r): std sqrt(1/r); B = 0, so the adapted forward
        # starts equal to the base forward
        self.lora_A = nn.Parameter(
            torch.randn(in_features, self.r, generator=generator,
                        device=dev) * (1.0 / self.r) ** 0.5)
        self.lora_B = nn.Parameter(
            torch.zeros(self.r, out_features, device=dev))
        self._merged = False
        base.weight.requires_grad_(False)
        if getattr(base, "bias", None) is not None:
            base.bias.requires_grad_(False)

    def forward(self, x):
        out = self.base(x)
        if self._merged:
            return out
        h = x
        if self.lora_dropout and self.training:
            h = torch.nn.functional.dropout(h, p=self.lora_dropout,
                                            training=True)
        delta = F.linear(F.linear(h, self.lora_A), self.lora_B)
        return out + delta * self.scaling

    def _delta(self, dtype):
        """``(A @ B * scaling)``, in the base's (out, in) layout and
        ``dtype``."""
        return (self.lora_A @ self.lora_B * self.scaling).t().to(dtype)

    @torch.no_grad()
    def merge(self):
        """Fold A @ B * scaling into the frozen base weight (inference)."""
        if self._merged:
            return self
        w = self.base.weight
        w.copy_(w + self._delta(w.dtype))
        self._merged = True
        return self

    @torch.no_grad()
    def unmerge(self):
        if not self._merged:
            return self
        w = self.base.weight
        w.copy_(w - self._delta(w.dtype))
        self._merged = False
        return self

    def extra_repr(self):
        return f"r={self.r}, scaling={self.scaling}, merged={self._merged}"


def _is_linear_like(layer):
    if isinstance(layer, QuantizedLinear):
        raise ValueError(
            "LoRA target matched a QuantizedLinear base: QLoRA-style "
            "adapters over int8 bases are not implemented — the low-"
            "rank delta would train against the dequantized weight "
            "while merge() cannot fold a float delta into an int8 "
            "weight without requantization error. Apply LoRA BEFORE "
            "PTQ convert (then quantize the merged model), or exclude "
            "quantized layers from target_modules.")
    return isinstance(layer, nn.Linear) and \
        getattr(layer, "weight", None) is not None


def _wrap_targets(model, config, generator=None):
    pats = [re.compile(p) for p in config.target_modules]
    wrapped = []

    def visit(layer, prefix):
        for name, sub in list(layer._modules.items()):
            if sub is None:
                continue
            full = f"{prefix}.{name}" if prefix else name
            if any(p.fullmatch(full) or p.fullmatch(name) for p in pats) \
                    and _is_linear_like(sub):
                layer._modules[name] = LoRALinear(
                    sub, config.r, config.lora_alpha, config.lora_dropout,
                    generator)
                wrapped.append(full)
            else:
                visit(sub, full)

    visit(model, "")
    if not wrapped:
        raise ValueError(
            f"LoRA target_modules {config.target_modules} matched no "
            f"Linear-like sublayer — check the patterns against "
            f"named_sublayers()")
    return wrapped


def mark_only_lora_as_trainable(model, trainable_bias=False):
    """Freeze every parameter but lora_A / lora_B (``requires_grad``);
    with ``trainable_bias`` the biases of WRAPPED layers (the LoRALinear
    bases) stay trainable too, and the adapter state dict then holds
    them."""
    for name, p in model.named_parameters():
        is_lora = "lora_A" in name or "lora_B" in name
        is_wrapped_bias = (trainable_bias and name.endswith(".bias")
                           and ".base." in name)
        p.requires_grad_(is_lora or is_wrapped_bias)
    return model


def lora_state_dict(model):
    """The adapter artifact: lora_A / lora_B, plus every TRAINABLE
    wrapped-layer bias (``trainable_bias=True``)."""
    out = {}
    for name, p in model.state_dict().items():
        if "lora_A" in name or "lora_B" in name:
            out[name] = p
    for name, p in model.named_parameters():
        if (name.endswith(".bias") and ".base." in name
                and p.requires_grad):
            out[name] = p
    return out


class LoRAModel(Layer):
    """Wraps the target modules of ``model`` in place, freezes the rest and
    forwards transparently; other attributes reach the wrapped model."""

    def __init__(self, model, lora_config, generator=None):
        super().__init__()
        self.lora_config = lora_config
        self.wrapped_names = _wrap_targets(model, lora_config, generator)
        self.model = model
        mark_only_lora_as_trainable(self, lora_config.trainable_bias)

    def forward(self, *args, **kwargs):
        return self.model(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            return getattr(super().__getattr__("model"), name)

    def merge(self):
        for layer in self._lora_layers():
            layer.merge()
        return self

    def unmerge(self):
        for layer in self._lora_layers():
            layer.unmerge()
        return self

    def _lora_layers(self):
        return [m for m in self.modules() if isinstance(m, LoRALinear)]


def get_lora_model(model, lora_config, generator=None):
    """The reference's entry point (``paddlenlp.peft.get_lora_model``)."""
    return LoRAModel(model, lora_config, generator)
