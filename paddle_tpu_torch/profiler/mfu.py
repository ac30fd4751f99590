"""MFU accounting (counterpart of ``paddle_tpu/profiler/mfu.py``).

Model FLOPs, not hardware FLOPs: 6 * N * T for the parameter products of
a train step (forward 2NT, backward 4NT) plus the attention score and
value products, 12 * L * S * E per token, halved when causal. MFU is the
achieved model FLOP/s over the card's peak.
"""
from __future__ import annotations

import time

import torch

__all__ = ["peak_flops_per_chip", "transformer_train_flops", "MFUMeter"]

# dense bf16 tensor-core FLOP/s by CUDA device name (NVIDIA's data sheet);
# "NVIDIA H100 80GB HBM3" is the H100 SXM's name
_PEAKS = {
    "H100 80GB HBM3": 989e12,
    "H100 SXM": 989e12,
}


def peak_flops_per_chip(device=None):
    """Peak dense bf16 FLOP/s of CUDA device ``device`` (default the
    current one) from its name; 0 for an unknown card or without CUDA
    (callers then report throughput, not MFU)."""
    if not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(device)
    for key in sorted(_PEAKS, key=len, reverse=True):
        if key in name:
            return _PEAKS[key]
    return 0.0


def transformer_train_flops(n_params, tokens, num_layers=0, seq_len=0,
                            hidden=0, causal=True):
    """Model FLOPs of ONE train step over ``tokens`` tokens: 6 * N * T for
    the parameter products, plus 12 * L * S * E per token for attention
    (forward 4 * S * E per layer, times 3 for forward and backward),
    halved when causal."""
    flops = 6.0 * n_params * tokens
    if num_layers and seq_len and hidden:
        attn = 12.0 * num_layers * seq_len * hidden * tokens
        if causal:
            attn *= 0.5
        flops += attn
    return flops


class MFUMeter:
    """Times step callables (host clock around work that ends in a device
    synchronize) and reports tokens/s and MFU."""

    def __init__(self, flops_per_step, tokens_per_step, n_chips=1):
        self.flops_per_step = flops_per_step
        self.tokens_per_step = tokens_per_step
        self.n_chips = n_chips
        self.peak = peak_flops_per_chip() * n_chips
        self._times = []

    def measure(self, step_fn, warmup=2, iters=10, sync=None):
        """Run ``step_fn()`` warmup + iters times, waiting for the device
        after each (``sync(result)`` overrides how)."""
        for _ in range(warmup):
            _block(step_fn(), sync)
        for _ in range(iters):
            t0 = time.perf_counter()
            _block(step_fn(), sync)
            self._times.append(time.perf_counter() - t0)
        return self.report()

    def report(self):
        if not self._times:
            return {}
        ts = sorted(self._times)
        step_time = ts[len(ts) // 2]  # the median resists stragglers
        achieved = self.flops_per_step / step_time
        return {
            "step_time_s": step_time,
            "tokens_per_sec": self.tokens_per_step / step_time,
            "tokens_per_sec_per_chip":
                self.tokens_per_step / step_time / self.n_chips,
            "model_tflops_per_sec": achieved / 1e12,
            "mfu": (achieved / self.peak) if self.peak else None,
            "n_steps_timed": len(ts),
        }


def _block(result, sync):
    if sync is not None:
        sync(result)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()
