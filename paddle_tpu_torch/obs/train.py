"""Train-side telemetry (counterpart of ``paddle_tpu/obs/train.py``): wrap
a :class:`~paddle_tpu_torch.jit.train.JittedTrainStep` (or any
``step(inputs, labels) -> loss`` callable) and feed step time, tokens per
second and MFU into the same registry the serving engine exports.

The wrapper times each step on the host clock. With ``sync`` (the
default) it waits for the card (``torch.cuda.synchronize``) before it
stops the clock, which a loop that logs its loss pays anyway;
``sync=False`` times the enqueue only. MFU takes the model FLOPs of
:mod:`paddle_tpu_torch.profiler.mfu` over the card's peak; without a known
peak (the CPU, an unknown card) the MFU gauge is not set and the
throughput gauges still export.
"""
from __future__ import annotations

import time
from collections import deque

from .registry import LATENCY_BUCKETS, MetricsRegistry

__all__ = ["InstrumentedTrainStep"]

# step-time buckets: LATENCY_BUCKETS plus a slow tail for big-model
# steps (10 s .. 120 s)
_STEP_BUCKETS = tuple(LATENCY_BUCKETS) + (30.0, 60.0, 120.0)


class InstrumentedTrainStep:
    """Telemetry proxy around a train step.

    Args:
        step: the wrapped step, typically a
            :class:`~paddle_tpu_torch.jit.train.JittedTrainStep`; every
            attribute this proxy does not define (``run_steps``,
            ``sync_to_model``, ``params``, ...) passes straight through
            to the same object.
        registry: target :class:`MetricsRegistry` (default: fresh).
        name: metric name prefix (``<name>_step_seconds``, ...).
        tokens_per_step: tokens consumed per step — enables the
            ``_tokens_total`` counter and tokens/s gauges.
        model_flops_per_step: model FLOPs per step (see
            :func:`paddle_tpu_torch.profiler.mfu.transformer_train_flops`) —
            enables the MFU / TFLOP/s gauges when the chip peak is
            known.
        n_chips: chips the step spans (peak = per-chip peak × n).
        sync: block on the loss before stopping the clock.
        tracer: optional :class:`~paddle_tpu_torch.obs.trace.TraceRecorder`
            — one ``X`` span per step on the train track.
    """

    def __init__(self, step, registry=None, name="train",
                 tokens_per_step=None, model_flops_per_step=None,
                 n_chips=1, sync=True, tracer=None):
        self._step = step
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.name = str(name)
        self.tokens_per_step = (None if tokens_per_step is None
                                else int(tokens_per_step))
        self.model_flops_per_step = (
            None if model_flops_per_step is None
            else float(model_flops_per_step))
        self._sync = bool(sync)
        self.tracer = tracer
        from ..profiler.mfu import peak_flops_per_chip

        self.peak_flops = peak_flops_per_chip() * int(n_chips)
        r = self.registry
        self._h_step = r.histogram(
            f"{self.name}_step_seconds", "one train step, host wall",
            buckets=_STEP_BUCKETS)
        self._c_steps = r.counter(
            f"{self.name}_steps_total", "train steps dispatched")
        self._c_tokens = r.counter(
            f"{self.name}_tokens_total", "tokens consumed")
        self._g_tok_s = r.gauge(
            f"{self.name}_tokens_per_second", "last-step tokens/s")
        self._g_mfu = r.gauge(
            f"{self.name}_mfu", "model-FLOP utilization (0..1)")
        self._g_tflops = r.gauge(
            f"{self.name}_model_tflops_per_second",
            "achieved model TFLOP/s")
        self._times = deque(maxlen=4096)

    @classmethod
    def for_transformer(cls, step, *, n_params, tokens_per_step,
                        num_layers=0, seq_len=0, hidden=0, causal=True,
                        **kw):
        """Convenience: derive ``model_flops_per_step`` from the
        standard 6NT(+attention) accounting in profiler.mfu."""
        from ..profiler.mfu import transformer_train_flops

        flops = transformer_train_flops(
            n_params, tokens_per_step, num_layers=num_layers,
            seq_len=seq_len, hidden=hidden, causal=causal)
        return cls(step, tokens_per_step=tokens_per_step,
                   model_flops_per_step=flops, **kw)

    def __call__(self, inputs, labels):
        t0 = time.perf_counter()
        loss = self._step(inputs, labels)
        if self._sync:
            from ..profiler.mfu import _block

            _block(loss, None)
        t1 = time.perf_counter()
        dt = t1 - t0
        self._times.append(dt)
        self._h_step.observe(dt)
        self._c_steps.inc()
        if self.tokens_per_step:
            self._c_tokens.inc(self.tokens_per_step)
            self._g_tok_s.set(self.tokens_per_step / dt)
        if self.model_flops_per_step:
            achieved = self.model_flops_per_step / dt
            self._g_tflops.set(achieved / 1e12)
            if self.peak_flops:
                self._g_mfu.set(achieved / self.peak_flops)
        if self.tracer is not None:
            self.tracer.thread_name(100, self.name)
            self.tracer.complete(f"{self.name}_step", t0, t1, tid=100)
        return loss

    def report(self):
        """MFUMeter-shaped summary over the recorded steps (median step
        time; empty dict before the first step)."""
        if not self._times:
            return {}
        ts = sorted(self._times)
        step_time = ts[len(ts) // 2]
        out = {"step_time_s": step_time, "n_steps_timed": len(ts)}
        if self.tokens_per_step:
            out["tokens_per_sec"] = self.tokens_per_step / step_time
        if self.model_flops_per_step:
            achieved = self.model_flops_per_step / step_time
            out["model_tflops_per_sec"] = achieved / 1e12
            out["mfu"] = (achieved / self.peak_flops
                          if self.peak_flops else None)
        return out

    def __getattr__(self, attr):
        # state accessors (run_steps, sync_to_model, params, ...) hit the
        # wrapped step unchanged
        return getattr(self._step, attr)
