"""One decode step captured as a CUDA graph (the counterpart of the
reference compiling its decode loops into one program).

A :class:`CapturedStep` wraps a step function that reads and writes only
static tensors: buffers made before the capture and never reallocated
(slot state, token buffers, KV pools and caches, weights). Its first call
runs eagerly on the step's own capture stream as the warm-up, and does the
step's real work; the capture follows on the same stream, and every later
call is a replay. The warm-up is what makes the capture safe:

- the kernel library is built and loaded (``ops._library.library``), and
  each kernel's one-time shared-memory attribute is set;
- K2/K5's merge-ticket buffer of the capture stream is made
  (``ops.split_decode.tickets_for`` keys tickets by stream, and a buffer
  made inside a capture would come from the graph's private pool).

cuBLAS's workspaces are the other way round: they are dropped right
before and right after each capture, so the capture allocates its own
workspace in the graph's private pool, which lives as long as the graph
(as inductor's CUDA graph trees do). A workspace taken from the shared
pool is keyed by (handle, stream), so graphs captured on one stream
share it, and it can be freed and its memory handed to other tensors
while a graph still writes it (ROADMAP C11).

The cycle collector is run before the capture and held off during it. An
engine that holds a captured graph is a reference cycle (the graph's step
is one of its bound methods), so a dropped engine is freed only by the
collector, at whatever allocation triggers it. Freed inside another
graph's capture, its graph and memory pool make CUDA calls that a capture
forbids, and the capture fails ("operation failed due to a previous error
during capture"); the card showed exactly that, with a collection of 127
objects inside the failed capture.

:data:`ops.LAUNCHES` counts where a wrapper's Python code launches, which a
replay never runs: the capture records the launches it saw, gives them
back (a capture runs no kernel), and each replay adds them once.

Nothing falls back: a capture or a replay that fails raises.
"""
from __future__ import annotations

import gc

import torch

from .ops import _library as L

__all__ = ["CapturedStep"]


class CapturedStep:
    """``fn`` (no arguments) as a CUDA graph on ``device``: call
    :meth:`warm_up` once, then :meth:`capture`, then :meth:`replay`
    (or :meth:`run`, which does all three)."""

    def __init__(self, fn, device):
        self.fn = fn
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.launches = {}

    def warm_up(self):
        """Run ``fn`` once, eagerly, on the capture stream."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self.fn()
        cur.wait_stream(self.stream)

    def capture(self):
        """Capture ``fn`` on the stream it warmed up on, with no cycle
        collection inside the capture and cuBLAS's workspaces dropped on
        either side (see the module's docstring)."""
        before = dict(L.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self.fn()
        finally:
            torch._C._cuda_clearCublasWorkspaces()
            if was_enabled:
                gc.enable()
            seen = {k: n - before[k] for k, n in L.LAUNCHES.items()}
            L.LAUNCHES.update(before)
        self.launches = {k: n for k, n in seen.items() if n}
        self.graph = graph

    def replay(self):
        self.graph.replay()
        for k, n in self.launches.items():
            L.LAUNCHES[k] += n

    def run(self, n):
        """``n`` steps with no host sync: until the step is captured, the
        first is the warm-up and a capture follows when more remain; the
        rest are replays."""
        if n > 0 and self.graph is None:
            self.warm_up()
            n -= 1
            if n:
                self.capture()
        for _ in range(n):
            self.replay()
