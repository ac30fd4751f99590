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
  made inside a capture would come from the graph's private pool);
- cuBLAS sets up its workspace for the capture stream.

:data:`ops.LAUNCHES` counts where a wrapper's Python code launches, which a
replay never runs: the capture records the launches it saw, gives them
back (a capture runs no kernel), and each replay adds them once.

Nothing falls back: a capture or a replay that fails raises.
"""
from __future__ import annotations

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
        """Capture ``fn`` on the stream it warmed up on."""
        before = dict(L.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                self.fn()
        finally:
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
