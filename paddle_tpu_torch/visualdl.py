"""VisualDL-compatible ``LogWriter`` / ``LogReader`` of the port (a copy
of ``paddle_tpu/visualdl.py``, which imports nothing of JAX): one
append-only JSONL stream per writer (``vdlrecords.<ts>.jsonl``) of
{kind, tag, step, wall_time, ...} records; the reader restores each
tag's scalar series. The ``VisualDL`` callback writes through it.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["LogWriter", "LogReader"]


class LogWriter:
    """``with LogWriter(logdir='./runs') as w: w.add_scalar(...)``"""

    def __init__(self, logdir="./vdl_log", file_name=None, **kwargs):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        if file_name is None:
            file_name = f"vdlrecords.{int(time.time() * 1000)}.jsonl"
        self._path = os.path.join(logdir, file_name)
        self._f = open(self._path, "a")

    @property
    def file_path(self):
        return self._path

    def _write(self, kind, tag, step, payload):
        rec = {"kind": kind, "tag": tag, "step": int(step),
               "wall_time": time.time()}
        rec.update(payload)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def add_scalar(self, tag, value, step, walltime=None):
        self._write("scalar", tag, step, {"value": float(value)})

    def add_histogram(self, tag, values, step, buckets=10):
        arr = np.asarray(values).reshape(-1)
        if arr.size == 0:
            self._write("histogram", tag, step, {
                "hist": [], "edges": [], "min": 0.0, "max": 0.0, "mean": 0.0,
            })
            return
        hist, edges = np.histogram(arr, bins=buckets)
        self._write("histogram", tag, step, {
            "hist": hist.tolist(), "edges": edges.tolist(),
            "min": float(arr.min()), "max": float(arr.max()),
            "mean": float(arr.mean()),
        })

    def add_text(self, tag, text_string, step):
        self._write("text", tag, step, {"text": str(text_string)})

    def add_hparams(self, hparams_dict, metrics_list=None, **kwargs):
        self._write("hparams", "hparams", 0, {
            "hparams": {k: str(v) for k, v in hparams_dict.items()},
            "metrics": list(metrics_list or []),
        })

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class LogReader:
    """Reads every vdlrecords JSONL stream under ``logdir``."""

    def __init__(self, logdir):
        self.logdir = logdir

    def _records(self):
        for name in sorted(os.listdir(self.logdir)):
            if not name.startswith("vdlrecords."):
                continue
            with open(os.path.join(self.logdir, name)) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        yield json.loads(line)

    def tags(self, kind="scalar"):
        return sorted({
            r["tag"] for r in self._records() if r["kind"] == kind
        })

    def scalars(self, tag):
        return [
            (r["step"], r["value"])
            for r in self._records()
            if r["kind"] == "scalar" and r["tag"] == tag
        ]
