"""The host rules of the reference's native io core
(``csrc/paddle_tpu_io.cc``), in numpy: the splitmix64 Fisher-Yates
permutation and the varlen pack (its row gather is numpy's indexing,
``DataLoader``'s fast path). Each gives what the native
library gives, so one seed draws the same permutation in both packages.

The permutation's draws do not depend on the swaps (splitmix64's state
only advances), so they are made in one vectorised pass; the swaps run
in order on the host (about 0.5 s per million indices).
"""
from __future__ import annotations

import numpy as np

__all__ = ["shuffle_indices", "pack_varlen"]

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_ZERO_SEED = 0x853C49E6748FEA9B


def _splitmix64(seed, n):
    """The first ``n`` outputs of splitmix64 from state ``seed``."""
    with np.errstate(over="ignore"):
        s = np.uint64(seed) + _GOLDEN * np.arange(1, n + 1, dtype=np.uint64)
        z = (s ^ (s >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def shuffle_indices(n, seed):
    """The permutation of ``arange(n)`` (int64) that the native core's
    Fisher-Yates draws from ``seed``: for i from n - 1 down to 1, swap i
    with splitmix64() mod (i + 1); a zero seed starts from the core's
    fixed state."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    s = seed if seed else _ZERO_SEED
    n = int(n)
    if n < 2:
        return np.arange(n, dtype=np.int64)
    i = np.arange(n - 1, 0, -1, dtype=np.uint64)
    js = (_splitmix64(s, n - 1) % (i + np.uint64(1))).tolist()
    buf = list(range(n))
    for i, j in zip(range(n - 1, 0, -1), js):
        buf[i], buf[j] = buf[j], buf[i]
    return np.asarray(buf, dtype=np.int64)


def pack_varlen(rows, max_len, pad_id=0):
    """Rows of ints -> (batch int32 (n, max_len) padded with ``pad_id``,
    lengths int32 (n,)); longer rows are truncated."""
    out = np.full((len(rows), max_len), pad_id, np.int32)
    lengths = np.empty((len(rows),), np.int32)
    for i, r in enumerate(rows):
        a = np.asarray(r, dtype=np.int32)[:max_len]
        lengths[i] = len(a)
        out[i, :len(a)] = a
    return out, lengths
