"""The bf16 flash-attention forward's tile plan, rehearsed on the CPU.

``ops.flash_attention.FwdTiles`` states, in the form the CUDA kernel
(``csrc/flash_attention.cu``) follows, which key tiles each 128-row query
tile walks, which of them skip the mask, and in which order the CTAs are
launched. The card runs the kernel; these tests check the plan itself
against ``band_mask`` at the shapes of the smoke run's kernel phase and at
ragged ones (query lengths around the 128-row edges, fewer and more
queries than keys, windows around the 128-key edges, no causal mask):
every live pair lies in exactly one visited tile, no visited tile is
wholly dead, a "full" tile is live for every real row, and the launch
order never raises the live key count.
"""
import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import (FWD_BLOCK_K, FWD_BLOCK_Q,
                                                  FwdTiles, band_mask)

# (B, Sq, Sk, H, HK, causal, window): the smoke run's four K4 shapes
# (Mistral's prefill, dense causal 2,048, bottom-right, the training shape)
SHAPES = [
    (1, 4608, 4608, 32, 8, True, 4096),
    (1, 2048, 2048, 32, 32, True, None),
    (1, 64, 1024, 32, 8, True, None),
    (1, 4096, 4096, 32, 32, True, None),
]
for _sq in (1, 63, 64, 65, 127, 128, 129, 300):
    SHAPES += [
        (2, _sq, _sq, 4, 2, True, None),
        (2, _sq, _sq + 77, 4, 2, True, None),        # Sq < Sk
        (2, _sq, _sq // 2, 4, 2, True, None),        # Sq > Sk
        (2, _sq, _sq, 4, 2, True, 127),
        (2, _sq, _sq, 4, 2, True, 128),
        (2, _sq, _sq + 77, 7, 1, True, 129),
        (2, _sq, _sq + 33, 4, 4, False, None),
    ]
IDS = [f"b{b}-sq{sq}-sk{sk}-h{h}-hk{hk}-{'causal' if c else 'full'}-w{w}"
       for b, sq, sk, h, hk, c, w in SHAPES]


def _mask(t):
    return band_mask(t.sq, t.sk, t.causal, t.window or None)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_live_pair_in_one_visited_tile(shape):
    """The visited key tiles of a query tile cover its rows' live keys
    exactly once, and each holds at least one live pair."""
    t = FwdTiles(*shape)
    mask = _mask(t)
    for i in range(t.n_q):
        rows = mask[i * t.block_q:(i + 1) * t.block_q]
        seen = torch.zeros(t.sk, dtype=torch.int32)
        for k0 in t.tiles(i):
            block = rows[:, k0:k0 + t.block_k]
            assert block.any(), (i, k0)
            seen[k0:k0 + t.block_k] += 1
        assert bool((seen <= 1).all())
        assert bool((seen[rows.any(0)] == 1).all()), i


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_full_tiles_are_live_for_every_real_row(shape):
    t = FwdTiles(*shape)
    mask = _mask(t)
    for i in range(t.n_q):
        rows = mask[i * t.block_q:(i + 1) * t.block_q]
        for k0 in t.tiles(i):
            if t.full(i, k0):
                assert k0 + t.block_k <= t.sk
                assert bool(rows[:, k0:k0 + t.block_k].all()), (i, k0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_launch_order(shape):
    """Every (query tile, batch, head) once; the live keys never rise
    along the order; within a rank the heads run fastest, so the query
    heads of one KV head are launched side by side."""
    t = FwdTiles(*shape)
    order = t.order()
    assert sorted(order) == sorted(
        (i, b, h) for i in range(t.n_q) for b in range(t.b)
        for h in range(t.h))
    keys = [t.live_keys(i) for i, _, _ in order]
    assert all(a >= c for a, c in zip(keys, keys[1:])), keys
    assert keys[0] == max(t.live_keys(i) for i in range(t.n_q))
    mask = _mask(t)
    for i in range(t.n_q):
        rows = mask[i * t.block_q:(i + 1) * t.block_q]
        live = rows.any(0).nonzero().flatten()
        lo, hi = t.key_range(i)
        if live.numel():
            assert lo <= int(live[0]) and int(live[-1]) < hi
    group = t.h // t.hk
    for w in range(0, t.n_items, t.h):
        heads = [h for _, _, h in order[w:w + t.h]]
        assert heads == list(range(t.h))
        assert [h // group for h in heads] == sorted(h // group
                                                     for h in heads)


def test_tiles_match_the_kernel_source():
    """The plan's tile sizes are the kernel's."""
    src = (Path(__file__).resolve().parents[1] / "paddle_tpu_torch" / "csrc"
           / "flash_attention.cu").read_text()
    assert int(re.search(r"constexpr int kTQ = (\d+);", src)[1]) == \
        FWD_BLOCK_Q
    assert int(re.search(r"constexpr int kTK = (\d+);", src)[1]) == \
        FWD_BLOCK_K
    t = FwdTiles(1, 4608, 4608, 32, 8, True, 4096)
    assert (t.n_q, t.n_items) == (36, 36 * 32)
    # Mistral's prefill: every tile past the window's ramp walks 33 tiles
    assert [len(t.tiles(i)) for i in (0, 31, 32, 35)] == [1, 32, 33, 33]
