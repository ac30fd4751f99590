"""The fused flash-attention backward's work order, rehearsed on the CPU.

``ops.flash_attention.BwdSchedule`` states, in the form the CUDA kernel
(``csrc/flash_attention_bwd.cu``) follows, which CTA claims which key tile,
which query tiles it walks, and in which order each query tile receives
its dq adds. The card runs the kernel; these tests check the order itself
at every shape of the card tests and at the training and Mistral shapes:
the contributors of each query tile are exactly the key tiles that hold a
live pair with it (against ``band_mask``), every wait is on an earlier
ticket, each tile has one first and one last contributor in the places
the kernel takes them to be, and a step-by-step simulation of the
training and Mistral shapes waits only in the first wave.
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import (BwdSchedule, band_mask,
                                                  bwd_block_k)

# (B, Sq, Sk, H, HK, causal, window): the card tests' shapes, then the
# training shape (Llama-2-7B width, S = 4,096) and Mistral's GQA window
SHAPES = [
    (2, 128, 128, 4, 4, True, None),
    (2, 100, 100, 8, 2, True, None),
    (1, 190, 190, 7, 1, True, None),
    (2, 96, 200, 4, 2, False, None),
    (1, 300, 300, 8, 2, True, 17),
    (1, 64, 1024, 8, 2, True, None),
    (1, 200, 130, 4, 4, True, None),
    (1, 4096, 4096, 32, 32, True, None),
    (1, 4608, 4608, 32, 8, True, 4096),
]
IDS = [f"b{b}-sq{sq}-sk{sk}-h{h}-hk{hk}-{'causal' if c else 'full'}-w{w}"
       for b, sq, sk, h, hk, c, w in SHAPES]
SMS = 132  # H100 SXM: one CTA of the fused kernel per SM


def _live_tiles(s):
    """(n_q, n_k) bool: query tile i and key tile j hold a live pair."""
    mask = band_mask(s.sq, s.sk, s.causal, s.window or None)
    pad = torch.zeros(s.n_q * s.block_q, s.n_k * s.block_k, dtype=torch.bool)
    pad[:s.sq, :s.sk] = mask
    return pad.reshape(s.n_q, s.block_q, s.n_k, s.block_k).any(3).any(1)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_contributors_are_the_live_key_tiles(shape):
    s = BwdSchedule(*shape)
    live = _live_tiles(s)
    for i in range(s.n_q):
        want = live[i].nonzero().flatten().tolist()
        got = s.key_tiles(i)
        got = [] if got is None else list(range(got[0], got[1] + 1))
        assert got == want, (i, got, want)
    for j in range(s.n_k):
        want = live[:, j].nonzero().flatten().tolist()
        walked = sorted({i for i, _ in s.walk(j)})
        assert walked == want, (j, walked, want)
        # every query head of the group, each tile from the highest down
        steps = s.walk(j)
        assert len(steps) == len(want) * s.group
        assert [i for i, _ in steps] == sorted(
            (i for i, _ in steps), reverse=True)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_every_wait_is_on_an_earlier_ticket(shape):
    s = BwdSchedule(*shape)
    tickets = [s.item(t) for t in range(s.n_items)]
    assert sorted(tickets) == sorted(
        (j, b, kh) for j in range(s.n_k) for b in range(s.b)
        for kh in range(s.hk))
    assert all(s.ticket(*s.item(t)) == t for t in range(s.n_items))
    for t, (j, b, kh) in enumerate(tickets):
        for i, _ in s.walk(j):
            rank, _ = s.rank(i, j)
            if rank > 0:
                # the contributor just before: the key tile below, the
                # same batch and KV head
                jlo, _ = s.key_tiles(i)
                assert s.ticket(jlo + rank - 1, b, kh) < t


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_first_and_last_contributors(shape):
    """Replaying every item's adds in ticket order, each tile's first add
    is the store (rank 0) and its last the bf16 conversion (the key tile
    ``jhi``), with every rank in between once; tiles without contributors
    hold only rows that see no key, which the wrapper zeroes."""
    s = BwdSchedule(*shape)
    landed = {}  # (batch, head, tile) -> ranks added so far
    for t in range(s.n_items):
        j, b, kh = s.item(t)
        for i, g in s.walk(j):
            rank, n = s.rank(i, j)
            ranks = landed.setdefault((b, kh * s.group + g, i), [])
            ranks.append(rank)
            # the kernel stores on rank 0 and converts on the last rank
            assert (rank == 0) == (len(ranks) == 1)
            assert (j == s.key_tiles(i)[1]) == (len(ranks) == n)
    for b in range(s.b):
        for head in range(s.h):
            for i in range(s.n_q):
                tiles = s.key_tiles(i)
                if tiles is None:
                    assert (b, head, i) not in landed
                    # rows of a tile nobody adds to see no key at all
                    rows = band_mask(s.sq, s.sk, s.causal, s.window or None)[
                        i * s.block_q:(i + 1) * s.block_q]
                    assert not rows.any()
                    assert shape[5] and s.sq > s.sk
                else:
                    n = tiles[1] - tiles[0] + 1
                    assert landed[(b, head, i)] == list(range(n))
    assert s.n_counters == 1 + s.b * s.h * s.n_q
    assert sorted(s.counter(b, hd, i) for b in range(s.b)
                  for hd in range(s.h) for i in range(s.n_q)) == \
        list(range(1, s.n_counters))


def _simulate(s, sms=SMS, release_delay=0.0):
    """Step-by-step run of the grid on ``sms`` SMs, one CTA each: a CTA
    claims the next ticket as it starts, each step takes one unit, and a
    step whose add has rank r > 0 ends no earlier than the moment rank
    r - 1 released its tile (``release_delay`` after the end of the step
    that added). Returns (makespan, total work, waits of CTAs that
    started at time 0, waits of the rest)."""
    free = [0.0] * sms
    released = {}
    first_wave = later = 0.0
    work = 0
    for t in range(s.n_items):
        j, b, kh = s.item(t)
        sm = min(range(sms), key=free.__getitem__)
        start = now = free[sm]
        for i, g in s.walk(j):
            rank, _ = s.rank(i, j)
            end = now + 1
            head = kh * s.group + g
            if rank > 0:
                wait = max(0.0, released[(b, head, i, rank - 1)] - end)
                if start == 0:
                    first_wave += wait
                else:
                    later += wait
                end += wait
            released[(b, head, i, rank)] = end + release_delay
            now = end
            work += 1
        free[sm] = now
    return max(free), work, first_wave, later


@pytest.mark.parametrize("shape", [SHAPES[-2], SHAPES[-1]],
                         ids=["train", "mistral_gqa_window"])
def test_no_wait_in_the_steady_state(shape):
    """With each tile released as its add lands, no CTA ever waits at the
    training and Mistral shapes, and the long walks, claimed first, leave
    the grid within 2% of a perfect spread of its steps over the SMs. The
    kernel releases a tile in its next step, after the first half of that
    step's products: with half a step of delay the waits stay in the
    first wave, where CTAs that started together on one tile run one
    behind the other, but for 0.1% of the steps after it."""
    s = BwdSchedule(*shape)
    makespan, work, first, later = _simulate(s)
    assert first == 0 and later == 0
    assert makespan <= 1.02 * math.ceil(work / SMS)
    makespan, work, first, later = _simulate(s, release_delay=0.5)
    assert later <= 1e-3 * work and first <= 1e-2 * work
    assert makespan <= 1.03 * math.ceil(work / SMS)


def test_workspace_and_counters_size_the_launch():
    s = BwdSchedule(1, 4096, 4096, 32, 32, True)
    assert (s.n_q, s.n_k, s.n_items) == (64, 32, 1024)
    shape = s.workspace_shape(128)
    assert shape == (1, 32, 64, 64, 132)
    # the 64 MiB of an f32 (B, Sq, H, D) dq, plus 3% of row padding
    assert math.prod(shape) * 4 == 69206016
    g4 = BwdSchedule(2, 100, 100, 8, 2, True)
    assert g4.group == 4 and g4.item(3) == (0, 1, 1)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_f32_key_tiles_keep_the_order(shape):
    """The f32 kernel at head width 64 walks 64-key tiles
    (``bwd_block_k``): its contributors are still the live key tiles,
    each wait is on an earlier ticket, and each tile's ranks land 0, 1,
    ... in ticket order (the f32 kernel stores rank 0 and adds the rest
    into dq itself)."""
    s = BwdSchedule(*shape, block_k=bwd_block_k(torch.float32, 64))
    assert s.block_k == 64
    live = _live_tiles(s)
    landed = {}
    for t in range(s.n_items):
        j, b, kh = s.item(t)
        assert sorted({i for i, _ in s.walk(j)}) == \
            live[:, j].nonzero().flatten().tolist()
        for i, g in s.walk(j):
            rank, n = s.rank(i, j)
            if rank > 0:
                jlo, _ = s.key_tiles(i)
                assert s.ticket(jlo + rank - 1, b, kh) < t
            key = (b, kh * s.group + g, i)
            assert landed.get(key, 0) == rank < n
            landed[key] = rank + 1
    for (b, head, i), count in landed.items():
        assert count == int(live[i].sum())
