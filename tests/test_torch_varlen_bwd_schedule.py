"""The fused varlen flash-attention backward's work order, rehearsed on the
CPU.

``ops.varlen_flash_attention.VarlenBwdSchedule`` states, in the form the
CUDA kernel K8 (``csrc/varlen_flash_attention_bwd.cu``) follows, which CTA
claims which 128-key tile, which query tiles it walks (with each 64-key
half's tile state), and in which order each (query head, query tile)
receives its dq adds. The card runs the kernel; these tests check the
order itself on packed batches (against ``segment_mask``): the
contributors of each query tile are exactly the key tiles with a live
pair, each key's live queries form the one interval the kernel's mask
tests, every wait is on an earlier ticket, ranks count live contributors
only, each tile has one first and one last contributor, the tiles without
a contributor are exactly those whose rows see no key, a step-by-step run
of the grid on 132 SMs finishes, and a packed row of one segment takes
the dense kernel's order (``BwdSchedule``).
"""
import math

import pytest
import torch

from paddle_tpu_torch.ops.flash_attention import BwdSchedule
from paddle_tpu_torch.ops.varlen_flash_attention import (VarlenBwdSchedule,
                                                         segment_mask)

PACKED = [1600, 800, 600, 400, 300, 200, 120, 76]
# (label, lens_q, lens_k or None, padding rows, H, HK, causal, window): the
# packed 941M row and chip_smoke's other K8 shapes, padding rows past
# cu_q[-1], a segment shorter than a tile across a 64-row and a 128-key
# tile edge, key tiles dead inside a query tile's key range (a segment
# without queries; a window behind more keys than queries), the card
# tests' shapes, and a packed row of one segment
CASES = [
    ("packed_941m", PACKED, None, 0, 32, 32, True, None),
    ("empty_segments", [1600, 0, 800, 600, 0, 400, 300, 200, 120, 76, 0],
     None, 0, 32, 32, True, None),
    ("cross_lengths", [1024, 512, 300, 76], [1600, 512, 700, 76], 0, 32, 32,
     True, None),
    ("gqa_window", PACKED, None, 0, 32, 8, True, 512),
    ("padding_rows", [100, 37, 200], None, 63, 4, 2, True, None),
    ("short_segment_straddles", [60, 10, 120, 20, 100], None, 0, 4, 1, True,
     None),
    ("query_less_segment", [100, 0, 100, 60], [100, 300, 100, 60], 0, 4, 2,
     True, None),
    ("window_dead_key_tiles", [40, 100], [40, 1000], 0, 4, 2, True, 64),
    ("card_ragged_gqa", [13, 37, 1, 77], None, 0, 4, 2, True, None),
    ("card_empty_d128", [200, 0, 130, 64, 1, 0], None, 0, 8, 2, True, None),
    ("card_cross", [9, 25, 140], [17, 125, 61], 0, 4, 4, True, None),
    ("card_cross_full", [9, 25, 140], [17, 125, 61], 0, 4, 4, False, None),
    ("card_cross_window", [90, 25, 140, 0], [17, 125, 61, 30], 0, 8, 2, True,
     20),
    ("card_window_g8", [300, 70, 190], None, 0, 8, 1, True, 48),
    ("card_no_keys", [6, 10, 12], [9, 0, 4], 5, 4, 2, True, None),
    ("one_segment", [1000], None, 0, 8, 2, True, None),
]
IDS = [c[0] for c in CASES]
# the kernel's CTA shapes: 64 keys at head width 64, 128 at 128
HEAD_DIMS = [64, 128]
SMS = 132  # H100 SXM
# CTAs of the fused kernel an SM holds: two of 64 keys, one of 128
CTAS_PER_SM = {64: 2, 128: 1}


def _cu(lens):
    out = [0]
    for n in lens:
        out.append(out[-1] + n)
    return out


def _schedule(case, d=128):
    _, lens_q, lens_k, pad, h, hk, causal, window = case
    cu_q = _cu(lens_q)
    cu_k = _cu(lens_q if lens_k is None else lens_k)
    return VarlenBwdSchedule(cu_q, cu_k, cu_q[-1] + pad, cu_k[-1], h, hk,
                             causal, window, d)


def _mask(s):
    return segment_mask(torch.tensor(s.cu_q), torch.tensor(s.cu_k), s.tq,
                        s.tk, s.causal, s.window or None)


def _blocks(s, cols):
    """(n_q, n_cols) bool: query tile i and the column block of ``cols``
    keys hold a live pair; (and every pair of a whole block is live)."""
    n_c = -(-s.tk // cols)
    pad = torch.zeros(s.n_q * 64, n_c * cols, dtype=torch.bool)
    real = torch.zeros_like(pad)
    pad[:s.tq, :s.tk] = _mask(s)
    real[:s.tq, :s.tk] = True
    pad = pad.reshape(s.n_q, 64, n_c, cols)
    real = real.reshape(s.n_q, 64, n_c, cols)
    return pad.any(3).any(1), (pad & real).all(3).all(1)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_contributors_are_the_live_key_tiles(case, d):
    s = _schedule(case, d)
    live, _ = _blocks(s, s.block_k)
    for i in range(s.n_q):
        assert s.contributors(i) == live[i].nonzero().flatten().tolist(), i
    half_live, half_full = _blocks(s, 64)
    for j in range(s.n_k):
        tiles = s.tiles(j)
        # every live query tile, each once, from the highest down
        assert [i for i, _, _ in tiles] == \
            live[:, j].nonzero().flatten().tolist()[::-1], j
        for i, st0, st1 in tiles:
            for w, st in enumerate((st0, st1)):
                c = s.halves * j + w
                if w >= s.halves or c >= half_live.shape[1]:
                    assert st == 0
                    continue
                # dead exactly when no pair is live; full (no mask) only
                # when every pair of the whole 64 x 64 block is live
                assert (st != 0) == bool(half_live[i, c]), (i, j, w)
                assert st != 2 or bool(half_full[i, c]), (i, j, w)
        steps = s.walk(j)
        assert steps == [(i, g) for i, _, _ in tiles
                         for g in range(s.group)]


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_each_key_is_seen_by_one_interval_of_queries(case, d):
    """The kernel's per-pair mask: key kj's live queries are exactly
    ``key_queries(kj)``."""
    s = _schedule(case, d)
    mask = _mask(s)
    pos = torch.arange(s.tq)
    for kj in range(s.tk):
        qa, qb = s.key_queries(kj)
        assert torch.equal(mask[:, kj], (pos >= qa) & (pos < qb)), kj


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_every_wait_is_on_an_earlier_ticket(case, d):
    """``prev`` is the contributor just before, counting live
    contributors only, and its ticket is earlier; ``last`` marks the last
    contributor."""
    s = _schedule(case, d)
    assert sorted(s.item(t) for t in range(s.n_items)) == sorted(
        (j, kh) for j in range(s.n_k) for kh in range(s.hk))
    assert all(s.ticket(*s.item(t)) == t for t in range(s.n_items))
    waits = 0
    for t in range(s.n_items):
        j, kh = s.item(t)
        for i, _, _ in s.tiles(j):
            rank, n = s.rank(i, j)
            prev, last = s.order(i, j)
            assert prev == (s.contributors(i)[rank - 1] if rank else -1)
            assert last == (rank == n - 1)
            if prev >= 0:
                assert s.ticket(prev, kh) < t
                waits += 1
    assert waits == sum(len(s.contributors(i)) - 1 for i in range(s.n_q)
                        if s.contributors(i)) * s.hk


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_first_and_last_contributors(case, d):
    """Replaying every item's adds in ticket order, each (head, tile)'s
    first add is the store, its last the bf16 conversion, with every rank
    in between once; the tiles nobody adds to are exactly the tiles whose
    rows see no key, and the kernel zeroes them."""
    s = _schedule(case, d)
    landed = {}  # (head, tile) -> ranks added so far
    for t in range(s.n_items):
        j, kh = s.item(t)
        for i, g in s.walk(j):
            rank, n = s.rank(i, j)
            prev, last = s.order(i, j)
            ranks = landed.setdefault((kh * s.group + g, i), [])
            ranks.append(rank)
            assert (prev < 0) == (len(ranks) == 1)
            assert last == (len(ranks) == n)
    rows_see = torch.zeros(s.n_q * 64, dtype=torch.bool)
    rows_see[:s.tq] = _mask(s).any(1)
    no_key = [i for i in range(s.n_q)
              if not rows_see[i * 64:(i + 1) * 64].any()]
    assert s.zero_tiles() == no_key
    for head in range(s.h):
        for i in range(s.n_q):
            n = len(s.contributors(i))
            if i in no_key:
                assert n == 0 and (head, i) not in landed
            else:
                assert landed[(head, i)] == list(range(n))
    assert sorted(s.counter(hd, i) for hd in range(s.h)
                  for i in range(s.n_q)) == list(range(1, s.n_counters))


def _simulate(s, sms=SMS):
    """Step-by-step run of the grid on ``sms`` SMs, one CTA each: a CTA
    claims the next ticket as it starts, each step takes one unit, and a
    step that adds after a predecessor ends no earlier than the
    predecessor's add (a missing one would be a deadlock). Returns
    (makespan, steps, waits of CTAs that started at time 0, waits of the
    rest)."""
    free = [0.0] * sms
    released = {}
    first_wave = later = 0.0
    work = 0
    tiles = [s.tiles(j) for j in range(s.n_k)]
    orders = {}
    for t in range(s.n_items):
        j, kh = s.item(t)
        sm = min(range(sms), key=free.__getitem__)
        start = now = free[sm]
        for i, _, _ in tiles[j]:
            if (i, j) not in orders:
                orders[(i, j)] = s.order(i, j)
            prev, _ = orders[(i, j)]
            for g in range(s.group):
                head = kh * s.group + g
                end = now + 1
                if prev >= 0:
                    wait = max(0.0, released[(head, i, prev)] - end)
                    if start == 0:
                        first_wave += wait
                    else:
                        later += wait
                    end += wait
                released[(head, i, j)] = end
                now = end
                work += 1
        free[sm] = now
    return max(free), work, first_wave, later


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_the_grid_finishes_without_deadlock(case, d, record_property):
    """Every wait refers to an add that an earlier ticket has made, so the
    simulation ends. At the packed 941M row and its GQA window the CTAs
    that start later wait for under 1% of the steps; the packed row's grid
    (1,024 items) ends within 15% of a perfect spread of its steps over
    the SMs, and the window's (256 items of 36 steps, under two waves)
    within its longest walk of the second wave."""
    s = _schedule(case, d)
    sms = SMS * CTAS_PER_SM[s.block_k]
    makespan, work, first, later = _simulate(s, sms)
    # the run's waits, in the test report's properties
    record_property("simulation", {"steps": work, "makespan": makespan,
                                   "ideal": math.ceil(work / sms),
                                   "first_wave_waits": first,
                                   "later_waits": later})
    assert work == sum(len(s.walk(j)) for j in range(s.n_k)) * s.hk
    if case[0] in ("packed_941m", "gqa_window"):
        assert later <= 1e-2 * work
        longest = max(len(s.walk(j)) for j in range(s.n_k))
        assert makespan <= (1.15 * math.ceil(work / sms)
                            if case[0] == "packed_941m"
                            else math.ceil(work / sms) + longest)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("window", [None, 100])
def test_one_segment_takes_the_dense_order(window, d):
    """A packed row of one segment is the dense case: the same items,
    walks, contributors, predecessors and workspace as ``BwdSchedule``."""
    t, h, hk = 1000, 8, 2
    s = VarlenBwdSchedule([0, t], [0, t], t, t, h, hk, True, window, d)
    dense = BwdSchedule(1, t, t, h, hk, True, window, block_k=s.block_k)
    assert (s.n_q, s.n_k, s.n_items, s.n_counters) == \
        (dense.n_q, dense.n_k, dense.n_items, dense.n_counters)
    for ticket in range(s.n_items):
        assert s.item(ticket) == dense.item(ticket)[::2]
    for j in range(s.n_k):
        assert s.walk(j) == dense.walk(j)
        for i, _ in s.walk(j):
            rank, n = dense.rank(i, j)
            assert s.rank(i, j) == (rank, n)
            assert s.order(i, j) == (j - 1 if rank else -1, rank == n - 1)
    for i in range(s.n_q):
        jlo, jhi = dense.key_tiles(i)
        assert s.contributors(i) == list(range(jlo, jhi + 1))
    assert (1, *s.workspace_shape(d)) == dense.workspace_shape(d)


def test_workspace_and_counters_size_the_launch():
    # the packed 941M row (D = 64): 64-key CTAs on one warpgroup
    s = _schedule(CASES[0], 64)
    assert (s.n_q, s.n_k, s.n_items, s.halves) == (64, 64, 2048, 1)
    assert s.workspace_shape(64) == (32, 64, 64, 68)
    assert s.n_counters == 1 + 32 * 64
    # the wrapper sizes the launch from the same helper, shapes alone
    assert VarlenBwdSchedule.launch_sizes(4096, 32, 64) == (
        s.workspace_shape(64), s.n_counters)
    # (query tile, key tile) steps per KV head at G = 1, against 298 of
    # 128-key tiles (which carry a dead half on about one step in ten)
    assert sum(len(s.walk(j)) for j in range(s.n_k)) == 535
    wide = _schedule(CASES[0], 128)
    assert sum(len(wide.walk(j)) for j in range(wide.n_k)) == 298
    # GQA 32/8 with the window (D = 128): 128-key CTAs on two warpgroups
    g = _schedule(CASES[3], 128)
    assert g.group == 4 and g.halves == 2 and g.item(9) == (1, 1)
