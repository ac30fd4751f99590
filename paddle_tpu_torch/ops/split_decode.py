"""The split plan of the decode attention kernels K2 and K5
(``csrc/split_decode.cuh``) and the scratch their in-kernel merge uses.

Each CTA of the kernel takes one stretch of one sequence for one KV head.
The plan sizes the stretch on the host from the launch's shapes alone:
the number of (sequence, KV head) pairs and the table's reach (table
width times block size for a paged pool, ``S_max`` for a contiguous
cache). It never reads ``seq_lens``, which lives on the card and would
cost a sync. At a small B x HK the stretches are short, so that a few
long sequences still spread over the card; at a large B x HK they are
long, so that each pair takes few CTAs and its merge stays small.
:class:`DecodeSplits` states which tokens each CTA reads; the kernel
follows it and ``tests/test_torch_decode_splits.py`` rehearses it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

__all__ = ["DecodeSplits", "plan", "plan_for", "workspace", "STRETCH_UNIT",
           "MIN_STRETCH", "MAX_STRETCH", "MAX_SPLITS"]

STRETCH_UNIT = 64     # a stretch is a multiple of this (one bf16 ring stage)
# the shortest planned stretch: shorter ones cost more in each CTA's fixed
# latency and in the merge than they gain in spread
MIN_STRETCH = 128
MAX_STRETCH = 2048    # tokens of one CTA (the kernel's shared row table)
MAX_SPLITS = 256      # CTAs of one pair (the kernel's shared merge table)
# a CTA streams at most this many K and V bytes, unless the reach needs
# longer stretches to stay within MAX_SPLITS
STRETCH_BYTES = 256 * 1024
# CTAs the plan aims for per SM when every sequence fills the reach
CTAS_PER_SM = 8


@dataclass(frozen=True)
class DecodeSplits:
    """``nsplit`` stretches of ``stretch`` tokens cover the reach; split
    ``s`` of a sequence of ``length`` live tokens takes positions
    ``[s * stretch, min((s + 1) * stretch, length))``."""

    stretch: int
    nsplit: int

    def live(self, length: int) -> int:
        """Splits that hold a token of a sequence of ``length`` tokens
        (already clipped to the reach); the last of them to finish
        merges them in split order."""
        return max(0, -(-length // self.stretch))

    def span(self, split: int, length: int):
        """The positions ``(t0, t1)`` split ``split`` reads, or None when
        it holds no token (its CTA exits at once; with ``length <= 0``
        split 0 writes the zero rows)."""
        if split >= self.live(length):
            return None
        t0 = split * self.stretch
        return t0, min(t0 + self.stretch, length)


def plan(pairs: int, reach: int, row_bytes: int, num_sms: int):
    """The stretch and split count for ``pairs`` (sequence, KV head)
    pairs over a reach of ``reach`` tokens, ``row_bytes`` the bytes of
    one token's K and V rows of one head. A pure function of the shapes:
    the grid is ``(nsplit, pairs)``."""
    unit = STRETCH_UNIT
    reach = max(int(reach), 1)
    cap = max(unit, min(MAX_STRETCH, STRETCH_BYTES // row_bytes // unit
                        * unit))
    want = -(-pairs * reach // (CTAS_PER_SM * num_sms))
    stretch = min(max(MIN_STRETCH, -(-want // unit) * unit), cap,
                  -(-reach // unit) * unit)
    # a reach beyond cap * MAX_SPLITS takes longer stretches
    stretch = max(stretch, -(-reach // (MAX_SPLITS * unit)) * unit)
    if stretch > MAX_STRETCH:
        raise ValueError(f"a reach of {reach} tokens exceeds the decode "
                         f"kernel's {MAX_SPLITS * MAX_STRETCH}")
    return DecodeSplits(stretch, -(-reach // stretch))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# device index -> int32 tickets, zero between launches (each launch
# leaves them zero); shared by the launches of one stream at a time
_TICKETS = {}


def workspace(splits: DecodeSplits, pairs: int, group: int, d: int,
              device):
    """The scratch of one launch as device pointers (part_o, part_ml,
    tickets) and the tensor that holds the partials: the f32 partials
    of the splits (none when one split covers the reach), then the
    pairs' tickets."""
    n = pairs * splits.nsplit * group if splits.nsplit > 1 else 0
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    tickets = _TICKETS.get(device.index)
    if tickets is None or tickets.numel() < pairs:
        tickets = torch.zeros(max(pairs, 1024), dtype=torch.int32,
                              device=device)
        _TICKETS[device.index] = tickets
    base = part.data_ptr()
    return (base, base + 4 * n * d, tickets.data_ptr()), part


@functools.lru_cache(maxsize=256)
def _plan_on(pairs, reach, row_bytes, index):
    return plan(pairs, reach, row_bytes, _sm_count(index))


def plan_for(pairs: int, reach: int, row_bytes: int, device):
    """:func:`plan` with the SM count of ``device`` (cached: the wrapper
    plans every call)."""
    return _plan_on(pairs, reach, row_bytes, device.index)
