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

__all__ = ["DecodeSplits", "plan", "plan_for", "workspace", "ticket_key",
           "tickets_for", "STRETCH_UNIT", "MIN_STRETCH", "MAX_STRETCH",
           "MAX_SPLITS", "MIN_TICKETS"]

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


# the smallest ticket buffer, in int32 tickets (one per pair)
MIN_TICKETS = 1024
# ticket_key(...) -> int32 tickets, zero between launches (each launch
# leaves them zero: the last CTA of a pair resets its ticket)
_TICKETS = {}


def ticket_key(index, stream: int, pairs: int):
    """The key of the ticket buffer a launch of ``pairs`` pairs on the
    stream with handle ``stream`` of device ``index`` counts in: (index,
    stream, capacity), the capacity the least power of two that holds the
    pairs and at least :data:`MIN_TICKETS`. A pure function. Launches
    that can be in flight at once lie on different streams and so never
    share tickets; the launches of one stream run one after another. A
    buffer is made at a key's first use and never replaced, so an address
    a launch (or a captured CUDA graph) took stays valid: a larger launch
    takes a buffer of its own capacity."""
    cap = max(MIN_TICKETS, 1 << (max(int(pairs), 1) - 1).bit_length())
    return (index, int(stream), cap)


def tickets_for(device, stream: int, pairs: int):
    """The zeroed int32 ticket buffer of :func:`ticket_key`, made at its
    first use (make it before a CUDA graph is captured)."""
    key = ticket_key(device.index, stream, pairs)
    tickets = _TICKETS.get(key)
    if tickets is None:
        tickets = torch.zeros(key[2], dtype=torch.int32, device=device)
        _TICKETS[key] = tickets
    return tickets


def workspace(splits: DecodeSplits, pairs: int, group: int, d: int,
              device, stream: int):
    """The scratch of one launch on the stream with handle ``stream`` as
    device pointers (part_o, part_ml, tickets) and the tensor that holds
    the partials: the f32 partials of the splits (none when one split
    covers the reach), allocated per call, and the pairs' tickets
    (:func:`tickets_for`)."""
    n = pairs * splits.nsplit * group if splits.nsplit > 1 else 0
    part = torch.empty(n * (d + 2), dtype=torch.float32, device=device)
    tickets = tickets_for(device, stream, pairs)
    base = part.data_ptr()
    return (base, base + 4 * n * d, tickets.data_ptr()), part


@functools.lru_cache(maxsize=256)
def _plan_on(pairs, reach, row_bytes, index):
    return plan(pairs, reach, row_bytes, _sm_count(index))


def plan_for(pairs: int, reach: int, row_bytes: int, device):
    """:func:`plan` with the SM count of ``device`` (cached: the wrapper
    plans every call)."""
    return _plan_on(pairs, reach, row_bytes, device.index)
