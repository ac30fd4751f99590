"""Paged KV-cache pool (counterpart of ``paddle_tpu/nlp/paged_cache.py``):
a host-side block allocator over per-layer device pools.

The allocator (free list, per-sequence block tables, refcounts) is plain
host Python and behaves exactly as the reference's, so one sequence of
operations gives the same tables and statistics on both. The device
pools are ``(num_blocks, block_size, HK, D)`` torch tensors, one K and
one V per layer, updated IN PLACE by the serving path (the reference
replaces its immutable arrays instead).

This slice ports the allocation and accounting subset. The prefix cache
(``prefix_cache=True``: chain-hash index, copy-on-write, LRU eviction)
and int8 pools (``kv_dtype="int8"``) come with later slices.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["PagedKVCachePool"]


class PagedKVCachePool:
    """A shared K/V block pool + per-sequence block tables.

    Args:
        num_blocks: pool capacity in blocks (shared by all sequences).
        block_size: tokens per block.
        num_kv_heads, head_dim, num_layers: cache geometry.
        dtype: cache dtype (bf16 for serving).
        device: where the pools live (default ``cuda``; raises without
            CUDA unless ``"cpu"`` is asked for).
    """

    def __init__(self, num_blocks, block_size, num_kv_heads, head_dim,
                 num_layers=1, dtype=torch.bfloat16, prefix_cache=False,
                 kv_dtype=None, device=None):
        if prefix_cache:
            raise NotImplementedError(
                "the prefix cache is not ported yet (ROADMAP A5)")
        if kv_dtype is not None:
            raise NotImplementedError(
                f"kv_dtype={kv_dtype!r} pools are not ported yet "
                f"(ROADMAP A9)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.num_layers = int(num_layers)
        self.device = resolve_device(device)
        shape = (self.num_blocks, self.block_size, self.num_kv_heads,
                 self.head_dim)
        self.k_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(self.num_layers)]
        self.v_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(self.num_layers)]
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._tables: dict = {}     # seq_id -> list[int] block ids
        self._lens: dict = {}       # seq_id -> int tokens
        self._refcounts: dict = {}  # block id -> holders (>= 1 while out)
        self._peak_blocks = 0       # high-water mark of blocks_in_use
        self._freed_total = 0       # blocks returned over the pool's life

    # -- allocator ---------------------------------------------------------
    def _alloc_block(self):
        """Pop one free block; it is born refcounted."""
        if not self._free:
            raise RuntimeError(
                f"KV pool exhausted ({self.num_blocks} blocks)")
        blk = self._free.pop()
        self._refcounts[blk] = 1
        return blk

    def ensure(self, seq_id, new_total_tokens):
        """Grow ``seq_id``'s block table to cover ``new_total_tokens``."""
        table = self._tables.setdefault(seq_id, [])
        need = -(-int(new_total_tokens) // self.block_size)
        while len(table) < need:
            table.append(self._alloc_block())
        self._lens[seq_id] = max(self._lens.get(seq_id, 0),
                                 int(new_total_tokens))
        self._peak_blocks = max(self._peak_blocks, self.blocks_in_use)
        return table

    def grow_decode_table(self, seq_id, need_tokens, written_tokens,
                          pad_to=None, cow=False):
        """Grow ``seq_id``'s table to cover ``need_tokens`` before a decode
        dispatch and return its padded host int32 row. ``written_tokens``
        and ``cow`` serve the prefix cache's copy-on-write, which is not
        ported yet."""
        if cow:
            raise NotImplementedError(
                "copy-on-write needs the prefix cache (ROADMAP A5)")
        if need_tokens > self.seq_len(seq_id):
            self.ensure(seq_id, need_tokens)
        return self.block_table_array([seq_id], pad_to=pad_to)[0]

    def share(self, src_seq_id, dst_seq_id):
        """Alias ``src``'s blocks into a new table for ``dst`` with the
        refcounts bumped: a shared block returns to the free list only
        when its LAST holder releases it."""
        if dst_seq_id in self._tables:
            raise ValueError(f"sequence {dst_seq_id!r} already exists")
        src = self._tables.get(src_seq_id)
        if src is None:
            raise KeyError(f"unknown sequence {src_seq_id!r}")
        for blk in src:
            self._refcounts[blk] += 1
        self._tables[dst_seq_id] = list(src)
        self._lens[dst_seq_id] = self._lens.get(src_seq_id, 0)
        return self._tables[dst_seq_id]

    def _check_accounting(self):
        """Invariants tying the free list, the refcount map and the tables
        together; raises on drift instead of publishing wrong numbers."""
        held = set(self._refcounts)
        if len(held) != self.blocks_in_use:
            raise RuntimeError(
                f"pool accounting drift: {self.blocks_in_use} blocks "
                f"out of the free list but {len(held)} refcounted")
        stale = held & set(self._free)
        if stale:
            raise RuntimeError(
                f"blocks {sorted(stale)} are both free and refcounted")
        mapped = set()
        for table in self._tables.values():
            mapped.update(table)
        untracked = mapped - held
        if untracked:
            raise RuntimeError(
                f"mapped blocks {sorted(untracked)} missing from the "
                f"refcount map")

    def _release(self, blocks):
        """Refcount-safe return path shared by free/trim; releasing a block
        the pool does not hold is a double free and raises."""
        for blk in blocks:
            n = self._refcounts.get(blk)
            if n is None:
                raise RuntimeError(
                    f"block {blk} released but not held — double free")
            if n > 1:
                self._refcounts[blk] = n - 1
            else:
                del self._refcounts[blk]
                self._free.append(blk)
                self._freed_total += 1

    def free(self, seq_id):
        """Release a finished (or evicted) sequence's hold on its blocks
        (LIFO free list: straight to the next admission)."""
        blocks = self._tables.pop(seq_id, [])
        self._release(blocks)
        self._lens.pop(seq_id, None)

    def trim(self, seq_id, new_total_tokens):
        """Shrink a live sequence to ``new_total_tokens``, releasing its
        now-unused tail blocks; returns them."""
        table = self._tables.get(seq_id)
        if table is None:
            return []
        keep = -(-int(new_total_tokens) // self.block_size)
        released = table[keep:]
        del table[keep:]
        self._release(released)
        self._lens[seq_id] = min(self._lens.get(seq_id, 0),
                                 int(new_total_tokens))
        return released

    def blocks_needed(self, total_tokens):
        """Blocks a sequence of ``total_tokens`` occupies."""
        return -(-int(total_tokens) // self.block_size)

    def can_allocate(self, total_tokens):
        """Could a NEW sequence of ``total_tokens`` be allocated now?"""
        return self.blocks_needed(total_tokens) <= len(self._free)

    def seq_len(self, seq_id):
        return self._lens.get(seq_id, 0)

    def held_blocks(self, seq_id):
        return len(self._tables.get(seq_id, ()))

    @property
    def blocks_in_use(self):
        return self.num_blocks - len(self._free)

    @property
    def free_blocks(self):
        return len(self._free)

    def fragmentation_stats(self):
        """Allocator health counters, the reference's keys: internal tail
        waste, utilization (live tokens over allocated capacity), peak
        and freed counts, and bytes in use. A block shared by several
        sequences counts once, at the largest coverage any holder has."""
        self._check_accounting()
        bs = self.block_size
        coverage: dict = {}
        for s, table in self._tables.items():
            length = self._lens.get(s, 0)
            for j, blk in enumerate(table):
                c = min(bs, max(length - j * bs, 0))
                if c > coverage.get(blk, 0):
                    coverage[blk] = c
        live = sum(coverage.values())
        cap = self.blocks_in_use * self.block_size
        shared = sum(1 for n in self._refcounts.values() if n > 1)
        return {
            "num_blocks": self.num_blocks,
            "blocks_in_use": self.blocks_in_use,
            "free_blocks": len(self._free),
            "peak_blocks_in_use": self._peak_blocks,
            "blocks_freed_total": self._freed_total,
            "live_tokens": live,
            "tail_waste_tokens": cap - live,
            "utilization": (live / cap) if cap else 1.0,
            "shared_blocks": shared,
            "cached_blocks": 0,
            "kv_dtype": str(self.k_pools[0].dtype).removeprefix("torch."),
            "bytes_in_use": self.bytes_in_use(),
            "per_chip_bytes_in_use": self.bytes_in_use(),
        }

    def bytes_in_use(self):
        """Live cache bytes: scales with allocated blocks."""
        per_block = (self.block_size * self.num_kv_heads * self.head_dim
                     * self.k_pools[0].element_size())
        return 2 * self.num_layers * self.blocks_in_use * per_block

    # -- host views --------------------------------------------------------
    def block_table_array(self, seq_ids, pad_to=None):
        """(B, max_blocks) int32 host table for the given sequences (dead
        entries 0; they are masked by the sequence lengths)."""
        tables = [self._tables.get(s, []) for s in seq_ids]
        width = max([len(t) for t in tables] + [1])
        if pad_to:
            width = max(width, pad_to)
        out = np.zeros((len(tables), width), np.int32)
        for i, t in enumerate(tables):
            out[i, : len(t)] = t
        return out

    def seq_lens_array(self, seq_ids):
        return np.asarray([self._lens.get(s, 0) for s in seq_ids], np.int32)
