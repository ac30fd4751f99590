"""Paged KV-cache pool (counterpart of ``paddle_tpu/nlp/paged_cache.py``):
a host-side block allocator over per-layer device pools.

The allocator (free list, per-sequence block tables, refcounts) is plain
host Python and behaves exactly as the reference's, so one sequence of
operations gives the same tables and statistics on both. The device
pools are ``(num_blocks, block_size, HK, D)`` torch tensors, one K and
one V per layer, updated IN PLACE by the serving path (the reference
replaces its immutable arrays instead).

int8 pools (``kv_dtype="int8"``) keep int8 block buffers beside per-row
f32 scale pools.

The content-addressed prefix cache (``prefix_cache=True``) is the
reference's: full token blocks are published into an index keyed by a
chain hash (a block's key folds its parent's, so depth is part of the
key), and every entry keeps its (parent, token tuple) key material, so a
hash collision is verified before it aliases. A new sequence whose prompt
walks a cached chain aliases those blocks into its table
(``attach_prefix``); the first write into a block another holder still
maps copies it first (``make_writable``). The index holds one refcount
per published block, so a cached block outlives its sequences and is
reclaimed (LRU, leaf first) only under allocation pressure and only when
no live sequence maps it.

The copy-on-write copies IN PLACE: the shared block's K and V rows (and
an int8 pool's scale rows) are copied into the fresh block of the same
tensors on the current stream, so no pool tensor is ever replaced. A
captured decode graph keeps the pools' addresses, and a copy enqueued
before a replay on the same stream is seen by it.

The resilience tier's hooks are the reference's: ``fault_hook`` fires in
``_alloc_block`` before a block leaves the free list (seeded allocation
failures); ``kv_checksums`` arms the content verify, a crc32 of each
published block's layer-0 K rows (and an int8 pool's scale rows) checked
again before an attach aliases it, whose first mismatch quarantines that
entry's subtree (``quarantine_prefix``); ``rebuild_accounting`` rebuilds
the refcounts and the free list from the live tables after drift. A
checksum reads one block to the host, a device sync on each publish and
attach, and only when ``kv_checksums`` is on. No pool tensor is ever
replaced. The reference's mesh layout is not ported (ROADMAP A7).
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["PagedKVCachePool", "prompt_prefix_key"]

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK64 = (1 << 64) - 1


def _chain_hash(parent_hash, tokens):
    """Rolling FNV-1a over one block's token ids, seeded by the parent
    block's chain hash: the same content at another prefix depth hashes
    differently. A hit is still verified against the stored key material
    before any alias."""
    h = (int(parent_hash) ^ _FNV_OFFSET) & _MASK64
    for t in tokens:
        h ^= int(t) & 0xFFFFFFFF
        h = (h * _FNV_PRIME) & _MASK64
    return h


def prompt_prefix_key(tokens, block_size, max_blocks=None):
    """The content address of a prompt's leading FULL blocks: the chain
    key :class:`PagedKVCachePool`'s index stores for the same tokens
    (chained from parent hash 0 over each full ``block_size`` slice; the
    trailing partial block never enters it). ``max_blocks`` caps the walk.
    Returns the final 64-bit chain hash, or ``None`` when the prompt has
    no full block."""
    bs = int(block_size)
    if bs <= 0:
        raise ValueError(f"block_size must be positive, got {bs}")
    n = len(tokens) // bs
    if max_blocks is not None:
        n = min(n, int(max_blocks))
    if n <= 0:
        return None
    h = 0
    for i in range(n):
        h = _chain_hash(h, tuple(int(t) for t in tokens[i * bs:(i + 1) * bs]))
    return h


class _PrefixEntry:
    """One published full block, a node of the prefix-chain trie. The
    index holds ONE refcount on ``block`` while the entry lives; the
    ``parent`` entry and the token tuple are the key material verified
    behind the chain hash."""

    __slots__ = ("hash", "parent", "tokens", "block", "nchildren", "tick")

    def __init__(self, hash_, parent, tokens, block, tick):
        self.hash = hash_
        self.parent = parent
        self.tokens = tokens
        self.block = block
        self.nchildren = 0
        self.tick = tick


class PagedKVCachePool:
    """A shared K/V block pool + per-sequence block tables.

    Args:
        num_blocks: pool capacity in blocks (shared by all sequences).
        block_size: tokens per block.
        num_kv_heads, head_dim, num_layers: cache geometry.
        dtype: cache dtype (bf16 for serving).
        kv_dtype: ``"int8"`` makes the block buffers int8 and adds
            per-layer scale pools ``k_scales`` / ``v_scales`` of shape
            (num_blocks, block_size, num_kv_heads) f32: one abs-max
            scale per written KV row, written beside the row and read
            by the attention's dequant. ``None`` keeps float pools.
        prefix_cache: turn on the content-addressed prefix index
            (``attach_prefix`` / ``publish_prefix`` / ``make_writable``);
            off by default, when the pool behaves as an unshared one.
        device: where the pools live (default ``cuda``; raises without
            CUDA unless ``"cpu"`` is asked for).
    """

    def __init__(self, num_blocks, block_size, num_kv_heads, head_dim,
                 num_layers=1, dtype=torch.bfloat16, prefix_cache=False,
                 kv_dtype=None, device=None):
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"unsupported kv_dtype {kv_dtype!r} (None or 'int8')")
        self.kv_dtype = kv_dtype
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.num_kv_heads = int(num_kv_heads)
        self.head_dim = int(head_dim)
        self.num_layers = int(num_layers)
        self.device = resolve_device(device)
        shape = (self.num_blocks, self.block_size, self.num_kv_heads,
                 self.head_dim)
        pool_dtype = torch.int8 if self.quantized else dtype
        self.k_pools = [torch.zeros(shape, dtype=pool_dtype,
                                    device=self.device)
                        for _ in range(self.num_layers)]
        self.v_pools = [torch.zeros(shape, dtype=pool_dtype,
                                    device=self.device)
                        for _ in range(self.num_layers)]
        self.k_scales, self.v_scales = [], []
        if self.quantized:
            sshape = shape[:3]
            self.k_scales = [torch.zeros(sshape, dtype=torch.float32,
                                         device=self.device)
                             for _ in range(self.num_layers)]
            self.v_scales = [torch.zeros(sshape, dtype=torch.float32,
                                         device=self.device)
                             for _ in range(self.num_layers)]
        self._free = list(range(self.num_blocks - 1, -1, -1))
        self._tables: dict = {}     # seq_id -> list[int] block ids
        self._lens: dict = {}       # seq_id -> int tokens
        self._refcounts: dict = {}  # block id -> holders (>= 1 while out)
        self._peak_blocks = 0       # high-water mark of blocks_in_use
        self._freed_total = 0       # blocks returned over the pool's life
        # the content-addressed prefix index (enable_prefix_cache)
        self._prefix_enabled = False
        self._prefix_buckets: dict = {}  # chain hash -> [_PrefixEntry]
        self._cached_blocks: dict = {}   # block id -> its entry
        self._prefix_tick = 0            # LRU clock of the eviction
        self.prefix_hits = 0             # blocks served from the index
        self.prefix_misses = 0           # full blocks that had to be built
        self.cow_copies = 0              # copy-on-write block copies
        self.prefix_aliases = 0          # blocks the index aliased
        self.prefix_evictions = 0        # entries reclaimed or cleared
        # the resilience tier: the injector's allocation hook, the content
        # verify of cached blocks and the counters of its recoveries
        self.fault_hook = None
        self.kv_checksums = False
        self._block_crcs: dict = {}      # block id -> publish-time crc
        self.prefix_quarantines = 0      # entries dropped by the verify
        self.accounting_rebuilds = 0
        if prefix_cache:
            self.enable_prefix_cache()

    @property
    def quantized(self):
        """True when the block buffers are int8 beside per-row scale
        pools."""
        return self.kv_dtype == "int8"

    # -- allocator ---------------------------------------------------------
    def _alloc_block(self):
        """Pop one free block, reclaiming a cached-only prefix block (LRU)
        when the free list is dry. The block is born refcounted, so a
        stats snapshot taken in the middle of a copy-on-write never sees
        an allocated but untracked block. A raising ``fault_hook`` fires
        before any state changes, so the caller can retry."""
        if self.fault_hook is not None:
            self.fault_hook(self)
        if not self._free:
            self.evict_prefix(1)
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
        dispatch (K quanta ahead; admission reserved the request's worst
        case), copy-on-write the range ``[written_tokens, need_tokens)``
        the dispatch will write when ``cow``, and return the padded host
        int32 row the dispatch stages."""
        if need_tokens > self.seq_len(seq_id):
            self.ensure(seq_id, need_tokens)
        if cow:
            self.make_writable(seq_id, int(written_tokens), int(need_tokens))
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

    # -- content-addressed prefix cache ------------------------------------
    def enable_prefix_cache(self):
        """Turn on the prefix index (off by default: an unshared pool never
        walks the index or copies a block)."""
        self._prefix_enabled = True

    @property
    def prefix_cache_enabled(self):
        return self._prefix_enabled

    @property
    def cached_blocks(self):
        """Blocks the prefix index holds (resident; reclaimable once no
        live sequence maps them)."""
        return len(self._cached_blocks)

    def _full_blocks(self, tokens):
        return len(tokens) // self.block_size

    def _block_tokens(self, tokens, i):
        bs = self.block_size
        return tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def _find(self, h, parent, blk_toks):
        """The verified entry under chain hash ``h``: a hash match alone
        never aliases, the parent entry and the token tuple must match."""
        for e in self._prefix_buckets.get(h, ()):
            if e.parent is parent and e.tokens == blk_toks:
                return e
        return None

    def _match_entries(self, tokens, max_blocks=None):
        """The longest verified entry chain over ``tokens``' full
        blocks."""
        if not self._prefix_enabled:
            return []
        n = self._full_blocks(tokens)
        if max_blocks is not None:
            n = min(n, int(max_blocks))
        entries, parent, h = [], None, 0
        for i in range(n):
            blk_toks = self._block_tokens(tokens, i)
            h = _chain_hash(h, blk_toks)
            hit = self._find(h, parent, blk_toks)
            if hit is None:
                break
            entries.append(hit)
            parent = hit
        return entries

    def match_prefix(self, tokens):
        """Cached tokens a new sequence with this prompt could alias (a
        whole number of full blocks; 0 when the cache is off or cold)."""
        return len(self._match_entries(tokens)) * self.block_size

    def prefix_match_stats(self, tokens, max_blocks=None):
        """What a lookup would alias, and how many of those blocks are
        evictable now (the index their sole holder): attaching pins them,
        so the scheduler's novel-demand check takes them out of the
        reclaimable set."""
        entries = self._match_entries(tokens, max_blocks=max_blocks)
        ev = sum(1 for e in entries if self._refcounts.get(e.block) == 1)
        return {"matched_blocks": len(entries),
                "matched_tokens": len(entries) * self.block_size,
                "evictable": ev}

    def attach_prefix(self, seq_id, tokens, max_blocks=None):
        """Alias the longest cached chain of ``tokens``' full blocks into
        a NEW table for ``seq_id`` (refcounts bumped; the sequence starts
        that many tokens deep). Returns the aliased token count and counts
        the lookup (hits: aliased blocks; misses: the prompt's other full
        blocks), so call it once per admission, cold cache included."""
        if not self._prefix_enabled:
            return 0
        if seq_id in self._tables:
            raise ValueError(f"sequence {seq_id!r} already exists")
        entries = self._match_entries(tokens, max_blocks=max_blocks)
        if self.kv_checksums:
            entries = self._verify_entries(entries)
        self.prefix_hits += len(entries)
        self.prefix_misses += max(self._full_blocks(tokens) - len(entries),
                                  0)
        if not entries:
            return 0
        self._prefix_tick += 1
        for e in entries:
            self._refcounts[e.block] += 1
            e.tick = self._prefix_tick
        self._tables[seq_id] = [e.block for e in entries]
        self._lens[seq_id] = len(entries) * self.block_size
        self.prefix_aliases += len(entries)
        return len(entries) * self.block_size

    def publish_prefix(self, seq_id, tokens):
        """Publish ``seq_id``'s written FULL blocks covering ``tokens``
        into the index (at prefill completion, when their KV is in the
        pool). Each new entry holds one refcount on its block. Chain
        positions already indexed keep their entry; a block that already
        backs another entry stops the walk. Returns the number of blocks
        newly published."""
        if not self._prefix_enabled:
            return 0
        table = self._tables.get(seq_id)
        if table is None:
            return 0
        n = min(self._full_blocks(tokens), len(table))
        self._prefix_tick += 1
        parent, h, published = None, 0, 0
        for i in range(n):
            blk_toks = self._block_tokens(tokens, i)
            h = _chain_hash(h, blk_toks)
            hit = self._find(h, parent, blk_toks)
            if hit is None:
                blk = table[i]
                if blk in self._cached_blocks:
                    break
                hit = _PrefixEntry(h, parent, blk_toks, blk,
                                   self._prefix_tick)
                self._prefix_buckets.setdefault(h, []).append(hit)
                self._cached_blocks[blk] = hit
                self._refcounts[blk] += 1
                if parent is not None:
                    parent.nchildren += 1
                if self.kv_checksums:
                    self._block_crcs[blk] = self._block_crc(blk)
                published += 1
            else:
                hit.tick = self._prefix_tick
            parent = hit
        return published

    def _pool_tensors(self):
        """Every device tensor of the pool: K and V, and an int8 pool's
        scale pools."""
        return (*self.k_pools, *self.v_pools, *self.k_scales,
                *self.v_scales)

    def make_writable(self, seq_id, start_token, end_token):
        """Copy-on-write before a forward writes KV at positions
        ``[start_token, end_token)``: every block of that range that
        another holder (a sequence or the index) still maps is replaced in
        ``seq_id``'s table by a fresh block holding a copy of its rows,
        and the shared block is decref'd. The copy runs in place on the
        current stream, layer by layer: K and V rows, and an int8 pool's
        scale rows (a block's content, without which the writer's new
        scales would corrupt the sharer's dequantized values). Returns the
        number of blocks copied."""
        table = self._tables.get(seq_id)
        if not table or end_token <= start_token:
            return 0
        bs = self.block_size
        lo = max(int(start_token) // bs, 0)
        hi = min((int(end_token) - 1) // bs, len(table) - 1)
        copies = 0
        for j in range(lo, hi + 1):
            blk = table[j]
            if self._refcounts.get(blk, 1) <= 1:
                continue
            fresh = self._alloc_block()
            for t in self._pool_tensors():
                t[fresh].copy_(t[blk])
            table[j] = fresh
            self._release([blk])
            copies += 1
            self.cow_copies += 1
        if copies:
            self._peak_blocks = max(self._peak_blocks, self.blocks_in_use)
        return copies

    def evictable_prefix_blocks(self):
        """Cached blocks reclaimable now: the index their sole holder."""
        return sum(1 for b in self._cached_blocks
                   if self._refcounts.get(b) == 1)

    def _drop_entry(self, e):
        bucket = self._prefix_buckets.get(e.hash, [])
        bucket.remove(e)
        if not bucket:
            self._prefix_buckets.pop(e.hash, None)
        if e.parent is not None:
            e.parent.nchildren -= 1
        del self._cached_blocks[e.block]
        self._block_crcs.pop(e.block, None)
        self._release([e.block])
        self.prefix_evictions += 1

    # -- resilience: the content verify and the recovery from drift --------
    def _block_crc(self, blk):
        """crc32 of one cached block's layer-0 K rows, and on an int8 pool
        of its scale rows too (the same codes under other scales are other
        values). A cached block is immutable (a write copies it first), so
        a mismatch at attach is corruption. Reads the block to the host."""
        rows = self.k_pools[0][blk]
        if rows.dtype == torch.bfloat16:
            rows = rows.view(torch.int16)  # numpy has no bf16: same bytes
        crc = zlib.crc32(rows.cpu().numpy().tobytes())
        if self.quantized:
            crc = zlib.crc32(self.k_scales[0][blk].cpu().numpy().tobytes(),
                             crc)
        return crc

    def _verify_entries(self, entries):
        """Checksum each matched cached block before it is aliased; the
        FIRST mismatch quarantines that entry's whole subtree and cuts the
        match there (the sequence goes on unshared from that depth)."""
        for i, e in enumerate(entries):
            want = self._block_crcs.get(e.block)
            if want is None or self._block_crc(e.block) == want:
                continue
            self.quarantine_prefix(e)
            return entries[:i]
        return entries

    def quarantine_prefix(self, entry):
        """Drop ``entry`` and every descendant from the prefix index, leaves
        first (live sequences that alias the blocks keep their holds; only
        the index's holds release). Returns the entries quarantined."""
        doomed = {id(entry): entry}
        changed = True
        while changed:
            changed = False
            for e in self._cached_blocks.values():
                if id(e) in doomed:
                    continue
                if e.parent is not None and id(e.parent) in doomed:
                    doomed[id(e)] = e
                    changed = True
        remaining = list(doomed.values())
        while remaining:
            leaves = [e for e in remaining if e.nchildren == 0]
            if not leaves:  # chains are trees
                raise RuntimeError("prefix subtree has no leaf")
            for e in leaves:
                self._drop_entry(e)
                remaining.remove(e)
        self.prefix_quarantines += len(doomed)
        return len(doomed)

    def rebuild_accounting(self):
        """Recover from accounting drift: rebuild the refcounts and the
        free list from the LIVE block tables and drop the whole prefix
        index (its holds are forgotten, not released: cached subtrees are
        not trusted after drift). ``_check_accounting`` passes afterwards.
        Returns a summary."""
        counts: dict = {}
        for blocks in self._tables.values():
            for b in blocks:
                counts[b] = counts.get(b, 0) + 1
        dropped_entries = len(self._cached_blocks)
        self._prefix_buckets = {}
        self._cached_blocks = {}
        self._block_crcs = {}
        self._refcounts = dict(counts)
        held = set(counts)
        self._free = [b for b in range(self.num_blocks - 1, -1, -1)
                      if b not in held]
        for s in list(self._lens):
            if s not in self._tables:
                del self._lens[s]
        self.accounting_rebuilds += 1
        return {"held_blocks": len(held),
                "free_blocks": len(self._free),
                "dropped_prefix_entries": dropped_entries}

    def evict_prefix(self, n):
        """Reclaim up to ``n`` cached blocks: LRU over LEAF entries (a
        dropped mid-chain node would orphan its descendants) whose block
        the index alone holds, so a block a live sequence maps is never
        taken. Returns the blocks reclaimed."""
        freed = 0
        while freed < n:
            best = None
            for b, e in self._cached_blocks.items():
                if e.nchildren or self._refcounts.get(b) != 1:
                    continue
                if best is None or e.tick < best.tick:
                    best = e
            if best is None:
                break
            self._drop_entry(best)
            freed += 1
        return freed

    def clear_prefix_cache(self):
        """Release every index hold, leaves first. With the sequences
        freed too, ``free_blocks`` is then ``num_blocks``. Returns the
        entries dropped."""
        dropped = 0
        while self._cached_blocks:
            leaves = [e for e in self._cached_blocks.values()
                      if e.nchildren == 0]
            if not leaves:  # chains are trees
                raise RuntimeError("prefix index has no leaf entries")
            for e in leaves:
                self._drop_entry(e)
                dropped += 1
        return dropped

    def prefix_cache_stats(self):
        """The index's monotonic counters and occupancy (raises on
        accounting drift, as ``fragmentation_stats``)."""
        self._check_accounting()
        return {
            "hits": self.prefix_hits,
            "misses": self.prefix_misses,
            "cow_copies": self.cow_copies,
            "aliased_blocks": self.prefix_aliases,
            "evictions": self.prefix_evictions,
            "cached_blocks": self.cached_blocks,
            "evictable_blocks": self.evictable_prefix_blocks(),
        }

    def _check_accounting(self):
        """Invariants tying the free list, the refcount map, the tables
        and the prefix index together; raises on drift instead of
        publishing wrong numbers."""
        held = set(self._refcounts)
        if len(held) != self.blocks_in_use:
            raise RuntimeError(
                f"pool accounting drift: {self.blocks_in_use} blocks "
                f"out of the free list but {len(held)} refcounted")
        stale = held & set(self._free)
        if stale:
            raise RuntimeError(
                f"blocks {sorted(stale)} are both free and refcounted")
        mapped = set(self._cached_blocks)
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
        """Could a NEW sequence of ``total_tokens`` be allocated now?
        Cached-only prefix blocks count: ``_alloc_block`` evicts them on
        demand."""
        return (self.blocks_needed(total_tokens)
                <= len(self._free) + self.evictable_prefix_blocks())

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
        for blk in self._cached_blocks:
            coverage[blk] = bs  # published blocks are full
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
            "cached_blocks": len(self._cached_blocks),
            "kv_dtype": str(self.k_pools[0].dtype).removeprefix("torch."),
            "bytes_in_use": self.bytes_in_use(),
            "per_chip_bytes_in_use": self.bytes_in_use(),
        }

    def bytes_in_use(self):
        """Live cache bytes: scales with allocated blocks, at the pools'
        element size, plus the scale rows of an int8 pool."""
        per_block = (self.block_size * self.num_kv_heads * self.head_dim
                     * self.k_pools[0].element_size())
        if self.quantized:
            per_block += (self.block_size * self.num_kv_heads
                          * self.k_scales[0].element_size())
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
