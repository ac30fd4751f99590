"""Request state + admission scheduling for the continuous-batching
engine: a copy of ``paddle_tpu/serving/scheduler.py`` (numpy only), kept in
the port so that importing it never imports the JAX package. Behaviour is
identical; only docstrings differ.

Pure host-side bookkeeping: a priority admission queue (FIFO within a
priority class, strict priority across classes), a fixed table of
``num_slots`` serving slots, and conservative block accounting against
the shared :class:`~paddle_tpu_torch.nlp.paged_cache.PagedKVCachePool` —
a request is admitted only when its WORST-CASE block demand
(``ceil((prompt + max_new) / block_size)``) fits under the pool capacity
left unreserved by in-flight requests, so the pool can never exhaust
mid-decode. Preemption evicts a live request and requeues it at the head
of its class as a longer prompt (recompute-on-resume). With the pool's
prefix cache on (``prefix_cache=True``), admission aliases the longest
cached chain of the prefill source into the request's table
(``_attach``) and the fit check counts only NOVEL block demand: each live
request's remaining growth and pending copy-on-write debt, and the
candidate's ``demand - matched``, against the free list plus what prefix
eviction can reclaim (``_fits``). With the cache off the check is the
static worst-case reservation.
"""
from __future__ import annotations

from collections import deque

import numpy as np

__all__ = ["Request", "SchedulerConfig", "Scheduler"]


class Request:
    """One generation request riding the engine.

    Lifecycle: ``waiting`` (queued) -> ``prefill`` (admitted to a slot,
    prompt entering the pool chunk by chunk) -> ``decode`` (in the
    jitted quantum) -> ``finished`` (eos | stop | max_new; blocks
    freed). A PREEMPTED request cycles back to ``waiting`` with its
    emitted tokens appended to the prefill source (``begin_resume``),
    so resume is re-admission of a longer prompt.

    Per-request generation params (the front door's knobs, all applied
    at host boundaries or through existing per-slot device state):

    - ``seed``: per-slot PRNG key for the sampling arm (existing).
    - ``max_new_tokens``: per-slot retirement bound (existing).
    - ``temperature``: per-slot logits scale — requires an engine built
      with ``per_request_sampling=True`` (the per-slot temperature
      array is an input of the front-door quantum variant).
    - ``stop_token_ids`` / ``stop_sequences``: host-side stop rules
      checked as tokens are appended (``finish_reason == "stop"``; the
      device mask keeps the slot riding until the quantum boundary,
      exactly like the truncate-at-eos convention).
    - ``priority``: admission class (see serving/policy.py —
      BATCH < NORMAL < INTERACTIVE); higher admits first and may
      preempt strictly-lower classes under pool pressure.
    """

    def __init__(self, prompt, max_new_tokens=32, req_id=None, seed=0,
                 arrival_time=0.0, priority=1, temperature=None,
                 stop_token_ids=None, stop_sequences=None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        self.req_id = req_id
        self.seed = int(seed)
        self.arrival_time = float(arrival_time)
        self.priority = int(priority)
        self.temperature = (None if temperature is None
                            else float(temperature))
        self.stop_token_ids = frozenset(
            int(t) for t in (stop_token_ids or ()))
        self.stop_sequences = [
            [int(t) for t in s] for s in (stop_sequences or ()) if s]
        # mutable state
        self.slot = None
        self.prefill_pos = 0          # prefill tokens already in the pool
        self.prefill_target = self.prompt_len
        self._prefill_src = self.prompt
        self.cached_prefix_tokens = 0  # tokens aliased from the prefix
        # cache at this admission (prefill skips them — the TTFT win)
        self.preemptions = 0
        self.tokens: list = []        # generated token ids (incl. eos)
        self.finished = False
        self.finish_reason = None     # "eos" | "stop" | "length" |
        #   "shed" (refused admission) | "error" (quarantined/failed)
        self.admit_time = None
        self.first_token_time = None
        self.finish_time = None

    @property
    def prompt_len(self):
        return int(self.prompt.shape[0])

    @property
    def prefill_src(self):
        """The token row prefill pushes through the pool: the prompt,
        or prompt + emitted tokens after a preemption (recompute-on-
        resume re-prefills the evicted KV and the continuation token
        falls out of the final position's logits)."""
        return self._prefill_src

    @property
    def prefilling(self):
        return (self.slot is not None
                and self.prefill_pos < self.prefill_target)

    @property
    def decoding(self):
        return (self.slot is not None and not self.finished
                and self.prefill_pos >= self.prefill_target)

    def begin_resume(self):
        """Reset to the waiting state after an eviction: the next
        admission re-prefills ``prompt + tokens`` from position 0 (the
        emitted stream itself is untouched — the continuation must be
        bit-exact vs an undisturbed run)."""
        self.preemptions += 1
        self.slot = None
        self.prefill_pos = 0
        self.cached_prefix_tokens = 0  # re-admission re-attaches
        if self.tokens:
            self._prefill_src = np.concatenate(
                [self.prompt, np.asarray(self.tokens, np.int32)])
        self.prefill_target = int(self._prefill_src.shape[0])

    def _hits_stop(self):
        if self.tokens and self.tokens[-1] in self.stop_token_ids:
            return True
        for s in self.stop_sequences:
            if len(self.tokens) >= len(s) \
                    and self.tokens[-len(s):] == s:
                return True
        return False

    def record(self, token, eos_token_id=None):
        """Append one emitted token and apply the retirement rule the
        device mask uses (eos emitted, or max_new reached) plus the
        host-side per-request stop rules. Returns True while the
        request stays live."""
        if self.finished:
            return False
        self.tokens.append(int(token))
        if eos_token_id is not None and int(token) == int(eos_token_id):
            self.finished = True
            self.finish_reason = "eos"
        elif self._hits_stop():
            self.finished = True
            self.finish_reason = "stop"
        elif len(self.tokens) >= self.max_new_tokens:
            self.finished = True
            self.finish_reason = "length"
        return not self.finished


class SchedulerConfig:
    """Engine/scheduler knobs.

    num_slots: fixed capacity of the padded active set (the decode
        quantum is compiled once for this batch).
    prefill_chunk: max prompt tokens a new arrival pushes through the
        mixed batch per step (chunked prefill keeps admission latency
        bounded while in-flight slots keep decoding).
    decode_quantum: decode steps per jitted dispatch; the host scheduler
        only runs (admit/retire) at quantum boundaries.
    """

    def __init__(self, num_slots=8, prefill_chunk=64, decode_quantum=8):
        self.num_slots = int(num_slots)
        self.prefill_chunk = int(prefill_chunk)
        self.decode_quantum = int(decode_quantum)
        if self.num_slots < 1 or self.prefill_chunk < 1 \
                or self.decode_quantum < 1:
            raise ValueError("all SchedulerConfig knobs must be >= 1")


class Scheduler:
    """Admission queue + slot table + block reservations.

    ``companion_pools`` are additional pools every admitted request also
    occupies (the speculative engine's DRAFT KV pool); they must share
    the main pool's block size, and capacity is gated on the TIGHTEST
    pool. ``token_margin`` widens the worst-case demand by a per-request
    token slack — the speculative verify step writes up to ``gamma``
    proposal slots past the accepted history, so admission must reserve
    the blocks those writes can touch."""

    def __init__(self, config, pool, reserved_blocks=0,
                 companion_pools=(), token_margin=0):
        self.config = config
        self.pool = pool
        self.companion_pools = [p for p in companion_pools
                                if p is not None]
        for p in self.companion_pools:
            if p.block_size != pool.block_size:
                raise ValueError(
                    f"companion pool block_size {p.block_size} != main "
                    f"pool {pool.block_size}: one demand number must "
                    f"cover every pool")
        self.token_margin = int(token_margin)
        # requests admitted with their whole prompt cached still owe one
        # future COW allocation per pool (the capped re-prefill of the
        # final prompt token writes into the tail shared block); the
        # dynamic fit check carries the debt until the engine clears it
        self._cow_debt = {}  # req -> blocks its pending COW may allocate
        self.waiting = deque()
        self.slots = [None] * config.num_slots
        # blocks permanently unavailable to requests (engine scratch)
        self._base_reserved = int(reserved_blocks)
        self._reservations = {}  # req -> worst-case block count
        self.admitted_total = 0
        self.finished_total = 0
        self.preempted_total = 0
        self.resumed_total = 0
        self._submitted_total = 0  # monotonic req_id source (a derived
        # id like admitted+waiting can repeat once preemption requeues)

    # -- queue -------------------------------------------------------------
    def submit(self, request):
        if request.req_id is None:
            request.req_id = f"req{self._submitted_total}"
        self._submitted_total += 1
        self.waiting.append(request)
        return request

    def _demand(self, req):
        return self.pool.blocks_needed(
            req.prompt_len + req.max_new_tokens + self.token_margin)

    # -- prefix-cache-aware admission --------------------------------------
    @property
    def _prefix_on(self):
        return getattr(self.pool, "prefix_cache_enabled", False)

    def _all_pools(self):
        return [self.pool] + self.companion_pools

    def _match_blocks(self, req):
        """Full blocks EVERY pool can alias for ``req``'s prefill source
        — the min across pools, so the draft pool attaches in LOCKSTEP
        with the target pool and the engine's shared per-slot sequence
        length stays consistent."""
        if not self._prefix_on:
            return 0
        return min(p.prefix_match_stats(req.prefill_src)["matched_blocks"]
                   for p in self._all_pools())

    def _cow_allowance(self, req, m_blocks):
        """Blocks ``req``'s pending copy-on-write may still allocate in
        each pool: 1 when the cached prefix covers the whole prefill
        source (the engine caps ``prefill_pos`` one token short, and
        re-prefilling that token COWs the tail shared block), else 0 —
        every other write lands in a fresh block by construction."""
        return 1 if (m_blocks and m_blocks * self.pool.block_size
                     >= req.prefill_target) else 0

    def clear_cow_debt(self, req):
        """The engine calls this once ``req``'s prefill completes — any
        COW its admission could trigger has happened (or never will),
        so the debt stops inflating the dynamic fit check."""
        self._cow_debt.pop(req, None)

    def _fits(self, req, need):
        """Would ``req``'s admission keep every pool exhaustion-free in
        the worst case?

        Cache OFF: the static reservation check (worst-case demand of
        every in-flight request, pre-reserved) — byte-for-byte the
        pre-prefix-cache behavior.

        Cache ON: per-pool NOVEL-demand check. Each live request can
        still allocate at most ``demand - held`` fresh blocks (its
        table only grows toward its worst case; shared blocks it
        already maps are in ``held``) plus its pending COW debt; the
        candidate allocates ``need - matched`` fresh blocks plus its
        own COW allowance. All of that must fit in what the pool can
        produce: the free list plus cached-only blocks eviction can
        reclaim — MINUS the matched evictable blocks this admission is
        about to pin (attach bumps them to refcount 2)."""
        if not self._prefix_on:
            return self.reserved_blocks + need <= self._capacity
        m = self._match_blocks(req)
        cow_new = self._cow_allowance(req, m)
        for p in self._all_pools():
            growth = sum(
                max(0, dem - p.held_blocks(r.req_id))
                for r, dem in self._reservations.items())
            debt = sum(self._cow_debt.get(r, 0)
                       for r in self._reservations)
            pinned = p.prefix_match_stats(
                req.prefill_src, max_blocks=m)["evictable"]
            avail = (p.free_blocks + p.evictable_prefix_blocks()
                     - pinned - self._base_reserved
                     + p.held_blocks("__scratch__"))
            if growth + debt + (need - m + cow_new) > avail:
                return False
        return True

    def _attach(self, req):
        """Alias the cached prefix into ``req``'s fresh tables in every
        pool (same block count everywhere — lockstep) and record how
        many prompt tokens prefill may now skip."""
        if not self._prefix_on:
            return 0
        m = self._match_blocks(req)
        cached = 0
        for p in self._all_pools():
            cached = p.attach_prefix(req.req_id, req.prefill_src,
                                     max_blocks=m)
        req.cached_prefix_tokens = int(cached)
        allowance = self._cow_allowance(req, m)
        if allowance:
            self._cow_debt[req] = allowance
        return cached

    @property
    def reserved_blocks(self):
        return self._base_reserved + sum(self._reservations.values())

    @property
    def _capacity(self):
        """Blocks the TIGHTEST pool offers — with a companion (draft)
        pool, a request only admits when it fits in every pool."""
        return min([self.pool.num_blocks]
                   + [p.num_blocks for p in self.companion_pools])

    def next_waiting(self):
        """The request admission would try next: the OLDEST request of
        the HIGHEST priority class present (stable within a class —
        FIFO per priority, strict priority across classes). None when
        the queue is empty."""
        best = None
        for r in self.waiting:
            if best is None or r.priority > best.priority:
                best = r
        return best

    def can_admit(self, req):
        """Would ``req`` be admitted right now? (a free slot exists and
        its worst-case demand fits under the live reservations) — the
        pressure signal the preemption policy keys on."""
        if not any(s is None for s in self.slots):
            return False
        return self._fits(req, self._demand(req))

    def try_admit(self):
        """Move waiting requests into free slots while their worst-case
        block demand fits; returns the newly admitted requests.
        Selection is priority-then-FIFO (``next_waiting``), and a
        too-big head BLOCKS its class and everything below rather than
        starving (no bypass: admitting a small low-priority request
        around a blocked high-priority head would invert priority)."""
        admitted = []
        while self.waiting:
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                break
            req = self.next_waiting()
            need = self._demand(req)
            if need > self._capacity - self._base_reserved:
                self.waiting.remove(req)
                raise ValueError(
                    f"request {req.req_id}: needs {need} blocks, pool "
                    f"only has {self._capacity - self._base_reserved} "
                    f"usable — raise num_blocks or split the request")
            if not self._fits(req, need):
                break
            self.waiting.remove(req)
            req.slot = free[0]
            self.slots[free[0]] = req
            self._reservations[req] = need
            self._attach(req)
            # a request with preemptions behind it was admitted before:
            # this admission is the RESUME half of a preempt/resume
            # pair, not new work
            if req.preemptions:
                self.resumed_total += 1
            else:
                self.admitted_total += 1
            admitted.append(req)
        return admitted

    def preempt(self, req):
        """Evict a LIVE request under pool pressure: release its blocks
        in every pool (refcount-safe — a shared block only returns to
        the free list when its last holder lets go), drop the
        reservation, free the slot, and requeue it at the HEAD of the
        waiting queue as a longer prompt (``Request.begin_resume``) so
        resume is plain re-admission + re-prefill."""
        if req.slot is None or req.finished:
            raise ValueError(
                f"request {req.req_id} is not live (slot={req.slot}, "
                f"finished={req.finished}): only an in-flight request "
                f"can be preempted")
        self.pool.free(req.req_id)
        for p in self.companion_pools:
            p.free(req.req_id)
        self._reservations.pop(req, None)
        self._cow_debt.pop(req, None)
        self.slots[req.slot] = None
        req.begin_resume()
        # head of the deque: the stable scan in next_waiting() puts a
        # resumed request ahead of its class (it was admitted first)
        self.waiting.appendleft(req)
        self.preempted_total += 1
        return req

    def retire(self, req):
        """Release a finished request's slot, reservation, and pool
        blocks in EVERY pool (free-list reuse is immediate)."""
        self.pool.free(req.req_id)
        for p in self.companion_pools:
            p.free(req.req_id)
        self._reservations.pop(req, None)
        self._cow_debt.pop(req, None)
        if req.slot is not None:
            self.slots[req.slot] = None
            req.slot = None
        self.finished_total += 1

    # -- views -------------------------------------------------------------
    def live(self):
        return [r for r in self.slots if r is not None]

    def prefilling(self):
        return [r for r in self.slots if r is not None and r.prefilling]

    def decoding(self):
        return [r for r in self.slots if r is not None and r.decoding]

    @property
    def has_work(self):
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def steady_state(self):
        """True when the batch composition CANNOT change before the
        next dispatch: nothing is waiting for admission, no slot is
        mid-prefill, and at least one slot is decoding. This is the
        predicate the engine's multi-quantum dispatch consults to decide
        how many decode quanta to run per dispatch — in steady state
        the host has no scheduling decision to make between quanta
        (retirement is handled by the on-device eos/max-len masks, and
        the admission reservation already covers every live row's
        worst-case growth), so re-entering Python between them buys
        nothing."""
        return (not self.waiting and not self.prefilling()
                and bool(self.decoding()))
