"""Deterministic, seeded fault injection for the serving engine
(counterpart of ``paddle_tpu/serving/faults.py``).

The injector threads through the engine's host boundaries: the decode
dispatch (``before_dispatch``), the pool's ``_alloc_block`` (``on_alloc``
through ``pool.fault_hook``) and the per-step KV corruption sweep
(``maybe_corrupt``). Every fault fires on the host BEFORE the device work
it targets, so a retried dispatch re-stages its state buffers against
intact pools. A default injector (empty plan) is disarmed: every hook is a
constant-time no-op, and a default engine's captured quantum is unchanged.

Determinism: the same ``seed``, ``plan`` and call sequence fire the same
faults at the same call indices, with the same ``journal``. The draws come
from a private ``random.Random`` in the reference's order, so both
packages' journals are equal for one plan, seed and workload.

The bit flip of ``maybe_corrupt`` is IN PLACE: one element of one cached
block of layer 0's K pool is XORed through an integer view of the pool on
the device, so no pool tensor is replaced and a captured decode graph keeps
its addresses. It picks the element and the bit as the reference does,
over an integer view of the block whose word is 16 bits for 2-byte
elements and 32 bits otherwise; on an int8 pool that view has a quarter as
many words as the block has elements, and an element index past it raises
``IndexError``, as the reference's numpy view does (ROADMAP queue C).
"""
from __future__ import annotations

import random
import time

import torch

__all__ = ["InjectedFault", "FaultSpec", "FaultInjector",
           "FAULT_SITES", "FAULT_KINDS"]

#: host boundaries the injector can target: the three quantum kinds (the
#: labels of ``obs.on_quantum``), the pool allocator, cached-KV corruption
#: and the prefix-verify walk
FAULT_SITES = ("decode", "spec_round", "mixed", "alloc", "kv", "prefix")

#: what fires at a matched site: ``raise`` (an :class:`InjectedFault`
#: before the dispatch), ``slow`` (sleep ``sleep_s``: watchdog fodder),
#: ``alloc_fail`` (the pool raises as if exhausted), ``bit_flip`` (one bit
#: of one element of a cached-only KV block), ``poison`` (every dispatch
#: holding a marked request raises; the engine's bisect isolates it)
FAULT_KINDS = ("raise", "slow", "alloc_fail", "bit_flip", "poison")


class InjectedFault(RuntimeError):
    """A fault the injector raised on purpose. The engine retries ONLY this
    type (any other exception keeps fail-stop semantics); ``site`` and
    ``kind`` say where it fired, ``poison`` carries the poisoned request id
    of a poison trip."""

    def __init__(self, site, kind, detail=None, poison=None):
        self.site = site
        self.kind = kind
        self.poison = poison
        msg = f"injected {kind} at {site}"
        if poison is not None:
            msg += f" (poison {poison})"
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


class FaultSpec:
    """One declarative fault: fire ``kind`` at ``site`` with probability
    ``p`` per eligible call, at most ``times`` times (None: unbounded).
    ``sleep_s`` sizes a ``slow`` fault's stall; ``detail`` rides in the
    raised message."""

    def __init__(self, site, kind, p=1.0, times=None, sleep_s=0.05,
                 detail=None):
        if site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"expected one of {FAULT_SITES}")
        if kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        self.site = site
        self.kind = kind
        self.p = float(p)
        self.times = None if times is None else int(times)
        self.sleep_s = float(sleep_s)
        self.detail = detail
        self.fired = 0

    def exhausted(self):
        return self.times is not None and self.fired >= self.times

    def __repr__(self):
        return (f"FaultSpec({self.site!r}, {self.kind!r}, p={self.p}, "
                f"times={self.times}, fired={self.fired})")


def _flip_in_place(block, j, bit):
    """XOR bit ``bit`` of word ``j`` of ``block`` (one pool block, a view
    of the pool) in place, over the reference's integer view: 16-bit words
    for 2-byte elements, 32-bit words otherwise."""
    flat = block.reshape(-1)
    raw = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
    n = raw.numel()
    if j >= n:
        raise IndexError(
            f"index {j} is out of bounds for axis 0 with size {n}")
    width = raw.element_size() * 8
    mask = 1 << bit
    if mask >= 1 << (width - 1):
        mask -= 1 << width  # the same bit pattern as a signed word
    raw[j].bitwise_xor_(mask)


class FaultInjector:
    """Seeded declarative fault injection at the engine's host boundaries.

    Args:
        plan: iterable of :class:`FaultSpec` (or ``(site, kind)`` /
            ``(site, kind, p)`` tuples). Empty: a disarmed no-op.
        seed: seeds the private ``random.Random`` behind every fire/skip
            decision.
        sleep: the stall of ``slow`` faults (tests pass a stub; default
            ``time.sleep``).
    """

    def __init__(self, plan=(), seed=0, sleep=time.sleep):
        self.plan = [s if isinstance(s, FaultSpec) else FaultSpec(*s)
                     for s in plan]
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        self._sleep = sleep
        self.injected_total = 0
        self.journal = []          # replayable record of every fire
        self._poisoned = set()     # request ids whose dispatches raise
        self._calls = 0            # monotone call index (journal key)

    # -- arming state ------------------------------------------------------
    @property
    def armed(self):
        """True while a spec can still fire or a poison is pending: a
        disarmed injector's hooks are constant-time no-ops."""
        return (bool(self._poisoned)
                or any(not s.exhausted() for s in self.plan))

    def poison(self, req_id):
        """Mark ``req_id`` as poison: every dispatch whose active rows hold
        it raises until the engine's bisect finishes it with
        ``finish_reason="error"`` and calls :meth:`cure`."""
        self._poisoned.add(str(req_id))

    def cure(self, req_id):
        self._poisoned.discard(str(req_id))

    @property
    def poisoned(self):
        return frozenset(self._poisoned)

    # -- plan matching -----------------------------------------------------
    def _fire(self, spec, site, **extra):
        spec.fired += 1
        self.injected_total += 1
        self.journal.append({"call": self._calls, "site": site,
                             "kind": spec.kind, **extra})

    def _match(self, site, kinds):
        """The first live spec for ``site`` with a kind in ``kinds`` whose
        coin lands; the generator is drawn for every candidate, so the
        decisions are a pure function of seed, plan and call order."""
        for spec in self.plan:
            if spec.site != site or spec.kind not in kinds:
                continue
            if spec.exhausted():
                continue
            if self._rng.random() < spec.p:
                return spec
        return None

    # -- engine hooks ------------------------------------------------------
    def before_dispatch(self, site, active_req_ids=()):
        """Called right BEFORE a dispatch (site decode | spec_round |
        mixed) with the request ids of the rows about to run. Raises
        :class:`InjectedFault` for a matched ``raise`` spec or a poisoned
        row; stalls for a matched ``slow`` spec."""
        if not (self.plan or self._poisoned):
            return
        self._calls += 1
        for rid in active_req_ids:
            if str(rid) in self._poisoned:
                spec = self._match(site, ("poison",))
                if spec is not None:
                    self._fire(spec, site, poison=str(rid))
                else:
                    self.injected_total += 1
                    self.journal.append(
                        {"call": self._calls, "site": site,
                         "kind": "poison", "poison": str(rid)})
                raise InjectedFault(site, "poison", poison=str(rid))
        spec = self._match(site, ("raise", "slow"))
        if spec is None:
            return
        if spec.kind == "slow":
            self._fire(spec, site, sleep_s=spec.sleep_s)
            self._sleep(spec.sleep_s)
            return
        self._fire(spec, site)
        raise InjectedFault(site, "raise", detail=spec.detail)

    def on_alloc(self, pool):
        """Bound to ``pool.fault_hook``: called inside ``_alloc_block``
        before a block leaves the free list. A matched ``alloc_fail``
        raises with the pool untouched, so the engine can retry the
        step."""
        if not self.plan:
            return
        self._calls += 1
        spec = self._match("alloc", ("alloc_fail",))
        if spec is None:
            return
        self._fire(spec, "alloc")
        raise InjectedFault("alloc", "alloc_fail", detail=spec.detail)

    def maybe_corrupt(self, pool):
        """Called once per engine step: a matched ``kv`` / ``bit_flip``
        spec flips one bit of one element of a CACHED-ONLY block (refcount
        1, held by the prefix index alone) of layer 0's K pool, in place:
        corruption the content verify at the next ``attach_prefix`` must
        catch, which never touches a live request's stream. With no such
        block it journals a skip. Returns the corrupted block id or
        None."""
        if not self.plan:
            return None
        self._calls += 1
        spec = self._match("kv", ("bit_flip",))
        if spec is None:
            return None
        held = set()
        for blocks in pool._tables.values():
            held.update(blocks)
        victims = sorted(b for b, e in pool._cached_blocks.items()
                         if pool._refcounts.get(b) == 1
                         and b not in held)
        if not victims:
            self.journal.append({"call": self._calls, "site": "kv",
                                 "kind": "bit_flip", "skipped": True})
            return None
        blk = victims[self._rng.randrange(len(victims))]
        block = pool.k_pools[0][blk]
        j = self._rng.randrange(block.numel())
        word = 2 if block.element_size() == 2 else 4
        bit = self._rng.randrange(word * 8)
        _flip_in_place(block, j, bit)
        self._fire(spec, "kv", block=int(blk), elem=int(j), bit=int(bit))
        return int(blk)

    # -- views -------------------------------------------------------------
    def stats(self):
        return {
            "seed": self.seed,
            "armed": self.armed,
            "injected_total": self.injected_total,
            "poisoned": sorted(self._poisoned),
            "plan": [repr(s) for s in self.plan],
            "journal_len": len(self.journal),
        }
