"""Cluster tier of the port (counterpart of
``paddle_tpu/serving/cluster.py``): N :class:`ServingEngine` replicas
behind one router, the layer above the single-engine front door.

Three routing ingredients:

- **prefix-cache affinity**: a prompt's leading full blocks are hashed
  with :func:`~paddle_tpu_torch.nlp.paged_cache.prompt_prefix_key` (the
  chained FNV-1a key the pool's index stores) and the key is placed on a
  consistent-hash ring (vnodes per replica), so traffic with one system
  prompt lands where its blocks are hot, and adding or removing a replica
  moves only ~1/N of the keys;
- **health-weighted balancing**: each replica's
  :meth:`ClusterReplica.load_report` (burn-rate health, slot and pool
  gauges, queue depth); WARN replicas lose traffic to any OK peer,
  CRITICAL ones are skipped, and a prompt without a full block goes to
  the least loaded;
- **roles** (prefill/decode disaggregation): a ``role="prefill"`` replica
  runs the prompt and publishes its blocks; a ``role="decode"`` replica
  re-admits the request through recompute-on-resume, the mechanism of
  :meth:`ServingEngine.restore`, so no device state moves between
  replicas and the joined stream equals a single replica's.

:class:`ClusterFrontDoor` keeps the :class:`TokenStream` API and makes
the per-engine operations fleet-wide: ``drain()``, shed coordination (a
request is refused only after every eligible replica refused it), and
fleet ``snapshot()`` / ``restore()``.

All of it is host code at the front door's boundaries: nothing enters a
captured graph. On one card every replica's graph replays on the same
stream, so :meth:`ClusterFrontDoor.pump`'s dispatch-all-then-collect-all
overlaps the host's work with the card's, not the replicas' device work
with each other. K2's split-merge tickets are keyed by device, stream and
capacity, so replicas on one stream share them; their replays are ordered
on the stream, which makes the sharing safe.
"""
from __future__ import annotations

from ..nlp.paged_cache import _chain_hash, prompt_prefix_key
from .frontend import ServingFrontDoor, TokenStream
from .policy import NORMAL
from .scheduler import Request

__all__ = ["ClusterReplica", "ClusterRouter", "ClusterFrontDoor"]

_STATE_ORDER = {"ok": 0, "warn": 1, "critical": 2}


def _string_key(s):
    """64-bit chain hash of a unicode string (ring vnode placement) —
    reuses the pool's FNV-1a chain so the ring needs no new hash."""
    return _chain_hash(0, tuple(s.encode("utf-8")))


class ClusterReplica:
    """One engine + its own :class:`ServingFrontDoor` under a cluster
    router. ``role`` is ``"general"`` (default), ``"prefill"`` or
    ``"decode"``; mixed-role fleets get disaggregated hand-off."""

    def __init__(self, name, engine, role="general", policy=None,
                 door=None):
        if role not in ("general", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        self.name = str(name)
        self.engine = engine
        self.role = role
        self.door = (door if door is not None
                     else ServingFrontDoor(engine, policy=policy))

    def health_state(self, now):
        """Burn-rate health via the door's cached evaluation (no SLOs
        attached -> vacuously ``ok``)."""
        return self.door._health_state(now)

    def load_report(self, now=None):
        """Cheap, JSON-serializable load report — the poll target a
        router (in-process here, a scrape of ``/healthz`` + pool
        gauges in a multi-process deployment) balances on."""
        eng = self.engine
        if now is None:
            now = eng.obs.now()
        sched = eng.scheduler
        return {
            "replica": self.name,
            "role": self.role,
            "state": self.health_state(now),
            "waiting": len(sched.waiting),
            "live": len(sched.live()),
            "slots": int(eng.config.num_slots),
            "free_blocks": int(eng.pool.free_blocks),
            "blocks_in_use": int(eng.pool.blocks_in_use),
            "open_streams": len(self.door._streams),
            "draining": self.door.draining,
        }

    def load_score(self, now=None):
        """Sort key for least-loaded placement: waiting depth first
        (the queue is the latency), then live slots, then pool
        pressure; replica name breaks ties deterministically."""
        r = self.load_report(now)
        return (r["waiting"], r["live"], r["blocks_in_use"], self.name)


class ClusterRouter:
    """Placement policy over N replicas: prefix-affinity first, health
    always, least-loaded as the fallback.

    Args:
        replicas: list of :class:`ClusterReplica` (block sizes must
            agree — the affinity key is block-size-dependent).
        affinity_blocks: leading full blocks hashed into the affinity
            key (caps the key walk; prompts shorter than one block
            route by balance).
        vnodes: virtual nodes per replica on the consistent-hash ring.
        strategy: ``"affinity"`` (default) or ``"round_robin"`` (the
            bench's control arm: same health gating, no affinity).
        registry: a :class:`~paddle_tpu_torch.obs.MetricsRegistry` for the
            router's own counters (default: a private one).
    """

    def __init__(self, replicas, affinity_blocks=4, vnodes=32,
                 strategy="affinity", registry=None):
        if not replicas:
            raise ValueError("a cluster needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        sizes = {r.engine.pool.block_size for r in replicas}
        if len(sizes) != 1:
            raise ValueError(
                f"replicas disagree on block_size: {sorted(sizes)} — "
                f"the affinity key would alias-route")
        if strategy not in ("affinity", "round_robin"):
            raise ValueError(f"unknown strategy {strategy!r}")
        self.replicas = list(replicas)
        self.block_size = sizes.pop()
        self.affinity_blocks = int(affinity_blocks)
        self.vnodes = int(vnodes)
        self.strategy = strategy
        if registry is None:
            from ..obs import MetricsRegistry
            registry = MetricsRegistry()
        self.registry = registry
        self._c_requests = registry.counter(
            "serving_router_requests_total",
            "Requests placed on a replica, by placement reason")
        self._c_handoffs = registry.counter(
            "serving_router_handoffs_total",
            "Disaggregated prefill->decode hand-offs")
        self._c_shed = registry.counter(
            "serving_router_shed_total",
            "Requests every eligible replica refused")
        self._c_hits = registry.counter(
            "serving_router_affinity_hits_total",
            "Keyed requests placed on the replica that last served "
            "their prefix key")
        self._c_keyed = registry.counter(
            "serving_router_affinity_lookups_total",
            "Requests that carried an affinity key")
        self._g_hit_rate = registry.gauge(
            "serving_router_affinity_hit_rate",
            "affinity_hits_total / affinity_lookups_total")
        self._g_replicas = registry.gauge(
            "serving_router_replicas",
            "Replicas on the ring, by health state")
        self._ring = []
        self._key_owner = {}   # affinity key -> replica name last placed
        self._rr_next = 0
        self._rebuild_ring()

    # -- ring --------------------------------------------------------------
    def _rebuild_ring(self):
        self._ring = sorted(
            (_string_key(f"{r.name}#{v}"), r.name)
            for r in self.replicas for v in range(self.vnodes))

    def _ring_lookup(self, key):
        """First vnode clockwise of ``key`` (wrapping) — the classic
        consistent-hash successor, so add/remove of one replica moves
        only the arcs its vnodes owned (~1/N of the keyspace)."""
        ring = self._ring
        lo, hi = 0, len(ring)
        while lo < hi:
            mid = (lo + hi) // 2
            if ring[mid][0] < key:
                lo = mid + 1
            else:
                hi = mid
        return ring[lo % len(ring)][1]

    def _by_name(self, name):
        for r in self.replicas:
            if r.name == name:
                return r
        return None

    def add_replica(self, replica):
        """Grow the fleet: the ring is rebuilt; existing keys keep
        their owner unless the new replica's vnodes claim their arc."""
        if self._by_name(replica.name) is not None:
            raise ValueError(f"replica {replica.name!r} already routed")
        if replica.engine.pool.block_size != self.block_size:
            raise ValueError("replica block_size mismatch")
        self.replicas.append(replica)
        self._rebuild_ring()

    def remove_replica(self, name):
        """Shrink the fleet (the caller drains the replica first);
        its arcs redistribute to the ring successors."""
        rep = self._by_name(name)
        if rep is None:
            raise ValueError(f"no replica {name!r}")
        self.replicas.remove(rep)
        if not self.replicas:
            raise ValueError("cannot remove the last replica")
        self._rebuild_ring()
        return rep

    # -- placement ---------------------------------------------------------
    def now(self):
        return self.replicas[0].engine.obs.now()

    def prefix_key(self, tokens):
        return prompt_prefix_key(tokens, self.block_size,
                                 max_blocks=self.affinity_blocks)

    def plan(self, tokens, roles=None, now=None):
        """Ordered placement candidates ``[(replica, reason), ...]``:
        the head is where the request should run; the tail is the
        shed-coordination failover order. ``reason`` is ``affinity`` |
        ``balance`` | ``failover``.

        Health gating: CRITICAL replicas are skipped outright (they
        re-enter only if the WHOLE eligible fleet is critical — a
        refusal there is the per-door policy's call, not the
        router's); WARN replicas are demoted below every OK peer,
        including for affinity traffic."""
        if now is None:
            now = self.now()
        eligible = [r for r in self.replicas
                    if roles is None or r.role in roles]
        if not eligible:
            raise ValueError(f"no replica with role in {roles!r}")
        states = {r.name: r.health_state(now) for r in eligible}
        for st in ("ok", "warn", "critical"):
            self._g_replicas.set(
                sum(1 for s in states.values() if s == st), state=st)
        ok = [r for r in eligible if states[r.name] == "ok"]
        warn = [r for r in eligible if states[r.name] == "warn"]
        healthy = ok if ok else warn
        if not healthy:           # whole fleet critical: last resort
            healthy = eligible
        by_load = sorted(healthy, key=lambda r: r.load_score(now))
        if self.strategy == "round_robin":
            chosen = eligible[self._rr_next % len(eligible)]
            self._rr_next += 1
            if states[chosen.name] == "critical" and chosen not in healthy:
                chosen = by_load[0]
            rest = [r for r in by_load if r is not chosen]
            return ([(chosen, "balance")]
                    + [(r, "failover") for r in rest])
        key = self.prefix_key(tokens)
        if key is None:
            return ([(by_load[0], "balance")]
                    + [(r, "failover") for r in by_load[1:]])
        preferred = self._by_name(self._ring_lookup(key))
        if preferred is not None and preferred in healthy:
            rest = [r for r in by_load if r is not preferred]
            return ([(preferred, "affinity")]
                    + [(r, "failover") for r in rest])
        # preferred ineligible / demoted / critical: fail over by load
        return [(r, "failover") for r in by_load]

    def note_placement(self, tokens, replica, reason):
        """Account the ACTUAL placement (after shed failover): request
        counter, affinity hit bookkeeping, hit-rate gauge."""
        self._c_requests.inc(replica=replica.name, reason=reason)
        key = self.prefix_key(tokens)
        if key is None:
            return
        self._c_keyed.inc()
        if self._key_owner.get(key) == replica.name:
            self._c_hits.inc()
        self._key_owner[key] = replica.name
        keyed = self._c_keyed.value()
        if keyed:
            self._g_hit_rate.set(self._c_hits.value() / keyed)

    def note_shed(self, reason):
        self._c_shed.inc(reason=str(reason))

    def note_handoff(self):
        self._c_handoffs.inc()

    # -- views -------------------------------------------------------------
    @property
    def roles(self):
        return {r.role for r in self.replicas}

    @property
    def disaggregated(self):
        return "prefill" in self.roles and "decode" in self.roles

    def load_reports(self, now=None):
        if now is None:
            now = self.now()
        return [r.load_report(now) for r in self.replicas]

    def affinity_stats(self):
        keyed = self._c_keyed.value()
        return {
            "keys_tracked": len(self._key_owner),
            "keyed_requests": int(keyed),
            "affinity_hits": int(self._c_hits.value()),
            "hit_rate": (self._c_hits.value() / keyed) if keyed else 0.0,
        }


class ClusterFrontDoor:
    """The :class:`TokenStream` API over a routed fleet. ``submit``
    places each request through the router's plan, trying candidates
    in order until one admits (shed coordination: the caller sees
    ``finish_reason == "shed"`` only when EVERY eligible replica
    refused); on a disaggregated fleet, greedy requests without stop
    sequences run the prefill phase on a prefill replica and hand off
    to a decode replica via recompute-on-resume."""

    def __init__(self, router):
        self.router = router
        self._draining = False
        self._seq = 0

    @property
    def replicas(self):
        return self.router.replicas

    @property
    def engines(self):
        return [r.engine for r in self.replicas]

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, priority=NORMAL,
               temperature=None, stop_token_ids=None,
               stop_sequences=None, seed=0, req_id=None, timeout=None):
        """Route-and-admit one request; always returns a stream with
        the single-door contract (check ``stream.shed``)."""
        tokens = [int(t) for t in prompt]
        router = self.router
        if req_id is None:
            req_id = f"c{self._seq}"
        self._seq += 1
        if (router.disaggregated and not self._draining
                and max_new_tokens > 1
                and (temperature is None or temperature == 0)
                and not stop_sequences):
            return self._submit_handoff(
                tokens, max_new_tokens, priority, stop_token_ids,
                seed, req_id, timeout)
        roles = (("decode", "general") if router.disaggregated
                 else None)
        return self._routed_submit(
            tokens, roles, max_new_tokens=max_new_tokens,
            priority=priority, temperature=temperature,
            stop_token_ids=stop_token_ids,
            stop_sequences=stop_sequences, seed=seed, req_id=req_id,
            timeout=timeout)

    def _routed_submit(self, tokens, roles, **kw):
        """Try the plan's candidates in order; the first non-shed
        stream wins. Candidate i>0 is accounted as ``failover``
        regardless of its planned reason — the head refused it."""
        router = self.router
        plan = router.plan(tokens, roles=roles)
        stream = None
        for i, (rep, reason) in enumerate(plan):
            stream = rep.door.submit(tokens, **kw)
            if not stream.shed:
                reason = reason if i == 0 else "failover"
                router.note_placement(tokens, rep, reason)
                self._journal_route(rep, stream.request, reason)
                return stream
        router.note_shed("cluster_full" if not self._draining
                         else "draining")
        return stream

    def _journal_route(self, rep, req, reason):
        flight = rep.engine.flight
        if flight is not None:
            flight.on_route(req, rep.engine.obs.now(),
                            replica=rep.name, reason=reason)

    def _submit_handoff(self, tokens, max_new_tokens, priority,
                        stop_token_ids, seed, req_id, timeout):
        """Disaggregated path: prefill replica emits the first token
        (publishing the prompt's blocks into ITS prefix index for the
        next same-prefix arrival), then the decode replica re-admits
        prompt+[t0] through the recompute-on-resume path — the exact
        :meth:`ServingFrontDoor.restore` mechanism, so the combined
        stream is bit-identical to a single-replica run."""
        router = self.router
        pre = self._routed_submit(
            tokens, ("prefill",), max_new_tokens=1, priority=priority,
            stop_token_ids=stop_token_ids, seed=seed,
            req_id=f"{req_id}#prefill")
        if pre.shed:
            return pre
        first = pre.result()          # pumps the prefill door to done
        if (len(first) == 0 or pre.request.finish_reason
                in ("eos", "stop", "error")):
            return pre                # finished inside the prefill leg
        t0 = int(first[-1])
        # decode-side re-admission (force-admit: the cluster accepted
        # this request at the prefill leg; drain semantics owe it a
        # finish)
        plan = router.plan(tokens, roles=("decode",))
        rep, reason = plan[0]
        eng = rep.engine
        now = eng.obs.now()
        req = Request(tokens, max_new_tokens=max_new_tokens,
                      req_id=req_id, seed=seed, priority=priority,
                      stop_token_ids=stop_token_ids, arrival_time=now)
        req.tokens = [t0]
        req.begin_resume()
        eng.scheduler.submit(req)
        eng._on_submitted(req)
        router.note_placement(tokens, rep, reason)
        router.note_handoff()
        self._journal_route(rep, req, reason)
        if eng.flight is not None:
            eng.flight.on_handoff(req, now, src=pre.request.req_id,
                                  dst=rep.name,
                                  tokens_prefilled=len(tokens) + 1)
        stream = TokenStream(req, rep.door, timeout=timeout)
        stream._buf.append(t0)
        rep.door._streams[str(req.req_id)] = stream
        return stream

    # -- the pump ----------------------------------------------------------
    def pump(self):
        """One iteration of EVERY replica's front door: dispatch every
        replica's quantum first (no host sync), then collect in the same
        order, so a replica's host work runs while the card works on the
        dispatches before it. True while any replica still has work."""
        pend = []
        for rep in self.replicas:
            if rep.engine.has_work:
                pend.append((rep, rep.door.pump_dispatch()))
        alive = False
        for rep, p in pend:
            alive = rep.door.pump_collect(p) or alive
        return alive

    @property
    def has_work(self):
        return any(eng.has_work for eng in self.engines)

    def run_until_idle(self):
        """Drive the whole fleet synchronously until idle; returns the
        per-replica completed lists keyed by replica name."""
        while self.has_work:
            self.pump()
        return {r.name: r.engine.completed for r in self.replicas}

    # -- cluster-wide operations -------------------------------------------
    def drain(self, flight_dir=None):
        """Coordinated drain: every door stops accepting FIRST (so a
        submission racing the drain sheds everywhere instead of
        landing on a not-yet-draining replica), then the whole fleet
        pumps INTERLEAVED until idle — one overlapped pass per replica
        per round via :meth:`pump`, never one replica to completion
        before the next starts (the old ring-order drain starved later
        replicas: replica 0 ran its whole backlog while replica N-1's
        accepted requests aged). Each door's ``drain()`` then runs on
        an already-idle engine, contributing only its summary + flight
        flush. Returns per-replica summaries + fleet totals."""
        import os
        self._draining = True
        for rep in self.replicas:       # flip all gates before pumping
            if not rep.door.draining:
                rep.door._draining = True
                eng = rep.engine
                eng.obs.on_drain(eng.obs.now(),
                                 live=len(eng.scheduler.live()),
                                 waiting=len(eng.scheduler.waiting))
        while self.has_work:            # interleaved, fleet-wide
            self.pump()
        out = {"drained": True, "replicas": {}}
        completed = shed = 0
        for rep in self.replicas:
            path = (os.path.join(flight_dir, f"{rep.name}.jsonl")
                    if flight_dir is not None
                    and rep.engine.flight is not None else None)
            s = rep.door.drain(flight_path=path)
            out["replicas"][rep.name] = s
            completed += s["completed"]
            shed += s["shed"]
        out["completed"] = completed
        out["shed"] = shed
        return out

    @property
    def draining(self):
        return self._draining

    # -- fleet crash recovery ----------------------------------------------
    def snapshot(self):
        """Fleet snapshot: every replica's engine snapshot plus the
        router's placement state, so a restored cluster keeps its
        affinity map warm."""
        router = self.router
        return {
            "version": 1,
            "kind": "serving_cluster_snapshot",
            "strategy": router.strategy,
            "affinity_blocks": router.affinity_blocks,
            "vnodes": router.vnodes,
            "rr_next": router._rr_next,
            "affinity_map": {str(k): v
                             for k, v in router._key_owner.items()},
            "replicas": [{"name": r.name, "role": r.role,
                          "snapshot": r.engine.snapshot()}
                         for r in self.replicas],
        }

    @classmethod
    def restore(cls, snap, model, policy=None, registry=None,
                spec_draft=None, **overrides):
        """Rebuild the whole fleet from a snapshot: each replica
        restores through :meth:`ServingFrontDoor.restore` (in-flight
        requests re-admitted via recompute-on-resume with pre-loaded
        streams), and the router resumes with the saved affinity map.
        ``model`` is one shared model, or a dict ``{replica_name:
        model}`` for heterogeneous fleets."""
        if snap.get("kind") != "serving_cluster_snapshot":
            raise ValueError(
                f"not a cluster snapshot: kind={snap.get('kind')!r}")
        reps = []
        for r in snap["replicas"]:
            m = model[r["name"]] if isinstance(model, dict) else model
            door = ServingFrontDoor.restore(
                r["snapshot"], m, policy=policy,
                spec_draft=spec_draft, **overrides)
            reps.append(ClusterReplica(r["name"], door.engine,
                                       role=r["role"], door=door))
        router = ClusterRouter(
            reps, affinity_blocks=snap["affinity_blocks"],
            vnodes=snap["vnodes"], strategy=snap["strategy"],
            registry=registry)
        router._rr_next = int(snap.get("rr_next", 0))
        router._key_owner = {int(k): v
                             for k, v in snap["affinity_map"].items()}
        return cls(router)

    # -- views -------------------------------------------------------------
    def streams(self):
        """All open streams across the fleet, keyed by req_id."""
        out = {}
        for rep in self.replicas:
            out.update(rep.door._streams)
        return out

    def stats(self):
        """Fleet stats: per-replica front-door stats + router affinity
        view + fleet totals."""
        per = {r.name: r.door.stats() for r in self.replicas}
        return {
            "replicas": per,
            "router": self.router.affinity_stats(),
            "admitted": sum(s["admitted"] for s in per.values()),
            "finished": sum(s["finished"] for s in per.values()),
            "shed": sum(s["shed"] for s in per.values()),
            "draining": self._draining,
        }
