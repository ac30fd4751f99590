"""The serving front door of the port (counterpart of
``paddle_tpu/serving/frontend.py``): streaming requests, priority
preemption, SLO-aware load shedding and graceful drain over the
continuous-batching :class:`~paddle_tpu_torch.serving.ServingEngine`;
entry point :func:`paddle_tpu_torch.inference.serve`.

Everything here is host-side policy at the engine's scheduler
boundaries; on the card the decode quantum stays one captured CUDA
graph with one host sync a dispatch.

- **streaming**: :meth:`ServingFrontDoor.submit` returns a
  :class:`TokenStream`, iterated synchronously (each pull pumps the
  engine) or with ``async for`` under :meth:`run_async`; the engine's
  ``token_sink`` pushes every emitted token as the host sees it.
- **per-request parameters**: ``max_new_tokens``, ``seed``,
  ``temperature`` (an engine built with ``per_request_sampling=True``),
  and the host-side stop rules ``stop_token_ids`` / ``stop_sequences``.
- **priority preemption**: under pool pressure the pump evicts a
  strictly-lower-priority victim (:func:`~.policy.choose_victim`); its
  blocks return to the pool and it is requeued for recompute-on-resume,
  whose continuation equals an undisturbed run's.
- **load shedding and backpressure**: admission reads the burn-rate
  health report (``engine.health()``, cached ``health_interval_s``) and
  the queue depth through :class:`~.policy.FrontDoorPolicy`; a shed
  request is a bad outcome sample and its flight journal is captured.
- **graceful drain**: :meth:`ServingFrontDoor.drain` sheds new
  submissions (reason ``draining``), finishes everything accepted and
  flushes the flight recorder.
- **failure semantics**: an engine-side failure or an engine gone idle
  closes every open stream with ``finish_reason == "error"``, and
  ``timeout=`` bounds each token wait.

- **crash recovery**: :meth:`ServingFrontDoor.snapshot` /
  :meth:`ServingFrontDoor.restore` ride the engine's JSON snapshot; a
  restored door's streams hold the tokens emitted before the restart.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from .policy import NORMAL, FrontDoorPolicy, choose_victim
from .scheduler import Request

__all__ = ["TokenStream", "ServingFrontDoor"]


class TokenStream:
    """One request's streaming handle.

    Sync: ``for tok in stream`` — each pull pumps the front door until
    a token lands or the request finishes. Async: ``async for tok in
    stream`` under a running :meth:`ServingFrontDoor.run_async` task.
    ``stream.result()`` drives to completion and returns the generated
    ids as one int32 array; ``stream.request`` is the live
    :class:`~paddle_tpu_torch.serving.Request` (``finish_reason``:
    ``eos`` | ``stop`` | ``length`` | ``shed`` | ``error``).

    Failure semantics (the hang fix): an engine-side exception during a
    pump, or the engine going idle with this stream still open, closes
    the stream terminally with ``finish_reason == "error"`` instead of
    blocking the consumer forever; ``timeout`` seconds without a new
    token raises ``TimeoutError`` (sync) / ``asyncio.TimeoutError``
    (async) without touching the request's engine state."""

    def __init__(self, request, frontdoor, timeout=None):
        self.request = request
        self._fd = frontdoor
        self._buf = deque()
        self._closed = False
        self._timeout = None if timeout is None else float(timeout)
        self._aevent = None  # lazy: only async consumers pay for it

    # -- producer side (the front door's token sink) ----------------------
    def _push(self, tok):
        self._buf.append(int(tok))
        self._wake()

    def _close(self):
        self._closed = True
        self._wake()

    def _error_close(self, detail):
        """Terminal error close: the request is finished with
        ``finish_reason="error"`` (only if nothing finished it first)
        and the stream closes — the consumer's loop ends instead of
        hanging. Only called when the request is OUT of the engine
        (engine idle / engine dead), so the mutation cannot race a
        live slot."""
        req = self.request
        if not req.finished:
            req.finished = True
            req.finish_reason = "error"
            req.finish_time = self._fd.engine.obs.now()
        self._fd._streams.pop(str(req.req_id), None)
        self._close()

    def _wake(self):
        if self._aevent is not None:
            self._aevent.set()

    # -- consumer side -----------------------------------------------------
    @property
    def closed(self):
        return self._closed

    @property
    def shed(self):
        return self.request.finish_reason == "shed"

    @property
    def finish_reason(self):
        return self.request.finish_reason

    @property
    def cached_prefix_tokens(self):
        """Prompt tokens this request aliased from the prefix cache at
        its latest admission (0 on an unshared engine or a cache miss):
        tokens that paid NO prefill compute and no fresh pool
        residency — the per-request view of the shared-system-prompt
        TTFT win."""
        return self.request.cached_prefix_tokens

    def __iter__(self):
        eng = self._fd.engine
        last = eng.obs.now()
        while True:
            while self._buf:
                last = eng.obs.now()
                yield self._buf.popleft()
            if self._closed:
                return
            if not eng.has_work:
                # the engine went idle while this stream is still open:
                # the request fell out of the scheduler (engine died or
                # dropped it) — pumping again would spin forever
                self._error_close("engine idle with stream open")
                return
            if (self._timeout is not None
                    and eng.obs.now() - last > self._timeout):
                raise TimeoutError(
                    f"no token for request {self.request.req_id!r} in "
                    f"{self._timeout}s")
            try:
                self._fd.pump()
            except Exception:
                # engine-side failure: every open stream (this one
                # included) closes with finish_reason="error"; the
                # pumping caller also sees the exception
                self._fd._fail_open_streams()
                raise

    def __aiter__(self):
        return self

    async def __anext__(self):
        import asyncio

        while True:
            if self._buf:
                return self._buf.popleft()
            if self._closed:
                raise StopAsyncIteration
            if self.request.finished:
                # finished without a closing push (an error close) —
                # terminal, not a hang
                self._close()
                raise StopAsyncIteration
            if self._aevent is None:
                self._aevent = asyncio.Event()
            if self._timeout is None:
                await self._aevent.wait()
            else:
                await asyncio.wait_for(self._aevent.wait(),
                                       self._timeout)
            self._aevent.clear()

    def result(self):
        """Drain this stream to completion (pumping as needed) and
        return the full generated id row as int32."""
        for _ in self:
            pass
        return np.asarray(self.request.tokens, np.int32)


class ServingFrontDoor:
    """The serving system around one engine: submissions pass the
    shedding policy, the pump applies preemption before every scheduler
    iteration, and every emitted token streams out through
    :class:`TokenStream`.

    Args:
        engine: a :class:`~paddle_tpu_torch.serving.ServingEngine`
            (build with ``slo=`` for health-driven shedding and
            ``flight=`` for drain-flushable journals;
            ``paddle_tpu_torch.inference.serve()`` wires the stock setup).
        policy: a :class:`~paddle_tpu_torch.serving.FrontDoorPolicy`
            (default: stock ladder — shed BATCH at warn, BATCH+NORMAL
            at critical, preemption on).
    """

    def __init__(self, engine, policy=None):
        self.engine = engine
        self.policy = policy if policy is not None else FrontDoorPolicy()
        if engine.token_sink is not None:
            raise ValueError(
                "engine already has a token_sink — one front door per "
                "engine")
        engine.token_sink = self._on_token
        self._streams = {}       # req_id -> TokenStream
        self.shed_requests = []  # Request handles refused admission
        self._shed_seq = 0
        self._draining = False
        self._stopped = False
        self._health = ("ok", float("-inf"))  # (state, stamped at)

    # -- submission --------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, priority=NORMAL,
               temperature=None, stop_token_ids=None,
               stop_sequences=None, seed=0, req_id=None, timeout=None):
        """Admit-or-shed one request; always returns a
        :class:`TokenStream` (a shed request's stream is already closed
        with ``finish_reason == "shed"`` — check ``stream.shed``).
        ``timeout`` bounds the stream's wait for each next token
        (None = wait forever; see :class:`TokenStream`)."""
        eng = self.engine
        now = eng.obs.now()
        if self._draining:
            return self._shed(prompt, max_new_tokens, priority, seed,
                              req_id, now, reason="draining")
        admit, reason = self.policy.admission(
            priority, self._health_state(now),
            waiting_depth=len(eng.scheduler.waiting))
        if not admit:
            return self._shed(prompt, max_new_tokens, priority, seed,
                              req_id, now, reason=reason)
        req = eng.submit(prompt, max_new_tokens=max_new_tokens,
                         req_id=req_id, seed=seed, priority=priority,
                         temperature=temperature,
                         stop_token_ids=stop_token_ids,
                         stop_sequences=stop_sequences,
                         arrival_time=now)
        stream = TokenStream(req, self, timeout=timeout)
        self._streams[str(req.req_id)] = stream
        return stream

    def _shed(self, prompt, max_new_tokens, priority, seed, req_id,
              now, reason):
        """Refuse one submission: the request never touches the
        scheduler; obs records the bad-outcome sample (the shed rate
        burns the error-rate SLO) and the flight recorder captures the
        (short) journal — shedding IS an anomaly."""
        eng = self.engine
        if req_id is None:
            req_id = f"shed{self._shed_seq}"
        self._shed_seq += 1
        req = Request(prompt, max_new_tokens=max_new_tokens,
                      req_id=req_id, seed=seed, priority=priority,
                      arrival_time=now)
        req.finished = True
        req.finish_reason = "shed"
        req.finish_time = now
        if eng.flight is not None:
            eng.flight.on_submit(req, now)
            eng.flight.on_shed(req, now, reason=reason)
        eng.obs.on_shed(req, now)
        self.shed_requests.append(req)
        stream = TokenStream(req, self)
        stream._close()
        return stream

    def _health_state(self, now):
        """The engine's burn-rate health state, re-evaluated at most
        every ``policy.health_interval_s`` (no SLOs attached -> always
        ``ok``: shedding then rests on backpressure alone)."""
        if self.engine.slo is None:
            return "ok"
        state, stamped = self._health
        if now - stamped < self.policy.health_interval_s:
            return state
        state = self.engine.health(now=now)["state"]
        self._health = (state, now)
        return state

    # -- the pump ----------------------------------------------------------
    def _on_token(self, req, tok):
        stream = self._streams.get(str(req.req_id))
        if stream is None:
            return
        stream._push(tok)
        if req.finished:
            stream._close()
            self._streams.pop(str(req.req_id), None)

    def _apply_preemption(self):
        """Before admitting: if the highest-priority waiting request
        cannot fit, evict strictly-lower-priority victims until it can
        (or no victim remains). Equal priority never preempts — no
        thrash between peers — and a resumed victim can itself only be
        preempted again by a strictly higher class."""
        if not self.policy.preempt:
            return 0
        sched = self.engine.scheduler
        head = sched.next_waiting()
        if head is None:
            return 0
        n = 0
        while (n < self.policy.max_preemptions_per_pump
                and not sched.can_admit(head)):
            victim = choose_victim(sched.live(), head.priority)
            if victim is None:
                break
            self.engine.preempt(victim)
            n += 1
        return n

    def _reap_finished(self):
        """Close streams whose request finished WITHOUT a final token
        push (``_on_token`` never fired for it): without this sweep its
        consumer would pump forever."""
        for rid, stream in list(self._streams.items()):
            if stream.request.finished:
                stream._close()
                self._streams.pop(rid, None)

    def _fail_open_streams(self):
        """The engine raised out of a pump: every open stream closes
        terminally with ``finish_reason="error"`` so no consumer —
        including ones on other streams — blocks on a dead engine."""
        for stream in list(self._streams.values()):
            stream._error_close("engine failed")
        self._streams.clear()

    def pump(self):
        """One front-door iteration: preemption policy, then one engine
        scheduler step (admit -> mixed prefill | decode quantum ->
        retire), then the finished-stream reap. Returns True while work
        remains."""
        self._apply_preemption()
        alive = self.engine.step()
        self._reap_finished()
        return alive

    def pump_dispatch(self):
        """DISPATCH HALF of :meth:`pump` — preemption policy + the
        engine's async :meth:`~ServingEngine.step_dispatch`. Returns
        the opaque pending record for :meth:`pump_collect`: the card
        works on the dispatch while the host is free. ``pump()`` is
        equivalent to
        ``pump_collect(pump_dispatch())`` (it goes through
        ``engine.step()`` — the composition of the same two halves — so
        wrappers around ``step`` still see every pump)."""
        self._apply_preemption()
        return self.engine.step_dispatch()

    def pump_collect(self, pending):
        """COLLECT HALF of :meth:`pump`: force the pending dispatch,
        reap finished streams, report whether work remains."""
        alive = self.engine.step_collect(pending)
        self._reap_finished()
        return alive

    def run_until_idle(self):
        """Drive synchronously until no work remains; returns the
        engine's completed-request list."""
        while self.engine.has_work:
            self.pump()
        return self.engine.completed

    async def run_async(self, idle_s=0.001):
        """The serving loop as a coroutine: pump while work exists
        (yielding to the event loop between dispatches so streaming
        consumers run), sleep briefly when idle, exit on :meth:`stop`
        or when a drain completes."""
        import asyncio

        self._stopped = False
        while not self._stopped:
            if self.engine.has_work:
                self.pump()
                await asyncio.sleep(0)
            elif self._draining:
                break
            else:
                await asyncio.sleep(idle_s)

    def stop(self):
        """Stop :meth:`run_async` after its current iteration (no
        drain: queued work stays queued)."""
        self._stopped = True

    # -- drain -------------------------------------------------------------
    def drain(self, flight_path=None):
        """Graceful drain: stop accepting NEW submissions (they shed
        with reason ``draining``), finish everything already accepted
        — queued and in-flight — then flush the flight recorder
        (optionally to ``flight_path`` as JSONL). Returns a summary
        dict; the front door stays drained (build a new one to
        serve again)."""
        eng = self.engine
        if not self._draining:
            self._draining = True
            eng.obs.on_drain(eng.obs.now(),
                             live=len(eng.scheduler.live()),
                             waiting=len(eng.scheduler.waiting))
        while eng.has_work:
            self.pump()
        out = {
            "drained": True,
            "completed": len(eng.completed),
            "shed": len(self.shed_requests),
            "preempted": eng.scheduler.preempted_total,
            "resumed": eng.scheduler.resumed_total,
        }
        if eng.flight is not None:
            out["flight"] = eng.flight.stats()
            if flight_path is not None:
                out["flight_path"] = eng.flight.save(flight_path)
        return out

    # -- crash recovery ----------------------------------------------------
    def snapshot(self):
        """The engine's crash-recovery snapshot (JSON-able; see
        :meth:`ServingEngine.snapshot`): the door adds nothing, its
        streams are rebuilt by :meth:`restore`."""
        return self.engine.snapshot()

    @classmethod
    def restore(cls, snap, model, policy=None, spec_draft=None,
                **overrides):
        """Rebuild a front door and its engine from a snapshot: every
        in-flight request is re-admitted through recompute-on-resume and
        gets a FRESH open :class:`TokenStream` holding the tokens it had
        emitted, so a consumer sees the whole sequence; a greedy
        continuation equals the uninterrupted run's."""
        from .engine import ServingEngine

        eng = ServingEngine.restore(snap, model, spec_draft=spec_draft,
                                    **overrides)
        fd = cls(eng, policy=policy)
        for req in list(eng.scheduler.waiting):
            stream = TokenStream(req, fd)
            for tok in req.tokens:
                stream._buf.append(int(tok))
            fd._streams[str(req.req_id)] = stream
        return fd

    # -- views -------------------------------------------------------------
    @property
    def draining(self):
        return self._draining

    def stats(self):
        """Front-door counters merged over the engine's: shed /
        preempted / resumed / drain state next to the engine stats."""
        out = self.engine.engine_stats()
        out["shed"] = len(self.shed_requests)
        out["draining"] = self._draining
        out["open_streams"] = len(self._streams)
        return out
