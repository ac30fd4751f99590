"""Continuous-batching serving engine over the paged KV pool (counterpart
of ``paddle_tpu/serving/engine.py``, the core of it).

The loop is the reference's:

- a fixed table of ``num_slots`` serving slots; empty and finished slots
  ride along masked;
- chunked prefill: new arrivals push their prompt through
  :func:`~paddle_tpu_torch.incubate.nn.functional.block_multihead_attention`
  in ``prefill_chunk``-token slices, sharing MIXED batches with the
  in-flight slots' decode rows (varlen kernel K3 for prefill rows, paged
  kernel K2 for decode rows);
- the decode quantum: ``decode_quantum`` single-token steps of
  :func:`paged_decode_math` for every slot, with the eos / max-length
  ``done`` masks kept on the device and ONE host sync per dispatch;
  ``multi_quantum=K`` runs up to K quanta per dispatch while the
  scheduler is in steady state;
- block accounting by the scheduler, retirement returning blocks to the
  pool free list for immediate reuse, preemption by recompute-on-resume.

The reference compiles its quantum into one jitted program; here the
quantum is one captured CUDA graph on the card
(:class:`~paddle_tpu_torch._graphs.CapturedStep`). The slot state lives in
static device buffers, staged from the host mirrors by one copy before
each dispatch and read back by one copy after it; the graph's T steps
write their results back into those buffers, so K quanta are K replays.
The mixed prefill step stays eager (its shapes vary; the reference
compiles it per shape). Pools are updated in place and never
reallocated. Decoding is greedy, or sampling with engine-wide
``top_k``/``top_p``/``temperature`` (and, with ``per_request_sampling``,
a per-slot temperature): each draw is keyed on the device by (request
seed, tokens emitted so far), so a stream does not depend on preemption
or on how steps group into quanta. int8 serving:
``quantize="weight_only_int8"`` sweeps the model's Linears to int8
weights with per-channel scales, and ``kv_dtype="int8"`` keeps int8 pools
with per-row scale pools, every written row quantized by its own abs-max
(the quantum's attention is K2's per-row mode). Observability, SLOs, the
flight recorder, fault injection, resilience, speculative decoding,
tensor parallelism and the prefix cache are later slices (ROADMAP A2,
A4, A5, A7); the engine does not take their options.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from .._device import resolve_device
from .._graphs import CapturedStep
from ..incubate.nn.functional import block_multihead_attention
from ..nlp.generation import _filter_logits, keyed_gumbel_argmax
from ..nlp.paged_cache import PagedKVCachePool
from ..nn.functional.rope import build_rope_cache, inv_freq
from ..nn.quant import quantize_for_serving, quantize_kv_rows
from ..ops import _library as L
from ..ops.paged_attention import (_paged_decode_attention_rows,
                                   paged_decode_attention)
from .scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["ServingEngine", "paged_decode_math"]


def _rope_rows(x, cos, sin):
    """Rotate (S, H, D) rows by per-row angles (S, D/2), neox layout, in
    f32 (the model's rotary layout at each row's own cache position)."""
    xf = x.float()
    c = cos[:, None, :]
    s = sin[:, None, :]
    d = x.shape[-1]
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _fused_paged_decode_attn(q, kp, vp, tables, lens, ks=None, vs=None):
    """Plain port of the reference's fused decode attention: an
    online-softmax stream over the block-table entries, one pool block
    per row and step folded into running (m, l, acc) f32 statistics. A
    row whose context ended before block ``ki`` re-points its read at
    pool block 0 and masks the whole block; masked logits are -1e30.
    ``ks``/``vs`` are an int8 pool's per-row scale pools: blocks
    dequantize in f32 as they stream through. q (S, H, D); returns
    (S, H, D) in q's dtype."""
    s_, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    rep = h // hk
    sc = 1.0 / math.sqrt(d)
    qf = q.float()
    neg = -1e30
    dev = q.device
    lens = lens.to(dev)
    offs = torch.arange(bs, device=dev)
    m = torch.full((s_, h), neg, dtype=torch.float32, device=dev)
    l = torch.zeros((s_, h), dtype=torch.float32, device=dev)
    acc = torch.zeros((s_, h, d), dtype=torch.float32, device=dev)
    # every row attends >= 1 position (masked rows carry lens == 1), so
    # the first live block lifts m above -1e30 before any dead block's
    # exp(neg - m) underflows to an exact 0
    for ki in range(w):
        start = ki * bs
        alive = start < lens                               # (S,)
        blk = torch.where(alive, tables[:, ki], 0).long()  # elision clamp
        k = kp[blk].float()                                # (S, BS, HK, D)
        v = vp[blk].float()
        if ks is not None:
            k = k * ks[blk][..., None]
            v = v * vs[blk][..., None]
        if rep > 1:
            k = k.repeat_interleave(rep, dim=2)
            v = v.repeat_interleave(rep, dim=2)
        logits = torch.einsum("bhd,bkhd->bhk", qf, k) * sc  # (S, H, BS)
        mask = alive[:, None] & ((start + offs)[None, :] < lens[:, None])
        logits = torch.where(mask[:, None, :], logits, neg)
        m2 = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m2)                          # (S, H)
        p = torch.exp(logits - m2[..., None])              # (S, H, BS)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhk,bkhd->bhd", p, v)
        m = m2
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def _paged_attn(q, kp, vp, tables, lens, ks=None, vs=None, impl="gather"):
    """The quantum's decode attention. On the card both ``impl`` values
    launch K2 over float pools, or K2's per-row mode over int8 pools with
    per-row scale pools ``ks``/``vs``: K2 already streams the block
    table, as the reference sends both values to its Pallas kernel on a
    TPU. On the CPU (and under ``ops.plain_versions()``) ``"gather"``
    runs K2's plain versions (the reference's ``_xla_paged_decode_attn``)
    and ``"fused"`` runs :func:`_fused_paged_decode_attn`."""
    if impl == "fused" and L.use_plain(q):
        return _fused_paged_decode_attn(q, kp, vp, tables, lens, ks, vs)
    if ks is None:
        return paged_decode_attention(q, kp, vp, tables, lens)
    return _paged_decode_attention_rows(q, kp, vp, ks, vs, tables, lens)


def paged_decode_math(model, scratch_block, ids_t, seq_lens, tables, kc, vc,
                      live, ks=(), vs=(), attn_impl="gather"):
    """One token for every slot over a paged pool (the quantum's step).

    ``ids_t`` (S, 1) last tokens, ``seq_lens`` (S,) int32 tokens cached,
    ``tables`` (S, W) int32, ``kc``/``vc`` the per-layer pools (written in
    place), ``live`` (S,) bool. A masked row writes its KV into the
    scratch block and attends one position. ``ks``/``vs`` are the
    per-layer scale pools of an int8 pool (empty for a float pool): each
    written row, the scratch block's included, quantizes by its own
    abs-max and its scale is written beside it. ``attn_impl`` routes the
    attention (:func:`_paged_attn`). Returns logits (S, vocab)."""
    cfg = model.config
    core = model.llama
    s = ids_t.shape[0]
    h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim)
    bs = kc[0].shape[1]
    w = tables.shape[1]

    hidden = core.embed_tokens(ids_t)                   # (S, 1, E)
    freqs = seq_lens.float()[:, None] * inv_freq(
        d, cfg.rope_theta, seq_lens.device)[None, :]
    cos, sin = torch.cos(freqs), torch.sin(freqs)        # (S, D/2)

    blk_idx = torch.clamp(seq_lens // bs, 0, w - 1).long()
    own_blk = tables.gather(1, blk_idx[:, None])[:, 0].long()
    write_blk = torch.where(live, own_blk, scratch_block)
    write_off = torch.where(live, seq_lens % bs, 0).long()
    lens = torch.where(live, seq_lens + 1, 1).int()

    for i, layer in enumerate(core.layers):
        attn = layer.self_attn
        residual = hidden
        x = layer.input_layernorm(hidden)
        # q and k heads rotate together: the same elementwise math in
        # half the launches (a decode step is launch-bound)
        qk = _rope_rows(torch.cat([attn.q_proj(x).view(s, h, d),
                                   attn.k_proj(x).view(s, hk, d)], dim=1),
                        cos, sin)
        q, k = qk[:, :h], qk[:, h:]
        v = attn.v_proj(x).view(s, hk, d)
        ksi = vsi = None
        if ks:
            k, k_sc = quantize_kv_rows(k)
            v, v_sc = quantize_kv_rows(v)
            ksi, vsi = ks[i], vs[i]
            ksi.index_put_((write_blk, write_off), k_sc)
            vsi.index_put_((write_blk, write_off), v_sc)
        kc[i].index_put_((write_blk, write_off), k.to(kc[i].dtype))
        vc[i].index_put_((write_blk, write_off), v.to(vc[i].dtype))
        att = _paged_attn(q, kc[i], vc[i], tables, lens, ksi, vsi,
                          attn_impl)
        hidden = residual + attn.o_proj(att.view(s, 1, h * d))
        hidden = hidden + layer.mlp(layer.post_attention_layernorm(hidden))
    return model.lm_head(core.norm(hidden))[:, 0]


class _StateBuffers:
    """The decode dispatch's slot state as views of ONE device byte
    buffer, beside two host buffers of the same layout (pinned on the
    card): ``stage``, which the host mirrors are copied into before one
    host-to-device copy of the whole buffer, and ``back``, which one
    device-to-host copy fills after the dispatch. ``dev``, ``stage`` and
    ``back`` map each field's name to its view (numpy on the host)."""

    def __init__(self, fields, device):
        layout, n = {}, 0
        for name, shape, dtype in fields:
            n = -(-n // 8) * 8
            size = (int(np.prod(shape))
                    * torch.empty((), dtype=dtype).element_size())
            layout[name] = (n, size, shape, dtype)
            n += size
        pin = device.type == "cuda"
        self.device_buf = torch.zeros(n, dtype=torch.uint8, device=device)
        self.stage_buf = torch.zeros(n, dtype=torch.uint8, pin_memory=pin)
        self.back_buf = torch.zeros(n, dtype=torch.uint8, pin_memory=pin)

        def views(buf):
            return {name: buf[o:o + size].view(dtype).view(shape)
                    for name, (o, size, shape, dtype) in layout.items()}

        self.dev = views(self.device_buf)
        self.stage = {k: v.numpy() for k, v in views(self.stage_buf).items()}
        self.back = {k: v.numpy() for k, v in views(self.back_buf).items()}


# the host mirrors staged into the state buffers before each dispatch
_STAGED = ("tables", "seq_lens", "last_tok", "n_gen", "max_new", "seeds",
           "temps", "done")


class ServingEngine:
    """Multiplex many in-flight generation requests over one shared paged
    KV pool.

    Args:
        model: a :class:`~paddle_tpu_torch.nlp.LlamaForCausalLM` on
            ``device``; its parameter dtype is the pool dtype.
        num_slots: fixed decode batch capacity.
        block_size: KV pool block size in tokens.
        num_blocks: pool capacity; default ``num_slots`` full-context
            sequences plus the scratch block.
        max_context: per-request prompt + generation bound (default the
            model's ``max_position_embeddings``).
        prefill_chunk / decode_quantum: see ``SchedulerConfig``.
        decode_strategy: ``"greedy"`` or ``"sampling"`` (engine-wide
            ``top_k``/``top_p``/``temperature``, per-request ``seed``).
        eos_token_id: retire a slot the step after it emits this id.
        per_request_sampling: (sampling only) each slot takes its own
            ``submit(..., temperature=)``, divided into the logits before
            the top-k/top-p cut; a request without one gets the
            engine-wide temperature.
        quantize: ``"weight_only_int8"`` (or ``"llm.int8"``, the same
            algorithm) sweeps the model's Linears IN PLACE to
            :class:`~paddle_tpu_torch.nn.quant.QuantizedLinear` (int8
            weights, per-output-channel f32 scales) before ``eval()``.
            Greedy streams equal a float engine's over the dequantized
            weights. ``None``: float weights.
        kv_dtype: ``"int8"`` builds int8 pools with per-row f32 scale
            pools; ``None`` keeps float pools in the model's dtype.
        multi_quantum: ``K > 1`` runs up to K decode quanta per dispatch
            (K replays of the quantum's graph, one host sync) while
            ``Scheduler.steady_state()`` holds; the tables grow to cover
            the K quanta first. ``decode_quanta`` counts the quanta that
            started with a live row, as the reference's while loop does;
            later quanta still run, masked (no on-device early exit).
            Streams equal the K=1 engine's. Default 1. On the card it
            saves host syncs only, and a replayed quantum's host time is
            small beside its device time: K=4 measured no faster than
            K=1 (PERF.md).
        attn_impl: ``"gather"`` or ``"fused"``, for parity with the
            reference's options. On the card it changes nothing: both
            launch K2. On the CPU ``"fused"`` runs the online-softmax
            port of the reference's ``_fused_paged_decode_attn`` instead
            of the gather, the port held to the reference's in the CPU
            tests. Streams are equal.
        device: default ``cuda``; raises without CUDA unless ``"cpu"``.

    On the card the decode quantum runs only as a captured CUDA graph,
    captured at the first decode dispatch and never rebuilt; a failed
    capture or replay raises. (``_eager = True`` on an engine runs the
    same body eagerly: the oracle of the card's tests.)
    """

    # run the quantum's body eagerly on the card (a test oracle; the
    # captured graph is the engine's decode path)
    _eager = False

    def __init__(self, model, num_slots=8, block_size=32, num_blocks=None,
                 max_context=None, prefill_chunk=64, decode_quantum=8,
                 decode_strategy="greedy", top_k=0, top_p=1.0,
                 temperature=1.0, eos_token_id=None,
                 per_request_sampling=False, quantize=None, kv_dtype=None,
                 multi_quantum=1, attn_impl="gather", device=None):
        cfg = model.config
        if getattr(cfg, "sliding_window", None):
            raise NotImplementedError(
                "ServingEngine does not compose with sliding_window: a "
                "rolling buffer wrap-writes over pool slots the block "
                "tables still map")
        if decode_strategy not in ("greedy", "sampling"):
            raise ValueError(
                f"decode_strategy must be greedy|sampling, got "
                f"{decode_strategy!r}")
        self._per_request_sampling = bool(per_request_sampling)
        if self._per_request_sampling and decode_strategy != "sampling":
            raise ValueError(
                "per_request_sampling=True requires "
                "decode_strategy='sampling' (per-slot temperature only "
                "changes the sampling quantum)")
        if attn_impl not in ("gather", "fused"):
            raise ValueError(
                f"attn_impl must be gather|fused, got {attn_impl!r}")
        self.attn_impl = attn_impl
        self._mq_max = int(multi_quantum)
        if self._mq_max < 1:
            raise ValueError(
                f"multi_quantum must be >= 1, got {multi_quantum}")
        self.decode_strategy = decode_strategy
        self.top_k = 0 if top_k is None else int(top_k)
        self.top_p = 1.0 if top_p is None else float(top_p)
        self.temperature = 1.0 if temperature is None else float(temperature)
        self.device = resolve_device(device)
        params = list(model.parameters())
        if params[0].device.type != self.device.type:
            raise ValueError(
                f"the model lies on {params[0].device}, the engine on "
                f"{self.device}: build the model with device=")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"unsupported kv_dtype {kv_dtype!r} (None or 'int8')")
        if quantize is not None:
            # sweep before eval(): the quantized layers are what runs
            quantize_for_serving(model, algo=quantize)
            params = list(model.parameters())
        model.eval()
        self.model = model
        self.config = SchedulerConfig(num_slots=num_slots,
                                      prefill_chunk=prefill_chunk,
                                      decode_quantum=decode_quantum)
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.max_context = int(max_context or cfg.max_position_embeddings)
        # the float pools' dtype: the first FLOATING parameter's (a
        # quantized model's first Linear parameter is int8)
        cache_dtype = next(p.dtype for p in params if p.is_floating_point())
        s = self.config.num_slots
        bs = int(block_size)
        w = -(-self.max_context // bs)
        if num_blocks is None:
            num_blocks = s * w + 1  # +1: the masked-write scratch block
        self.pool = PagedKVCachePool(
            num_blocks, bs, cfg.num_key_value_heads, cfg.head_dim,
            num_layers=cfg.num_hidden_layers, dtype=cache_dtype,
            kv_dtype=kv_dtype, device=self.device)
        # masked (retired/empty) rows dump their KV writes here
        self._scratch_block = self.pool.ensure("__scratch__", 1)[0]
        self.scheduler = Scheduler(self.config, self.pool, reserved_blocks=1)
        self._table_width = w

        # host mirrors of the per-slot device state
        self._tables = np.zeros((s, w), np.int32)
        self._seq_lens = np.zeros(s, np.int32)
        self._last_tok = np.zeros(s, np.int32)
        self._n_gen = np.zeros(s, np.int32)
        self._done = np.ones(s, bool)
        self._max_new = np.zeros(s, np.int32)
        self._seeds = np.zeros(s, np.int64)
        self._temps = np.ones(s, np.float32)
        # ... and the static device buffers the quantum reads and writes:
        # the mirrors, the (K, T, S) token buffer, the quantum index and
        # the count of quanta that started with a live row
        t = self.config.decode_quantum
        self._state = _StateBuffers(
            [("tables", (s, w), torch.int32),
             ("seq_lens", (s,), torch.int32),
             ("last_tok", (s,), torch.int32),
             ("n_gen", (s,), torch.int32),
             ("max_new", (s,), torch.int32),
             ("seeds", (s,), torch.int64),
             ("temps", (s,), torch.float32),
             ("done", (s,), torch.bool),
             ("toks", (self._mq_max, t, s), torch.int32),
             ("qi", (1,), torch.int64),
             ("count", (1,), torch.int32)], self.device)
        self._graph = None          # the quantum's CapturedStep
        self._graph_pools = None    # the pool addresses it captured
        self._graph_error = None    # a failed capture stops the engine

        # rotary table of prefill (block_mha fused rope); the quantum
        # computes the same angles per row on the device
        cos, sin = build_rope_cache(self.max_context, cfg.head_dim,
                                    base=cfg.rope_theta, device=self.device)
        self._rotary = torch.stack([cos, sin])
        self.completed: list = []
        self.stats = {"steps": 0, "mixed_steps": 0, "decode_quanta": 0,
                      "quantum_tokens": 0, "prefill_tokens": 0,
                      "generated_tokens": 0, "occupancy_sum": 0.0}

    # -- public API --------------------------------------------------------
    def submit(self, prompt, max_new_tokens=32, req_id=None, seed=0,
               arrival_time=None, priority=1, temperature=None,
               stop_token_ids=None, stop_sequences=None):
        """Queue one request; returns the :class:`Request` handle.
        ``seed`` keys the request's sampled stream; ``temperature`` needs
        an engine built with ``per_request_sampling=True``."""
        if temperature is not None and not self._per_request_sampling:
            raise ValueError(
                "per-request temperature needs an engine built with "
                "per_request_sampling=True (and "
                "decode_strategy='sampling')")
        req = Request(prompt, max_new_tokens=max_new_tokens, req_id=req_id,
                      seed=seed, priority=priority, temperature=temperature,
                      stop_token_ids=stop_token_ids,
                      stop_sequences=stop_sequences,
                      arrival_time=(time.perf_counter()
                                    if arrival_time is None
                                    else arrival_time))
        total = req.prompt_len + req.max_new_tokens
        if total > self.max_context:
            raise ValueError(
                f"request needs {total} tokens > max_context "
                f"{self.max_context}")
        self.scheduler.submit(req)
        return req

    def preempt(self, req):
        """Evict a live request: its blocks return to the pool, its slot
        frees, and it re-enters the head of its priority class; the next
        admission re-prefills ``prompt + tokens`` and the stream continues
        as if undisturbed."""
        if req.slot is None or req.finished:
            raise ValueError(
                f"request {req.req_id} is not live — only an admitted, "
                f"unfinished request can be preempted")
        self._done[req.slot] = True
        self._max_new[req.slot] = 0
        self.scheduler.preempt(req)
        return req

    @property
    def has_work(self):
        return self.scheduler.has_work

    def step(self):
        """One scheduler iteration: admit, then either a mixed
        prefill(+decode) step or a decode dispatch, then retire. Returns
        whether work remains. Exactly ``step_collect(step_dispatch())``."""
        return self.step_collect(self.step_dispatch())

    def step_dispatch(self):
        """The dispatch half of :meth:`step`: admit, then either run the
        mixed step to completion (returns ``None``) or enqueue the decode
        quantum (K quanta in steady state) and its read-back WITHOUT a
        host sync, returning a pending record for :meth:`step_collect`.
        Between the halves the card works while the host is free (e.g. to
        dispatch another engine)."""
        self.stats["steps"] += 1
        self._admit()
        live = self.scheduler.live()
        self.stats["occupancy_sum"] += len(live) / self.config.num_slots
        if self.scheduler.prefilling():
            self._mixed_step()
        elif self.scheduler.decoding():
            return self._decode_dispatch()
        return None

    def step_collect(self, pending):
        """The collect half of :meth:`step`: wait for the pending
        dispatch, refresh the host mirrors, record its tokens and retire
        finished requests. ``pending=None`` (the step completed in
        :meth:`step_dispatch`) only reports whether work remains."""
        if pending is not None:
            self._decode_collect(pending)
        return self.scheduler.has_work

    def run(self, requests=None):
        """Submit ``requests`` (if given) and drive until idle; returns
        the completed :class:`Request` list in retirement order."""
        for r in requests or ():
            if isinstance(r, Request):
                self.scheduler.submit(r)
            elif isinstance(r, dict):
                self.submit(**r)
            else:
                self.submit(r)
        while self.step():
            pass
        return self.completed

    def output_tokens(self, req):
        """prompt + generated ids as one int32 array."""
        return np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])

    def engine_stats(self):
        out = dict(self.stats)
        out["pool"] = self.pool.fragmentation_stats()
        out["admitted"] = self.scheduler.admitted_total
        out["finished"] = self.scheduler.finished_total
        out["preempted"] = self.scheduler.preempted_total
        out["resumed"] = self.scheduler.resumed_total
        if self.stats["steps"]:
            out["mean_occupancy"] = (self.stats["occupancy_sum"]
                                     / self.stats["steps"])
        return out

    # -- scheduling --------------------------------------------------------
    def _admit(self):
        now = time.perf_counter()
        for req in self.scheduler.try_admit():
            req.admit_time = now
            slot = req.slot
            self._seq_lens[slot] = 0
            self._n_gen[slot] = 0
            self._done[slot] = True  # not decodable until prefill ends
            self._max_new[slot] = req.max_new_tokens
            self._seeds[slot] = req.seed
            self._temps[slot] = (self.temperature if req.temperature is None
                                 else req.temperature)

    def _dev(self, a):
        return torch.from_numpy(np.array(a)).to(self.device,
                                                non_blocking=True)

    def _select(self, logits, slots, steps):
        """Next tokens (R,) for logits (R, V): argmax, or a filtered
        categorical draw keyed by (the slot's request seed, ``steps`` (R,)
        on the device: tokens the slot has emitted so far). ``slots`` is
        a host list of the rows' slots (the mixed step), or ``None`` for
        every slot in order (the quantum, which reads the seeds and
        temperatures from its state buffers: no host value enters it)."""
        if self.decode_strategy == "greedy":
            return torch.argmax(logits, dim=-1)
        d = self._state.dev
        seeds = d["seeds"] if slots is None else self._dev(self._seeds[slots])
        if self._per_request_sampling:
            temps = (d["temps"] if slots is None
                     else self._dev(self._temps[slots]))
            filt = _filter_logits(logits.float() / temps.clamp_min(1e-6)[
                :, None], self.top_k, self.top_p, None)
        else:
            filt = _filter_logits(logits, self.top_k, self.top_p,
                                  self.temperature)
        return keyed_gumbel_argmax(filt, seeds, steps)

    @torch.inference_mode()
    def _mixed_forward(self, tables, enc_lens, dec_lens, this_time, ids):
        """One mixed prefill(+decode) forward through
        ``block_multihead_attention`` per layer; the pools are written in
        place. Returns the (T, E) final hidden states."""
        model = self.model
        cfg = model.config
        core = model.llama
        h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        common = dict(
            seq_lens_encoder=np.asarray(enc_lens, np.int32),
            seq_lens_decoder=np.asarray(dec_lens, np.int32),
            seq_lens_this_time=np.asarray(this_time, np.int32),
            block_tables=tables, rotary_embs=self._rotary,
            use_neox_rotary_style=True,  # the model's rope layout
            num_heads=h, kv_num_heads=hk, head_dim=d)
        hidden = core.embed_tokens(self._dev(ids))          # (T, E)
        pool = self.pool
        for i, layer in enumerate(core.layers):
            attn = layer.self_attn
            x = layer.input_layernorm(hidden)
            qkv = torch.cat([attn.q_proj(x), attn.k_proj(x),
                             attn.v_proj(x)], dim=-1)
            # an int8 pool threads its per-row scale pools (written in
            # place beside the rows)
            scales = ({} if not pool.quantized else
                      dict(cache_k_scale_pool=pool.k_scales[i],
                           cache_v_scale_pool=pool.v_scales[i]))
            att = block_multihead_attention(
                qkv, pool.k_pools[i], pool.v_pools[i], **common, **scales)
            hidden = hidden + attn.o_proj(att)
            hidden = hidden + layer.mlp(layer.post_attention_layernorm(hidden))
        return core.norm(hidden)

    def _mixed_step(self):
        """One chunk of prefill for every prefilling slot and one decode
        token for every in-flight slot, as a single mixed batch."""
        self.stats["mixed_steps"] += 1
        chunk = self.config.prefill_chunk
        pre = self.scheduler.prefilling()
        dec = self.scheduler.decoding()
        rows = pre + dec
        toks, this_time, enc_lens, dec_lens = [], [], [], []
        for req in pre:
            n = min(chunk, req.prefill_target - req.prefill_pos)
            toks.append(req.prefill_src[req.prefill_pos:req.prefill_pos + n])
            this_time.append(n)
            enc_lens.append(n)
            dec_lens.append(req.prefill_pos)
            self.pool.ensure(req.req_id, req.prefill_pos + n)
        for req in dec:
            slot = req.slot
            toks.append(np.asarray([self._last_tok[slot]], np.int32))
            this_time.append(1)
            enc_lens.append(0)
            dec_lens.append(int(self._seq_lens[slot]))
            self.pool.ensure(req.req_id, int(self._seq_lens[slot]) + 1)
        ids = np.concatenate(toks).astype(np.int32)
        self.stats["prefill_tokens"] += int(sum(enc_lens))
        cu = np.concatenate([[0], np.cumsum(this_time)]).astype(np.int64)
        tables = self.pool.block_table_array(
            [r.req_id for r in rows], pad_to=self._table_width)
        hidden = self._mixed_forward(tables, enc_lens, dec_lens, this_time,
                                     ids)

        # logits only where a next token is due: rows completing their
        # prefill this chunk, and every decode row
        need = [i for i, req in enumerate(rows)
                if (i >= len(pre))
                or (req.prefill_pos + this_time[i] >= req.prefill_target)]
        if need:
            last_idx = self._dev(np.asarray([cu[i + 1] - 1 for i in need]))
            picked = [rows[i] for i in need]
            with torch.inference_mode():
                logits = self.model.lm_head(hidden[last_idx])
                nxt = self._select(
                    logits, [r.slot for r in picked],
                    self._dev(np.asarray([len(r.tokens) for r in picked],
                                         np.int64))).cpu().numpy()
        now = time.perf_counter()
        for i, req in enumerate(rows):
            slot = req.slot
            if i < len(pre):
                req.prefill_pos += this_time[i]
                self._seq_lens[slot] = req.prefill_pos
                if req.prefill_pos >= req.prefill_target:
                    tok = int(nxt[need.index(i)])
                    if req.first_token_time is None:
                        req.first_token_time = now
                    req.record(tok, self.eos_token_id)
                    self._record_host(slot, req, tok)
            else:
                tok = int(nxt[need.index(i)])
                self._seq_lens[slot] += 1  # last_tok entered the cache
                req.record(tok, self.eos_token_id)
                self._record_host(slot, req, tok)
        self._retire_finished()

    def _record_host(self, slot, req, tok):
        self._last_tok[slot] = tok
        self._n_gen[slot] = len(req.tokens)
        self._done[slot] = req.finished

    # -- the decode quantum ------------------------------------------------
    def _choose_k(self):
        """Quanta the next dispatch runs: ``multi_quantum`` when the
        scheduler is in steady state (the batch cannot change before the
        dispatch lands), else 1."""
        if self._mq_max > 1 and self.scheduler.steady_state():
            return self._mq_max
        return 1

    @torch.inference_mode()
    def _quantum_body(self):
        """``decode_quantum`` steps for every slot over the state buffers
        alone (the function the card captures and the CPU runs): the
        state is written back in place and the tokens land in
        ``toks[qi]``. A slot live at a step has emitted ``n_gen`` tokens,
        which keys its draw; a done slot's draw is discarded."""
        d = self._state.dev
        tables, max_new = d["tables"], d["max_new"]
        seq_lens, last_tok = d["seq_lens"], d["last_tok"]
        n_gen, done = d["n_gen"], d["done"]
        pool = self.pool
        eos = self.eos_token_id
        # the quanta that start with a live row: the reference's
        # while-loop count (done only grows within a dispatch)
        d["count"].add_((~done.all()).int())
        toks = []
        for _ in range(self.config.decode_quantum):
            live = ~done
            logits = paged_decode_math(
                self.model, self._scratch_block, last_tok[:, None],
                seq_lens, tables, pool.k_pools, pool.v_pools, live,
                pool.k_scales, pool.v_scales, self.attn_impl)
            nxt = self._select(logits, None, n_gen).int()
            nxt = torch.where(done, last_tok, nxt)
            n_gen = n_gen + live.int()
            done_next = done | (n_gen >= max_new)
            if eos is not None:
                done_next = done_next | (live & (nxt == eos))
            seq_lens = seq_lens + live.int()
            last_tok, done = nxt, done_next
            toks.append(nxt)
        d["toks"].index_copy_(0, d["qi"], torch.stack(toks)[None])
        d["qi"].add_(1)
        for name, val in (("seq_lens", seq_lens), ("last_tok", last_tok),
                          ("n_gen", n_gen), ("done", done)):
            d[name].copy_(val)

    def _pool_ptrs(self):
        pool = self.pool
        return tuple(t.data_ptr() for t in (*pool.k_pools, *pool.v_pools,
                                            *pool.k_scales, *pool.v_scales))

    def _run_quanta(self, k):
        """Run ``k`` quanta on the staged state: eagerly on the CPU (or
        with ``_eager``), else as replays of the captured quantum. The
        first dispatch on the card captures it: its first quantum is the
        warm-up on the capture stream (the kernel library's load, K2's
        ticket buffer of that stream, cuBLAS's workspace), then the
        capture; the graph is never rebuilt."""
        if self.device.type != "cuda" or self._eager:
            for _ in range(k):
                self._quantum_body()
            return
        if self._graph_error is not None:
            raise RuntimeError(
                "the decode quantum's CUDA graph failed to capture; the "
                "engine cannot decode") from self._graph_error
        if self._graph is None:
            step = CapturedStep(self._quantum_body, self.device)
            try:
                step.warm_up()
                step.capture()
            except BaseException as exc:
                # the warm-up already moved the device state, and a failed
                # capture leaves torch's CUDA generators marked as
                # capturing: the engine stops decoding
                self._graph_error = exc
                raise
            self._graph = step
            self._graph_pools = self._pool_ptrs()
            k -= 1
        if self._pool_ptrs() != self._graph_pools:
            raise RuntimeError(
                "the KV pools were reallocated after the decode quantum "
                "was captured; its graph would write freed memory")
        for _ in range(k):
            self._graph.replay()

    def _decode_dispatch(self):
        """Grow the tables to cover the dispatch, stage the host mirrors
        into the state buffers (one copy), run the quanta, and enqueue
        the read-back of the whole buffer (one copy) behind an event:
        no host sync. Returns the pending record."""
        t_steps = self.config.decode_quantum
        k = self._choose_k()
        rows = self.scheduler.decoding()
        for req in rows:
            # cover the whole dispatch (K quanta) before entering the
            # device loop, capped by the request's own prompt + max_new
            # bound, which admission reserved
            slot = req.slot
            cap = req.prompt_len + req.max_new_tokens - 1
            need = min(int(self._seq_lens[slot]) + k * t_steps, cap)
            row = self.pool.grow_decode_table(
                req.req_id, need, int(self._seq_lens[slot]),
                pad_to=self._table_width)
            self._tables[slot] = row[:self._table_width]
        st = self._state
        for name in _STAGED:
            np.copyto(st.stage[name], getattr(self, "_" + name))
        st.stage["qi"][0] = 0
        st.stage["count"][0] = 0
        st.device_buf.copy_(st.stage_buf, non_blocking=True)
        self._run_quanta(k)
        st.back_buf.copy_(st.device_buf, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return {"rows": rows, "k": k, "event": event}

    def _decode_collect(self, pending):
        """Wait for the dispatch (the ONE host sync), refresh the host
        mirrors, record the tokens of the quanta that ran and account
        them, then retire finished requests."""
        if pending["event"] is not None:
            pending["event"].synchronize()
        back = self._state.back
        self._seq_lens = back["seq_lens"].copy()
        self._last_tok = back["last_tok"].copy()
        self._n_gen = back["n_gen"].copy()
        self._done = back["done"].copy()
        n_exec = max(int(back["count"][0]), 1)
        toks = back["toks"][:n_exec].reshape(-1, self.config.num_slots)
        self.stats["decode_quanta"] += n_exec
        self.stats["quantum_tokens"] += int(toks.shape[0] * toks.shape[1])
        now = time.perf_counter()
        for req in pending["rows"]:
            for j in range(toks.shape[0]):
                if req.finished:
                    break
                req.record(int(toks[j, req.slot]), self.eos_token_id)
            if req.finished:
                req.finish_time = now
        self._retire_finished()

    def _retire_finished(self):
        now = time.perf_counter()
        for req in list(self.scheduler.live()):
            if req.finished:
                slot = req.slot
                if req.finish_time is None:
                    req.finish_time = now
                self.stats["generated_tokens"] += len(req.tokens)
                self._done[slot] = True
                self._max_new[slot] = 0
                self.scheduler.retire(req)
                self.completed.append(req)
