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
(the quantum's attention is K2's per-row mode).

``prefix_cache=True`` turns on the pool's content-addressed prefix cache:
admission aliases the longest cached chain of a request's full prompt
blocks into its table and its prefill starts after them (one token short
of a fully cached prompt, whose last token is prefilled again to emit the
first token); at prefill completion the prompt's full blocks are
published. A write into a block another holder maps copies it first
(copy-on-write), in the mixed step before the forward and in the decode
dispatch before the mirrors are staged. The copy is made in place on the
current stream, so the captured quantum's pool addresses never change and
its replay sees the copy.

``spec_draft=`` makes the decode dispatch the speculative round
(:mod:`~paddle_tpu_torch.serving.speculative`): the draft's γ+1 steps of
:func:`paged_decode_math` over its own pool, the target's chunked verify
(:func:`paged_chunk_math`), acceptance and both pools' roll forward, all on
the device as one captured graph with one host sync per round. The draft
ingests the mixed prefill rows beside the target, and its pool grows,
attaches, publishes and copies prefixes in lockstep with the target's.
Observability rides the same host boundaries: ``obs=`` (a
:class:`~paddle_tpu_torch.obs.ServingObs`, ``"off"``, or a fresh one) holds
the metrics registry (``stats`` is its legacy view), ``trace=True`` a Chrome
trace, ``slo=`` the burn-rate objectives behind :meth:`health`, ``flight=``
the per-request flight recorder, and ``token_sink`` streams each emitted
token to the front door (:mod:`~paddle_tpu_torch.serving.frontend`). No hook
reads a tensor or synchronizes the card. Fault injection, resilience and
snapshots (ROADMAP A5), tensor parallelism (A7) and the cost model (A8) are
later slices: their options raise.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from .._graphs import CapturedStep
from .._later import not_ported
from ..incubate.nn.functional import block_multihead_attention
from ..nlp.generation import _filter_logits, keyed_gumbel_argmax
from ..nlp.paged_cache import PagedKVCachePool
from ..nn.functional.rope import build_rope_cache, inv_freq
from ..nn.quant import quantize_for_serving, quantize_kv_rows
from ..obs.attribution import decode_flops_per_token
from ..obs.flight import FlightRecorder
from ..obs.serving import ServingObs
from ..obs.slo import SLOSet
from ..obs.trace import TraceRecorder
from ..ops import _library as L
from ..ops.paged_attention import (_paged_decode_attention_rows,
                                   paged_decode_attention)
from ..profiler.mfu import peak_flops_per_chip
from .scheduler import Request, Scheduler, SchedulerConfig

__all__ = ["ServingEngine", "paged_decode_math", "paged_chunk_math"]


def _rope_rows(x, cos, sin):
    """Rotate (..., H, D) rows by per-row angles (..., D/2), neox layout,
    in f32 (the model's rotary layout at each row's own cache position):
    (S, H, D) with (S, D/2) for the decode quantum, (S, C, H, D) with
    (S, C, D/2) for the speculative verify chunk."""
    xf = x.float()
    c = cos[..., None, :]
    s = sin[..., None, :]
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


def _paged_chunk_attn(q, kp, vp, tables, base_lens, ks=None, vs=None):
    """Chunked decode attention over the paged pool (the speculative
    verify; port of the reference's ``_xla_paged_chunk_attn``): query
    position j of slot s attends pool positions ``< base_lens[s] + j +
    1``, through a gather of the slot's table and an f32 masked softmax.
    ``ks``/``vs`` are an int8 pool's per-row scale pools. q (S, C, H, D);
    returns (S, C, H, D) in q's dtype. The reference has no Pallas kernel
    for it, so it stays PyTorch; its shapes are static and it reads no
    host value, so a graph can capture it.

    The gathered rows are moved once, by the copy that casts them, into
    (HK, S, W·BS, D): one batched product over (KV head, slot) then reads
    them as they lie, a GQA group's query heads the rows of its head's
    product. On the card a bf16 K is not cast: Q·Kᵀ is taken on the bf16
    rows with f32 accumulation and f32 output (``bmm(out_dtype=)``), the
    same products as on f32 copies of them (a bf16 product is exact in
    f32). ``scripts/torch_spec_verify_variants.py`` times the layouts."""
    s_, c, h, d = q.shape
    w = tables.shape[1]
    bs, hk = kp.shape[1], kp.shape[2]
    rep, n = h // hk, w * bs
    dev = q.device
    t = tables.long()
    native = (ks is None and q.is_cuda and q.dtype != torch.float32
              and kp.dtype == q.dtype)

    def moved(pool, scales, dtype):
        rows = pool[t].reshape(s_, n, hk, d)
        if scales is not None:
            rows = rows.float() * scales[t].reshape(s_, n, hk)[..., None]
        out = torch.empty((hk, s_, n, d), dtype=dtype, device=dev)
        out.copy_(rows.permute(2, 0, 1, 3))
        return out.view(hk * s_, n, d)

    k = moved(kp, ks, q.dtype if native else torch.float32)
    v = moved(vp, vs, torch.float32)
    # (S, C, HK, R, D) -> (HK·S, R·C, D): query head g·R + r reads head g
    qr = q.reshape(s_, c, hk, rep, d).permute(2, 0, 3, 1, 4).reshape(
        hk * s_, rep * c, d)
    if native:
        logits = torch.bmm(qr, k.transpose(1, 2), out_dtype=torch.float32)
    else:
        logits = torch.bmm(qr.float(), k.transpose(1, 2))
    logits = logits * (1.0 / math.sqrt(d))
    lens = (base_lens.to(dev)[:, None]
            + torch.arange(c, device=dev)[None, :] + 1)       # (S, C)
    mask = torch.arange(n, device=dev)[None, None, :] < lens[:, :, None]
    logits = torch.where(mask[None, :, None],
                         logits.view(hk, s_, rep, c, n), -1e30)
    p = torch.softmax(logits, dim=-1).view(hk * s_, rep * c, n)
    out = torch.bmm(p, v).view(hk, s_, rep, c, d)
    return out.permute(1, 3, 0, 2, 4).reshape(s_, c, h, d).to(q.dtype)


def paged_chunk_math(model, scratch_block, ids_t, seq_lens, tables, kc, vc,
                     live, ks=(), vs=()):
    """The C-token forward of every slot over a paged pool (the
    speculative round's target verify). ``ids_t`` (S, C): chunk position
    j rotates at ``seq_lens + j``, writes its KV in place at ``seq_lens +
    j`` (a masked row writes into the scratch block) and attends its own
    prefix (:func:`_paged_chunk_attn`). ``ks``/``vs``: an int8 pool's
    per-layer scale pools, each written row quantized by its own abs-max.
    Rejected positions are rolled back by the length mask alone: the
    caller advances ``seq_lens`` by the accepted count and the next
    round's writes overwrite the rest. Returns logits (S, C, vocab)."""
    cfg = model.config
    core = model.llama
    s, c = ids_t.shape
    h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                cfg.head_dim)
    bs = kc[0].shape[1]
    w = tables.shape[1]
    dev = ids_t.device

    hidden = core.embed_tokens(ids_t)                   # (S, C, E)
    wpos = seq_lens[:, None] + torch.arange(c, device=dev, dtype=torch.int32)
    freqs = wpos.float()[..., None] * inv_freq(d, cfg.rope_theta, dev)
    cos, sin = torch.cos(freqs), torch.sin(freqs)        # (S, C, D/2)

    blk_idx = torch.clamp(wpos // bs, 0, w - 1).long()
    own_blk = tables.gather(1, blk_idx).long()
    write_blk = torch.where(live[:, None], own_blk, scratch_block)
    write_off = torch.where(live[:, None], wpos % bs, 0).long()
    base_lens = torch.where(live, seq_lens, 0)

    for i, layer in enumerate(core.layers):
        attn = layer.self_attn
        residual = hidden
        x = layer.input_layernorm(hidden)
        qk = _rope_rows(torch.cat([attn.q_proj(x).view(s, c, h, d),
                                   attn.k_proj(x).view(s, c, hk, d)], dim=2),
                        cos, sin)
        q, k = qk[:, :, :h], qk[:, :, h:]
        v = attn.v_proj(x).view(s, c, hk, d)
        ksi = vsi = None
        if ks:
            k, k_sc = quantize_kv_rows(k)
            v, v_sc = quantize_kv_rows(v)
            ksi, vsi = ks[i], vs[i]
            ksi.index_put_((write_blk, write_off), k_sc)
            vsi.index_put_((write_blk, write_off), v_sc)
        kc[i].index_put_((write_blk, write_off), k.to(kc[i].dtype))
        vc[i].index_put_((write_blk, write_off), v.to(vc[i].dtype))
        att = _paged_chunk_attn(q, kc[i], vc[i], tables, base_lens, ksi, vsi)
        hidden = residual + attn.o_proj(att.reshape(s, c, h * d))
        hidden = hidden + layer.mlp(layer.post_attention_layernorm(hidden))
    return model.lm_head(core.norm(hidden))


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
# (a speculative engine stages the draft pool's tables too)
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
        spec_draft: a draft causal LM (same vocab) turns the decode
            dispatch into the speculative round
            (:mod:`~paddle_tpu_torch.serving.speculative`): the draft
            proposes ``spec_gamma`` tokens over its own paged pool
            (``d_pool``), the target verifies all γ+1 positions in one
            chunked forward, and acceptance, the bonus or residual token
            and both pools' roll forward happen on the device, one host
            sync per round. Greedy streams equal the target's own greedy
            decode; ``decode_strategy="sampling"`` is rejection sampling,
            exact in distribution (a draft equal to the target replays
            the plain sampling engine). The draft is fed the same mixed
            prefill rows as the target, its pool attaches, publishes and
            copies prefixes in lockstep, ``quantize=`` sweeps it too and
            ``kv_dtype="int8"`` makes its pool int8. ``multi_quantum``
            does not apply: each round needs its counts on the host.
        spec_gamma: proposals per speculative round (default 4).
        prefix_cache: content-addressed prefix caching (default off).
            Requests sharing full prompt blocks with a published prompt
            skip their prefill (the shared-system-prompt case) and alias
            the blocks instead of holding copies; admission counts only
            their novel blocks; a write into a shared block copies it in
            place first. Greedy streams equal the unshared engine's in
            f32 (in bf16 the mixed batches differ in rows, so a near-tie
            may part). ``engine_stats()["prefix_cache"]`` holds the
            pool's counters.
        obs: a :class:`~paddle_tpu_torch.obs.ServingObs` to record into
            (share a registry across engines), ``"off"`` (only the legacy
            ``stats`` counters count), or ``None`` (a fresh one).
        trace: record a Chrome trace (``obs.tracer``).
        slo: ``True`` (the stock objectives), an
            :class:`~paddle_tpu_torch.obs.SLOSet` or a list of
            :class:`~paddle_tpu_torch.obs.SLO`; :meth:`health` evaluates
            them.
        flight: ``True`` or a
            :class:`~paddle_tpu_torch.obs.FlightRecorder`: per-request
            journals, dumped on anomaly.
        device: default ``cuda``; raises without CUDA unless ``"cpu"``.

    Every observability hook runs on the host at the reference's
    boundaries, on values the host already holds: a decode dispatch keeps
    its one host sync with everything on. A decode quantum's ``device_s``
    is the host clock from the dispatch's return to its collect's sync.
    ``mesh=`` / ``tp=`` (ROADMAP A7), ``faults=`` / ``resilience=`` (A5)
    and ``cost_model=True`` (A8) raise ``NotImplementedError``.

    On the card the decode quantum (or the speculative round) runs only
    as a captured CUDA graph, captured at the first decode dispatch and
    never rebuilt; a failed capture or replay raises. (``_eager = True``
    on an engine runs the same body eagerly: the oracle of the card's
    tests.)
    """

    # run the quantum's body eagerly on the card (a test oracle; the
    # captured graph is the engine's decode path)
    _eager = False

    def __init__(self, model, num_slots=8, block_size=32, num_blocks=None,
                 max_context=None, prefill_chunk=64, decode_quantum=8,
                 decode_strategy="greedy", top_k=0, top_p=1.0,
                 temperature=1.0, eos_token_id=None, spec_draft=None,
                 spec_gamma=4, per_request_sampling=False, quantize=None,
                 kv_dtype=None, multi_quantum=1, attn_impl="gather",
                 prefix_cache=False, obs=None, trace=False, slo=None,
                 flight=None, mesh=None, tp=None, faults=None,
                 resilience=None, cost_model=False, device=None):
        cfg = model.config
        # cost_model=True: the reference's walker is analysis.cost
        for name, value, item in (
                ("mesh", mesh, "A7"), ("tp", tp, "A7"),
                ("faults", faults, "A5, second half"),
                ("resilience", resilience, "A5, second half"),
                ("cost_model", cost_model or None, "A8")):
            if value is not None:
                not_ported(f"ServingEngine({name}=)", item)()
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
        if self._per_request_sampling and spec_draft is not None:
            raise NotImplementedError(
                "per_request_sampling does not compose with spec_draft "
                "yet: the speculative round's acceptance math takes the "
                "engine-wide temperature")
        if spec_draft is not None:
            d_cfg = spec_draft.config
            if getattr(d_cfg, "sliding_window", None):
                raise NotImplementedError(
                    "speculative serving with a sliding-window draft is "
                    "not supported: rollback-by-length-mask cannot "
                    "restore rolling-buffer slots rejected proposals "
                    "wrapped over")
            if d_cfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    f"draft vocab {d_cfg.vocab_size} != target vocab "
                    f"{cfg.vocab_size}: acceptance compares token ids")
            if int(spec_gamma) < 1:
                raise ValueError(
                    f"spec_gamma must be >= 1, got {spec_gamma}")
        if attn_impl not in ("gather", "fused"):
            raise ValueError(
                f"attn_impl must be gather|fused, got {attn_impl!r}")
        self.attn_impl = attn_impl
        self.prefix_cache = bool(prefix_cache)
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
        for m in (model, spec_draft):
            if m is None:
                continue
            first = next(m.parameters())
            if first.device.type != self.device.type:
                raise ValueError(
                    f"the model lies on {first.device}, the engine on "
                    f"{self.device}: build the model with device=")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"unsupported kv_dtype {kv_dtype!r} (None or 'int8')")
        if quantize is not None:
            # sweep before eval(): the quantized layers are what runs
            quantize_for_serving(model, algo=quantize)
            if spec_draft is not None:
                quantize_for_serving(spec_draft, algo=quantize)
            params = list(model.parameters())
        model.eval()
        self.model = model
        self.spec_draft = spec_draft
        self.spec_gamma = int(spec_gamma)
        spec = spec_draft is not None
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
        # the speculative verify writes up to gamma positions past the
        # accepted history before the length mask rolls them back, so the
        # tables (and the admission's worst case) carry that margin
        margin = self.spec_gamma if spec else 0
        w = -(-(self.max_context + margin) // bs)
        if num_blocks is None:
            num_blocks = s * w + 1  # +1: the masked-write scratch block
        self.pool = PagedKVCachePool(
            num_blocks, bs, cfg.num_key_value_heads, cfg.head_dim,
            num_layers=cfg.num_hidden_layers, dtype=cache_dtype,
            prefix_cache=self.prefix_cache, kv_dtype=kv_dtype,
            device=self.device)
        # masked (retired/empty) rows dump their KV writes here (a pool
        # sequence of its own: never published, never evicted)
        self._scratch_block = self.pool.ensure("__scratch__", 1)[0]
        self.d_pool = None
        if spec:
            spec_draft.eval()
            d_cfg = spec_draft.config
            # the draft's pool: the same blocks and block size, the
            # draft's geometry and float dtype, int8 with the target's
            self.d_pool = PagedKVCachePool(
                num_blocks, bs, d_cfg.num_key_value_heads, d_cfg.head_dim,
                num_layers=d_cfg.num_hidden_layers,
                dtype=next(p.dtype for p in spec_draft.parameters()
                           if p.is_floating_point()),
                prefix_cache=self.prefix_cache, kv_dtype=kv_dtype,
                device=self.device)
            self._d_scratch_block = self.d_pool.ensure("__scratch__", 1)[0]
        self.scheduler = Scheduler(
            self.config, self.pool, reserved_blocks=1,
            companion_pools=[self.d_pool] if spec else [],
            token_margin=margin)
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
        # the count of quanta that started with a live row; a speculative
        # round's instead: the draft's tables, the (S, γ+1) emission
        # matrix, the per-slot yield and acceptance count
        fields = [("tables", (s, w), torch.int32),
                  ("seq_lens", (s,), torch.int32),
                  ("last_tok", (s,), torch.int32),
                  ("n_gen", (s,), torch.int32),
                  ("max_new", (s,), torch.int32),
                  ("seeds", (s,), torch.int64),
                  ("temps", (s,), torch.float32),
                  ("done", (s,), torch.bool)]
        self._staged = _STAGED
        if spec:
            self._d_tables = np.zeros((s, w), np.int32)
            self._staged = _STAGED + ("d_tables",)
            fields += [("d_tables", (s, w), torch.int32),
                       ("stream", (s, self.spec_gamma + 1), torch.int32),
                       ("emitted", (s,), torch.int32),
                       ("accepted", (s,), torch.int32)]
        else:
            t = self.config.decode_quantum
            fields += [("toks", (self._mq_max, t, s), torch.int32),
                       ("qi", (1,), torch.int64),
                       ("count", (1,), torch.int32)]
        self._state = _StateBuffers(fields, self.device)
        self._graph = None          # the quantum's (round's) CapturedStep
        self._graph_pools = None    # the pool addresses it captured
        self._graph_error = None    # a failed capture stops the engine

        # rotary table of prefill (block_mha fused rope); the quantum
        # computes the same angles per row on the device
        cos, sin = build_rope_cache(self.max_context, cfg.head_dim,
                                    base=cfg.rope_theta, device=self.device)
        self._rotary = torch.stack([cos, sin])
        self._body = self._quantum_body
        if spec:
            d_cos, d_sin = build_rope_cache(
                self.max_context, d_cfg.head_dim, base=d_cfg.rope_theta,
                device=self.device)
            self._d_rotary = torch.stack([d_cos, d_sin])
            from .speculative import make_spec_round

            self._spec_round = make_spec_round(self)
            self._body = self._spec_body
        self.completed: list = []
        # the front door's per-token push (serving/frontend.py)
        self.token_sink = None
        # observability: the registry (always on unless "off"), an
        # optional tracer; `stats` is the legacy view over its counters
        if obs == "off":
            self.obs = ServingObs(enabled=False)
        elif obs is None:
            self.obs = ServingObs(trace=trace)
        else:
            self.obs = obs
            if trace and self.obs.tracer is None:
                self.obs.tracer = TraceRecorder()
        self._now = self.obs.now
        self.stats = self.obs.legacy_stats_view()
        # the cost ledger's MFU constants: 2N FLOPs a token (embedding
        # gathers left out) over the card's bf16 dense peak. A quantized
        # engine keeps that peak: its int8 weights are dequantized and
        # the products run in bf16 (ROADMAP queue C)
        self.obs.ledger.configure(
            flops_per_token=decode_flops_per_token(
                sum(p.numel() for p in params),
                n_embedding_params=cfg.vocab_size * cfg.hidden_size),
            peak_flops=(peak_flops_per_chip(self.device)
                        if self.device.type == "cuda" else 0.0))
        # the SLOs behind health() and the flight recorder
        if slo is True:
            self.slo = SLOSet()
        elif slo is None or isinstance(slo, SLOSet):
            self.slo = slo
        else:
            self.slo = SLOSet(slo)
        if flight is True:
            self.flight = FlightRecorder(slo=self.slo)
        elif flight is None or flight is False:
            self.flight = None
        else:
            self.flight = flight

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
                      arrival_time=(self._now()
                                    if arrival_time is None
                                    else arrival_time))
        total = req.prompt_len + req.max_new_tokens
        if total > self.max_context:
            raise ValueError(
                f"request needs {total} tokens > max_context "
                f"{self.max_context}")
        self.scheduler.submit(req)
        self._on_submitted(req)
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
        slot = req.slot
        now = self._now()
        cached = int(self._seq_lens[slot])
        self._done[slot] = True
        self._max_new[slot] = 0
        self.scheduler.preempt(req)
        self.obs.on_preempt(req, now, cached_tokens=cached)
        if self.flight is not None:
            self.flight.on_preempt(req, now, cached_tokens=cached,
                                   tokens_emitted=len(req.tokens))
        return req

    def _on_submitted(self, req):
        """Observability for one queued request (its id comes from the
        scheduler, so this runs after the scheduler's submit)."""
        self.obs.on_submit(req)
        if self.flight is not None:
            self.flight.on_submit(req, req.arrival_time)

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
        self.obs.on_step(self._now(), len(live), self.config.num_slots,
                         self.pool, self.d_pool)
        if self.scheduler.prefilling():
            self._mixed_step()
        elif self.scheduler.decoding():
            if self.spec_draft is not None:
                # the host needs the round's counts before the next step:
                # it runs to completion here
                self._spec_round_step()
                return None
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
                self._on_submitted(r)
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
        if self.d_pool is not None:
            out["draft_pool"] = self.d_pool.fragmentation_stats()
            out["spec_acceptance_rate"] = (
                self.stats["spec_accepted"]
                / max(self.stats["spec_proposed"], 1))
        if self.prefix_cache:
            out["prefix_cache"] = self.pool.prefix_cache_stats()
            if self.d_pool is not None:
                out["draft_prefix_cache"] = self.d_pool.prefix_cache_stats()
        return out

    def attribution(self):
        """The cost ledger's report
        (:meth:`~paddle_tpu_torch.obs.CostLedger.report`) plus the raw
        counters its conservation invariants are held to."""
        rep = self.obs.ledger.report()
        r = self.obs.registry
        rep["raw_counters"] = {
            "serving_tokens_emitted_total":
                int(r.get("serving_tokens_emitted_total").value()),
            "serving_prefill_tokens_total":
                int(self.stats["prefill_tokens"]),
            "serving_spec_proposed_total":
                int(self.stats["spec_proposed"]),
            "serving_spec_accepted_total":
                int(self.stats["spec_accepted"]),
            "serving_tokens_recomputed_total":
                int(r.get("serving_tokens_recomputed_total").value()),
        }
        return rep

    def health(self, now=None):
        """Evaluate the engine's SLOs over the obs sample series: the
        multi-window burn-rate report (state ``ok`` / ``warn`` /
        ``critical`` and each objective's windows) that ``/healthz`` and
        the front door's shedding admission read. The reference's
        ``"resilience"`` key comes with the resilience tier (ROADMAP
        A5). The engine must have been built with ``slo=``."""
        if self.slo is None:
            raise ValueError(
                "engine built without slo=: pass slo=True (stock "
                "objectives) or an SLOSet to evaluate health")
        return self.slo.evaluate(self.obs, now=now)

    # crash recovery comes with the resilience tier
    snapshot = not_ported("ServingEngine.snapshot", "A5, second half")
    restore = not_ported("ServingEngine.restore", "A5, second half")

    # -- scheduling --------------------------------------------------------
    def _admit(self):
        now = self._now()
        for req in self.scheduler.try_admit():
            resumed = req.preemptions > 0
            req.admit_time = now
            if resumed:
                self.obs.on_resume(req, now)
                if self.flight is not None:
                    self.flight.on_resume(
                        req, now, slot=req.slot,
                        prefill_tokens=req.prefill_target)
            else:
                self.obs.on_admit(req, now)
                if self.flight is not None:
                    st = self.pool.fragmentation_stats()
                    reserved = self.scheduler._reservations.get(req)
                    cached_blk = self.pool.held_blocks(req.req_id)
                    self.flight.on_admit(
                        req, now, queue_wait=now - req.arrival_time,
                        blocks_reserved=reserved,
                        pool_free_blocks=st["free_blocks"],
                        pool_blocks_in_use=st["blocks_in_use"],
                        cached_blocks=cached_blk,
                        novel_blocks=(None if reserved is None
                                      else reserved - cached_blk))
            slot = req.slot
            cached = 0
            if self.prefix_cache and req.cached_prefix_tokens:
                # never skip the whole prefill source: its last token is
                # prefilled again so that completion emits a token, and
                # that write copies a fully cached tail block
                cached = min(req.cached_prefix_tokens,
                             req.prefill_target - 1)
                req.prefill_pos = cached
                self.obs.on_cached_prefill(req, cached)
            self._seq_lens[slot] = cached
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
    def _mixed_forward(self, model, pool, tables, rotary, enc_lens, dec_lens,
                       this_time, ids):
        """One mixed prefill(+decode) forward of ``model`` over ``pool``
        through ``block_multihead_attention`` per layer; the pool is
        written in place. The target and (speculative) the draft share it:
        the draft ingests the same rows, so its pool stays in lockstep.
        Returns the (T, E) final hidden states."""
        cfg = model.config
        core = model.llama
        h, hk, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                    cfg.head_dim)
        common = dict(
            seq_lens_encoder=np.asarray(enc_lens, np.int32),
            seq_lens_decoder=np.asarray(dec_lens, np.int32),
            seq_lens_this_time=np.asarray(this_time, np.int32),
            block_tables=tables, rotary_embs=rotary,
            use_neox_rotary_style=True,  # the model's rope layout
            num_heads=h, kv_num_heads=hk, head_dim=d)
        hidden = core.embed_tokens(self._dev(ids))          # (T, E)
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

    def _pools(self):
        """The target's pool, and the draft's of a speculative engine."""
        return [p for p in (self.pool, self.d_pool) if p is not None]

    def _mixed_step(self):
        """One chunk of prefill for every prefilling slot and one decode
        token for every in-flight slot, as a single mixed batch. A
        speculative engine pushes the same batch through the draft into
        its pool (token selection stays the target's)."""
        t0 = self._now()
        self.stats["mixed_steps"] += 1
        chunk = self.config.prefill_chunk
        pre = self.scheduler.prefilling()
        dec = self.scheduler.decoding()
        rows = pre + dec
        pools = self._pools()
        toks, this_time, enc_lens, dec_lens = [], [], [], []
        # the cost ledger's work split: a resumed row's chunk recomputes
        # KV a preemption dropped, a fresh row's is novel prefill
        novel_toks = recompute_toks = 0
        for req in pre:
            n = min(chunk, req.prefill_target - req.prefill_pos)
            if req.preemptions > 0:
                recompute_toks += n
            else:
                novel_toks += n
            toks.append(req.prefill_src[req.prefill_pos:req.prefill_pos + n])
            this_time.append(n)
            enc_lens.append(n)
            dec_lens.append(req.prefill_pos)
            for pool in pools:
                pool.ensure(req.req_id, req.prefill_pos + n)
            if self.prefix_cache:
                # copy-on-write before the forward writes the chunk
                for pool in pools:
                    pool.make_writable(req.req_id, req.prefill_pos,
                                       req.prefill_pos + n)
        for req in dec:
            slot = req.slot
            seq = int(self._seq_lens[slot])
            toks.append(np.asarray([self._last_tok[slot]], np.int32))
            this_time.append(1)
            enc_lens.append(0)
            dec_lens.append(seq)
            for pool in pools:
                pool.ensure(req.req_id, seq + 1)
            if self.prefix_cache:
                for pool in pools:
                    pool.make_writable(req.req_id, seq, seq + 1)
        ids = np.concatenate(toks).astype(np.int32)
        self.stats["prefill_tokens"] += int(sum(enc_lens))
        cu = np.concatenate([[0], np.cumsum(this_time)]).astype(np.int64)
        # read after the copy-on-write: the tables name the fresh blocks
        row_ids = [r.req_id for r in rows]
        tables = self.pool.block_table_array(row_ids,
                                             pad_to=self._table_width)
        hidden = self._mixed_forward(self.model, self.pool, tables,
                                     self._rotary, enc_lens, dec_lens,
                                     this_time, ids)
        if self.d_pool is not None:
            d_tables = self.d_pool.block_table_array(
                row_ids, pad_to=self._table_width)
            self._mixed_forward(self.spec_draft, self.d_pool, d_tables,
                                self._d_rotary, enc_lens, dec_lens,
                                this_time, ids)

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
        now = self._now()
        emitted = prefill_emitted = 0
        for i, req in enumerate(rows):
            slot = req.slot
            if i < len(pre):
                req.prefill_pos += this_time[i]
                self._seq_lens[slot] = req.prefill_pos
                if self.flight is not None:
                    self.flight.on_prefill_chunk(
                        req, now, this_time[i], req.prefill_pos)
                if req.prefill_pos >= req.prefill_target:
                    if self.prefix_cache:
                        # the whole prefill source is in the pool(s):
                        # publish its full blocks for the next request to
                        # alias (both pools in lockstep)
                        for pool in pools:
                            pool.publish_prefix(req.req_id,
                                                req.prefill_src)
                        self.scheduler.clear_cow_debt(req)
                    tok = int(nxt[need.index(i)])
                    if req.first_token_time is None:
                        # once a request: a resumed request's re-prefill
                        # emits a continuation token, not a first token
                        req.first_token_time = now
                        self.obs.on_first_token(req, now)
                        if self.flight is not None:
                            self.flight.on_first_token(
                                req, now, now - req.arrival_time)
                    self._emit(req, tok)
                    emitted += 1
                    prefill_emitted += 1
                    self._record_host(slot, req, tok)
            else:
                tok = int(nxt[need.index(i)])
                self._seq_lens[slot] += 1  # last_tok entered the cache
                self._emit(req, tok)
                emitted += 1
                self._record_host(slot, req, tok)
        self.obs.on_quantum(
            "mixed", t0, now, emitted, len(rows),
            breakdown={"prefill_emitted": prefill_emitted,
                       "decode_emitted": emitted - prefill_emitted,
                       "novel_tokens": novel_toks,
                       "recompute_tokens": recompute_toks,
                       "decode_rows": len(dec)})
        self._retire_finished()

    def _emit(self, req, tok):
        """Append ONE generated token to a request's stream (the
        retirement rule included) and count it; the front door's
        ``token_sink`` fires on the same boundary."""
        req.record(tok, self.eos_token_id)
        self.obs.on_token(req)
        if self.token_sink is not None:
            self.token_sink(req, int(tok))

    def _record_host(self, slot, req, tok):
        self._last_tok[slot] = tok
        self._n_gen[slot] = len(req.tokens)
        self._done[slot] = req.finished

    # -- the decode quantum ------------------------------------------------
    def _choose_k(self):
        """Quanta the next dispatch runs: ``multi_quantum`` when the
        scheduler is in steady state (the batch cannot change before the
        dispatch lands), else 1. A speculative engine runs one round per
        dispatch: its acceptance counts must reach the host."""
        if (self._mq_max > 1 and self.spec_draft is None
                and self.scheduler.steady_state()):
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

    @torch.inference_mode()
    def _spec_body(self):
        """One speculative round over the state buffers alone (the
        function the card captures and the CPU runs)."""
        self._spec_round(self._state.dev)

    def _pool_ptrs(self):
        return tuple(t.data_ptr() for pool in self._pools()
                     for t in pool._pool_tensors())

    def _run_quanta(self, k):
        """Run ``k`` quanta (or one speculative round) on the staged
        state: eagerly on the CPU (or with ``_eager``), else as replays of
        the captured body. The first dispatch on the card captures it: its
        first run is the warm-up on the capture stream (the kernel
        library's load, K2's ticket buffer of that stream, cuBLAS's
        workspace), then the capture; the graph is never rebuilt."""
        if self.device.type != "cuda" or self._eager:
            for _ in range(k):
                self._body()
            return
        if self._graph_error is not None:
            raise RuntimeError(
                "the decode quantum's CUDA graph failed to capture; the "
                "engine cannot decode") from self._graph_error
        if self._graph is None:
            step = CapturedStep(self._body, self.device)
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
        t0 = self._now()
        t_steps = self.config.decode_quantum
        k = self._choose_k()
        rows = self.scheduler.decoding()
        for req in rows:
            # cover the whole dispatch (K quanta) before entering the
            # device loop, capped by the request's own prompt + max_new
            # bound, which admission reserved; with the prefix cache, copy
            # the shared blocks of that range first (before the mirrors
            # are staged, on the stream the graph replays on)
            slot = req.slot
            cap = req.prompt_len + req.max_new_tokens - 1
            need = min(int(self._seq_lens[slot]) + k * t_steps, cap)
            row = self.pool.grow_decode_table(
                req.req_id, need, int(self._seq_lens[slot]),
                pad_to=self._table_width, cow=self.prefix_cache)
            self._tables[slot] = row[:self._table_width]
        st = self._state
        st.stage["qi"][0] = 0
        st.stage["count"][0] = 0
        event = self._stage_and_run(k)
        return {"rows": rows, "k": k, "event": event, "t0": t0,
                "t_disp": self._now()}

    def _stage_and_run(self, k):
        """Stage the host mirrors into the state buffers (one copy), run
        ``k`` quanta or one round, and enqueue the read-back of the whole
        buffer (one copy) behind an event, which it returns (``None`` on
        the CPU)."""
        st = self._state
        for name in self._staged:
            np.copyto(st.stage[name], getattr(self, "_" + name))
        st.device_buf.copy_(st.stage_buf, non_blocking=True)
        self._run_quanta(k)
        st.back_buf.copy_(st.device_buf, non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return event

    def _spec_round_step(self):
        """One speculative round, run to completion: grow both pools'
        tables to cover the round's writes (γ proposals past the accepted
        history, copy-on-write first under the prefix cache), stage the
        state, run the round (the captured graph on the card), wait for
        its read-back (the ONE host sync), then emit each row's yield and
        account the proposals and acceptances."""
        g = self.spec_gamma
        t0 = self._now()
        self.stats["spec_rounds"] += 1
        rows = self.scheduler.decoding()
        for req in rows:
            slot = req.slot
            seq = int(self._seq_lens[slot])
            for pool, tables in ((self.pool, self._tables),
                                 (self.d_pool, self._d_tables)):
                row = pool.grow_decode_table(
                    req.req_id, seq + g + 1, seq, pad_to=self._table_width,
                    cow=self.prefix_cache)
                tables[slot] = row[:self._table_width]
        event = self._stage_and_run(1)
        if event is not None:
            event.synchronize()
        back = self._state.back
        self._seq_lens = back["seq_lens"].copy()
        self._last_tok = back["last_tok"].copy()
        self._n_gen = back["n_gen"].copy()
        self._done = back["done"].copy()
        stream, emitted = back["stream"], back["emitted"]
        accepted = back["accepted"]
        self.stats["quantum_tokens"] += int(emitted.sum())
        self.stats["spec_proposed"] += g * len(rows)
        self.stats["spec_accepted"] += int(accepted.sum())
        now = self._now()
        n_emit = 0
        for req in rows:
            got = 0
            for j in range(int(emitted[req.slot])):
                if req.finished:
                    break
                self._emit(req, int(stream[req.slot, j]))
                got += 1
            n_emit += got
            if self.flight is not None:
                self.flight.on_spec_round(
                    req, now, proposed=g, accepted=int(accepted[req.slot]),
                    emitted=got)
            if req.finished:
                req.finish_time = now
        self.obs.on_quantum("spec_round", t0, now, n_emit, len(rows))
        self.obs.on_spec_round(now, g * len(rows), int(accepted.sum()))
        self._retire_finished()

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
        now = self._now()
        t0 = pending["t0"]
        device_s = max(now - pending["t_disp"], 0.0)
        t_steps = self.config.decode_quantum
        emitted_k = [0] * n_exec
        rows = pending["rows"]
        for req in rows:
            got = 0
            for j in range(toks.shape[0]):
                if req.finished:
                    break
                self._emit(req, int(toks[j, req.slot]))
                emitted_k[j // t_steps] += 1
                got += 1
            if self.flight is not None and got:
                self.flight.on_quantum_tokens(req, now, got)
            if req.finished:
                req.finish_time = now
        # K quanta of one dispatch are K quanta to the hooks: equal
        # slices that partition [t0, now] exactly
        dt = (now - t0) / n_exec
        prev = t0
        for j in range(n_exec):
            edge = now if j == n_exec - 1 else t0 + (j + 1) * dt
            self.obs.on_quantum("decode", prev, edge, emitted_k[j],
                                len(rows), device_s=device_s / n_exec)
            prev = edge
        self._retire_finished()

    def _retire_finished(self):
        now = self._now()
        for req in list(self.scheduler.live()):
            if req.finished:
                slot = req.slot
                if req.finish_time is None:
                    req.finish_time = now
                self.stats["generated_tokens"] += len(req.tokens)
                self.obs.on_retire(req, req.finish_time)
                if self.flight is not None:
                    self.flight.on_retire(
                        req, req.finish_time,
                        ttft=(req.first_token_time - req.arrival_time
                              if req.first_token_time is not None
                              else None),
                        e2e=req.finish_time - req.arrival_time,
                        reason=req.finish_reason)
                self._done[slot] = True
                self._max_new[slot] = 0
                self.scheduler.retire(req)
                self.completed.append(req)
