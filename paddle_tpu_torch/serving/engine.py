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
  ``done`` masks kept on the device and ONE host sync per quantum;
- block accounting by the scheduler, retirement returning blocks to the
  pool free list for immediate reuse, preemption by recompute-on-resume.

The reference compiles its quantum into one jitted program; here it is a
Python loop of eager steps (CUDA-graph capture is later work). Pools are
updated in place. Decoding is greedy. Observability, SLOs, the flight
recorder, fault injection, resilience, speculative decoding, tensor
parallelism, int8, the prefix cache and multi-quantum dispatch are
later slices (ROADMAP A7-A12); the engine does not take their options.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..incubate.nn.functional import block_multihead_attention
from ..nlp.paged_cache import PagedKVCachePool
from ..nn.functional.rope import build_rope_cache, inv_freq
from ..ops.paged_attention import paged_decode_attention
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


def paged_decode_math(model, scratch_block, ids_t, seq_lens, tables, kc, vc,
                      live):
    """One token for every slot over a paged pool (the quantum's step).

    ``ids_t`` (S, 1) last tokens, ``seq_lens`` (S,) int32 tokens cached,
    ``tables`` (S, W) int32, ``kc``/``vc`` the per-layer pools (written in
    place), ``live`` (S,) bool. A masked row writes its KV into the
    scratch block and attends one position. Returns logits (S, vocab)."""
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
        kc[i].index_put_((write_blk, write_off), k.to(kc[i].dtype))
        vc[i].index_put_((write_blk, write_off), v.to(vc[i].dtype))
        att = paged_decode_attention(q, kc[i], vc[i], tables, lens)
        hidden = residual + attn.o_proj(att.view(s, 1, h * d))
        hidden = hidden + layer.mlp(layer.post_attention_layernorm(hidden))
    return model.lm_head(core.norm(hidden))[:, 0]


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
        decode_strategy: ``"greedy"`` (sampling is a later slice).
        eos_token_id: retire a slot the step after it emits this id.
        device: default ``cuda``; raises without CUDA unless ``"cpu"``.
    """

    def __init__(self, model, num_slots=8, block_size=32, num_blocks=None,
                 max_context=None, prefill_chunk=64, decode_quantum=8,
                 decode_strategy="greedy", eos_token_id=None, device=None):
        cfg = model.config
        if getattr(cfg, "sliding_window", None):
            raise NotImplementedError(
                "ServingEngine does not compose with sliding_window: a "
                "rolling buffer wrap-writes over pool slots the block "
                "tables still map")
        if decode_strategy == "sampling":
            raise NotImplementedError(
                "sampling serving is not ported yet (ROADMAP A4/A7)")
        if decode_strategy != "greedy":
            raise ValueError(
                f"decode_strategy must be greedy|sampling, got "
                f"{decode_strategy!r}")
        self.device = resolve_device(device)
        params = list(model.parameters())
        if params[0].device.type != self.device.type:
            raise ValueError(
                f"the model lies on {params[0].device}, the engine on "
                f"{self.device}: build the model with device=")
        model.eval()
        self.model = model
        self.config = SchedulerConfig(num_slots=num_slots,
                                      prefill_chunk=prefill_chunk,
                                      decode_quantum=decode_quantum)
        self.eos_token_id = (None if eos_token_id is None
                             else int(eos_token_id))
        self.max_context = int(max_context or cfg.max_position_embeddings)
        cache_dtype = next(p.dtype for p in params if p.is_floating_point())
        s = self.config.num_slots
        bs = int(block_size)
        w = -(-self.max_context // bs)
        if num_blocks is None:
            num_blocks = s * w + 1  # +1: the masked-write scratch block
        self.pool = PagedKVCachePool(
            num_blocks, bs, cfg.num_key_value_heads, cfg.head_dim,
            num_layers=cfg.num_hidden_layers, dtype=cache_dtype,
            device=self.device)
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
        """Queue one request; returns the :class:`Request` handle."""
        if temperature is not None:
            raise NotImplementedError(
                "per-request temperature needs sampling serving (ROADMAP "
                "A10)")
        req = Request(prompt, max_new_tokens=max_new_tokens, req_id=req_id,
                      seed=seed, priority=priority,
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
        prefill(+decode) step or a decode quantum, then retire. Returns
        whether work remains."""
        self.stats["steps"] += 1
        self._admit()
        live = self.scheduler.live()
        self.stats["occupancy_sum"] += len(live) / self.config.num_slots
        if self.scheduler.prefilling():
            self._mixed_step()
        elif self.scheduler.decoding():
            self._decode_quantum()
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

    def _dev(self, a):
        return torch.from_numpy(np.array(a)).to(self.device,
                                                non_blocking=True)

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
        for i, layer in enumerate(core.layers):
            attn = layer.self_attn
            x = layer.input_layernorm(hidden)
            qkv = torch.cat([attn.q_proj(x), attn.k_proj(x),
                             attn.v_proj(x)], dim=-1)
            att = block_multihead_attention(
                qkv, self.pool.k_pools[i], self.pool.v_pools[i], **common)
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
            with torch.inference_mode():
                logits = self.model.lm_head(hidden[last_idx])
                nxt = torch.argmax(logits, dim=-1).cpu().numpy()
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
    def _decode_quantum(self):
        """``decode_quantum`` greedy steps for every slot. The slot state
        stays on the device through the steps (retirement masks included)
        and comes back to the host once, at the end."""
        t_steps = self.config.decode_quantum
        rows = self.scheduler.decoding()
        for req in rows:
            # cover the whole quantum before entering the device loop,
            # capped by the request's own prompt + max_new bound
            slot = req.slot
            cap = req.prompt_len + req.max_new_tokens - 1
            need = min(int(self._seq_lens[slot]) + t_steps, cap)
            row = self.pool.grow_decode_table(
                req.req_id, need, int(self._seq_lens[slot]),
                pad_to=self._table_width)
            self._tables[slot] = row[:self._table_width]
        tables = self._dev(self._tables)
        seq_lens = self._dev(self._seq_lens)
        last_tok = self._dev(self._last_tok)
        n_gen = self._dev(self._n_gen)
        done = self._dev(self._done)
        max_new = self._dev(self._max_new)
        eos = self.eos_token_id
        toks = []
        with torch.inference_mode():
            for _ in range(t_steps):
                live = ~done
                logits = paged_decode_math(
                    self.model, self._scratch_block, last_tok[:, None],
                    seq_lens, tables, self.pool.k_pools, self.pool.v_pools,
                    live)
                nxt = torch.argmax(logits, dim=-1).int()
                nxt = torch.where(done, last_tok, nxt)
                n_gen = n_gen + live.int()
                done_next = done | (n_gen >= max_new)
                if eos is not None:
                    done_next = done_next | (live & (nxt == eos))
                seq_lens = seq_lens + live.int()
                last_tok, done = nxt, done_next
                toks.append(nxt)
            # the ONE host sync of the quantum
            host = torch.stack(toks + [seq_lens, last_tok, n_gen,
                                       done.int()]).cpu().numpy()
        toks = host[:t_steps]
        self._seq_lens = host[t_steps].astype(np.int32)
        self._last_tok = host[t_steps + 1].astype(np.int32)
        self._n_gen = host[t_steps + 2].astype(np.int32)
        self._done = host[t_steps + 3].astype(bool)
        self.stats["decode_quanta"] += 1
        self.stats["quantum_tokens"] += int(toks.shape[0] * toks.shape[1])
        now = time.perf_counter()
        for req in rows:
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
