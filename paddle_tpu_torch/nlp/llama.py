"""Llama-family model in PyTorch (counterpart of ``paddle_tpu/nlp/llama.py``).

Module names mirror the reference's, so its ``state_dict()`` keys map
one to one onto this model's (see ``nlp/convert.py``). ``torch.nn.Linear``
stores its weight as (out, in) where the reference stores (in, out); the
carry transposes once. The projections and the embedding are the port's
``Linear`` / ``Embedding`` (``nn/layer/common.py``), whose forward holds
amp's cast seam. With ``tensor_parallel`` and the hybrid mesh installed
(``fleet.init``), the model builds the reference's tensor-parallel layers
(``_use_mp``): q/k/v, gate and up as ``ColumnParallelLinear``, o and down
as ``RowParallelLinear``, the embedding as ``VocabParallelEmbedding`` and
the lm head as ``ColumnParallelLinear(gather_output=True)``, so a rank
holds H/mp query heads and HK/mp KV heads and its slices of the weights.
Without a mesh the reference's parallel layers are serial layers; the
port then builds the serial ones, which hold the same keys and shapes.
Every rank draws each full weight from the one generator and keeps its
slice, so a parallel build of seed s equals the serial build of seed s.

Attention without a cache runs through ``F.scaled_dot_product_attention``
(dense) or ``F.sliding_window_attention`` (windowed), both the flash
kernel K4 with K7 as its backward; packed training (``cu_seqlens``,
one (1, T) row of segments, rotary positions restarting per segment)
through ``F.flash_attn_unpadded``, the varlen kernel K3 with K8 (K8a/K8b
in f32) as its backward; with a contiguous cache, windowed prefill runs
K4 and a single decoded token the decode kernel K5; RMSNorm runs K1
with K6 as its backward. Training: ``LlamaPretrainingCriterion`` here
(unpacked and packed), the step in ``jit/train.py``, recompute at the
reference's four granularities through
``distributed/fleet/utils/recompute.py``. Generation over the cache lives
in ``nlp/generation.py``; the serving
path (paged KV pool) in ``serving/engine.py`` and
``incubate/nn/functional``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..distributed.fleet.layers.mpu import mp_layers
from ..distributed.fleet.utils.recompute import recompute, should_remat_layer
from ..nn import functional as F
from ..nn.functional.rope import apply_rotary_emb, build_rope_cache
from ..nn.layer.common import Embedding, LayerList, Linear
from ..nn.layer.norm import RMSNorm
from ..ops.decode_attention import decode_attention
from ..parallel import mesh as mesh_state
from ..core.dtype import one_of, to_torch_dtype
from ..nn.layer.layers import Layer

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "LlamaPretrainingCriterion",
           "packed_position_ids"]

# the dtypes the port's kernels take
_DTYPES = (torch.float32, torch.bfloat16)


def _model_dtype(name):
    """A model config's dtype name -> its torch dtype, one the kernels
    take."""
    dt = one_of(name, _DTYPES)
    if dt is None:
        raise ValueError(f"unsupported model dtype {name!r}")
    return dt


class LlamaConfig:
    """Configuration; the same fields and presets as the reference's."""

    def __init__(self, vocab_size=32000, hidden_size=4096,
                 intermediate_size=11008, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=None,
                 max_position_embeddings=4096, rms_norm_eps=1e-6,
                 rope_theta=10000.0, tie_word_embeddings=False,
                 tensor_parallel=True, sequence_parallel=False,
                 context_parallel=None, use_recompute=False,
                 recompute_granularity="full", dtype="float32",
                 fuse_linear_cross_entropy=False, lce_chunk_rows=1024,
                 sliding_window=None, attention_bias=False):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads or num_attention_heads
        self.max_position_embeddings = max_position_embeddings
        self.rms_norm_eps = rms_norm_eps
        self.rope_theta = rope_theta
        self.tie_word_embeddings = tie_word_embeddings
        # the tensor-parallel layers, under the hybrid mesh (_use_mp)
        self.tensor_parallel = tensor_parallel
        self.sequence_parallel = sequence_parallel
        self.context_parallel = context_parallel
        self.use_recompute = use_recompute
        self.recompute_granularity = recompute_granularity
        self.dtype = dtype
        self.fuse_linear_cross_entropy = fuse_linear_cross_entropy
        self.lce_chunk_rows = lce_chunk_rows
        self.sliding_window = sliding_window
        self.attention_bias = attention_bias

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads

    @property
    def torch_dtype(self):
        return _model_dtype(self.dtype)

    @staticmethod
    def llama2_7b(**overrides):
        cfg = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
                   num_hidden_layers=32, num_attention_heads=32,
                   max_position_embeddings=4096)
        cfg.update(overrides)
        return LlamaConfig(**cfg)

    @staticmethod
    def tiny(**overrides):
        """Test-scale config, the reference's ``LlamaConfig.tiny``."""
        cfg = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, max_position_embeddings=256)
        cfg.update(overrides)
        return LlamaConfig(**cfg)

    @staticmethod
    def mistral_7b(**overrides):
        """Mistral-7B shape: GQA 32/8 + sliding window 4096."""
        cfg = dict(vocab_size=32000, hidden_size=4096,
                   intermediate_size=14336, num_hidden_layers=32,
                   num_attention_heads=32, num_key_value_heads=8,
                   max_position_embeddings=32768, rope_theta=10000.0,
                   sliding_window=4096)
        cfg.update(overrides)
        return LlamaConfig(**cfg)

    @staticmethod
    def qwen2_7b(**overrides):
        """Qwen2-7B shape: GQA 28/4 with q/k/v biases."""
        cfg = dict(vocab_size=152064, hidden_size=3584,
                   intermediate_size=18944, num_hidden_layers=28,
                   num_attention_heads=28, num_key_value_heads=4,
                   max_position_embeddings=32768, rope_theta=1000000.0,
                   attention_bias=True)
        cfg.update(overrides)
        return LlamaConfig(**cfg)


def _use_mp(config):
    """The reference's tensor-parallel build: asked for, and a mesh
    installed (without one its parallel layers are serial layers)."""
    return bool(config.tensor_parallel) and mesh_state.has_mesh()


def _mp_heads(config):
    """(query heads, KV heads) on this rank."""
    h, hk = config.num_attention_heads, config.num_key_value_heads
    if not _use_mp(config):
        return h, hk
    mp = mesh_state.mesh_axis_size("mp")
    if h % mp or hk % mp:
        raise ValueError(
            f"mp degree {mp} must divide the {h} query heads and the {hk} "
            f"KV heads")
    return h // mp, hk // mp


def _check_ported(config):
    """Refuse the options whose code paths belong to later slices."""
    later = {
        "context_parallel": ("context parallelism", "ROADMAP A7"),
    }
    for field, (what, item) in later.items():
        if getattr(config, field):
            raise NotImplementedError(
                f"{what} ({field}) is not ported yet ({item})")


class LlamaAttention(Layer):
    """Self-attention with rotary embedding, GQA, Qwen2-style q/k/v biases
    and the optional sliding window, with or without a KV cache."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        h, hk, d = (config.num_attention_heads, config.num_key_value_heads,
                    config.head_dim)
        self.num_heads, self.num_kv_heads = _mp_heads(config)
        self.head_dim = d
        bias = bool(config.attention_bias)
        kw = dict(device=device, dtype=dtype)
        e = config.hidden_size
        if _use_mp(config):
            col, row = mp_layers.ColumnParallelLinear, \
                mp_layers.RowParallelLinear
            self.q_proj = col(e, h * d, has_bias=bias, gather_output=False,
                              **kw)
            self.k_proj = col(e, hk * d, has_bias=bias, gather_output=False,
                              **kw)
            self.v_proj = col(e, hk * d, has_bias=bias, gather_output=False,
                              **kw)
            self.o_proj = row(h * d, e, has_bias=False,
                              input_is_parallel=True, **kw)
        else:
            self.q_proj = Linear(e, h * d, bias=bias, **kw)
            self.k_proj = Linear(e, hk * d, bias=bias, **kw)
            self.v_proj = Linear(e, hk * d, bias=bias, **kw)
            self.o_proj = Linear(h * d, e, bias=False, **kw)

    def forward(self, hidden, position_offset=0, cache=None,
                cu_seqlens=None, position_ids=None):
        """Returns ``(out, cache)``. ``cache`` is a ``(k, v)`` pair of
        (B, S_max, HK, D) tensors holding ``position_offset`` tokens; this
        call's K/V are written into it IN PLACE (the reference returns new
        arrays) and the same pair is returned. A single-token call (s ==
        1) also takes ``position_offset`` as a 0-d integer device tensor,
        so that a captured decode step reads its position from the device
        (``nlp.generation._ondevice_decode``), with the int position's
        results bit for bit. A sliding-window model
        uses it as a rolling buffer (writes wrap at S_max). Packed
        training passes ``cu_seqlens`` (int32 prefix sums of the segments
        of the (1, T) row) and ``position_ids`` (1, T), the rotary
        positions restarting per segment (:func:`packed_position_ids`)."""
        b, s, _ = hidden.shape
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        q = self.q_proj(hidden).view(b, s, h, d)
        k = self.k_proj(hidden).view(b, s, hk, d)
        v = self.v_proj(hidden).view(b, s, hk, d)
        cos, sin = build_rope_cache(s, d, base=self.config.rope_theta,
                                    position_offset=position_offset,
                                    device=hidden.device)
        q = apply_rotary_emb(q, cos, sin, position_ids=position_ids)
        k = apply_rotary_emb(k, cos, sin, position_ids=position_ids)
        window = self.config.sliding_window
        if cu_seqlens is not None:
            # packed segments, (B=1, T): attention never crosses a segment
            # and the window applies per segment
            t = b * s
            out, _ = F.flash_attn_unpadded(
                q.reshape(t, h, d), k.reshape(t, hk, d), v.reshape(t, hk, d),
                cu_seqlens, cu_seqlens, s, s, scale=1.0 / math.sqrt(d),
                causal=True, window_size=window or None)
            out = out.reshape(b, s, h, d)
        elif cache is not None:
            if window and s > 1:
                # windowed prefill attends the call's own keys through the
                # banded kernel (every query's band lies inside this call
                # at offset 0); the rolling buffer is storage for decode
                if position_offset != 0:
                    raise NotImplementedError(
                        "sliding_window + chunked prefill (cache with "
                        "position_offset>0 and s>1) is not supported; "
                        "prefill in one chunk, then decode token by token")
                cache = self._update_cache(k, v, cache, position_offset)
                out = F.sliding_window_attention(q, k, v, window)
            else:
                cache = self._update_cache(k, v, cache, position_offset)
                out = self._decode_attend(q, cache[0], cache[1],
                                          position_offset + s)
        elif window:
            out = F.sliding_window_attention(q, k, v, window)
        else:
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return self.o_proj(out.reshape(b, s, h * d)), cache

    def forward_no_cache(self, hidden, position_offset=0, cu_seqlens=None,
                         position_ids=None):
        """Single-output variant for the recompute wrapper (core_attn)."""
        return self.forward(hidden, position_offset, None, cu_seqlens,
                            position_ids)[0]

    def _update_cache(self, k, v, cache, position_offset):
        """Write this call's K/V into the cache pair in place."""
        kc, vc = cache
        cache_len = kc.shape[1]
        s = k.shape[1]
        if not self.config.sliding_window:
            if s > cache_len:
                # wrap-writes would permute slots the slot-index causal
                # mask then misreads (a silent causality violation)
                raise ValueError(
                    f"KV cache length {cache_len} < {s} tokens written; "
                    f"allocate init_caches(max_len >= prompt + new tokens)")
            # the reference's dynamic_update_slice clamps the start so the
            # update fits
            if isinstance(position_offset, torch.Tensor):
                idx = (position_offset.clamp(0, cache_len - s)
                       + torch.arange(s, device=k.device))
                kc.index_copy_(1, idx, k.to(kc.dtype))
                vc.index_copy_(1, idx, v.to(vc.dtype))
                return kc, vc
            start = min(max(int(position_offset), 0), cache_len - s)
            kc[:, start:start + s] = k.to(kc.dtype)
            vc[:, start:start + s] = v.to(vc.dtype)
            return kc, vc
        if s > cache_len:
            # rolling buffer: only this call's last cache_len tokens matter
            k, v = k[:, s - cache_len:], v[:, s - cache_len:]
            position_offset = position_offset + (s - cache_len)
            s = cache_len
        idx = (position_offset + torch.arange(s, device=k.device)) % cache_len
        kc[:, idx] = k.to(kc.dtype)
        vc[:, idx] = v.to(vc.dtype)
        return kc, vc

    def _decode_attend(self, q, kc, vc, valid_len):
        """Attention of this call's queries over the cache. ``valid_len``
        counts ABSOLUTE tokens so far; a rolling buffer holds only
        ``min(valid_len, cache_len)`` live slots. A single query runs the
        decode kernel (K5) when the buffer is no longer than the window
        (the window IS the buffer, and the wrapped order is irrelevant to
        softmax); a multi-token suffix masks by each slot's reconstructed
        absolute position in f32."""
        window = self.config.sliding_window
        b, sq, h, d = q.shape
        cache_len = kc.shape[1]
        if sq == 1 and (not window or cache_len <= window):
            if isinstance(valid_len, torch.Tensor):
                live = valid_len.clamp(max=cache_len) if window else valid_len
                lens = live.to(torch.int32).reshape(1).expand(b).contiguous()
            else:
                live = min(valid_len, cache_len) if window else valid_len
                lens = torch.full((b,), live, dtype=torch.int32,
                                  device=q.device)
            return decode_attention(q, kc, vc, lens)
        rep = h // kc.shape[2]
        kr = kc.repeat_interleave(rep, dim=2) if rep > 1 else kc
        vr = vc.repeat_interleave(rep, dim=2) if rep > 1 else vc
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                              kr.float()) / math.sqrt(d)
        dev = q.device
        q_pos = valid_len - sq + torch.arange(sq, device=dev)
        k_slot = torch.arange(cache_len, device=dev)
        if window:
            # slot j holds absolute position a(j): the largest p <
            # valid_len with p % cache_len == j
            a = valid_len - 1 - ((valid_len - 1 - k_slot) % cache_len)
            mask = ((a[None, :] <= q_pos[:, None])
                    & (a[None, :] > q_pos[:, None] - window)
                    & (a[None, :] >= 0))
        else:
            mask = k_slot[None, :] <= q_pos[:, None]
        logits = logits.masked_fill(~mask, -1e30)
        p = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", p, vr.float())
        return out.to(q.dtype)


class LlamaMLP(Layer):
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""

    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        e, f = config.hidden_size, config.intermediate_size
        kw = dict(device=device, dtype=dtype)
        if _use_mp(config):
            col, row = mp_layers.ColumnParallelLinear, \
                mp_layers.RowParallelLinear
            self.gate_proj = col(e, f, has_bias=False, gather_output=False,
                                 **kw)
            self.up_proj = col(e, f, has_bias=False, gather_output=False,
                               **kw)
            self.down_proj = row(f, e, has_bias=False,
                                 input_is_parallel=True, **kw)
        else:
            self.gate_proj = Linear(e, f, bias=False, **kw)
            self.up_proj = Linear(e, f, bias=False, **kw)
            self.down_proj = Linear(f, e, bias=False, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(Layer):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(config.hidden_size,
                                       epsilon=config.rms_norm_eps, **kw)
        self.self_attn = LlamaAttention(config, **kw)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps, **kw)
        self.mlp = LlamaMLP(config, **kw)

    def forward(self, hidden, position_offset=0, cache=None,
                cu_seqlens=None, position_ids=None):
        cfg = self.config
        # full_attn / core_attn recompute only the attention sublayer (its
        # score intermediates), keeping the MLP activations resident
        if (cfg.use_recompute and cache is None
                and cfg.recompute_granularity in ("full_attn", "core_attn")):
            attn_out = recompute(self.self_attn.forward_no_cache,
                                 self.input_layernorm(hidden),
                                 position_offset, cu_seqlens, position_ids)
        else:
            attn_out, cache = self.self_attn(self.input_layernorm(hidden),
                                             position_offset, cache,
                                             cu_seqlens, position_ids)
        hidden = hidden + attn_out
        return hidden + self.mlp(self.post_attention_layernorm(hidden)), cache

    def forward_no_cache(self, hidden, position_offset=0, cu_seqlens=None,
                         position_ids=None):
        """Single-output variant for the recompute wrapper."""
        return self.forward(hidden, position_offset, None, cu_seqlens,
                            position_ids)[0]


def packed_position_ids(cu_seqlens, total_tokens):
    """Per-token rotary positions of a packed (1, T) row: they restart at
    every ``cu_seqlens`` boundary. Returns a (1, T) int64 tensor on
    ``cu_seqlens``' device."""
    cu = cu_seqlens.long()
    t = torch.arange(total_tokens, device=cu.device)
    seg = torch.searchsorted(cu, t, right=True) - 1
    return (t - cu[seg])[None, :]


class LlamaModel(Layer):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        kw = dict(device=device, dtype=dtype)
        emb = (mp_layers.VocabParallelEmbedding if _use_mp(config)
               else Embedding)
        self.embed_tokens = emb(config.vocab_size, config.hidden_size, **kw)
        self.layers = LayerList(
            LlamaDecoderLayer(config, **kw)
            for _ in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, epsilon=config.rms_norm_eps,
                            **kw)

    def forward(self, input_ids, position_offset=0, caches=None,
                cu_seqlens=None):
        """Returns ``(hidden, new_caches)``; ``new_caches`` is None without
        caches. ``cu_seqlens`` ((nseg + 1,) prefix sums) packs the segments
        of a (1, T) row; it excludes caches."""
        hidden = self.embed_tokens(input_ids)
        position_ids = None
        if cu_seqlens is not None:
            if caches is not None:
                raise ValueError(
                    "packed cu_seqlens training and KV caches are "
                    "mutually exclusive (serving uses the paged path)")
            if input_ids.shape[0] != 1:
                raise ValueError(
                    f"packed cu_seqlens training expects the (1, T) "
                    f"packed layout, got batch {input_ids.shape[0]}")
            cu_seqlens = torch.as_tensor(cu_seqlens, device=hidden.device,
                                         dtype=torch.int32)
            position_ids = packed_position_ids(cu_seqlens,
                                               input_ids.shape[1])
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            # full_attn / core_attn recompute inside the layer; full and
            # selective wrap the whole block, only without caches
            if caches is None and should_remat_layer(
                    self.config, i, allowed=("full", "full_attn",
                                             "core_attn", "selective")):
                hidden = recompute(layer.forward_no_cache, hidden,
                                   position_offset, cu_seqlens, position_ids)
            else:
                hidden, cache = layer(hidden, position_offset, cache,
                                      cu_seqlens, position_ids)
            if new_caches is not None:
                new_caches.append(cache)
        return self.norm(hidden), new_caches


class LlamaForCausalLM(Layer):
    """Causal LM. Built on ``device`` (default ``cuda``; raises without
    CUDA unless ``device="cpu"``) in ``config.dtype``, with weights drawn
    from ``generator`` (a ``torch.Generator`` on that device; seed 0 when
    omitted): Linear weights Xavier-normal, embeddings N(0, 1), norms 1,
    biases 0, the reference's initializers. To hold the reference's exact
    weights, carry its ``state_dict()`` with
    :func:`~paddle_tpu_torch.nlp.convert.load_paddle_tpu_arrays`."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        _check_ported(config)
        dev = resolve_device(device)
        dtype = config.torch_dtype
        self.config = config
        self.llama = LlamaModel(config, device=dev, dtype=dtype)
        if _use_mp(config):
            if config.fuse_linear_cross_entropy:
                raise NotImplementedError(
                    "fuse_linear_cross_entropy over a vocabulary split on "
                    "mp is not ported yet (ROADMAP A7)")
            self.lm_head = mp_layers.ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=True, device=dev, dtype=dtype)
        else:
            self.lm_head = Linear(config.hidden_size, config.vocab_size,
                                  bias=False, device=dev, dtype=dtype)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        self._init_weights(generator)

    @torch.no_grad()
    def _init_weights(self, generator):
        """Each weight drawn at its full shape, a split one keeping this
        rank's slice (the same draws on every rank and in the serial
        build)."""
        def draw(w, std):
            full = torch.empty(mp_layers.full_shape(w), dtype=w.dtype,
                               device=w.device)
            full.normal_(0.0, std, generator=generator)
            w.copy_(mp_layers.local_of(w, full))

        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mp_layers.full_shape(mod.weight)
                draw(mod.weight, math.sqrt(2.0 / (fan_in + fan_out)))
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                draw(mod.weight, 1.0)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def forward(self, input_ids, position_offset=0, caches=None,
                cu_seqlens=None):
        """Logits (B, S, vocab); with ``caches`` (a list of per-layer
        ``(k, v)`` pairs from :meth:`init_caches`, holding
        ``position_offset`` tokens) returns ``(logits, new_caches)``. With
        ``config.fuse_linear_cross_entropy`` and no caches it returns the
        final hidden states: the lm-head product happens inside
        :class:`LlamaPretrainingCriterion`'s chunked fused loss.
        ``cu_seqlens`` packs segments into the (1, T) row (packed
        training; see :meth:`LlamaModel.forward`)."""
        hidden, new_caches = self.llama(input_ids, position_offset, caches,
                                        cu_seqlens)
        if self.config.fuse_linear_cross_entropy and caches is None:
            return hidden
        logits = self.lm_head(hidden)
        if caches is not None:
            return logits, new_caches
        return logits

    def generate(self, input_ids, max_new_tokens=32,
                 decode_strategy="greedy_search", **kwargs):
        """Paddle-style generation entry (greedy / sampling / beam; see
        :func:`paddle_tpu_torch.nlp.generation.generate`)."""
        from .generation import generate

        return generate(self, input_ids, max_new_tokens,
                        decode_strategy=decode_strategy, **kwargs)

    def init_caches(self, batch_size, max_len, dtype=None):
        """Empty KV caches on the model's device: a list of ``(k, v)`` per
        layer, each (B, max_len, HK, D) in ``dtype`` (default the model's).
        A sliding-window model never needs more than the window."""
        cfg = self.config
        if cfg.sliding_window:
            max_len = min(max_len, cfg.sliding_window)
        dev = self.lm_head.weight.device
        dt = cfg.torch_dtype if dtype is None else to_torch_dtype(dtype)
        shape = (batch_size, max_len, _mp_heads(cfg)[1], cfg.head_dim)
        return [(torch.zeros(shape, dtype=dt, device=dev),
                 torch.zeros(shape, dtype=dt, device=dev))
                for _ in range(cfg.num_hidden_layers)]


def _same_segment(cu_seqlens, n):
    """(n,) bool: position i and i + 1 of a packed row lie in one segment
    (the shifted target of a segment's last token is the next segment's
    first token, which packed training must not predict)."""
    cu = cu_seqlens.to(torch.long)
    pos = torch.arange(n, device=cu.device)
    return (torch.searchsorted(cu, pos, right=True)
            == torch.searchsorted(cu, pos + 1, right=True))


class LlamaPretrainingCriterion(Layer):
    """Shifted next-token cross entropy (the reference's criterion). With
    ``config.fuse_linear_cross_entropy`` the model returns the final
    hidden states and this criterion applies the chunked fused lm-head +
    loss; ``lm_head`` must then be passed, and is kept as a plain
    attribute, not a submodule, so its weight registers only on the
    model. With ``cu_seqlens`` (a packed (1, T) row) the positions whose
    target lies in the next segment leave the mean (unfused) or become
    ``ignore_index`` (fused)."""

    def __init__(self, config=None, lm_head=None):
        super().__init__()
        self._fuse = bool(config is not None
                          and config.fuse_linear_cross_entropy)
        self._lce_chunk_rows = int(
            getattr(config, "lce_chunk_rows", 0) or 1024)
        object.__setattr__(self, "_lm_head", lm_head)

    def forward(self, logits, labels, cu_seqlens=None):
        shifted = logits[:, :-1, :]
        targets = labels[:, 1:]
        same = None
        if cu_seqlens is not None:
            if logits.shape[0] != 1:
                raise ValueError(
                    f"packed cu_seqlens criterion expects batch 1 (packed "
                    f"(1, T) layout), got batch {logits.shape[0]}")
            same = _same_segment(
                torch.as_tensor(cu_seqlens, device=logits.device),
                targets.shape[1])
        if self._fuse:
            if self._lm_head is None:
                raise ValueError(
                    "fuse_linear_cross_entropy needs the lm_head: construct "
                    "LlamaPretrainingCriterion(config, lm_head=model.lm_head)")
            from ..incubate.nn.functional import fused_linear_cross_entropy

            if same is not None:
                targets = torch.where(same[None, :], targets, -100)
            return fused_linear_cross_entropy(
                shifted, self._lm_head.weight, targets,
                bias=self._lm_head.bias, chunk_rows=self._lce_chunk_rows)
        flat = shifted.reshape(-1, shifted.shape[-1])
        if same is None:
            return F.cross_entropy(flat, targets.reshape(-1))
        per_tok = F.cross_entropy(flat, targets.reshape(-1),
                                  reduction="none")
        mask = same.to(per_tok.dtype)
        return (per_tok * mask).sum() / mask.sum().clamp_min(1.0)
