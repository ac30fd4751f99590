"""Text generation over a contiguous KV cache (counterpart of
``paddle_tpu/nlp/generation.py``).

Entry points:

- ``greedy_search``: host loop of single-token steps with f32 caches and
  an eos early exit (one host sync per step, for that check);
- ``generate_on_device`` / ``sampling_search`` / ``beam_search``: the
  reference compiles prefill plus a ``lax.scan`` of single-token steps
  into one program; here the same fixed-trip loop runs as eager steps with
  the tokens, done masks and caches left on the device and no host sync
  until the result is read;
- ``generate``: the paddle-style facade routing ``decode_strategy``.

Every step is ``model(tokens, position_offset, caches)``: rope at the
step's offset, the K/V written into the cache (wrapping in a sliding
window's rolling buffer), and attention through the decode kernel K5;
prefill of a windowed model attends through K4.

Sampling cannot reproduce JAX's threefry bits. Each draw is a Gumbel-max
over the filtered logits with noise from a ``torch.Generator`` seeded by
:func:`fold_seed` of (seed, step): deterministic given (seed, inputs) and
independent of how steps are grouped. ``speculative_generate`` is not
ported yet (ROADMAP A2).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["greedy_search", "generate_on_device", "sampling_search",
           "beam_search", "generate", "fold_seed"]

_MASK64 = (1 << 64) - 1


def fold_seed(seed, step):
    """A 63-bit generator seed from (seed, step) (splitmix64 of the pair):
    the counterpart of ``jax.random.fold_in(PRNGKey(seed), step)``."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        x = ((x ^ (x >> shift)) * mul) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def gumbel_argmax(filt, seeds):
    """One categorical draw per row of the filtered logits ``filt`` (R, V)
    (``-inf`` marks cut tokens): argmax of logits plus Gumbel noise, the
    noise of row i from a generator seeded with ``seeds[i]``, or of all
    rows from one generator when ``seeds`` is an int. Returns (R,) int64."""
    dev = filt.device
    g = torch.Generator(device=dev)
    if isinstance(seeds, int):
        u = torch.rand(filt.shape, generator=g.manual_seed(seeds), device=dev)
    else:
        # reseeding restarts the stream: row i draws what a fresh generator
        # seeded with seeds[i] would
        u = torch.stack([torch.rand(filt.shape[-1], device=dev,
                                    generator=g.manual_seed(s))
                         for s in seeds])
    return torch.argmax(filt - torch.log(-torch.log(u)), dim=-1)


def _filter_logits(logits, top_k, top_p, temperature):
    """Sampling logits transform: temperature scale (clamped at 1e-6),
    then top-k cut, then nucleus (top-p) cut keeping the smallest prefix
    with cumulative probability >= top_p (the first token always
    survives). (B, V) f32 out, cut tokens at ``-inf``."""
    logits = logits.float()
    if temperature is not None and temperature != 1.0:
        # a device tensor divisor: true f32 division, as the per-slot path
        # (a scalar divisor becomes a multiply by its reciprocal); filled
        # on the device, so no blocking host-to-device copy per step
        logits = logits / torch.full((), max(float(temperature), 1e-6),
                                     dtype=torch.float32,
                                     device=logits.device)
    v = logits.shape[-1]
    if top_k and 0 < top_k < v:
        kth = torch.topk(logits, int(top_k), dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if top_p is not None and 0.0 < top_p < 1.0:
        sorted_l = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        n_keep = (cum - probs < top_p).sum(dim=-1)
        cutoff = sorted_l.gather(-1, (n_keep - 1).clamp_min(0)[:, None])
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return logits


def _ids(model, input_ids):
    dev = model.lm_head.weight.device
    if isinstance(input_ids, torch.Tensor):
        return input_ids.to(dev, torch.long)
    return torch.as_tensor(np.asarray(input_ids), dtype=torch.long,
                           device=dev)


def _param_dtype(model):
    return next(p.dtype for p in model.parameters() if p.is_floating_point())


@torch.no_grad()
def greedy_search(model, input_ids, max_new_tokens=32, max_length=None,
                  eos_token_id=None):
    """Host-driven greedy decode with f32 caches. Returns (B, S_in +
    generated) int64 ids; stops early once every row's last token is
    ``eos_token_id``."""
    ids = _ids(model, input_ids)
    b, s_in = ids.shape
    total = max_length or (s_in + max_new_tokens)
    caches = model.init_caches(b, total, dtype=torch.float32)
    logits, caches = model(ids, 0, caches)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out = [ids, nxt]
    pos = s_in
    while pos + 1 < total:
        logits, caches = model(nxt, pos, caches)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(nxt)
        pos += 1
        if eos_token_id is not None and bool((nxt == eos_token_id).all()):
            break
    return torch.cat(out, dim=1)


@torch.no_grad()
def _ondevice_decode(model, input_ids, max_new_tokens, select,
                     eos_token_id=None, pad_token_id=None):
    """Prefill plus ``max_new_tokens - 1`` single-token steps with caches
    in the parameters' dtype. ``select(logits, i) -> (B,) int64`` picks
    step i's tokens. Rows that emitted ``eos_token_id`` keep emitting
    ``pad_token_id`` (default: the eos id) for the remaining fixed-trip
    steps."""
    ids = _ids(model, input_ids)
    b, s_in = ids.shape
    eos = None if eos_token_id is None else int(eos_token_id)
    pad = eos if pad_token_id is None else int(pad_token_id)
    caches = model.init_caches(b, s_in + max_new_tokens,
                               dtype=_param_dtype(model))
    logits, caches = model(ids, 0, caches)
    tok = select(logits[:, -1], 0)[:, None]
    done = torch.zeros(b, dtype=torch.bool, device=ids.device)
    toks = []
    for i in range(max_new_tokens - 1):
        logits, caches = model(tok, s_in + i, caches)
        nxt = select(logits[:, -1], i + 1)[:, None]
        if eos is not None:
            done = done | (tok[:, 0] == eos)
            nxt = torch.where(done[:, None], pad, nxt)
        toks.append(tok[:, 0])
        tok = nxt
    gen = torch.stack(toks + [tok[:, 0]], dim=1)
    return torch.cat([ids, gen], dim=1)


def generate_on_device(model, input_ids, max_new_tokens=32,
                       eos_token_id=None, pad_token_id=None):
    """Whole greedy decode, fixed trip (see :func:`_ondevice_decode`)."""
    return _ondevice_decode(
        model, input_ids, max_new_tokens,
        lambda logits, i: torch.argmax(logits, dim=-1),
        eos_token_id=eos_token_id, pad_token_id=pad_token_id)


def sampling_search(model, input_ids, max_new_tokens=32, top_k=0,
                    top_p=1.0, temperature=1.0, seed=0, eos_token_id=None,
                    pad_token_id=None):
    """Whole sampling decode: step i draws from the temperature / top-k /
    top-p filtered distribution with noise seeded by ``fold_seed(seed,
    i)``; deterministic given (seed, inputs). None disables a knob."""
    top_k = 0 if top_k is None else int(top_k)
    top_p = 1.0 if top_p is None else float(top_p)
    temperature = 1.0 if temperature is None else float(temperature)

    def select(logits, i):
        filt = _filter_logits(logits, top_k, top_p, temperature)
        return gumbel_argmax(filt, fold_seed(seed, i))

    return _ondevice_decode(model, input_ids, max_new_tokens, select,
                            eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id)


@torch.no_grad()
def beam_search(model, input_ids, max_new_tokens=32, num_beams=4,
                length_penalty=1.0, eos_token_id=None, pad_token_id=None):
    """Beam search: beams ride the batch axis (B * num_beams rows), each
    step reorders the caches by the surviving beams, and the best beam
    per row (sum log-prob over generated length ** ``length_penalty``)
    is returned. A beam that emits ``eos_token_id`` retires: its only
    continuation is ``pad_token_id`` (default: eos) at zero cost and its
    length stops growing. Returns ``(ids, best_scores)``."""
    ids = _ids(model, input_ids)
    b, s_in = ids.shape
    vocab = model.config.vocab_size
    nb = int(num_beams)
    eos = None if eos_token_id is None else int(eos_token_id)
    pad = eos if pad_token_id is None else int(pad_token_id)
    dev = ids.device
    caches = model.init_caches(b, s_in + max_new_tokens,
                               dtype=_param_dtype(model))
    logits, caches = model(ids, 0, caches)
    logp0 = torch.log_softmax(logits[:, -1].float(), dim=-1)
    scores0, tok0 = torch.topk(logp0, nb, dim=-1)
    caches = [(k.repeat_interleave(nb, dim=0), v.repeat_interleave(nb, dim=0))
              for k, v in caches]
    tok = tok0.reshape(b * nb, 1)
    scores = scores0.reshape(b * nb)
    seqs = torch.zeros(b * nb, max_new_tokens, dtype=torch.long, device=dev)
    seqs[:, 0] = tok[:, 0]
    done = torch.zeros(b * nb, dtype=torch.bool, device=dev)
    lens = torch.ones(b * nb, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)[:, None] * nb
    for i in range(max_new_tokens - 1):
        logits, caches = model(tok, s_in + i, caches)
        logp = torch.log_softmax(logits[:, -1].float(), dim=-1)
        if eos is not None:
            done = done | (tok[:, 0] == eos)
            # retired beams: one zero-cost pad continuation (any other
            # child would duplicate the frozen hypothesis)
            logp = logp.masked_fill(done[:, None], -torch.inf)
            logp[:, pad] = torch.where(done, 0.0, logp[:, pad])
        cand = (scores[:, None] + logp).reshape(b, nb * vocab)
        new_scores, flat = torch.topk(cand, nb, dim=-1)
        gidx = (rows + flat // vocab).reshape(-1)
        caches = [(k[gidx], v[gidx]) for k, v in caches]
        seqs = seqs[gidx]
        seqs[:, i + 1] = (flat % vocab).reshape(-1)
        done = done[gidx]
        lens = lens[gidx] + (~done).int()
        tok = (flat % vocab).reshape(b * nb, 1)
        scores = new_scores.reshape(-1)
    norm = scores.reshape(b, nb) / (lens.reshape(b, nb).float()
                                    ** float(length_penalty))
    best = torch.argmax(norm, dim=-1)
    pick = torch.arange(b, device=dev)
    gen = seqs.reshape(b, nb, max_new_tokens)[pick, best]
    best_scores = scores.reshape(b, nb)[pick, best]
    return torch.cat([ids, gen], dim=1), best_scores


def generate(model, input_ids, max_new_tokens=32,
             decode_strategy="greedy_search", top_k=0, top_p=1.0,
             temperature=1.0, num_beams=1, length_penalty=1.0, seed=0,
             eos_token_id=None, pad_token_id=None, **kwargs):
    """Paddle generation facade: routes to the greedy / sampling / beam
    loops. Rows (or beams) that emit ``eos_token_id`` pad out / retire.
    Unknown kwargs raise, and so do sampling or beam knobs under a
    strategy that would silently ignore them."""
    if kwargs:
        raise TypeError(f"generate: unsupported kwargs {sorted(kwargs)}")
    sampling_knobs = ((top_k or 0) > 0
                      or (top_p is not None and top_p < 1.0)
                      or (temperature is not None and temperature != 1.0))
    beam_knobs = num_beams != 1 or length_penalty != 1.0
    if decode_strategy in ("greedy_search", "greedy"):
        if sampling_knobs or beam_knobs:
            raise ValueError(
                "generate: sampling/beam knobs require "
                "decode_strategy='sampling'/'beam_search' (greedy would "
                "silently ignore them)")
        return generate_on_device(model, input_ids, max_new_tokens,
                                  eos_token_id=eos_token_id,
                                  pad_token_id=pad_token_id)
    if decode_strategy == "sampling":
        if beam_knobs:
            raise ValueError(
                "generate: num_beams/length_penalty require "
                "decode_strategy='beam_search'")
        return sampling_search(model, input_ids, max_new_tokens,
                               top_k=top_k, top_p=top_p,
                               temperature=temperature, seed=seed,
                               eos_token_id=eos_token_id,
                               pad_token_id=pad_token_id)
    if decode_strategy == "beam_search":
        if sampling_knobs:
            raise ValueError(
                "generate: top_k/top_p/temperature require "
                "decode_strategy='sampling' (beam search would silently "
                "ignore them)")
        out, _ = beam_search(model, input_ids, max_new_tokens,
                             num_beams=num_beams,
                             length_penalty=length_penalty,
                             eos_token_id=eos_token_id,
                             pad_token_id=pad_token_id)
        return out
    raise ValueError(
        f"decode_strategy must be greedy_search|sampling|beam_search, "
        f"got {decode_strategy!r}")
