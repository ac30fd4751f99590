"""The serving engine's speculative round (counterpart of
``paddle_tpu/serving/speculative.py``; speculative sampling after
Leviathan et al. and Chen et al.).

One round, over every serving slot at once, reads and writes only the
engine's static state buffers and the two paged pools, so the card runs it
as ONE captured CUDA graph (the reference jits it into one program):

- **draft**: γ+1 single-token steps of
  :func:`~paddle_tpu_torch.serving.engine.paged_decode_math` over the
  draft's pool at ``seq_lens + j`` (K2 on the card). Step j consumes the
  proposal of step j-1; step γ only writes proposal γ-1's KV, so a full
  accept leaves the draft's cache complete (a rejecting row's write lies
  past its new length and is overwritten by the next round).
- **verify**: one target forward over the chunk ``[last_tok, p_0 ..
  p_{γ-1}]`` (:func:`~paddle_tpu_torch.serving.engine.paged_chunk_math`),
  every position's logits at once, KV written at ``seq_lens + j``.
- **acceptance**: greedy accepts the longest prefix of proposals equal to
  the target's argmax and emits the target's own choice at every position,
  so the stream IS the target's greedy stream. Sampling is rejection
  sampling (:func:`rejection_sample`): accept p_j with probability
  min(1, p/q) of the filtered target and draft distributions, resample the
  first rejection from norm(max(p - q, 0)), and draw a bonus token from
  the target at position γ after a full accept: exact in distribution.
- **caps and roll forward**: the yield is cut at ``max_new`` and at eos;
  both pools advance ``seq_lens`` by the yield only, and the stale
  positions beyond it are the rollback (length masks hide them).

Draws: a proposal is ``keyed_gumbel_argmax(filt, seeds, n_gen + j)``, the
key the plain quantum gives its draw of that token, and the bonus token
is keyed at ``n_gen + γ``: a draft equal to the target replays the plain
sampling engine. The acceptance uniforms and the residual draws come from
``keyed_bits`` of the slot's seed with ``_ACC_TAG`` / ``_RES_TAG`` folded
in (:func:`_stream_keys`) at the absolute emission index, the same rule on
every device, so their streams are independent of the token stream.
"""
from __future__ import annotations

import torch

from ..nlp.generation import (_filter_logits, gumbel_noise, keyed_bits,
                              keyed_gumbel_argmax)
from .engine import paged_chunk_math, paged_decode_math

__all__ = ["make_spec_round", "rejection_sample"]

# stream tags: the acceptance uniforms and the residual resample must be
# independent of the token stream (which keys the plain engine's draws)
_ACC_TAG = 0x5ACC
_RES_TAG = 0x5E5A


def _stream_keys(seeds, base, tag, n):
    """The (seed, step) pairs of ``n`` draws per slot under ``tag``: the
    slot's seed with the tag folded into its top 16 bits (``seed ^ tag <<
    48``; request seeds stay below 2**48) and the absolute emission index
    ``base + j``. ``keyed_bits`` of a pair is a pure function of (slot,
    position, tag). Returns two (S * n,) int64 tensors, slot-major."""
    s = seeds.shape[0]
    tagged = seeds.to(torch.int64) ^ (int(tag) << 48)
    steps = (base.to(torch.int64)[:, None]
             + torch.arange(n, dtype=torch.int64, device=seeds.device))
    return tagged[:, None].expand(s, n).reshape(-1), steps.reshape(-1)


def _uniforms(bits):
    """u in [0, 1) from hashes in [0, 2**32): the top 24 bits over 2**24,
    exact in f32 (its largest value is 1 - 2**-24 < 1, so a ratio of
    exactly 1 always accepts)."""
    return (bits >> 8).to(torch.float32) * 2.0 ** -24


def rejection_sample(p, q, props, u, res_bits, fallback=None):
    """The sampling round's acceptance rule, a pure function.

    Args:
        p: (S, γ, V) the target's filtered probabilities at the γ
            proposal positions.
        q: (S, γ, V) the draft's filtered probabilities the proposals
            were drawn from.
        props: (S, γ) integer proposals.
        u: (S, γ) uniforms in [0, 1).
        res_bits: (S, γ, V) hashes in [0, 2**32) of the residual draws.
        fallback: (S, γ, V) logits drawn from where the residual sums to
            0 (only where p == q, whose ratio always accepts); default
            ``log(p)``.

    Returns ``(a, res)``: (S,) int64 accepted-prefix lengths (proposal j
    accepted when ``u_j < min(p/q, 1)``, counted up to the first
    rejection) and (S, γ) int64 residual draws, position j a Gumbel-max
    over ``log(max(p_j - q_j, 0))`` (``-inf`` where the residual is 0).
    The emitted token at the first rejection ``a`` is ``res[:, a]``."""
    idx = props.long()[..., None]
    p_at = p.gather(-1, idx)[..., 0]
    q_at = q.gather(-1, idx)[..., 0]
    ratio = p_at / torch.clamp_min(q_at, 1e-30)
    accept = u < torch.clamp_max(ratio, 1.0)
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)
    resid = torch.clamp_min(p - q, 0.0)
    rsum = resid.sum(dim=-1, keepdim=True)
    if fallback is None:
        fallback = torch.log(p)
    corr = torch.where(rsum > 0.0, torch.log(resid), fallback)
    res = torch.argmax(corr + gumbel_noise(res_bits), dim=-1)
    return a, res


def make_spec_round(engine):
    """Build the speculative round of ``engine`` (a
    :class:`~paddle_tpu_torch.serving.ServingEngine` with ``spec_draft``):
    a function of the engine's device state buffers that runs one round
    in place. It reads ``tables``, ``d_tables``, ``seq_lens`` (tokens in
    both caches), ``last_tok`` (the newest emitted token, not yet cached),
    ``n_gen``, ``done``, ``max_new`` and ``seeds``; it writes both pools,
    ``seq_lens``, ``last_tok``, ``n_gen``, ``done``, ``stream`` (S, γ+1,
    the emission matrix), ``emitted`` (the yield after the eos / max_new
    caps) and ``accepted`` (raw accepted proposals) in place. No host
    value enters it."""
    target = engine.model
    draft = engine.spec_draft
    gamma = int(engine.spec_gamma)
    greedy = engine.decode_strategy == "greedy"
    top_k, top_p, temp = engine.top_k, engine.top_p, engine.temperature
    eos = engine.eos_token_id
    attn_impl = engine.attn_impl
    t_pool, d_pool = engine.pool, engine.d_pool
    t_scratch = engine._scratch_block
    d_scratch = engine._d_scratch_block

    def spec_round(d):
        seq_lens, last_tok = d["seq_lens"], d["last_tok"]
        n_gen, done, max_new = d["n_gen"], d["done"], d["max_new"]
        seeds = d["seeds"]
        live = ~done
        s_ = last_tok.shape[0]
        dev = last_tok.device

        # -- draft: γ+1 single-token steps over the draft's pool --------
        props, qs = [], []
        cur = last_tok
        for j in range(gamma + 1):
            logits = paged_decode_math(
                draft, d_scratch, cur[:, None], seq_lens + j, d["d_tables"],
                d_pool.k_pools, d_pool.v_pools, live, d_pool.k_scales,
                d_pool.v_scales, attn_impl)
            if j == gamma:
                break               # this step only writes props[γ-1]
            if greedy:
                nxt = torch.argmax(logits, dim=-1)
            else:
                filt = _filter_logits(logits, top_k, top_p, temp)
                nxt = keyed_gumbel_argmax(filt, seeds, n_gen + j)
                qs.append(torch.softmax(filt, dim=-1))
            cur = nxt.int()
            props.append(cur)
        prop = torch.stack(props, dim=1)                  # (S, γ)

        # -- verify: one target forward over the γ+1 positions ----------
        chunk = torch.cat([last_tok[:, None], prop], dim=1)
        t_logits = paged_chunk_math(
            target, t_scratch, chunk, seq_lens, d["tables"],
            t_pool.k_pools, t_pool.v_pools, live, t_pool.k_scales,
            t_pool.v_scales)                              # (S, γ+1, V)

        # -- acceptance prefix, bonus / resample ------------------------
        pos = torch.arange(gamma + 1, device=dev)
        if greedy:
            # accepted proposals equal the target's argmax, so the
            # target's own choices ARE the stream: exact by construction
            stream = torch.argmax(t_logits, dim=-1).int()
            match = prop == stream[:, :gamma]
            a = torch.cumprod(match.long(), dim=1).sum(dim=1)
        else:
            v = t_logits.shape[-1]
            filt_t = _filter_logits(
                t_logits.reshape(s_ * (gamma + 1), v), top_k, top_p,
                temp).reshape(s_, gamma + 1, v)
            p = torch.softmax(filt_t[:, :gamma], dim=-1)
            q = torch.stack(qs, dim=1)
            sd, st = _stream_keys(seeds, n_gen, _ACC_TAG, gamma)
            u = _uniforms(keyed_bits(sd, st, 1)).reshape(s_, gamma)
            sd, st = _stream_keys(seeds, n_gen, _RES_TAG, gamma)
            res_bits = keyed_bits(sd, st, v).reshape(s_, gamma, v)
            a, res = rejection_sample(p, q, prop, u, res_bits,
                                      filt_t[:, :gamma])
            # the bonus token after a full accept, on the TOKEN stream's
            # key: a draft equal to the target replays the plain engine
            bonus = keyed_gumbel_argmax(filt_t[:, gamma], seeds,
                                        n_gen + gamma)
            corr = torch.cat([res, bonus[:, None]], dim=1).int()
            stream = torch.where(pos[None, :] < a[:, None],
                                 torch.cat([prop, prop[:, :1]], dim=1),
                                 corr)

        # -- yield caps (max_new, eos), then roll both caches forward ---
        remaining = torch.clamp_min(max_new - n_gen, 0)
        e = torch.minimum(a + 1, remaining.long())
        if eos is not None:
            hit = (stream == eos) & (pos[None, :] < e[:, None])
            any_hit = hit.any(dim=1)
            first = torch.argmax(hit.int(), dim=1)
            e = torch.where(any_hit, first + 1, e)
        e = torch.where(live, e, 0).int()
        n_gen2 = n_gen + e
        done2 = done | (n_gen2 >= max_new)
        if eos is not None:
            done2 = done2 | (live & any_hit)
        new_last = stream.gather(1, torch.clamp_min(e - 1, 0).long()[
            :, None])[:, 0]
        last_tok2 = torch.where(e > 0, new_last, last_tok)
        for name, val in (("seq_lens", seq_lens + e),
                          ("last_tok", last_tok2), ("n_gen", n_gen2),
                          ("done", done2), ("stream", stream),
                          ("emitted", e),
                          ("accepted", torch.where(live, a, 0))):
            d[name].copy_(val)

    return spec_round
