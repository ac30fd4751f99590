"""Text generation over a contiguous KV cache (counterpart of
``paddle_tpu/nlp/generation.py``).

Entry points:

- ``greedy_search``: host loop of single-token steps with f32 caches and
  an eos early exit (one host sync per step, for that check);
- ``generate_on_device`` / ``sampling_search``: the reference compiles
  prefill plus a ``lax.scan`` of single-token steps into one program;
  here the prefill runs eagerly and the decode step is one captured CUDA
  graph (:mod:`paddle_tpu_torch._graphs`) over static buffers: the
  tokens, the done mask, the caches, and the position as a 0-d int32
  device tensor that the step advances itself. The step is captured
  once per (model, B, prompt length, new tokens, strategy) and kept
  with its buffers (:class:`_DecodeSteps`, one per model): the first
  such call runs its first decode step as the eager warm-up on the
  capture stream and captures the step, and every decode step after
  that, in this call or a later one with the same key, is a replay
  enqueued with no host sync. On the CPU the same step runs eagerly;
- ``beam_search``: the same fixed-trip loop as eager steps (its caches
  are reordered by the surviving beams each step);
- ``generate``: the paddle-style facade routing ``decode_strategy``;
- ``speculative_generate``: speculative decoding through the serving
  engine's speculative round (one captured graph a round on the card);
  ``speculative_greedy_search``: the host-driven batch-1 speculative loop
  over contiguous caches, kept as the debuggable baseline.

Every step is ``model(tokens, position_offset, caches)``: rope at the
step's offset, the K/V written into the cache (wrapping in a sliding
window's rolling buffer), and attention through the decode kernel K5;
prefill of a windowed model attends through K4.

Sampling cannot reproduce JAX's threefry bits. Each draw is a Gumbel-max
over the filtered logits (:func:`keyed_gumbel_argmax`) whose noise for
row r, token v is an integer hash of (the row's seed, the row's step, v)
computed on the device: deterministic given (seed, inputs), independent of
how steps are grouped, free of host values (so it can be captured), and
the same bits on the CPU and the card.
"""
from __future__ import annotations

import itertools
import weakref

import numpy as np
import torch

from .._graphs import CapturedStep
from ..ops import _library as L

__all__ = ["greedy_search", "generate_on_device", "sampling_search",
           "beam_search", "generate", "speculative_generate",
           "speculative_greedy_search", "fold_seed", "keyed_gumbel_argmax"]

_MASK64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
# odd multipliers below 2**31: a 32-bit lane times one stays below 2**63,
# so the int64 products never overflow
_MIX = ((16, 0x7FEB352D), (15, 0x5BD1E995))
_LANE0 = 0x3C6EF372
# run generate's decode step eagerly on the card too, on buffers of the
# call's own (the oracle of the captured step in the card tests and
# chip_smoke.py)
_EAGER = False
# each model's latest _DecodeSteps; it holds its model only weakly
_STEPS = weakref.WeakKeyDictionary()


def fold_seed(seed, step):
    """A 63-bit seed from (seed, step) (splitmix64 of the pair): the
    counterpart of ``jax.random.fold_in(PRNGKey(seed), step)``;
    :func:`sampling_search` keys row r by ``fold_seed(seed, r)``."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(step) + 1) & _MASK64
    for shift, mul in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        x = ((x ^ (x >> shift)) * mul) & _MASK64
    return (x ^ (x >> 31)) & ((1 << 63) - 1)


def _mix32(x):
    """A 32-bit finalizer over int64 tensors holding values in [0, 2**32)
    (``>>`` on int64 is arithmetic; the values stay non-negative)."""
    for shift, mul in _MIX:
        x = x ^ (x >> shift)
        x = (x * mul) & _M32
    return x ^ (x >> 16)


def keyed_bits(seeds, steps, vocab):
    """(R, vocab) int64 hashes in [0, 2**32): entry (r, v) is a pure
    function of (``seeds[r]``, ``steps[r]``, v). ``seeds`` (R,) int64 and
    ``steps`` (R,) or 0-d integer tensors on one device."""
    seeds = seeds.to(torch.int64)
    steps = steps.to(torch.int64)
    row = _mix32((seeds & _M32) ^ _LANE0)
    row = _mix32(row ^ ((seeds >> 32) & _M32))
    row = _mix32(row ^ (steps & _M32))
    tok = _mix32(torch.arange(vocab, dtype=torch.int64, device=seeds.device))
    return _mix32(row[:, None] ^ tok[None, :])


def gumbel_noise(bits):
    """Gumbel noise ``-log(-log(u))`` in f32 from hashes in [0, 2**32):
    u = (top 24 bits + 0.5) / 2**24 lies in (0, 1) exclusive. u and the
    logs are taken in f64, where u is exact: in f32 the top hash's u,
    1 - 2**-25, rounds to 1.0, whose noise is +inf (a kept token would
    always win, and a cut one, -inf + inf, would be a NaN that argmax
    picks). The noise lies in [-2.86, 17.33]."""
    u = ((bits >> 8).to(torch.float64) + 0.5) * 2.0 ** -24
    return (-torch.log(-torch.log(u))).to(torch.float32)


def keyed_gumbel_argmax(filt, seeds, steps):
    """One categorical draw per row of the filtered logits ``filt`` (R, V)
    (``-inf`` marks cut tokens): argmax of logits plus Gumbel noise, the
    noise of row r, token v a pure function of (``seeds[r]``,
    ``steps[r]``, v) (:func:`keyed_bits`, :func:`gumbel_noise`). Returns
    (R,) int64."""
    bits = keyed_bits(seeds, steps, filt.shape[-1])
    return torch.argmax(filt + gumbel_noise(bits), dim=-1)


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


def _selector(strategy, seeds):
    """A decode step's token choice ``select(logits, draw) -> (B,) int64``
    for ``strategy``: ``("greedy",)`` or ``("sampling", top_k, top_p,
    temperature)``, row r's noise keyed by (``seeds[r]``, ``draw``)."""
    if strategy[0] == "greedy":
        return lambda logits, draw: torch.argmax(logits, dim=-1)
    _, top_k, top_p, temperature = strategy

    def select(logits, draw):
        filt = _filter_logits(logits, top_k, top_p, temperature)
        return keyed_gumbel_argmax(filt, seeds, draw)

    return select


class _DecodeSteps:
    """The static buffers and the decode step of generate calls with one
    key: the caches, the token and output buffers, the done mask, the
    rows' seeds, and three counters the step advances itself (the
    position as a 0-d int32 tensor, the output column, the draw). On the
    card the step is a :class:`~paddle_tpu_torch._graphs.CapturedStep`:
    the first call that runs a decode step warms it up and captures it,
    and every later step is a replay. A call restages the buffers with
    device ops only, so it syncs the host nowhere after the seeds' copy.

    The key holds what the graph bakes in: B, prompt length, new tokens,
    the caches' dtype, the device, the strategy, eos and pad, the kernel
    mode (``ops.plain_versions``), the f32 matmul precision, and the
    addresses of the weights (a replaced weight tensor gets a new
    graph). Stale cache entries need no clearing: the prefill rewrites
    the prompt's slots and a decode step writes its slot before it
    attends, never past it."""

    def __init__(self, model, key, ids, new, dtype, strategy, eos, pad,
                 capture):
        b, s_in = ids.shape
        dev = ids.device
        self.key, self.s_in, self.new = key, s_in, new
        self.caches = caches = model.init_caches(b, s_in + new, dtype=dtype)
        self.tok = tok = torch.zeros(b, 1, dtype=torch.long, device=dev)
        self.out = out = torch.empty(b, new, dtype=torch.long, device=dev)
        self.pos = pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.col = col = torch.zeros(1, dtype=torch.int64, device=dev)
        self.draw = draw = torch.zeros((), dtype=torch.int64, device=dev)
        self.done = done = torch.zeros(b, dtype=torch.bool, device=dev)
        self.seeds = torch.zeros(b, dtype=torch.int64, device=dev)
        self.select = select = _selector(strategy, self.seeds)
        # the step (and so the cache of steps) must not keep the model
        # alive; a replay runs no Python
        ref = weakref.ref(model)

        def step():
            logits, _ = ref()(tok, pos, caches)
            nxt = select(logits[:, -1], draw)[:, None]
            if eos is not None:
                done.logical_or_(tok[:, 0] == eos)
                nxt = torch.where(done[:, None], pad, nxt)
            out.index_copy_(1, col, tok)
            tok.copy_(nxt)
            for t in (pos, col, draw):
                t.add_(1)

        self.step = step
        self.graph = CapturedStep(step, dev) if capture else None

    def __call__(self, model, ids, seeds):
        if seeds is not None:
            self.seeds.copy_(torch.tensor(seeds, dtype=torch.int64))
        logits, _ = model(ids, 0, self.caches)
        self.draw.zero_()
        self.tok.copy_(self.select(logits[:, -1], self.draw)[:, None])
        del logits
        self.pos.fill_(self.s_in)
        self.col.zero_()
        self.done.zero_()
        self.draw.fill_(1)
        n = self.new - 1
        if self.graph is None:
            for _ in range(n):
                self.step()
        else:
            self.graph.run(n)
        self.out[:, -1] = self.tok[:, 0]
        return torch.cat([ids, self.out], dim=1)


@torch.no_grad()
def _ondevice_decode(model, input_ids, max_new_tokens, strategy,
                     seeds=None, eos_token_id=None, pad_token_id=None):
    """Prefill plus ``max_new_tokens - 1`` single-token steps with caches
    in the parameters' dtype, tokens chosen by ``strategy`` (see
    :func:`_selector`; ``seeds`` the rows' draw seeds). Rows that emitted
    ``eos_token_id`` keep emitting ``pad_token_id`` (default: the eos id)
    for the remaining fixed-trip steps. The step runs on the buffers of
    the model's :class:`_DecodeSteps` for this call's key, made anew (and
    the previous one freed first) when the key changes; on the card it is
    one captured CUDA graph."""
    ids = _ids(model, input_ids)
    eos = None if eos_token_id is None else int(eos_token_id)
    pad = eos if pad_token_id is None else int(pad_token_id)
    dtype = _param_dtype(model)
    key = (tuple(ids.shape), ids.device, max_new_tokens, dtype, strategy,
           eos, pad, L._plain, torch.get_float32_matmul_precision(),
           tuple(t.data_ptr() for t in itertools.chain(model.parameters(),
                                                       model.buffers())))
    if _EAGER:
        steps = _DecodeSteps(model, key, ids, max_new_tokens, dtype,
                             strategy, eos, pad, capture=False)
        return steps(model, ids, seeds)
    steps = _STEPS.get(model)
    if steps is None or steps.key != key:
        _STEPS.pop(model, None)
        del steps
        steps = _DecodeSteps(model, key, ids, max_new_tokens, dtype,
                             strategy, eos, pad,
                             capture=ids.device.type == "cuda")
        _STEPS[model] = steps
    return steps(model, ids, seeds)


def generate_on_device(model, input_ids, max_new_tokens=32,
                       eos_token_id=None, pad_token_id=None):
    """Whole greedy decode, fixed trip (see :func:`_ondevice_decode`)."""
    return _ondevice_decode(model, input_ids, int(max_new_tokens),
                            ("greedy",), eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id)


def sampling_search(model, input_ids, max_new_tokens=32, top_k=0,
                    top_p=1.0, temperature=1.0, seed=0, eos_token_id=None,
                    pad_token_id=None):
    """Whole sampling decode: step i draws from the temperature / top-k /
    top-p filtered distribution, row r's noise keyed by
    (``fold_seed(seed, r)``, i) (:func:`keyed_gumbel_argmax`);
    deterministic given (seed, inputs). None disables a knob."""
    top_k = 0 if top_k is None else int(top_k)
    top_p = 1.0 if top_p is None else float(top_p)
    temperature = 1.0 if temperature is None else float(temperature)
    ids = _ids(model, input_ids)
    seeds = [fold_seed(seed, r) for r in range(ids.shape[0])]
    return _ondevice_decode(model, ids, int(max_new_tokens),
                            ("sampling", top_k, top_p, temperature),
                            seeds=seeds, eos_token_id=eos_token_id,
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


def speculative_generate(target, draft, input_ids, max_new_tokens=32,
                         gamma=4, decode_strategy="greedy", top_k=0,
                         top_p=1.0, temperature=1.0, seed=0,
                         eos_token_id=None, block_size=32, obs=None):
    """Speculative decoding through the serving engine: every batch row
    rides a serving slot of ``ServingEngine(target, spec_draft=draft,
    spec_gamma=gamma)``, and each round (the draft's ``gamma`` proposals,
    the target's verify of all γ+1 positions in one forward, acceptance
    and both pools' roll forward) is one captured CUDA graph on the card.
    The greedy arm emits exactly the target's greedy decode;
    ``decode_strategy="sampling"`` is rejection sampling, exact in
    distribution, row i seeded with ``seed + i``.

    Returns ``(tokens, acceptance_rate)``: (B, S_in + max_new_tokens)
    int64 ids on the target's device (a row that ends early at
    ``eos_token_id`` pads its tail with it, else with 0) and the share of
    draft proposals accepted over the run.

    ``obs`` goes to the engine: a
    :class:`~paddle_tpu_torch.obs.ServingObs` collects this call's time
    to first token, latency and acceptance metrics (and trace spans, if
    its tracer is set) into a registry you read; every hook runs at the
    host's round boundaries, never in the captured round."""
    from ..serving import ServingEngine

    dev = target.lm_head.weight.device
    rows = np.asarray(input_ids.cpu() if isinstance(input_ids, torch.Tensor)
                      else input_ids).astype(np.int32)
    b, s_in = rows.shape
    strategy = ("greedy" if decode_strategy in ("greedy", "greedy_search")
                else decode_strategy)
    engine = ServingEngine(
        target, spec_draft=draft, spec_gamma=gamma, num_slots=b,
        block_size=block_size, max_context=s_in + max_new_tokens,
        decode_strategy=strategy, top_k=top_k, top_p=top_p,
        temperature=temperature, eos_token_id=eos_token_id, obs=obs,
        device=dev)
    reqs = [engine.submit(rows[i], max_new_tokens=max_new_tokens,
                          seed=seed + i) for i in range(b)]
    engine.run()
    pad = 0 if eos_token_id is None else int(eos_token_id)
    out = np.full((b, s_in + max_new_tokens), pad, np.int64)
    for i, req in enumerate(reqs):
        toks = engine.output_tokens(req)
        out[i, :toks.shape[0]] = toks
    return (torch.from_numpy(out).to(dev),
            engine.engine_stats()["spec_acceptance_rate"])


@torch.no_grad()
def speculative_greedy_search(target, draft, input_ids, max_new_tokens=32,
                              gamma=4):
    """Speculative greedy decoding, host-driven, batch 1, over contiguous
    caches in the models' dtypes: the draft proposes ``gamma`` tokens one
    step at a time (the decode kernel K5), the target verifies them in
    one (g+1)-token forward, and the longest prefix equal to the target's
    own choices is accepted plus the target's token at the first
    mismatch. The caches roll back by position: a rejected slot is
    overwritten by the next round. After a full accept the draft runs one
    extra forward to cache its last proposal. The output follows the
    target's batched verify forwards: a near-tie may resolve there
    otherwise than in a step-wise decode. The serving-grade path is
    :func:`speculative_generate`. Returns ``(tokens, acceptance_rate)``,
    tokens (1, S_in + max_new_tokens) int64."""
    ids = _ids(target, input_ids)
    b, s_in = ids.shape
    if b != 1:
        raise ValueError(
            f"speculative decoding is per-sequence (batch 1), got {b}")
    for name, m in (("target", target), ("draft", draft)):
        if getattr(m.config, "sliding_window", None):
            raise NotImplementedError(
                f"speculative decoding with a sliding-window {name} is "
                f"not supported: rollback-by-overwrite cannot restore "
                f"rolling-buffer slots the rejected proposals wrapped "
                f"over")
    dev = ids.device
    total = s_in + max_new_tokens + gamma + 1
    t_caches = target.init_caches(1, total)
    d_caches = draft.init_caches(1, total)
    t_logits, t_caches = target(ids, 0, t_caches)
    _, d_caches = draft(ids, 0, d_caches)
    cur = int(t_logits[0, -1].argmax())

    def tok(*values):
        return torch.tensor([list(values)], dtype=torch.long, device=dev)

    out = ids[0].tolist() + [cur]
    pos, n = s_in, 1
    proposed = accepted = 0
    while n < max_new_tokens:
        g = min(gamma, max_new_tokens - n)
        props, d_cur = [], cur
        for i in range(g):
            dl, d_caches = draft(tok(d_cur), pos + i, d_caches)
            d_cur = int(dl[0, -1].argmax())
            props.append(d_cur)
        # one target forward verifies every proposal (+ the bonus slot)
        tl, t_caches = target(tok(cur, *props), pos, t_caches)
        t_choice = tl[0].argmax(dim=-1).tolist()         # (g+1,)
        a = 0
        while a < g and props[a] == t_choice[a]:
            a += 1
        emit = props[:a] + [t_choice[a]]
        proposed += g
        accepted += a
        out.extend(emit)
        n += len(emit)
        cur = emit[-1]
        pos += a + 1
        # a full accept: the draft proposed props[g-1] but never consumed
        # it, so its slot would stay a hole in the draft's history
        if a == g and n < max_new_tokens:
            _, d_caches = draft(tok(props[g - 1]), pos - 1, d_caches)
    tokens = torch.tensor([out[:s_in + max_new_tokens]], dtype=torch.long,
                          device=dev)
    return tokens, accepted / max(proposed, 1)
