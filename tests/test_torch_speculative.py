"""Speculative serving of the port held against paddle_tpu's
(``LlamaConfig.tiny`` target and a seeded 1-layer tiny draft, f32, the
same carried weights; tests/test_serving.py's fixtures).

- the chunked verify attention (``_paged_chunk_attn``) and the verify
  forward (``paged_chunk_math``) against the reference's, float and int8
  pools, GQA, masked rows: f32 within 1e-5, pool rows equal after the
  writes (int8 codes and their scales);
- tests/test_serving.py's ragged-eos scenario on both engines (2 slots,
  eos, γ = 2): streams, finish reasons, counters (``spec_rounds``,
  ``spec_proposed``, ``spec_accepted`` among them) and both pools'
  statistics equal; the streams also equal the port's sequential greedy
  oracle;
- the rejection sampler alone on synthetic p and q: the emitted token's
  frequencies match p within 4 sigma over 20,000 seeded trials, for an
  independent q and for q = p (every proposal accepted);
- sampling with the target as its own draft replays the port's plain
  sampling engine and accepts every proposal;
- the prefix cache, int8 weights and KV pools, ``multi_quantum=4``;
- ``speculative_generate`` and ``speculative_greedy_search`` against the
  reference's, in tokens and acceptance rate, with a full-accept case.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import generation as ref_generation
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu.serving import engine as ref_engine_mod
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.nlp import generation
from paddle_tpu_torch.nlp.generation import keyed_bits
from paddle_tpu_torch.serving import ServingEngine, rejection_sample
from paddle_tpu_torch.serving import engine as port_engine_mod

_COUNTERS = ("steps", "mixed_steps", "decode_quanta", "quantum_tokens",
             "prefill_tokens", "generated_tokens", "admitted", "finished",
             "spec_rounds", "spec_proposed", "spec_accepted")


def _ref_target():
    """A fresh reference target (a quantized engine sweeps its model in
    place); the same seed gives the same weights."""
    paddle.seed(0)
    model = RefLM(RefConfig.tiny(tensor_parallel=False))
    model.eval()
    return model


def _ref_draft():
    """tests/test_serving.py's independent draft: random, one layer."""
    paddle.seed(11)
    model = RefLM(RefConfig.tiny(tensor_parallel=False,
                                 num_hidden_layers=1))
    model.eval()
    return model


def _port(arrays, layers=None):
    kw = {} if layers is None else {"num_hidden_layers": layers}
    model = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False, **kw),
                             device="cpu")
    return load_paddle_tpu_arrays(model, arrays)


def _arrays(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def models():
    ref_t, ref_d = _ref_target(), _ref_draft()
    t_arr, d_arr = _arrays(ref_t), _arrays(ref_d)
    return {"ref": (ref_t, ref_d), "arrays": (t_arr, d_arr),
            "port": (_port(t_arr), _port(d_arr, layers=1))}


def _engine(model, ref=False, **kw):
    if ref:
        return RefEngine(model, **kw)
    return ServingEngine(model, device="cpu", **kw)


def _result(eng, reqs):
    st = eng.engine_stats()
    return {"streams": [list(map(int, r.tokens)) for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "counters": {k: st[k] for k in _COUNTERS},
            "pool": st["pool"], "draft_pool": st["draft_pool"],
            "prefix": st.get("prefix_cache"),
            "draft_prefix": st.get("draft_prefix_cache")}


def _equal_results(got, want):
    for key in ("streams", "reasons", "counters", "pool", "draft_pool",
                "prefix", "draft_prefix"):
        assert got[key] == want[key], key


# ------------------------------------------------ the verify's math
def _chunk_inputs(rng, s, c, w, bs, hq, hk, d, nb, base, int8=False):
    q = rng.randn(s, c, hq, d).astype(np.float32)
    if int8:
        kp = rng.randint(-127, 128, (nb, bs, hk, d)).astype(np.int8)
        vp = rng.randint(-127, 128, (nb, bs, hk, d)).astype(np.int8)
    else:
        kp = rng.randn(nb, bs, hk, d).astype(np.float32)
        vp = rng.randn(nb, bs, hk, d).astype(np.float32)
    tables = rng.randint(0, nb, (s, w)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(base, np.int32)


@pytest.mark.parametrize("hq,hk,int8", [(4, 4, False), (4, 2, False),
                                        (4, 2, True)])
def test_paged_chunk_attn_equals_reference(hq, hk, int8):
    """Query j of slot s attends pool positions < base + j + 1 through the
    slot's table: ragged bases (a masked row's 0, a chunk that ends at the
    table's last position), MHA and GQA 4/2, float pools and int8 pools
    with per-row scale pools; f32 within 1e-5 of the reference's."""
    rng = np.random.RandomState(3 + hq * hk + int8)
    s, c, w, bs, d, nb = 4, 3, 5, 4, 16, 24
    args = _chunk_inputs(rng, s, c, w, bs, hq, hk, d, nb,
                         [0, 7, w * bs - c, 12], int8=int8)
    scales = {}
    if int8:
        scales = {k: (rng.rand(nb, bs, hk) * 0.02 + 1e-3).astype(np.float32)
                  for k in ("ks", "vs")}
    want = ref_engine_mod._xla_paged_chunk_attn(
        *map(jnp.asarray, args),
        **{k: jnp.asarray(v) for k, v in scales.items()})
    got = port_engine_mod._paged_chunk_attn(
        *map(torch.from_numpy, args),
        **{k: torch.from_numpy(v) for k, v in scales.items()})
    assert got.shape == (s, c, hq, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_chunk_math_equals_reference(models, kv_dtype):
    """The verify forward: 3 slots (one masked) write a 3-token chunk each
    at their own lengths into a pool already holding random rows, and
    attend their prefixes. Logits within 1e-5 of the reference's and
    every pool row equal after the writes (the masked row's go to the
    scratch block; int8 codes and scales written row by row)."""
    ref_t, _ = models["ref"]
    port_t, _ = models["port"]
    cfg = ref_t.config
    rng = np.random.RandomState(17)
    nb, bs, w, c = 12, 4, 3, 3
    hk, d, n_layers = cfg.num_key_value_heads, cfg.head_dim, \
        cfg.num_hidden_layers
    shape = (nb, bs, hk, d)
    if kv_dtype:
        kc = [rng.randint(-127, 128, shape).astype(np.int8)
              for _ in range(n_layers)]
        vc = [rng.randint(-127, 128, shape).astype(np.int8)
              for _ in range(n_layers)]
        ks = [(rng.rand(nb, bs, hk) * 0.05 + 1e-3).astype(np.float32)
              for _ in range(n_layers)]
        vs = [(rng.rand(nb, bs, hk) * 0.05 + 1e-3).astype(np.float32)
              for _ in range(n_layers)]
    else:
        kc = [rng.randn(*shape).astype(np.float32) for _ in range(n_layers)]
        vc = [rng.randn(*shape).astype(np.float32) for _ in range(n_layers)]
        ks = vs = []
    ids = rng.randint(1, cfg.vocab_size, (3, c)).astype(np.int32)
    seq_lens = np.asarray([5, 2, 7], np.int32)
    tables = np.asarray([[3, 4, 5], [6, 7, 8], [9, 10, 11]], np.int32)
    live = np.asarray([True, False, True])
    ref_logits, r_kc, r_vc, r_ks, r_vs = ref_engine_mod.paged_chunk_math(
        ref_t, 0, paddle.to_tensor(ids), jnp.asarray(seq_lens),
        jnp.asarray(tables), [jnp.asarray(x) for x in kc],
        [jnp.asarray(x) for x in vc], jnp.asarray(live),
        ks=tuple(jnp.asarray(x) for x in ks),
        vs=tuple(jnp.asarray(x) for x in vs))
    p_kc, p_vc, p_ks, p_vs = ([torch.from_numpy(x.copy()) for x in xs]
                              for xs in (kc, vc, ks, vs))
    ptrs = [t.data_ptr() for t in p_kc + p_vc + p_ks + p_vs]
    with torch.inference_mode():
        logits = port_engine_mod.paged_chunk_math(
            port_t, 0, torch.from_numpy(ids), torch.from_numpy(seq_lens),
            torch.from_numpy(tables), p_kc, p_vc, torch.from_numpy(live),
            p_ks, p_vs)
    assert logits.shape == (3, c, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               rtol=1e-5, atol=1e-5)
    assert [t.data_ptr() for t in p_kc + p_vc + p_ks + p_vs] == ptrs
    for got, want in ((p_kc, r_kc), (p_vc, r_vc), (p_ks, r_ks),
                      (p_vs, r_vs)):
        assert len(got) == len(want)
        for g, r in zip(got, want):
            g, r = g.numpy(), np.asarray(r)
            if g.dtype == np.int8:
                np.testing.assert_array_equal(g[1:], r[1:])
            else:
                np.testing.assert_allclose(g[1:], r[1:], rtol=1e-5,
                                           atol=1e-5)
    # the live rows' chunk positions were written, the pools elsewhere
    # (but the scratch block 0) kept their rows
    written = {(tables[s, p // bs], p % bs) for s in (0, 2)
               for p in range(seq_lens[s], seq_lens[s] + c)}
    for b in range(1, nb):
        for o in range(bs):
            if (b, o) not in written:
                np.testing.assert_array_equal(p_kc[0][b, o].numpy(),
                                              kc[0][b, o])


# ------------------------------------------------ engines: greedy
def _ragged_eos_prompts(vocab):
    rng = np.random.RandomState(1)
    probe = rng.randint(1, vocab, 6).astype(np.int32)
    return [probe, rng.randint(1, vocab, 4).astype(np.int32),
            rng.randint(1, vocab, 8).astype(np.int32)]


def _oracle_row(model, prompt, max_new, eos_token_id=None):
    """The port's sequential greedy decode of one request, truncated at
    eos (the engine retires the slot there)."""
    out = generation.generate_on_device(
        model, torch.from_numpy(prompt[None, :].astype(np.int64)),
        max_new_tokens=max_new, eos_token_id=eos_token_id)
    gen = out[0, prompt.shape[0]:].numpy()
    if eos_token_id is not None:
        hits = np.nonzero(gen == eos_token_id)[0]
        if hits.size:
            gen = gen[:hits[0] + 1]
    return gen.tolist()


SPEC_KW = dict(spec_gamma=2, num_slots=2, block_size=4, prefill_chunk=3)


@pytest.fixture(scope="module")
def ragged_eos(models):
    """tests/test_serving.py::test_spec_engine_greedy_oracle_ragged_eos on
    both engines: 3 ragged requests over 2 slots, the 4th greedy token of
    the first prompt as eos, γ = 2, an independent draft."""
    ref_t, ref_d = models["ref"]
    port_t, port_d = models["port"]
    prompts = _ragged_eos_prompts(ref_t.config.vocab_size)
    eos = _oracle_row(port_t, prompts[0], 10)[3]
    out = {"prompts": prompts, "eos": eos}
    for side, (t, d) in (("ref", (ref_t, ref_d)), ("port", (port_t, port_d))):
        eng = _engine(t, ref=side == "ref", spec_draft=d, eos_token_id=eos,
                      **SPEC_KW)
        reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
        ptrs = None if side == "ref" else eng._pool_ptrs()
        assert len(eng.run()) == len(reqs)
        assert side == "ref" or eng._pool_ptrs() == ptrs
        out[side] = (eng, _result(eng, reqs))
    return out


def test_greedy_ragged_eos_equals_reference(ragged_eos):
    """Streams, finish reasons, every counter and both pools' statistics
    equal the reference engine's; both pools drain to their scratch
    block."""
    got, want = ragged_eos["port"][1], ragged_eos["ref"][1]
    _equal_results(got, want)
    assert got["reasons"][0] == "eos"
    assert got["counters"]["spec_rounds"] > 0
    assert got["counters"]["spec_proposed"] >= \
        got["counters"]["spec_accepted"] >= 0
    assert got["pool"]["blocks_in_use"] == 1
    assert got["draft_pool"]["blocks_in_use"] == 1


def test_greedy_ragged_eos_equals_sequential_oracle(models, ragged_eos):
    """Exact by construction: an independent draft leaves every stream
    equal to the target's own sequential greedy decode."""
    port_t, _ = models["port"]
    streams = ragged_eos["port"][1]["streams"]
    for prompt, stream in zip(ragged_eos["prompts"], streams):
        assert stream == _oracle_row(port_t, prompt, 10,
                                     eos_token_id=ragged_eos["eos"])


def test_draft_equal_to_target_accepts_everything_greedy(models,
                                                        ragged_eos):
    """With the target as its own draft every proposal is accepted and
    the streams stay the sequential oracle's; the engine's staging and
    state buffers carry the draft's tables and the (S, γ+1) stream."""
    port_t, _ = models["port"]
    eng = _engine(port_t, spec_draft=port_t, eos_token_id=ragged_eos["eos"],
                  **SPEC_KW)
    reqs = [eng.submit(p, max_new_tokens=10) for p in ragged_eos["prompts"]]
    eng.run()
    got = _result(eng, reqs)
    assert got["streams"] == ragged_eos["port"][1]["streams"]
    st = eng.engine_stats()
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert st["spec_acceptance_rate"] == 1.0
    assert eng._state.dev["stream"].shape == (2, 3)
    assert "d_tables" in eng._staged and "toks" not in eng._state.dev


# ------------------------------------------------ the rejection sampler
_TRIALS = 20000


def _synthetic_p(rng, v=8):
    p = rng.dirichlet(np.ones(v)).astype(np.float32)
    return p / p.sum()


@pytest.mark.parametrize("same", [False, True])
def test_rejection_sampler_is_exact_in_distribution(same):
    """Proposals drawn from q; the emitted first token (the proposal if
    accepted, else the residual draw) must follow p: each token's
    frequency within 4 sigma of p over 20,000 seeded trials, vectorised.
    With q = p every proposal is accepted."""
    rng = np.random.RandomState(21 + same)
    v, g = 8, 2
    p = _synthetic_p(rng, v)
    q = p.copy() if same else _synthetic_p(rng, v)
    n = _TRIALS
    pt = torch.from_numpy(np.broadcast_to(p, (n, g, v)).copy())
    qt = torch.from_numpy(np.broadcast_to(q, (n, g, v)).copy())
    props = torch.from_numpy(rng.choice(v, size=(n, g), p=q.astype(
        np.float64) / q.sum()).astype(np.int64))
    seeds = torch.arange(n, dtype=torch.int64)
    u = (keyed_bits(seeds, torch.zeros(n, dtype=torch.int64), g)
         >> 8).float() * 2.0 ** -24
    bits = keyed_bits(seeds.repeat_interleave(g),
                      torch.arange(g).repeat(n) + 1, v).reshape(n, g, v)
    a, res = rejection_sample(pt, qt, props, u, bits)
    emitted = torch.where(a > 0, props[:, 0], res[:, 0]).numpy()
    freq = np.bincount(emitted, minlength=v) / n
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(freq - p) <= 4 * sigma + 1e-12), (freq, p)
    assert 0.0 <= float(u.min()) and float(u.max()) < 1.0
    if same:
        assert bool((a == g).all())
    else:
        rate = float((a > 0).float().mean())
        want = float(np.minimum(p, q).sum())      # P(accept) = Σ min(p, q)
        assert abs(rate - want) <= 4 * np.sqrt(want * (1 - want) / n)


# ------------------------------------------------ engines: sampling
SAMPLING_KW = dict(num_slots=2, block_size=4, prefill_chunk=4,
                   decode_strategy="sampling", top_k=8, temperature=0.9)


def test_sampling_with_target_as_draft_replays_plain_engine(models):
    """tests/test_serving.py::test_spec_engine_sampling_parity_fixed_seeds
    on the port: q == p (up to the verify's rounding), every proposal
    accepted, and each proposal and bonus token drawn on the plain
    engine's key, so the streams equal the port's plain sampling
    engine's."""
    port_t, _ = models["port"]
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in (5, 7, 3)]
    plain = _engine(port_t, decode_quantum=3, **SAMPLING_KW)
    want = [plain.submit(p, max_new_tokens=5, seed=i)
            for i, p in enumerate(prompts)]
    plain.run()
    spec = _engine(port_t, spec_draft=port_t, spec_gamma=2, **SAMPLING_KW)
    got = [spec.submit(p, max_new_tokens=5, seed=i)
           for i, p in enumerate(prompts)]
    spec.run()
    assert [r.tokens for r in got] == [r.tokens for r in want]
    st = spec.engine_stats()
    assert st["spec_proposed"] > 0
    assert st["spec_accepted"] == st["spec_proposed"]


def test_sampling_with_independent_draft_is_seeded(models):
    """An independent draft: a fixed-seed speculative sampling run
    repeats itself, rejections happen, and every token is in range."""
    port_t, port_d = models["port"]
    rng = np.random.RandomState(4)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in (5, 7)]
    runs = []
    for _ in range(2):
        eng = _engine(port_t, spec_draft=port_d, spec_gamma=3,
                      **SAMPLING_KW)
        reqs = [eng.submit(p, max_new_tokens=8, seed=7 + i)
                for i, p in enumerate(prompts)]
        eng.run()
        runs.append([r.tokens for r in reqs])
        st = eng.engine_stats()
    assert runs[0] == runs[1]
    assert all(len(t) == 8 and all(0 <= x < 128 for x in t)
               for t in runs[0])
    assert st["spec_accepted"] < st["spec_proposed"]


# ------------------------------------------------ prefix cache, int8, K
def _shared_prompts(vocab):
    """tests/test_prefix_cache.py's trace: an 8-token system prompt and
    unique tails, then the bare system prompt (its fully cached chain
    re-prefills its last token into a shared block: a copy-on-write in
    both pools)."""
    rng = np.random.RandomState(3)
    sys_p = rng.randint(1, vocab, 8).astype(np.int32)
    tails = [rng.randint(1, vocab, n).astype(np.int32) for n in (3, 5, 1)]
    return [np.concatenate([sys_p, t]) for t in tails] + [sys_p.copy()]


_PREFIX_KW = dict(spec_gamma=2, num_slots=2, block_size=4, prefill_chunk=4)


def _submit(eng, prompts, max_new):
    return [eng.submit(p, max_new_tokens=mn, req_id=f"r{i}")
            for i, (p, mn) in enumerate(zip(prompts, max_new))]


def test_prefix_cache_equals_reference_and_unshared(models):
    """With the prefix cache on, the draft pool attaches, publishes and
    copies in lockstep: streams equal the unshared speculative engine's,
    and streams, counters and both pools' fragmentation and prefix
    statistics equal the reference's. No pool tensor moves."""
    ref_t, ref_d = models["ref"]
    port_t, port_d = models["port"]
    prompts = _shared_prompts(ref_t.config.vocab_size)
    max_new = [5, 4, 6, 4]
    runs = {}
    for name, t, d, ref, prefix in (("ref", ref_t, ref_d, True, True),
                                    ("port", port_t, port_d, False, True),
                                    ("unshared", port_t, port_d, False,
                                     False)):
        eng = _engine(t, ref=ref, spec_draft=d, prefix_cache=prefix,
                      **_PREFIX_KW)
        reqs = _submit(eng, prompts, max_new)
        ptrs = None if ref else eng._pool_ptrs()
        eng.run()
        assert ref or eng._pool_ptrs() == ptrs
        runs[name] = _result(eng, reqs)
    _equal_results(runs["port"], runs["ref"])
    assert runs["port"]["streams"] == runs["unshared"]["streams"]
    for key in ("prefix", "draft_prefix"):
        assert runs["port"][key]["hits"] > 0
        assert runs["port"][key]["cow_copies"] >= 1
    assert runs["port"]["prefix"] == runs["port"]["draft_prefix"]


def test_int8_weights_and_kv_equal_reference(models):
    """``quantize="weight_only_int8", kv_dtype="int8"`` sweeps both
    models and makes both pools int8 with scale pools; the greedy streams,
    counters and pool statistics equal the reference's int8 speculative
    engine."""
    t_arr, d_arr = models["arrays"]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in (5, 9, 3)]
    max_new = [6, 5, 7]
    kw = dict(SPEC_KW, quantize="weight_only_int8", kv_dtype="int8")
    runs = {}
    for name, t, d, ref in (("ref", _ref_target(), _ref_draft(), True),
                            ("port", _port(t_arr), _port(d_arr, 1), False)):
        eng = _engine(t, ref=ref, spec_draft=d, **kw)
        reqs = _submit(eng, prompts, max_new)
        eng.run()
        runs[name] = _result(eng, reqs)
        if not ref:
            assert eng.pool.quantized and eng.d_pool.quantized
            assert eng.d_pool.k_pools[0].dtype == torch.int8
            assert len(eng.d_pool.k_scales) == 1
    _equal_results(runs["port"], runs["ref"])


def test_multi_quantum_leaves_spec_streams_unchanged(models):
    """tests/test_multiquantum.py::test_multiquantum_spec_round_ignores_k:
    a speculative engine runs one round per dispatch whatever
    ``multi_quantum`` says."""
    port_t, port_d = models["port"]
    rng = np.random.RandomState(2)
    prompts = [rng.randint(1, 128, n).astype(np.int32) for n in (4, 7, 5)]
    max_new = [7, 5, 9]
    runs = []
    for k in (1, 4):
        eng = _engine(port_t, spec_draft=port_d, spec_gamma=3,
                      multi_quantum=k, num_slots=2, block_size=4,
                      prefill_chunk=4)
        reqs = _submit(eng, prompts, max_new)
        while eng.has_work:
            assert eng._choose_k() == 1
            assert eng.step_dispatch() is None
        runs.append(_result(eng, reqs))
    _equal_results(runs[1], runs[0])


# ------------------------------------------------ the generation facades
@pytest.mark.parametrize("draft", ["independent", "target"])
def test_speculative_generate_equals_reference(models, draft):
    """The batch facade: tokens and acceptance rate equal the reference's
    ``speculative_generate``; the greedy rows equal the target's own
    decode. The target as its own draft is the full-accept path."""
    ref_t, ref_d = models["ref"]
    port_t, port_d = models["port"]
    if draft == "target":
        ref_d, port_d = ref_t, port_t
    rng = np.random.RandomState(0)
    prompts = np.stack([rng.randint(1, 128, 5).astype(np.int32)
                        for _ in range(2)])
    want, want_rate = ref_generation.speculative_generate(
        ref_t, ref_d, prompts, max_new_tokens=6, gamma=3)
    got, rate = generation.speculative_generate(
        port_t, port_d, prompts, max_new_tokens=6, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
    assert rate == pytest.approx(float(want_rate), abs=0.0)
    for i in range(2):
        assert got[i, 5:].tolist() == _oracle_row(port_t, prompts[i], 6)
    assert rate == 1.0 if draft == "target" else 0.0 <= rate < 1.0


@pytest.mark.parametrize("draft", ["independent", "target"])
def test_speculative_greedy_search_equals_reference(models, draft):
    """The host-driven batch-1 loop over contiguous caches: tokens and
    acceptance rate equal the reference's; with the target as its own
    draft every round is a full accept, which runs the extra draft
    forward."""
    ref_t, ref_d = models["ref"]
    port_t, port_d = models["port"]
    if draft == "target":
        ref_d, port_d = ref_t, port_t
    rng = np.random.RandomState(6)
    prompt = rng.randint(1, 128, (1, 6)).astype(np.int32)
    want, want_rate = ref_generation.speculative_greedy_search(
        ref_t, ref_d, prompt, max_new_tokens=9, gamma=3)
    got, rate = generation.speculative_greedy_search(
        port_t, port_d, prompt, max_new_tokens=9, gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want._value))
    assert rate == pytest.approx(want_rate, abs=0.0)
    assert got[0, 6:].tolist() == _oracle_row(port_t, prompt[0], 9)
    if draft == "target":
        assert rate == 1.0
    with pytest.raises(ValueError, match="batch 1"):
        generation.speculative_greedy_search(
            port_t, port_d, np.concatenate([prompt, prompt]), 4)


def test_refuses_a_sliding_window_draft(models):
    """The reference's refusal: rollback by the length mask cannot restore
    a rolling buffer's slots that rejected proposals wrapped over."""
    port_t, _ = models["port"]
    windowed = LlamaForCausalLM(LlamaConfig.tiny(
        tensor_parallel=False, num_hidden_layers=1, sliding_window=8),
        device="cpu")
    with pytest.raises(NotImplementedError, match="sliding-window draft"):
        _engine(port_t, spec_draft=windowed)
