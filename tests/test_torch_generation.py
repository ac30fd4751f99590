"""The slice as a whole: the port's Llama cache path and contiguous-cache
generation (paddle_tpu_torch.nlp.generation) held against paddle_tpu's on
the same carried weights (``LlamaConfig.tiny``, f32).

Greedy and beam streams must be EQUAL to the reference's (f32 on both
sides, so argmax near-ties cannot excuse a mismatch), on the plain tiny
model and on a sliding-window one whose prompt plus generation wraps its
rolling buffer. Sampled streams cannot match JAX's threefry bits: the
logits filter must match the reference (same ``-inf`` set, f32 values
``1e-6``), ``top_k=1`` sampling must equal greedy, and a fixed seed must
replay. Logits: f32 ``1e-4`` (two decoder layers summed in another order
than XLA's), cache vs full forward ``2e-5`` as the reference's own test.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import generation as RG
from paddle_tpu_torch import ops
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  load_paddle_tpu_arrays)
from paddle_tpu_torch.nlp import generation as G

WINDOW = 8


def _pair(**overrides):
    paddle.seed(0)
    ref = RefLM(RefConfig.tiny(tensor_parallel=False, **overrides))
    ref.eval()
    port = LlamaForCausalLM(
        LlamaConfig.tiny(tensor_parallel=False, **overrides), device="cpu")
    load_paddle_tpu_arrays(
        port, {k: v.numpy() for k, v in ref.state_dict().items()})
    port.eval()
    return ref, port


@pytest.fixture(scope="module")
def dense():
    return _pair()


@pytest.fixture(scope="module")
def windowed():
    return _pair(sliding_window=WINDOW)


def _ids(shape, seed=4):
    return np.random.RandomState(seed).randint(0, 128, shape)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x.numpy())


# ------------------------------------------------------- model + cache
def test_no_cache_windowed_logits_match_reference(windowed):
    ref, port = windowed
    ids = _ids((2, 20), seed=2)
    want = ref(paddle.to_tensor(ids)).numpy()
    with torch.no_grad():
        got = port(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("which", ["dense", "windowed"])
def test_cache_logits_match_full_forward_and_reference(which, request):
    """tests/test_nlp_models.py::test_llama_decode_cache_matches_full_forward
    on the port, and the cached logits against the reference's."""
    ref, port = request.getfixturevalue(which)
    rng = np.random.RandomState(0)
    ids, step = rng.randint(0, 128, (2, 24)), rng.randint(0, 128, (2, 1))
    with torch.no_grad():
        caches = port.init_caches(2, 64)
        _, caches = port(torch.from_numpy(ids), 0, caches)
        lg, caches = port(torch.from_numpy(step), 24, caches)
        full = port(torch.from_numpy(np.concatenate([ids, step], 1)))
    np.testing.assert_allclose(lg[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-5)
    rcaches = ref.init_caches(2, 64)
    _, rcaches = ref(paddle.to_tensor(ids), position_offset=0,
                     caches=rcaches)
    rlg, rcaches = ref(paddle.to_tensor(step), position_offset=24,
                       caches=rcaches)
    np.testing.assert_allclose(lg.numpy(), rlg.numpy(), rtol=1e-4, atol=1e-4)
    for (k, v), (rk, rv) in zip(caches, rcaches):
        np.testing.assert_allclose(k.numpy(), _np(rk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(v.numpy(), _np(rv), rtol=1e-5, atol=1e-5)


def test_masked_cache_paths_match_reference(dense, windowed):
    """The cache attention that is not the decode kernel: a 3-token suffix
    after a dense prefill, and single tokens over a windowed model's
    buffer LONGER than its window (the band mask over reconstructed
    absolute positions), stepped past the point where the buffer wraps."""
    rng = np.random.RandomState(1)
    ids, nxt = rng.randint(0, 128, (2, 11)), rng.randint(0, 128, (2, 3))
    ref, port = dense
    with torch.no_grad():
        caches = port.init_caches(2, 64)
        _, caches = port(torch.from_numpy(ids), 0, caches)
        lg, _ = port(torch.from_numpy(nxt), 11, caches)
    rc = ref.init_caches(2, 64)
    _, rc = ref(paddle.to_tensor(ids), position_offset=0, caches=rc)
    rlg, _ = ref(paddle.to_tensor(nxt), position_offset=11, caches=rc)
    np.testing.assert_allclose(lg.numpy(), rlg.numpy(), rtol=1e-4, atol=1e-4)

    ref, port = windowed
    shape = (2, 2 * WINDOW, 2, 16)
    caches = [(torch.zeros(shape), torch.zeros(shape)) for _ in range(2)]
    rc = [(paddle.zeros(list(shape)), paddle.zeros(list(shape)))
          for _ in range(2)]
    with torch.no_grad():
        _, caches = port(torch.from_numpy(ids), 0, caches)
    _, rc = ref(paddle.to_tensor(ids), position_offset=0, caches=rc)
    for pos in range(11, 11 + 8):
        tok = rng.randint(0, 128, (2, 1))
        with torch.no_grad():
            lg, caches = port(torch.from_numpy(tok), pos, caches)
        rlg, rc = ref(paddle.to_tensor(tok), position_offset=pos, caches=rc)
        np.testing.assert_allclose(lg.numpy(), rlg.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_cache_errors_and_window_clamp(dense, windowed):
    _, port = dense
    assert port.init_caches(2, 64)[0][0].shape == (2, 64, 2, 16)
    assert windowed[1].init_caches(2, 64)[0][0].shape[1] == WINDOW
    assert windowed[1].init_caches(1, 5)[0][0].shape[1] == 5
    with torch.no_grad(), pytest.raises(ValueError, match="KV cache length"):
        port(torch.zeros(1, 9, dtype=torch.long), 0, port.init_caches(1, 8))
    with torch.no_grad(), pytest.raises(NotImplementedError,
                                        match="chunked prefill"):
        windowed[1](torch.zeros(1, 3, dtype=torch.long), 2,
                    windowed[1].init_caches(1, 8))
    assert port.init_caches(1, 4, dtype="bfloat16")[0][0].dtype \
        == torch.bfloat16


# ------------------------------------------------------- greedy, beam
@pytest.mark.parametrize("which", ["dense", "windowed"])
def test_greedy_streams_equal_reference(which, request):
    """greedy_search and generate_on_device; on the windowed model the
    10-token prompt already exceeds the window and the buffer wraps (the
    rolling-buffer case of tests/test_incubate_inference.py)."""
    ref, port = request.getfixturevalue(which)
    ids = _ids((2, 10))
    want = RG.generate_on_device(ref, paddle.to_tensor(ids),
                                 max_new_tokens=7).numpy()
    np.testing.assert_array_equal(
        G.generate_on_device(port, ids, max_new_tokens=7).numpy(), want)
    np.testing.assert_array_equal(
        G.greedy_search(port, ids, max_new_tokens=7).numpy(),
        RG.greedy_search(ref, paddle.to_tensor(ids),
                         max_new_tokens=7).numpy())
    np.testing.assert_array_equal(
        port.generate(torch.from_numpy(ids), max_new_tokens=7).numpy(), want)


def test_generate_eos_and_pad_equal_reference(dense):
    ref, port = dense
    ids = _ids((3, 6), seed=5)
    probe = G.generate_on_device(port, ids, max_new_tokens=9).numpy()
    eos = int(probe[0, 6 + 2])                  # row 0's third new token
    for pad in (None, 0):
        want = RG.generate(ref, paddle.to_tensor(ids), max_new_tokens=9,
                           eos_token_id=eos, pad_token_id=pad).numpy()
        got = G.generate(port, ids, max_new_tokens=9, eos_token_id=eos,
                         pad_token_id=pad).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[0, 6 + 3:] == (eos if pad is None else pad)).all()
    # the host loop stops once every row's last token is eos
    want = RG.greedy_search(ref, paddle.to_tensor(ids[:1]),
                            max_new_tokens=9, eos_token_id=eos).numpy()
    got = G.greedy_search(port, ids[:1], max_new_tokens=9,
                          eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == 6 + 3


@pytest.mark.parametrize("which,nb,eos_at", [("dense", 1, None),
                                            ("dense", 4, 2),
                                            ("windowed", 4, 3)])
def test_beam_search_equals_reference(which, nb, eos_at, request):
    ref, port = request.getfixturevalue(which)
    ids = _ids((2, 10))
    eos = None
    if eos_at is not None:
        probe = G.generate_on_device(port, ids, max_new_tokens=6).numpy()
        eos = int(probe[1, 10 + eos_at])
    want, wscore = RG.beam_search(ref, paddle.to_tensor(ids),
                                  max_new_tokens=6, num_beams=nb,
                                  length_penalty=0.8, eos_token_id=eos)
    got, score = G.beam_search(port, ids, max_new_tokens=6, num_beams=nb,
                               length_penalty=0.8, eos_token_id=eos)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_allclose(score.numpy(), wscore.numpy(), rtol=1e-4,
                               atol=1e-4)
    if nb == 4:
        facade = G.generate(port, ids, max_new_tokens=6,
                            decode_strategy="beam_search", num_beams=nb,
                            length_penalty=0.8, eos_token_id=eos)
        np.testing.assert_array_equal(facade.numpy(), want.numpy())


# ------------------------------------------------------- sampling
@pytest.mark.parametrize("top_k,top_p,temperature", [
    (0, 1.0, 1.0), (5, 1.0, 1.0), (0, 0.8, 1.0), (0, 1.0, 0.7),
    (10, 0.5, 1.3), (0, 0.3, 0.0), (200, 0.95, 2.0), (None, None, None),
])
def test_filter_logits_matches_reference(top_k, top_p, temperature):
    rng = np.random.RandomState(11)
    logits = (rng.randn(4, 128) * 3).astype("f4")
    want = np.asarray(RG._filter_logits(jnp.asarray(logits), top_k, top_p,
                                         temperature))
    got = G._filter_logits(torch.from_numpy(logits), top_k, top_p,
                           temperature).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    keep = ~np.isinf(want)
    assert keep.sum(-1).min() >= 1
    np.testing.assert_allclose(got[keep], want[keep], rtol=1e-6, atol=1e-6)


def test_top_k_1_sampling_equals_greedy(dense, windowed):
    for _, port in (dense, windowed):
        ids = _ids((2, 10))
        greedy = G.generate_on_device(port, ids, max_new_tokens=8)
        for seed in (0, 3):
            sampled = G.generate(port, ids, max_new_tokens=8,
                                 decode_strategy="sampling", top_k=1,
                                 seed=seed)
            assert torch.equal(sampled, greedy)


def test_sampling_is_seeded(dense):
    _, port = dense
    ids = _ids((2, 6))
    kw = dict(max_new_tokens=10, top_k=20, top_p=0.9, temperature=1.5)
    a = G.sampling_search(port, ids, seed=1, **kw)
    assert torch.equal(a, G.sampling_search(port, ids, seed=1, **kw))
    assert not torch.equal(a, G.sampling_search(port, ids, seed=2, **kw))
    assert not torch.equal(a, G.generate_on_device(port, ids,
                                                   max_new_tokens=10))
    # each draw depends only on (row seed, step): rows do not share noise
    assert G.fold_seed(1, 0) != G.fold_seed(1, 1) != G.fold_seed(2, 0)
    filt = torch.zeros(2000, 50)
    draws = G.keyed_gumbel_argmax(filt, torch.full((2000,), 7),
                                  torch.arange(2000))
    counts = torch.bincount(draws, minlength=50)
    assert counts.min() > 10          # uniform logits: every token drawn


def _np_mix32(x):
    for shift, mul in ((16, 0x7FEB352D), (15, 0x5BD1E995)):
        x = x ^ (x >> np.uint64(shift))
        x = (x * np.uint64(mul)) & np.uint64(0xFFFFFFFF)
    return x ^ (x >> np.uint64(16))


def test_keyed_draw_hash_pinned_against_numpy():
    """The keyed draw's integer hash, rebuilt in numpy on unsigned 64-bit
    lanes, gives the same bits as the port's int64 torch version (which
    the card computes with the same integer ops), for seeds past 2**32,
    negative seeds and a 0-d step; the draw's u lies in (0, 1)."""
    seeds = np.array([0, 7, 2 ** 40 + 3, -5, G.fold_seed(3, 1)], np.int64)
    steps = np.array([0, 1, 123456, 2 ** 31 + 9, 5], np.int64)
    vocab = 300
    m32 = np.uint64(0xFFFFFFFF)
    su = seeds.astype(np.uint64)
    row = _np_mix32((su & m32) ^ np.uint64(0x3C6EF372))
    row = _np_mix32(row ^ ((su >> np.uint64(32)) & m32))
    row = _np_mix32(row ^ (steps.astype(np.uint64) & m32))
    tok = _np_mix32(np.arange(vocab, dtype=np.uint64))
    want = _np_mix32(row[:, None] ^ tok[None, :])
    got = G.keyed_bits(torch.from_numpy(seeds), torch.from_numpy(steps),
                       vocab)
    np.testing.assert_array_equal(got.numpy().astype(np.uint64), want)
    assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32
    one = G.keyed_bits(torch.from_numpy(seeds), torch.tensor(5), vocab)
    np.testing.assert_array_equal(one[4].numpy(), got[4].numpy())
    # distinct keys draw distinct noise; uniform logits spread the draws
    assert len({tuple(r) for r in got[:, :16].tolist()}) == len(seeds)


def test_keyed_noise_is_finite_at_the_extreme_hashes(monkeypatch):
    """The noise of the largest hash is finite (in f32, u of the top 24
    bits would round to 1.0 and its noise to +inf), the noise rises with
    the hash across its whole range, and a token the filter cut is never
    drawn, even where every cut token carries the largest hash and the
    kept one the smallest."""
    bits = torch.tensor([0, 1, 255, 256, 2 ** 31, 2 ** 32 - 257,
                         2 ** 32 - 256, 2 ** 32 - 1], dtype=torch.int64)
    noise = G.gumbel_noise(bits)
    assert noise.dtype == torch.float32
    assert bool(torch.isfinite(noise).all())
    assert -2.9 < float(noise[0]) < -2.8 and 17.3 < float(noise[-1]) < 17.4
    assert bool((noise[1:] >= noise[:-1]).all())
    assert float(noise[-3]) < float(noise[-2])
    vocab, kept = 64, 5
    top = torch.full((3, vocab), 2 ** 32 - 1, dtype=torch.int64)
    top[:, kept] = 0
    monkeypatch.setattr(G, "keyed_bits", lambda seeds, steps, v: top)
    filt = torch.full((3, vocab), -torch.inf)
    filt[:, kept] = -50.0
    draws = G.keyed_gumbel_argmax(filt, torch.zeros(3, dtype=torch.int64),
                                  torch.tensor(0))
    assert draws.tolist() == [kept] * 3


@pytest.mark.parametrize("which", ["dense", "windowed"])
def test_decode_steps_are_kept_per_key_and_restaged(which, request,
                                                    monkeypatch):
    """generate keeps one decode step per model with its buffers and
    reuses it while the key holds: calls on other prompts of the same
    shape, rows that hit eos in the call before, and sampling with other
    seeds give what fresh buffers give (the windowed model well past its
    window); a new strategy or shape makes a new one."""
    _, port = request.getfixturevalue(which)
    a, b = _ids((2, 6), seed=4), _ids((2, 6), seed=9)
    new = 2 * WINDOW + 3
    eos = int(G.generate_on_device(port, a, max_new_tokens=new)[0, 9])
    calls = [dict(input_ids=a, eos_token_id=eos),
             dict(input_ids=b, eos_token_id=eos),
             dict(input_ids=a, eos_token_id=eos),
             dict(input_ids=b, decode_strategy="sampling", top_k=20,
                  seed=1),
             dict(input_ids=a, decode_strategy="sampling", top_k=20,
                  seed=2),
             dict(input_ids=_ids((3, 5)), eos_token_id=eos)]
    got, kept = [], []
    for kw in calls:
        got.append(G.generate(port, max_new_tokens=new, **kw))
        kept.append(G._STEPS[port])
    assert kept[0] is kept[1] is kept[2]
    assert kept[3] is kept[4] and kept[3] is not kept[2]
    assert kept[5] is not kept[4]
    monkeypatch.setattr(G, "_EAGER", True)
    for kw, out in zip(calls, got):
        assert torch.equal(out, G.generate(port, max_new_tokens=new, **kw))
    assert (got[0][0, 6 + 10:] == eos).all()    # row 0 hit eos, padded


@pytest.mark.parametrize("which", ["dense", "windowed"])
def test_tensor_position_decode_equals_int_position(which, request):
    """The decode step with its position as a 0-d int32 tensor (what the
    captured graph reads) gives the int position's logits and caches bit
    for bit, on the dense model and on the windowed one well past its
    window (the rolling buffer wraps twice)."""
    _, port = request.getfixturevalue(which)
    ids = torch.from_numpy(_ids((2, 6)))
    total = 6 + 3 * WINDOW
    runs = []
    for as_tensor in (False, True):
        caches = port.init_caches(2, total)
        with torch.no_grad():
            logits, caches = port(ids, 0, caches)
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
            seen = []
            for pos in range(6, total):
                at = torch.tensor(pos, dtype=torch.int32) if as_tensor \
                    else pos
                logits, caches = port(tok, at, caches)
                seen.append(logits)
                tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        runs.append((torch.stack(seen), caches))
    (a, ca), (b, cb) = runs
    assert torch.equal(a, b)
    for (k1, v1), (k2, v2) in zip(ca, cb):
        assert torch.equal(k1, k2) and torch.equal(v1, v2)


def test_generate_facade_refuses_mixed_knobs(dense):
    _, port = dense
    ids = _ids((1, 4))
    with pytest.raises(TypeError, match="unsupported kwargs"):
        G.generate(port, ids, max_new_tokens=2, bogus=1)
    with pytest.raises(ValueError, match="greedy"):
        G.generate(port, ids, max_new_tokens=2, top_k=5)
    with pytest.raises(ValueError, match="beam_search"):
        G.generate(port, ids, max_new_tokens=2, decode_strategy="sampling",
                   num_beams=2)
    with pytest.raises(ValueError, match="sampling"):
        G.generate(port, ids, max_new_tokens=2,
                   decode_strategy="beam_search", temperature=0.5)
    with pytest.raises(ValueError, match="decode_strategy"):
        G.generate(port, ids, max_new_tokens=2, decode_strategy="nucleus")


def test_generate_launches_only_plain_versions_on_the_cpu(windowed):
    """On CPU tensors every wrapper runs its plain version: no kernel
    launch is counted (the card's counts are chip_smoke.py's)."""
    _, port = windowed
    ops.reset_launches()
    G.generate(port, _ids((1, 10)), max_new_tokens=3)
    assert all(n == 0 for n in ops.LAUNCHES.values())
