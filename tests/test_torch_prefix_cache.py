"""The prefix cache and copy-on-write of the port's paged KV pool and
serving engine, held against paddle_tpu's on the same operations and
inputs (seeded with numpy).

Pool: the chain key (``prompt_prefix_key``), verified lookups under a
forced hash collision, copy-on-write at the device rows (K, V and an int8
pool's scale rows, every pool tensor keeping its address), LRU leaf-first
eviction that never takes a live holder, reclaim under allocation
pressure, the refcount-aware statistics, and a 100-round seeded ragged
churn replayed on both pools with tables, lengths, refcounts, free list,
index, statistics and pool rows equal after every round.

Engine: tests/test_prefix_cache.py's traces (shared system prompt with a
bare-prompt request, novel-demand admission, a preempted sharer),
``multi_quantum=4`` and int8 KV pools with the cache on: greedy streams,
finish reasons, counters and ``prefix_cache_stats()`` equal to the
reference engine's (``LlamaConfig.tiny``, f32, carried weights). Against
the port itself: fixed-seed sampling, ``step_dispatch`` /
``step_collect`` and ``attn_impl="fused"``.

Everything is integer bookkeeping or f32 streams on the same plain
kernels, so the tolerance is exact equality throughout.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import LlamaConfig as RefConfig
from paddle_tpu.nlp import LlamaForCausalLM as RefLM
from paddle_tpu.nlp import PagedKVCachePool as RefPool
from paddle_tpu.nlp import paged_cache as ref_paged_cache
from paddle_tpu.serving import ServingEngine as RefEngine
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  PagedKVCachePool, load_paddle_tpu_arrays)
from paddle_tpu_torch.nlp import paged_cache as port_paged_cache
from paddle_tpu_torch.serving import ServingEngine, prompt_prefix_key

_COUNTERS = ("steps", "mixed_steps", "decode_quanta", "quantum_tokens",
             "prefill_tokens", "generated_tokens", "admitted", "finished",
             "preempted", "resumed")


# ---------------------------------------------------------------- pools
def _pools(num_blocks=8, bs=4, hk=2, d=8, kv_dtype=None, layers=2):
    ref = RefPool(num_blocks, bs, hk, d, num_layers=layers,
                  dtype=jnp.float32, prefix_cache=True, kv_dtype=kv_dtype)
    port = PagedKVCachePool(num_blocks, bs, hk, d, num_layers=layers,
                            dtype=torch.float32, prefix_cache=True,
                            kv_dtype=kv_dtype, device="cpu")
    return ref, port


_TENSORS = ("k_pools", "v_pools", "k_scales", "v_scales")


def _ptrs(port):
    return [t.data_ptr() for name in _TENSORS for t in getattr(port, name)]


def _write_rows(ref, port, seq_id, start, end, tag):
    """Write positions ``[start, end)`` of ``seq_id`` in both pools, as a
    forward would: distinct values per (tag, position, element), int8
    codes and scales on an int8 pool."""
    table = port._tables[seq_id]
    assert table == ref._tables[seq_id]
    if end <= start:
        return
    bs = port.block_size
    pos = np.arange(start, end)
    blks = np.asarray([table[p // bs] for p in pos])
    offs = pos % bs
    for li, name in enumerate(_TENSORS):
        for i, t in enumerate(getattr(port, name)):
            shape = (len(pos),) + tuple(t.shape[2:])
            base = (tag * 7919 + pos * 131 + li * 17 + i)[
                (...,) + (None,) * (len(shape) - 1)]
            fill = base + np.arange(int(np.prod(shape[1:]))).reshape(
                shape[1:])
            if t.dtype == torch.int8:
                vals = (fill % 255 - 127).astype(np.int8)
            else:
                vals = (fill % 1000).astype(np.float32) / 8.0
            t[torch.from_numpy(blks), torch.from_numpy(offs)] = \
                torch.from_numpy(vals)
            ref_list = getattr(ref, name)
            ref_list[i] = ref_list[i].at[blks, offs].set(vals)


def _rows_equal(ref, port):
    for name in _TENSORS:
        for a, b in zip(getattr(ref, name), getattr(port, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _index(pool):
    return sorted(
        (b, e.hash, e.tokens, None if e.parent is None else e.parent.block,
         e.nchildren, e.tick) for b, e in pool._cached_blocks.items())


def _audit(pool):
    """tests/test_prefix_cache.py's refcount oracle: every block's
    refcount is its holder count (tables mapping it + the index's hold),
    and the free list and the held set partition the pool."""
    expect = {}
    for table in pool._tables.values():
        for b in table:
            expect[b] = expect.get(b, 0) + 1
    for b in pool._cached_blocks:
        expect[b] = expect.get(b, 0) + 1
    assert expect == pool._refcounts
    assert len(pool._free) + len(expect) == pool.num_blocks
    assert not (set(pool._free) & set(expect))
    st = pool.fragmentation_stats()
    assert 0.0 <= st["utilization"] <= 1.0
    assert st["blocks_in_use"] == len(expect)


def _same(ref, port):
    assert port._tables == ref._tables
    assert port._lens == ref._lens
    assert port._refcounts == ref._refcounts
    assert port._free == ref._free
    assert _index(port) == _index(ref)
    assert port.prefix_cache_stats() == ref.prefix_cache_stats()
    assert port.fragmentation_stats() == ref.fragmentation_stats()
    assert port.bytes_in_use() == ref.bytes_in_use()
    _audit(ref)
    _audit(port)


def _both(ref, port, name, *args, **kw):
    """Call ``name`` on both pools: equal results, or both raise the same
    RuntimeError (re-raised)."""
    out = []
    for pool in (ref, port):
        try:
            res = getattr(pool, name)(*args, **kw)
            out.append(("ok", np.asarray(res).tolist()
                        if res is not None else None))
        except RuntimeError as exc:
            out.append(("raise", str(exc)))
    assert out[0] == out[1], (name, args, out)
    if out[0][0] == "raise":
        raise RuntimeError(out[0][1])
    return out[0][1]


def test_prompt_prefix_key_equals_reference():
    """The chain key over seeded prompts of 0-40 tokens, block sizes 1, 4
    and 32, walks capped at None / 1 / 3 blocks."""
    rng = np.random.RandomState(0)
    seen = 0
    for n in range(41):
        toks = rng.randint(0, 50000, n).astype(np.int32)
        for bs in (1, 4, 32):
            for mb in (None, 1, 3):
                want = ref_paged_cache.prompt_prefix_key(toks, bs, mb)
                got = prompt_prefix_key(toks, bs, mb)
                assert got == want, (n, bs, mb)
                seen += got is not None
    assert seen > 0
    with pytest.raises(ValueError, match="block_size"):
        prompt_prefix_key([1, 2], 0)
    # the pool's index stores the same key for the prompt's last full block
    ref, port = _pools(num_blocks=16, bs=4)
    toks = rng.randint(0, 50000, 14).astype(np.int32)
    _both(ref, port, "ensure", "a", 14)
    assert _both(ref, port, "publish_prefix", "a", toks) == 3
    leaf = port._match_entries(toks)[-1]
    assert leaf.hash == prompt_prefix_key(toks, 4)
    _same(ref, port)


def test_chain_depth_is_part_of_the_key():
    ref, port = _pools(num_blocks=8, bs=4)
    rep = np.array([7, 7, 7, 7] * 2, np.int32)
    _both(ref, port, "ensure", "a", 8)
    assert _both(ref, port, "publish_prefix", "a", rep) == 2
    e0, e1 = port._match_entries(rep)
    assert e0.block != e1.block and e0.hash != e1.hash
    assert e1.parent is e0
    for toks, want in (([7, 7, 7, 7, 1, 2, 3, 4], 4),
                       ([9, 9, 9, 9, 7, 7, 7, 7], 0)):
        toks = np.asarray(toks, np.int32)
        assert _both(ref, port, "match_prefix", toks) == want
    _same(ref, port)


def test_forced_hash_collision_never_aliases(monkeypatch):
    """Every block keys to one bucket in both modules: lookups still alias
    only verified chains (parent entry + token tuple)."""
    for mod in (ref_paged_cache, port_paged_cache):
        monkeypatch.setattr(mod, "_chain_hash", lambda parent, tokens: 7)
    ref, port = _pools(num_blocks=12, bs=4)
    p1 = np.arange(8, dtype=np.int32)
    p2 = np.arange(8, 16, dtype=np.int32)
    for sid, toks in (("a", p1), ("b", p2)):
        _both(ref, port, "ensure", sid, 8)
        assert _both(ref, port, "publish_prefix", sid, toks) == 2
    assert len(port._prefix_buckets) == 1
    assert _both(ref, port, "attach_prefix", "c", p2) == 8
    assert port._tables["c"] == port._tables["b"] != port._tables["a"]
    assert _both(ref, port, "attach_prefix", "d",
                 np.full(8, 99, np.int32)) == 0
    _same(ref, port)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_cow_isolates_writers_at_device_rows(kv_dtype):
    """A write into a shared block lands in a fresh copy made in place:
    the copy's rows (scale rows included on an int8 pool) equal the
    source's, a write through the writer's table leaves the sharer's rows
    unchanged, no pool tensor moves, and both pools agree throughout."""
    ref, port = _pools(num_blocks=8, bs=4, kv_dtype=kv_dtype)
    ptrs = _ptrs(port)
    toks = np.arange(8, dtype=np.int32)
    _both(ref, port, "ensure", "a", 8)
    _write_rows(ref, port, "a", 0, 8, tag=1)
    _both(ref, port, "publish_prefix", "a", toks)
    assert _both(ref, port, "attach_prefix", "b", toks) == 8
    shared = list(port._tables["b"])
    assert shared == port._tables["a"]
    tensors = [t for name in _TENSORS for t in getattr(port, name)]
    assert len(tensors) == (8 if kv_dtype else 4)
    before = [t[shared[1]].clone() for t in tensors]
    assert _both(ref, port, "make_writable", "b", 4, 8) == 1
    assert port._tables["b"][0] == shared[0]
    fresh = port._tables["b"][1]
    assert fresh != shared[1]
    for t, b in zip(tensors, before):
        assert torch.equal(t[fresh], b)
        assert torch.equal(t[shared[1]], b)
    _rows_equal(ref, port)
    _write_rows(ref, port, "b", 4, 8, tag=2)
    for t, b in zip(tensors, before):
        assert torch.equal(t[shared[1]], b)
        assert not torch.equal(t[fresh], b)
    _rows_equal(ref, port)
    assert _ptrs(port) == ptrs
    assert port._refcounts[shared[1]] == 2 and port._refcounts[fresh] == 1
    assert _both(ref, port, "make_writable", "b", 4, 8) == 0
    assert port.cow_copies == 1
    # the decode dispatch's form: grow and copy in one call
    assert _both(ref, port, "attach_prefix", "c", toks) == 8
    row = _both(ref, port, "grow_decode_table", "c", 10, 7, pad_to=4,
                cow=True)
    assert row[:3] == port._tables["c"] and len(row) == 4
    assert port.cow_copies == 2
    _rows_equal(ref, port)
    assert _ptrs(port) == ptrs
    _same(ref, port)


def test_eviction_respects_refcounts_lru_leaf_first():
    ref, port = _pools(num_blocks=8, bs=4)
    old = np.arange(8, dtype=np.int32)
    new = np.arange(100, 108, dtype=np.int32)
    for sid, toks in (("a", old), ("b", new)):
        _both(ref, port, "ensure", sid, 8)
        _both(ref, port, "publish_prefix", sid, toks)
    assert port.evictable_prefix_blocks() == 0
    assert _both(ref, port, "evict_prefix", 8) == 0
    _both(ref, port, "free", "a")
    _both(ref, port, "free", "b")
    assert port.evictable_prefix_blocks() == 4
    # the old chain's leaf goes first; its parent stays walkable
    assert _both(ref, port, "evict_prefix", 1) == 1
    assert port.match_prefix(old) == 4 and port.match_prefix(new) == 8
    _both(ref, port, "attach_prefix", "c", new)
    assert _both(ref, port, "evict_prefix", 8) == 1
    assert port.cached_blocks == 2
    _same(ref, port)


def test_allocation_pressure_reclaims_cached_only_blocks():
    ref, port = _pools(num_blocks=4, bs=4)
    toks = np.arange(8, dtype=np.int32)
    _both(ref, port, "ensure", "a", 8)
    _both(ref, port, "publish_prefix", "a", toks)
    _both(ref, port, "free", "a")
    assert _both(ref, port, "can_allocate", 16)
    _both(ref, port, "ensure", "big", 16)
    assert port.cached_blocks == 0 and port.prefix_evictions == 2
    with pytest.raises(RuntimeError, match="exhausted"):
        _both(ref, port, "ensure", "more", 4)
    _same(ref, port)


def test_clear_prefix_cache_releases_every_hold():
    ref, port = _pools(num_blocks=8, bs=4)
    toks = np.arange(12, dtype=np.int32)
    _both(ref, port, "ensure", "a", 12)
    _both(ref, port, "publish_prefix", "a", toks)
    _both(ref, port, "free", "a")
    assert port.cached_blocks == 3
    assert _both(ref, port, "clear_prefix_cache") == 3
    assert port.free_blocks == port.num_blocks
    assert not port._refcounts and not port._prefix_buckets
    _same(ref, port)


def test_fragmentation_counts_shared_block_once():
    ref, port = _pools(num_blocks=8, bs=4)
    toks = np.arange(8, dtype=np.int32)
    _both(ref, port, "ensure", "a", 8)
    _both(ref, port, "publish_prefix", "a", toks)
    _both(ref, port, "attach_prefix", "b", toks)
    s = port.fragmentation_stats()
    assert (s["blocks_in_use"], s["live_tokens"], s["shared_blocks"],
            s["cached_blocks"]) == (2, 8, 2, 2)
    assert s["utilization"] == 1.0
    _same(ref, port)
    _both(ref, port, "free", "a")
    _both(ref, port, "free", "b")
    s = port.fragmentation_stats()
    assert s["blocks_in_use"] == 2 and s["utilization"] == 1.0
    assert s["shared_blocks"] == 0
    _same(ref, port)


def test_stats_snapshot_during_active_cow_stays_consistent():
    """Snapshots taken right after each fresh block leaves the free list
    (copy, table swap and decref still pending) equal the reference's and
    count no block twice."""
    snaps = []
    for pool in _pools(num_blocks=8, bs=4):
        toks = np.arange(8, dtype=np.int32)
        pool.ensure("a", 8)
        pool.publish_prefix("a", toks)
        pool.attach_prefix("b", toks)
        orig, got = pool._alloc_block, []

        def alloc_then_snapshot(pool=pool, orig=orig, got=got):
            blk = orig()
            got.append((pool.fragmentation_stats(),
                        pool.prefix_cache_stats()))
            return blk

        pool._alloc_block = alloc_then_snapshot
        assert pool.make_writable("b", 0, 8) == 2
        pool._alloc_block = orig
        snaps.append(got)
        _audit(pool)
    assert snaps[0] == snaps[1] and len(snaps[1]) == 2
    for frag, pref in snaps[1]:
        assert 0.0 <= frag["utilization"] <= 1.0
        assert pref["cached_blocks"] == 2


def test_stats_raise_on_accounting_drift():
    _, port = _pools(num_blocks=8, bs=4)
    port.ensure("a", 8)
    port.publish_prefix("a", np.arange(8, dtype=np.int32))
    blk = port._tables["a"][0]
    held = port._refcounts.pop(blk)
    for stats in (port.fragmentation_stats, port.prefix_cache_stats):
        with pytest.raises(RuntimeError, match="accounting drift"):
            stats()
    port._refcounts[port._free[-1]] = 1
    with pytest.raises(RuntimeError, match="free and refcounted"):
        port.fragmentation_stats()
    del port._refcounts[port._free[-1]]
    port._refcounts[blk] = held
    # an index block missing from the refcount map
    entry = port._cached_blocks[blk]
    port._cached_blocks[99] = entry
    with pytest.raises(RuntimeError, match="missing from the refcount"):
        port.prefix_cache_stats()
    del port._cached_blocks[99]
    _audit(port)


@pytest.mark.parametrize("geom,kv_dtype,seed", [
    ((16, 4, 2, 8), None, 42),
    ((16, 4, 2, 8), "int8", 2),
    ((12, 4, 1, 4), "int8", 2)], ids=["float", "int8_target", "int8_draft"])
def test_ragged_churn_100_rounds_equals_reference(geom, kv_dtype, seed):
    """tests/test_prefix_cache.py's and tests/test_serving_int8.py's churn
    (attach / ensure / make_writable / write / publish / trim / free /
    evict over a 3-token alphabet, so chains really share) replayed on
    both pools: after EVERY round the tables, lengths, refcounts, free
    list, index, statistics, bytes and pool rows are equal, the refcount
    audit holds, and no pool tensor has moved."""
    nb, bs, hk, d = geom
    rng = np.random.RandomState(seed)
    ref, port = _pools(num_blocks=nb, bs=bs, hk=hk, d=d, kv_dtype=kv_dtype)
    ptrs = _ptrs(port)
    live, counter = {}, 0
    for _ in range(100):
        op = rng.rand()
        if op < 0.55 and len(live) < 6:
            sid = f"s{counter}"
            counter += 1
            toks = rng.randint(0, 3, rng.randint(1, 21)).astype(np.int32)
            try:
                matched = _both(ref, port, "attach_prefix", sid, toks)
                _both(ref, port, "ensure", sid, len(toks))
                start = 0 if rng.rand() < 0.25 else matched
                _both(ref, port, "make_writable", sid, start, len(toks))
                _write_rows(ref, port, sid, start, len(toks), counter)
                _both(ref, port, "publish_prefix", sid, toks)
                live[sid] = toks
            except RuntimeError:
                _both(ref, port, "free", sid)
                if live:
                    victim = list(live)[rng.randint(len(live))]
                    live.pop(victim)
                    _both(ref, port, "free", victim)
        elif op < 0.75 and live:
            victim = list(live)[rng.randint(len(live))]
            live.pop(victim)
            _both(ref, port, "free", victim)
        elif op < 0.85 and live:
            sid = list(live)[rng.randint(len(live))]
            _both(ref, port, "trim", sid,
                  rng.randint(0, len(live[sid]) + 1))
        else:
            _both(ref, port, "evict_prefix", rng.randint(0, 3))
        _same(ref, port)
        _rows_equal(ref, port)
        assert _ptrs(port) == ptrs
    assert port.prefix_hits > 0 and port.cow_copies > 0
    if kv_dtype is None:
        assert port.prefix_evictions > 0
    for sid in list(live):
        _both(ref, port, "free", sid)
    _both(ref, port, "clear_prefix_cache")
    _same(ref, port)
    assert port.free_blocks == port.num_blocks and port.bytes_in_use() == 0


# --------------------------------------------------------------- engines
KW = dict(num_slots=2, block_size=4, prefill_chunk=4, decode_quantum=3)


def _ref_model():
    """A fresh reference model (a quantized engine sweeps its model in
    place); the same seed gives the same weights."""
    paddle.seed(0)
    model = RefLM(RefConfig.tiny(tensor_parallel=False))
    model.eval()
    return model


@pytest.fixture(scope="module")
def models():
    ref = _ref_model()
    arrays = {k: v.numpy() for k, v in ref.state_dict().items()}
    return ref, arrays, _port_model(arrays)


def _port_model(arrays):
    model = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel=False),
                             device="cpu")
    return load_paddle_tpu_arrays(model, arrays)


def _shared_prompts(vocab):
    """tests/test_prefix_cache.py's trace: an 8-token system prompt (2
    full blocks at block size 4) and unique tails; the last prompt is the
    bare system prompt, whose fully cached chain prefills its last token
    again into a shared block (the copy-on-write trigger)."""
    rng = np.random.RandomState(3)
    sys_p = rng.randint(1, vocab, 8).astype(np.int32)
    tails = [rng.randint(1, vocab, n).astype(np.int32) for n in (3, 5, 1)]
    return [np.concatenate([sys_p, t]) for t in tails] + [sys_p.copy()]


_MAX_NEW = [5, 4, 6, 4]


def _engine(model, ref=False, **kw):
    if ref:
        return RefEngine(model, **kw)
    return ServingEngine(model, device="cpu", **kw)


def _submit(eng, prompts, max_new, seeds=None):
    return [eng.submit(p, max_new_tokens=mn, req_id=f"r{i}",
                       seed=seeds[i] if seeds else 0)
            for i, (p, mn) in enumerate(zip(prompts, max_new))]


def _result(eng, reqs):
    st = eng.engine_stats()
    return {"streams": [list(map(int, r.tokens)) for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "counters": {k: st[k] for k in _COUNTERS},
            "prefix": st.get("prefix_cache"),
            "pool": st["pool"]}


def _equal_results(got, want):
    for key in ("streams", "reasons", "counters", "prefix"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("chunk", [4, 6])
def test_shared_prompt_trace_equals_reference(models, chunk):
    """Hits, the bare-prompt request's copy-on-write, fewer prefill tokens
    than the unshared run, equal streams, a pool that ends at scratch +
    cache and no pool tensor moved. With 4-token chunks every number
    equals the reference engine's; with 6-token chunks a hit's first chunk
    starts at a cached length (8, or 7 for the bare prompt) that is no
    multiple of the chunk, so K3's first chunk of a row continues a
    cached context (held to the unshared engine)."""
    ref_model, _, port_model = models
    prompts = _shared_prompts(ref_model.config.vocab_size)
    kw = dict(KW, prefill_chunk=chunk, prefix_cache=True)
    eng = _engine(port_model, **kw)
    reqs = _submit(eng, prompts, _MAX_NEW)
    ptrs = eng._pool_ptrs()
    eng.run()
    got = _result(eng, reqs)
    assert eng._pool_ptrs() == ptrs
    if chunk == 4:
        ref = _engine(ref_model, ref=True, **kw)
        ref_reqs = _submit(ref, prompts, _MAX_NEW)
        ref.run()
        want = _result(ref, ref_reqs)
        _equal_results(got, want)
        assert got["pool"] == want["pool"]
    base = _engine(port_model, **dict(kw, prefix_cache=False))
    base_reqs = _submit(base, prompts, _MAX_NEW)
    base.run()
    assert _result(base, base_reqs)["streams"] == got["streams"]
    assert got["prefix"]["hits"] > 0 and got["prefix"]["cow_copies"] >= 1
    assert got["counters"]["prefill_tokens"] < base.stats["prefill_tokens"]
    # the prefill skipped exactly the cached tokens, one short of a fully
    # cached prompt
    saved = sum(min(r.cached_prefix_tokens, r.prefill_target - 1)
                for r in reqs)
    assert base.stats["prefill_tokens"] - got["counters"][
        "prefill_tokens"] == saved > 0
    assert eng.pool.blocks_in_use == 1 + eng.pool.cached_blocks
    _audit(eng.pool)


def test_admission_counts_novel_demand_only(models):
    """Two identical prompts on a pool that cannot hold two unshared
    copies: the unshared engine serialises them, the prefix engine runs
    them together (the twin's demand is its novel blocks); the port's
    streams and numbers equal the reference's."""
    ref_model, _, port_model = models
    rng = np.random.RandomState(5)
    prompt = rng.randint(1, ref_model.config.vocab_size,
                         8).astype(np.int32)

    def run(model, prefix, ref=False):
        eng = _engine(model, ref=ref, num_blocks=6, max_context=16,
                      prefix_cache=prefix, **KW)
        a = eng.submit(prompt, max_new_tokens=4, req_id="a")
        while not a.tokens:
            eng.step()
        b = eng.submit(prompt.copy(), max_new_tokens=4, req_id="b")
        overlap = False
        while eng.has_work:
            eng.step()
            overlap = overlap or (a.slot is not None and b.slot is not None)
        return overlap, _result(eng, [a, b])

    overlap_u, unshared = run(port_model, False)
    overlap_p, got = run(port_model, True)
    overlap_r, want = run(ref_model, True, ref=True)
    _equal_results(got, want)
    assert got["streams"] == unshared["streams"]
    assert not overlap_u and overlap_p and overlap_r


def test_preempted_sharer_resumes_like_reference(models):
    """Evict one of two sharers mid-decode: the survivor decodes on over
    the still-shared blocks, the victim resumes by re-prefill (attaching
    the cache again); both streams equal an undisturbed unshared run's,
    and the port equals the reference under the same eviction."""
    ref_model, _, port_model = models
    vocab = ref_model.config.vocab_size
    rng = np.random.RandomState(9)
    sys_p = rng.randint(1, vocab, 8).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.randint(1, vocab, n).astype(
        np.int32)]) for n in (2, 3)]
    base = _engine(port_model, **KW)
    base_reqs = _submit(base, prompts, [8, 8])
    base.run()
    out = {}
    for side, model in (("ref", ref_model), ("port", port_model)):
        eng = _engine(model, ref=side == "ref", prefix_cache=True, **KW)
        a, b = _submit(eng, prompts, [8, 8])
        while len(a.tokens) < 2 or len(b.tokens) < 2:
            eng.step()
        assert not a.finished and not b.finished
        eng.preempt(a)
        eng.run()
        out[side] = _result(eng, [a, b])
    _equal_results(out["port"], out["ref"])
    assert out["port"]["streams"] == _result(base, base_reqs)["streams"]
    assert out["port"]["counters"]["preempted"] == 1
    assert out["port"]["prefix"]["hits"] > 0
    _audit(eng.pool)


def _mq_requests(vocab):
    """tests/test_multiquantum.py::test_multiquantum_prefix_hit_cow."""
    rng = np.random.RandomState(3)
    sys_p = rng.randint(1, vocab, 8).astype(np.int32)
    return [(np.concatenate([sys_p, rng.randint(1, vocab, t).astype(
        np.int32)]), mn) for t, mn in ((3, 8), (5, 6), (2, 9))] + [
        (sys_p.copy(), 7)]


def test_multiquantum_with_prefix_cache_equals_reference(models):
    """``multi_quantum=4`` with the cache on: the port's streams equal its
    K=1 engine's, and every number equals the reference's K=4 engine's;
    no pool tensor moves across the copies."""
    ref_model, _, port_model = models
    requests = _mq_requests(ref_model.config.vocab_size)
    prompts, max_new = zip(*requests)
    runs = {}
    for name, model, ref, k in (("ref4", ref_model, True, 4),
                                ("port4", port_model, False, 4),
                                ("port1", port_model, False, 1)):
        eng = _engine(model, ref=ref, multi_quantum=k, prefix_cache=True,
                      **KW)
        reqs = _submit(eng, prompts, max_new)
        ptrs = None if ref else eng._pool_ptrs()
        eng.run()
        assert ref or eng._pool_ptrs() == ptrs
        runs[name] = _result(eng, reqs)
    _equal_results(runs["port4"], runs["ref4"])
    assert runs["port4"]["streams"] == runs["port1"]["streams"]
    assert runs["port4"]["prefix"]["hits"] > 0
    assert runs["port4"]["prefix"]["cow_copies"] >= 1
    c4, c1 = runs["port4"]["counters"], runs["port1"]["counters"]
    assert c4["steps"] < c1["steps"]


def test_int8_kv_pools_with_prefix_cache_equal_reference(models):
    """tests/test_serving_int8.py's prefix trace: int8 weights and int8 KV
    pools, the bare system prompt after the prompt it prefixes (the
    follower hits the leader's published chain and copies its tail block,
    scale rows included); streams equal the unshared engine's, and every
    number equals the reference's."""
    _, arrays, _ = models
    rng = np.random.RandomState(3)
    vocab = RefConfig.tiny(tensor_parallel=False).vocab_size
    sys_p = rng.randint(1, vocab, 8).astype(np.int32)
    tail = rng.randint(1, vocab, 3).astype(np.int32)
    prompts = [np.concatenate([sys_p, tail]), sys_p.copy()]
    kw = dict(KW, quantize="weight_only_int8", kv_dtype="int8")

    def run_seq(model, ref=False, **extra):
        eng = _engine(model, ref=ref, **kw, **extra)
        ptrs = None if ref else eng._pool_ptrs()
        reqs = []
        for i, (p, mn) in enumerate(zip(prompts, (5, 4))):
            reqs.append(eng.submit(p, max_new_tokens=mn, req_id=f"r{i}"))
            eng.run()
        assert ref or eng._pool_ptrs() == ptrs
        return _result(eng, reqs)

    want = run_seq(_ref_model(), ref=True, prefix_cache=True)
    got = run_seq(_port_model(arrays), prefix_cache=True)
    unshared = run_seq(_port_model(arrays))
    _equal_results(got, want)
    assert got["streams"] == unshared["streams"]
    assert got["prefix"]["hits"] >= 2 and got["prefix"]["cow_copies"] >= 1


# ------------------------------------------------- the port against itself
def test_sampling_with_prefix_cache_equals_unshared(models):
    """Fixed-seed sampling: draws are keyed by (request seed, tokens
    emitted), so the cached engine replays the unshared one exactly."""
    _, _, port_model = models
    prompts = _shared_prompts(port_model.config.vocab_size)
    seeds = [101, 202, 303, 404]
    kw = dict(KW, decode_strategy="sampling", temperature=0.8, top_k=16)
    streams = []
    for prefix in (False, True):
        eng = _engine(port_model, prefix_cache=prefix, **kw)
        reqs = _submit(eng, prompts, _MAX_NEW, seeds=seeds)
        eng.run()
        streams.append(_result(eng, reqs)["streams"])
    assert streams[0] == streams[1]
    assert eng.pool.prefix_cache_stats()["hits"] > 0


def test_dispatch_collect_and_fused_attention_equal_step(models):
    """With the cache on, ``step_dispatch`` / ``step_collect`` pairs (K=4
    and K=1) and ``attn_impl="fused"`` give ``step()``'s streams and
    numbers. Each dispatch staged its rows' tables after the
    copy-on-write: the staged rows are the pool's tables, and every block
    the dispatch writes is held by its row alone."""
    _, _, port_model = models
    requests = _mq_requests(port_model.config.vocab_size)
    prompts, max_new = zip(*requests)
    bs, t = KW["block_size"], KW["decode_quantum"]

    def check_staged(eng, pending):
        st, pool = eng._state.stage, eng.pool
        for r in pending["rows"]:
            table = pool._tables[r.req_id]
            assert st["tables"][r.slot][:len(table)].tolist() == table
            lo = int(st["seq_lens"][r.slot])
            hi = min(lo + pending["k"] * t,
                     r.prompt_len + r.max_new_tokens - 1)
            for j in range(lo // bs, (hi - 1) // bs + 1):
                assert pool._refcounts[table[j]] == 1

    def run(pairs, **kw):
        eng = _engine(port_model, prefix_cache=True, **KW, **kw)
        reqs = _submit(eng, prompts, max_new)
        if pairs:
            while eng.has_work:
                pending = eng.step_dispatch()
                if pending is not None:
                    check_staged(eng, pending)
                eng.step_collect(pending)
        else:
            eng.run()
        return _result(eng, reqs)

    for k in (1, 4):
        want = run(False, multi_quantum=k)
        _equal_results(run(True, multi_quantum=k), want)
        _equal_results(run(False, multi_quantum=k, attn_impl="fused"),
                       want)
        assert want["prefix"]["cow_copies"] >= 1
