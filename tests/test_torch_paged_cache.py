"""The port's paged KV pool allocator held against paddle_tpu's: one seeded
sequence of operations (ensure / grow / trim / share / free), replayed on
both pools, must leave equal tables, lengths and statistics at every step.
The allocator is exact integer bookkeeping, so equality is exact."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from paddle_tpu.nlp import PagedKVCachePool as RefPool
from paddle_tpu_torch.nlp import PagedKVCachePool


def _pools(num_blocks=24, bs=4):
    ref = RefPool(num_blocks, bs, 2, 8, num_layers=2, dtype=jnp.float32)
    port = PagedKVCachePool(num_blocks, bs, 2, 8, num_layers=2,
                            dtype=torch.float32, device="cpu")
    return ref, port


def _same(ref, port, seqs):
    assert ref._tables == port._tables
    assert ref._lens == port._lens
    assert ref._refcounts == port._refcounts
    assert ref._free == port._free
    assert ref.fragmentation_stats() == port.fragmentation_stats()
    np.testing.assert_array_equal(
        np.asarray(ref.block_table_array(seqs, pad_to=6)),
        port.block_table_array(seqs, pad_to=6))
    np.testing.assert_array_equal(np.asarray(ref.seq_lens_array(seqs)),
                                  port.seq_lens_array(seqs))
    assert ref.bytes_in_use() == port.bytes_in_use()
    for n in (1, 9, 40, 200):
        assert ref.can_allocate(n) == port.can_allocate(n)
        assert ref.blocks_needed(n) == port.blocks_needed(n)


def test_seeded_op_sequence_replays_identically():
    rng = np.random.RandomState(0)
    ref, port = _pools()
    live = []
    n_new = 0
    for step in range(120):
        op = rng.choice(["ensure", "grow", "trim", "share", "free"],
                        p=[0.35, 0.25, 0.15, 0.1, 0.15])
        if op == "ensure" or not live:
            sid = f"s{n_new}"
            n_new += 1
            n = int(rng.randint(1, 14))
            if not ref.can_allocate(n):
                continue
            assert ref.ensure(sid, n) == port.ensure(sid, n)
            live.append(sid)
        elif op == "grow":
            sid = live[rng.randint(len(live))]
            need = ref.seq_len(sid) + int(rng.randint(1, 6))
            if ref.blocks_needed(need) - ref.held_blocks(sid) \
                    > ref.free_blocks:
                continue
            np.testing.assert_array_equal(
                np.asarray(ref.grow_decode_table(sid, need, 0, pad_to=5)),
                port.grow_decode_table(sid, need, 0, pad_to=5))
        elif op == "trim":
            sid = live[rng.randint(len(live))]
            n = int(rng.randint(0, ref.seq_len(sid) + 1))
            assert ref.trim(sid, n) == port.trim(sid, n)
        elif op == "share":
            src = live[rng.randint(len(live))]
            sid = f"s{n_new}"
            n_new += 1
            assert ref.share(src, sid) == port.share(src, sid)
            live.append(sid)
        else:
            sid = live.pop(rng.randint(len(live)))
            ref.free(sid)
            port.free(sid)
        _same(ref, port, live[:5])
    st = port.fragmentation_stats()
    assert st["shared_blocks"] > 0 and st["blocks_freed_total"] > 0
    for sid in live:
        ref.free(sid)
        port.free(sid)
    _same(ref, port, [])
    assert port.free_blocks == port.num_blocks


def test_exhaustion_and_double_free_raise_like_reference():
    ref, port = _pools(num_blocks=4)
    for pool in (ref, port):
        pool.ensure("a", 16)
        with pytest.raises(RuntimeError, match="exhausted"):
            pool.ensure("b", 1)
        with pytest.raises(RuntimeError, match="double free|not held"):
            pool._release([99])


def test_pools_are_device_tensors_written_in_place():
    port = PagedKVCachePool(8, 4, 2, 8, num_layers=3, dtype=torch.bfloat16,
                            device="cpu")
    assert len(port.k_pools) == 3 and len(port.v_pools) == 3
    assert port.k_pools[0].shape == (8, 4, 2, 8)
    assert port.k_pools[0].dtype == torch.bfloat16
    assert port.fragmentation_stats()["kv_dtype"] == "bfloat16"
    with pytest.raises(NotImplementedError, match="prefix"):
        PagedKVCachePool(8, 4, 2, 8, prefix_cache=True, device="cpu")
    with pytest.raises(NotImplementedError, match="int8"):
        PagedKVCachePool(8, 4, 2, 8, kv_dtype="int8", device="cpu")
    with pytest.raises(NotImplementedError, match="copy-on-write"):
        port.grow_decode_table("a", 4, 0, cow=True)
