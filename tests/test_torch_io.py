"""The port's ``io`` held against paddle_tpu's on the CPU: the same
datasets (numpy arrays from ``np.random.RandomState``) through both
packages' samplers and loaders. Everything here is host index arithmetic
and copies, so every comparison is exact: batch order and content,
sampler indices, the native splitmix64 permutation, the varlen pack.

Shuffles read numpy's global stream in both packages (ROADMAP caveat
C7), so each comparison seeds it right before each package draws."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import io as rio
from paddle_tpu.io import _native as ref_native
from paddle_tpu_torch import io
from paddle_tpu_torch.io import _native


@pytest.fixture(autouse=True)
def _numpy_global_state():
    """Leave numpy's global random stream as this test found it (the tests
    here seed it, and a later test in the same worker may draw from it)."""
    state = np.random.get_state()
    yield
    np.random.set_state(state)


def _fields(n=22, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((n, 3)).astype(np.float32),
            rng.randint(0, 9, (n, 1)).astype(np.int64))


def _np(batch):
    return [np.asarray(t.numpy()) for t in batch]


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


class _Pairs(io.Dataset):
    """Items as (array, int, float), the collate's three kinds."""

    def __init__(self, x):
        self.x = x

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], int(i), float(self.x[i, 0])


class _RefPairs(rio.Dataset):
    def __init__(self, x):
        self.x = x

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], int(i), float(self.x[i, 0])


@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_equal_reference_for_0_and_2_workers(drop_last):
    x, y = _fields()
    want = [_np(b) for b in rio.DataLoader(
        rio.TensorDataset([x, y]), batch_size=5, drop_last=drop_last)]
    for workers in ((0, 2) if drop_last else (0,)):
        loader = io.DataLoader(io.TensorDataset([x, y]), batch_size=5,
                               drop_last=drop_last, num_workers=workers)
        got = [_np(b) for b in loader]
        assert len(loader) == len(got) == (4 if drop_last else 5)
        _equal(got, want)
        assert loader._executor is None  # workers stopped after the epoch


def test_collate_kinds_and_shuffled_order_equal_reference():
    x, _ = _fields(seed=1)
    np.random.seed(3)
    want = [_np(b) for b in rio.DataLoader(_RefPairs(x), batch_size=4,
                                           shuffle=True)]
    np.random.seed(3)
    got = list(io.DataLoader(_Pairs(x), batch_size=4, shuffle=True))
    assert [t.dtype for t in got[0]] == [torch.float32, torch.int64,
                                         torch.float32]
    _equal([_np(b) for b in got], want)
    nested = io.default_collate_fn([{"a": np.ones(2), "b": [1, 2.0]},
                                    {"a": np.zeros(2), "b": [3, 4.0]}])
    assert nested["a"].shape == (2, 2) and nested["b"][0].tolist() == [1, 3]
    assert io.default_collate_fn([torch.ones(2), torch.zeros(2)]).shape == \
        (2, 2)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True),
                                               (True, False)])
def test_distributed_batch_sampler_equal_at_every_rank(shuffle, drop_last):
    data = np.arange(23)
    for rank in range(4):
        got = io.DistributedBatchSampler(data, 3, num_replicas=4, rank=rank,
                                         shuffle=shuffle, drop_last=drop_last)
        want = rio.DistributedBatchSampler(data, 3, num_replicas=4,
                                           rank=rank, shuffle=shuffle,
                                           drop_last=drop_last)
        got.set_epoch(5)
        want.set_epoch(5)
        assert list(got) == list(want) and len(got) == len(want)
    one = io.DistributedBatchSampler(data, 4)
    assert (one.nranks, one.local_rank) == (1, 0)


@pytest.fixture
def own_ref_native(tmp_path, monkeypatch):
    """The reference's native io core built by its own ``_try_build`` into
    this test's directory and bound for this test alone. The reference's
    loader otherwise binds the shared ``~/.cache/paddle_tpu`` build, which
    another test process may be writing at that moment (a half-written
    library fails to bind, and the loader remembers the failure for the
    life of its process)."""
    built = ref_native._try_build(str(tmp_path / "libpaddle_tpu_io.so"))
    assert built is not None, "g++ could not build csrc/paddle_tpu_io.cc"
    monkeypatch.setattr(ref_native, "_LIB", ref_native._bind(built))
    monkeypatch.setattr(ref_native, "_TRIED", True)


def test_native_permutation_and_random_sampler_at_70000(own_ref_native):
    assert ref_native.lib() is not None, "the reference's native io core"
    for seed in (0, 12345, 2**31 - 2):
        np.testing.assert_array_equal(_native.shuffle_indices(70000, seed),
                                      ref_native.shuffle_indices(70000, seed))
    data = np.zeros(70000)
    np.random.seed(11)
    want = list(rio.RandomSampler(data))
    np.random.seed(11)
    got = list(io.RandomSampler(data))
    assert got == want and sorted(got) == list(range(70000))


def test_pack_varlen_and_samplers_equal_reference():
    rows = [[1, 2, 3], [], [4, 5, 6, 7, 8, 9], [10]]
    for pad in (0, -1):
        out, lengths = io.pack_varlen(rows, 4, pad)
        rout, rlen = rio.pack_varlen(rows, 4, pad)
        np.testing.assert_array_equal(out.numpy(), rout.numpy())
        np.testing.assert_array_equal(lengths.numpy(), rlen.numpy())
        assert out.dtype == torch.int32
    data = np.zeros(17)
    for build, rbuild in (
            (lambda: io.RandomSampler(data, replacement=True, num_samples=9),
             lambda: rio.RandomSampler(data, replacement=True,
                                       num_samples=9)),
            (lambda: io.WeightedRandomSampler([0.1, 0.5, 0.2, 0.2], 12),
             lambda: rio.WeightedRandomSampler([0.1, 0.5, 0.2, 0.2], 12)),
            (lambda: io.BatchSampler(data, shuffle=True, batch_size=4),
             lambda: rio.BatchSampler(data, shuffle=True, batch_size=4))):
        np.random.seed(2)
        want = list(rbuild())
        np.random.seed(2)
        got = list(build())
        assert got == want and len(build()) == len(rbuild())
    assert list(io.SequenceSampler(data)) == list(range(17))


def test_random_split_and_dataset_kinds_equal_reference():
    x, y = _fields(10, seed=2)
    paddle.seed(5)
    torch.manual_seed(5)
    for lengths in ([3, 7], [0.4, 0.6]):
        got = io.random_split(io.TensorDataset([x, y]), lengths)
        want = rio.random_split(rio.TensorDataset([x, y]), lengths)
        assert [s.indices for s in got] == [s.indices for s in want]
    with pytest.raises(ValueError):
        io.random_split(x, [3, 3])
    comp = io.ComposeDataset([io.TensorDataset([x]), io.TensorDataset([y])])
    assert len(comp) == 10 and len(comp[4]) == 2
    assert io.Subset(x, [2, 5])[1] is not None and len(io.Subset(x, [2])) == 1

    class Stream(io.IterableDataset):
        def __init__(self, n):
            self.n = n

        def __iter__(self):
            return iter(np.arange(self.n))

    chain = io.ChainDataset([Stream(3), Stream(4)])
    batches = list(io.DataLoader(chain, batch_size=3))
    assert [b.tolist() for b in batches] == [[0, 1, 2], [0, 1, 2], [3]]
    assert len(list(io.DataLoader(chain, batch_size=3, drop_last=True))) == 2
    # an iterable dataset with workers prefetches on a thread, in order
    threaded = list(io.DataLoader(chain, batch_size=3, num_workers=2))
    assert [b.tolist() for b in threaded] == [b.tolist() for b in batches]
    assert io.get_worker_info() is None
