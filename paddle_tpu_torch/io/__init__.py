"""``paddle.io`` of the port (counterpart of ``paddle_tpu/io``): datasets,
samplers, ``BatchSampler`` / ``DistributedBatchSampler``, collation and
``DataLoader``.

Batches come out as torch tensors on the CPU; the trainers
(``distributed.auto_parallel.Engine``, ``hapi.Model``) move them to their
model's device. The samplers draw as the reference's do: ``RandomSampler``
from numpy's global stream (``np.random.seed`` fixes an epoch's order),
and at n >= 65,536 by the native core's splitmix64 Fisher-Yates
(``_native.shuffle_indices``, the same permutation for the same seed);
``random_split`` from the torch default generator's initial seed where
the reference reads its own global seed; ``DistributedBatchSampler``
from ``RandomState(epoch)``.

``num_workers > 0`` fetches batches in spawned worker processes, which
collate in numpy (the parent makes the tensors) and never see a GPU
(``CUDA_VISIBLE_DEVICES`` is empty while they start); batches come back
in order. A dataset or collate function that does not pickle, or an
``IterableDataset``, falls back to a prefetch thread.
"""
from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from . import _native

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "BatchSampler", "DistributedBatchSampler", "DataLoader",
    "get_worker_info", "default_collate_fn", "pack_varlen",
]

# the size from which RandomSampler shuffles by the native rule
_NATIVE_SHUFFLE_MIN = 1 << 16


def pack_varlen(rows, max_len, pad_id=0):
    """Pad variable-length int sequences into a dense int32 batch and
    their lengths (two int32 tensors)."""
    out, lengths = _native.pack_varlen(rows, max_len, pad_id)
    return torch.from_numpy(out), torch.from_numpy(lengths)


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Rows of equally long tensors or arrays: item ``i`` is the tuple of
    each one's row ``i``."""

    def __init__(self, tensors):
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __getitem__(self, idx):
        out = []
        for ds in self.datasets:
            item = ds[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return min(len(ds) for ds in self.datasets)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for ds in self.datasets:
            yield from ds


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    """Disjoint ``Subset``s of the given lengths (or fractions), from one
    permutation drawn by ``RandomState(seed & 0x7FFFFFFF)``, ``seed``
    being ``generator``'s initial seed (torch's default generator's when
    None)."""
    total = len(dataset)
    if all(isinstance(n, float) for n in lengths):
        lengths = [int(total * f) for f in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    if sum(lengths) != total:
        raise ValueError("sum of lengths must equal dataset size")
    seed = (generator or torch.default_generator).initial_seed()
    perm = np.random.RandomState(seed & 0x7FFFFFFF).permutation(total)
    out, off = [], 0
    for n in lengths:
        out.append(Subset(dataset, perm[off:off + n].tolist()))
        off += n
    return out


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        if self.replacement:
            return iter(np.random.randint(0, n, self.num_samples).tolist())
        if n >= _NATIVE_SHUFFLE_MIN:
            seed = int(np.random.randint(0, 2**31 - 1))
            return iter(
                _native.shuffle_indices(n, seed)[:self.num_samples].tolist())
        return iter(np.random.permutation(n)[:self.num_samples].tolist())

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        if isinstance(weights, torch.Tensor):
            weights = weights.detach().cpu().numpy()
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        return iter(np.random.choice(len(self.weights), self.num_samples,
                                     self.replacement, p).tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def _world():
    """(world size, rank) of the default process group, (1, 0) without
    one."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class DistributedBatchSampler(BatchSampler):
    """One data-parallel rank's batches: the index list (shuffled by
    ``RandomState(epoch)``) padded to a multiple of ``num_replicas`` by
    its own head, then every ``num_replicas``-th index from ``rank``.
    Without ``num_replicas`` / ``rank`` they come from the default
    ``torch.distributed`` process group (1 and 0 without one)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        world, me = _world()
        self.dataset = dataset
        self.batch_size = batch_size
        self.nranks = num_replicas if num_replicas is not None else world
        self.local_rank = rank if rank is not None else me
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.num_samples = -(-len(dataset) // self.nranks)
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.RandomState(self.epoch).permutation(
                n).tolist()
        else:
            indices = list(range(n))
        indices += indices[:(self.total_size - n)]
        indices = indices[self.local_rank:self.total_size:self.nranks]
        batch = []
        for idx in indices:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class _WorkerInfo:
    def __init__(self, id=0, num_workers=0, dataset=None):  # noqa: A002
        self.id, self.num_workers, self.dataset = id, num_workers, dataset


_worker_info = None


def get_worker_info():
    """Inside a ``DataLoader`` worker process: its ``id``,
    ``num_workers`` and ``dataset``; None elsewhere."""
    return _worker_info


def default_collate_fn(batch):
    """Stack samples into batched tensors, as paddle's collate: tensors
    and arrays stacked, ints to int64, floats to float32, sequences field
    by field, dicts key by key."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch)
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, np.float32))
    if isinstance(sample, (list, tuple)):
        return [default_collate_fn(list(group)) for group in zip(*batch)]
    if isinstance(sample, dict):
        return {k: default_collate_fn([d[k] for d in batch]) for k in sample}
    return batch


# -- worker processes ---------------------------------------------------------
def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except (ProcessLookupError, ValueError):
        return False
    except PermissionError:
        return True


class _SlotTaken(Exception):
    """This worker-id slot is held by a live process."""


def _read_owner(slot):
    try:
        with open(slot) as f:
            return int(f.read().strip() or -1)
    except FileNotFoundError:
        raise
    except (OSError, ValueError):
        return -1


def _try_claim_slot(slot, i):
    try:
        fd = os.open(slot, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        return i
    except FileExistsError:
        pass
    # a dead claimant's slot is taken over under an exclusive reap marker
    owner = _read_owner(slot)
    if owner == -1 or _pid_alive(owner):
        raise _SlotTaken
    try:
        rfd = os.open(slot + ".reap", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        raise _SlotTaken from None
    try:
        owner = _read_owner(slot)
        if owner == -1 or _pid_alive(owner):
            raise _SlotTaken
        with open(slot, "w") as f:
            f.write(str(os.getpid()))
        return i
    finally:
        os.close(rfd)
        try:
            os.unlink(slot + ".reap")
        except FileNotFoundError:
            pass


def _claim_worker_id(claim_dir):
    """A worker id below ``num_workers`` from O_EXCL slot files (the
    reference's scheme: it survives any spawn boundary, and a respawned
    worker reclaims a dead one's slot)."""
    i = 0
    while True:
        try:
            return _try_claim_slot(os.path.join(claim_dir, f"w{i}"), i)
        except FileNotFoundError:
            return i  # the loader closed while this worker started
        except _SlotTaken:
            i += 1


def _pool_init(dataset, collate_fn, worker_init_fn, claim_dir, num_workers):
    """Worker initializer: installs the dataset and collate function once
    per worker and runs ``worker_init_fn`` with the worker's id."""
    global _WORKER_DATASET, _WORKER_COLLATE, _worker_info
    _WORKER_DATASET = dataset
    _WORKER_COLLATE = collate_fn
    wid = _claim_worker_id(claim_dir) if claim_dir else 0
    _worker_info = _WorkerInfo(id=wid, num_workers=num_workers,
                               dataset=dataset)
    if worker_init_fn is not None:
        worker_init_fn(wid)


def _collate_numpy(batch):
    """``default_collate_fn`` in numpy (worker side)."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack(batch).numpy()
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, np.float32)
    if isinstance(sample, (list, tuple)):
        return [_collate_numpy(list(g)) for g in zip(*batch)]
    if isinstance(sample, dict):
        return {k: _collate_numpy([d[k] for d in batch]) for k in sample}
    return batch


def _tensorize(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, list):
        return [_tensorize(t) for t in tree]
    if isinstance(tree, tuple):
        return tuple(_tensorize(t) for t in tree)
    if isinstance(tree, dict):
        return {k: _tensorize(v) for k, v in tree.items()}
    return tree


def _pool_fetch(indices):
    samples = [_WORKER_DATASET[i] for i in indices]
    if _WORKER_COLLATE is None:
        return _collate_numpy(samples)
    return _WORKER_COLLATE(samples)


def _pool_warmup():
    return os.getpid()


def _picklable(*objs):
    import pickle

    try:
        for o in objs:
            pickle.dumps(o)
        return True
    except Exception:
        return False


class DataLoader:
    """Batches of a ``Dataset`` by its batch sampler, or of an
    ``IterableDataset`` in order, through ``collate_fn``.
    ``num_workers > 0``: spawned worker processes with at most
    ``prefetch_factor * num_workers`` batches in flight, yielded in
    order (see the module's note)."""

    def __init__(self, dataset, feed_list=None, places=None,
                 return_list=True, batch_sampler=None, batch_size=1,
                 shuffle=False, drop_last=False, collate_fn=None,
                 num_workers=0, use_buffer_reader=True, prefetch_factor=2,
                 use_shared_memory=False, timeout=0, worker_init_fn=None,
                 persistent_workers=False):
        self.dataset = dataset
        self.return_list = return_list
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = num_workers
        self.prefetch_factor = max(2, prefetch_factor)
        self.worker_init_fn = worker_init_fn
        self.persistent_workers = persistent_workers
        self.timeout = timeout
        self._executor = None
        self._claim_dir = None
        self._picklable_ok = None  # decided on the first iteration
        self._iterable_mode = isinstance(dataset, IterableDataset)
        self.drop_last = drop_last
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size",
                                      batch_size)
        elif self._iterable_mode:
            self.batch_sampler = None
            self.batch_size = batch_size
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size,
                drop_last=drop_last)
            self.batch_size = batch_size

    def __len__(self):
        if self._iterable_mode:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _fast_path(self):
        """A ``TensorDataset`` of numpy arrays under the default collate:
        one row gather per field (the reference's native path)."""
        return (isinstance(self.dataset, TensorDataset)
                and self.collate_fn is default_collate_fn
                and bool(self.dataset.tensors)
                and all(isinstance(t, np.ndarray)
                        for t in self.dataset.tensors))

    def _fetch_iter(self):
        if self._iterable_mode:
            buf = []
            for item in self.dataset:
                buf.append(item)
                if len(buf) == self.batch_size:
                    yield self.collate_fn(buf)
                    buf = []
            if buf and not self.drop_last:
                yield self.collate_fn(buf)
        elif self._fast_path():
            fields = self.dataset.tensors
            for batch_idx in self.batch_sampler:
                idx = np.asarray(batch_idx, np.int64)
                yield [torch.from_numpy(t[idx]) for t in fields]
        else:
            for batch_idx in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in batch_idx])

    def _ensure_executor(self):
        if self._executor is None:
            import multiprocessing as mp
            import tempfile
            from concurrent.futures import ProcessPoolExecutor

            claim_dir = self._claim_dir = tempfile.mkdtemp(prefix="ptt_dl_")
            collate = (None if self.collate_fn is default_collate_fn
                       else self.collate_fn)
            ex = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"), initializer=_pool_init,
                initargs=(self.dataset, collate, self.worker_init_fn,
                          claim_dir, self.num_workers))
            # start every worker now, with no GPU visible to it
            prev = os.environ.get("CUDA_VISIBLE_DEVICES")
            os.environ["CUDA_VISIBLE_DEVICES"] = ""
            try:
                for fut in [ex.submit(_pool_warmup)
                            for _ in range(self.num_workers)]:
                    fut.result()
            finally:
                if prev is None:
                    os.environ.pop("CUDA_VISIBLE_DEVICES", None)
                else:
                    os.environ["CUDA_VISIBLE_DEVICES"] = prev
            self._executor = ex
        return self._executor

    def _process_iter(self):
        from collections import deque

        ex = self._ensure_executor()
        window = self.prefetch_factor * self.num_workers
        pending = deque()
        timeout = self.timeout or None
        try:
            for batch_idx in self.batch_sampler:
                pending.append(ex.submit(_pool_fetch, list(batch_idx)))
                if len(pending) >= window:
                    yield _tensorize(pending.popleft().result(
                        timeout=timeout))
            while pending:
                yield _tensorize(pending.popleft().result(timeout=timeout))
        finally:
            if not self.persistent_workers:
                self.close()

    def close(self):
        """Shut the worker processes down and remove the worker-id claim
        directory (idempotent; at each epoch's end unless
        ``persistent_workers``)."""
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=True)
            self._executor = None
        if self._claim_dir is not None:
            import shutil

            shutil.rmtree(self._claim_dir, ignore_errors=True)
            self._claim_dir = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        if self.num_workers == 0:
            yield from self._fetch_iter()
            return
        if self._picklable_ok is None:
            self._picklable_ok = (not self._iterable_mode) and _picklable(
                self.dataset, self.collate_fn, self.worker_init_fn)
        if self._picklable_ok:
            yield from self._process_iter()
            return
        # a prefetch thread
        q = queue.Queue(maxsize=self.prefetch_factor * self.num_workers)
        sentinel = object()
        error = []

        def producer():
            try:
                for item in self._fetch_iter():
                    q.put(item)
            except BaseException as e:  # re-raised in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()
        if error:
            raise error[0]
