"""``ProcessMesh`` of the port (counterpart of
``paddle_tpu/distributed/auto_parallel/process_mesh.py``): a grid of
process ids with named dims. A mesh of one process is the one-rank path
of ``shard_tensor`` and ``Engine``; a larger one needs several ranks
(ROADMAP A7)."""
from __future__ import annotations

import numpy as np

__all__ = ["ProcessMesh"]


class ProcessMesh:
    def __init__(self, mesh=None, dim_names=None, shape=None,
                 process_ids=None):
        arr = (np.asarray(mesh) if mesh is not None
               else np.asarray(process_ids).reshape(shape))
        self._shape = tuple(arr.shape)
        self._process_ids = [int(i) for i in arr.reshape(-1)]
        self._dim_names = (list(dim_names) if dim_names is not None
                           else [f"d{i}" for i in range(arr.ndim)])

    @property
    def shape(self):
        return list(self._shape)

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def process_ids(self):
        return self._process_ids

    processes = process_ids

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def mesh(self):
        return np.asarray(self._process_ids).reshape(self._shape)

    def get_dim_size(self, dim_name):
        return self._shape[self._dim_names.index(dim_name)]

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh)
                and self._shape == other._shape
                and self._process_ids == other._process_ids)

    def __hash__(self):
        return hash((self._shape, tuple(self._process_ids)))

    def __repr__(self):
        return f"ProcessMesh(shape={self.shape}, dim_names={self._dim_names})"
