"""Tensor-parallel layers (counterpart of
``paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py``).

The reference holds each full weight placed over the ``mp`` mesh axis and
lets GSPMD insert the collectives. Here each rank holds its slice and
calls the collectives of ``mp_ops`` itself (Megatron's layout). The
weights are torch's layout, (out, in), as the port's ``Linear``:

- ``ColumnParallelLinear`` splits ``out`` (weight rows, and its bias);
  ``gather_output`` all-gathers the output's last dim;
- ``RowParallelLinear`` splits ``in`` (weight columns); its input is
  this rank's slice (``input_is_parallel``) or is split here; the product
  is all-reduced, then the (full) bias added;
- ``VocabParallelEmbedding`` splits the vocabulary (table rows): ids
  outside this rank's rows read zeros, and the all-reduce sums the rows;
- ``ParallelCrossEntropy`` is the cross entropy over logits split on the
  vocabulary (max, sum of exponentials and the target's logit
  all-reduced).

Each split parameter carries ``is_distributed = True`` (as the
reference's) and ``_mp_split = (dim, rank, parts)``; :func:`local_of`
cuts a full tensor to this rank's slice. A parallel build of seed s
equals the serial build of seed s when every rank draws the full weight
from the same generator and keeps its slice (the Llama's
``_init_weights`` does). Without a mesh (or ``mp_group``) each layer is
its serial self.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .....nn.functional.common import torch_linear
from .....nn.functional.loss import cross_entropy
from .....nn.layer.common import Embedding, Linear
from .....parallel import mesh as mesh_state
from .mp_ops import _c_concat, _c_identity, _c_split, _mp_allreduce
from .....nn.layer.layers import Layer

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "local_of",
           "full_shape"]


def _group(mp_group):
    g = mp_group if mp_group is not None else mesh_state.axis_group("mp")
    if g is None:
        return None, 1, 0
    return g, g.nranks, g.rank


def _split(n, parts, what):
    if n % parts:
        raise ValueError(f"{what} {n} does not split over {parts} mp ranks")
    return n // parts


def _mark(p, dim, rank, parts, full):
    p.is_distributed = True
    p._mp_split = (dim, rank, parts)
    p._full_shape = tuple(full)


def full_shape(p):
    """The parameter's full (serial) shape in the port's layout."""
    return tuple(getattr(p, "_full_shape", p.shape))


def local_of(p, full):
    """This rank's slice of ``full`` (a tensor or array of
    ``full_shape(p)``) for parameter ``p``: its mp slice; the whole of it
    for a parameter that is not split."""
    split = getattr(p, "_mp_split", None)
    if split is None:
        return full
    dim, rank, parts = split
    size = full.shape[dim] // parts
    idx = [slice(None)] * len(full.shape)
    idx[dim] = slice(rank * size, (rank + 1) * size)
    return full[tuple(idx)]


class VocabParallelEmbedding(Embedding):
    """Embedding with the vocabulary's rows split over mp."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, device=None, dtype=None):
        group, parts, rank = _group(mp_group)
        per = _split(num_embeddings, parts, "vocabulary")
        super().__init__(per, embedding_dim, device=device, dtype=dtype)
        self._mp_group = group
        self._vocab_start = rank * per
        _mark(self.weight, 0, rank, parts, (num_embeddings, embedding_dim))

    def forward(self, x):
        if self._mp_group is None:
            return super().forward(x)
        lo, per = self._vocab_start, self.weight.shape[0]
        outside = (x < lo) | (x >= lo + per)
        out = super().forward((x - lo).masked_fill(outside, 0))
        out = out.masked_fill(outside[..., None], 0)
        return _mp_allreduce(out, self._mp_group)


class ColumnParallelLinear(Linear):
    """Weight (out, in) split along out; the output stays split unless
    ``gather_output``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, device=None, dtype=None):
        group, parts, rank = _group(mp_group)
        per = _split(out_features, parts, "out_features")
        super().__init__(in_features, per, bias=bool(has_bias),
                         device=device, dtype=dtype)
        self._mp_group = group
        self._gather_output = gather_output
        _mark(self.weight, 0, rank, parts, (out_features, in_features))
        if self.bias is not None:
            _mark(self.bias, 0, rank, parts, (out_features,))

    def forward(self, x):
        out = torch_linear(_c_identity(x, self._mp_group), self.weight,
                           self.bias)
        if self._gather_output:
            out = _c_concat(out, self._mp_group)
        return out


class RowParallelLinear(Linear):
    """Weight (out, in) split along in; the product is all-reduced before
    the bias is added."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None,
                 device=None, dtype=None):
        group, parts, rank = _group(mp_group)
        per = _split(in_features, parts, "in_features")
        super().__init__(per, out_features, bias=bool(has_bias),
                         device=device, dtype=dtype)
        self._mp_group = group
        self._input_is_parallel = input_is_parallel
        _mark(self.weight, 1, rank, parts, (out_features, in_features))

    def forward(self, x):
        if self._mp_group is None:
            return torch_linear(x, self.weight, self.bias)
        if not self._input_is_parallel:
            x = _c_split(x, self._mp_group)
        out = _mp_allreduce(torch_linear(x, self.weight), self._mp_group)
        return out if self.bias is None else out + self.bias.to(out.dtype)


class ParallelCrossEntropy(Layer):
    """Cross entropy (per position, a trailing dim of 1) over logits whose
    last dim is split over mp; ``ignore_index`` positions give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self._mp_group, _, self._rank = _group(mp_group)
        self._ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label.squeeze(-1)
        if self._mp_group is None:
            loss = cross_entropy(input, label, reduction="none",
                                 ignore_index=self._ignore_index)
            return loss.unsqueeze(-1)
        group = self._mp_group
        logits = input.float()
        per = logits.shape[-1]
        lo = self._rank * per
        top = logits.detach().amax(dim=-1).contiguous()
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group.process_group)
        z = logits - top[..., None]
        sumexp = _mp_allreduce(z.exp().sum(dim=-1), group)
        inside = (label >= lo) & (label < lo + per)
        idx = (label - lo).clamp(0, per - 1)
        target = z.gather(-1, idx[..., None]).squeeze(-1) * inside
        loss = sumexp.log() - _mp_allreduce(target, group)
        loss = torch.where(label == self._ignore_index,
                           torch.zeros_like(loss), loss)
        return loss.unsqueeze(-1)
