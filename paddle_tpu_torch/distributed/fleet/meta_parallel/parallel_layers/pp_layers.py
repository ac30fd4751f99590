"""Pipeline layer descriptions (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/pp_layers.py``).

``PipelineLayer`` keeps the reference's API and its segmentation: the
items (``LayerDesc`` / ``SharedLayerDesc`` / modules / callables) cut
into ``num_stages x num_virtual_pipeline_stages`` chunks, uniformly or at
the classes a ``"layer:<regex>"`` names, chunk c on stage c % S. The
reference builds every stage in its one process; here a rank builds only
its own stage's chunks. The built modules sit in ``run_function`` under
the index the reference gives them (its list of module items), so the
reference's ``run_function.<i>...`` keys carry onto the ranks that hold
them. A ``SharedLayerDesc`` layer held by several stages is made equal at
build (broadcast from its first stage) and its gradients are summed over
those stages after each batch (``sync_shared_grads``).
"""
from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch import nn

from ....communication.group import new_group
from .....nn.layer.common import LayerDict
from .....nn.layer.layers import Layer

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer"]


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, nn.Module)):
            raise TypeError("LayerDesc expects a Module subclass")
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _class_name(item):
    if isinstance(item, LayerDesc):
        return item.layer_cls.__name__
    return type(item).__name__


class PipelineLayer(Layer):
    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        from ..meta_parallel_base import _get_hcg

        hcg = _get_hcg()
        if num_stages is None:
            num_stages = hcg.num_stages if hcg is not None else 1
        self._num_stages = int(num_stages)
        self._num_virtual = int(num_virtual_pipeline_stages or 1)
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._descs = list(layers)
        self._hcg = hcg if hcg is not None and hcg.num_stages > 1 else None
        if self._hcg is not None and self._hcg.num_stages != num_stages:
            raise ValueError(
                f"num_stages {num_stages} differs from the topology's "
                f"{self._hcg.num_stages} pipeline stages")
        self._stage = self._hcg.get_stage_id() if self._hcg else None
        self._segment = self._segment_layers(
            self._descs, self._num_stages * self._num_virtual, seg_method)

        # the reference's module index of each item (its LayerList holds
        # module items only, a shared layer once per appearance)
        index, k = {}, 0
        for j, d in enumerate(self._descs):
            if isinstance(d, (LayerDesc, nn.Module)):
                index[j] = k
                k += 1
        built, shared = {}, {}
        self.run_function = LayerDict()
        for chunk, (lo, hi) in enumerate(self._segment):
            if not self.is_local_chunk(chunk):
                continue
            for j in range(lo, hi):
                d = self._descs[j]
                if isinstance(d, SharedLayerDesc):
                    layer = shared.get(d.layer_name)
                    if layer is None:
                        layer = shared[d.layer_name] = d.build_layer()
                    built[j] = ((layer, d.forward_func) if d.forward_func
                                else layer)
                elif isinstance(d, LayerDesc):
                    layer = built[j] = d.build_layer()
                elif isinstance(d, nn.Module) or callable(d):
                    layer = built[j] = d
                else:
                    raise TypeError(f"unsupported pipeline item {d!r}")
                if j in index:
                    self.run_function[str(index[j])] = layer
        self._built = built
        self._shared = shared
        self._shared_groups = self._build_shared_groups()

    # -- segmentation ------------------------------------------------------
    @staticmethod
    def _segment_layers(descs, num_chunks, seg_method):
        n = len(descs)
        if isinstance(seg_method, str) and seg_method.startswith("layer:"):
            pat = seg_method.split("layer:")[1]
            marks = [i for i, d in enumerate(descs)
                     if re.search(pat, _class_name(d))]
            if len(marks) >= num_chunks:
                per = len(marks) // num_chunks
                bounds = [0] + [marks[s * per]
                                for s in range(1, num_chunks)] + [n]
                return [(bounds[i], bounds[i + 1])
                        for i in range(num_chunks)]
        sizes = [n // num_chunks] * num_chunks
        for i in range(n % num_chunks):
            sizes[i] += 1
        out, off = [], 0
        for s in sizes:
            out.append((off, off + s))
            off += s
        return out

    # -- shared layers -----------------------------------------------------
    def _build_shared_groups(self):
        """For each shared key held by more than one stage: the group of
        those stages at this rank's other coordinates (every rank builds
        every such group, in one order), and the layer made equal."""
        if self._hcg is None:
            return {}
        stages = {}
        for chunk, (lo, hi) in enumerate(self._segment):
            for j in range(lo, hi):
                d = self._descs[j]
                if isinstance(d, SharedLayerDesc):
                    stages.setdefault(d.layer_name, set()).add(
                        self.chunk_stage(chunk))
        mine = {}
        for key, held in stages.items():
            if len(held) < 2:
                continue
            held = sorted(held)
            for lst in self._hcg.topology.get_comm_list("pipe"):
                g = new_group([lst[s] for s in held])
                if g.rank >= 0:
                    mine[key] = g
        for key, g in mine.items():
            with torch.no_grad():
                for p in self._shared[key].parameters():
                    dist.broadcast(p.data, g.ranks[0], group=g.process_group)
        return mine

    def sync_shared_grads(self):
        """Sum each shared layer's gradients over the stages holding it."""
        for key, g in self._shared_groups.items():
            for p in self._shared[key].parameters():
                if p.grad is not None:
                    dist.all_reduce(p.grad, group=g.process_group)

    # -- chunks ------------------------------------------------------------
    @property
    def num_stages(self):
        return self._num_stages

    @property
    def num_chunks(self):
        """Pipeline units (num_stages x the virtual factor)."""
        return len(self._segment)

    def chunk_stage(self, chunk):
        """The stage holding a chunk (round robin for the interleave)."""
        return chunk % self._num_stages

    def is_local_chunk(self, chunk):
        return self._stage is None or self.chunk_stage(chunk) == self._stage

    def get_stage_items(self, chunk):
        """The built items of ``chunk`` (one of this rank's)."""
        if not self.is_local_chunk(chunk):
            raise ValueError(f"chunk {chunk} is not built on this rank")
        lo, hi = self._segment[chunk]
        return [self._built[j] for j in range(lo, hi)]

    @property
    def loss_fn(self):
        return self._loss_fn

    def forward_stage(self, x, chunk):
        from ..pp_utils.utils import run_items

        return run_items(self.get_stage_items(chunk), x,
                         self._recompute_interval)

    def forward(self, *args):
        """The whole model in one process (serial, no pipeline)."""
        if self._hcg is not None:
            raise RuntimeError(
                "a PipelineLayer over several stages runs through "
                "fleet.distributed_model(...).train_batch / eval_batch")
        x = args if len(args) > 1 else args[0]
        for chunk in range(self.num_chunks):
            x = self.forward_stage(x, chunk)
        return x
