"""``paddle.summary`` / ``paddle.flops`` of the port (counterpart of
``paddle_tpu/hapi/summary.py``).

``summary`` prints each parameter's shape and count and returns the
total and trainable counts. ``flops`` counts the floating-point
operations of one forward at ``input_size`` by the rules the reference's
number comes from (XLA's cost analysis of the compiled forward): a
product of (M, K) by (K, N) is 2MKN; a convolution is 2 x batch x
output channels x input channels per group x the taps that land inside
the unpadded input, summed over output positions; an elementwise op is
one per output element (a bias add included); a max or average pool is
(taps inside the input - 1) per output element; a reduction is one per
input element less one per output; views, copies and index ops are
free (padding included). The ops are counted at PyTorch's dispatch (a ``TorchDispatchMode``
over the forward, run on the network's device).
"""
from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["summary", "flops"]


def summary(net, input_size=None, dtypes=None, input=None):  # noqa: A002
    rows = []
    total_params = 0
    trainable_params = 0
    for name, p in net.named_parameters():
        n = p.numel()
        total_params += n
        if p.requires_grad:
            trainable_params += n
        rows.append((name, tuple(p.shape), n))
    width = max((len(r[0]) for r in rows), default=20) + 2
    print("-" * (width + 36))
    print(f"{'Param':<{width}}{'Shape':<22}{'Count':>12}")
    print("-" * (width + 36))
    for name, shape, n in rows:
        print(f"{name:<{width}}{str(shape):<22}{n:>12,}")
    print("-" * (width + 36))
    print(f"Total params: {total_params:,}")
    print(f"Trainable params: {trainable_params:,}")
    print(f"Non-trainable params: {total_params - trainable_params:,}")
    return {"total_params": total_params,
            "trainable_params": trainable_params}


def _valid_taps(n_in, n_out, k, stride, pad, dil):
    """Sum over the output positions of the window taps that land inside
    the unpadded input (one spatial dim)."""
    total = 0
    for o in range(n_out):
        start = o * stride - pad
        total += sum(1 for j in range(k) if 0 <= start + j * dil < n_in)
    return total


def _tuple(v, n):
    return tuple(v) * (n // len(v)) if len(v) != n else tuple(v)


def _conv_flops(args, out):
    x, w = args[0], args[1]
    stride, padding, dilation = args[3], args[4], args[5]
    transposed = args[6]
    if transposed:  # every input element meets every tap
        return 2 * x.numel() * w.shape[1] * math.prod(w.shape[2:])
    nd = w.dim() - 2
    stride, padding, dilation = (_tuple(stride, nd), _tuple(padding, nd),
                                 _tuple(dilation, nd))
    taps = 1
    for d in range(nd):
        taps *= _valid_taps(x.shape[2 + d], out.shape[2 + d], w.shape[2 + d],
                            stride[d], padding[d], dilation[d])
    n = 2 * x.shape[0] * w.shape[0] * w.shape[1] * taps
    if len(args) > 2 and args[2] is not None:
        n += out.numel()
    return n


def _pool_flops(name, args, out):
    """A pool: (taps inside the input - 1) per output element for max
    (its comparisons), taps per output element for average (the adds and
    the divide)."""
    x, kernel = args[0], args[1]
    nd = int(name.split("pool")[1][0])
    kernel = _tuple(kernel, nd)
    stride = _tuple(args[2], nd) if len(args) > 2 and args[2] else kernel
    padding = _tuple(args[3], nd) if len(args) > 3 else (0,) * nd
    dilation = (_tuple(args[4], nd) if name.startswith("max")
                and len(args) > 4 else (1,) * nd)
    spatial_in, spatial_out = x.shape[-nd:], out.shape[-nd:]
    taps = math.prod(_valid_taps(spatial_in[d], spatial_out[d], kernel[d],
                                 stride[d], padding[d], dilation[d])
                     for d in range(nd))
    lead = out.numel() // math.prod(spatial_out)
    if name.startswith("max"):
        return lead * taps - out.numel()
    return lead * taps


_FREE = {"view", "_unsafe_view", "reshape", "t", "transpose", "permute",
         "expand", "clone", "contiguous", "detach", "alias", "squeeze",
         "unsqueeze", "select", "slice", "index_select", "embedding",
         "cat", "stack", "copy_", "_to_copy", "empty", "zeros", "ones",
         "full", "arange", "split", "unbind", "flatten", "lift_fresh",
         "new_zeros", "new_empty", "zeros_like", "ones_like", "empty_like",
         "as_strided", "gather", "index", "scalar_tensor", "_reshape_alias",
         "constant_pad_nd", "pad", "max_pool2d_with_indices_backward"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "var",
           "std", "argmax", "argmin"}


def _op_flops(func, args, kwargs, out):
    name = func.overloadpacket.__name__
    if name in _FREE:
        return 0
    if name in ("mm", "bmm", "matmul"):
        a, b = args[0], args[1]
        return 2 * math.prod(a.shape) * b.shape[-1]
    if name == "addmm":
        a, b = args[1], args[2]
        return 2 * a.shape[0] * a.shape[1] * b.shape[1] + out.numel()
    if name in ("convolution", "_convolution"):
        return _conv_flops(args, out)
    if name.startswith(("max_pool", "avg_pool")):
        first = out[0] if isinstance(out, (tuple, list)) else out
        return _pool_flops(name, args, first)
    if name in _REDUCE:
        first = out[0] if isinstance(out, (tuple, list)) else out
        return args[0].numel() - first.numel()
    first = out[0] if isinstance(out, (tuple, list)) else out
    return first.numel() if isinstance(first, torch.Tensor) else 0


class _FlopCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0
        self.by_op = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        n = int(_op_flops(func, args, kwargs or {}, out))
        if n:
            name = func.overloadpacket.__name__
            self.by_op[name] = self.by_op.get(name, 0) + n
            self.total += n
        return out


def flops(net, input_size, custom_ops=None, print_detail=False):
    """Floating-point operations of one forward of ``net`` (put in eval
    mode, as the reference does) on an f32 zero input of ``input_size``,
    on the network's device."""
    p = next(net.parameters(), None)
    device = p.device if p is not None else torch.device("cpu")
    x = torch.zeros(input_size, dtype=torch.float32, device=device)
    net.eval()
    counter = _FlopCount()
    with torch.no_grad(), counter:
        net(x)
    if print_detail:
        for name, n in sorted(counter.by_op.items(), key=lambda kv: -kv[1]):
            print(f"{name:<24}{n:>16,}")
    return counter.total
