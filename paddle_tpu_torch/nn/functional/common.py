"""Products and lookups with amp's cast seam (counterpart of the
reference's ``linear`` in ``paddle_tpu/nn/functional/common.py`` and
``matmul`` in ``paddle_tpu/tensor/linalg.py``), and the reference's
resampling and layout functionals of the same file: ``interpolate`` /
``upsample``, ``pixel_shuffle`` / ``pixel_unshuffle``,
``channel_shuffle``, ``zeropad2d`` and ``pad`` (from
``paddle_tpu/tensor/manipulation.py``), the dropouts, the similarity and
distance functionals, ``fold`` / ``unfold``, ``affine_grid`` /
``grid_sample`` and the sequence helpers.

Inputs of one dtype take PyTorch's own product. Mixed dtypes (a bf16
base weight and f32 LoRA factors outside amp) follow the reference: the
product runs in the promoted dtype and, when the left operand is bf16 or
fp16, comes back in that dtype (the reference's f32-accumulated product
cast to the input's dtype); a bias is then added in the output's dtype.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ... import amp
from ...amp import amp_state
from ...core.dtype import to_torch_dtype
from ...tensor.creation import one_hot  # noqa: F401  (re-exported)
from ...tensor.manipulation import paddings4
from ...tensor.manipulation import unfold  # noqa: F401  (re-exported)

__all__ = ["linear", "matmul", "embedding", "dropout", "interpolate",
           "upsample", "pixel_shuffle", "pixel_unshuffle", "channel_shuffle",
           "zeropad2d", "pad", "one_hot", "dropout2d", "dropout3d",
           "alpha_dropout", "cosine_similarity", "label_smooth", "bilinear",
           "unfold", "fold", "temporal_shift", "class_center_sample",
           "affine_grid", "grid_sample", "pairwise_distance",
           "sequence_mask", "gather_tree"]

_HALF = (torch.bfloat16, torch.float16)


def _mixed(op, x, y):
    """``op(x, y)`` of two floating tensors of different dtypes, the
    reference's way."""
    common = torch.promote_types(x.dtype, y.dtype)
    out = op(x.to(common), y.to(common))
    return out.to(x.dtype) if x.dtype in _HALF else out


def torch_linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with weight (out, in), torch's layout: the
    product of the port's ``Linear`` (op name ``linear``)."""
    if amp_state.enabled:
        x, weight, bias = amp.cast_inputs_for_op("linear", x, weight, bias)
    if x.dtype == weight.dtype and (bias is None or bias.dtype == x.dtype):
        return torch.nn.functional.linear(x, weight, bias)
    out = (_mixed(torch.nn.functional.linear, x, weight)
           if x.dtype != weight.dtype
           else torch.nn.functional.linear(x, weight))
    return out if bias is None else out + bias.to(out.dtype)


def linear(x, weight, bias=None, name=None):
    """``x @ weight + bias`` with weight (in, out), paddle's layout."""
    return torch_linear(x, weight.t(), bias)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    """``paddle.matmul``: ``x @ y``, either operand's last two dims swapped
    first on request."""
    if amp_state.enabled:
        x, y = amp.cast_inputs_for_op("matmul", x, y)
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    if x.dtype == y.dtype:
        return torch.matmul(x, y)
    return _mixed(torch.matmul, x, y)


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows ``weight[x]`` (op name ``embedding``); ``padding_idx`` rows
    get no gradient."""
    if amp_state.enabled:
        (weight,) = amp.cast_inputs_for_op("embedding", weight)
    return torch.nn.functional.embedding(x, weight, padding_idx,
                                         sparse=sparse)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None, generator=None):
    """``paddle.nn.functional.dropout``: in training, zero each element
    (or, with ``axis``, each slice along those axes) with probability
    ``p``, the keep mask drawn from ``generator`` (a ``torch.Generator``
    on x's device; the global one when omitted); ``upscale_in_train``
    divides the kept values by ``1 - p``. Outside training it is the
    identity, or a scale by ``1 - p`` under ``downscale_in_infer``. The
    draws are PyTorch's, not the reference's JAX keys."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unsupported dropout mode {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1.0 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = {a % x.dim() for a in
                ((axis,) if isinstance(axis, int) else tuple(axis))}
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``paddle.nn.functional.pad``: ``pad`` of length 2 * ndim pads every
    dim, first dim first; a shorter one pads the trailing spatial dims
    (the ones before the channel under ``N...C``), first spatial dim
    first. Modes ``constant``, ``reflect``, ``replicate``, ``circular``."""
    pad = [int(p) for p in (pad.tolist() if isinstance(pad, torch.Tensor)
                            else pad)]
    nd = x.dim()
    widths = [(0, 0)] * nd
    if len(pad) == 2 * nd:
        widths = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        n_sp = len(pad) // 2
        dims = (range(1, 1 + n_sp) if data_format.endswith("C")
                else range(nd - n_sp, nd))
        for i, d in enumerate(dims):
            widths[d] = (pad[2 * i], pad[2 * i + 1])
    last = max((d for d, w in enumerate(widths) if w != (0, 0)), default=-1)
    flat = []
    for lo, hi in reversed(widths[:last + 1]):
        flat += [lo, hi]
    if not flat:
        return x
    if mode == "constant":
        return torch.nn.functional.pad(x, flat, value=value)
    return _pad_edges(x, widths, mode)


def _pad_edges(x, widths, mode):
    """reflect / replicate / circular on any dims, one dim at a time
    (torch's own pads these only on the trailing dims of 2-5-D input)."""
    for d, (lo, hi) in enumerate(widths):
        if lo == 0 and hi == 0:
            continue
        n = x.shape[d]
        i = torch.arange(-lo, n + hi, device=x.device)
        if mode == "replicate":
            i = i.clamp(0, n - 1)
        elif mode == "circular":
            i = i % n
        elif mode == "reflect":
            period = max(2 * (n - 1), 1)
            i = i.abs() % period
            i = torch.where(i >= n, period - i, i)
        else:
            raise ValueError(f"unsupported pad mode {mode!r}")
        x = x.index_select(d, i)
    return x


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero padding ``[left, right, top, bottom]`` of the two spatial
    dims."""
    left, right, top, bottom = (int(v) for v in padding)
    if data_format == "NCHW":
        return torch.nn.functional.pad(x, (left, right, top, bottom))
    return torch.nn.functional.pad(x, (0, 0, left, right, top, bottom))


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        n, c, h, w = x.shape
        v = x.reshape(n, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return v.reshape(n, c // (r * r), h * r, w * r)
    n, h, w, c = x.shape
    v = x.reshape(n, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return v.reshape(n, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    n, c, h, w = x.shape
    v = x.reshape(n, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
    return v.reshape(n, c * r * r, h // r, w // r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    n, c, h, w = x.shape
    return x.reshape(n, groups, c // groups, h, w).transpose(1, 2).reshape(
        n, c, h, w)


def _keys_cubic(d):
    out = ((1.5 * d - 2.5) * d) * d + 1.0
    out = np.where(d >= 1.0, ((-0.5 * d + 2.5) * d - 4.0) * d + 2.0, out)
    return np.where(d >= 2.0, 0.0, out)


_KERNELS = {"linear": lambda d: np.maximum(0, 1 - np.abs(d)),
            "cubic": _keys_cubic}


def _resize_weights(n_in, n_out, kernel):
    """(n_in, n_out) weights of ``jax.image.resize`` along one axis
    (``scale_and_translate`` with antialiasing: the kernel widens by the
    downsampling factor), in f32 as jax forms them."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(n_out / n_in)
    kernel_scale = max(inv_scale, f32(1.0))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5)).astype(f32)
    d = (np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = _KERNELS[kernel](d).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0).astype(f32)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(f32)


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resampling of the spatial dims as the reference defines it:
    ``nearest`` takes source ``floor(i * in / out)`` (f32); linear modes
    with ``align_corners`` interpolate between ``floor(pos)`` and the next
    sample at ``pos = i * (in - 1) / (out - 1)``; otherwise ``bilinear``,
    ``linear``, ``trilinear`` and ``area`` are ``jax.image.resize``'s
    linear (half-pixel centres, antialiased when shrinking) and
    ``bicubic`` its Keys cubic, as per-axis weight matrices."""
    channels_last = not data_format.startswith("NC")
    n_sp = x.dim() - 2
    first = 1 if channels_last else 2
    in_sp = tuple(x.shape[first:first + n_sp])
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        out_sp = tuple(int(s) for s in (size if isinstance(size, (list,
                                                                  tuple))
                                        else [size]))
    else:
        sf = (scale_factor if isinstance(scale_factor, (list, tuple))
              else [scale_factor] * n_sp)
        out_sp = tuple(int(d * f) for d, f in zip(in_sp, sf))
    method = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
              "trilinear": "linear", "bicubic": "cubic",
              "area": "linear"}[mode]
    out = x
    for d, (n_in, n_out) in enumerate(zip(in_sp, out_sp)):
        ax = first + d
        if method == "nearest":
            src = np.floor(np.arange(n_out).astype(np.float32)
                           * np.float32(n_in / n_out)).astype(np.int64)
            idx = torch.from_numpy(np.clip(src, 0, n_in - 1)).to(x.device)
            out = out.index_select(ax, idx)
        elif align_corners:
            out = _align_corners(out, ax, n_in, n_out)
        elif n_in != n_out:
            w = torch.from_numpy(_resize_weights(n_in, n_out, method)).to(
                device=x.device, dtype=x.dtype)
            out = torch.tensordot(out, w, dims=([ax], [0])).movedim(-1, ax)
    return out


def _align_corners(x, ax, n_in, n_out):
    if n_out == 1 or n_in == 1:
        pos = np.zeros(n_out, np.float32)
    else:
        pos = (np.arange(n_out) * (n_in - 1)).astype(np.float32) \
            / np.float32(n_out - 1)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    shape = [1] * x.dim()
    shape[ax] = -1
    t = torch.from_numpy((pos - lo).astype(np.float32)).to(
        device=x.device, dtype=x.dtype).reshape(shape)
    lo_t = torch.from_numpy(lo).to(x.device)
    hi_t = torch.from_numpy(hi).to(x.device)
    return (x.index_select(ax, lo_t) * (1 - t)
            + x.index_select(ax, hi_t) * t)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None,
              generator=None):
    """Drop whole channels of 4-D input: one keep draw per (sample,
    channel), broadcast over the spatial dims."""
    keep = (0, 1) if data_format == "NCHW" else (0, 3)
    return dropout(x, p, axis=keep, training=training, generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None,
              generator=None):
    """Drop whole channels of 5-D input (:func:`dropout2d`'s rule)."""
    keep = (0, 1) if data_format == "NCDHW" else (0, 4)
    return dropout(x, p, axis=keep, training=training, generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, generator=None):
    """Dropout that keeps SELU's self-normalizing mean and variance: a
    dropped element takes SELU's negative saturation value, then the
    result is scaled and shifted back to unit variance and zero mean."""
    if not training or p == 0.0:
        return x
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    a = 1.0 / ((1 - p) * (1 + p * alpha_p ** 2)) ** 0.5
    b = -a * alpha_p * p
    return (a * torch.where(keep, x, alpha_p) + b).to(x.dtype)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``sum(x1 * x2) / max(|x1| * |x2|, eps)`` along ``axis``."""
    dot = (x1 * x2).sum(dim=axis)
    norms = (torch.linalg.vector_norm(x1, dim=axis)
             * torch.linalg.vector_norm(x2, dim=axis))
    return dot / torch.clamp(norms, min=eps)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) * label + epsilon * prior`` (a uniform prior over
    the last dim when ``prior_dist`` is None)."""
    if prior_dist is None:
        return (1 - epsilon) * label + epsilon / label.shape[-1]
    return (1 - epsilon) * label + epsilon * prior_dist


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] @ weight[o] @ x2[b] (+ bias[o])``, weight
    (out, in1, in2)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the inverse of :func:`unfold`: (N, C * kh * kw, L) ->
    (N, C, H, W), overlapping taps summed. The columns are folded onto
    the padded plane and the padding cut away after."""
    oh, ow = _pair(output_sizes)
    top, bottom, left, right = paddings4(paddings)
    out = torch.nn.functional.fold(
        x, (oh + top + bottom, ow + left + right), _pair(kernel_sizes),
        dilation=_pair(dilations), padding=0, stride=_pair(strides))
    return out[:, :, top:top + oh, left:left + ow]


def class_center_sample(label, num_classes, num_samples, group=None,
                        generator=None):
    """PLSC's margin-softmax helper: keep every class present in
    ``label``, top up with classes drawn uniformly without replacement
    from the rest until ``num_samples`` are kept, and map ``label`` into
    the kept classes' index space. Returns ``(remapped_label,
    sampled_class_center)``: the positives ascending, then the drawn
    negatives. The output's size depends on the data, so it runs
    eagerly, as the reference's. The draws are torch's (``generator``,
    else the global one), not the reference's JAX keys. The reference
    ignores ``group`` (it samples on one process); the port refuses any
    other value than None rather than ignore it."""
    if group is not None:
        raise NotImplementedError(
            "class_center_sample: group= is not ported (the reference "
            "ignores it and samples on one process)")
    lab = label.reshape(-1).long()
    pos = torch.unique(lab)
    if pos.numel() >= num_samples:
        sampled = pos
    else:
        present = torch.zeros(num_classes, dtype=torch.bool,
                              device=lab.device)
        present[pos] = True
        pool = torch.nonzero(~present).reshape(-1)
        order = torch.randperm(pool.numel(), generator=generator,
                               device="cpu").to(lab.device)
        sampled = torch.cat([pos, pool[order[:num_samples - pos.numel()]]])
    remap = torch.full((num_classes,), -1, dtype=torch.int64,
                       device=lab.device)
    remap[sampled] = torch.arange(sampled.numel(), device=lab.device)
    return remap[lab].reshape(label.shape), sampled.to(label.dtype)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    """TSM's shift of (N * T, C, H, W) over its T segments: the first
    ``C * shift_ratio`` channels take the next segment's values, the next
    as many the previous segment's (zeros at the ends), the rest stay."""
    nt, c, h, w = x.shape
    v = x.reshape(nt // seg_num, seg_num, c, h, w)
    k = int(c * shift_ratio)
    zeros = torch.zeros_like(v[:, :1, :k])
    left = torch.cat([v[:, 1:, :k], zeros], dim=1)
    right = torch.cat([torch.zeros_like(v[:, :1, k:2 * k]),
                       v[:, :-1, k:2 * k]], dim=1)
    return torch.cat([left, right, v[:, :, 2 * k:]], dim=2).reshape(
        nt, c, h, w)


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The 2-D sampling grid of affine maps: theta (N, 2, 3) ->
    (N, H, W, 2) f32 normalized (x, y) coordinates, ``out_shape`` (N, C,
    H, W)."""
    if isinstance(out_shape, torch.Tensor):
        out_shape = out_shape.tolist()
    _, _, h, w = (int(s) for s in out_shape)

    def coords(size):
        if align_corners:
            return torch.linspace(-1.0, 1.0, size, device=theta.device)
        step = 2.0 / size
        return torch.linspace(-1.0 + step / 2, 1.0 - step / 2, size,
                              device=theta.device)

    gy, gx = torch.meshgrid(coords(h), coords(w), indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    return torch.einsum("nij,hwj->nhwi", theta.float(), base)


def _reflect(v, lo, hi):
    """Triangular-wave reflection into [lo, hi]: values inside are fixed
    points."""
    span = hi - lo
    if span <= 0:
        return torch.zeros_like(v)
    return span - torch.abs(torch.remainder(v - lo, 2 * span) - span) + lo


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample (N, C, H, W) features at the grid's (N, Hg, Wg, 2)
    normalized (x, y) locations. ``bilinear`` blends the four neighbours
    by their f32 weights, ``nearest`` takes the rounded one (half to
    even). Out-of-range taps read zeros (``zeros``), the nearest edge
    (``border``), or are reflected into range first (``reflection``:
    about the edge pixels' centres with ``align_corners``, about their
    outer edges without). Differentiable in ``x`` and ``grid``."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unsupported mode {mode!r}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unsupported padding_mode {padding_mode!r}")
    n, c, h, w = x.shape
    gx, gy = grid[..., 0].float(), grid[..., 1].float()
    if align_corners:
        fx, fy = (gx + 1) * (w - 1) / 2, (gy + 1) * (h - 1) / 2
    else:
        fx, fy = ((gx + 1) * w - 1) / 2, ((gy + 1) * h - 1) / 2
    if padding_mode == "reflection":
        if align_corners:
            fx, fy = _reflect(fx, 0.0, w - 1.0), _reflect(fy, 0.0, h - 1.0)
        else:
            fx, fy = _reflect(fx, -0.5, w - 0.5), _reflect(fy, -0.5, h - 0.5)
    flat = x.reshape(n, c, h * w)
    hg, wg = fx.shape[1], fx.shape[2]

    def tap(iy, ix):
        iyc, ixc = iy.clamp(0, h - 1), ix.clamp(0, w - 1)
        idx = (iyc * w + ixc).long().reshape(n, 1, hg * wg)
        out = flat.gather(2, idx.expand(n, c, hg * wg))
        if padding_mode == "zeros":
            valid = (iy >= 0) & (iy <= h - 1) & (ix >= 0) & (ix <= w - 1)
            out = out * valid.reshape(n, 1, hg * wg)
        return out

    if mode == "nearest":
        out = tap(torch.round(fy), torch.round(fx))
    else:
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx = (fx - x0).reshape(n, 1, hg * wg)
        wy = (fy - y0).reshape(n, 1, hg * wg)
        out = ((1 - wy) * ((1 - wx) * tap(y0, x0) + wx * tap(y0, x0 + 1))
               + wy * ((1 - wx) * tap(y0 + 1, x0)
                       + wx * tap(y0 + 1, x0 + 1)))
    return out.reshape(n, c, hg, wg).to(x.dtype)


def pairwise_distance(x, y, p=2.0, epsilon=1e-6, keepdim=False, name=None):
    """The p-norm of ``x - y + epsilon`` over the last dim (the max of its
    magnitudes for p = inf)."""
    d = torch.abs(x - y + epsilon)
    if math.isinf(p):
        return d.amax(dim=-1, keepdim=keepdim)
    return torch.pow(torch.pow(d, p).sum(dim=-1, keepdim=keepdim), 1.0 / p)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths (...) -> (..., maxlen) mask, position < length. Without
    ``maxlen`` the longest length is read from ``x`` (a host sync, and
    under a trace a value the graph depends on, as the reference
    refuses it while tracing)."""
    if maxlen is None:
        if torch.compiler.is_compiling():
            raise ValueError(
                "sequence_mask(maxlen=None) needs the max length as a host "
                "value, which is unavailable while tracing (to_static / "
                "jit). Pass an explicit maxlen.")
        maxlen = int(x.max()) if x.numel() else 0
    pos = torch.arange(int(maxlen), device=x.device, dtype=x.dtype)
    return (pos < x[..., None]).to(to_torch_dtype(dtype))


def gather_tree(ids, parents, name=None):
    """Back-trace beam search's parent pointers: ids and parents (T, B,
    W) -> the full token sequences (T, B, W) of the W final beams."""
    steps, _, width = ids.shape
    beam = torch.arange(width, device=ids.device,
                        dtype=torch.int64).expand(ids.shape[1:])
    out = []
    for t in range(steps - 1, -1, -1):
        out.append(ids[t].gather(1, beam))
        beam = parents[t].gather(1, beam).long()
    return torch.stack(out[::-1])
