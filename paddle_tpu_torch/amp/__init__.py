"""Automatic mixed precision (counterpart of ``paddle_tpu/amp``):
``auto_cast`` / ``amp_guard``, ``decorate``, ``GradScaler`` and
``amp_state``.

``auto_cast`` flips a global mode that the port's op entry points read.
O1 casts the white-listed ops (the tensor-core products: ``linear``,
``matmul``, attention) to the amp dtype and keeps the black-listed ones
(norms, softmax, losses) in f32; O2 casts every op but the black list.
The reference casts at its one dispatch seam, for every op it runs; the
port has no such seam, so :func:`cast_inputs_for_op` is called at the
entry points of the ops the Llama path reaches: ``Linear`` and
``F.linear`` (``linear``), ``F.matmul`` (``matmul``), ``Embedding``
(``embedding``), ``F.scaled_dot_product_attention`` /
``F.flash_attention`` / ``F.sliding_window_attention``, ``F.rms_norm``,
``F.softmax`` and the losses (``F.cross_entropy`` ...), each under the
reference's op name. Elementwise ops (adds, products, ``silu``) are not seams: they
follow torch's type promotion, which under O1 gives the reference's
result (its elementwise ops are on neither list) and under O2 does so for
a model whose weights ``decorate`` cast. With amp off a seam is one
attribute read (``amp_state.enabled``).

This is not ``torch.autocast``: its op lists are not the reference's and
it takes no custom lists. The lists below are a copy of the reference's.
"""
from __future__ import annotations

import warnings

import torch

from ..core.dtype import one_of

__all__ = ["auto_cast", "amp_guard", "GradScaler", "decorate", "amp_state",
           "cast_inputs_for_op", "WHITE_LIST", "BLACK_LIST"]

WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum",
    "addmm", "flash_attention", "scaled_dot_product_attention",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "softmax", "log_softmax", "cross_entropy", "softmax_with_cross_entropy",
    "layer_norm", "batch_norm", "instance_norm", "group_norm", "rms_norm",
    "mean", "sum", "cumsum", "logsumexp", "norm", "dist", "cosine_similarity",
    "sigmoid_focal_loss", "bce", "bce_with_logits", "kl_div", "nll_loss",
    "mse_loss", "l1_loss", "smooth_l1",
}
# the op names the port's seams pass (besides the two lists)
SEAM_OPS = {"linear", "matmul", "embedding", "scaled_dot_product_attention",
            "flash_attention", "sliding_window_attention", "rms_norm",
            "layer_norm", "softmax", "cross_entropy"}

_DTYPES = (torch.float16, torch.bfloat16, torch.float32)


def _dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = one_of(str(dtype), _DTYPES)
    if dt is None:
        raise ValueError(f"unsupported amp dtype {dtype!r}")
    return dt


class _AmpState:
    enabled = False
    dtype = torch.float16
    level = "O1"
    custom_white: set = set()
    custom_black: set = set()


amp_state = _AmpState()


def _known_op_names():
    """The op registry's names and their bare forms (``functional.relu``
    also as ``relu``), the op names run so far, the lists and the port's
    seam names, as the reference checks its registry: a custom list entry
    outside them never matches."""
    from ..core.dispatch import OP_REGISTRY, SEAM_OPS as RUN

    names = set(OP_REGISTRY) | RUN
    names.update(n.rsplit(".", 1)[-1] for n in OP_REGISTRY)
    return names | WHITE_LIST | BLACK_LIST | SEAM_OPS


def cast_inputs_for_op(op_name, *tensors):
    """The inputs of op ``op_name`` under the current amp mode, as a list:
    floating tensors cast by the reference's rules (O2: the black list to
    f32, everything else to the amp dtype; O1: the white list to the amp
    dtype, the black list to f32, the rest untouched); other values pass
    through. A custom white entry overrides the black list. Callers read
    ``amp_state.enabled`` first."""
    st = amp_state
    white = op_name in WHITE_LIST or op_name in st.custom_white
    black = (op_name in BLACK_LIST or op_name in st.custom_black) and \
        op_name not in st.custom_white
    if st.level == "O2":
        to = torch.float32 if black else st.dtype
    elif white:
        to = st.dtype
    elif black:
        to = torch.float32
    else:
        return list(tensors)
    return [t.to(to) if isinstance(t, torch.Tensor) and t.is_floating_point()
            else t for t in tensors]


class auto_cast:
    """``paddle.amp.auto_cast``: a context manager that sets the amp mode
    (``level`` O1 or O2, ``dtype`` float16 or bfloat16, custom white and
    black lists) and restores the previous one on exit. A custom list
    name the port does not know warns (``RuntimeWarning``), as the
    reference warns for names outside its op registry."""

    def __init__(self, enable=True, custom_white_list=None,
                 custom_black_list=None, level="O1", dtype="float16",
                 use_promote=True):
        self._enable = enable
        self._white = set(custom_white_list or ())
        self._black = set(custom_black_list or ())
        self._level = level
        self._dtype = _dtype(dtype)
        unknown = ((self._white | self._black) - _known_op_names()
                   if (self._white or self._black) else ())
        if unknown:
            warnings.warn(
                f"auto_cast: op names not (yet) in the op registry: "
                f"{sorted(unknown)}. A dispatch-seam op name will still "
                f"match once that op runs; the port's seams are "
                f"{sorted(SEAM_OPS)}.", RuntimeWarning)

    def __enter__(self):
        self._saved = (amp_state.enabled, amp_state.dtype, amp_state.level,
                       amp_state.custom_white, amp_state.custom_black)
        amp_state.enabled = self._enable
        amp_state.dtype = self._dtype
        amp_state.level = self._level
        amp_state.custom_white = self._white
        amp_state.custom_black = self._black
        return self

    def __exit__(self, *exc):
        (amp_state.enabled, amp_state.dtype, amp_state.level,
         amp_state.custom_white, amp_state.custom_black) = self._saved
        return False


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="float16",
             master_weight=None, save_dtype=None):
    """``paddle.amp.decorate``: at O2 every floating parameter and buffer
    of each model is cast to ``dtype`` in place (``model.to(dtype)``).
    Returns ``models``, or ``(models, optimizers)`` when optimizers are
    given (an optimizer keeps f32 masters of low-precision parameters
    with ``multi_precision=True``)."""
    single = not isinstance(models, (list, tuple))
    if level == "O2":
        for m in [models] if single else models:
            m.to(_dtype(dtype))
    if optimizers is None:
        return models
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling, the reference's arithmetic: ``scale(loss)``
    multiplies by the scale; ``unscale_`` multiplies every gradient of the
    optimizer's parameters by ``1 / scale`` in place and checks them for
    inf / NaN; ``step`` skips the optimizer's update when one is found;
    ``update`` halves the scale (``decr_ratio``, not below 1) after
    ``decr_every_n_nan_or_inf`` bad steps in a row and doubles it
    (``incr_ratio``) after ``incr_every_n_steps`` good ones.

    The reference reads each gradient's finiteness on the host, one sync a
    gradient. The port stacks one flag a gradient on the device and reads
    their conjunction once: one host sync a step, the same result."""

    def __init__(self, enable=True, init_loss_scaling=2.0**15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = float(init_loss_scaling) if enable else 1.0
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._unscaled = False  # set by unscale_, cleared by step

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    @torch.no_grad()
    def unscale_(self, optimizer):
        if not self._enable or self._unscaled:
            return
        self._unscaled = True
        grads = [p.grad for p in optimizer._parameter_list
                 if p.grad is not None]
        inv = 1.0 / self._scale
        for g in grads:
            g.mul_(inv)
        self._found_inf = bool(grads) and not bool(
            torch.stack([torch.isfinite(g).all() for g in grads]).all())

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)  # a no-op if the caller already unscaled
        self._unscaled = False
        if not self._found_inf:
            optimizer.step()

    def update(self):
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._bad_steps += 1
            self._good_steps = 0
            if self._bad_steps >= self._decr_every:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._good_steps += 1
            self._bad_steps = 0
            if self._good_steps >= self._incr_every:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()
        optimizer.clear_grad()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return torch.tensor(self._scale, dtype=torch.float32)

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "incr_count": self._good_steps,
                "decr_count": self._bad_steps}

    def load_state_dict(self, state):
        self._scale = state.get("scale", self._scale)
        self._good_steps = state.get("incr_count", 0)
        self._bad_steps = state.get("decr_count", 0)
