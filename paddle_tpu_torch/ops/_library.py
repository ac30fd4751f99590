"""Build, load and account for the hand-written Hopper kernels.

The CUDA sources under ``paddle_tpu_torch/csrc/`` expose a plain C
interface. They are compiled with ``nvcc`` for ``sm_90a`` at first use,
one ``nvcc`` process per source started together, linked into one
shared library under ``build/paddle_tpu_torch/`` at the repository root,
and loaded with ``ctypes``. The library's file name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads straight away.

K1 / K6, K3 / K8 and K4 / K7 are ``torch.library`` custom ops in the
``paddle_tpu_torch::`` namespace (:func:`custom_op`): their CUDA
implementation launches the kernel, their CPU implementation is the plain
version, and a fake implementation gives their output shapes, so
TorchDynamo and ``torch.export`` trace through them (``jit.to_static``,
``jit.save``). An eager call runs the CUDA implementation directly
(:func:`route`), without the dispatcher's host cost. K2 and K5 stay
direct calls and refuse to be traced (:func:`refuse_trace`). Each
kernel's CUDA implementation adds one to its entry in :data:`LAUNCHES`
where it launches the kernel, and nowhere else, so a compiled graph
counts its real launches, not its traces. :func:`plain_versions` is the
explicit switch that makes the wrappers run their plain PyTorch versions
on CUDA tensors too; only tests and ``chip_smoke.py`` set it, to compare
the two paths end to end. It is never a fallback: a kernel that fails to build
or launch raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor

from . import split_decode as sd

__all__ = ["LAUNCHES", "reset_launches", "plain_versions", "use_plain",
           "route", "refuse_grad", "refuse_trace", "custom_op",
           "library", "check_status", "cuda_stream", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
SOURCES = ("rms_norm.cu", "paged_attention.cu", "varlen_flash_attention.cu",
           "decode_attention.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "varlen_flash_attention_bwd.cu")
HEADERS = ("common.cuh", "split_decode.cuh", "flash_f32.cuh", "flash_mma.cuh",
           "varlen_seg.cuh", "wgmma.cuh", "tma.cuh", "bwd_fused.cuh",
           "bwd_f32.cuh", "tf32x3.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"rms_norm": 0, "paged_decode_attention": 0,
            "paged_decode_attention_int8": 0,
            "paged_decode_attention_int8_rows": 0,
            "paged_decode_attention_scaled": 0,
            "varlen_flash_attention": 0, "varlen_flash_attention_f32": 0,
            "flash_attention": 0, "flash_attention_f32": 0,
            "flash_attention_f16": 0,
            "decode_attention": 0, "rms_norm_bwd": 0,
            "flash_attention_bwd": 0, "flash_attention_bwd_f32": 0,
            "flash_attention_bwd_f16": 0,
            "varlen_flash_attention_bwd": 0,
            "varlen_flash_attention_bwd_f32": 0}

_plain = False
_lib = None
_lib_lock = threading.Lock()
# what this process's build printed (the ptxas register / shared-memory
# report), which chip_smoke.py prints; empty when the library was cached
BUILD_INFO = {"log": "", "built": False}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def plain_versions():
    """Run the plain PyTorch versions on CUDA tensors inside the block
    (the kernel-vs-plain end-to-end comparison)."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def use_plain(t: torch.Tensor) -> bool:
    """True when a wrapper must run its plain version: the tensor lies on
    the CPU, or :func:`plain_versions` is active."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return _plain


def route(t: torch.Tensor, *tensors) -> str:
    """How a wrapper of a custom-op kernel runs on ``t`` (and the other
    inputs): ``"op"`` while TorchDynamo or ``torch.export`` traces it (a
    fake tensor, or Dynamo compiling), so the graph holds the op;
    otherwise ``"kernel"``, a direct call of the op's CUDA implementation
    (eager calls skip the dispatcher's host cost; the launch and its
    count are the same), or ``"plain"``: CPU tensors, and
    :func:`plain_versions` on the card. A traced call takes ``"plain"``
    too where autograd must see through it (on CPU tensors that require
    grad: the ops carry no autograd formula, their autograd Functions do)
    or inside :func:`plain_versions`."""
    if torch.compiler.is_compiling() or isinstance(t, FakeTensor):
        if t.device.type == "cuda":
            return "plain" if _plain else "op"
        grad = torch.is_grad_enabled() and any(
            x.requires_grad for x in (t, *tensors))
        return "plain" if grad else "op"
    if t.device.type == "cpu":
        return "plain"
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return "plain" if _plain else "kernel"


def custom_op(name, cuda_impl):
    """Register ``cuda_impl`` (its arguments and results annotated) as the
    CUDA implementation of the custom op ``paddle_tpu_torch::<name>``;
    returns the op, whose ``register_kernel("cpu")`` and
    ``register_fake`` add the rest. A compiled graph hands the op its
    inputs in the strides the trace saw (the kernels take contiguous
    tensors)."""
    return torch.library.custom_op(
        f"paddle_tpu_torch::{name}", cuda_impl, mutates_args=(),
        device_types="cuda", tags=(torch.Tag.needs_fixed_stride_order,))


def refuse_trace(name):
    """Raise when TorchDynamo or ``torch.export`` traces a kernel that is
    not a custom op yet (K2 and K5, whose split plans and ticket buffers
    keyed by stream live on the host): no graph may hold a call it cannot
    replay."""
    if torch.compiler.is_compiling() or torch.compiler.is_exporting():
        raise NotImplementedError(
            f"the {name} kernel is not a traceable custom op yet (ROADMAP "
            f"A9, K2 / K5 as custom ops): to_static and jit.save cannot "
            f"hold it; run the decode step eagerly")


def refuse_grad(name, item, *tensors):
    """Raise where a kernel without a backward would hand autograd a
    detached output: grad mode is on and an input requires grad. The
    wrappers of such kernels call it on their kernel path (the plain
    versions on CPU tensors are differentiable by autograd)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"the {name} kernel has no backward ({item}); call it under "
            f"torch.no_grad() or with inputs that do not require grad")


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cand = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cand.append(Path(found))
    cand.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cand:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build():
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    so = BUILD_DIR / f"libpaddle_tpu_torch_{tag}.so"
    if so.is_file():
        return so
    nvcc = _nvcc()
    objs, procs = [], []
    for name in SOURCES:
        obj = BUILD_DIR / f"{Path(name).stem}_{tag}.o"
        objs.append(obj)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / name),
               "-o", str(obj)]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for name, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {name}\n{out}")
        if p.returncode != 0:
            failed.append(name)
    log = "\n".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log}")
    tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"linking the kernel library failed:\n"
                           f"{link.stdout}")
    os.replace(tmp, so)
    BUILD_INFO.update(log=log, built=True)
    return so


def _declare(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sigs = {
        # x, w, y, rstd, rows, n, eps, dtype, stream
        "ptt_rms_norm": (p, p, p, p, i, i, f, i, p),
        # q, k_pool, v_pool, tables, lens, out, part_o, part_ml, tickets,
        # b, h, hk, d, num_blocks, block_size, table_width, stretch,
        # nsplit, sm_scale, dtype, stream
        "ptt_paged_decode_attention": (p, p, p, p, p, p, p, p, p, i, i, i,
                                       i, i, i, i, i, i, f, i, p),
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, part_o,
        # part_ml, tickets, b, h, hk, d, num_blocks, block_size,
        # table_width, stretch, nsplit, sm_scale, dtype, per_row, stream
        "ptt_paged_decode_attention_int8": (p, p, p, p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, i, f, i,
                                            i, p),
        # q, k_pool, v_pool, k_scale, v_scale, tables, lens, out, part_o,
        # part_ml, tickets, b, h, hk, d, num_blocks, block_size,
        # table_width, stretch, nsplit, sm_scale, dtype, stream
        "ptt_paged_decode_attention_scaled": (p, p, p, p, p, p, p, p, p, p,
                                              p, i, i, i, i, i, i, i, i, i,
                                              f, i, p),
        # q, k, v, cu_q, cu_k, order, out, lse, tq, tk, nseg, h, hk, d,
        # causal, window, sm_scale, dtype, stream
        "ptt_varlen_flash_attention": (p, p, p, p, p, p, p, p, i, i, i, i,
                                       i, i, i, i, f, i, p),
        # q, k_cache, v_cache, lens, out, part_o, part_ml, tickets, b, h,
        # hk, d, s_max, stretch, nsplit, sm_scale, dtype, stream
        "ptt_decode_attention": (p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                                 f, i, p),
        # q, k, v, out, lse, b, sq, sk, h, hk, d, causal, window, sm_scale,
        # dtype, stream
        "ptt_flash_attention": (p, p, p, p, p, i, i, i, i, i, i, i, i, f, i,
                                p),
        # x, w, rstd, dy, dx, dw_part, dw, rows, n, ctas, threads, vpt,
        # dtype, stream (ops/rms_norm.py `bwd_plan`)
        "ptt_rms_norm_bwd": (p, p, p, p, p, p, p, i, i, i, i, i, i, p),
        # n, threads, vpt, dtype -> row CTAs an SM holds
        "ptt_rms_norm_bwd_fit": (i, i, i, i),
        # q, k, v, do, lse, delta, dq, dk, dv, dq_workspace, counters, b,
        # sq, sk, h, hk, d, causal, window, sm_scale, dtype, stream
        "ptt_flash_attention_bwd_fused": (p, p, p, p, p, p, p, p, p, p, p, i,
                                          i, i, i, i, i, i, i, f, i, p),
        # q, k, v, do, lse, delta, cu_q, cu_k, dq, dk, dv, dq_workspace,
        # counters, tq, tk, nseg, h, hk, d, causal, window, sm_scale, dtype,
        # stream
        "ptt_varlen_flash_attention_bwd_fused": (p, p, p, p, p, p, p, p, p, p,
                                                 p, p, p, i, i, i, i, i, i, i,
                                                 i, f, i, p),
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    lib.ptt_decode_split_limit.argtypes = [ctypes.c_int]
    lib.ptt_decode_split_limit.restype = ctypes.c_int
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    limits = (sd.STRETCH_UNIT, sd.MAX_STRETCH, sd.MAX_SPLITS)
    if tuple(lib.ptt_decode_split_limit(i) for i in range(3)) != limits:
        raise RuntimeError("split_decode.cuh and ops/split_decode.py "
                           "disagree on the decode plan's limits")
    return lib


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(_build())))
        return _lib


def check_status(name, status):
    """Raise when a launch returned a CUDA error (``cudaGetLastError``
    right after the launch: a refused launch never runs, and a later
    synchronize would not report it)."""
    if status != 0:
        msg = library().ptt_error_string(status).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({status})")


def cuda_stream(t: torch.Tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
