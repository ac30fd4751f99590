"""Build the C inference API (``paddle_tpu_torch/csrc/capi/``) with g++.

The library embeds the Python runtime and drives
:mod:`paddle_tpu_torch.inference`; it is built at first use into
``build/paddle_tpu_torch/capi/`` at the repository root (its file name
carries a hash of the sources and flags) and is not part of the ``nvcc``
kernel library. A C client compiles against :func:`include_dir`, links
:func:`library` by its path and runs with :func:`client_env`::

    g++ client.c -I<include_dir()> <library()> -lpthread -o client

:func:`build_client` builds ``csrc/capi/predict_client.c``, a client
that runs a saved program on a float32 input file.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

__all__ = ["library", "include_dir", "client_env", "build_client"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "capi"
_FILES = ("paddle_tpu_torch_infer_capi.h", "paddle_tpu_torch_infer_capi.cc")
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch" / "capi"
_lock = threading.Lock()


def include_dir() -> str:
    return str(_SRC)


def _python_link():
    libdir = sysconfig.get_config_var("LIBDIR")
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    # an rpath, not LD_LIBRARY_PATH: that would put a system library
    # directory ahead of the libraries torch finds by its own paths
    return [f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{ver}", "-ldl",
            "-lm"]


def library() -> str:
    """The path of the built C API library (built on first use)."""
    flags = ["-O2", "-shared", "-fPIC",
             f"-I{sysconfig.get_paths()['include']}", *_python_link()]
    h = hashlib.sha256(" ".join(flags).encode())
    for name in _FILES:
        h.update((_SRC / name).read_bytes())
    so = BUILD_DIR / f"libpaddle_tpu_torch_infer_{h.hexdigest()[:16]}.so"
    with _lock:
        if so.is_file():
            return str(so)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}.tmp"
        cmd = ["g++", str(_SRC / _FILES[1]), *flags, "-o", str(tmp)]
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"building the C inference API failed:\n"
                               f"{' '.join(cmd)}\n{r.stdout}")
        os.replace(tmp, so)
    return str(so)


def client_env(base=None) -> dict:
    """The environment a C client needs: the checkout and this
    interpreter's paths on ``PYTHONPATH`` (the embedded interpreter
    imports torch and the port). A client linked against
    :func:`library` by its path finds it, and it finds libpython, without
    ``LD_LIBRARY_PATH``."""
    env = dict(os.environ if base is None else base)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_PKG.parent)] + [p for p in sys.path if p])
    return env


def build_client(out_path) -> str:
    """Compile ``csrc/capi/predict_client.c`` against the library into
    ``out_path``; returns its path."""
    cmd = ["g++", "-O2", "-x", "c", str(_SRC / "predict_client.c"),
           "-x", "none", f"-I{_SRC}", library(), "-lpthread", "-o",
           str(out_path)]
    r = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                       text=True)
    if r.returncode != 0:
        raise RuntimeError(f"building the C client failed:\n"
                           f"{' '.join(cmd)}\n{r.stdout}")
    return str(out_path)
