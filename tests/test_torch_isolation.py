"""The port stands alone: ``paddle_tpu_torch`` and ``chip_smoke.py`` import
neither jax nor anything of paddle_tpu, and no entry point quietly runs
on the CPU when CUDA is missing."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import create_serving_engine
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                  PagedKVCachePool)
from paddle_tpu_torch.serving import ServingEngine

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "paddle_tpu_torch"


def _run(code_or_args, cwd, with_repo=True):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "XLA_FLAGS")}
    if with_repo:
        env["PYTHONPATH"] = str(ROOT)
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=120)


def test_import_leaves_jax_and_reference_out(tmp_path):
    out = _run("import sys, paddle_tpu_torch, paddle_tpu_torch.serving, "
               "paddle_tpu_torch.obs, paddle_tpu_torch.inference, "
               "paddle_tpu_torch.incubate.nn.functional; "
               "print(sorted(m for m in sys.modules if m == 'jax' or "
               "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
               "m.startswith('paddle_tpu.')))", tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "paddle_tpu"), (path, name)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedKVCachePool(4, 4, 2, 8)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    for build in (lambda: ServingEngine(model),
                  lambda: create_serving_engine(model, num_slots=2),
                  lambda: serve(model, num_slots=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    engine = create_serving_engine(model, num_slots=2, block_size=4,
                                   device="cpu")
    req = engine.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    engine.run()
    assert len(req.tokens) == 3


def test_chip_smoke_refuses_without_cuda_and_outside_a_checkout(tmp_path):
    """Without CUDA (this machine) it prints no result and fails; copied
    alone into an empty directory it fails as well."""
    runs = [_run([sys.executable, str(ROOT / "chip_smoke.py")], ROOT)]
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs.append(_run([sys.executable, "chip_smoke.py"], alone,
                     with_repo=False))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout and '"kernels"' not in out.stdout
    assert paddle_tpu_torch.__version__
