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
from paddle_tpu_torch.incubate.distributed.models.moe import MoELayer
from paddle_tpu_torch.incubate.nn import FusedMultiTransformer
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.nlp import (GPTConfig, GPTForCausalLM, LlamaConfig,
                                  LlamaForCausalLM, PagedKVCachePool)
from paddle_tpu_torch.serving import (ClusterFrontDoor, ClusterReplica,
                                      ClusterRouter, ServingEngine)

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
               "paddle_tpu_torch.serving.faults, "
               "paddle_tpu_torch.serving.resilience, "
               "paddle_tpu_torch.serving.soak, "
               "paddle_tpu_torch.serving.cluster, "
               "paddle_tpu_torch.obs, paddle_tpu_torch.obs.__main__, "
               "paddle_tpu_torch.inference, "
               "paddle_tpu_torch.incubate.nn.functional, "
               "paddle_tpu_torch.incubate.distributed.models.moe, "
               "paddle_tpu_torch.nlp.gpt, paddle_tpu_torch.vision, "
               "paddle_tpu_torch.vision.models.sd_unet, "
               "paddle_tpu_torch.nn.layer.transformer, "
               "paddle_tpu_torch.nlp.bert, paddle_tpu_torch.nlp.t5, "
               "paddle_tpu_torch.io, paddle_tpu_torch.io._native, "
               "paddle_tpu_torch.framework.io, "
               "paddle_tpu_torch.distributed.auto_parallel, "
               "paddle_tpu_torch.metric, paddle_tpu_torch.hapi, "
               "paddle_tpu_torch.hapi.summary, paddle_tpu_torch.callbacks, "
               "paddle_tpu_torch.visualdl, paddle_tpu_torch.parallel, "
               "paddle_tpu_torch.distributed.launch.main, "
               "paddle_tpu_torch.distributed.fleet.meta_parallel, "
               "paddle_tpu_torch.distributed.sharding, "
               "paddle_tpu_torch.distributed.utils; "
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
    for build in (lambda **kw: GPTForCausalLM(GPTConfig.tiny(), **kw),
                  lambda **kw: FusedMultiTransformer(64, 4, 128, **kw),
                  lambda **kw: MoELayer(16, 32, 4, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        build(device="cpu")
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    for build in (lambda: ServingEngine(model),
                  lambda: ServingEngine(model, resilience=True),
                  lambda: create_serving_engine(model, num_slots=2),
                  lambda: serve(model, num_slots=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    engine = create_serving_engine(model, num_slots=2, block_size=4,
                                   device="cpu")
    req = engine.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=3)
    engine.run()
    assert len(req.tokens) == 3
    # the resilience and cluster tiers build and serve on the CPU alone
    armed = ServingEngine(model, num_slots=2, block_size=4,
                          prefix_cache=True, resilience=True, device="cpu")
    assert armed.pool.kv_checksums and armed.watchdog is not None
    cfd = ClusterFrontDoor(ClusterRouter(
        [ClusterReplica("r0", armed)]))
    stream = cfd.submit(np.arange(1, 6, dtype=np.int32), max_new_tokens=2)
    cfd.run_until_idle()
    assert len(stream.result()) == 2


def test_vision_entry_points_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch.vision.models import (SDUNetConfig,
                                                UNet2DConditionModel,
                                                mobilenet_v2, resnet18)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: resnet18(num_classes=10, **kw),
                  lambda **kw: mobilenet_v2(num_classes=10, **kw),
                  lambda **kw: UNet2DConditionModel(SDUNetConfig.tiny(),
                                                    **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        build(device="cpu")


def test_trainers_and_new_models_raise_without_cuda(monkeypatch):
    from paddle_tpu_torch import Model
    from paddle_tpu_torch.distributed.auto_parallel import Engine
    from paddle_tpu_torch.nlp import (BertConfig, BertForPretraining,
                                      BertForSequenceClassification,
                                      BertModel, ErnieConfig,
                                      ErnieForPretraining, T5Config,
                                      T5ForConditionalGeneration, T5Model)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: BertModel(BertConfig.tiny(), **kw),
                  lambda **kw: BertForPretraining(BertConfig.tiny(), **kw),
                  lambda **kw: BertForSequenceClassification(
                      BertConfig.tiny(), **kw),
                  lambda **kw: ErnieForPretraining(ErnieConfig.tiny(), **kw),
                  lambda **kw: T5Model(T5Config.tiny(), **kw),
                  lambda **kw: T5ForConditionalGeneration(T5Config.tiny(),
                                                          **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        model = build(device="cpu")
    for trainer in (lambda **kw: Engine(model, **kw),
                    lambda **kw: Model(model, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trainer()
        trainer(device="cpu")


def test_distributed_start_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    """The ranks run on CUDA with NCCL by default; gloo only when the
    caller asks for the CPU, and never as a fallback."""
    import torch.distributed as tdist

    import paddle_tpu_torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(tdist, "init_process_group",
                        lambda **kw: called.append(kw))
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    for kw in ({}, {"backend": "nccl"}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            dist.init_parallel_env(**kw)
    with pytest.raises(ValueError, match="nccl backend needs"):
        dist.init_parallel_env(backend="nccl", device="cpu")
    assert not called
    for kw in ({"device": "cpu"}, {"backend": "gloo"}):
        dist.init_parallel_env(**kw)
        assert called.pop()["backend"] == "gloo"


def test_later_distributed_parts_raise_naming_a7():
    from paddle_tpu_torch.distributed import utils
    from paddle_tpu_torch.distributed.fleet.meta_parallel.sharding import (
        ShardedOptimizer)
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm, Lamb

    w = torch.nn.Parameter(torch.ones(4))
    for opt in (Lamb(parameters=[w]),
                AdamW(parameters=[w], grad_clip=ClipGradByGlobalNorm(1.0))):
        with pytest.raises(NotImplementedError, match="A7"):
            ShardedOptimizer(opt, 1, group=object())
    with pytest.raises(NotImplementedError, match="A7"):
        utils.global_scatter(w, w, w)
    with pytest.raises(NotImplementedError, match="A7"):
        LlamaForCausalLM(LlamaConfig.tiny(context_parallel="ring"),
                         device="cpu")


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


# -- the Paddle tensor API tier ----------------------------------------------
@pytest.fixture
def _place_restored():
    """Whatever a test sets with ``set_device``, the place before it comes
    back after it."""
    from paddle_tpu_torch.core import place

    saved = place._current
    yield place
    place._current = saved


def test_tensor_api_modules_import_neither_jax_nor_reference(tmp_path):
    out = _run("import sys, paddle_tpu_torch, paddle_tpu_torch.core.dtype, "
               "paddle_tpu_torch.core.place, paddle_tpu_torch.core.random, "
               "paddle_tpu_torch.core.flags, paddle_tpu_torch.core.tensor, "
               "paddle_tpu_torch.core.autograd, "
               "paddle_tpu_torch.core.dispatch, paddle_tpu_torch.tensor, "
               "paddle_tpu_torch.tensor.linalg, paddle_tpu_torch.autograd, "
               "paddle_tpu_torch.device, paddle_tpu_torch.utils, "
               "paddle_tpu_torch.nn.initializer, "
               "paddle_tpu_torch.nn.layer.layers; "
               "print(sorted(m for m in sys.modules if m == 'jax' or "
               "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
               "m.startswith('paddle_tpu.')))", tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_import_replaces_no_torch_tensor_attribute(tmp_path):
    """A fresh interpreter snapshots every attribute of ``torch.Tensor`` (as
    stored, before descriptors bind), imports the port, and finds each one
    the same object; the port's
    additions are exactly the names that were absent."""
    out = _run(
        "import inspect, torch\n"
        "raw = lambda n: inspect.getattr_static(torch.Tensor, n)\n"
        "before = {n: raw(n) for n in dir(torch.Tensor)}\n"
        "import paddle_tpu_torch\n"
        "from paddle_tpu_torch.tensor import ATTACHED\n"
        "changed = [n for n, v in before.items() if raw(n) is not v]\n"
        "added = sorted(set(dir(torch.Tensor)) - set(before))\n"
        "assert not changed, changed\n"
        "assert added == sorted(ATTACHED), (added, ATTACHED)\n"
        "assert not set(ATTACHED) & set(before)\n"
        "print(len(added))\n", tmp_path)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) > 50


def test_to_tensor_and_creation_ops_need_cuda_unless_asked_for_the_cpu(
        monkeypatch, _place_restored):
    import paddle_tpu_torch as paddle

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _place_restored._current = None
    makers = [
        lambda: paddle.to_tensor([1.0, 2.0]), lambda: paddle.zeros([2]),
        lambda: paddle.ones([2]), lambda: paddle.full([2], 3.0),
        lambda: paddle.empty([2]), lambda: paddle.arange(4),
        lambda: paddle.linspace(0, 1, 3), lambda: paddle.logspace(0, 1, 3),
        lambda: paddle.eye(2), lambda: paddle.tril_indices(3, 3),
        lambda: paddle.triu_indices(3, 3), lambda: paddle.rand([2]),
        lambda: paddle.randn([2]), lambda: paddle.randint(0, 4, [2]),
        lambda: paddle.uniform([2]), lambda: paddle.normal(shape=[2]),
        lambda: paddle.randperm(4), lambda: paddle.standard_normal([2]),
        lambda: paddle.Parameter(np.ones(2, np.float32)),
        lambda: paddle.nn.initializer.Constant(1.0)([2]),
        lambda: paddle.nn.Layer().create_parameter([2, 2]),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    x = paddle.to_tensor([1.0], place=paddle.CPUPlace())
    assert x.device.type == "cpu"
    assert paddle.to_tensor([1.0], place="cpu").device.type == "cpu"
    # a tensor argument's device decides; no default is asked for
    assert paddle.zeros_like(x).device.type == "cpu"
    assert paddle.add(x, 1.0).device.type == "cpu"
    paddle.set_device("cpu")
    for make in makers:
        out = make()
        assert out.device.type == "cpu"


def test_place_fixture_restores_the_place(_place_restored):
    import paddle_tpu_torch as paddle

    paddle.set_device("cpu")
    assert _place_restored._current is not None


def test_no_test_left_a_place_set():
    from paddle_tpu_torch.core import place

    assert place._current is None


def test_static_and_deployment_modules_import_neither_jax_nor_reference(
        tmp_path):
    out = _run("import sys, paddle_tpu_torch, paddle_tpu_torch.jit, "
               "paddle_tpu_torch.static, paddle_tpu_torch.static.nn, "
               "paddle_tpu_torch.inference, paddle_tpu_torch.inference.capi; "
               "print(sorted(m for m in sys.modules if m == 'jax' or "
               "m.startswith(('jax.', 'jaxlib')) or m == 'paddle_tpu' or "
               "m.startswith('paddle_tpu.')))", tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_c_inference_api_embeds_only_the_port():
    """The C API's source imports the port's modules (and numpy) into
    its interpreter, nothing of jax or the reference; its header is the
    port's own copy."""
    import re

    capi = PORT / "csrc" / "capi"
    src = (capi / "paddle_tpu_torch_infer_capi.cc").read_text()
    mods = set(re.findall(r'PyImport_ImportModule\("([^"]+)"\)', src))
    assert mods == {"paddle_tpu_torch.inference", "numpy"}, mods
    assert '#include "paddle_tpu_torch_infer_capi.h"' in src
    assert (capi / "paddle_tpu_torch_infer_capi.h").is_file()


def test_saved_program_for_the_card_needs_cuda(tmp_path, monkeypatch):
    """A program saved from the card loads only where CUDA is: no quiet
    run on the CPU."""
    from paddle_tpu_torch import inference, jit
    from paddle_tpu_torch.static import InputSpec

    net = torch.nn.Linear(4, 2)
    prefix = str(tmp_path / "m")
    jit.save(net, prefix, input_spec=[InputSpec([2, 4])])
    blob = torch.load(prefix + ".pdiparams", weights_only=True)
    blob["device"] = "cuda:0"
    torch.save(blob, prefix + ".pdiparams")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jit.load(prefix)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        inference.create_predictor(inference.Config(prefix))
