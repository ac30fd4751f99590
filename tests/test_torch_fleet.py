"""The port's fleet tier across gloo ranks on the CPU: tensor-parallel
layers at mp2, group sharding stages 1-3 at sharding 4, the pipeline
(pp2 / pp4 / interleave / scaler / shared layers), mp2 x pp2 x sharding2
at stages 2 and 3, and the tiny Llama under dp2 x mp2 x sharding2.

Each job runs once (``tests/torch_dist_jobs.py``) and its ranks' results
are held against the reference's one-process run on conftest's 8 virtual
devices and against the port's serial run, at the reference's own
tolerances: 1e-5 for the layers, rtol 1e-4 (losses) / 1e-3 (parameters)
for the sharding stages, rtol 2e-4 for the pipelines, rtol 5e-4 /
atol 5e-5 for the hybrid Llama losses.
"""
import warnings

import numpy as np
import pytest
import torch

from torch_dist_jobs import Pair2, run_ranks, shared

import paddle_tpu as paddle
import paddle_tpu.nn as rnn
import paddle_tpu.nn.functional as RF
from paddle_tpu.distributed import fleet as ref_fleet
from paddle_tpu.parallel import mesh as ref_mesh
from paddle_tpu_torch import nn, optimizer
from paddle_tpu_torch.nlp import load_paddle_tpu_arrays
from paddle_tpu_torch.nn import functional as F


def _ref_init(dp=1, mp=1, pp=1, sharding=1, acc=1, stage=None):
    ref_mesh.set_mesh(None)
    strategy = ref_fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": dp, "mp_degree": mp,
                               "pp_degree": pp, "sharding_degree": sharding}
    strategy.pipeline_configs = {"accumulate_steps": acc}
    if stage:
        strategy.sharding = True
        strategy.sharding_configs = {"stage": stage}
    ref_fleet.init(is_collective=True, strategy=strategy)
    return strategy


def _arrays(layer):
    return {k: np.asarray(v.numpy()) for k, v in layer.state_dict().items()}


def _close_params(got, want, rtol, atol, msg=""):
    assert sorted(got) == sorted(want), msg
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{msg} {k}")


def _ref_params_in_port_layout(model, arrays):
    """The reference's arrays as the port holds them (Linear transposed)."""
    from paddle_tpu_torch.nlp import paddle_tpu_arrays_to_port

    return paddle_tpu_arrays_to_port(model, arrays)


# -- tensor parallel at mp2 --------------------------------------------------
@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    return shared(tmp_path_factory, "tp",
                  lambda: _tp_run(tmp_path_factory))


def _tp_run(tmp_path_factory):
    from paddle_tpu.distributed.fleet.meta_parallel import (
        ColumnParallelLinear as RCol, ParallelCrossEntropy as RPCE,
        RowParallelLinear as RRow, VocabParallelEmbedding as RVocab)

    try:
        _ref_init(mp=2)
        paddle.seed(0)
        col = RCol(8, 16, has_bias=True, gather_output=False)
        row = RRow(16, 8, has_bias=True, input_is_parallel=True)
        x = paddle.randn([4, 8])
        pair = {"col.weight": col.weight.numpy(), "col.bias": col.bias.numpy(),
                "row.weight": row.weight.numpy(),
                "row.bias": row.bias.numpy()}
        ref = {"pair": row(col(x)).numpy(), "col": col(x).numpy()}
        emb = RVocab(16, 8)
        ids = np.array([[1, 3], [5, 15]])
        ref["emb"] = emb(paddle.to_tensor(ids)).numpy()
        rng = np.random.RandomState(4)
        logits = rng.randn(6, 16).astype(np.float32)
        labels = np.array([0, 7, 8, 15, 3, 12])
        lt = paddle.to_tensor(logits)
        lt.stop_gradient = False
        loss = RPCE()(lt, paddle.to_tensor(labels))
        loss.mean().backward()
        ref["pce"], ref["pce_grad"] = loss.numpy(), lt.grad.numpy()

        # the reference's test_tp_training_matches_serial, parallel arm
        _ref_init(mp=2)
        paddle.seed(42)
        tcol = RCol(8, 16, has_bias=True, gather_output=False)
        trow = RRow(16, 4, has_bias=True, input_is_parallel=True)
        train = {"col.weight": tcol.weight.numpy(),
                 "col.bias": tcol.bias.numpy(),
                 "row.weight": trow.weight.numpy(),
                 "row.bias": trow.bias.numpy()}
        params = tcol.parameters() + trow.parameters()
        opt = paddle.optimizer.SGD(0.1, parameters=params)
        xt = np.random.RandomState(0).randn(4, 8).astype(np.float32)
        yt = np.array([0, 1, 2, 3])
        losses = []
        for _ in range(3):
            lo = RF.cross_entropy(trow(tcol(paddle.to_tensor(xt))),
                                  paddle.to_tensor(yt))
            lo.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(lo))
        ref["losses"] = losses
        ref["params"] = {"col.weight": tcol.weight.numpy(),
                         "col.bias": tcol.bias.numpy(),
                         "row.weight": trow.weight.numpy(),
                         "row.bias": trow.bias.numpy()}
    finally:
        ref_mesh.set_mesh(None)
    h = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    payload = {"x": x.numpy(), "pair": pair, "emb": _arrays(emb)["weight"],
               "ids": ids, "logits": logits, "labels": labels, "h": h,
               "train": train, "xt": xt, "yt": yt}
    ranks = run_ranks("tensor_parallel", 2, tmp_path_factory.mktemp("tp"),
                      payload)
    return payload, ref, ranks


def test_tp_layers_match_reference(tp):
    payload, ref, ranks = tp
    w_col, b_col = payload["pair"]["col.weight"], payload["pair"]["col.bias"]
    w_row, b_row = payload["pair"]["row.weight"], payload["pair"]["row.bias"]
    for out in ranks:
        np.testing.assert_allclose(out["pair"], ref["pair"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["col_gathered"], ref["col"],
                                   rtol=1e-5, atol=1e-5)
        mine = np.split(ref["col"], 2, axis=-1)[out["mp_rank"]]
        np.testing.assert_allclose(out["col_local_out"], mine, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["row_split_in"],
                                   payload["h"] @ w_row + b_row, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(out["emb"], ref["emb"], rtol=1e-6)
    np.testing.assert_allclose(
        ranks[0]["pair"], (payload["x"] @ w_col + b_col) @ w_row + b_row,
        rtol=1e-5, atol=1e-5)


def test_tp_ranks_hold_half_of_each_split_weight(tp):
    _, _, ranks = tp
    assert [o["mp_rank"] for o in ranks] == [0, 1]
    for out in ranks:
        assert out["mp_world"] == 2
        assert out["col_local"] == (8, 8)   # (out / 2, in)
        assert out["row_local"] == (8, 8)   # (out, in / 2)
        assert out["emb_local"] == (8, 8)   # (vocab / 2, hidden)
        assert out["distributed"] == (True, True)


def test_parallel_cross_entropy_matches_reference(tp):
    _, ref, ranks = tp
    for out in ranks:
        np.testing.assert_allclose(out["pce"], ref["pce"], rtol=1e-5,
                                   atol=1e-6)
        mine = np.split(ref["pce_grad"], 2, axis=-1)[out["mp_rank"]]
        np.testing.assert_allclose(out["pce_grad"], mine, rtol=1e-5,
                                   atol=1e-6)


def test_tp_training_matches_reference_and_serial(tp):
    payload, ref, ranks = tp
    serial = load_paddle_tpu_arrays(Pair2(), payload["train"])
    opt = optimizer.SGD(0.1, parameters=serial.named_parameters())
    x, y = torch.from_numpy(payload["xt"]), torch.from_numpy(payload["yt"])
    losses = []
    for _ in range(3):
        loss = F.cross_entropy(serial(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    want = _ref_params_in_port_layout(serial, ref["params"])
    mine = {k: v.detach().numpy() for k, v in serial.named_parameters()}
    for out in ranks:
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=1e-4)
        np.testing.assert_allclose(out["losses"], losses, rtol=1e-5)
        _close_params(out["params"], want, 1e-4, 1e-5, "reference")
        _close_params(out["params"], mine, 1e-5, 1e-6, "serial")


# -- group sharding at sharding 4 -------------------------------------------
@pytest.fixture(scope="module")
def sharding(tmp_path_factory):
    return shared(tmp_path_factory, "sharding",
                  lambda: _sharding_run(tmp_path_factory))


def _sharding_run(tmp_path_factory):
    from paddle_tpu.distributed.sharding import group_sharded_parallel

    x = np.random.RandomState(1).randn(8, 8).astype(np.float32)
    y = np.arange(8) % 4
    ref, arrays = {}, None
    try:
        for level in ("os", "os_g", "p_g_os"):
            _ref_init(sharding=4)
            paddle.seed(7)
            m = rnn.Sequential(rnn.Linear(8, 16), rnn.ReLU(),
                               rnn.Linear(16, 4))
            arrays = arrays or _arrays(m)
            opt = paddle.optimizer.Adam(0.05, parameters=m.parameters())
            m2, opt, _ = group_sharded_parallel(m, opt, level)
            losses = []
            for _ in range(3):
                loss = RF.cross_entropy(m2(paddle.to_tensor(x)),
                                        paddle.to_tensor(y))
                loss.backward()
                opt.step()
                opt.clear_grad()
                losses.append(float(loss))
            ref[level] = (losses, _arrays(m))
    finally:
        ref_mesh.set_mesh(None)
    ranks = run_ranks("sharding_stages", 4, tmp_path_factory.mktemp("sh"),
                      {"x": x, "y": y, "arrays": arrays})
    return x, y, arrays, ref, ranks


def _serial_mlp(arrays, x, y):
    m = load_paddle_tpu_arrays(
        nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4)), arrays)
    opt = optimizer.Adam(0.05, parameters=m.named_parameters())
    losses = []
    for _ in range(3):
        loss = F.cross_entropy(m(torch.from_numpy(x)), torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return m, losses


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_sharding_stage_matches_reference_and_serial(sharding, level):
    x, y, arrays, ref, ranks = sharding
    serial, losses = _serial_mlp(arrays, x, y)
    ref_losses, ref_arrays = ref[level]
    want = _ref_params_in_port_layout(serial, ref_arrays)
    mine = {k: v.detach().numpy() for k, v in serial.named_parameters()}
    for out in ranks:
        got = out[level]
        np.testing.assert_allclose(got["losses"], ref_losses, rtol=1e-4)
        np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
        _close_params(got["params"], want, 1e-3, 1e-5, level)
        _close_params(got["params"], mine, 1e-5, 1e-6, level)


@pytest.mark.parametrize("level", ["os", "os_g", "p_g_os"])
def test_sharding_stage_holds_a_quarter(sharding, level):
    """Each rank keeps 1/4 of every moment; at stage 3 also 1/4 of every
    parameter, and one Linear's parameters gathered at a time."""
    x, y, arrays, ref, ranks = sharding
    full = {k: int(np.prod(np.shape(v))) for k, v in arrays.items()}
    for out in ranks:
        got = out[level]
        for k, n in full.items():
            quarter = -(-n // 4)
            assert got["state_numel"][k] == {"moment1": quarter,
                                             "moment2": quarter}, k
            if level == "p_g_os":
                assert got["param_numel"][k] == quarter, k
                assert got["is_sharded"][k]
            else:
                assert got["param_numel"][k] == n, k
        if level == "p_g_os":
            assert got["stage3"]["peak"] == 1
            assert got["stage3"]["gathers"] > 0


# -- the pipeline --------------------------------------------------------------
def _ref_descs():
    from paddle_tpu.distributed.fleet import LayerDesc

    return [LayerDesc(rnn.Linear, 16, 32), LayerDesc(rnn.ReLU),
            LayerDesc(rnn.Linear, 32, 32), LayerDesc(rnn.ReLU),
            LayerDesc(rnn.Linear, 32, 32), LayerDesc(rnn.ReLU),
            LayerDesc(rnn.Linear, 32, 8)]


def _ref_pp(pp, acc, x, y, virtual=None, steps=3):
    from paddle_tpu.distributed.fleet import PipelineLayer
    from paddle_tpu.distributed.fleet.meta_parallel.pipeline_parallel import (
        PipelineParallel, PipelineParallelWithInterleave)

    strategy = _ref_init(pp=pp, acc=acc)
    paddle.seed(7)
    pipe = PipelineLayer(layers=_ref_descs(), num_stages=pp,
                         loss_fn=rnn.CrossEntropyLoss(),
                         num_virtual_pipeline_stages=virtual)
    arrays = _arrays(pipe)
    cls = PipelineParallelWithInterleave if virtual else PipelineParallel
    model = cls(pipe, ref_fleet.get_hybrid_communicate_group(), strategy)
    opt = paddle.optimizer.SGD(0.1, parameters=pipe.parameters())
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        losses = [float(model.train_batch(
            [paddle.to_tensor(x), paddle.to_tensor(y)], opt))
            for _ in range(steps)]
    return arrays, losses


def _serial_pp(arrays, x, y, steps=3):
    from torch_dist_jobs import _pp_descs

    net = nn.Sequential(*[d.build_layer() for d in _pp_descs()])
    load_paddle_tpu_arrays(net, {k.replace("run_function.", ""): v
                                 for k, v in arrays.items()})
    opt = optimizer.SGD(0.1, parameters=net.named_parameters())
    losses = []
    for _ in range(steps):
        loss = nn.CrossEntropyLoss()(net(torch.from_numpy(x)),
                                     torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    return shared(tmp_path_factory, "pipe",
                  lambda: _pipe_run(tmp_path_factory))


def _pipe_run(tmp_path_factory):
    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    y = (np.arange(8) % 8).astype(np.int64)
    try:
        arrays, pp4 = _ref_pp(4, 2, x, y)
        _, pp2 = _ref_pp(2, 4, x, y)
        _, inter = _ref_pp(2, 4, x, y, virtual=2)
        _, acc2 = _ref_pp(2, 2, x, y, steps=1)
    finally:
        ref_mesh.set_mesh(None)
    ref = {"pp4": pp4, "pp2": pp2, "interleave": inter, "acc2": acc2}
    ranks = run_ranks("pipeline", 4, tmp_path_factory.mktemp("pp"),
                      {"x": x, "y": y, "arrays": arrays})
    return x, y, arrays, ref, ranks


@pytest.mark.parametrize("run", ["pp4", "pp2", "interleave"])
def test_pipeline_matches_reference_and_serial(pipe, run):
    x, y, arrays, ref, ranks = pipe
    serial = _serial_pp(arrays, x, y)
    for out in ranks:
        np.testing.assert_allclose(out[run], ref[run], rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(out[run], serial, rtol=2e-4, atol=1e-5)


def test_pipeline_types_and_placement(pipe):
    _, _, _, _, ranks = pipe
    stages = []
    for out in ranks:
        assert out["pp2_type"] == "PipelineParallel"
        assert out["interleave_type"] == "PipelineParallelWithInterleave"
        assert out["pp2_dp"] == 2  # dp grows to take the other two ranks
        assert out["chunk_stage"] == [0, 1, 0, 1]
        stages.append(tuple(out["local_chunks"]))
        # a pp2 rank builds only its stage's layers
        assert len(out["pp2_stage_keys"]) == 4
    # rank = 2 * data + pipe: the data axis is the outer one
    assert stages == [(0, 2), (1, 3), (0, 2), (1, 3)]


def test_pipeline_eval_batch(pipe):
    x, y, arrays, ref, ranks = pipe
    serial_losses = _serial_pp(arrays, x, y, steps=4)
    for out in ranks:
        # evaluated after three steps: the loss of the fourth serial step
        np.testing.assert_allclose(out["pp2_eval"], serial_losses[3],
                                   rtol=2e-4, atol=1e-5)


def test_pipeline_scaler_path(pipe):
    """The scaled run's loss is the unscaled one's, and a found inf on one
    stage skips the step on every rank."""
    x, y, arrays, ref, ranks = pipe
    for out in ranks:
        assert np.isfinite(out["scaler"][0])
        np.testing.assert_allclose(out["scaler"], out["plain_acc2"],
                                   rtol=1e-6)
        np.testing.assert_allclose(out["scaler"], ref["acc2"], rtol=2e-4,
                                   atol=1e-5)
        assert out["inf_scale"] == 128.0
        for k, v in out["inf_skipped"].items():
            want = arrays[k].T if v.ndim == 2 else arrays[k]
            np.testing.assert_array_equal(v, want, err_msg=k)


def test_pipeline_shared_layer_sums_grads_across_stages(pipe):
    """A layer shared by stage 0 and stage 1 stays equal on both and
    trains as the serial model that applies it twice."""
    x, y, _, _, ranks = pipe
    by_stage = {0: ranks[0], 1: ranks[1]}
    np.testing.assert_array_equal(
        by_stage[0]["shared_params"]["run_function.0.weight"],
        by_stage[1]["shared_params"]["run_function.4.weight"])
    init = {**by_stage[1]["shared_init"], **by_stage[0]["shared_init"]}
    tied, mid, last = nn.Linear(16, 16), nn.Linear(16, 16), nn.Linear(16, 8)
    with torch.no_grad():
        for name, mod in (("0", tied), ("2", mid), ("5", last)):
            mod.weight.copy_(torch.from_numpy(init[f"run_function.{name}.weight"]))
            mod.bias.copy_(torch.from_numpy(init[f"run_function.{name}.bias"]))
    net = nn.Sequential(tied, nn.ReLU(), mid, nn.ReLU(), tied, last)
    opt = optimizer.SGD(0.1, parameters=net.named_parameters())
    losses = []
    for _ in range(3):
        loss = nn.CrossEntropyLoss()(net(torch.from_numpy(x)),
                                     torch.from_numpy(y))
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    for out in ranks:
        np.testing.assert_allclose(out["shared"], losses, rtol=2e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(
        by_stage[0]["shared_params"]["run_function.0.weight"],
        tied.weight.detach().numpy(), rtol=1e-4, atol=1e-6)


# -- mp2 x pp2 x sharding2 ------------------------------------------------------
def _ref_tp_descs():
    from paddle_tpu.distributed.fleet import LayerDesc
    from paddle_tpu.distributed.fleet.layers.mpu.mp_layers import (
        ColumnParallelLinear, RowParallelLinear)

    return [LayerDesc(ColumnParallelLinear, 16, 32, gather_output=False),
            LayerDesc(rnn.ReLU),
            LayerDesc(RowParallelLinear, 32, 32, input_is_parallel=True),
            LayerDesc(rnn.ReLU),
            LayerDesc(ColumnParallelLinear, 32, 32, gather_output=True),
            LayerDesc(rnn.ReLU), LayerDesc(rnn.Linear, 32, 8)]


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    return shared(tmp_path_factory, "hybrid",
                  lambda: _hybrid_run(tmp_path_factory))


def _hybrid_run(tmp_path_factory):
    from paddle_tpu.distributed.fleet import PipelineLayer

    x = np.random.RandomState(0).randn(8, 16).astype(np.float32)
    y = (np.arange(8) % 8).astype(np.int64)
    ref = {}
    try:
        ref_mesh.set_mesh(None)
        paddle.seed(7)
        net = rnn.Sequential(*[d.build_layer() for d in _ref_tp_descs()])
        arrays = {f"run_function.{k}": v for k, v in _arrays(net).items()}
        opt = paddle.optimizer.AdamW(1e-3, parameters=net.parameters(),
                                     weight_decay=0.01)
        serial = []
        for _ in range(3):
            loss = rnn.CrossEntropyLoss()(net(paddle.to_tensor(x)),
                                          paddle.to_tensor(y))
            loss.backward()
            opt.step()
            opt.clear_grad()
            serial.append(float(loss))
        ref["serial"] = serial
        for virtual, stage in ((None, 2), (2, 2), (None, 3), (2, 3)):
            _ref_init(mp=2, pp=2, sharding=2, acc=2, stage=stage)
            paddle.seed(7)
            pl = PipelineLayer(layers=_ref_tp_descs(), num_stages=2,
                               loss_fn=rnn.CrossEntropyLoss(),
                               num_virtual_pipeline_stages=virtual)
            model = ref_fleet.distributed_model(pl)
            opt = ref_fleet.distributed_optimizer(paddle.optimizer.AdamW(
                1e-3, parameters=pl.parameters(), weight_decay=0.01))
            ref[(virtual, stage)] = [float(model.train_batch(
                [paddle.to_tensor(x), paddle.to_tensor(y)], opt))
                for _ in range(3)]
    finally:
        ref_mesh.set_mesh(None)
    ranks = run_ranks("hybrid", 8, tmp_path_factory.mktemp("hy"),
                      {"x": x, "y": y, "arrays": arrays}, timeout=180)
    return ref, ranks


@pytest.mark.parametrize("virtual,stage", [(None, 2), (2, 2), (None, 3),
                                           (2, 3)])
def test_hybrid_matches_reference_and_serial(hybrid, virtual, stage):
    ref, ranks = hybrid
    for out in ranks:
        got = out[(virtual, stage)]
        assert got["type_ok"]
        np.testing.assert_allclose(got["losses"], ref[(virtual, stage)],
                                   rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(got["losses"], ref["serial"], rtol=2e-4,
                                   atol=1e-5)


@pytest.mark.parametrize("stage", [2, 3])
def test_hybrid_shards_tp_weights_and_moments(hybrid, stage):
    """Stage 2: a TP weight is half on a rank (mp2), its moments a
    quarter (mp2 x sharding2); stage 3: the weight a quarter too."""
    _, ranks = hybrid
    for out in ranks:
        for virtual in (None, 2):
            got = out[(virtual, stage)]
            assert got["numel"], "no tensor-parallel weight on this rank"
            for k, n in got["numel"].items():
                full = got["full_numel"][k]
                assert got["moment_numel"][k] * 4 == full, k
                assert n * (4 if stage == 3 else 2) == full, k


# -- the tiny Llama under dp2 x mp2 x sharding2 ---------------------------------
@pytest.fixture(scope="module")
def llama(tmp_path_factory):
    return shared(tmp_path_factory, "llama",
                  lambda: _llama_run(tmp_path_factory))


def _llama_run(tmp_path_factory):
    from paddle_tpu.jit.train import JittedTrainStep as RStep
    from paddle_tpu.nlp.llama import (LlamaConfig as RCfg,
                                      LlamaForCausalLM as RLlama,
                                      LlamaPretrainingCriterion as RCrit)

    ids = np.random.RandomState(1).randint(0, 128, (4, 32))
    try:
        # the reference's _train_losses(True) (tests/test_nlp_models.py)
        _ref_init(dp=2, mp=2, sharding=2)
        paddle.seed(0)
        m = RLlama(RCfg.tiny(tensor_parallel=True))
        arrays = {k: np.asarray(v._value) for k, v in m.state_dict().items()}
        crit = RCrit()
        opt = paddle.optimizer.AdamW(1e-3, parameters=m.parameters(),
                                     weight_decay=0.01)
        step = RStep(m, lambda out, labels: crit(out, labels), opt,
                     state_sharding_axis="sharding")
        ref = [float(step(paddle.to_tensor(ids), paddle.to_tensor(ids)))
               for _ in range(3)]
    finally:
        ref_mesh.set_mesh(None)
    ranks = run_ranks("llama", 8, tmp_path_factory.mktemp("ll"),
                      {"ids": ids, "arrays": arrays}, timeout=180)
    return ids, arrays, ref, ranks


def _serial_llama(ids, arrays):
    from paddle_tpu_torch.jit import JittedTrainStep
    from paddle_tpu_torch.nlp import (LlamaConfig, LlamaForCausalLM,
                                      LlamaPretrainingCriterion)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = LlamaConfig.tiny(tensor_parallel=True)
    m = load_paddle_tpu_arrays(LlamaForCausalLM(cfg, device="cpu"), arrays)
    crit = LlamaPretrainingCriterion(cfg)
    step = JittedTrainStep(m, lambda o, lb: crit(o, lb), AdamW(
        1e-3, parameters=m.named_parameters(), weight_decay=0.01))
    t = torch.from_numpy(ids)
    losses = [float(step(t, t)) for _ in range(3)]
    return m, losses


@pytest.mark.parametrize("stage", [None, 3], ids=["stage1", "stage3"])
def test_llama_hybrid_matches_reference_and_serial(llama, stage):
    ids, arrays, ref, ranks = llama
    serial, losses = _serial_llama(ids, arrays)
    want = {k: v.detach().numpy() for k, v in serial.named_parameters()}
    for out in ranks:
        got = out[stage]
        np.testing.assert_allclose(got["losses"], ref, rtol=5e-4, atol=5e-5)
        np.testing.assert_allclose(got["losses"], losses, rtol=5e-4,
                                   atol=5e-5)
        _close_params(got["params"], want, 1e-3, 1e-5, f"stage {stage}")


def test_llama_run_steps_under_the_mesh(llama):
    """K steps in one call equal K single steps, the batch split over dp
    inside each."""
    _, _, ref, ranks = llama
    for out in ranks:
        np.testing.assert_allclose(out[None]["run_steps"],
                                   out[None]["losses"], rtol=1e-6)
        np.testing.assert_allclose(out[None]["run_steps"], ref, rtol=5e-4,
                                   atol=5e-5)


def test_llama_tp_build_splits_heads(llama):
    _, _, _, ranks = llama
    for out in ranks:
        for stage in (None, 3):
            got = out[stage]
            # tiny: 4 query heads and 2 KV heads of 16, hidden 64, mp2
            assert got["heads"] == (2, 1)
            assert got["q_local"] == (32, 64)
    assert ranks[0][3]["wrapper"] == "TensorParallel"


def test_llama_state_and_stage3_shards(llama):
    """Stage 1: the q weight is half on a rank, its moments a quarter;
    stage 3: the weight a quarter too, one layer gathered at a time."""
    _, _, _, ranks = llama
    for out in ranks:
        s1, s3 = out[None], out[3]
        assert s1["q_numel"] * 2 == s1["q_full_numel"]
        assert s1["q_moment_numel"] * 4 == s1["q_full_numel"]
        assert s3["q_numel"] * 4 == s3["q_full_numel"]
        assert s3["q_moment_numel"] * 4 == s3["q_full_numel"]
        assert s3["stage3"]["peak"] == 1
        assert s1["stage3"]["gathers"] == 0


def test_llama_groups_follow_the_topology(llama):
    """Each rank's groups are the reference topology's lists holding it."""
    _, _, _, ranks = llama
    topo = ref_fleet.CommunicateTopology(
        ("data", "pipe", "sharding", "sep", "model"), (2, 1, 2, 1, 2))
    names = {"dp": "data", "mp": "model", "sharding": "sharding",
             "pp": "pipe"}
    for out in ranks:
        coord = topo.get_coord(out["rank"])
        got = out[None]["coord"]
        assert (got["dp"], got["mp"], got["sharding"]) == (
            coord["data"], coord["model"], coord["sharding"])
        for axis, name in names.items():
            mine = [lst for lst in topo.get_comm_list(name)
                    if out["rank"] in lst]
            assert got["groups"][axis] == mine[0], axis
