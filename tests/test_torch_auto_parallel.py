"""The port's auto-parallel tier (``ProcessMesh``, the placements,
``shard_tensor`` and ``Engine``) held against paddle_tpu's on the CPU,
with BASELINE config #4's recipe at ``ErnieConfig.tiny()`` (2 layers,
hidden 32): ``ErnieForPretraining`` + ``BertPretrainingCriterion`` in an
``Engine``, AdamW, labels on every 7th token. The reference's weights are
carried into the port with ``nlp.convert`` before its first step.

The reference's Engine without a mesh builds a data-parallel mesh over
the 8 CPU devices of ``tests/conftest.py``; these tests pass it
``mesh=ProcessMesh([0])``, one device, the port's path. Both fits shuffle
with ``RandomSampler``, which reads numpy's global stream: each fit runs
right after ``np.random.seed`` of the same value.

Tolerances, each with its reason:
- losses: ``1e-5`` relative (the same f32 forward, summed in other
  orders);
- parameters (the tied word table too) and AdamW's two moments after
  three steps: within ``1e-5`` of each tensor's largest |value|, the
  f32 rounding of updates of the same gradients. The key projections'
  biases are left out of the parameters' and the moments' check: their
  gradient is zero in exact
  arithmetic (the softmax cancels a bias common to a query's scores), so
  what either package computes is rounding noise, and Adam's update
  scales noise up to a step of ~lr; they are held within ``3 * lr``;
- evaluate / predict / the resumed fit: ``1e-5`` relative, as above.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed.auto_parallel import Engine as RefEngine
from paddle_tpu.distributed.auto_parallel import ProcessMesh as RefMesh
from paddle_tpu.io import Dataset as RefDataset
from paddle_tpu.nlp import BertPretrainingCriterion as RefCriterion
from paddle_tpu.nlp import ErnieConfig as RefConfig
from paddle_tpu.nlp import ErnieForPretraining as RefErnie
from paddle_tpu_torch.distributed.auto_parallel import (Engine, Partial,
                                                        ProcessMesh,
                                                        Replicate, Shard,
                                                        dtensor_from_fn,
                                                        reshard, shard_layer,
                                                        shard_tensor)
from paddle_tpu_torch.io import Dataset
from paddle_tpu_torch.nlp import (BertPretrainingCriterion, ErnieConfig,
                                  ErnieForPretraining,
                                  load_paddle_tpu_arrays,
                                  paddle_tpu_arrays_to_port)
from paddle_tpu_torch.optimizer import AdamW

LR = 1e-4
B, S = 4, 16
TABLE = "bert.embeddings.word_embeddings.weight"


def _arrays(n, seed=0, vocab=128):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, vocab, (n, S)).astype(np.int64)
    labels = np.full((n, S), -100, np.int64)
    labels[:, ::7] = ids[:, ::7]
    return ids, labels


class _Data(Dataset):
    """ernie_engine's dataset (scripts/bench_suite.py) at the tiny
    size."""

    def __init__(self, n=B * 3, seed=0):
        self.ids, self.labels = _arrays(n, seed)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


class _RefData(RefDataset):
    def __init__(self, n=B * 3, seed=0):
        self.ids, self.labels = _arrays(n, seed)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return self.ids[i], self.labels[i]


def _pair(seed=0):
    """The reference's tiny ERNIE engine and the port's on its weights."""
    paddle.seed(seed)
    ref = RefErnie(RefConfig.tiny())
    arrays = {k: np.asarray(v._value, np.float32)
              for k, v in ref.state_dict().items()}
    rcrit = RefCriterion()
    ref_eng = RefEngine(ref, lambda out, lb: rcrit(out[0], out[1], lb),
                        paddle.optimizer.AdamW(LR, parameters=ref.parameters()),
                        mesh=RefMesh([0]))
    model = ErnieForPretraining(ErnieConfig.tiny(), device="cpu")
    load_paddle_tpu_arrays(model, arrays)
    eng = _engine(model)
    return ref_eng, ref, eng, model


def _engine(model):
    crit = BertPretrainingCriterion()
    return Engine(model, lambda out, lb: crit(out[0], out[1], lb),
                  AdamW(LR, parameters=model.parameters()), device="cpu")


def _fit(eng, data, **kw):
    np.random.seed(7)
    return eng.fit(data, batch_size=B, verbose=0, **kw)


def _close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(np.asarray(got, np.float32) - want).max()) \
        <= rel * scale


def _is_key_bias(name):
    return name.endswith("k_proj.bias")


def test_three_fit_steps_match_reference():
    ref_eng, ref, eng, model = _pair()
    want = _fit(ref_eng, _RefData(), epochs=3, steps_per_epoch=1)
    got = _fit(eng, _Data(), epochs=3, steps_per_epoch=1)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert len(got["loss"]) == 3 and np.isfinite(got["loss"]).all()
    ref_params = dict(ref.named_parameters())
    params = dict(model.named_parameters())
    assert sorted(ref_params) == sorted(params)
    ported = paddle_tpu_arrays_to_port(model, {
        k: np.asarray(v._value, np.float32) for k, v in ref_params.items()})
    ref_states = {k: ref_eng._optimizer._states[id(p)]
                  for k, p in ref_params.items()}
    moments = {key: paddle_tpu_arrays_to_port(model, {
        k: np.asarray(st[key], np.float32) for k, st in ref_states.items()})
        for key in ("moment1", "moment2")}
    for name, p in params.items():
        state = eng._optimizer._states[id(p)]
        for key, want_key in moments.items():
            if _is_key_bias(name):
                continue  # rounding noise of a zero gradient
            _close(state[key].numpy(), want_key[name])
        if _is_key_bias(name):
            assert np.abs(p.detach().numpy() - ported[name]).max() \
                <= 3 * LR
        else:
            _close(p.detach().numpy(), ported[name])
    # the tied table: one Parameter, the reference's updated values
    assert model.cls.decoder_weight is params[TABLE]
    assert eng._optimizer._step_count == 3


def test_evaluate_predict_and_valid_data_match_reference():
    ref_eng, _, eng, _ = _pair(seed=1)
    want = _fit(ref_eng, _RefData(n=B), valid_data=_RefData(n=6, seed=3))
    got = _fit(eng, _Data(n=B), valid_data=_Data(n=6, seed=3))
    assert sorted(got) == sorted(want) == ["loss", "val_loss"]
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)
    np.testing.assert_allclose(
        eng.evaluate(_Data(n=10, seed=4), batch_size=B, verbose=0)["loss"],
        ref_eng.evaluate(_RefData(n=10, seed=4), batch_size=B,
                         verbose=0)["loss"], rtol=1e-5)
    # predict keeps the partial last batch: 10 rows in batches of 4
    outs = eng.predict(_Data(n=10, seed=4), batch_size=B)
    ref_outs = ref_eng.predict(_RefData(n=10, seed=4), batch_size=B)
    assert [o[0].shape[0] for o in outs] == [4, 4, 2]
    for (mlm, nsp), (rmlm, rnsp) in zip(outs, ref_outs):
        _close(mlm.numpy(), rmlm.numpy())
        _close(nsp.numpy(), rnsp.numpy())
    assert eng.history is eng._history and eng.main_program is None


def test_save_load_resumes_the_uninterrupted_fit(tmp_path):
    _, _, eng, model = _pair(seed=2)
    _fit(eng, _Data())
    path = str(tmp_path / "ck")
    eng.save(path)
    # an uninterrupted second fit
    straight = _fit(eng, _Data(seed=5))["loss"]
    table = model.cls.decoder_weight.detach().clone()
    # a new model and engine, loaded from the checkpoint
    fresh = ErnieForPretraining(ErnieConfig.tiny(), device="cpu",
                                generator=torch.Generator().manual_seed(9))
    eng2 = _engine(fresh)
    eng2.load(path)
    assert fresh.cls.decoder_weight is fresh.bert.embeddings.word_embeddings.weight
    resumed = _fit(eng2, _Data(seed=5))["loss"]
    np.testing.assert_allclose(resumed, straight, rtol=1e-6)
    _close(fresh.cls.decoder_weight.detach().numpy(), table.numpy(),
           rel=1e-6)
    assert eng2._optimizer._step_count == eng._optimizer._step_count == 6


@pytest.mark.parametrize("build", [
    lambda: Engine(mesh=ProcessMesh([0, 1]), device="cpu"),
    lambda: Engine(mesh=ProcessMesh([[0, 1], [2, 3]], dim_names=["dp", "mp"]),
                   device="cpu"),
    lambda: Engine(strategy=type("S", (), {"hybrid_configs": {
        "dp_degree": 2}})(), device="cpu"),
    lambda: Engine(strategy=type("S", (), {
        "hybrid_configs": {"dp_degree": 1, "mp_degree": 4}})(), device="cpu"),
    lambda: shard_tensor(torch.ones(4), ProcessMesh([0, 1]), [Shard(0)]),
    lambda: shard_layer(torch.nn.Linear(2, 2), ProcessMesh([0, 1, 2, 3])),
], ids=["mesh2", "mesh2x2", "dp2", "mp4", "shard_tensor", "shard_layer"])
def test_more_than_one_rank_raises_naming_a7(build):
    with pytest.raises(NotImplementedError, match="A7"):
        build()


def test_one_rank_mesh_and_strategy_take_the_one_rank_path():
    strategy = type("S", (), {"hybrid_configs": {
        "dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
        "sharding_degree": 1, "sep_degree": 1}})()
    model = ErnieForPretraining(ErnieConfig.tiny(), device="cpu")
    eng = Engine(model, lambda out, lb: BertPretrainingCriterion()(
        out[0], out[1], lb), AdamW(LR, parameters=model.parameters()),
        mesh=ProcessMesh([0], dim_names=["dp"]), strategy=strategy,
        device="cpu")
    assert len(_fit(eng, _Data())["loss"]) == 1
    with pytest.raises(ValueError, match="lies on"):
        Engine(torch.nn.Linear(2, 2, device="meta"), device="cpu")


def test_process_mesh_and_placements_match_reference():
    for args in (([[0, 1, 2], [3, 4, 5]], ["x", "y"]), ([0], None)):
        got, want = ProcessMesh(*args), RefMesh(*args)
        assert (got.shape, got.ndim, got.process_ids, got.dim_names) == (
            want.shape, want.ndim, want.process_ids, want.dim_names)
        np.testing.assert_array_equal(got.mesh, want.mesh)
    mesh = ProcessMesh(shape=[2, 3], process_ids=range(6),
                       dim_names=["dp", "mp"])
    assert mesh.get_dim_size("mp") == 3 and mesh.processes == list(range(6))
    assert mesh == ProcessMesh([[0, 1, 2], [3, 4, 5]])
    assert mesh != ProcessMesh([[0, 1], [2, 3]])
    assert hash(mesh) == hash(ProcessMesh([[0, 1, 2], [3, 4, 5]]))
    assert repr(Shard(1)) == "Shard(dim=1)" and repr(Replicate()) == \
        "Replicate()" and repr(Partial()) == "Partial()"
    one = ProcessMesh([0])
    t = torch.arange(6.0).reshape(2, 3)
    place = [Shard(0)]
    assert shard_tensor(t, one, place) is t
    assert t.process_mesh == one and t.placements == place
    assert repr(reshard(t, one, [Replicate()]).placements) == "[Replicate()]"
    d = dtensor_from_fn(torch.ones, one, [Replicate()], 2, 2)
    assert d.shape == (2, 2) and d.process_mesh == one
    seen = []
    lin = torch.nn.Sequential(torch.nn.Linear(2, 2))
    assert shard_layer(lin, one, lambda n, m, pm: seen.append(n)) is lin
    assert seen == ["", "0"]
    with pytest.raises(ValueError, match="placements"):
        shard_tensor(t, one, [Shard(0), Shard(1)])
