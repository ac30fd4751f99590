"""The port's BERT / ERNIE family held against paddle_tpu's on the CPU:
``BertConfig.tiny()`` / ``ErnieConfig.tiny()`` (2 layers, hidden 32, 2
heads, vocab 128) built by the reference from its seed and carried with
``nlp.convert``; ids from ``np.random.RandomState``.

Tolerances, each with its reason:
- f32 hidden states, pooled outputs and logits: ``2e-5`` absolute and
  relative (the same f32 products, LayerNorms and softmax summed in other
  orders; the MLM logits are products with the N(0, 1) word table, of
  size ~10, so they get ``1e-4`` absolute);
- losses: ``1e-5`` relative;
- after one AdamW step (``JittedTrainStep``): the tied word table within
  ``1e-5`` of its largest |value| (f32 updates of the same gradient).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nlp import bert as ref_bert
from paddle_tpu.jit.train import JittedTrainStep as RefStep
from paddle_tpu_torch.jit import JittedTrainStep
from paddle_tpu_torch.nlp import (BertConfig, BertForPretraining, BertModel,
                                  BertForSequenceClassification,
                                  BertPretrainingCriterion, ErnieConfig,
                                  ErnieForPretraining, ErnieModel,
                                  load_paddle_tpu_arrays,
                                  paddle_tpu_arrays_to_port)
from paddle_tpu_torch.optimizer import AdamW

TABLE = "bert.embeddings.word_embeddings.weight"


def _ids(b=2, s=16, seed=0, vocab=128):
    ids = np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(
        np.int64)
    ids[1, 11:] = 0  # pads in the second row
    return ids


def _arrays(ref):
    return {k: np.asarray(v._value, np.float32)
            for k, v in ref.state_dict().items()}


def _pair(ref_cls, cls, cfg_name="BertConfig", seed=0, **kw):
    paddle.seed(seed)
    ref = ref_cls(getattr(ref_bert, cfg_name).tiny(**kw))
    cfg = {"BertConfig": BertConfig, "ErnieConfig": ErnieConfig}[cfg_name]
    model = cls(cfg.tiny(**kw), device="cpu")
    load_paddle_tpu_arrays(model, _arrays(ref))
    return ref, model


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(
        got.detach().numpy(), want.numpy(), rtol=tol, atol=tol)


def _masks(ids):
    keep = ids != 0
    additive2d = np.where(keep, 0.0, -1e9).astype(np.float32)
    return {"none": None, "bool": keep, "int": keep.astype(np.int64),
            "additive_2d": additive2d,
            "additive_4d": additive2d[:, None, None, :]}


@pytest.mark.parametrize("mask", ["none", "bool", "int", "additive_2d",
                                  "additive_4d"])
def test_bert_model_outputs_under_every_mask_form(mask):
    ref, model = _pair(ref_bert.BertModel, BertModel)
    ids = _ids()
    m = _masks(ids)[mask]
    rh, rp = ref(paddle.to_tensor(ids), attention_mask=None if m is None
                 else paddle.to_tensor(m))
    h, p = model(torch.from_numpy(ids), attention_mask=None if m is None
                 else torch.from_numpy(m))
    assert tuple(h.shape) == (2, 16, 32) and tuple(p.shape) == (2, 32)
    _close(h, rh)
    _close(p, rp)


def test_mask_forms_agree_and_pads_are_masked():
    _, model = _pair(ref_bert.BertModel, BertModel, seed=1)
    ids = torch.from_numpy(_ids(seed=1))
    outs = [model(ids, attention_mask=None if m is None
                  else torch.from_numpy(m))[0]
            for m in _masks(ids.numpy()).values()]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=0, atol=0)
    # a pad's content does not reach the kept tokens
    changed = ids.clone()
    changed[1, 11:] = 5
    h1 = model(ids, attention_mask=ids != 0)[0]
    h2 = model(changed, attention_mask=ids != 0)[0]
    torch.testing.assert_close(h1[1, :11], h2[1, :11], rtol=0, atol=1e-6)


@pytest.mark.parametrize("ernie", [False, True])
def test_pretraining_logits_and_criterion_match_reference(ernie):
    ref, model = (_pair(ref_bert.ErnieForPretraining, ErnieForPretraining,
                        "ErnieConfig", seed=2) if ernie else
                  _pair(ref_bert.BertForPretraining, BertForPretraining,
                        seed=2))
    ids = _ids(seed=2)
    labels = np.full_like(ids, -100)
    labels[:, ::7] = ids[:, ::7]
    nsp = np.array([0, 1], np.int64)
    rs, rn = ref(paddle.to_tensor(ids))
    s, n = model(torch.from_numpy(ids))
    assert tuple(s.shape) == (2, 16, 128) and tuple(n.shape) == (2, 2)
    np.testing.assert_allclose(s.detach().numpy(), rs.numpy(), rtol=2e-5,
                               atol=1e-4)
    _close(n, rn)
    rcrit, crit = ref_bert.BertPretrainingCriterion(), \
        BertPretrainingCriterion()
    for nsp_labels in (None, nsp):
        want = float(rcrit(rs, rn, paddle.to_tensor(labels),
                           None if nsp_labels is None
                           else paddle.to_tensor(nsp_labels)))
        got = float(crit(s, n, torch.from_numpy(labels),
                         None if nsp_labels is None
                         else torch.from_numpy(nsp_labels)).detach())
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # the head's decoder is the word table: one Parameter
    assert model.cls.decoder_weight is \
        model.bert.embeddings.word_embeddings.weight
    names = [k for k, _ in model.named_parameters()]
    assert names.count(TABLE) == 1 and len(names) == len(set(names))
    assert sorted(model.state_dict()) == sorted(ref.state_dict())


def test_tied_table_survives_carry_and_step():
    ref, model = _pair(ref_bert.ErnieForPretraining, ErnieForPretraining,
                       "ErnieConfig", seed=3)
    ids = _ids(seed=3)
    labels = np.full_like(ids, -100)
    labels[:, ::7] = ids[:, ::7]
    rcrit, crit = ref_bert.BertPretrainingCriterion(), \
        BertPretrainingCriterion()
    rstep = RefStep(ref, lambda o, lb: rcrit(o[0], o[1], lb),
                    paddle.optimizer.AdamW(1e-3, parameters=ref.parameters()))
    rstep([paddle.to_tensor(ids)], [paddle.to_tensor(labels)])
    rstep.sync_to_model()
    table = model.bert.embeddings.word_embeddings.weight
    step = JittedTrainStep(model, lambda o, lb: crit(o[0], o[1], lb),
                           AdamW(1e-3, parameters=model.parameters()))
    assert sum(p is table for p in step.params) == 1
    step([torch.from_numpy(ids)], [torch.from_numpy(labels)])
    assert model.cls.decoder_weight is table
    want = paddle_tpu_arrays_to_port(model, _arrays(ref))[TABLE]
    assert float(np.abs(table.detach().numpy() - want).max()) <= \
        1e-5 * float(np.abs(want).max())


def test_sequence_classification_and_untied_head():
    ref, model = _pair(ref_bert.BertForSequenceClassification,
                       BertForSequenceClassification, seed=4, num_labels=3)
    ids = _ids(seed=4)
    _close(model(torch.from_numpy(ids)), ref(paddle.to_tensor(ids)))
    paddle.seed(5)
    rhead = ref_bert.BertLMPredictionHead(ref_bert.BertConfig.tiny())
    from paddle_tpu_torch.nlp.bert import BertLMPredictionHead

    head = BertLMPredictionHead(BertConfig.tiny())
    assert sorted(k for k, _ in head.named_parameters()) == sorted(
        rhead.state_dict())
    load_paddle_tpu_arrays(head, _arrays(rhead))
    h = np.random.RandomState(5).standard_normal((2, 3, 32)).astype(
        np.float32)
    np.testing.assert_allclose(
        head(torch.from_numpy(h)).detach().numpy(),
        rhead(paddle.to_tensor(h)).numpy(), rtol=2e-5, atol=1e-4)
    assert ErnieModel is not BertModel and issubclass(ErnieModel, BertModel)
    cfg = ErnieConfig()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.intermediate_size,
            cfg.max_position_embeddings, cfg.type_vocab_size) == (
        40000, 768, 12, 12, 3072, 512, 2)
