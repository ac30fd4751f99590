"""The port's T5 family held against paddle_tpu's on the CPU:
``T5Config.tiny()`` (2 + 2 layers, d_model 32, 4 heads of 8, vocab 128)
built by the reference from its seed and carried with ``nlp.convert``;
ids from ``np.random.RandomState``.

Tolerances, each with its reason:
- the relative-position buckets: bit-equal (integer results of the same
  f32 arithmetic);
- f32 logits: ``1e-4`` absolute and ``2e-5`` relative (the tied head
  multiplies by the N(0, 1) shared table: logits of size ~10), the loss
  ``1e-5`` relative;
- after one AdamW step: the tied table within ``1e-5`` of its largest
  |value|;
- ``prepare_decoder_input_ids``: equal.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.train import JittedTrainStep as RefStep
from paddle_tpu.nlp import t5 as ref_t5
from paddle_tpu_torch.jit import JittedTrainStep
from paddle_tpu_torch.nlp import (T5Config, T5ForConditionalGeneration,
                                  T5Model, load_paddle_tpu_arrays,
                                  paddle_tpu_arrays_to_port)
from paddle_tpu_torch.nlp.t5 import relative_position_bucket
from paddle_tpu_torch.optimizer import AdamW


def _ids(b, s, seed, vocab=128):
    return np.random.RandomState(seed).randint(1, vocab, (b, s)).astype(
        np.int64)


def _arrays(ref):
    return {k: np.asarray(v._value, np.float32)
            for k, v in ref.state_dict().items()}


def _pair(seed=0, **kw):
    paddle.seed(seed)
    ref = ref_t5.T5ForConditionalGeneration(ref_t5.T5Config.tiny(**kw))
    model = T5ForConditionalGeneration(T5Config.tiny(**kw), device="cpu")
    load_paddle_tpu_arrays(model, _arrays(ref))
    return ref, model


@pytest.mark.parametrize("bidirectional", [True, False])
def test_relative_buckets_bit_equal(bidirectional):
    import jax.numpy as jnp

    rel = np.arange(-300, 301)[None, :] - np.arange(0, 40)[:, None]
    want = np.asarray(ref_t5._relative_position_bucket(
        jnp.asarray(rel, jnp.int32), bidirectional, 32, 128))
    got = relative_position_bucket(torch.from_numpy(rel), bidirectional, 32,
                                   128).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("proj", ["relu", "gated-gelu"])
def test_logits_and_loss_match_reference(proj):
    ref, model = _pair(seed=1, feed_forward_proj=proj)
    src, tgt = _ids(2, 12, 1), _ids(2, 7, 2)
    src[1, 9:] = 0  # pads: the encoder's pad bias
    labels = tgt.copy()
    labels[0, 5:] = -100
    rl, rlog = ref(paddle.to_tensor(src), paddle.to_tensor(tgt),
                   labels=paddle.to_tensor(labels))
    loss, logits = model(torch.from_numpy(src), torch.from_numpy(tgt),
                         labels=torch.from_numpy(labels))
    assert tuple(logits.shape) == (2, 7, 128)
    np.testing.assert_allclose(logits.detach().numpy(), rlog.numpy(),
                               rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(float(loss.detach()), float(rl), rtol=1e-5)


def test_tied_embeddings_survive_carry_and_step():
    ref, model = _pair(seed=2)
    shared = model.t5.shared.weight
    assert model.t5.encoder.embed_tokens is model.t5.shared
    assert model.t5.decoder.embed_tokens is model.t5.shared
    names = [k for k, _ in model.named_parameters()]
    assert names.count("t5.shared.weight") == 1
    # torch's state_dict names the shared table under each module that
    # holds it; the aliases are one storage
    sd = model.state_dict()
    extra = set(sd) - set(ref.state_dict())
    assert set(ref.state_dict()) <= set(sd) and extra == {
        "t5.encoder.embed_tokens.weight", "t5.decoder.embed_tokens.weight"}
    assert all(sd[k].data_ptr() == shared.data_ptr() for k in extra)
    src, tgt = _ids(2, 10, 3), _ids(2, 6, 4)
    dec = model.prepare_decoder_input_ids(torch.from_numpy(tgt))
    rdec = ref.prepare_decoder_input_ids(paddle.to_tensor(tgt))
    np.testing.assert_array_equal(dec.numpy(), rdec.numpy())
    rstep = RefStep(ref, lambda out: out[0],
                    paddle.optimizer.AdamW(1e-3, parameters=ref.parameters()))
    rstep([paddle.to_tensor(src), rdec, paddle.to_tensor(tgt)], [])
    rstep.sync_to_model()
    step = JittedTrainStep(model, lambda out: out[0],
                           AdamW(1e-3, parameters=model.parameters()))
    step([torch.from_numpy(src), dec, torch.from_numpy(tgt)], [])
    assert model.t5.shared.weight is shared \
        and model.t5.encoder.embed_tokens.weight is shared
    want = paddle_tpu_arrays_to_port(model, _arrays(ref))["t5.shared.weight"]
    assert float(np.abs(shared.detach().numpy() - want).max()) <= \
        1e-5 * float(np.abs(want).max())


def test_prepare_decoder_input_ids_and_defaults():
    _, model = _pair(seed=3)
    labels = np.array([[5, 6, -100, -100], [7, -100, 8, 9]], np.int64)
    got = model.prepare_decoder_input_ids(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(got, [[0, 5, 6, 0], [0, 7, 0, 8]])
    cfg = T5Config()
    assert (cfg.vocab_size, cfg.d_model, cfg.d_kv, cfg.d_ff, cfg.num_layers,
            cfg.num_heads) == (32128, 512, 64, 2048, 6, 8)
    assert isinstance(model.t5, T5Model)
