"""BERT / ERNIE family in PyTorch (counterpart of
``paddle_tpu/nlp/bert.py``; BASELINE.md config #4 is ERNIE-3.0 pretraining
under the auto-parallel ``Engine``).

Built from the port's ``TransformerEncoder`` (post-norm), ``LayerNorm``
and ``Embedding``, with the reference's module names, so the reference's
``state_dict`` keys carry with :func:`~paddle_tpu_torch.nlp.convert.
load_paddle_tpu_arrays`. ERNIE is BERT's graph under ERNIE-3.0 base's
widths (``ErnieConfig``); there is no task-type embedding, as in the
reference.

BERT always attends under an additive mask (from ``attention_mask``, or
derived from ``pad_token_id``), so its attention takes the plain f32 path
of ``F.scaled_dot_product_attention`` on every device, as the reference's
takes XLA's.

The masked-LM head ties its decoder to the word embedding: the head holds
the embedding's Parameter without registering it (the reference's
``state_dict`` lists the table once, as
``bert.embeddings.word_embeddings.weight``), so the carry writes one
Parameter, ``named_parameters()`` yields it once, and a train step
updates it once with the sum of both uses' gradients.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from ..nn import functional as F
from ..nn.functional.common import torch_linear
from ..nn.layer.common import Dropout, Embedding, Linear
from ..nn.layer.norm import LayerNorm
from ..nn.layer.transformer import TransformerEncoder, TransformerEncoderLayer
from ..nn.layer.layers import Layer

__all__ = [
    "BertConfig", "BertModel", "BertForPretraining",
    "BertForSequenceClassification", "BertPretrainingCriterion",
    "BertEmbeddings", "BertPooler", "BertLMPredictionHead",
    "ErnieConfig", "ErnieModel", "ErnieForPretraining",
]

# additive bias of a masked key (the reference's)
_MASKED = -1e9


class BertConfig:
    """Configuration; the same fields and defaults as the reference's."""

    def __init__(self, vocab_size=30522, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=2,
                 initializer_range=0.02, layer_norm_eps=1e-12,
                 pad_token_id=0, num_labels=2):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.intermediate_size = intermediate_size
        self.hidden_act = hidden_act
        self.hidden_dropout_prob = hidden_dropout_prob
        self.attention_probs_dropout_prob = attention_probs_dropout_prob
        self.max_position_embeddings = max_position_embeddings
        self.type_vocab_size = type_vocab_size
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.pad_token_id = pad_token_id
        self.num_labels = num_labels

    @classmethod
    def tiny(cls, **overrides):
        cfg = dict(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=64, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
        cfg.update(overrides)
        return cls(**cfg)


@torch.no_grad()
def _init_weights(modules, generator):
    """The reference's initializers: Linear weights Xavier-normal and
    biases 0, embeddings N(0, 1); LayerNorms stay at 1 and 0."""
    for root in modules:
        for mod in root.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                                   generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=generator)
            elif isinstance(mod, BertLMPredictionHead) \
                    and mod._tied_to is None:
                v, e = mod._tied.shape
                mod._tied.normal_(0.0, math.sqrt(2.0 / (v + e)),
                                  generator=generator)


def _device_and_generator(device, generator):
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    return dev, generator


class BertEmbeddings(Layer):
    def __init__(self, config, device=None):
        super().__init__()
        kw = dict(device=device)
        e = config.hidden_size
        self.word_embeddings = Embedding(config.vocab_size, e, **kw)
        self.position_embeddings = Embedding(
            config.max_position_embeddings, e, **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, e,
                                               **kw)
        self.layer_norm = LayerNorm(e, config.layer_norm_eps, **kw)
        self.dropout = Dropout(config.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        b, s = input_ids.shape
        if position_ids is None:
            position_ids = torch.arange(
                s, device=input_ids.device).expand(b, s)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids)
               + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class BertPooler(Layer):
    def __init__(self, config, device=None):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size,
                            device=device)

    def forward(self, hidden):
        return F.tanh(self.dense(hidden[:, 0]))


def additive_mask(attention_mask):
    """The reference's mask rule, as an f32 bias broadcastable to (B, H,
    Sq, Sk): a 4-D mask passes through (as f32); a 2-D float mask is
    already additive; a bool or integer keep-mask gives 0 where kept and
    -1e9 where masked."""
    if attention_mask.dim() == 4:
        return attention_mask.float()
    base = attention_mask[:, None, None, :]
    if base.is_floating_point():
        return base.float()
    return torch.where(base.bool(), 0.0, _MASKED).float()


class BertModel(Layer):
    """Embeddings, a post-norm ``TransformerEncoder`` and the pooler.
    Built on ``device`` (default ``cuda``; raises without CUDA unless
    ``device="cpu"``) in f32, with weights drawn from ``generator`` (a
    ``torch.Generator`` on that device; seed 0 when omitted) by the
    reference's initializers. Returns ``(hidden, pooled)``."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        dev, generator = _device_and_generator(device, generator)
        self.config = config
        self.embeddings = BertEmbeddings(config, device=dev)
        layer = TransformerEncoderLayer(
            config.hidden_size, config.num_attention_heads,
            config.intermediate_size, dropout=config.hidden_dropout_prob,
            activation=config.hidden_act,
            attn_dropout=config.attention_probs_dropout_prob,
            layer_norm_eps=config.layer_norm_eps, device=dev)
        self.encoder = TransformerEncoder(layer, config.num_hidden_layers)
        self.pooler = BertPooler(config, device=dev)
        _init_weights([self], generator)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None):
        if attention_mask is None:
            # pads derived from pad_token_id, as the reference
            attention_mask = input_ids != self.config.pad_token_id
        mask = additive_mask(attention_mask.to(input_ids.device))
        hidden = self.embeddings(input_ids, token_type_ids, position_ids)
        hidden = self.encoder(hidden, mask)
        return hidden, self.pooler(hidden)


class BertLMPredictionHead(Layer):
    """Transform, LayerNorm and a decoder over the (V, E) word-embedding
    table ``embedding_weights`` (held, not registered: tied). Without it
    the head registers a table of its own as ``_tied`` (the reference's
    name), drawn by the model's initializers."""

    def __init__(self, config, embedding_weights=None, device=None):
        super().__init__()
        e, v = config.hidden_size, config.vocab_size
        self.transform = Linear(e, e, device=device)
        self.layer_norm = LayerNorm(e, config.layer_norm_eps, device=device)
        if embedding_weights is None:
            self._tied = nn.Parameter(nn.init.xavier_normal_(
                torch.empty(v, e, device=device)))
            self._tied_to = None
        else:
            self._tied_to = (embedding_weights,)
        self.decoder_bias = nn.Parameter(torch.zeros(v, device=device))
        self._act = getattr(F, config.hidden_act)

    @property
    def decoder_weight(self):
        """The (V, E) table the decoder multiplies by."""
        return self._tied if self._tied_to is None else self._tied_to[0]

    def forward(self, hidden):
        h = self.layer_norm(self._act(self.transform(hidden)))
        return torch_linear(h, self.decoder_weight, self.decoder_bias)


class BertForPretraining(Layer):
    """MLM + NSP heads over ``BertModel``; returns ``(prediction_scores
    (B, S, V), seq_relationship_score (B, 2))``. Device and weights as
    :class:`BertModel`."""

    def __init__(self, config, device=None, generator=None):
        super().__init__()
        dev, generator = _device_and_generator(device, generator)
        self.config = config
        self.bert = BertModel(config, device=dev, generator=generator)
        self.cls = BertLMPredictionHead(
            config, self.bert.embeddings.word_embeddings.weight, device=dev)
        self.nsp = Linear(config.hidden_size, 2, device=dev)
        _init_weights([self.cls, self.nsp], generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        hidden, pooled = self.bert(input_ids, token_type_ids,
                                   attention_mask=attention_mask)
        return self.cls(hidden), self.nsp(pooled)


class BertPretrainingCriterion(Layer):
    """Masked-LM loss (mean over the positions whose label is not
    ``ignore_index``, at least one), plus the next-sentence loss when
    ``next_sentence_labels`` is given; both in f32."""

    def __init__(self, vocab_size=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, prediction_scores, seq_relationship_score,
                masked_lm_labels, next_sentence_labels=None):
        v = prediction_scores.shape[-1]
        loss = F.cross_entropy(prediction_scores.reshape(-1, v),
                               masked_lm_labels.reshape(-1),
                               ignore_index=self.ignore_index)
        if next_sentence_labels is not None:
            loss = loss + F.cross_entropy(seq_relationship_score,
                                          next_sentence_labels.reshape(-1))
        return loss


class BertForSequenceClassification(Layer):
    def __init__(self, config, device=None, generator=None):
        super().__init__()
        dev, generator = _device_and_generator(device, generator)
        self.bert = BertModel(config, device=dev, generator=generator)
        self.dropout = Dropout(config.hidden_dropout_prob)
        self.classifier = Linear(config.hidden_size, config.num_labels,
                                 device=dev)
        _init_weights([self.classifier], generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.bert(input_ids, token_type_ids,
                              attention_mask=attention_mask)
        return self.classifier(self.dropout(pooled))


# -- ERNIE: BERT's graph under ERNIE-3.0 base's defaults ---------------------
class ErnieConfig(BertConfig):
    def __init__(self, vocab_size=40000, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu", **kw):
        super().__init__(
            vocab_size=vocab_size, hidden_size=hidden_size,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            intermediate_size=intermediate_size, hidden_act=hidden_act, **kw)


class ErnieModel(BertModel):
    pass


class ErnieForPretraining(BertForPretraining):
    pass
