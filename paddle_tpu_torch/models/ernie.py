"""ERNIE-3.0 / BERT-style encoder with the MLM pretraining head and the
sequence classifier (counterpart of paddle_tpu/models/ernie.py:19-163).

Learned position and token-type embeddings, a post-LN transformer
encoder (nn.TransformerEncoder: the flash kernels on the card), a pooler
and an MLM head tied to the word embeddings. Parameter names and their
registration order are the JAX package's, so `named_parameters()` (and
with it the fused AdamW bucket's flat layout and stochastic-rounding
indices) line up. ERNIE-3.0-base: 12 layers, hidden 768, 12 heads, ffn
3072, vocab 40000.
"""
from __future__ import annotations

import torch

from .. import nn
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..nn import functional as F


class ErnieEmbeddings(nn.Layer):
    def __init__(self, vocab_size, hidden_size, max_position_embeddings=512, type_vocab_size=4,
                 pad_token_id=0, hidden_dropout_prob=0.1, weight_attr=None):
        super().__init__()
        self.word_embeddings = nn.Embedding(vocab_size, hidden_size, padding_idx=pad_token_id,
                                            weight_attr=weight_attr)
        self.position_embeddings = nn.Embedding(max_position_embeddings, hidden_size,
                                                weight_attr=weight_attr)
        self.token_type_embeddings = nn.Embedding(type_vocab_size, hidden_size,
                                                  weight_attr=weight_attr)
        self.layer_norm = nn.LayerNorm(hidden_size)
        self.dropout = nn.Dropout(hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device).unsqueeze(0)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        emb = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
               + self.token_type_embeddings(token_type_ids))
        return self.dropout(self.layer_norm(emb))


class ErniePooler(nn.Layer):
    def __init__(self, hidden_size, weight_attr=None):
        super().__init__()
        self.dense = nn.Linear(hidden_size, hidden_size, weight_attr=weight_attr)
        self.activation = nn.Tanh()

    def forward(self, hidden_states):
        return self.activation(self.dense(hidden_states[:, 0]))


class ErnieModel(nn.Layer):
    def __init__(self, vocab_size=40000, hidden_size=768, num_hidden_layers=12,
                 num_attention_heads=12, intermediate_size=3072, hidden_act="gelu",
                 hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
                 max_position_embeddings=512, type_vocab_size=4, initializer_range=0.02,
                 pad_token_id=0):
        super().__init__()
        self.pad_token_id = pad_token_id
        # one Normal(0, initializer_range) for every Linear and Embedding weight
        attr = nn.ParamAttr(initializer=nn.initializer.Normal(0.0, initializer_range))
        self.embeddings = ErnieEmbeddings(vocab_size, hidden_size, max_position_embeddings,
                                          type_vocab_size, pad_token_id, hidden_dropout_prob,
                                          weight_attr=attr)
        encoder_layer = nn.TransformerEncoderLayer(
            hidden_size, num_attention_heads, intermediate_size, dropout=hidden_dropout_prob,
            activation=hidden_act, attn_dropout=attention_probs_dropout_prob, act_dropout=0.0,
            weight_attr=attr)
        self.encoder = nn.TransformerEncoder(encoder_layer, num_hidden_layers)
        self.pooler = ErniePooler(hidden_size, weight_attr=attr)
        self._init_attr = attr

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        if attention_mask is not None:
            # [B, S] of 1 (attend) / 0 (padding) -> additive [B, 1, 1, S]
            attention_mask = (attention_mask.float()[:, None, None, :] - 1.0) * 1e4
        emb = self.embeddings(input_ids, token_type_ids, position_ids)
        encoded = self.encoder(emb, attention_mask)
        return encoded, self.pooler(encoded)


class ErnieForMaskedLM(nn.Layer):
    """The MLM head, its decoder tied to the word embeddings. With
    `labels` the loss is the fused linear cross-entropy against the [V, H]
    embedding (no [N, V] f32 logits kept); without, the logits."""

    def __init__(self, ernie: ErnieModel = None, **config):
        super().__init__()
        self.ernie = ernie or ErnieModel(**config)
        hidden = self.ernie.pooler.dense.in_features
        self.transform = nn.Linear(hidden, hidden, weight_attr=self.ernie._init_attr)
        self.layer_norm = nn.LayerNorm(hidden)
        vocab = self.ernie.embeddings.word_embeddings.weight.shape[0]
        self.decoder_bias = self.create_parameter([vocab], is_bias=True)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None,
                labels=None):
        encoded, _ = self.ernie(input_ids, token_type_ids, position_ids, attention_mask)
        h = self.layer_norm(F.gelu(self.transform(encoded)))
        E = self.ernie.embeddings.word_embeddings.weight
        if labels is not None:
            loss = fused_linear_cross_entropy(h, E, labels, bias=self.decoder_bias,
                                              ignore_index=-100, transpose_weight=True)
            return loss, None
        return F.linear(h, E.t()) + self.decoder_bias


class ErnieForSequenceClassification(nn.Layer):
    """The pooled [CLS] state, dropout, then a Linear to `num_classes`
    logits (PaddleNLP's fine-tuning head). With an `attention_mask`
    (1 attend, 0 padding) attention takes the plain chain, as in the JAX
    package."""

    def __init__(self, ernie: ErnieModel = None, num_classes=2, dropout=0.1, **config):
        super().__init__()
        self.ernie = ernie or ErnieModel(**config)
        hidden = self.ernie.pooler.dense.in_features
        self.dropout = nn.Dropout(dropout)
        self.classifier = nn.Linear(hidden, num_classes, weight_attr=self.ernie._init_attr)

    def forward(self, input_ids, token_type_ids=None, position_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, position_ids, attention_mask)
        return self.classifier(self.dropout(pooled))


def ernie_3_0_base(**kw):
    cfg = dict(vocab_size=40000, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
               intermediate_size=3072)
    cfg.update(kw)
    return ErnieModel(**cfg)


def ernie_3_0_medium(**kw):
    cfg = dict(vocab_size=40000, hidden_size=768, num_hidden_layers=6, num_attention_heads=12,
               intermediate_size=3072)
    cfg.update(kw)
    return ErnieModel(**cfg)


def ernie_tiny(**kw):
    """Small config for tests."""
    cfg = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=128, max_position_embeddings=128)
    cfg.update(kw)
    return ErnieModel(**cfg)
