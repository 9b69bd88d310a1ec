"""Transformer encoder layers (counterpart of
paddle_tpu/nn/layers/transformer.py:19-156), [B, S, E] activations.

Attention runs through functional.scaled_dot_product_attention in [B, S,
H, D]: the flash kernels on the card when no mask is given, the plain
chain under an additive mask (as in the JAX package). The decoding caches
(`cache=`, `gen_cache`) are not ported and raise.
"""
from __future__ import annotations

import copy

import torch

from .. import functional as F
from ..layer import Layer
from .common import Dropout, Linear
from .norm import LayerNorm


def _no_cache(cache) -> None:
    if cache is not None:
        raise NotImplementedError("attention caches are not ported")


class MultiHeadAttention(Layer):
    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None, need_weights=False,
                 weight_attr=None, bias_attr=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        if self.head_dim * num_heads != embed_dim:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of num_heads {num_heads}")
        self.dropout = dropout
        self.q_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, weight_attr, bias_attr)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, weight_attr, bias_attr)
        self.out_proj = Linear(embed_dim, embed_dim, weight_attr, bias_attr)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None):
        _no_cache(cache)
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        out = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
                                             training=self.training)
        return self.out_proj(out.reshape(out.shape[0], out.shape[1], self.embed_dim))


class TransformerEncoderLayer(Layer):
    """Post-LN (the default) or pre-LN (normalize_before=True)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1, activation="relu",
                 attn_dropout=None, act_dropout=None, normalize_before=False, weight_attr=None,
                 bias_attr=None, layer_norm_eps=1e-5):
        super().__init__()
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead,
                                            dropout if attn_dropout is None else attn_dropout,
                                            weight_attr=weight_attr, bias_attr=bias_attr)
        self.linear1 = Linear(d_model, dim_feedforward, weight_attr, bias_attr)
        self.linear2 = Linear(dim_feedforward, d_model, weight_attr, bias_attr)
        self.norm1 = LayerNorm(d_model, layer_norm_eps)
        self.norm2 = LayerNorm(d_model, layer_norm_eps)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.activation_dropout = Dropout(dropout if act_dropout is None else act_dropout)
        self._activation = getattr(F, activation)

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src, src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.activation_dropout(self._activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(Layer):
    """`num_layers` layers: `encoder_layer` and deep copies of it, so every
    layer starts from the same weights (as in paddle)."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = torch.nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer) for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        _no_cache(cache)
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out
