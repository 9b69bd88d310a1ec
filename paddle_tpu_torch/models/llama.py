"""Llama decoder-only LM with the training loss and the serving cache mode
(counterpart of paddle_tpu/models/llama.py).

`forward(ids, labels=)` returns (loss, None): the fused LM-head
cross-entropy of h[:, :-1] against labels[:, 1:].

`forward(ids, cache=, positions=, last_index=)`: with `cache` (an
inference/kv_cache.PagedCacheView) a prefill (positions=None) writes the
prompt's K/V into the pool pages and runs causal attention through the
flash kernel; decode (one token) and extend (several) write at
`positions` and read the whole context back through the paged-attention
kernel. Linear weights are torch's [out, in]; utils/convert.py carries
the JAX package's [in, out] weights across.
"""
from __future__ import annotations

import functools
import inspect
import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as TF

from ..core import record as _record
from ..framework import device as _device
from ..framework import dtype as _dtype
from ..framework import random as _random
from ..incubate.nn.functional import fused_linear_cross_entropy
from ..nn import functional as F
from ..nn.layers import Linear, RMSNorm
from ..ops.attention import flash_decode_paged, flash_decode_paged_multi

_ROPE_POS_GRANULE = 512  # table length rounds up to this (bounds cache entries)


@functools.lru_cache(maxsize=8)
def _rope_tables(max_pos: int, d: int, pos_base: float):
    """cos/sin [max_pos, d/2] as numpy f32, computed exactly as the JAX
    package computes them."""
    inv = 1.0 / (pos_base ** (np.arange(0, d, 2, dtype=np.float32) / d))
    t = np.arange(max_pos, dtype=np.float32)
    freqs = np.outer(t, inv)
    return np.cos(freqs), np.sin(freqs)


@functools.lru_cache(maxsize=8)
def _rope_tables_on(max_pos: int, d: int, pos_base: float, device: str):
    cos, sin = _rope_tables(max_pos, d, pos_base)
    # normal tensors even when first built under the engine's inference
    # mode: autograd may not save inference tensors for a later backward
    with torch.inference_mode(False):
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rope(q, k, pos_base=10000.0, positions=None, max_pos=None):
    """Rotary embeddings on [B, S, H, D] q/k with the INTERLEAVED pairing
    (x[..., 0::2], x[..., 1::2]) of the JAX package, not the rotate-half
    pairing of other Llama ports. positions=None places the tokens at
    0..S-1; [B, S] int positions give each token its own offset."""
    b, s, h, d = q.shape
    if max_pos is None:
        max_pos = s if positions is None else int(positions.max()) + 1
    cap = -(-max(int(max_pos), 1) // _ROPE_POS_GRANULE) * _ROPE_POS_GRANULE
    cos_t, sin_t = _rope_tables_on(cap, d, float(pos_base), str(q.device))
    if positions is None:
        cos, sin = cos_t[:s][None, :, None, :], sin_t[:s][None, :, None, :]
    else:
        idx = positions.long()
        cos, sin = cos_t[idx][:, :, None, :], sin_t[idx][:, :, None, :]

    def rot(x):
        x1, x2 = x[..., 0::2], x[..., 1::2]
        xr1 = x1 * cos - x2 * sin
        xr2 = x2 * cos + x1 * sin
        return torch.stack([xr1, xr2], dim=-1).reshape(x.shape).to(x.dtype)

    return rot(q), rot(k)


def _split_heads(x, n_heads):
    """[B, S, n_heads * D] -> [B, S, n_heads, D] (a view)."""
    return x.unflatten(-1, (n_heads, x.shape[-1] // n_heads))


def _merge_heads(x):
    """[B, S, H, D] -> [B, S, H * D]."""
    return x.flatten(2)


class LlamaAttention(nn.Module):
    def __init__(self, hidden_size, num_heads, num_kv_heads=None, device=None, dtype=None):
        super().__init__()
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = hidden_size // num_heads
        self.layer_idx = 0  # position in the decoder stack (set by LlamaModel)
        self.q_proj = Linear(hidden_size, num_heads * self.head_dim, **kw)
        self.k_proj = Linear(hidden_size, self.num_kv_heads * self.head_dim, **kw)
        self.v_proj = Linear(hidden_size, self.num_kv_heads * self.head_dim, **kw)
        self.o_proj = Linear(num_heads * self.head_dim, hidden_size, **kw)

    def forward(self, x, cache=None, positions=None):
        # heads split and merged without reading B or S: a captured Program
        # records a "reshape" whose replay takes any batch and length (no
        # literal of the dry run's), so a -1 feed dim stays free when the
        # Program is exported
        q = _record.apply("reshape", _split_heads, self.q_proj(x), self.num_heads)
        k = _record.apply("reshape", _split_heads, self.k_proj(x), self.num_kv_heads)
        v = _record.apply("reshape", _split_heads, self.v_proj(x), self.num_kv_heads)

        if cache is None:
            q, k = _record.apply("rope", _rope, q, k)
            # GQA: k/v stay at num_kv_heads; the flash kernel maps q heads
            # to their kv head itself
            out = F.scaled_dot_product_attention(q, k, v, is_causal=True, training=self.training)
            return self.o_proj(_record.apply("reshape", _merge_heads, out))

        # ---- serving cache mode (inference only) ----
        b, s = x.shape[0], x.shape[1]
        max_pos = cache.block_tables.shape[1] * cache.block_size
        if positions is None:
            pos2d = torch.arange(s, dtype=torch.int32, device=x.device)[None].expand(b, s)
        else:
            pos2d = positions.to(torch.int32).reshape(b, -1)
        qr, kr = _rope(q, k, positions=pos2d, max_pos=max_pos)
        cache.write(self.layer_idx, kr, v, pos2d)
        if positions is None:
            # prefill: the context IS this call's k/v; the padded tail's
            # rows are discarded by the caller
            out = F.scaled_dot_product_attention(qr, kr, v, is_causal=True, training=False)
        else:
            kp, vp = cache.layer(self.layer_idx)
            ks, vs = cache.scales(self.layer_idx)
            if s == 1:
                out = flash_decode_paged(qr[:, 0], kp, vp, cache.block_tables, cache.seq_lens,
                                         k_scales=ks, v_scales=vs)[:, None]
            else:
                # extend/verify: every query reads the paged context up
                # through its own position (all s tokens were just written)
                out = flash_decode_paged_multi(qr, kp, vp, cache.block_tables, pos2d,
                                               k_scales=ks, v_scales=vs)
        return self.o_proj(_merge_heads(out))


class LlamaMLP(nn.Module):
    def __init__(self, hidden_size, intermediate_size, device=None, dtype=None):
        super().__init__()
        kw = dict(bias_attr=False, device=device, dtype=dtype)
        self.gate_proj = Linear(hidden_size, intermediate_size, **kw)
        self.up_proj = Linear(hidden_size, intermediate_size, **kw)
        self.down_proj = Linear(intermediate_size, hidden_size, **kw)

    def forward(self, x):
        return self.down_proj(TF.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, hidden_size, num_heads, intermediate_size, num_kv_heads=None,
                 rms_eps=1e-6, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.input_layernorm = RMSNorm(hidden_size, rms_eps, **kw)
        self.self_attn = LlamaAttention(hidden_size, num_heads, num_kv_heads, **kw)
        self.post_attention_layernorm = RMSNorm(hidden_size, rms_eps, **kw)
        self.mlp = LlamaMLP(hidden_size, intermediate_size, **kw)

    def forward(self, x, cache=None, positions=None):
        x = x + self.self_attn(self.input_layernorm(x), cache=cache, positions=positions)
        return x + self.mlp(self.post_attention_layernorm(x))


class LlamaModel(nn.Module):
    def __init__(self, vocab_size=32000, hidden_size=512, num_hidden_layers=4,
                 num_attention_heads=8, num_key_value_heads=None, intermediate_size=1376,
                 rms_norm_eps=1e-6, recompute=False, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.embed_tokens = nn.Embedding(vocab_size, hidden_size, **kw)
        self.layers = nn.ModuleList([
            LlamaDecoderLayer(hidden_size, num_attention_heads, intermediate_size,
                              num_key_value_heads, rms_norm_eps, **kw)
            for _ in range(num_hidden_layers)
        ])
        for i, layer in enumerate(self.layers):
            layer.self_attn.layer_idx = i
        self.norm = RMSNorm(hidden_size, rms_norm_eps, **kw)
        # activation recompute on the decoder layers: in training each layer
        # keeps only its input and runs again in the backward (~1/3 more
        # compute for O(layers) less activation memory)
        self.recompute = recompute

    def forward(self, input_ids, cache=None, positions=None):
        from ..distributed.fleet.recompute import recompute as _ckpt

        x = self.embed_tokens(input_ids)
        for layer in self.layers:
            if cache is not None:
                x = layer(x, cache=cache, positions=positions)
            elif self.recompute and self.training:
                x = _ckpt(layer, x)
            else:
                x = layer(x)
        return self.norm(x)


_CONFIG_DEFAULTS = {
    k: p.default
    for k, p in inspect.signature(LlamaModel.__init__).parameters.items()
    if p.default is not inspect.Parameter.empty and k not in ("device", "dtype")
}


def _xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    w.uniform_(-limit, limit, generator=gen)


class LlamaForCausalLM(nn.Module):
    """`LlamaForCausalLM(**config)`: the config keys of LlamaModel. The
    weights are created on `device` (default: the framework device) in
    `dtype` (default: the framework default dtype) and drawn from the
    framework generator of that device with the JAX package's Xavier-
    uniform rule; device="meta" allocates nothing (for loading)."""

    def __init__(self, device=None, dtype=None, **config):
        super().__init__()
        dev = torch.device("meta") if str(device) == "meta" else _device.resolve(device)
        dt = _dtype.convert_dtype(dtype) if dtype is not None else _dtype.get_default_dtype()
        unknown = set(config) - set(_CONFIG_DEFAULTS)
        if unknown:
            raise TypeError(f"unknown Llama config keys {sorted(unknown)}")
        self.config = {**_CONFIG_DEFAULTS, **config}
        meta = dict(device="meta", dtype=dt)
        self.llama = LlamaModel(**config, **meta)
        hidden = self.config["hidden_size"]
        self.lm_head = Linear(hidden, self.config["vocab_size"], bias_attr=False, **meta)
        if dev.type != "meta":
            self.to_empty(device=dev)
            self.reset_parameters(_random.generator(dev))

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        for m in self.modules():
            if isinstance(m, Linear):
                # paddle's Linear draws over its [in, out] weight: same fans
                _xavier_uniform_(m.weight, m.in_features, m.out_features, gen)
            elif isinstance(m, nn.Embedding):
                _xavier_uniform_(m.weight, m.num_embeddings, m.embedding_dim, gen)
            elif isinstance(m, RMSNorm):
                m.weight.fill_(1.0)

    def forward(self, input_ids, labels=None, cache=None, positions=None, last_index=None):
        h = self.llama(input_ids, cache=cache, positions=positions)
        if labels is not None:
            # fused LM head + shifted CE; lm_head.weight is [H, V]
            loss = fused_linear_cross_entropy(h[:, :-1], self.lm_head.weight, labels[:, 1:])
            return loss, None
        if last_index is not None:
            # one position per row before the LM head (prefill takes the
            # prompt's true last token; skips the [B, S, V] logits)
            idx = torch.as_tensor(last_index, device=h.device).long().reshape(-1)
            if idx.shape[0] == 1 and h.shape[0] != 1:
                idx = idx.expand(h.shape[0])
            h = h[torch.arange(h.shape[0], device=h.device), idx]
        return self.lm_head(h)


def llama_tiny(**kw):
    cfg = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
               intermediate_size=176)
    cfg.update(kw)
    return LlamaForCausalLM(**cfg)
