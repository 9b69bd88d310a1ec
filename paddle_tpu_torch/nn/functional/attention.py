"""Attention functionals in paddle's [B, S, H, D] layout (counterpart of
paddle_tpu/nn/functional/attention.py): scaled_dot_product_attention,
flash_attention, flash_attn_unpadded, sparse_attention and
flash_attention_with_sparse_mask.

On CUDA every call the flash kernel can take goes to it, whatever S is:
the JAX package's multiple-of-128 rule and its S >= 512 gate
(`_FLASH_MIN_SK`) were measured on a TPU and do not carry over. The plain
chain runs only where the JAX package never runs its kernel either: an
`attn_mask` is given, causal with sk < sq, or head_dim > 256.
flash_attention and flash_attn_unpadded take that same rule (the latter
per sequence); sparse_attention and flash_attention_with_sparse_mask run
the plain masked chain, as in the JAX package.
"""
from __future__ import annotations

import math

import torch

from ...framework import random as _random
from ...ops._common import _t

from ...amp import amp_cast_inputs
from ...ops import attention as _attn


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, dropout_seed=None):
    """[B, S, H, D] attention; key/value may carry fewer heads (GQA).
    Dropout applies only when `training`, from the position hash keyed by
    `dropout_seed` (None draws one from the framework generator). Under
    AMP the inputs cast as the white-listed op (to the AMP dtype, bf16 or
    float16, under O1); the flash kernels take either."""
    query, key, value, attn_mask = amp_cast_inputs(
        "scaled_dot_product_attention", [query, key, value, attn_mask])
    p_drop = float(dropout_p) if training else 0.0
    _attn._check_heads(query, key, value)
    sq, sk, d = query.shape[1], key.shape[1], query.shape[-1]
    plain = attn_mask is not None or (is_causal and sk < sq) or d > 256
    if not plain:
        return _attn.flash_attention_bshd(query, key, value, causal=is_causal,
                                          dropout_p=p_drop, dropout_seed=dropout_seed)
    return _attn.ref_attention_bshd(query, key, value, causal=is_causal, dropout_p=p_drop,
                                    seed=dropout_seed, mask=attn_mask)


def flash_attention(query, key, value, dropout=0.0, causal=False, return_softmax=False,
                    fixed_seed_offset=None, rng_name="", training=True, name=None):
    """(out, None): scaled_dot_product_attention without a mask. The
    softmax (return_softmax=True) is a debugging output of paddle's and
    raises, as in the JAX package."""
    if return_softmax:
        raise NotImplementedError("flash_attention return_softmax=True is not supported")
    return scaled_dot_product_attention(query, key, value, None, dropout, causal, training), None


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                        max_seqlen_k, scale=None, dropout=0.0, causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True, name=None):
    """(out, None) for sequences packed without padding: query [total_q, H,
    D] and key/value [total_k, Hkv, D], sequence i at rows cu_seqlens[i] to
    cu_seqlens[i + 1] (read on the host). Each sequence is one
    scaled_dot_product_attention call, so the flash kernel where its rule
    allows. `scale` (default 1/sqrt(D)) is applied to q first. The JAX
    package raises here."""
    if return_softmax:
        raise NotImplementedError("flash_attn_unpadded return_softmax=True is not supported")
    q, k, v = _t(query), _t(key), _t(value)
    d = q.shape[-1]
    if scale is not None and scale != 1.0 / math.sqrt(d):
        q = q * (scale * math.sqrt(d))
    cq = _t(cu_seqlens_q).tolist()
    ck = _t(cu_seqlens_k).tolist()
    outs = [scaled_dot_product_attention(q[None, cq[i]:cq[i + 1]], k[None, ck[i]:ck[i + 1]],
                                         v[None, ck[i]:ck[i + 1]], None, dropout, causal,
                                         training)[0]
            for i in range(len(cq) - 1)]
    return torch.cat(outs, dim=0), None


def _masked_probs(q, k, keep):
    """softmax over the kept scores of f32 q.k^T / sqrt(D) ([B, H, S, D]
    inputs), in f32; rows with nothing kept all zero."""
    logits = q.float() @ k.float().transpose(-1, -2) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~keep, -math.inf)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(keep.any(-1, keepdim=True), p, 0.0)
    return p


def sparse_attention(query, key, value, sparse_csr_offset, sparse_csr_columns,
                     key_padding_mask=None, attn_mask=None, name=None):
    """CSR-sparse attention over [B, H, S, D]: offset [B, H, S + 1] and
    columns [B, H, nnz] mark the kept scores; key_padding_mask [B, S] and
    attn_mask [S, S] drop where 0. The pattern becomes a dense [B, H, S, S]
    mask over the plain chain (the JAX package's dense path; it switches to
    a blocked scan of the same numerics above S = 2048, which the port does
    not have)."""
    q, k, v = _t(query), _t(key), _t(value)
    offs, cols = _t(sparse_csr_offset).long(), _t(sparse_csr_columns).long()
    B, H, S, _ = q.shape
    nnz = cols.shape[-1]
    flat_offs = offs.reshape(B * H, S + 1)
    j = torch.arange(nnz, device=q.device).expand(B * H, nnz).contiguous()
    rows = (torch.searchsorted(flat_offs, j, right=True) - 1).clamp(0, S - 1)
    valid = j < flat_offs[:, -1:]
    # a float scatter (CUDA has no bool one): 1 where a valid entry lands
    hits = torch.zeros(B * H, S * S, device=q.device).scatter_reduce(
        1, rows * S + cols.reshape(B * H, nnz).clamp(0, S - 1), valid.float(), reduce="amax")
    keep = (hits > 0).reshape(B, H, S, S)
    if key_padding_mask is not None:
        keep = keep & (_t(key_padding_mask)[:, None, None, :] != 0)
    if attn_mask is not None:
        keep = keep & (_t(attn_mask)[None, None] != 0)
    p = _masked_probs(q, k, keep)
    return p.to(v.dtype) @ v


def flash_attention_with_sparse_mask(query, key, value, attn_mask_start_row_indices,
                                     attn_mask_start_row=0, dropout_p=0.0, is_causal=False,
                                     training=True, name=None):
    """[B, S, H, D] attention where score column j is masked from row
    attn_mask_start_row_indices[b, h, j] on (and above the diagonal with
    is_causal); the plain chain, dropout from the framework generator."""
    q, k, v = (_t(t).transpose(1, 2) for t in (query, key, value))
    S = q.shape[2]
    rows = torch.arange(S, device=q.device)[None, None, :, None]
    keep = rows < _t(attn_mask_start_row_indices).long()[:, :, None, :]
    if is_causal:
        keep = keep & (torch.arange(S, device=q.device)[None, None, None, :] <= rows)
    p = _masked_probs(q, k, keep)
    if dropout_p > 0.0 and training:
        drop_keep = torch.rand(p.shape, generator=_random.generator(p.device),
                               device=p.device) < 1.0 - dropout_p
        p = torch.where(drop_keep, p / (1.0 - dropout_p), 0.0)
    return (p.to(v.dtype) @ v).transpose(1, 2)

# each public op is one recorded op of a static capture (core/record.py)
from ...core.record import record_module as _record_module  # noqa: E402

_record_module(globals())
