"""scaled_dot_product_attention in paddle's [B, S, H, D] layout
(counterpart of paddle_tpu/nn/functional/attention.py:82).

On CUDA every call the flash kernel can take goes to it, whatever S is:
the JAX package's multiple-of-128 rule and its S >= 512 gate
(`_FLASH_MIN_SK`) were measured on a TPU and do not carry over. The plain
chain runs only where the JAX package never runs its kernel either: an
`attn_mask` is given, causal with sk < sq, or head_dim > 256.
"""
from __future__ import annotations

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
