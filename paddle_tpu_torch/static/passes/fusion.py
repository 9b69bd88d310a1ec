"""DRR fusion passes: op clusters -> fused kernels (counterpart of
paddle_tpu/static/passes/fusion.py).

A "fused kernel" is either the port's flash-attention dispatch
(`fuse_attention`'s unfused-chain pattern swaps the canonical
matmul->scale->softmax->matmul chain for `ops.attention`'s flash call,
the CUDA kernel B1 on the card) or a mini-replay composition of the
cluster's own recorded fns (`build_cluster_instr` — bit-identical by
construction). Each pass reports match counts; chip_smoke.py's
static_llama_capture phase holds them at full width.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .drr import (
    Match,
    OpPat,
    Pattern,
    apply_matches,
    build_cluster_instr,
    find_matches,
)
from .pass_base import PassStats, ProgramPass, register_pass
from ..program import OpInstr


class PatternRewritePass(ProgramPass):
    """Shared driver: match every pattern (non-overlapping, to fixpoint)
    and replace each cluster via the pattern's builder."""

    #: list of (Pattern, builder(program, match) -> OpInstr)
    patterns = ()

    def run(self, program, ctx) -> PassStats:
        matches_total = 0
        removed_total = 0
        for _ in range(8):  # rewrites can expose new matches
            graph = ctx.graph()
            taken: set = set()
            round_matches = []
            for pattern, builder in self.patterns:
                for m in find_matches(program, graph, pattern, taken=taken):
                    round_matches.append((m, builder))
            if not round_matches:
                break
            removed_total += apply_matches(program, round_matches)
            matches_total += len(round_matches)
            ctx.invalidate()
        return PassStats(matches=matches_total, rewritten_ops=removed_total)


# ---------------------------------------------------------------------------
# probing: a recorded fn is the ground truth for closure-baked attributes
# ---------------------------------------------------------------------------

def _probe(op, var_values):
    """Run `op.fn` on tiny CPU tensors: var inputs come from `var_values`
    (numpy arrays by vid), literal inputs are the recorded literals.
    Returns the result as numpy, or None when the fn rejects the probe."""
    args = []
    for ref in op.in_refs:
        if ref[0] == "var":
            if ref[1] not in var_values:
                return None
            args.append(torch.from_numpy(var_values[ref[1]]))
        else:
            args.append(ref[1])
    try:
        with torch.no_grad():
            out = op.fn(*args, **op.kwargs)
    except Exception:
        return None
    if not isinstance(out, torch.Tensor):
        return None
    return out.detach().float().cpu().numpy()


def _close(a, b, tol=1e-5):
    if a is None:
        return False
    a = np.asarray(a)
    if a.shape != np.asarray(b).shape:
        return False
    return bool(np.allclose(a, np.asarray(b), rtol=tol, atol=tol))


def _softmax(x):
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# fuse_attention
# ---------------------------------------------------------------------------

def _meta4(graph, vid):
    info = graph.vars.get(vid)
    if info is None or info.shape is None or len(info.shape) != 4:
        return None
    return info


def _where_unfused_attention(program, graph, binding, op_indices):
    """The canonical softmax(QK^T/sqrt(d))V chain in [B, H, S, D] layout,
    proven by probing the recorded fns (transpose flags and the scale
    factor live in closures, not kwargs): matmul #1 must compute
    einsum(bhqd,bhkd->bhqk), the scale must be x * (1/sqrt(D)) with no
    bias, softmax must reduce the last axis, matmul #2 must compute
    einsum(bhqk,bhkd->bhqd)."""
    q = _meta4(graph, binding["q"])
    k = _meta4(graph, binding["k"])
    v = _meta4(graph, binding["v"])
    s0 = _meta4(graph, binding["s0"])
    if q is None or k is None or v is None or s0 is None:
        return False
    if q.shape != k.shape or k.shape != v.shape:
        return False  # same [B, H, S, D] for all three (no GQA in the chain)
    b, h, s, d = q.shape
    if s0.shape != (b, h, s, s):
        return False
    mm1, sc, sm, mm2 = (program.ops[i] for i in op_indices)
    rng = np.random.RandomState(0)
    qa = rng.randn(1, 1, 2, 3).astype(np.float32)
    ka = rng.randn(1, 1, 2, 3).astype(np.float32)
    got = _probe(mm1, {binding["q"]: qa, binding["k"]: ka})
    if not _close(got, np.einsum("bhqd,bhkd->bhqk", qa, ka)):
        return False
    ones = np.ones((1, 1, 2, 2), np.float32)
    zeros = np.zeros((1, 1, 2, 2), np.float32)
    s_val = _probe(sc, {binding["s0"]: ones})
    b_val = _probe(sc, {binding["s0"]: zeros})
    if s_val is None or b_val is None:
        return False
    if not np.allclose(np.asarray(b_val), 0.0):
        return False
    if not np.allclose(np.asarray(s_val), 1.0 / math.sqrt(d), rtol=1e-4):
        return False
    pa = rng.randn(1, 1, 2, 3).astype(np.float32)
    got = _probe(sm, {binding["s1"]: pa})
    if not _close(got, _softmax(pa)):
        return False
    pp = rng.rand(1, 1, 2, 2).astype(np.float32)
    va = rng.randn(1, 1, 2, 3).astype(np.float32)
    got = _probe(mm2, {binding["p"]: pp, binding["v"]: va})
    return _close(got, np.einsum("bhqk,bhkd->bhqd", pp, va))


def _fused_flash(qv, kv, vv):
    """The verified [B, H, S, D] chain as one call of the port's flash
    dispatch in [B, S, H, D] (`ops.attention.flash_attention_bshd`: the
    CUDA kernel B1 for CUDA tensors, its plain version for CPU ones).
    Head dims past 256 take the plain chain, as scaled_dot_product_attention
    does; nothing falls back quietly from a failed build or launch."""
    from ...ops import attention as _attn

    qs, ks, vs = (t.transpose(1, 2).contiguous() for t in (qv, kv, vv))
    if qs.shape[-1] > 256:
        out = _attn.ref_attention_bshd(qs, ks, vs, causal=False)
    else:
        out = _attn.flash_attention_bshd(qs, ks, vs, causal=False)
    return out.transpose(1, 2)


def _build_flash_replacement(program, match: Match) -> OpInstr:
    """Replace the verified chain with the flash dispatch. Numerics:
    online softmax legitimately reassociates the reduction — fp
    tolerance, not bit identity (the one shipped pattern with that
    contract)."""
    b = match.binding
    refs = [("var", b["q"]), ("var", b["k"]), ("var", b["v"])]
    roots = match.root_vids()
    return OpInstr("fused_flash_attention", _fused_flash, refs, {},
                   list(roots), [0], 1)


def _rope_sdpa_builder(program, match):
    return build_cluster_instr(program, match, "fused_rope_flash_attention")


@register_pass
class FuseAttentionPass(PatternRewritePass):
    """Attention clusters -> the flash path.

    Pattern 1 (`rope_sdpa`): rope(q, k) feeding scaled_dot_product_attention
    — the captured Llama shape. The fused op mini-replays the two
    recorded fns (bit-identical); sdpa's own fn already dispatches to the
    flash kernel B1 on the card, so the capture hits it with zero
    model-code changes.

    Pattern 2 (`unfused_attention`): the hand-written
    matmul->scale->softmax->matmul chain in [B, H, S, D] layout, probed
    op-by-op, swapped for the flash dispatch (fp tolerance — online
    softmax reassociates)."""

    name = "fuse_attention"
    patterns = (
        (
            Pattern(
                "rope_sdpa",
                [
                    OpPat("rope", ins=["q", "k"], outs=["qr", "kr"]),
                    OpPat(
                        "scaled_dot_product_attention",
                        ins=["qr", "kr", "v"], outs=["o"],
                        allow_extra_ins=True,  # in-kernel dropout seed
                    ),
                ],
                roots=["o"],
            ),
            _rope_sdpa_builder,
        ),
        (
            Pattern(
                "unfused_attention",
                [
                    OpPat("matmul", ins=["q", "k"], outs=["s0"]),
                    OpPat(("scale", "multiply"), ins=["s0"], outs=["s1"],
                          allow_extra_ins=False),
                    OpPat("softmax", ins=["s1"], outs=["p"],
                          allow_extra_ins=False),
                    OpPat("matmul", ins=["p", "v"], outs=["o"]),
                ],
                roots=["o"],
                where=_where_unfused_attention,
            ),
            _build_flash_replacement,
        ),
    )


# ---------------------------------------------------------------------------
# fuse_norm_matmul
# ---------------------------------------------------------------------------

def _norm_mm_builder(program, match):
    norm_op = program.ops[match.op_indices[0]]
    mm_op = program.ops[match.op_indices[1]]
    return build_cluster_instr(
        program, match, f"fused_{norm_op.name}_{mm_op.name}"
    )


@register_pass
class FuseNormMatmulPass(PatternRewritePass):
    """RMSNorm/LayerNorm whose (single-consumer) output feeds the LHS of a
    linear/matmul collapses into one fused op — the epilogue-fusion shape
    (reference fused_gemm_epilogue) approached from the norm side. The
    fused fn mini-replays the recorded norm and matmul fns: bit-identical,
    one recorded op (Llama: final norm -> lm_head)."""

    name = "fuse_norm_matmul"
    patterns = (
        (
            Pattern(
                "norm_matmul",
                [
                    OpPat(("rms_norm", "layer_norm"), ins=["x"], outs=["h"],
                          allow_extra_ins=True),  # norm weight/bias
                    OpPat(("linear", "matmul"), ins=["h"], outs=["y"],
                          allow_extra_ins=True),  # weight (+ bias)
                ],
                roots=["y"],
            ),
            _norm_mm_builder,
        ),
    )


# ---------------------------------------------------------------------------
# fuse_moe (dispatch -> expert FFN -> combine)
# ---------------------------------------------------------------------------

def _moe_builder(program, match):
    return build_cluster_instr(program, match,
                               "fused_moe_dispatch_expert_combine")


@register_pass
class FuseMoEDispatchCombinePass(PatternRewritePass):
    """The MoE data path — dispatch einsum -> batched expert FFN ->
    combine einsum — collapses into one op (reference fused_ec_moe /
    fused_moe approached GShard-side). MoELayer's fast path records this
    exact fixed-arity chain (`moe_dispatch_ec` -> `moe_expert_ffn` ->
    `moe_combine_ec`, incubate/.../moe_layer.py); routing stays OUTSIDE
    the cluster because its other outputs (aux loss, the on-device drop
    count) escape to the loss and the post-step telemetry read, so the
    tail is the largest legally fusible cluster. The fused fn mini-replays
    the recorded fns (bit-identical). The port has no MoE layer yet, so
    nothing it captures records these ops; the pass is kept so that the
    pipeline is the JAX package's."""

    name = "fuse_moe"
    patterns = (
        (
            Pattern(
                "moe_dispatch_expert_combine",
                [
                    OpPat("moe_dispatch_ec", ins=["d", "x"], outs=["ecm"],
                          allow_extra_ins=False),
                    OpPat("moe_expert_ffn", ins=["ecm"], outs=["eo"],
                          allow_extra_ins=True),  # stacked expert weights
                    OpPat("moe_combine_ec", ins=["c", "eo"], outs=["y"],
                          allow_extra_ins=False),
                ],
                roots=["y"],
            ),
            _moe_builder,
        ),
    )


# ---------------------------------------------------------------------------
# fuse_bias_dropout_residual
# ---------------------------------------------------------------------------

def _bdr_builder(program, match):
    return build_cluster_instr(program, match,
                               "fused_" + match.pattern.name)


@register_pass
class FuseBiasDropoutResidualPass(PatternRewritePass):
    """bias-add -> dropout -> residual-add (and the bias-free
    dropout -> residual-add tail) collapse into one op — the reference's
    fused_bias_dropout_residual_layer_norm family minus the norm (which
    FuseNormMatmulPass owns). Adds match commutatively (either operand
    order); the fused fn mini-replays the recorded fns, so the dropout
    keeps its captured RNG key — bit-identical to the unfused chain."""

    name = "fuse_bias_dropout_residual"
    patterns = (
        (
            Pattern(
                "bias_dropout_residual",
                [
                    OpPat("add", ins=["x", "b"], outs=["t"], ordered=False),
                    OpPat(("dropout", "dropout_eval"), ins=["t"], outs=["d"],
                          allow_extra_ins=False),
                    OpPat("add", ins=["d", "r"], outs=["y"], ordered=False),
                ],
                roots=["y"],
            ),
            _bdr_builder,
        ),
        (
            Pattern(
                "dropout_residual",
                [
                    OpPat(("dropout", "dropout_eval"), ins=["x"], outs=["d"],
                          allow_extra_ins=False),
                    OpPat("add", ins=["d", "r"], outs=["y"], ordered=False),
                ],
                roots=["y"],
            ),
            _bdr_builder,
        ),
    )
