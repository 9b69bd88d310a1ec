"""Cheap canonicalization passes: scalar constant folding and redundant
cast/reshape elimination (counterpart of
paddle_tpu/static/passes/canonicalize.py).

"Folding" reads the value the eager capture already computed — an op
whose inputs are all literals
evaluated to a concrete placeholder Tensor at record time, so the fold is
a lookup, not an interpreter. Redundancy checks read the shape/dtype
metadata harvested from the placeholder Tensors; a candidate whose
metadata is missing (or whose input carries dynamic feed dims) is left
alone — canonicalization must never guess.
"""
from __future__ import annotations

import torch

from ..analysis.graph import EFFECTFUL_OPS
from .pass_base import (
    PassStats,
    ProgramPass,
    clone_op_with_inputs,
    register_pass,
    release_vars,
)


def _forward_uses(program, graph, out_vid, new_ref) -> bool:
    """Rewire every consumer of `out_vid` to `new_ref` (('var', vid) or
    ('lit', value)). Only op-site uses can be rewired; returns False (no
    rewrite) when the var escapes (fetch/grad/opt use or liveness root)."""
    if out_vid in graph.roots():
        return False
    uses = graph.uses_of(out_vid)
    if any(site != "op" for site, _si, _pos in uses):
        return False
    by_op = {}
    for _site, si, _pos in uses:
        by_op.setdefault(si, program.ops[si])
    for si, op in by_op.items():
        refs = [new_ref if (r[0] == "var" and r[1] == out_vid) else r
                for r in op.in_refs]
        program.ops[si] = clone_op_with_inputs(op, refs)
    return True


@register_pass
class ConstantFoldScalarsPass(ProgramPass):
    """Fold ops whose inputs are ALL literals and whose outputs are all
    scalars: the recorded placeholder value IS the constant (computed once
    at capture time), so consumers read it as a literal and the op goes
    away. Scalar-only on purpose — folding a big array would pin a copy of
    it into every consumer's in_refs."""

    name = "constant_fold_scalars"

    def run(self, program, ctx) -> PassStats:
        folded = 0
        # fixpoint: folding one op can make its consumer all-literal
        for _ in range(8):
            graph = ctx.graph()
            victims = []
            for i, op in enumerate(program.ops):
                if not op.out_vars or op.name in EFFECTFUL_OPS:
                    continue
                if any(r[0] == "var" for r in op.in_refs):
                    continue
                metas = [graph.vars.get(v) for v in op.out_vars]
                if any(m is None or m.shape != () for m in metas):
                    continue
                if any(program._var_tensors.get(v) is None for v in op.out_vars):
                    continue
                victims.append(i)
            did = 0
            for i in victims:
                op = program.ops[i]
                # all-or-nothing per op: EVERY output must be forwardable,
                # or the op stays (a half-forwarded op would lose an output)
                if any(v in graph.roots() for v in op.out_vars) or any(
                    site != "op"
                    for v in op.out_vars
                    for site, _si, _pos in graph.uses_of(v)
                ):
                    continue
                for vid in op.out_vars:
                    # the 0-d tensor itself (on its device), as a literal
                    value = program._var_tensors[vid].detach().clone()
                    _forward_uses(program, graph, vid, ("lit", value))
                release_vars(program, op.out_vars)
                did += 1
                program.ops[i] = None  # mark; compacted below
            if did:
                program.ops = [op for op in program.ops if op is not None]
                folded += did
                ctx.invalidate()
                program._compiled.clear()
            else:
                break
        return PassStats(matches=folded, rewritten_ops=folded)


def _moves_device(op) -> bool:
    """A recorded `Tensor.to(device)` is a "cast" that may keep the dtype
    and still move the tensor: never redundant."""
    return any(r[0] == "lit" and (isinstance(r[1], torch.device) or (
        isinstance(r[1], str) and r[1].split(":")[0] in ("cpu", "cuda")))
        for r in op.in_refs)


@register_pass
class RedundantCastReshapeElimPass(ProgramPass):
    """Remove casts whose output dtype equals the input's and reshapes
    whose output shape equals the input's (per the harvested placeholder
    metadata): consumers read the producer directly. Skipped when the
    input rides a dynamic feed dim — the dry-run metadata then understates
    the runtime shape and equality proves nothing."""

    name = "redundant_cast_reshape_elim"

    def run(self, program, ctx) -> PassStats:
        removed_total = 0
        for _ in range(8):
            graph = ctx.graph()
            did = 0
            for i, op in enumerate(program.ops):
                if op.name not in ("cast", "reshape") or _moves_device(op):
                    continue
                var_ins = [r[1] for r in op.in_refs if r[0] == "var"]
                if len(var_ins) != 1 or len(op.out_vars) != 1:
                    continue
                src, dst = var_ins[0], op.out_vars[0]
                mi, mo = graph.vars.get(src), graph.vars.get(dst)
                if mi is None or mo is None:
                    continue
                if mi.shape is None or mi.shape != mo.shape:
                    continue
                if mi.dtype is None or mi.dtype != mo.dtype:
                    continue
                src_t = program._var_tensors.get(src)
                if src_t is not None and getattr(src_t, "_dynamic_dims", None):
                    continue
                if not _forward_uses(program, graph, dst, ("var", src)):
                    continue
                program.ops[i] = None
                release_vars(program, [dst])
                did += 1
            if did:
                program.ops = [op for op in program.ops if op is not None]
                removed_total += did
                ctx.invalidate()
                program._compiled.clear()
            else:
                break
        return PassStats(matches=removed_total, rewritten_ops=removed_total)
