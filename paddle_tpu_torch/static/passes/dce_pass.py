"""Dead-op elimination as pipeline pass #0 (counterpart of
paddle_tpu/static/passes/dce_pass.py).

static/analysis/dce.py keeps the library entrypoint as a thin wrapper:
every compiled signature ships dead-op-free, so
the DRR fusion patterns that run after this pass never match — and fuse —
a dead cluster. Liveness is walked backward from the escape roots
(fetches, grad requests, optimizer updates); effectful ops (print_op) and
zero-output ops survive unconditionally. Removal is bit-identical by
construction: a removed op's outputs are read by nothing live.
"""
from __future__ import annotations

from typing import List

from ..analysis.graph import ProgramGraph
from .pass_base import PassStats, ProgramPass, register_pass, release_vars


def eliminate_dead_ops(program, fetch_vars: List[int]) -> int:
    """Core DCE over raw, already-resolved fetch var ids. Mutates `program`
    in place; returns the number of ops removed. Callers with
    fetch_list-style entries (Tensor/str) go through
    `analysis.dead_op_elimination`, which resolves + validates first."""
    graph = ProgramGraph(program, fetch_vars=fetch_vars)
    mask = graph.live_ops()
    removed = [op for op, live in zip(program.ops, mask) if not live]
    if removed:
        program.ops = [op for op, live in zip(program.ops, mask) if live]
        # release the dead outputs' placeholder Tensors: the keepalive dict
        # would otherwise pin their eagerly-evaluated activations (the
        # largest arrays a capture holds) for the program's lifetime, and a
        # stale vid must stop validating as a var of this program
        release_vars(program, [v for op in removed for v in op.out_vars])
        program._compiled.clear()
    from ... import telemetry as _tm

    if _tm.enabled():
        _tm.counter(
            "paddle_tpu_program_dce_removed_ops_total",
            "recorded ops removed by dead-op elimination",
        ).inc(len(removed))
    return len(removed)


@register_pass
class DeadOpEliminationPass(ProgramPass):
    name = "dead_op_elimination"

    def run(self, program, ctx) -> PassStats:
        n = eliminate_dead_ops(program, ctx.fetch_vars)
        return PassStats(matches=n, rewritten_ops=n)
