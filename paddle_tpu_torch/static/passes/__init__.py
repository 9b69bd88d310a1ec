"""static.passes: the graph pass & fusion framework (counterpart of
paddle_tpu/static/passes/__init__.py).

The PIR/CINN analogue over the recorded Program: `PassManager` runs an
ordered, flag-gated (`FLAGS_program_passes`, default on) pipeline of
analysis-backed rewrites before `Executor._compile` prepares a replay,
with `verify()` re-run after every rewriting
pass and `FLAGS_print_after_pass` to_text() diffs on demand. Patterns are
DRR-style declarative sub-DAG specs (drr.py) over ProgramGraph def-use
chains; replacements are single fused ops.

Default pipeline order (import order below defines it):
  1. dead_op_elimination        every compiled signature ships dead-op-free
  2. constant_fold_scalars      scalar lit-only ops fold to literals
  3. redundant_cast_reshape_elim identity casts/reshapes forward through
  4. fuse_attention             rope+sdpa / matmul-softmax chain -> flash
  5. fuse_norm_matmul           rms/layer_norm -> linear/matmul epilogue
  6. fuse_moe                   MoE dispatch -> expert FFN -> combine collapse
  7. fuse_bias_dropout_residual add -> dropout -> add collapse

Custom passes: subclass ProgramPass, decorate with @register_pass (use
`before="fuse_attention"` to insert mid-pipeline), and every later
Executor compile-miss runs it. `run_default_pipeline(program, ...)`
rewrites a CLONE and returns (rewritten_program, PipelineResult) — the
caller's Program is never mutated.
"""
from .pass_base import (  # noqa: F401
    PassContext,
    PassManager,
    PassStats,
    PipelineResult,
    ProgramPass,
    default_pipeline,
    get_pass,
    pipeline_enabled,
    register_pass,
)
from .drr import (  # noqa: F401
    Match,
    OpPat,
    Pattern,
    apply_matches,
    build_cluster_instr,
    find_matches,
)

# pipeline passes, registered in canonical order
from .dce_pass import DeadOpEliminationPass, eliminate_dead_ops  # noqa: F401
from .canonicalize import (  # noqa: F401
    ConstantFoldScalarsPass,
    RedundantCastReshapeElimPass,
)
from .fusion import (  # noqa: F401
    FuseAttentionPass,
    FuseBiasDropoutResidualPass,
    FuseMoEDispatchCombinePass,
    FuseNormMatmulPass,
    PatternRewritePass,
)

# the newest pipeline result, for introspection (callers that measure read
# their OWN result object; this is the debugging handle)
LAST_RESULT = [None]


def run_default_pipeline(program, fetch_vars=(), feed_names=None, clone=True):
    """Run the default pipeline; returns (program, PipelineResult).

    `clone=True` (the Executor's contract) rewrites a clone() so the
    caller's recorded Program survives untouched — a later run with a
    different fetch set must still see every recorded op. When the
    pipeline rewrote anything, `verify()` runs once more on the rewritten
    program (the post-pipeline verification the Executor relies on);
    failures carry 'post-pipeline' context."""
    work = program.clone() if clone else program
    mgr = PassManager()
    result = mgr.run(work, fetch_vars=fetch_vars, feed_names=feed_names)
    from ..analysis import verifier as _verifier

    # post-pipeline verify only when something was rewritten: an unchanged
    # clone is byte-for-byte the program the caller verified pre-pipeline,
    # and the manager already re-verified after every changing pass
    if result.changed and _verifier.verify_enabled():
        try:
            _verifier.verify(work, feed_names=feed_names, fetch_vars=fetch_vars)
        except _verifier.ProgramVerifyError as e:
            raise _verifier.ProgramVerifyError(
                e.diagnostics, context="post-pipeline"
            ) from e
    LAST_RESULT[0] = result
    return work, result


__all__ = [
    "PassContext",
    "PassManager",
    "PassStats",
    "PipelineResult",
    "ProgramPass",
    "OpPat",
    "Pattern",
    "Match",
    "find_matches",
    "apply_matches",
    "build_cluster_instr",
    "register_pass",
    "get_pass",
    "default_pipeline",
    "pipeline_enabled",
    "run_default_pipeline",
    "eliminate_dead_ops",
    "DeadOpEliminationPass",
    "ConstantFoldScalarsPass",
    "RedundantCastReshapeElimPass",
    "FuseAttentionPass",
    "FuseNormMatmulPass",
    "FuseBiasDropoutResidualPass",
    "PatternRewritePass",
]
