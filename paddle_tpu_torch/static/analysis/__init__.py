"""static.analysis: the analysis half of the PIR analogue (counterpart of
paddle_tpu/static/analysis/__init__.py).

Layered over the recorded Program (static/program.py):

- `ProgramGraph` (graph.py): def-use chains + per-var shape/dtype metadata
  harvested from the eagerly-evaluated placeholder Tensors, and the stable
  `program_to_text` dump (`Program.to_text()` / `describe_program`);
- `verify` (verifier.py): named, located diagnostics (SSA single
  assignment, use-before-def, feed/param coverage, dangling
  fetch/grad/opt refs, op-output arity, donation hazards) run flag-gated
  (`FLAGS_verify_program`, default on) before `Executor._compile`;
- `dead_op_elimination` (dce.py): thin wrapper (fetch resolution +
  validation) over the pipeline pass in static/passes/dce_pass.py;
- donation checks (donation.py): fused-bucket read-after-donation,
  fed-and-fetched aliasing, duplicate donated buffers at to_static
  lowering.

This is the substrate `static.passes` (the pass/fusion layer) rewrites
against: every pattern-rewrite pass runs `verify` after itself and shows
up in `to_text` diffs.
"""
from .dce import dead_op_elimination  # noqa: F401
from .donation import check_donation, verify_donated_state  # noqa: F401
from .graph import ProgramGraph, VarInfo, describe_program, program_to_text  # noqa: F401
from .verifier import (  # noqa: F401
    Diagnostic,
    ProgramVerifyError,
    verify,
    verify_enabled,
)

__all__ = [
    "ProgramGraph",
    "VarInfo",
    "Diagnostic",
    "ProgramVerifyError",
    "verify",
    "verify_enabled",
    "dead_op_elimination",
    "check_donation",
    "verify_donated_state",
    "describe_program",
    "program_to_text",
]
