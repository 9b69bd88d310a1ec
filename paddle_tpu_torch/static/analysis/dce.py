"""Dead-op elimination: library entrypoint.

The implementation now lives in static/passes/dce_pass.py, where it runs
as pass #0 of the default pipeline (every compiled signature ships
dead-op-free). This module keeps the public `dead_op_elimination` API as a
thin wrapper: it resolves + validates fetch_list-style entries through THE
shared policy (Program.resolve_fetch — liveness roots must match what a
later exe.run resolves), then delegates.
"""
from __future__ import annotations

from typing import List


def dead_op_elimination(program, fetch_list=None) -> int:
    """Remove ops whose outputs no root (fetch/grad/opt) transitively
    demands. Mutates `program` in place (run it on `program.clone()` to
    keep the original) and returns the number of ops removed.

    `fetch_list` entries may be Tensors recorded in the program or raw var
    ids; omitted, only grad/opt roots pin liveness (an inference program
    with no fetch list would lose everything — pass your fetches)."""
    from ..passes.dce_pass import eliminate_dead_ops

    return eliminate_dead_ops(program, _resolve_fetch(program, fetch_list))


def _resolve_fetch(program, fetch_list) -> List[int]:
    # every var with a recorded placeholder/persistable Tensor, plus grad
    # vars (bound by the grad pass): the set of vids that can root liveness
    known = set(program._var_tensors)
    for _loss, _pvars, gvars in program.grad_requests:
        known.update(gvars)
    vids = []
    for f in fetch_list or ():
        if isinstance(f, int):
            # an unvalidated stale/typo'd vid would root NOTHING and let
            # the walk silently delete the ops the caller meant to keep
            if f not in known:
                raise ValueError(
                    f"dead_op_elimination: fetch var id {f} is not a var of "
                    f"this program"
                )
            vids.append(f)
            continue
        # Tensors and strings resolve through THE shared policy — liveness
        # roots must match what a later exe.run(fetch_list=...) resolves to
        vids.append(program.resolve_fetch(f))
    return vids
