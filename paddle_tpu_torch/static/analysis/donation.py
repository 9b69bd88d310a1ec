"""Donation / aliasing checks (counterpart of
paddle_tpu/static/analysis/donation.py).

In the JAX package buffer donation is a memory optimization with a sharp
edge: a donated buffer read after the compiled step consumed it raises
deep inside user code. The port donates nothing (its Executor and its
to_static run eagerly and update persistables in place), but the checks
stay as the JAX package states them, because the hazards they name also
corrupt the port's in-place write-back:

- static programs: a fused-optimizer flat bucket (state the one-pass
  kernel overwrites) that is ALSO registered as a program input, and a
  var that is both fed and fetched;
- state lists: two tensors sharing one storage, which one in-place
  update would write twice.
"""
from __future__ import annotations

from typing import List

import torch


def check_donation(program, fetch_vars=None) -> List["Diagnostic"]:
    """Static-program donation/aliasing diagnostics (warning severity for
    hazards legal under the copying Executor, error for state aliasing
    that silently corrupts write-back)."""
    from .verifier import Diagnostic

    diags: List[Diagnostic] = []
    fetch_vars = set(fetch_vars or ())

    feed_vids = set(program.feed_vars.values())
    for vid in sorted(feed_vids & fetch_vars):
        name = next(n for n, v in program.feed_vars.items() if v == vid)
        diags.append(Diagnostic(
            "fed-and-fetched",
            f"feed {name!r} (%v{vid}) is also a fetch target — under a "
            f"donating engine the fetched output would alias the donated "
            f"feed buffer",
            severity="warning", var=vid,
        ))

    # accumulator aliasing: the Executor writes back each update's accums
    # after the run; one Tensor shared by two updates means the second
    # write-back silently wins
    seen_accums = {}
    for ui, upd in enumerate(program.opt_updates):
        for t in getattr(upd, "accum_tensors", ()):
            prev = seen_accums.get(id(t))
            if prev is not None:
                diags.append(Diagnostic(
                    "aliased-opt-state",
                    f"opt#{ui} and opt#{prev} share one accumulator Tensor "
                    f"object — the later write-back silently overwrites the "
                    f"earlier update's state",
                ))
            else:
                seen_accums[id(t)] = ui

    # fused donated-bucket read: the flat m/v buckets are overwritten by
    # the one-pass kernel; if the SAME tensor is also registered as a
    # program input (an op read it during capture), the op replays against
    # a buffer the kernel overwrites
    from ..executor import _FusedAdamWUpdate

    accum_ids = {
        id(t): (ui, ti)
        for ui, upd in enumerate(program.opt_updates)
        if isinstance(upd, _FusedAdamWUpdate)
        for ti, t in enumerate(getattr(upd, "accum_tensors", ()))
    }
    if accum_ids:
        read_vids = set()
        for op in program.ops:
            read_vids.update(r[1] for r in op.in_refs if r[0] == "var")
        for vid in sorted(read_vids):
            t = program._var_tensors.get(vid)
            if t is not None and id(t) in accum_ids:
                ui, ti = accum_ids[id(t)]
                diags.append(Diagnostic(
                    "donated-bucket-read",
                    f"%v{vid} is fused opt#{ui}'s donated flat bucket "
                    f"(accum {ti}) AND a program input — reads after the "
                    f"one-pass kernel consumes the bucket see stale or "
                    f"deleted memory",
                    severity="warning", var=vid,
                ))
    return diags


def verify_donated_state(state_tensors, origin="to_static", labels=None) -> None:
    """No two entries of a state list may share one storage. Raises
    ProgramVerifyError naming the tensors. `labels` (parallel to
    `state_tensors`) names each entry's collection, so the diagnostic
    points at the right one."""
    from .verifier import Diagnostic, ProgramVerifyError

    by_buf = {}
    diags = []

    def _label(k, tt):
        slot = labels[k] if labels is not None else f"state[{k}]"
        return f"{slot} {getattr(tt, 'name', None) or '<unnamed>'}"

    for i, t in enumerate(state_tensors):
        if not isinstance(t, torch.Tensor) or t.is_meta:
            continue
        buf = t.untyped_storage().data_ptr()
        prev = by_buf.get(buf)
        if prev is not None:
            j, other = prev
            diags.append(Diagnostic(
                "donated-state-alias",
                f"{origin}: {_label(i, t)} and {_label(j, other)} share one "
                f"storage — an in-place update would write it twice; "
                f"copy one of them (e.g. tensor.clone())",
            ))
        else:
            by_buf[buf] = (i, t)
    if diags:
        from .verifier import count_diagnostics

        count_diagnostics(diags)
        raise ProgramVerifyError(diags)
