"""Program verifier: named, located diagnostics over a ProgramGraph
(counterpart of paddle_tpu/static/analysis/verifier.py; pir::Verify).

The checks run against the recorded instruction list BEFORE
`Executor._compile` prepares its replay, so a malformed program fails
with a diagnostic naming the offending op/var instead of a KeyError from
deep inside the replay.

Diagnostic catalog (check slugs are the telemetry label values):

  errors (raise ProgramVerifyError):
    single-assignment   var defined by more than one site (SSA violation —
                        two ops, or a feed/param re-bound by an op or
                        registered twice across feed+param)
    duplicate-var-binding same vid bound twice WITHIN one site (repeated in
                        an op's out list, repeated in param_vars)
    use-before-def      op reads a var defined by a LATER op or by the
                        gradient pass (grads exist only after all ops ran)
    undefined-var       op/grad/opt reads a var no site defines
    op-output-arity     out_vars/out_positions/n_raw_outs inconsistent
                        (the recorded form of a replay arity mismatch)
    feed-coverage       a feed the program reads is not provided, or a
                        provided feed name is unknown to the program
    param-coverage      feed/param var with no backing placeholder Tensor
    dangling-fetch      fetch var not defined by this program
    dangling-grad-ref   grad request names a loss/param var that does not
                        exist in the program
    dangling-opt-ref    optimizer update reads a param/grad var that does
                        not exist (e.g. a pass removed its producer)
    aliased-opt-state   one accumulator Tensor object shared by two
                        optimizer updates (double write-back, last wins)

  warnings (reported + counted, never raise):
    fed-and-fetched     a var is both a feed and a fetch target — legal in
                        the copying Executor, an aliasing hazard for
                        engines that reuse the feed's buffer
    donated-bucket-read a fused-optimizer flat bucket (state the kernel
                        overwrites in place) is also read as a program
                        input — stale once the kernel has run
"""
from __future__ import annotations

import time
from typing import List


class Diagnostic:
    """One named, located finding: `check` is the slug from the catalog,
    `message` names the op (op#i 'name') and var (%vN) involved."""

    __slots__ = ("check", "message", "severity", "op_index", "var")

    def __init__(self, check, message, severity="error", op_index=None, var=None):
        self.check = check
        self.message = message
        self.severity = severity
        self.op_index = op_index
        self.var = var

    def __repr__(self):
        return f"[{self.check}] {self.message}"


class ProgramVerifyError(ValueError):
    """Raised by verify() when error-severity diagnostics are found; carries
    the full diagnostic list on `.diagnostics`. `context` names WHERE in a
    pipeline the program went bad (e.g. "after pass 'fuse_attention'") —
    the pass layer re-raises with it so a miscompiling rewrite is
    attributed to its pass, not to verification in general."""

    def __init__(self, diagnostics, context=None):
        self.diagnostics = list(diagnostics)
        self.context = context
        errors = [d for d in self.diagnostics if d.severity == "error"]
        where = f" {context}" if context else ""
        lines = [f"Program verification failed{where} ({len(errors)} error(s)):"]
        lines += [f"  {d!r}" for d in self.diagnostics]
        lines.append("(set FLAGS_verify_program=0 to skip verification)")
        super().__init__("\n".join(lines))


def _op_label(program, i):
    name = program.ops[i].name if 0 <= i < len(program.ops) else "?"
    return f"op#{i} '{name}'"


def verify(program, feed_names=None, fetch_vars=None, raise_on_error=True) -> List[Diagnostic]:
    """Run every check over `program`; returns the diagnostic list (errors
    first). When `raise_on_error` (the default), error-severity findings
    raise ProgramVerifyError. `feed_names` (the names run() was given)
    enables the feed-coverage check; `fetch_vars` enables dangling-fetch
    and the donation warnings."""
    t0 = time.perf_counter()
    diags: List[Diagnostic] = []
    # public entry point: accept fetch_list-style entries (Tensor/str) via
    # THE shared resolution policy, exactly like exe.run and DCE — raw var
    # ids pass through untouched. An unresolvable entry becomes a
    # dangling-fetch DIAGNOSTIC (verify reports, it doesn't throw bare
    # ValueErrors — raise_on_error=False callers rely on that)
    resolved = []
    for k, f in enumerate(fetch_vars or ()):
        if isinstance(f, int):
            resolved.append(f)
            continue
        try:
            resolved.append(program.resolve_fetch(f))
        except (TypeError, ValueError) as e:
            diags.append(Diagnostic(
                "dangling-fetch",
                f"fetch target {k} does not resolve to a var of this "
                f"program: {e}",
            ))
    fetch_vars = resolved
    prog = program

    # ONE def/use walker for every pass: the ProgramGraph is the structure
    # the checks read — def_sites (all definitions with replay-order keys),
    # intra_site_dups, and per-var tagged use sites
    from .graph import ORDER_AFTER_OPS, ORDER_BEFORE_OPS, ProgramGraph

    graph = ProgramGraph(prog, fetch_vars=fetch_vars)

    # ---- definition checks ----
    for site_kind, label, vid in graph.intra_site_dups:
        msg = (
            f"{label} binds %v{vid} twice in its output list"
            if site_kind == "op"
            else f"param %v{vid} is registered twice in param_vars"
        )
        diags.append(Diagnostic("duplicate-var-binding", msg, var=vid))
    for vid in sorted(graph.def_sites):
        sites = graph.def_sites[vid]
        if len(sites) > 1:
            diags.append(Diagnostic(
                "single-assignment",
                f"%v{vid} is defined twice: by {sites[0][1]} and again by "
                f"{sites[1][1]}",
                var=vid,
            ))
    for name, vid in prog.feed_vars.items():
        if vid not in prog._var_tensors:
            diags.append(Diagnostic(
                "param-coverage",
                f"feed {name!r} (%v{vid}) has no backing placeholder Tensor",
                var=vid,
            ))
    for vid in set(prog.param_vars):
        if vid not in prog._var_tensors:
            diags.append(Diagnostic(
                "param-coverage",
                f"param %v{vid} has no backing persistable Tensor", var=vid,
            ))

    # ---- recorded arity consistency: the statically-checkable form of the
    # replay_env arity contract ----
    for i, op in enumerate(prog.ops):
        if len(op.out_positions) != len(op.out_vars):
            diags.append(Diagnostic(
                "op-output-arity",
                f"{_op_label(prog, i)} records {len(op.out_vars)} output var(s) "
                f"but {len(op.out_positions)} output position(s)",
                op_index=i,
            ))
        elif op.out_positions and (
            min(op.out_positions) < 0 or max(op.out_positions) >= op.n_raw_outs
        ):
            diags.append(Diagnostic(
                "op-output-arity",
                f"{_op_label(prog, i)} maps output var(s) to position(s) "
                f"{op.out_positions} outside its recorded raw arity {op.n_raw_outs}",
                op_index=i,
            ))

    # ---- use checks, from the graph's tagged use sites ----
    def _def_order(vid):
        sites = graph.def_sites.get(vid)
        return sites[0][0] if sites else None

    for vid in sorted(graph.vars):
        info = graph.vars[vid]
        order = _def_order(vid)
        for site, si, pos in info.uses:
            if site == "op":
                if order is None:
                    diags.append(Diagnostic(
                        "undefined-var",
                        f"{_op_label(prog, si)} reads %v{vid} (input {pos}) "
                        f"which no feed/param/op defines",
                        op_index=si, var=vid,
                    ))
                elif order == ORDER_AFTER_OPS or (
                    order != ORDER_BEFORE_OPS and order >= si
                ):
                    where = (
                        "the gradient pass (grads exist only after all ops)"
                        if order == ORDER_AFTER_OPS
                        else graph.def_sites[vid][0][1]
                    )
                    diags.append(Diagnostic(
                        "use-before-def",
                        f"{_op_label(prog, si)} reads %v{vid} (input {pos}) "
                        f"defined later by {where}",
                        op_index=si, var=vid,
                    ))
            elif site == "grad":
                if order is None or order == ORDER_AFTER_OPS:
                    diags.append(Diagnostic(
                        "dangling-grad-ref",
                        f"grad#{si} differentiates loss %v{vid} which is not "
                        f"computed by this program",
                        var=vid,
                    ))
            elif site == "grad_wrt":
                if order is None or order == ORDER_AFTER_OPS:
                    diags.append(Diagnostic(
                        "dangling-grad-ref",
                        f"grad#{si} differentiates w.r.t. %v{vid} which is "
                        f"not a var of this program",
                        var=vid,
                    ))
            elif site == "opt":
                if order is None:
                    diags.append(Diagnostic(
                        "dangling-opt-ref",
                        f"opt#{si} updates param %v{vid} which is not a var "
                        f"of this program",
                        var=vid,
                    ))
            elif site == "opt_grad":
                if order is None:
                    diags.append(Diagnostic(
                        "dangling-opt-ref",
                        f"opt#{si} reads grad %v{vid} which no grad request "
                        f"computes (was its producer removed?)",
                        var=vid,
                    ))
            elif site == "fetch":
                if order is None:
                    diags.append(Diagnostic(
                        "dangling-fetch",
                        f"fetch target {si} (%v{vid}) is not defined by this "
                        f"program",
                        var=vid,
                    ))

    # ---- feed coverage (only when the caller says what it will feed) ----
    if feed_names is not None:
        provided = set(feed_names)
        unknown = provided - set(prog.feed_vars)
        for name in sorted(unknown):
            diags.append(Diagnostic(
                "feed-coverage",
                f"provided feed {name!r} is not a feed of this program "
                f"(feeds: {sorted(prog.feed_vars)})",
            ))
        # every feed the program reads (any use site — the replay binds ONLY
        # provided feeds, so a missing one is a guaranteed KeyError deep
        # inside the replay)
        for name, vid in sorted(prog.feed_vars.items()):
            info = graph.vars.get(vid)
            if info is not None and info.uses and name not in provided:
                diags.append(Diagnostic(
                    "feed-coverage",
                    f"feed {name!r} (%v{vid}) is read by this program but "
                    f"not provided (provided: {sorted(provided)})",
                    var=vid,
                ))

    # ---- donation/aliasing checks ----
    from .donation import check_donation

    diags.extend(check_donation(prog, fetch_vars=fetch_vars))

    diags.sort(key=lambda d: (d.severity != "error",))
    _count(diags, time.perf_counter() - t0)
    if raise_on_error and any(d.severity == "error" for d in diags):
        raise ProgramVerifyError(diags)
    # warning-severity findings must reach the USER, not just the telemetry
    # counter — the production call site (Executor._compile) drops the
    # return value. Attribute the warning to the first stack frame OUTSIDE
    # the package (the user's exe.run call site), not to whichever
    # framework internal happened to call verify
    import warnings

    if any(d.severity == "warning" for d in diags):
        stacklevel = _user_stacklevel()
        for d in diags:
            if d.severity == "warning":
                warnings.warn(f"program verifier: {d!r}", RuntimeWarning,
                              stacklevel=stacklevel)
    return diags


def _user_stacklevel() -> int:
    """warnings stacklevel (counted from verify()) of the first frame
    outside this package."""
    import os
    import sys

    pkg_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))) + os.sep
    try:
        frame = sys._getframe(2)  # verify()'s caller
    except ValueError:
        return 2
    # stacklevel semantics from the warn() call in verify(): 1 = verify
    # itself, 2 = verify's caller, and so on up
    level = 2
    while frame is not None and frame.f_code.co_filename.startswith(pkg_dir):
        frame = frame.f_back
        level += 1
    return level


def _count(diags, seconds):
    from ... import telemetry as _tm

    if not _tm.enabled():
        return
    _tm.counter(
        "paddle_tpu_program_verify_runs_total",
        "program verifier invocations (Executor compile)",
    ).inc()
    _tm.histogram(
        "paddle_tpu_program_verify_seconds",
        "wall time of one verify(program) pass",
    ).observe(seconds)
    count_diagnostics(diags)


def count_diagnostics(diags):
    """THE declaration site of the per-check findings counter — every path
    that emits diagnostics (verify(), the to_static donation check) counts
    through here so the metric schema can never fork."""
    from ... import telemetry as _tm

    if not (_tm.enabled() and diags):
        return
    c = _tm.counter(
        "paddle_tpu_program_verify_diagnostics_total",
        "verifier findings by check slug", ("check",),
    )
    for d in diags:
        c.labels(check=d.check).inc()


def verify_enabled() -> bool:
    from ...framework import flags as _flags

    return bool(_flags._registry.get("FLAGS_verify_program", True))
