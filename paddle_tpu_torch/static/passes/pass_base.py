"""Pass infrastructure: ProgramPass, PassManager, the pass registry
(counterpart of paddle_tpu/static/passes/pass_base.py; paddle/pir/pass).

A pass is a rewrite over the recorded `Program` (static/program.py)
backed by `ProgramGraph` def-use analysis; the manager runs an ordered
pipeline, re-runs the verifier after every pass that rewrote something
(a miscompiling rewrite fails HERE with the pass named, not as an error
in the replay), counts per-pass telemetry, and prints `to_text()` diffs
on demand (`FLAGS_print_after_pass`).

Contract for every pass:
  - NEVER mutate an OpInstr in place — instrs are shared with the caller's
    original Program (the Executor pipelines over a clone() whose ops list
    is a shallow copy). Rewrites build new OpInstr objects.
  - out_vars of replacement ops reuse the matched root vids, so downstream
    references (ops, fetches, grad/opt requests) stay valid.
  - report matches/rewritten_ops honestly; chip_smoke.py's
    static_llama_capture phase holds fusion coverage to these counts.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from ..analysis.graph import ProgramGraph
from ..program import OpInstr


class PassStats:
    """One pass's report: `matches` pattern/site hits, `rewritten_ops`
    recorded ops removed or replaced by the rewrite."""

    __slots__ = ("matches", "rewritten_ops")

    def __init__(self, matches=0, rewritten_ops=0):
        self.matches = matches
        self.rewritten_ops = rewritten_ops

    @property
    def changed(self):
        return self.rewritten_ops > 0 or self.matches > 0


class PassContext:
    """Per-pipeline state every pass reads: the liveness/fetch roots of the
    signature being compiled and a memoized ProgramGraph (invalidated by
    the manager after any rewriting pass)."""

    def __init__(self, program, fetch_vars=(), feed_names=None):
        self.program = program
        self.fetch_vars = list(fetch_vars or ())
        self.feed_names = list(feed_names) if feed_names is not None else None
        self._graph: Optional[ProgramGraph] = None

    def graph(self) -> ProgramGraph:
        if self._graph is None:
            self._graph = ProgramGraph(self.program, fetch_vars=self.fetch_vars)
        return self._graph

    def invalidate(self):
        self._graph = None


class ProgramPass:
    """Base class: subclass, set `name` (the telemetry label and
    print-after-pass key), implement `run(program, ctx) -> PassStats`."""

    name: str = "<unnamed>"

    def run(self, program, ctx: PassContext) -> PassStats:
        raise NotImplementedError

    def __repr__(self):
        return f"<{type(self).__name__} {self.name!r}>"


# ---------------------------------------------------------------------------
# shared rewrite helpers
# ---------------------------------------------------------------------------

def clone_op_with_inputs(op: OpInstr, in_refs) -> OpInstr:
    """A consumer whose inputs a pass rewires gets a NEW OpInstr (same fn /
    kwargs / outputs, fresh serial) — the original instr may be shared with
    the caller's un-pipelined Program."""
    return OpInstr(op.name, op.fn, list(in_refs), dict(op.kwargs),
                   list(op.out_vars), list(op.out_positions), op.n_raw_outs)


def release_vars(program, vids):
    """Drop the placeholder Tensors of vars a rewrite removed: the
    keepalive dict would otherwise pin their eagerly-evaluated activations,
    and a stale vid must stop resolving as a var of this program."""
    for vid in vids:
        t = program._var_tensors.pop(vid, None)
        if t is not None:
            program._id2var.pop(id(t), None)


# ---------------------------------------------------------------------------
# registry + default pipeline
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, type] = {}
# canonical pipeline order; register_pass appends custom passes here unless
# pipeline=False. Cheap cleanups run first so patterns never match dead or
# redundant ops; fusions run last over the canonicalized program.
PIPELINE_ORDER: List[str] = []


def register_pass(cls=None, *, pipeline=True, before=None):
    """Register a ProgramPass subclass (decorator or call). `pipeline=True`
    appends it to the default pipeline (or inserts it before the pass named
    by `before`); `pipeline=False` only makes it constructible by name."""

    def _register(klass):
        name = klass.name
        if name in _REGISTRY and _REGISTRY[name] is not klass:
            raise ValueError(f"pass {name!r} is already registered")
        _REGISTRY[name] = klass
        if pipeline and name not in PIPELINE_ORDER:
            if before is not None:
                try:
                    PIPELINE_ORDER.insert(PIPELINE_ORDER.index(before), name)
                except ValueError:
                    raise ValueError(
                        f"register_pass(before={before!r}): no such pass in "
                        f"the pipeline (have {PIPELINE_ORDER})"
                    )
            else:
                PIPELINE_ORDER.append(name)
        return klass

    return _register(cls) if cls is not None else _register


def get_pass(name: str) -> ProgramPass:
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(
            f"unknown pass {name!r}; registered: {sorted(_REGISTRY)}"
        )


def default_pipeline() -> List[ProgramPass]:
    return [_REGISTRY[n]() for n in PIPELINE_ORDER]


# ---------------------------------------------------------------------------
# manager
# ---------------------------------------------------------------------------

class PipelineResult:
    """Per-pass records + aggregate views; `summary()` is the JAX
    package's bench `detail.passes` shape."""

    def __init__(self, records, seconds):
        self.records = records  # [{pass, matches, rewritten_ops, seconds, changed}]
        self.seconds = seconds

    @property
    def changed(self) -> bool:
        return any(r["changed"] for r in self.records)

    @property
    def matches(self) -> Dict[str, int]:
        return {r["pass"]: r["matches"] for r in self.records}

    @property
    def rewritten_ops(self) -> Dict[str, int]:
        return {r["pass"]: r["rewritten_ops"] for r in self.records}

    def summary(self) -> dict:
        return {
            "pipeline_ms": round(self.seconds * 1000, 3),
            "matches": self.matches,
            "rewritten_ops": self.rewritten_ops,
        }

    def __repr__(self):
        parts = ", ".join(
            f"{r['pass']}:{r['matches']}m/{r['rewritten_ops']}r"
            for r in self.records
        )
        return f"PipelineResult({parts}, {self.seconds * 1000:.2f} ms)"


def pipeline_enabled() -> bool:
    from ...framework import flags as _flags

    return bool(_flags._registry.get("FLAGS_program_passes", True))


def _print_after_names() -> set:
    from ...framework import flags as _flags

    raw = _flags._registry.get("FLAGS_print_after_pass", "") or ""
    return {n.strip() for n in str(raw).split(",") if n.strip()}


class PassManager:
    """Runs an ordered pass pipeline over one Program.

    After every pass that rewrote something, `verify()` re-runs (flag-gated
    by FLAGS_verify_program like every verification site); a failure
    re-raises ProgramVerifyError with the offending pass named in the
    message. `print_after` (or FLAGS_print_after_pass: names or 'all')
    prints a unified to_text() diff to stderr after each named pass that
    changed the program."""

    def __init__(self, passes: Optional[List[ProgramPass]] = None,
                 print_after=None):
        self.passes = list(passes) if passes is not None else default_pipeline()
        self._print_after = set(print_after) if print_after is not None else None

    def _printing(self, name) -> bool:
        names = (self._print_after if self._print_after is not None
                 else _print_after_names())
        return "all" in names or name in names

    def run(self, program, fetch_vars=(), feed_names=None) -> PipelineResult:
        from ... import telemetry as _tm
        from ..analysis import verifier as _verifier

        ctx = PassContext(program, fetch_vars=fetch_vars, feed_names=feed_names)
        telemetry_on = _tm.enabled()
        records = []
        t_pipeline = time.perf_counter()
        for p in self.passes:
            printing = self._printing(p.name)
            before_text = program.to_text(fetch_vars=ctx.fetch_vars) if printing else None
            t0 = time.perf_counter()
            stats = p.run(program, ctx)
            dt = time.perf_counter() - t0
            if stats.changed:
                ctx.invalidate()
                program._compiled.clear()
            if telemetry_on:
                self._count(_tm, p.name, stats, dt)
            if printing and stats.changed:
                self._print_diff(p.name, before_text,
                                 program.to_text(fetch_vars=ctx.fetch_vars))
            if stats.changed and _verifier.verify_enabled():
                try:
                    _verifier.verify(program, feed_names=ctx.feed_names,
                                     fetch_vars=ctx.fetch_vars)
                except _verifier.ProgramVerifyError as e:
                    raise _verifier.ProgramVerifyError(
                        e.diagnostics, context=f"after pass {p.name!r}"
                    ) from e
            records.append({
                "pass": p.name,
                "matches": stats.matches,
                "rewritten_ops": stats.rewritten_ops,
                "seconds": dt,
                "changed": stats.changed,
            })
        return PipelineResult(records, time.perf_counter() - t_pipeline)

    @staticmethod
    def _count(_tm, name, stats, seconds):
        labels = {"pass": name}
        _tm.counter(
            "paddle_tpu_pass_runs_total",
            "pass-pipeline pass invocations", ("pass",),
        ).labels(**labels).inc()
        if stats.matches:
            _tm.counter(
                "paddle_tpu_pass_matches_total",
                "pattern/site matches per pass", ("pass",),
            ).labels(**labels).inc(stats.matches)
        if stats.rewritten_ops:
            _tm.counter(
                "paddle_tpu_pass_rewritten_ops_total",
                "recorded ops removed or replaced per pass", ("pass",),
            ).labels(**labels).inc(stats.rewritten_ops)
        _tm.histogram(
            "paddle_tpu_pass_seconds",
            "wall time of one pass over one program", ("pass",),
        ).labels(**labels).observe(seconds)

    @staticmethod
    def _print_diff(name, before, after):
        import difflib
        import sys

        diff = difflib.unified_diff(
            before.splitlines(), after.splitlines(),
            fromfile=f"{name}: before", tofile=f"{name}: after", lineterm="",
        )
        print("\n".join(diff), file=sys.stderr)
