"""DRR-style declarative pattern rewriting over ProgramGraph (counterpart
of paddle_tpu/static/passes/drr.py; paddle/fluid/pir/drr).

A pattern is a source sub-graph spec plus a result builder; the framework
does the matching, safety analysis, and replacement. The sub-graph is a
list of `OpPat` specs over the recorded op list, matched
through ProgramGraph def-use chains; per-op and per-pattern `where`
predicates read the shape/dtype metadata harvested from the placeholder
tensors (and may PROBE a recorded op's fn on tiny CPU tensors — the
recorded closure is the ground truth for baked-in attributes like a
matmul's transpose flags).

A match is only legal when every interior var (produced by a matched op,
not a declared root) is consumed exclusively inside the cluster and is not
a liveness root (fetch/grad/opt) — the replacement may then delete the
interior ops without changing any observable value.

The default replacement (`build_cluster_instr`) is a mini-replay of the
matched instrs' own recorded fns — bit-identical by construction, since
the replay makes the exact same calls in the exact same order. Passes
that swap in a different kernel (the flash-attention
rewrite) supply their own builder and own numerics contract.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..analysis.graph import ProgramGraph
from ..program import OpInstr
from .pass_base import release_vars


class OpPat:
    """One op of a source pattern.

    kind:    op name or tuple of accepted names.
    ins:     symbols bound against the op's VAR inputs. `ordered=True`
             matches positionally over the var refs (matmul-like ops where
             operand position is semantics); `ordered=False` lets bound
             symbols sit at any position (add/multiply-like commutative
             ops).
    outs:    symbols bound against out_vars positionally; arity must match
             exactly.
    allow_extra_ins: unmatched trailing var inputs (weights, seeds) are
             legal and become externals of the replacement op.
    where:   optional predicate(program, graph, op, binding) -> bool.
    """

    __slots__ = ("kinds", "ins", "outs", "ordered", "allow_extra_ins", "where")

    def __init__(self, kind, ins, outs, ordered=True, allow_extra_ins=True,
                 where: Optional[Callable] = None):
        self.kinds = (kind,) if isinstance(kind, str) else tuple(kind)
        self.ins = list(ins)
        self.outs = list(outs)
        self.ordered = ordered
        self.allow_extra_ins = allow_extra_ins
        self.where = where


class Pattern:
    """A connected sub-DAG spec in dataflow order. `roots` are the output
    symbols that survive the rewrite (they must be produced by the LAST
    spec so the single replacement op can define them at the cluster's
    position without reordering any other op)."""

    def __init__(self, name: str, ops: Sequence[OpPat], roots: Sequence[str],
                 where: Optional[Callable] = None):
        self.name = name
        self.ops = list(ops)
        self.roots = list(roots)
        self.where = where  # (program, graph, binding, op_indices) -> bool
        produced = set()
        for j, spec in enumerate(self.ops):
            if j > 0 and not any(s in produced for s in spec.ins):
                raise ValueError(
                    f"pattern {name!r}: op #{j} is not connected to any "
                    f"earlier op's outputs — patterns must be dataflow-"
                    f"connected"
                )
            produced.update(spec.outs)
        last_outs = set(self.ops[-1].outs)
        bad = [r for r in self.roots if r not in last_outs]
        if bad:
            raise ValueError(
                f"pattern {name!r}: roots {bad} are not outputs of the last "
                f"op — replacement outputs must live at the cluster's end"
            )


class Match:
    __slots__ = ("pattern", "op_indices", "binding")

    def __init__(self, pattern, op_indices, binding):
        self.pattern = pattern
        self.op_indices = list(op_indices)  # in pattern-spec order
        self.binding = dict(binding)        # symbol -> vid

    def root_vids(self) -> List[int]:
        return [self.binding[s] for s in self.pattern.roots]

    def __repr__(self):
        ops = ", ".join(f"op#{i}" for i in self.op_indices)
        return f"Match({self.pattern.name}: {ops})"


# ---------------------------------------------------------------------------
# matching
# ---------------------------------------------------------------------------

def _match_op(spec: OpPat, program, graph, op_index, binding) -> Optional[dict]:
    op = program.ops[op_index]
    if op.name not in spec.kinds:
        return None
    var_refs = [r[1] for r in op.in_refs if r[0] == "var"]
    if len(var_refs) < len(spec.ins):
        return None
    if not spec.allow_extra_ins and len(var_refs) != len(spec.ins):
        return None
    nb = dict(binding)
    if spec.ordered:
        for sym, vid in zip(spec.ins, var_refs):
            if sym in nb:
                if nb[sym] != vid:
                    return None
            else:
                nb[sym] = vid
    else:
        remaining = list(var_refs)
        unbound = []
        for sym in spec.ins:
            if sym in nb:
                if nb[sym] in remaining:
                    remaining.remove(nb[sym])
                else:
                    return None
            else:
                unbound.append(sym)
        if len(remaining) < len(unbound):
            return None
        for sym, vid in zip(unbound, remaining):
            nb[sym] = vid
    if len(op.out_vars) != len(spec.outs):
        return None
    for sym, vid in zip(spec.outs, op.out_vars):
        if sym in nb and nb[sym] != vid:
            return None
        nb[sym] = vid
    if spec.where is not None and not spec.where(program, graph, op, nb):
        return None
    return nb


def _cluster_safe(program, graph: ProgramGraph, op_indices, root_vids) -> bool:
    matched = set(op_indices)
    roots = graph.roots()
    root_set = set(root_vids)
    for i in op_indices:
        for vid in program.ops[i].out_vars:
            if vid in root_set:
                continue
            if vid in roots:
                return False
            for site, si, _pos in graph.uses_of(vid):
                if site != "op" or si not in matched:
                    return False
    return True


def find_matches(program, graph: ProgramGraph, pattern: Pattern,
                 taken=None) -> List[Match]:
    """All non-overlapping matches of `pattern` against the current op
    list. `taken` (mutated) carries op indices already claimed by earlier
    patterns of the same pass run."""
    taken = taken if taken is not None else set()
    matches = []
    specs = pattern.ops

    def extend(j, binding, idxs):
        if j == len(specs):
            root_vids = [binding[s] for s in pattern.roots]
            if not _cluster_safe(program, graph, idxs, root_vids):
                return None
            if pattern.where is not None and not pattern.where(
                    program, graph, binding, list(idxs)):
                return None
            return Match(pattern, idxs, binding)
        spec = specs[j]
        # candidates: consumers of any already-bound input symbol's var
        cand = None
        for sym in spec.ins:
            vid = binding.get(sym)
            if vid is None:
                continue
            sites = {si for site, si, _ in graph.uses_of(vid) if site == "op"}
            cand = sites if cand is None else (cand & sites)
        if not cand:
            return None
        for ci in sorted(cand):
            if ci in taken or ci in idxs:
                continue
            nb = _match_op(spec, program, graph, ci, binding)
            if nb is None:
                continue
            m = extend(j + 1, nb, idxs + [ci])
            if m is not None:
                return m
        return None

    for i0 in range(len(program.ops)):
        if i0 in taken:
            continue
        b0 = _match_op(specs[0], program, graph, i0, {})
        if b0 is None:
            continue
        m = extend(1, b0, [i0])
        if m is not None:
            taken.update(m.op_indices)
            matches.append(m)
    return matches


# ---------------------------------------------------------------------------
# replacement
# ---------------------------------------------------------------------------

def external_refs(program, op_indices) -> Tuple[list, list]:
    """The cluster's inputs seen from outside: every matched in_ref whose
    var is not produced inside the cluster (deduplicated, first-occurrence
    order) plus every literal ref (one position each). Returns
    (refs, per-op arg plans) where a plan entry is ('env', vid) for an
    interior value or ('ext', pos) into the external arg list."""
    produced = set()
    for i in op_indices:
        produced.update(program.ops[i].out_vars)
    refs: list = []
    var_pos: Dict[int, int] = {}
    plans = []
    for i in op_indices:
        plan = []
        for ref in program.ops[i].in_refs:
            if ref[0] == "var" and ref[1] in produced:
                plan.append(("env", ref[1]))
            elif ref[0] == "var":
                pos = var_pos.get(ref[1])
                if pos is None:
                    pos = len(refs)
                    refs.append(ref)
                    var_pos[ref[1]] = pos
                plan.append(("ext", pos))
            else:
                plan.append(("ext", len(refs)))
                refs.append(ref)
        plans.append(plan)
    return refs, plans


class ClusterFn:
    """A fused op's fn: mini-replays `instrs` (the matched ops) over an
    interior env, `plans[i]` saying where each argument of instr i comes
    from (an earlier instr's output or the fused op's i-th input)."""

    __slots__ = ("instrs", "plans", "roots")

    def __init__(self, instrs, plans, roots):
        self.instrs, self.plans, self.roots = list(instrs), plans, list(roots)

    def __call__(self, *vals):
        env = {}
        for instr, plan in zip(self.instrs, self.plans):
            args = [env[key] if tag == "env" else vals[key] for tag, key in plan]
            out = instr.fn(*args, **instr.kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            for vid, pos in zip(instr.out_vars, instr.out_positions):
                env[vid] = outs[pos]
        res = tuple(env[v] for v in self.roots)
        return res if len(res) > 1 else res[0]


def build_cluster_instr(program, match: Match, name: str) -> OpInstr:
    """The default DRR result: ONE op whose fn mini-replays the matched
    instrs' recorded fns over an interior env — the replacement makes the
    exact same calls in the exact same order (bit-identical), with
    the cluster collapsed to a single recorded op."""
    instrs = [program.ops[i] for i in match.op_indices]
    refs, plans = external_refs(program, match.op_indices)
    roots = match.root_vids()
    return OpInstr(name, ClusterFn(instrs, plans, roots), refs, {}, list(roots),
                   list(range(len(roots))), len(roots))


def apply_matches(program, match_builders) -> int:
    """Replace each match's cluster with builder(program, match) — an
    OpInstr defining the match's root vids — inserted where the cluster's
    last op sat (all externals are defined earlier, all consumers read the
    root vids later, so no other op moves). `match_builders` is a list of
    (Match, builder) pairs whose matches must be non-overlapping and whose
    op indices refer to the CURRENT ops list — all replacements land in one
    compaction so no match invalidates another's indices. Interior vars'
    placeholder Tensors are released. Returns the number of ops removed."""
    if not match_builders:
        return 0
    removed_idx = set()
    repl_at: Dict[int, OpInstr] = {}
    interior_vids = []
    for m, builder in match_builders:
        instr = builder(program, m)
        roots = set(m.root_vids())
        if set(instr.out_vars) != roots:
            raise ValueError(
                f"pattern {m.pattern.name!r}: replacement defines "
                f"{instr.out_vars}, expected the match roots {sorted(roots)}"
            )
        removed_idx.update(m.op_indices)
        repl_at[max(m.op_indices)] = instr
        for i in m.op_indices:
            interior_vids.extend(
                v for v in program.ops[i].out_vars if v not in roots
            )
    new_ops = []
    for i, op in enumerate(program.ops):
        if i in repl_at:
            new_ops.append(repl_at[i])
        elif i in removed_idx:
            continue
        else:
            new_ops.append(op)
    n_removed = len(program.ops) - len(new_ops) + len(repl_at)
    program.ops = new_ops
    release_vars(program, interior_vids)
    program._compiled.clear()
    return n_removed
