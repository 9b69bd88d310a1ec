"""ProgramGraph: def-use analysis over a recorded Program (counterpart of
paddle_tpu/static/analysis/graph.py).

The recorded `OpInstr` list IS the operation sequence and the eagerly
evaluated placeholder tensors (or the meta tensors that replace them,
Program.release_activations) carry the shape/dtype metadata, so the
graph is harvested, not inferred. Every pass (verify, DCE, the fusion
rules) rewrites against this structure. dtypes print under numpy's
names ("float32", "bfloat16", "int64"), as in the JAX package's dumps.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


# var definition kinds, in replay order: feeds and params are bound before
# any op runs; op outputs appear in instruction order; grad vars are bound
# by the gradient pass AFTER all ops; opt updates run last and define
# nothing (they write back out-of-env)
KIND_FEED = "feed"
KIND_PARAM = "param"
KIND_OP = "op"
KIND_GRAD = "grad"


# definition-order keys (replay order): feeds/params bind before any op,
# op outputs at their op index, grad vars after ALL ops ran
ORDER_BEFORE_OPS = -1.0
ORDER_AFTER_OPS = float("inf")


class VarInfo:
    """One program var: where it is defined, who reads it, and the
    shape/dtype metadata harvested from its recorded placeholder Tensor."""

    __slots__ = ("vid", "kind", "def_op", "order", "name", "shape", "dtype", "uses")

    def __init__(self, vid, kind, def_op=None, name=None, shape=None, dtype=None,
                 order=None):
        self.vid = vid
        self.kind = kind
        self.def_op = def_op  # op index for KIND_OP, else None
        self.order = order    # ORDER_BEFORE_OPS | op index | ORDER_AFTER_OPS
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.uses: List[Tuple[str, int, int]] = []  # (site, site_index, arg_pos)

    def __repr__(self):
        return f"VarInfo(%v{self.vid} {self.kind} {self.dtype}{list(self.shape) if self.shape is not None else '?'})"


def _tensor_meta(program, vid):
    name = program._var_names.get(vid)
    t = program._var_tensors.get(vid)
    if t is None:
        return name, None, None
    return name, tuple(t.shape), str(t.dtype).replace("torch.", "")


def _opt_param_vars(upd):
    pv = upd.param_var
    return list(pv) if isinstance(pv, tuple) else [pv]


def _opt_grad_vars(upd):
    gv = upd.grad_var
    return list(gv) if isinstance(gv, tuple) else [gv]


class ProgramGraph:
    """Def-use chains + per-var metadata over `program.ops`.

    Use sites are tagged by kind: ("op", op_index, arg_pos),
    ("grad", request_index, 0) for the loss read, ("grad_wrt", request_index,
    k) for the differentiated params, ("opt", update_index, k) and
    ("opt_grad", update_index, k) for optimizer reads, ("fetch", k, 0).
    """

    def __init__(self, program, fetch_vars=None):
        self.program = program
        self.fetch_vars = list(fetch_vars or ())
        self.vars: Dict[int, VarInfo] = {}
        # EVERY definition site per var, in replay order: (order, label).
        # len > 1 is an SSA violation the verifier reports; the VarInfo
        # keeps the first site's kind/order
        self.def_sites: Dict[int, List[Tuple[float, str]]] = {}
        # same vid bound twice WITHIN one site: (site_kind, label, vid)
        self.intra_site_dups: List[Tuple[str, str, int]] = []
        self._build()

    # ---- construction ----
    def _define(self, vid, kind, label, order, def_op=None):
        self.def_sites.setdefault(vid, []).append((order, label))
        info = self.vars.get(vid)
        if info is None:
            name, shape, dtype = _tensor_meta(self.program, vid)
            self.vars[vid] = VarInfo(vid, kind, def_op, name, shape, dtype,
                                     order=order)
        # a second definition is a verifier error, not a graph error: keep
        # the FIRST definition and let verify() report the collision
        return self.vars[vid]

    def _use(self, vid, site, site_index, arg_pos):
        info = self.vars.get(vid)
        if info is None:
            # undefined var (verifier reports it); record a metadata-less
            # entry so uses_of() still answers
            info = self.vars[vid] = VarInfo(vid, "undefined")
            name, shape, dtype = _tensor_meta(self.program, vid)
            info.name, info.shape, info.dtype = name, shape, dtype
        info.uses.append((site, site_index, arg_pos))

    def _build(self):
        prog = self.program
        for name, vid in prog.feed_vars.items():
            info = self._define(vid, KIND_FEED, f"feed {name!r}", ORDER_BEFORE_OPS)
            if info.name is None:
                info.name = name
        seen_params = set()
        for vid in prog.param_vars:
            if vid in seen_params:
                self.intra_site_dups.append(("param", f"param %v{vid}", vid))
                continue
            seen_params.add(vid)
            self._define(vid, KIND_PARAM, f"param %v{vid}", ORDER_BEFORE_OPS)
        for i, op in enumerate(prog.ops):
            seen_out = set()
            for vid in op.out_vars:
                if vid in seen_out:
                    self.intra_site_dups.append(("op", f"op#{i} '{op.name}'", vid))
                    continue
                seen_out.add(vid)
                self._define(vid, KIND_OP, f"op#{i} '{op.name}'", float(i), def_op=i)
        for ri, (loss_var, pvars, gvars) in enumerate(prog.grad_requests):
            for gv in gvars:
                self._define(gv, KIND_GRAD, f"grad#{ri}", ORDER_AFTER_OPS)
        # uses, in replay order
        for i, op in enumerate(prog.ops):
            for pos, ref in enumerate(op.in_refs):
                if ref[0] == "var":
                    self._use(ref[1], "op", i, pos)
        for ri, (loss_var, pvars, gvars) in enumerate(prog.grad_requests):
            self._use(loss_var, "grad", ri, 0)
            for k, pv in enumerate(pvars):
                self._use(pv, "grad_wrt", ri, k)
        for ui, upd in enumerate(prog.opt_updates):
            for k, pv in enumerate(_opt_param_vars(upd)):
                self._use(pv, "opt", ui, k)
            for k, gv in enumerate(_opt_grad_vars(upd)):
                self._use(gv, "opt_grad", ui, k)
        for k, vid in enumerate(self.fetch_vars):
            self._use(vid, "fetch", k, 0)

    # ---- queries ----
    def def_of(self, vid) -> Optional[VarInfo]:
        return self.vars.get(vid)

    def uses_of(self, vid) -> List[Tuple[str, int, int]]:
        info = self.vars.get(vid)
        return list(info.uses) if info is not None else []

    def roots(self) -> set:
        """Liveness roots: fetches, grad-request loss/param vars, optimizer
        param/grad vars — everything whose value escapes the replay."""
        prog = self.program
        roots = set(self.fetch_vars)
        for loss_var, pvars, gvars in prog.grad_requests:
            roots.add(loss_var)
            roots.update(pvars)
        for upd in prog.opt_updates:
            roots.update(_opt_param_vars(upd))
            roots.update(_opt_grad_vars(upd))
        return roots

    def live_ops(self, extra_roots=()) -> List[bool]:
        """Backward liveness walk over the op list: op i is live when any of
        its outputs is (transitively) demanded by a root, or when it is
        effectful. Returns a per-op bool mask."""
        prog = self.program
        live_vars = set(self.roots()) | set(extra_roots)
        mask = [False] * len(prog.ops)
        for i in range(len(prog.ops) - 1, -1, -1):
            op = prog.ops[i]
            live = (
                op.name in EFFECTFUL_OPS
                or not op.out_vars  # unknown side effects: keep
                or any(v in live_vars for v in op.out_vars)
            )
            mask[i] = live
            if live:
                for ref in op.in_refs:
                    if ref[0] == "var":
                        live_vars.add(ref[1])
        return mask


# ops that must survive DCE even when nothing reads their outputs: they
# observe or escape the program (the reference keeps these out of
# eliminate_dead_code the same way). py_func is NOT here: it never records
# under its own name (it either runs the callable eagerly or routes through
# static_pylayer, whose inner ops record under their own names); zero-output
# ops are kept unconditionally by live_ops as the unknown-side-effect net.
EFFECTFUL_OPS = frozenset({"print_op"})


# ---------------------------------------------------------------------------
# stable text dump (the --print-after-pass format)
# ---------------------------------------------------------------------------

def _fmt_shape(shape, dtype, declared=None):
    if declared is not None:
        dims = ", ".join("-1" if d in (-1, None) else str(int(d)) for d in declared)
    elif shape is None:
        return "?"
    else:
        dims = ", ".join(str(d) for d in shape)
    return f"{dtype or '?'}[{dims}]"


def _fmt_lit(value):
    # the dump contract is one line per op and NO addresses: collapse
    # newlines (numpy-array reprs) and replace address-bearing reprs
    # (functions/objects) with the bare type so two identically-constructed
    # programs render identically across processes
    r = repr(value).replace("\n", "\\n")
    if " at 0x" in r:
        r = f"<{type(value).__name__}>"
    return r if len(r) <= 40 else r[:37] + "..."


def program_to_text(program, fetch_vars=None) -> str:
    """Render `program` as a stable, diffable text dump. No memory
    addresses, no op serials — two identically-constructed programs render
    identically, so pass pipelines can --print-after-pass and diff."""
    prog = program
    feed_by_vid = {vid: name for name, vid in prog.feed_vars.items()}
    lines = [
        "program {"
        f"  # {len(prog.ops)} ops, {len(prog.feed_vars)} feeds, "
        f"{len(prog.param_vars)} params, {len(prog.grad_requests)} grad_requests, "
        f"{len(prog.opt_updates)} opt_updates"
    ]
    for name, vid in prog.feed_vars.items():
        _, shape, dtype = _tensor_meta(prog, vid)
        declared = prog.feed_shapes.get(name)
        lines.append(f"  feed  %v{vid} {name!r} : {_fmt_shape(shape, dtype, declared)}")
    for i, vid in enumerate(prog.param_vars):
        pname, shape, dtype = _tensor_meta(prog, vid)
        label = f" {pname!r}" if pname else ""
        lines.append(f"  param %v{vid}{label} : {_fmt_shape(shape, dtype)}")
    for i, op in enumerate(prog.ops):
        ins = []
        for ref in op.in_refs:
            if ref[0] == "var":
                ins.append(f"%v{ref[1]}")
            else:
                ins.append(_fmt_lit(ref[1]))
        if op.kwargs:
            ins += [f"{k}={_fmt_lit(v)}" for k, v in sorted(op.kwargs.items())]
        outs = ", ".join(f"%v{v}" for v in op.out_vars) or "()"
        metas = []
        for vid in op.out_vars:
            _, shape, dtype = _tensor_meta(prog, vid)
            metas.append(_fmt_shape(shape, dtype))
        meta = ", ".join(metas) if metas else "()"
        lines.append(f"  {outs} = {op.name}({', '.join(ins)}) : {meta}  # op#{i}")
    for ri, (loss_var, pvars, gvars) in enumerate(prog.grad_requests):
        wrt = ", ".join(f"%v{v}" for v in pvars)
        outs = ", ".join(f"%v{v}" for v in gvars)
        lines.append(f"  grad [{outs}] = d sum(%v{loss_var}) / d [{wrt}]  # grad#{ri}")
    for ui, upd in enumerate(prog.opt_updates):
        kind = type(upd).__name__.lstrip("_")
        pvs = ", ".join(f"%v{v}" for v in _opt_param_vars(upd))
        gvs = ", ".join(f"%v{v}" for v in _opt_grad_vars(upd))
        n_acc = len(getattr(upd, "accum_tensors", ()))
        lines.append(
            f"  opt {kind} params=[{pvs}] grads=[{gvs}] accums={n_acc}  # opt#{ui}"
        )
    for vid in fetch_vars or ():
        name = feed_by_vid.get(vid)
        label = f" {name!r}" if name else ""
        lines.append(f"  fetch %v{vid}{label}")
    lines.append("}")
    return "\n".join(lines)


def describe_program(program, fetch_vars=None) -> str:
    """`paddle.static.describe_program` convenience: the to_text dump.
    Accepts a Program or a CompiledProgram-style wrapper."""
    prog = getattr(program, "_program", program)
    return program_to_text(prog, fetch_vars=fetch_vars)
