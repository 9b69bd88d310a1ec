"""Static-graph Program IR (counterpart of paddle_tpu/static/program.py).

Under `program_guard` every op is recorded as an instruction (its replay
callable plus SSA var refs, core/record.py) while it also runs eagerly
on placeholder values: the eager run IS the shape/dtype inference. The
Executor (executor.py) then replays the instruction list on the card,
op by op.

Differences from the JAX package, each forced by torch:
- torch tensors have a read-only `.name`, so a Program keeps the names
  of its vars itself (`_var_names`: feeds, `@GRAD` vars, parameters
  named through `name_vars`);
- the capture's dry run runs without autograd (the static backward comes
  from the replay), so a captured model's activations hold no graph;
- at the guard's exit `release_activations` turns the recorded op outputs
  no caller holds into meta tensors (shape and dtype only), so a captured
  model does not pin its dry run's activations;
- `replay_env(..., keep=)` frees each value after its last use unless it
  is kept, as a compiled program would.
"""
from __future__ import annotations

import itertools
import sys
from typing import Dict, List, Optional, Tuple

import torch

from ..core import record as _record
from ..core import state

Tensor = torch.Tensor

# process-global monotonic serial for OpInstr identity: unlike id(), serials
# are never reused, so the Executor's cache key can tell a replaced op from
# the original even at the same memory address
_op_serial = itertools.count()


class OpInstr:
    """One recorded op: out_vars = fn(*in_refs, **kwargs).

    `out_positions[i]` is the index of out_vars[i] inside the raw output
    tuple fn returns (non-Tensor outputs are not program vars);
    `n_raw_outs` is the raw output count recorded at capture time, which
    replay_env enforces."""

    __slots__ = ("name", "fn", "in_refs", "kwargs", "out_vars",
                 "out_positions", "n_raw_outs", "seq")

    def __init__(self, name, fn, in_refs, kwargs, out_vars,
                 out_positions=None, n_raw_outs=None):
        self.name = name
        self.fn = fn
        self.in_refs = in_refs  # list of ("var", var_id) | ("lit", value)
        self.kwargs = kwargs
        self.out_vars = out_vars  # list of var_id
        self.out_positions = (
            list(out_positions) if out_positions is not None else list(range(len(out_vars)))
        )
        self.n_raw_outs = n_raw_outs if n_raw_outs is not None else len(out_vars)
        self.seq = next(_op_serial)

    def __repr__(self):
        ins = [f"v{r[1]}" if r[0] == "var" else repr(r[1]) for r in self.in_refs]
        return f"{[f'v{v}' for v in self.out_vars]} = {self.name}({', '.join(ins)})"


class Program:
    """A recorded instruction list with feed/param/fetch bookkeeping."""

    def __init__(self):
        self.ops: List[OpInstr] = []
        self.feed_vars: Dict[str, int] = {}  # feed name -> var id
        self.feed_shapes: Dict[str, tuple] = {}  # declared shapes (-1 = dynamic)
        self._id2var: Dict[int, int] = {}  # id(Tensor) -> var id
        self._var_tensors: Dict[int, Tensor] = {}  # var id -> Tensor (keepalive)
        self._var_names: Dict[int, str] = {}  # var id -> name
        self.param_vars: List[int] = []  # external persistable inputs (Parameters etc.)
        self.grad_requests: List[Tuple[int, List[int], List[int]]] = []  # (loss, params, grad vars)
        self.opt_updates: List = []  # _OptUpdate records (see executor)
        self._next_var = 0
        self._compiled = {}

    # ---- var management ----
    def _new_var(self, tensor: Optional[Tensor] = None, name: Optional[str] = None) -> int:
        vid = self._next_var
        self._next_var += 1
        if tensor is not None:
            self._id2var[id(tensor)] = vid
            self._var_tensors[vid] = tensor
        if name is not None:
            self._var_names[vid] = name
        return vid

    def var_of(self, tensor: Tensor, external_ok=True) -> int:
        """Var id of a tensor; unseen tensors become external persistable
        inputs (parameters / captured constants), read fresh at each run."""
        vid = self._id2var.get(id(tensor))
        if vid is None:
            if not external_ok:
                raise KeyError("tensor is not part of this program")
            vid = self._new_var(tensor)
            self.param_vars.append(vid)
        return vid

    def add_feed(self, name: str, tensor: Tensor) -> int:
        vid = self._new_var(tensor, name)
        self.feed_vars[name] = vid
        return vid

    def name_vars(self, named_tensors) -> None:
        """Name the program's vars from (name, tensor) pairs (as
        `layer.named_parameters()` gives them), so they resolve as fetch
        targets by name and read by name in to_text: paddle sets
        `tensor.name`, which torch keeps read-only."""
        for name, t in named_tensors:
            vid = self._id2var.get(id(t))
            if vid is not None:
                self._var_names[vid] = name

    def var_name(self, vid) -> Optional[str]:
        return self._var_names.get(vid)

    # ---- recording (called from core/record.py) ----
    def record_op(self, name, fn, args, kwargs, outs):
        in_refs = []
        for a in args:
            if isinstance(a, Tensor):
                in_refs.append(("var", self.var_of(a)))
            else:
                in_refs.append(("lit", a))
        out_list = outs if isinstance(outs, (tuple, list)) else [outs]
        out_vars, out_positions = [], []
        for i, o in enumerate(out_list):
            if isinstance(o, Tensor):
                out_vars.append(self._new_var(o))
                out_positions.append(i)
        self.ops.append(OpInstr(name, fn, in_refs, dict(kwargs), out_vars,
                                out_positions, len(out_list)))
        self._compiled.clear()

    # ---- replay (shared by the Executor and the passes' tests) ----
    def last_uses(self) -> Dict[int, int]:
        """var id -> index of the last op that reads it."""
        last = {}
        for i, instr in enumerate(self.ops):
            for r in instr.in_refs:
                if r[0] == "var":
                    last[r[1]] = i
        return last

    def replay_env(self, feed_bindings, param_arrays, keep=None, last_uses=None,
                   grad_leaves=()):
        """Execute the instruction list over an env seeded with feed/param
        values; returns the env (var id -> value). With `keep` (a set of var
        ids), a value no later op reads and `keep` does not hold is dropped
        after its last use. A float feed or op output in `grad_leaves` that
        autograd does not track yet becomes a leaf that requires grad, so
        a gradient can be taken with respect to it."""
        env = dict(feed_bindings)
        for vid, arr in zip(self.param_vars, param_arrays):
            env[vid] = arr
        for vid in grad_leaves:
            if vid in env:
                env[vid] = _grad_leaf(env[vid])
        if keep is not None and last_uses is None:
            last_uses = self.last_uses()
        for i, instr in enumerate(self.ops):
            args = [env[r[1]] if r[0] == "var" else r[1] for r in instr.in_refs]
            out = instr.fn(*args, **instr.kwargs)
            outs = out if isinstance(out, (tuple, list)) else (out,)
            # arity is a hard contract: a fn returning another number of
            # outputs than recorded would silently drop or misplace vars
            if len(outs) != instr.n_raw_outs:
                raise RuntimeError(
                    f"program replay: op#{i} '{instr.name}' returned "
                    f"{len(outs)} output(s) but {instr.n_raw_outs} were "
                    f"recorded at capture time — the op function changed "
                    f"arity between record and replay"
                )
            for vid, pos in zip(instr.out_vars, instr.out_positions):
                env[vid] = _grad_leaf(outs[pos]) if vid in grad_leaves else outs[pos]
            if keep is not None:
                for r in instr.in_refs:
                    if r[0] == "var" and last_uses.get(r[1]) == i and r[1] not in keep:
                        env.pop(r[1], None)
                for vid in instr.out_vars:
                    if vid not in last_uses and vid not in keep:
                        env.pop(vid, None)
        return env

    # ---- introspection ----
    def resolve_fetch(self, f) -> int:
        """THE fetch-target resolution policy, shared by Executor.run and
        the analysis passes: Tensor by identity, string by feed name then
        newest named var."""
        if isinstance(f, Tensor):
            vid = self._id2var.get(id(f))
            if vid is None:
                raise ValueError(f"fetch target {tuple(f.shape)} {f.dtype} is not in this program")
            return vid
        if isinstance(f, str):
            if f in self.feed_vars:
                return self.feed_vars[f]
            named = [v for v, n in self._var_names.items() if n == f]
            if not named:
                raise ValueError(f"no variable named {f!r} in program")
            return max(named)
        raise TypeError(f"fetch_list entries must be Tensor or str, got {type(f)}")

    def list_vars(self):
        return list(self._var_tensors.values())

    def global_block(self):
        return self

    def all_parameters(self):
        return [
            self._var_tensors[v]
            for v in self.param_vars
            if isinstance(self._var_tensors.get(v), torch.nn.Parameter)
        ]

    def release_activations(self) -> int:
        """Swap every recorded op output that nothing outside the Program
        references (and that is not 0-d: constant folding reads those) for
        a meta tensor of its shape and dtype: the analyses read only those,
        and the dry run's values are freed. A tensor the caller still holds
        stays, so it remains a fetch target. Returns the bytes released."""
        freed = 0
        for op in reversed(self.ops):  # a view, released, lets go of its base
            for vid in op.out_vars:
                t = self._var_tensors.get(vid)
                # held by this dict, `t` and getrefcount's argument only
                if t is None or t.ndim == 0 or t.is_meta or sys.getrefcount(t) > 3:
                    continue
                self._id2var.pop(id(t), None)
                freed += t.numel() * t.element_size()
                self._var_tensors[vid] = torch.empty(t.shape, dtype=t.dtype, device="meta")
        return freed

    def to_text(self, fetch_vars=None):
        """Stable text dump of the program (the `--print-after-pass` format
        of the analysis layer)."""
        from .analysis.graph import program_to_text

        return program_to_text(self, fetch_vars=fetch_vars)

    def __repr__(self):
        return self.to_text()

    def clone(self, for_test=False):
        """A copy sharing the recorded ops and the tensors. With
        `for_test`, paddle's test program: no backward or updates, and
        every op with a training switch (batch norm, the dropouts, also
        inside a fused op) replays in inference mode, so batch norm
        normalizes with its buffers and writes nothing; this program's
        ops are left as they are."""
        p = Program()
        p.ops = [_inference_op(op) for op in self.ops] if for_test else list(self.ops)
        p.feed_vars = dict(self.feed_vars)
        p.feed_shapes = dict(self.feed_shapes)
        p._id2var = dict(self._id2var)
        p._var_tensors = dict(self._var_tensors)
        p._var_names = dict(self._var_names)
        p.param_vars = list(self.param_vars)
        p.grad_requests = [] if for_test else list(self.grad_requests)
        p.opt_updates = [] if for_test else list(self.opt_updates)
        p._next_var = self._next_var
        return p


def _grad_leaf(v):
    if v.requires_grad or not v.is_floating_point() or not torch.is_grad_enabled():
        return v
    return v.detach().requires_grad_()


# ---- a test clone's ops (Program.clone(for_test=True)) ----

_TRAINING_ARGS = ("training", "train")  # paddle's functionals, torch's dropouts


class _Inference:
    """A recorded op's target called with its training switch off."""

    __slots__ = ("target", "sig", "arg")

    def __init__(self, target, sig, arg):
        self.target, self.sig, self.arg = target, sig, arg

    def __call__(self, *args, **kwargs):
        bound = self.sig.bind(*args, **kwargs)
        bound.arguments[self.arg] = False
        return self.target(*bound.args, **bound.kwargs)


def _inference_fn(fn):
    """`fn` (a recorded op's fn) replaying in inference mode, or None when
    nothing in it has a training switch."""
    import inspect

    from .passes.drr import ClusterFn

    if isinstance(fn, ClusterFn):
        instrs = [_inference_op(i) for i in fn.instrs]
        if all(a is b for a, b in zip(instrs, fn.instrs)):
            return None
        return ClusterFn(instrs, fn.plans, fn.roots)
    if not isinstance(fn, _record.Replay):
        return None
    target = inspect.unwrap(fn.target)
    try:
        sig = inspect.signature(target)
    except (TypeError, ValueError):  # a builtin without a signature
        return None
    arg = next((a for a in _TRAINING_ARGS if a in sig.parameters), None)
    if arg is None:
        return None
    return _record.Replay(_Inference(target, sig, arg), fn.spec, fn.amp, fn.rng)


def _inference_op(op: OpInstr) -> OpInstr:
    fn = _inference_fn(op.fn)
    if fn is None:
        return op
    return OpInstr(op.name, fn, list(op.in_refs), dict(op.kwargs), list(op.out_vars),
                   op.out_positions, op.n_raw_outs)


# ---- global default programs (paddle.static.default_main_program) ----

_default_main = Program()
_default_startup = Program()


def default_main_program() -> Program:
    return _default_main


def default_startup_program() -> Program:
    return _default_startup


class program_guard:
    """paddle.static.program_guard: activates instruction capture. The
    capture's eager dry run runs without autograd; parameters created
    inside are initialized unrecorded; at the exit the dry run's values no
    caller holds are released (`Program.release_activations`)."""

    def __init__(self, main_program: Program, startup_program: Optional[Program] = None):
        self.main = main_program
        self.startup = startup_program

    def __enter__(self):
        global _default_main, _default_startup
        self._prev_main = _default_main
        self._prev_startup = _default_startup
        _default_main = self.main
        if self.startup is not None:
            _default_startup = self.startup
        self._prev_capture = state.set_program_capture(self.main)
        self._no_grad = torch.no_grad()
        self._no_grad.__enter__()
        self._mode = _record.CaptureMode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        global _default_main, _default_startup
        self._mode.__exit__(*exc)
        self._no_grad.__exit__(*exc)
        _default_main = self._prev_main
        _default_startup = self._prev_startup
        state.set_program_capture(self._prev_capture)
        self.main.release_activations()
        return False


def data(name: str, shape, dtype="float32", lod_level=0) -> Tensor:
    """paddle.static.data: a feed placeholder of zeros on the framework
    device (dims of -1/None are 1 for the eager dry run; a replay takes any
    size there). Python reads of a dynamic dim during capture
    (``x.shape[0]``) raise: they would bake the dry-run size into the
    program. Pass -1 to reshape instead."""
    from ..framework import device as _device
    from ..framework.dtype import convert_dtype

    prog = state.get_program_capture()
    if prog is None:
        raise RuntimeError("static.data must be called under paddle.static.program_guard")
    dims = tuple(1 if d in (-1, None) else int(d) for d in shape)
    with _record.suspended():
        t = torch.zeros(dims, dtype=convert_dtype(dtype), device=_device.resolve(None))
    dyn = {i for i, d in enumerate(shape) if d in (-1, None)}
    if dyn:
        t._dynamic_dims = dyn
    prog.add_feed(name, t)
    prog.feed_shapes[name] = tuple(shape)
    return t
