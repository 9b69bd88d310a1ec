"""The rest of paddle.static (counterpart of paddle_tpu/static/extras.py):
the strategy and annotation names (BuildStrategy, ExecutionStrategy,
CompiledProgram, the Ipu names, name_scope, device_guard), places,
create_global_var, gradients, Print, py_func, WeightNormParamAttr,
ExponentialMovingAverage, the metrics (accuracy, auc, ctr_metric_bundle),
and the program serialization names: a Program's feed->fetch computation
to bytes and back (static/io.py's export), its persistables to bytes and
back, and .pdparams states.

The strategies carry their fields and change nothing: the Executor
replays the recorded ops eagerly, and `CompiledProgram` is an annotation
it unwraps. `cuda_places` names the card(s): the JAX package raises
there ("the TPU build"), paddle's CUDA build returns them, and it
raises as paddle's CPU build does when CUDA is unavailable.
"""
from __future__ import annotations

import contextlib
import os

import torch

from ..core import record as _record
from ..core import state as _state
from ..framework import io as fio
from ..nn.initializer import ParamAttr
from . import io as _io
from .program import Program, default_main_program

Variable = torch.Tensor  # paddle's static Variable: one tensor type here


class BuildStrategy:
    """paddle.static.BuildStrategy: the fields paddle's graph executor
    reads, carried so configs port without edits; they change nothing."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_optimizer_ops = False
        self.fuse_all_reduce_ops = False
        self.fuse_broadcast_ops = False
        self.fuse_elewise_add_act_ops = False
        self.fuse_bn_act_ops = False
        self.fuse_bn_add_act_ops = True
        self.fuse_gemm_epilogue = False
        self.sync_batch_norm = False
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.build_cinn_pass = False
        self.debug_graphviz_path = ""

    def __repr__(self):
        fields = ", ".join(f"{k}={v!r}" for k, v in vars(self).items())
        return f"BuildStrategy({fields})"


class ExecutionStrategy:
    """paddle.static.ExecutionStrategy: thread and scope fields, carried."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 100
        self.num_iteration_per_run = 1
        self.use_device = None


class CompiledProgram:
    """A Program marked for compiled execution, with its BuildStrategy.
    The Executor runs the Program it wraps; other attributes read
    through to it."""

    def __init__(self, program_or_graph, build_strategy=None):
        self._program = program_or_graph
        self._build_strategy = build_strategy or BuildStrategy()

    def __getattr__(self, item):
        return getattr(object.__getattribute__(self, "_program"), item)


def _no_ipu(name):
    return RuntimeError(f"{name} is only available with IPU support")


class IpuStrategy:
    def __init__(self):
        raise _no_ipu("IpuStrategy")


class IpuCompiledProgram:
    def __init__(self, program=None, ipu_strategy=None, scope=None):
        raise _no_ipu("IpuCompiledProgram")


@contextlib.contextmanager
def ipu_shard_guard(index=-1, stage=-1):
    raise _no_ipu("ipu_shard_guard")
    yield  # a generator, as a context manager's function must be


def set_ipu_shard(call_func, index=-1, stage=-1):
    raise _no_ipu("set_ipu_shard")


@contextlib.contextmanager
def name_scope(prefix=None):
    """Op names carry no prefix here; the guard nests and changes nothing."""
    yield


@contextlib.contextmanager
def device_guard(device=None):
    """Ops run where the program's tensors are; the guard changes nothing."""
    yield


def cpu_places(device_count=None):
    """CPU_NUM (1) CPU places."""
    from ..framework.device import CPUPlace

    n = device_count or int(os.environ.get("CPU_NUM", 1))
    return [CPUPlace() for _ in range(n)]


def cuda_places(device_ids=None):
    """A CUDAPlace for each card (or each of `device_ids`); raises as
    paddle's CPU build does when CUDA is unavailable."""
    from ..framework.device import CUDAPlace

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_places: CUDA is not available (not compiled with CUDA, "
                           "or no card is visible)")
    ids = range(torch.cuda.device_count()) if device_ids is None else device_ids
    return [CUDAPlace(int(i)) for i in ids]


def xpu_places(device_ids=None):
    raise RuntimeError("xpu_places: not compiled with XPU")


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    """A tensor of `shape` filled with `value` on the framework device
    (on the CPU with force_cpu)."""
    from ..framework import device as _device
    from ..framework.dtype import convert_dtype

    dev = "cpu" if force_cpu else _device.resolve(None)
    with _record.suspended():
        t = torch.full(tuple(int(s) for s in shape), value, dtype=convert_dtype(dtype),
                       device=dev)
    t.persistable = persistable
    return t


def _as_list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """d(targets)/d(inputs), seeded by target_gradients (ones). Outside
    capture: torch.autograd.grad now (None for an input the targets do
    not reach, or one in no_grad_set). Under program_guard: a grad
    request appended to the program, as append_backward's, over one
    recorded op "gradients_target" (the sum of each target times its
    seed); the returned placeholders are fetch targets, computed at every
    run. Inputs may be parameters, feeds or activations."""
    targets, inputs = _as_list(targets), _as_list(inputs)
    seeds = _as_list(target_gradients) if target_gradients is not None else [None] * len(targets)
    skip = {id(t) for t in (no_grad_set or ())}
    prog = _state.get_program_capture()
    if prog is None:
        wrt = [x for x in inputs if id(x) not in skip]
        seeds = [torch.ones_like(t) if g is None else g for t, g in zip(targets, seeds)]
        got = torch.autograd.grad(targets, wrt, grad_outputs=seeds, retain_graph=True,
                                  allow_unused=True)
        it = iter(got)
        return [None if id(x) in skip else next(it) for x in inputs]

    def weighted_sum(*vals):
        ts, gs = vals[:len(targets)], vals[len(targets):]
        return sum(((t * g).sum() if g is not None else t.sum()) for t, g in zip(ts, gs))

    target = _record.apply("gradients_target", weighted_sum, *targets, *seeds)
    loss_var = prog._id2var[id(target)]
    wrt_vars, grad_vars, out = [], [], []
    for x in inputs:
        if id(x) in skip:
            out.append(None)
            continue
        xv = prog.var_of(x)
        g = torch.empty(x.shape, dtype=x.dtype, device="meta")
        wrt_vars.append(xv)
        grad_vars.append(prog._new_var(g, (prog.var_name(xv) or f"v{xv}") + "@GRAD"))
        out.append(g)
    prog.grad_requests.append((loss_var, wrt_vars, grad_vars))
    prog._compiled.clear()
    return out


def Print(input, first_n=-1, message=None, summarize=20, print_tensor_name=True,  # noqa: A002,N802
          print_tensor_type=True, print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Prints `message` and the value, and returns the value: now, or
    under program_guard at every run of the program (one op "print_op",
    kept by dead-op elimination; the capture's dry run prints nothing)."""

    def fn(v):
        if _state.get_program_capture() is None:  # the JAX package's "msg {x}" format
            print(f"{message or ''} {fio.tensor_to_numpy(v.detach())}", flush=True)
        return v.view_as(v)  # a new tensor: an op that hands back its input records nothing

    return _record.apply("print_op", fn, input)


def py_func(func, x, out=None, backward_func=None, skip_vars_in_backward_input=None):
    """static.nn.py_func."""
    from . import nn as _static_nn

    return _static_nn.py_func(func, x, out=out, backward_func=backward_func,
                              skip_vars_in_backward_input=skip_vars_in_backward_input)


class WeightNormParamAttr(ParamAttr):
    """A ParamAttr that asks for the weight-norm reparameterization along
    `dim`: layers take it as a ParamAttr (nn.utils.weight_norm does the
    reparameterization in dygraph)."""

    def __init__(self, dim=None, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=False, need_clip=True):
        super().__init__(name=name, initializer=initializer, learning_rate=learning_rate,
                         regularizer=regularizer, trainable=trainable, need_clip=need_clip)
        self.dim = dim
        self.do_model_average = do_model_average


class ExponentialMovingAverage:
    """EMA of the trainable parameters of the program current at
    construction, with bias correction: update() folds the values in
    (shadow = p (1 - decay) at the first, then decay shadow + (1 - decay)
    p); apply() swaps shadow / (1 - decay^steps) into the parameters (a
    context manager that restores them), restore() undoes an apply. The
    shadows live on the parameters' device, in their dtype."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._step = 0
        self._ema = {}
        self._backup = {}
        self._params = None
        self._program = default_main_program()

    def _param_list(self):
        if self._params is None:
            prog = self._program
            params = [prog._var_tensors[v] for v in prog.param_vars]
            self._params = [p for p in params
                            if isinstance(p, torch.nn.Parameter) and p.requires_grad]
            if not self._params:
                raise ValueError(
                    "ExponentialMovingAverage found no trainable parameters in the current "
                    "program: make it after building the model")
        return self._params

    @torch.no_grad()
    def update(self):
        self._step += 1
        d = self._decay
        for p in self._param_list():
            shadow = self._ema.get(id(p))
            if shadow is None:
                self._ema[id(p)] = p.detach() * (1.0 - d)
            else:
                shadow.mul_(d).add_(p.detach() * (1.0 - d))

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        correction = 1.0 - self._decay ** max(1, self._step)
        with torch.no_grad():
            for p in self._param_list():
                self._backup[id(p)] = p.detach().clone()
                if id(p) in self._ema:
                    p.copy_(self._ema[id(p)] / correction)
        try:
            yield
        finally:
            if need_restore:
                self.restore(executor)

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._param_list():
            if id(p) in self._backup:
                p.copy_(self._backup.pop(id(p)))


def _accuracy(pred, lbl, k):
    top = torch.topk(pred, min(k, pred.shape[-1]), dim=-1).indices
    hit = (top == lbl.reshape(-1, 1)).any(dim=-1)
    return hit.float().mean()


def accuracy(input, label, k=1, correct=None, total=None):  # noqa: A002
    """Top-k accuracy (f32 0-d), one op "accuracy"."""
    return _record.apply("accuracy", _accuracy, input, label, k)


def auc_thresholds(num_thresholds):
    """The f64 grid 0, 1/nt, ..., 1 of np.linspace(0, 1, nt + 1), bit for
    bit (i * (1 / nt), the last exactly 1)."""
    nt = int(num_thresholds)
    thr = torch.arange(nt + 1, dtype=torch.float64) * (1.0 / nt)
    thr[-1] = 1.0
    return thr


def _trapezoid(y, x):
    return 0.5 * torch.sum((x[1:] - x[:-1]) * (y[1:] + y[:-1]))


def _auc(pred, lbl, nt, curve):
    p1 = pred[:, -1] if pred.dim() == 2 else pred.reshape(-1)
    y = lbl.reshape(-1).bool()
    thr = auc_thresholds(nt).to(p1.device)
    ge = p1[None, :] >= thr[:, None]  # [T + 1, B], compared in f64
    tp = torch.sum(ge & y[None, :], dim=1).double()
    fp = torch.sum(ge & ~y[None, :], dim=1).double()
    pos = torch.clamp(torch.sum(y), min=1)
    neg = torch.clamp(torch.sum(~y), min=1)
    tpr = tp / pos
    if curve == "PR":
        # precision 1 where nothing is predicted positive (recall -> 0)
        precision = torch.where(tp + fp > 0, tp / torch.clamp(tp + fp, min=1e-12),
                                torch.ones_like(tp))
        return torch.abs(_trapezoid(precision, tpr))
    return torch.abs(_trapezoid(tpr, fp / neg))


def auc(input, label, curve="ROC", num_thresholds=2 ** 12 - 1, topk=1, slide_steps=1,  # noqa: A002
        ins_tag_weight=None):
    """The batch's area under the ROC (or precision-recall) curve over
    num_thresholds + 1 f64 thresholds (at most 4096), one op "auc";
    returns (auc, [auc]) as the JAX package does."""
    nt = min(int(num_thresholds), 4095)
    if curve not in ("ROC", "PR"):
        raise ValueError("curve must be 'ROC' or 'PR'")
    a = _record.apply("auc", _auc, input, label, nt, curve)
    return a, [a]


def _ctr_stats(pred, lbl):
    p1 = pred[:, -1] if pred.dim() == 2 else pred.reshape(-1)
    y = lbl.reshape(-1).float()
    total = torch.tensor(float(p1.shape[0]), dtype=torch.float32, device=p1.device)
    return (torch.sum((p1 - y) ** 2), torch.sum(torch.abs(p1 - y)), torch.sum(p1),
            torch.sum(p1 * p1), torch.sum(y), total)


def ctr_metric_bundle(input, label, ins_tag_weight=None):  # noqa: A002
    """(auc, sqrerr, abserr, prob, q, pos, total) of the batch; the five
    sums one op "ctr_stats"."""
    a, _ = auc(input, label)
    return (a,) + tuple(_record.apply("ctr_stats", _ctr_stats, input, label))


def normalize_program(program, feed_vars, fetch_vars, **kwargs):
    """paddle.static.normalize_program: the program as it is (the export
    prunes to the fetches through the pass pipeline's DCE)."""
    if not isinstance(program, Program):
        raise TypeError("program must be a Program")
    return program


def serialize_program(feed_vars, fetch_vars, **kwargs) -> bytes:
    """The feed->fetch computation as bytes: a `.pdmodel`'s archive."""
    return _io._export_blob(feed_vars, fetch_vars, kwargs.get("program") or default_main_program())


def deserialize_program(data: bytes):
    """serialize_program's bytes -> the ExportedProgram on the framework
    device; call `.module()(*feeds)`. For an Executor-runnable artifact
    use save/load_inference_model, whose .pdmeta names the feeds."""
    return _io._load_blob(data)


def serialize_persistables(feed_vars, fetch_vars, executor=None, **kwargs) -> bytes:
    """The program's persistables as bytes ({key: numpy array})."""
    return fio.dumps(_io.program_state(kwargs.get("program") or default_main_program()))


def deserialize_persistables(program, data: bytes, executor=None):
    """serialize_persistables' bytes back into the program's tensors."""
    state = fio.loads(data)
    set_program_state(program, state)
    return state


def save_to_file(path, content):
    if not isinstance(content, bytes):
        raise ValueError("content must be bytes")
    with open(path, "wb") as f:
        f.write(content)


def load_from_file(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def load_program_state(model_path, var_list=None) -> dict:
    """A .pdparams state (static.save's, of either package); `var_list`
    keeps the keys it names."""
    state = fio.load(_io._pdparams(model_path))
    if var_list is not None:
        state = {k: v for k, v in state.items() if k in set(var_list)}
    return state


def set_program_state(program, state_dict) -> None:
    """Write a state into the program's persistables by key, in place."""
    _io.set_state(getattr(program, "_program", program), state_dict)


__all__ = ["BuildStrategy", "CompiledProgram", "ExecutionStrategy", "ExponentialMovingAverage",
           "IpuCompiledProgram", "IpuStrategy", "Print", "Variable", "WeightNormParamAttr",
           "accuracy", "auc", "cpu_places", "create_global_var", "ctr_metric_bundle",
           "cuda_places", "device_guard", "gradients", "ipu_shard_guard", "name_scope", "py_func",
           "set_ipu_shard", "xpu_places", "normalize_program", "serialize_program", "deserialize_program",
           "serialize_persistables", "deserialize_persistables", "save_to_file",
           "load_from_file", "load_program_state", "set_program_state"]
