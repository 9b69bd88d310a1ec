"""paddle.static (counterpart of paddle_tpu/static/__init__.py): Program
capture under program_guard, the Executor, append_backward and static
minimize, InputSpec, the analyses (analysis/), the pass pipeline
(passes/), save/load_inference_model and save/load (io.py), and the
serialization names of extras.py. See program.py and executor.py for
the design.

Names whose modules wait for a later slice (ROADMAP Queue A item 3)
raise NotImplementedError when called: static.nn's builders
(static/nn.py) and the rest of static/extras.py.
"""
from ..ops.creation import create_parameter  # noqa: F401
from . import analysis, nn, passes  # noqa: F401
from .analysis import (  # noqa: F401
    Diagnostic,
    ProgramVerifyError,
    dead_op_elimination,
    describe_program,
    verify,
)
from .executor import Executor, append_backward, global_scope, scope_guard  # noqa: F401
from .extras import (  # noqa: F401
    deserialize_persistables,
    deserialize_program,
    load_from_file,
    load_program_state,
    normalize_program,
    save_to_file,
    serialize_persistables,
    serialize_program,
    set_program_state,
)
from .io import load, load_inference_model, save, save_inference_model  # noqa: F401
from .nn import not_ported as _not_ported
from .program import (  # noqa: F401
    Program,
    data,
    default_main_program,
    default_startup_program,
    program_guard,
)

_EXTRAS = (
    "BuildStrategy", "CompiledProgram", "ExecutionStrategy", "ExponentialMovingAverage",
    "IpuCompiledProgram", "IpuStrategy", "Print", "Variable", "WeightNormParamAttr", "accuracy",
    "auc", "cpu_places", "create_global_var", "ctr_metric_bundle", "cuda_places",
    "device_guard", "gradients", "ipu_shard_guard", "name_scope", "py_func", "set_ipu_shard",
    "xpu_places",
)
for _n in _EXTRAS:
    globals()[_n] = _not_ported(_n, "static/extras.py", "3.5")
cond = _not_ported("cond", "static/nn.py's control flow")


class InputSpec:
    """paddle.static.InputSpec (shape/dtype/name triple)."""

    def __init__(self, shape=None, dtype="float32", name=None, stop_gradient=True):
        self.shape = list(shape) if shape is not None else None
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype, name)

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"
