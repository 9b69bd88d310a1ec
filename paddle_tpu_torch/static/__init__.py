"""paddle.static (counterpart of paddle_tpu/static/__init__.py): Program
capture under program_guard, the Executor, append_backward and static
minimize, InputSpec, the analyses (analysis/), the pass pipeline
(passes/), save/load_inference_model and save/load (io.py), the layer
builders (nn.py), and the strategies, metrics, EMA, gradients and
serialization names of extras.py. See program.py and executor.py for
the design.
"""
from ..jit.api import cond  # noqa: F401
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
    BuildStrategy,
    CompiledProgram,
    ExecutionStrategy,
    ExponentialMovingAverage,
    IpuCompiledProgram,
    IpuStrategy,
    Print,
    Variable,
    WeightNormParamAttr,
    accuracy,
    auc,
    cpu_places,
    create_global_var,
    ctr_metric_bundle,
    cuda_places,
    deserialize_persistables,
    deserialize_program,
    device_guard,
    gradients,
    ipu_shard_guard,
    load_from_file,
    load_program_state,
    name_scope,
    normalize_program,
    py_func,
    save_to_file,
    serialize_persistables,
    serialize_program,
    set_ipu_shard,
    set_program_state,
    xpu_places,
)
from .io import load, load_inference_model, save, save_inference_model  # noqa: F401
from .program import (  # noqa: F401
    Program,
    data,
    default_main_program,
    default_startup_program,
    program_guard,
)

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
