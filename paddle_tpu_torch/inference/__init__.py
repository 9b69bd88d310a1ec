"""paddle.inference (counterpart of paddle_tpu/inference/__init__.py):
the frozen-program Predictor and the LLM serving predictor.

A `.pdmodel` artifact (jit.save or static.save_inference_model: a
torch.export archive with its weights, and a JSON `.pdmeta`) is served
by `Predictor`: `create_predictor(Config(prefix))`, input and output
handles, `run()`. The artifact's kernels are registered ops
(`paddle_tpu_torch.flash_fwd`), so an artifact saved on the CPU runs
the flash kernel B1 once the Predictor has moved it to the card. A
JAX-package `.pdmodel` (StableHLO bytes) raises ArtifactFormatError.

`save_llm(model, prefix)` writes the JAX package's LLM artifact:
`{prefix}.pdllm` (JSON config) and `{prefix}.pdiparams` (pickled numpy
weights in paddle layout), so either package serves the other's files.
`Config(prefix).enable_llm_engine(...)` + `create_predictor(config)` give
an LLMPredictor whose run() greedy-decodes through the paged-KV engine,
or with `llm_replicas > 1` or `qos=` through a ReplicaFleet of engines
over the same weights (inference/fleet.py, inference/qos.py).

Both predictors run on cuda:0 unless `Config.disable_gpu()` asks for the
CPU; without a card they raise rather than run on the CPU. The Config
switches of engines the port has no counterpart of (TensorRT, MKLDNN,
IR optimisation, memory pools) are accepted and recorded, and change
nothing, as in the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..framework import device as _device
from ..framework import dtype as _dtype
from ..framework import io as fio
from ..static import io as _sio
from ..utils.convert import state_from_paddle_tpu, state_to_paddle_tpu
from .engine import InferenceEngine
from .fleet import NoHealthyReplica, ReplicaFleet, ReplicaStatus, fleet_replay
from .qos import BrownoutConfig, QoSConfig, QoSPolicy, TenantConfig
from .scheduler import ContinuousBatchingScheduler, Request, SpecDecodeConfig

__all__ = ["Config", "Tensor", "Predictor", "PredictorPool", "LLMPredictor", "create_predictor",
           "save_llm", "load_llm", "PrecisionType", "PlaceType", "DataType", "XpuConfig",
           "get_version", "get_trt_compile_version", "get_trt_runtime_version",
           "get_num_bytes_of_data_type", "convert_to_mixed_precision", "_get_phi_kernel_name",
           "InferenceEngine", "ContinuousBatchingScheduler",
           "Request", "SpecDecodeConfig", "ReplicaFleet", "ReplicaStatus", "NoHealthyReplica",
           "fleet_replay", "QoSConfig", "QoSPolicy", "TenantConfig", "BrownoutConfig"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class PlaceType:
    CPU = 0
    GPU = 1
    TPU = 1  # the accelerator place, as the JAX package names it
    XPU = 2
    CUSTOM = 9


class Config:
    """paddle.inference.Config: `Config(prefix)` (with or without
    `.pdmodel`), `Config(model_file, params_file)`, or a directory
    holding exactly one `.pdmodel` (or one `.pdllm`)."""

    def __init__(self, model_arg: Optional[str] = None, params_file: Optional[str] = None):
        self._prefix = None
        self._params_file = params_file
        if model_arg is not None:
            if os.path.isdir(model_arg):
                self._prefix = self._prefix_in_dir(model_arg)
            elif model_arg.endswith(".pdmodel"):
                self._prefix = model_arg[: -len(".pdmodel")]
            else:
                self._prefix = model_arg
        self._device = "gpu"
        self._device_id = 0
        self._inert: Dict[str, object] = {}
        self._llm_opts: Dict[str, object] = {}

    @staticmethod
    def _prefix_in_dir(model_dir):
        for ext in (".pdmodel", ".pdllm"):
            cands = [f for f in os.listdir(model_dir) if f.endswith(ext)]
            if len(cands) > 1:
                raise ValueError(
                    f"Config(model_dir): expected exactly one {ext} under {model_dir}, found {cands}")
            if cands:
                return os.path.join(model_dir, cands[0][: -len(ext)])
        raise ValueError(f"Config(model_dir): no .pdmodel or .pdllm under {model_dir}")

    # ---- model paths ----
    def set_model(self, model_arg, params_file=None):
        self.__init__(model_arg, params_file)

    def model_dir(self):
        return os.path.dirname(self._prefix or "")

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or ((self._prefix or "") + ".pdiparams")

    # ---- device selection ----
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._device, self._device_id = "gpu", int(device_id)

    def enable_xpu(self, *args, **kwargs):
        self._device = "gpu"  # the accelerator

    def enable_custom_device(self, device_type, device_id=0):
        self._device, self._device_id = "gpu", int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def gpu_device_id(self):
        return self._device_id

    # ---- switches of engines the port has no counterpart of: recorded ----
    def enable_tensorrt_engine(self, *args, **kwargs):
        self._inert["tensorrt"] = True

    def enable_mkldnn(self):
        self._inert["mkldnn"] = True

    def switch_ir_optim(self, flag=True):
        self._inert["ir_optim"] = flag

    def enable_memory_optim(self, flag=True):
        self._inert["memory_optim"] = flag

    def set_cpu_math_library_num_threads(self, n):
        self._inert["cpu_threads"] = n

    def summary(self) -> str:
        return (f"model: {self.prog_file()}\ndevice: {self._device}:{self._device_id}\n"
                f"inert knobs: {self._inert}")

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def device(self) -> torch.device:
        if self._device == "cpu":
            return torch.device("cpu")
        return _device.resolve(f"cuda:{self._device_id}")

    # ---- serving engine ----
    def enable_llm_engine(self, max_new_tokens=32, eos_id=None, llm_replicas=1, qos=None,
                          **engine_opts):
        """Serve through the paged-KV InferenceEngine; `engine_opts` go to
        it (max_seq_len, block_size, num_blocks, max_batch, kv_dtype, ...).
        `llm_replicas > 1` backs the predictor with a ReplicaFleet of that
        many engines over one weight set. `qos` (a QoSConfig or a QoSPolicy)
        turns on overload protection and tenant fairness; QoS always runs
        through a fleet (of 1 when llm_replicas == 1), so the policy state
        is shared as a multi-replica deployment shares it."""
        self._llm_opts.update(max_new_tokens=max_new_tokens, eos_id=eos_id,
                              llm_replicas=int(llm_replicas), qos=qos, **engine_opts)

    def llm_replicas(self) -> int:
        return int(self._llm_opts.get("llm_replicas", 1))

    def is_llm(self) -> bool:
        return self._prefix is not None and os.path.exists(self._prefix + ".pdllm")


class Tensor:
    """Predictor I/O handle: host-side staging with copy_from_cpu/copy_to_cpu.
    A bfloat16 output comes back as an ml_dtypes.bfloat16 array where
    ml_dtypes is installed (the JAX package's type), else widened to
    float32, which holds every bfloat16 value exactly."""

    def __init__(self, name, dtype=None):
        self._name = name
        self._dtype = dtype
        self._value = None
        self._declared_shape = None

    def name(self):
        return self._name

    def reshape(self, shape):
        self._declared_shape = tuple(shape)

    def copy_from_cpu(self, arr):
        a = np.asarray(arr)
        # numpy has no bfloat16 without ml_dtypes: the Predictor casts on the card
        self._value = a.astype(self._dtype) if self._dtype not in (None, "bfloat16") else a

    def copy_to_cpu(self):
        v = self._value
        if v is None:
            raise RuntimeError(f"output handle '{self._name}' has no data — call run() first")
        if isinstance(v, torch.Tensor):
            if v.dtype == torch.bfloat16 and fio._ml_dtypes() is None:
                return v.float().cpu().numpy()
            return fio.tensor_to_numpy(v)
        return np.asarray(v)

    def shape(self):
        if self._value is not None:
            return list(self._value.shape)
        return list(self._declared_shape or [])


def save_llm(model, prefix: str) -> str:
    """Write `{prefix}.pdllm` + `{prefix}.pdiparams` in the JAX package's
    format (weights in paddle layout)."""
    cfg = getattr(model, "config", None)
    if not isinstance(cfg, dict):
        raise ValueError("save_llm needs a model with a .config dict (LlamaForCausalLM-shaped)")
    d = os.path.dirname(prefix)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(prefix + ".pdllm", "w") as f:
        json.dump({"arch": "LlamaForCausalLM", "config": cfg}, f)
    fio.save(state_to_paddle_tpu(model.state_dict()), prefix + ".pdiparams")
    return prefix


def load_llm(prefix: str, device=None):
    """Rebuild the model save_llm wrote, on `device` (default: the
    framework device), in the saved weights' dtype, in eval mode."""
    from ..models.llama import LlamaForCausalLM

    with open(prefix + ".pdllm") as f:
        meta = json.load(f)
    if meta.get("arch") != "LlamaForCausalLM":
        raise ValueError(f"unknown LLM artifact arch {meta.get('arch')!r}")
    dev = _device.resolve(device)
    state = state_from_paddle_tpu(fio.load(prefix + ".pdiparams", return_numpy=True))
    dtype = next(t.dtype for t in state.values() if t.is_floating_point())
    model = LlamaForCausalLM(**meta["config"], device="meta", dtype=dtype)
    model.load_state_dict({k: v.to(dev) for k, v in state.items()}, assign=True)
    return model.eval()


class LLMPredictor:
    """run() greedy-decodes "input_ids" [B, S] (rows right-padded; true
    lengths in the optional "seq_lens" [B]) into "generated_ids"
    [B, max_new_tokens] int32, right-padded with -1 after EOS."""

    def __init__(self, config: Config):
        if config._prefix is None:
            raise ValueError("Config has no model path")
        self._config = config
        self._model = load_llm(config._prefix, device=config.device())
        opts = dict(config._llm_opts)
        self._max_new_tokens = int(opts.pop("max_new_tokens", 32))
        self._eos_id = opts.pop("eos_id", None)
        n_replicas = max(1, int(opts.pop("llm_replicas", 1)))
        qos = opts.pop("qos", None)
        # N engines over the SAME model: each holds references to its
        # tensors until a hot swap rebinds that engine's set
        engines = [InferenceEngine(self._model, **opts) for _ in range(n_replicas)]
        self._engine = engines[0]
        if qos is not None and not isinstance(qos, QoSPolicy):
            qos = QoSPolicy(qos)  # one policy shared by every replica
        self._qos = qos
        self._fleet = (ReplicaFleet(engines, eos_id=self._eos_id, qos=qos)
                       if n_replicas > 1 or qos is not None else None)
        self._inputs = {"input_ids": Tensor("input_ids", np.int64),
                        "seq_lens": Tensor("seq_lens", np.int64)}
        self._outputs = {"generated_ids": Tensor("generated_ids")}

    def qos(self):
        """The shared QoSPolicy (None when QoS is off)."""
        return self._qos

    def fleet(self):
        """The backing ReplicaFleet (None for a single-replica predictor
        without QoS): request_swap() and health inspection."""
        return self._fleet

    def get_input_names(self):
        return list(self._inputs)

    def get_output_names(self):
        return list(self._outputs)

    def get_input_handle(self, name):
        return self._inputs[name]

    def get_output_handle(self, name):
        return self._outputs[name]

    def run(self, inputs: Optional[list] = None):
        if inputs is not None:
            for n, a in zip(self.get_input_names(), inputs):
                self._inputs[n].copy_from_cpu(a)
        ids = self._inputs["input_ids"]._value
        if ids is None:
            raise RuntimeError("input 'input_ids' not set — copy_from_cpu it first")
        ids = np.asarray(ids)
        if ids.ndim == 1:
            ids = ids[None]
        lens = self._inputs["seq_lens"]._value
        if lens is None:
            lens = np.full((ids.shape[0],), ids.shape[1], np.int64)
        lens = np.asarray(lens).reshape(-1)
        if lens.shape[0] != ids.shape[0]:
            raise ValueError(
                f"seq_lens has {lens.shape[0]} entries for {ids.shape[0]} input_ids rows — "
                "re-copy seq_lens (a stale handle would silently truncate the batch)")
        prompts = [list(map(int, row[: int(n)])) for row, n in zip(ids, lens)]
        if self._fleet is not None:
            gen = self._fleet.generate(prompts, max_new_tokens=self._max_new_tokens)
        else:
            gen = self._engine.generate(prompts, max_new_tokens=self._max_new_tokens,
                                        eos_id=self._eos_id)
        out = np.full((len(gen), self._max_new_tokens), -1, np.int32)
        for i, g in enumerate(gen):
            out[i, : len(g)] = g
        self._outputs["generated_ids"]._value = out
        return [out] if inputs is not None else None


class Predictor:
    """paddle_infer.Predictor over a frozen program (`.pdmodel` + `.pdmeta`
    of jit.save or static.save_inference_model). The program runs on
    `Config.device()`: an artifact saved on another device is moved there
    (its weights and its graph's device literals). A clone shares the
    loaded program and has handles of its own."""

    def __init__(self, config: Config):
        if config._prefix is None:
            raise ValueError("Config has no model path")
        self._config = config
        self._device = config.device()
        ep, meta = _sio.read_artifact(config.prog_file(), config._prefix, self._device)
        self._init(ep.module(), meta)

    def _init(self, module, meta):
        self._module = module
        self._meta = meta
        # static artifacts name their feeds; jit.save's are positional
        names = meta.get("feed_names")
        if names is None:
            names = [f"input_{i}" for i in range(len(meta.get("in_dtypes", [])))]
        self._input_names = list(names)
        n_out = meta.get("n_fetch", meta.get("n_outputs", 1))
        self._output_names = [f"output_{i}" for i in range(n_out)]
        dtypes = meta.get("in_dtypes")
        self._inputs = {n: Tensor(n, dtypes[i] if dtypes else None)
                        for i, n in enumerate(self._input_names)}
        self._outputs = {n: Tensor(n) for n in self._output_names}

    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_output_names(self) -> List[str]:
        return list(self._output_names)

    def get_input_handle(self, name) -> Tensor:
        return self._inputs[name]

    def get_output_handle(self, name) -> Tensor:
        return self._outputs[name]

    def run(self, inputs: Optional[list] = None):
        """Run the program on the handles' inputs (or on `inputs`, in
        input-name order, returning the outputs as numpy arrays)."""
        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._inputs[n].copy_from_cpu(a)
        args = []
        for n in self._input_names:
            h = self._inputs[n]
            if h._value is None:
                raise RuntimeError(f"input '{n}' not set — copy_from_cpu it first")
            t = fio.numpy_to_tensor(h._value)
            args.append(t.to(self._device, _dtype.convert_dtype(h._dtype) if h._dtype else None))
        with torch.no_grad():  # a frozen program: no autograd graph, no saved activations
            outs = pytree.tree_leaves(self._module(*args))
        for n, o in zip(self._output_names, outs):
            self._outputs[n]._value = o
        if inputs is not None:
            return [self._outputs[n].copy_to_cpu() for n in self._output_names]
        return None

    def clone(self) -> "Predictor":
        c = Predictor.__new__(Predictor)
        c._config, c._device = self._config, self._device
        c._init(self._module, self._meta)
        return c

    def clear_intermediate_tensor(self):
        return None

    def try_shrink_memory(self):
        return None


def create_predictor(config: Config):
    """paddle.inference.create_predictor: a save_llm artifact (`.pdllm`)
    gets the engine-backed LLMPredictor, a frozen program (`.pdmodel`) the
    Predictor."""
    if config.is_llm():
        return LLMPredictor(config)
    return Predictor(config)


class PredictorPool:
    """`size` predictors over one Config: the first loads the program, the
    rest are its clones (one program, handles of their own)."""

    def __init__(self, config: Config, size: int = 1):
        if size < 1:
            raise ValueError("PredictorPool size must be >= 1")
        main = Predictor(config)
        self._preds = [main] + [main.clone() for _ in range(size - 1)]

    def retrieve(self, idx: int) -> Predictor:
        return self._preds[idx]


class DataType:
    """paddle_infer.DataType (paddle_tensor.h PaddleDType)."""

    FLOAT64 = -1  # not in the C enum; get_num_bytes_of_data_type takes it
    FLOAT32 = 0
    INT64 = 1
    INT32 = 2
    UINT8 = 3
    INT8 = 4
    FLOAT16 = 5
    BFLOAT16 = 6
    BOOL = 7


_DATA_TYPE_BYTES = {DataType.FLOAT64: 8, DataType.FLOAT32: 4, DataType.INT64: 8,
                    DataType.INT32: 4, DataType.UINT8: 1, DataType.INT8: 1,
                    DataType.FLOAT16: 2, DataType.BFLOAT16: 2, DataType.BOOL: 1}


def get_num_bytes_of_data_type(dtype) -> int:
    if dtype not in _DATA_TYPE_BYTES:
        raise ValueError(f"unknown inference DataType: {dtype}")
    return _DATA_TYPE_BYTES[dtype]


def get_version() -> str:
    """The version banner: the JAX package's version number (paddle.version
    is not ported yet) and the torch build the port runs on."""
    return f"version: 0.1.0\ncommit: torch {torch.__version__}\n"


def get_trt_compile_version():
    """The port links no TensorRT: (0, 0, 0), as the JAX package."""
    return (0, 0, 0)


def get_trt_runtime_version():
    return (0, 0, 0)


def _get_phi_kernel_name(op_name: str) -> str:
    """A legacy fluid op name -> its phi kernel name (the op name itself
    but for the renamed legacy ops)."""
    legacy = {
        "matmul_v2": "matmul", "elementwise_add": "add", "elementwise_sub": "subtract",
        "elementwise_mul": "multiply", "elementwise_div": "divide", "reduce_sum": "sum",
        "reduce_mean": "mean", "fill_constant": "full",
    }
    return legacy.get(op_name, op_name)


class XpuConfig:
    """paddle.inference.XpuConfig: its settings are recorded, and change
    nothing."""

    def __init__(self, **kwargs):
        self.device_id = kwargs.pop("device_id", 0)
        self.l3_size = kwargs.pop("l3_size", 0)
        self.l3_autotune_size = kwargs.pop("l3_autotune_size", 0)
        for k, v in kwargs.items():
            setattr(self, k, v)


def convert_to_mixed_precision(model_file: str, params_file: str, mixed_model_file: str,
                               mixed_params_file: str, mixed_precision=PrecisionType.Half,
                               backend=None, keep_io_types: bool = True, black_list=None,
                               **kwargs):
    """paddle.inference.convert_to_mixed_precision: the separate parameter
    file (.pdiparams) is cast to float16 or bfloat16 (f32 entries outside
    `black_list`); the program is copied as it is, so the weights inside
    it keep their precision (a UserWarning says so), and its .pdmeta
    records the precision."""
    import shutil
    import warnings

    target = {PrecisionType.Half: torch.float16,
              PrecisionType.Bfloat16: torch.bfloat16}.get(mixed_precision)
    if target is None:
        raise ValueError("mixed_precision must be PrecisionType.Half or Bfloat16")
    black = set(black_list or ())
    warnings.warn(
        "convert_to_mixed_precision converts only the SEPARATE parameter payload "
        f"({params_file!r}); the program blob is copied as-is, so any weights baked into the "
        "program as constants keep their exported precision and see no size/precision change",
        UserWarning, stacklevel=2)
    shutil.copyfile(model_file, mixed_model_file)
    src_meta = os.path.splitext(model_file)[0] + ".pdmeta"
    dst_meta = os.path.splitext(mixed_model_file)[0] + ".pdmeta"
    if os.path.exists(src_meta):
        meta = _sio.read_meta(os.path.splitext(model_file)[0])
        meta["mixed_precision"] = int(mixed_precision)
        with open(dst_meta, "w") as f:
            json.dump(meta, f)

    def cast(name, t):
        return t if name in black or t.dtype != torch.float32 else t.to(target)

    from ..jit.save_load import load_state

    fio.save({k: cast(k, v) for k, v in load_state(params_file).items()}, mixed_params_file)
