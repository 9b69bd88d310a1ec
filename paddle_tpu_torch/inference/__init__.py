"""Deployment surface for LLM serving (counterpart of the LLM half of
paddle_tpu/inference/__init__.py).

`save_llm(model, prefix)` writes the JAX package's artifact:
`{prefix}.pdllm` (JSON config) and `{prefix}.pdiparams` (pickled numpy
weights in paddle layout), so either package serves the other's files.
`Config(prefix).enable_llm_engine(...)` + `create_predictor(config)` give
an LLMPredictor whose run() greedy-decodes through the paged-KV engine,
or with `llm_replicas > 1` or `qos=` through a ReplicaFleet of engines
over the same weights (inference/fleet.py, inference/qos.py). The
predictor runs on cuda:0 unless `Config.disable_gpu()` asks for the CPU.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from ..framework import device as _device
from ..framework import io as fio
from ..utils.convert import state_from_paddle_tpu, state_to_paddle_tpu
from .engine import InferenceEngine
from .fleet import NoHealthyReplica, ReplicaFleet, ReplicaStatus, fleet_replay
from .qos import BrownoutConfig, QoSConfig, QoSPolicy, TenantConfig
from .scheduler import ContinuousBatchingScheduler, Request, SpecDecodeConfig

__all__ = ["Config", "Tensor", "LLMPredictor", "create_predictor", "save_llm", "load_llm",
           "PrecisionType", "InferenceEngine", "ContinuousBatchingScheduler",
           "Request", "SpecDecodeConfig", "ReplicaFleet", "ReplicaStatus", "NoHealthyReplica",
           "fleet_replay", "QoSConfig", "QoSPolicy", "TenantConfig", "BrownoutConfig"]


class PrecisionType:
    Float32 = 0
    Half = 1
    Bfloat16 = 2
    Int8 = 3


class Config:
    """paddle.inference.Config for a save_llm artifact: `Config(prefix)`,
    or a directory holding exactly one `.pdllm`."""

    def __init__(self, model_arg: Optional[str] = None):
        self._prefix = None
        if model_arg is not None:
            if os.path.isdir(model_arg):
                cands = [f for f in os.listdir(model_arg) if f.endswith(".pdllm")]
                if len(cands) != 1:
                    raise ValueError(
                        f"Config(model_dir): expected exactly one .pdllm under {model_arg}, found {cands}")
                self._prefix = os.path.join(model_arg, cands[0][: -len(".pdllm")])
            else:
                self._prefix = model_arg
        self._device = "gpu"
        self._device_id = 0
        self._llm_opts: Dict[str, object] = {}

    # ---- device selection ----
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0,
                       precision=PrecisionType.Float32):
        self._device, self._device_id = "gpu", int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

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
    """Predictor I/O handle: host-side staging with copy_from_cpu/copy_to_cpu."""

    def __init__(self, name, dtype=None):
        self._name = name
        self._dtype = dtype
        self._value = None

    def name(self):
        return self._name

    def copy_from_cpu(self, arr):
        a = np.asarray(arr)
        self._value = a.astype(self._dtype) if self._dtype is not None else a

    def copy_to_cpu(self):
        if self._value is None:
            raise RuntimeError(f"output handle '{self._name}' has no data — call run() first")
        return np.asarray(self._value)

    def shape(self):
        return [] if self._value is None else list(np.asarray(self._value).shape)


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


def create_predictor(config: Config) -> LLMPredictor:
    """A Config pointing at a save_llm artifact gets the engine-backed
    LLMPredictor. Frozen-program artifacts (.pdmodel) are not served by
    this slice."""
    if not config.is_llm():
        raise NotImplementedError(
            "create_predictor serves save_llm artifacts (.pdllm); frozen .pdmodel programs "
            "are not ported yet")
    return LLMPredictor(config)
