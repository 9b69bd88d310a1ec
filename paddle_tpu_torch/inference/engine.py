"""Greedy-decode inference engine over the paged KV cache (counterpart of
paddle_tpu/inference/engine.py).

One engine owns its parameter set, a BlockPool on the model's device, and
the shape-bucket arithmetic: prompts are padded into (1, seq_bucket) prefill
steps and in-flight sequences into (batch_bucket, 1) decode steps, with
the JAX package's bucket sets. Steps run eagerly under
`torch.inference_mode()`: the JAX package's AOT-compiled bucket programs
have no counterpart, so the engine records no compile events of its own;
the kernel libraries its first step builds or restores record theirs
(ops/kernels/build.py). It leaves the compile ledger's cold-start marks:
`engine_load_start` and an `engine_init` span from the constructor, a
`prewarm` span, and `first_token` when the first logits (outside prewarm)
reach the host, which `python -m paddle_tpu_torch.compile_cache report`
decomposes. Mesh/TP placement and checkpoint swaps arrive with the
distributed runtime.

Parameters: the engine holds references to the model's tensors at
construction (`self.params`, as the JAX engine holds the model's arrays)
and every step runs the model on that set. `load_weights` builds new
tensors and rebinds this engine's set only: the engine then steps a copy
of the model's module tree over the new tensors (the model's buffers
shared, no weight copied), so the model object and every other engine
over it keep theirs, and N engines over one model cost one weight set
until a rollout, two during it.

Padding contract: prefill pads the prompt on the right (causal masking
keeps real tokens from seeing the pad tail; its K/V writes land past
seq_len and are overwritten before the sequence grows into them). Decode
pads the batch with inactive rows whose block table is all trash page and
whose seq_len is 1; their results are discarded.
"""
from __future__ import annotations

import copy
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import telemetry
from ..telemetry import metrics as _metrics
from .kv_cache import BlockPool

__all__ = ["InferenceEngine"]


def _default_prefill_buckets(max_seq_len: int, block_size: int) -> Tuple[int, ...]:
    out, b = [], max(16, block_size)
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return tuple(sorted(set(out)))


def _default_batch_buckets(max_batch: int) -> Tuple[int, ...]:
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(sorted(set(out)))


def _rebind(model: nn.Module, tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """A copy of `model`'s module tree whose parameters are `tensors` (by
    name) and whose buffers are the model's own: no weight is copied and
    the model is not touched."""
    memo = {id(b): b for b in model.buffers()}
    for name, p in model.named_parameters(remove_duplicate=False):
        memo[id(p)] = nn.Parameter(tensors[name], requires_grad=False)
    return copy.deepcopy(model, memo)


class InferenceEngine:
    """`model` is LlamaForCausalLM-shaped: a `.config` dict and a
    `forward(ids, cache=, positions=, last_index=)` decode mode."""

    def __init__(self, model, *, max_seq_len: int = 512, block_size: int = 16,
                 num_blocks: Optional[int] = None, max_batch: int = 8,
                 decode_batch_buckets: Optional[Sequence[int]] = None,
                 kv_dtype: Optional[str] = None):
        t_init = time.monotonic()
        cfg = dict(getattr(model, "config", {}))
        if not cfg:
            raise ValueError("InferenceEngine needs a model with a .config dict "
                             "(LlamaForCausalLM-shaped)")
        self._model = model
        self._module = model  # what the steps run: the model, or a copy over swapped weights
        self.num_layers = int(cfg["num_hidden_layers"])
        heads = int(cfg["num_attention_heads"])
        self.num_kv_heads = int(cfg.get("num_key_value_heads") or heads)
        self.head_dim = int(cfg["hidden_size"]) // heads
        self.vocab_size = int(cfg["vocab_size"])
        self.max_seq_len = int(max_seq_len)
        self.block_size = int(block_size)
        self.max_pages = math.ceil(self.max_seq_len / self.block_size)
        self.max_batch = int(max_batch)
        self.prefill_buckets = _default_prefill_buckets(self.max_seq_len, self.block_size)
        self.decode_batch_buckets = tuple(
            decode_batch_buckets or _default_batch_buckets(self.max_batch))
        # this engine's parameter set: references to the model's tensors
        # until load_weights rebinds it (never written in place)
        self.params: Dict[str, torch.Tensor] = dict(model.state_dict(keep_vars=True))
        param = next(model.parameters())
        self.device = param.device
        if num_blocks is None:
            # worst case: every decode slot at full context, plus the trash page
            num_blocks = 1 + self.max_batch * self.max_pages
        self.pool = BlockPool(num_blocks, self.block_size, self.num_layers, self.num_kv_heads,
                              self.head_dim, dtype=param.dtype, kv_dtype=kv_dtype,
                              device=self.device)
        # steps run per kind: each prefill launches the flash kernel once per
        # layer, each decode/extend the paged kernel once per layer
        self.step_counts: Dict[str, int] = {"prefill": 0, "decode": 0, "extend": 0}
        # bumped by every load_weights(); the fleet exports it per replica
        # so a half-finished rollout is visible in telemetry
        self.weights_version = 0
        self._first_token_marked = False
        self._prewarming = False
        if telemetry.enabled():
            from ..compile_cache import ledger as _ledger

            _ledger.mark("engine_load_start", t_init)
            _ledger.span("engine_init", t_init, time.monotonic())

    # ---- weight hot swap ----
    def load_weights(self, state) -> int:
        """Swap in a full replacement parameter set: `state` maps every
        param name (exactly the engine's key set) to a tensor or array of
        the same shape; the dtype is cast to the current param's. New
        tensors on the engine's device rebind THIS engine's set: the model
        and other engines over it are untouched (a tensor already on the
        device in that dtype is taken by reference, so engines swapped from
        one mapping share it). Resident prefix-cache K/V was computed under
        the old weights, so the prefix index is dropped. Returns the new
        weights_version."""
        missing, extra = set(self.params) - set(state), set(state) - set(self.params)
        if missing or extra:
            raise ValueError(
                f"load_weights: state keys do not match the engine's params "
                f"(missing {sorted(missing)[:3]}, unexpected {sorted(extra)[:3]})")
        vals = {k: torch.as_tensor(state[k]) for k in self.params}
        for k, cur in self.params.items():
            if tuple(vals[k].shape) != tuple(cur.shape):
                raise ValueError(
                    f"load_weights: {k!r} shape {tuple(vals[k].shape)} != engine's "
                    f"{tuple(cur.shape)} — a hot swap cannot change the model")
        with torch.no_grad():
            new = {k: vals[k].detach().to(device=cur.device, dtype=cur.dtype)
                   for k, cur in self.params.items()}
        self._module = _rebind(self._model, new)
        self.params = dict(self._module.state_dict(keep_vars=True))
        self.weights_version += 1
        self.pool.invalidate_prefix()
        if telemetry.enabled():
            _metrics.counter(
                "paddle_tpu_serving_weight_swaps_total",
                "engine parameter sets hot-swapped",
            ).inc()
        return self.weights_version

    def checkpoint_template(self, state_key: Optional[str] = "model"):
        raise NotImplementedError(
            "checkpoint_template needs distributed.checkpoint, which arrives with the "
            "distributed runtime (ROADMAP Queue A item 5); pass load_weights a mapping")

    def load_weights_from_checkpoint(self, path: str, state_key: Optional[str] = "model") -> int:
        raise NotImplementedError(
            "load_weights_from_checkpoint needs distributed.checkpoint, which arrives with "
            "the distributed runtime (ROADMAP Queue A item 5); pass load_weights a mapping")

    def prewarm(self, *, include_prefill: bool = True, include_decode: bool = True,
                extend_q: Sequence[int] = ()) -> dict:
        """Run every bucket once before traffic (cuBLAS handles, kernel
        loads), so the first request pays none of it. The steps write only
        the trash page. `include_prefill=False` warms a decode-tier engine
        (streamed admission never runs a bucketed prefill); `extend_q` adds
        the extend family for those query lengths. The steps are counted in
        step_counts like any other; their logits are not the first token.
        Returns a copy of step_counts."""
        t0 = time.monotonic()
        self._prewarming = True
        try:
            if include_prefill:
                for S in self.prefill_buckets:
                    self.prefill([1] * S, [])
            for B in self.decode_batch_buckets if include_decode else ():
                self.decode([1] * B, [0] * B, [1] * B, [[]] * B)
            for q in extend_q:
                for B in self.decode_batch_buckets:
                    self.extend([[1] * int(q)] * B, [list(range(int(q)))] * B, [[]] * B,
                                q_len=int(q))
        finally:
            self._prewarming = False
        if telemetry.enabled():
            from ..compile_cache import ledger as _ledger

            _ledger.span("prewarm", t0, time.monotonic())
        return dict(self.step_counts)

    # ---- buckets ----
    def bucket_for(self, kind: str, n: int) -> int:
        buckets = self.prefill_buckets if kind == "prefill" else self.decode_batch_buckets
        for b in buckets:
            if n <= b:
                return b
        raise ValueError(f"{kind} size {n} exceeds the largest bucket {buckets[-1]}")

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _logits(self, t: torch.Tensor) -> np.ndarray:
        out = t.float().cpu().numpy()
        if not (self._first_token_marked or self._prewarming):
            self._first_token_marked = True
            if telemetry.enabled():
                from ..compile_cache import ledger as _ledger

                _ledger.mark("first_token")
        return out

    # ---- steps ----
    @torch.inference_mode()
    def prefill(self, prompt_ids: Sequence[int], pages: Sequence[int]) -> np.ndarray:
        """One prompt through a prefill bucket, its K/V written into
        `pages`; returns the last position's logits [V]."""
        L = len(prompt_ids)
        if L < 1 or L > self.max_seq_len:
            raise ValueError(f"prompt length {L} outside [1, {self.max_seq_len}]")
        S = self.bucket_for("prefill", L)
        ids = np.zeros((1, S), np.int64)
        ids[0, :L] = np.asarray(prompt_ids, np.int64)
        bt = np.asarray([self.pool.padded_table(pages, self.max_pages)], np.int32)
        view = self.pool.view(self._tensor(bt), self._tensor(np.asarray([L], np.int32)))
        logits = self._module(self._tensor(ids), cache=view,
                               last_index=self._tensor(np.asarray([L - 1], np.int64)))
        self.step_counts["prefill"] += 1
        return self._logits(logits[0])

    @torch.inference_mode()
    def decode(self, tokens: Sequence[int], positions: Sequence[int], seq_lens: Sequence[int],
               page_rows: Sequence[Sequence[int]]) -> np.ndarray:
        """One decode step for `n` sequences (token i at position
        positions[i], context length seq_lens[i] after it); logits [n, V]."""
        n = len(tokens)
        if n < 1:
            raise ValueError("decode needs at least one sequence")
        B = self.bucket_for("decode", n)
        tok = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int32)
        lens = np.ones((B,), np.int32)  # inactive rows read 1 trash slot
        bt = np.zeros((B, self.max_pages), np.int32)
        tok[:n, 0] = np.asarray(tokens, np.int64)
        pos[:n] = np.asarray(positions, np.int32)
        lens[:n] = np.asarray(seq_lens, np.int32)
        for i, row in enumerate(page_rows):
            bt[i] = self.pool.padded_table(row, self.max_pages)
        view = self.pool.view(self._tensor(bt), self._tensor(lens))
        logits = self._module(self._tensor(tok), cache=view, positions=self._tensor(pos))
        self.step_counts["decode"] += 1
        return self._logits(logits[:n, 0])

    @torch.inference_mode()
    def extend(self, token_rows: Sequence[Sequence[int]], position_rows: Sequence[Sequence[int]],
               page_rows: Sequence[Sequence[int]], q_len: int) -> np.ndarray:
        """One extend/verify step: row i consumes len(token_rows[i]) <=
        q_len tokens at position_rows[i] and gets logits for each —
        [n, q_len, V] (pad slots hold garbage)."""
        n = len(token_rows)
        if n < 1:
            raise ValueError("extend needs at least one sequence")
        B = self.bucket_for("decode", n)
        tok = np.zeros((B, q_len), np.int64)
        pos = np.zeros((B, q_len), np.int32)
        valid = np.zeros((B, q_len), bool)
        bt = np.zeros((B, self.max_pages), np.int32)
        for i, (toks, poss) in enumerate(zip(token_rows, position_rows)):
            r = len(toks)
            if r < 1 or r > q_len:
                raise ValueError(f"extend row {i}: {r} tokens outside [1, {q_len}]")
            if len(poss) != r:
                raise ValueError(f"extend row {i}: positions/tokens length mismatch")
            tok[i, :r] = np.asarray(toks, np.int64)
            pos[i, :r] = np.asarray(poss, np.int32)
            valid[i, :r] = True
        for i, row in enumerate(page_rows):
            bt[i] = self.pool.padded_table(row, self.max_pages)
        view = self.pool.view(self._tensor(bt), self._tensor(pos[:, -1] + 1),
                              write_mask=self._tensor(valid))
        logits = self._module(self._tensor(tok), cache=view, positions=self._tensor(pos))
        self.step_counts["extend"] += 1
        return self._logits(logits[:n])

    # ---- batch greedy generation through the scheduler ----
    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens=16,
                 eos_id: Optional[int] = None) -> List[List[int]]:
        """Greedy-decode every prompt (continuous batching); returns the
        generated ids per prompt."""
        from .scheduler import ContinuousBatchingScheduler, Request

        if isinstance(max_new_tokens, int):
            max_new_tokens = [max_new_tokens] * len(prompts)
        sched = ContinuousBatchingScheduler(self, eos_id=eos_id)
        reqs = [Request(rid=i, prompt=list(p), max_new_tokens=int(m))
                for i, (p, m) in enumerate(zip(prompts, max_new_tokens))]
        for r in reqs:
            sched.submit(r)
        while not sched.idle():
            sched.step()
        # a preempted request folds its generated prefix into the prompt
        # (recompute-on-resume): return the whole generation
        return [r.prompt[r.prompt_len:] + list(r.generated) for r in reqs]
