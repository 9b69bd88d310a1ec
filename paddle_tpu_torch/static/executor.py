"""Static-graph Executor: the recorded Program replayed on the card
(counterpart of paddle_tpu/static/executor.py).

The JAX package replays the instruction list inside one `jax.jit`. Here
`Executor.run` replays it eagerly, op by op, on the device of the
program's tensors: each recorded fn is the op the capture called, so a
paddle op replays through its own dispatch (the flash kernel B1 for
attention, B2/B3 in its backward, B6 for `fused_rms_norm`). The cache
key is the JAX package's: feeds, fetches, structure by `_op_serial`, and
FLAGS_program_passes. A cache entry is the pass-rewritten clone and the
bookkeeping of its replay, not a compiled executable. Gradients
(append_backward) come from `torch.autograd.grad` over the replayed ops,
one pass per request; optimizer updates run after them and write the
parameters (the model's own tensors) and accumulators back in place.

The compile ledger sees a signature's first run (verify + the pass
pipeline) as a `miss` of origin `static_executor` with its seconds, and
that run's FLOPs, counted over the replay (profiler.perf_attribution
`counting_flops`: torch's matmul-class ops and the flash kernels' own
counts), as a `record_compiled`; later runs are `hit`s. A cache entry is a
rewritten clone of closures, nothing a process could restore, so the
Executor persists nothing and records no `restore` or `persist` even with
PADDLE_TPU_COMPILE_CACHE_DIR set (the store holds the kernel libraries,
ops/kernels/build.py). With FLAGS_check_nan_inf on, the state a run writes
back (the updated parameters and the optimizer accumulators) goes through
the training guardian's check (framework/guardian.check_compiled_state),
which raises GuardianAnomaly naming `static_executor`.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..framework.io import numpy_to_tensor, tensor_to_numpy
from .program import Program, default_main_program

Tensor = torch.Tensor


class _OptUpdate:
    """One parameter's update: (new_param, *new_accums) =
    update_fn(param, grad, lr, *accums). `clip` (shared per minimize call)
    applies global-norm scaling across the group before updates; `wd` is
    the coupled L2 decay folded into the gradient (decoupled decay lives
    inside the update fn, see optimizer_hooks)."""

    __slots__ = ("param_var", "grad_var", "update_fn", "accum_tensors", "lr", "clip", "wd")

    def __init__(self, param_var, grad_var, update_fn, accum_tensors, lr, clip=None, wd=0.0):
        self.param_var = param_var
        self.grad_var = grad_var
        self.update_fn = update_fn
        self.accum_tensors = accum_tensors  # persistable state (momentum etc.)
        self.lr = lr
        self.clip = clip
        self.wd = wd


class _FusedAdamWUpdate:
    """Grouped one-pass update (FLAGS_fused_optimizer): every parameter of
    one minimize() call with the same storage dtype updates through a
    single `ops.fused_optimizer.fused_adamw_apply` (the CUDA kernel B5)
    over a flat bucket. The moments live flat in `accum_tensors`
    ([m_flat, v_flat, t]); the params are gathered into a flat buffer and
    scattered back around the kernel."""

    __slots__ = ("param_vars", "grad_vars", "index", "n_pad", "accum_tensors",
                 "lr", "clip", "beta1", "beta2", "eps", "wd", "decoupled")

    def __init__(self, param_vars, grad_vars, index, n_pad, accum_tensors, lr,
                 clip, beta1, beta2, eps, wd, decoupled):
        self.param_vars = list(param_vars)
        self.grad_vars = list(grad_vars)
        self.index = index  # param_var -> (offset, size, shape)
        self.n_pad = n_pad
        self.accum_tensors = accum_tensors
        self.lr = lr
        self.clip = clip
        self.beta1, self.beta2, self.eps = beta1, beta2, eps
        # decay (coupled for Adam, decoupled for AdamW) runs in the kernel;
        # the replay's per-update wd fold never fires for fused updates
        self.wd = wd
        self.decoupled = decoupled

    # the structure key and write-back treat param_var/grad_var uniformly
    @property
    def param_var(self):
        return tuple(self.param_vars)

    @property
    def grad_var(self):
        return tuple(self.grad_vars)


def append_backward(loss: Tensor, parameter_list=None, no_grad_set=None):
    """paddle.static.append_backward: registers grad computation for every
    trainable parameter the program read; returns [(param, grad
    placeholder)] — the placeholders are fetch targets (meta tensors:
    shape and dtype, no storage)."""
    prog = default_main_program()
    loss_var = prog._id2var.get(id(loss))
    if loss_var is None:
        raise ValueError("loss is not an output of the current default_main_program")
    if parameter_list is None:
        params = [
            prog._var_tensors[v]
            for v in prog.param_vars
            if isinstance(prog._var_tensors.get(v), torch.nn.Parameter)
            and prog._var_tensors[v].requires_grad
        ]
    else:
        params = list(parameter_list)
    pairs = []
    param_vars, grad_vars = [], []
    for p in params:
        pv = prog.var_of(p)
        g = torch.empty(p.shape, dtype=p.dtype, device="meta")
        gv = prog._new_var(g, (prog.var_name(pv) or f"v{pv}") + "@GRAD")
        param_vars.append(pv)
        grad_vars.append(gv)
        pairs.append((p, g))
    prog.grad_requests.append((loss_var, param_vars, grad_vars))
    prog._compiled.clear()
    return pairs


class _Compiled:
    """One cache entry: the program to replay (the pass-rewritten clone)
    and what its replay needs, computed once per signature."""

    def __init__(self, work: Program, feed_names, fetch_vars):
        self.work = work
        self.feed_var_ids = [work.feed_vars[n] for n in feed_names]
        self.fetch_vars = list(fetch_vars)
        self.grad_requests = list(work.grad_requests)
        self.opt_updates = list(work.opt_updates)
        self.pos_of_param = {v: i for i, v in enumerate(work.param_vars)}
        # feeds and activations a grad request differentiates (static.gradients)
        self.grad_leaves = {v for _, pvars, _ in self.grad_requests for v in pvars
                            if v not in self.pos_of_param}
        self.keep = (set(fetch_vars) | {loss for loss, _, _ in self.grad_requests}
                     | self.grad_leaves)
        self.last_uses = work.last_uses()

    def __call__(self, feed_arrays, param_arrays, accum_arrays, lr_values):
        work = self.work
        feeds = dict(zip(self.feed_var_ids, feed_arrays))
        pos_of_param = self.pos_of_param
        grad_vals: Dict[int, Tensor] = {}
        env = None
        # one grad pass PER request (losses must not contaminate each
        # other), differentiating only wrt that request's parameters
        for loss_var, pvars, gvars in self.grad_requests:
            with torch.enable_grad():
                env = work.replay_env(feeds, param_arrays, self.keep, self.last_uses,
                                      self.grad_leaves)
                wrt = [param_arrays[pos_of_param[pv]] if pv in pos_of_param else env[pv]
                       for pv in pvars]
                loss = env[loss_var].sum()
                diff = [i for i, p in enumerate(wrt) if p.requires_grad]
                grads = torch.autograd.grad(loss, [wrt[i] for i in diff], allow_unused=True)
            got = dict(zip(diff, grads))
            for i, (gv, p) in enumerate(zip(gvars, wrt)):
                g = got.get(i)
                grad_vals[gv] = torch.zeros_like(p) if g is None else g
        with torch.no_grad():
            if env is None:
                env = work.replay_env(feeds, param_arrays, self.keep, self.last_uses)
            env.update(grad_vals)
            params = set(pos_of_param)
            fetches = []
            for v in self.fetch_vars:
                t = env[v].detach()
                # a fetched parameter shows its value before this run's update
                fetches.append(t.clone() if v in params and self.opt_updates else t)
            self._update(env, param_arrays, accum_arrays, lr_values)
        return fetches

    def _update(self, env, param_arrays, accum_arrays, lr_values):
        """clip -> decay -> update, each group as the eager step does;
        parameters and accumulators are written in place."""
        from ..nn.clip import ClipGradByGlobalNorm

        opt_updates, pos_of_param = self.opt_updates, self.pos_of_param
        eff_grads = []
        for upd in opt_updates:
            if isinstance(upd, _FusedAdamWUpdate):
                gs = [env.get(gv) for gv in upd.grad_vars]
                if any(g is None for g in gs):
                    raise RuntimeError("optimizer update without computed gradient")
                eff_grads.append(gs)
                continue
            g = env.get(upd.grad_var)
            if g is None:
                raise RuntimeError("optimizer update without computed gradient")
            eff_grads.append(g)

        def _as_list(g):
            return g if isinstance(g, list) else [g]

        clip_groups = {}
        for i, upd in enumerate(opt_updates):
            if isinstance(upd.clip, ClipGradByGlobalNorm):
                clip_groups.setdefault(id(upd.clip), (upd.clip, []))[1].append(i)
        for clip, idxs in clip_groups.values():
            gn = torch.sqrt(sum(
                torch.sum(torch.square(g.float())) for i in idxs for g in _as_list(eff_grads[i])))
            scale = torch.clamp(clip.clip_norm / torch.clamp(gn, min=1e-12), max=1.0)

            def _scaled(g):
                return (g.float() * scale).to(g.dtype)

            for i in idxs:
                if isinstance(eff_grads[i], list):
                    eff_grads[i] = [_scaled(g) for g in eff_grads[i]]
                else:
                    eff_grads[i] = _scaled(eff_grads[i])
        for upd, accs, lr, g in zip(opt_updates, accum_arrays, lr_values, eff_grads):
            if isinstance(upd, _FusedAdamWUpdate):
                Executor._apply_fused_update(upd, accs, lr, g, param_arrays, pos_of_param)
                continue
            p = param_arrays[pos_of_param[upd.param_var]]
            if upd.wd:
                g = g + upd.wd * p.to(g.dtype)
            res = upd.update_fn(p, g, lr, *accs)
            p.copy_(res[0])
            for t, new in zip(accs, res[1:]):
                t.copy_(new)


class Executor:
    """paddle.static.Executor."""

    def __init__(self, place=None):
        self.place = place

    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, np.ndarray]] = None,
        fetch_list: Optional[Sequence] = None,
        return_numpy: bool = True,
        **kwargs,
    ):
        from ..core import state
        from .io import _InferenceProgram

        from .extras import CompiledProgram

        if isinstance(program, _InferenceProgram):  # load_inference_model's artifact
            return program._run(feed or {}, return_numpy)
        if isinstance(program, CompiledProgram):
            program = program._program
        program = program if program is not None else default_main_program()
        feed = feed or {}
        fetch_list = list(fetch_list or [])
        fetch_vars = [program.resolve_fetch(f) for f in fetch_list]
        compiled, miss_s = self._compile(program, tuple(sorted(feed)), tuple(fetch_vars))

        feed_arrays = []
        for n in sorted(feed):
            like = program._var_tensors.get(program.feed_vars.get(n))
            v = feed[n]
            t = v if isinstance(v, Tensor) else numpy_to_tensor(np.asarray(v))
            if like is not None and not like.is_meta:
                t = t.to(like.device)
            feed_arrays.append(t)
        param_arrays = [program._var_tensors[v] for v in program.param_vars]
        accum_arrays = [list(upd.accum_tensors) for upd in program.opt_updates]
        lr_values = [float(upd.lr() if callable(upd.lr) else upd.lr)
                     for upd in program.opt_updates]
        # the replay records nothing, even when run under a program_guard
        prev = state.set_program_capture(None)
        try:
            args = (feed_arrays, param_arrays, accum_arrays, lr_values)
            if miss_s is None:
                from .. import compile_cache as _cc

                _cc.record("static_executor", "replay", "hit")
                fetches = compiled(*args)
            else:
                fetches = self._first_run(program, compiled, args, miss_s)
            from ..framework import flags as _flags

            if _flags._registry.get("FLAGS_check_nan_inf", False):
                self._check_written_state(program, param_arrays, accum_arrays)
        finally:
            state.set_program_capture(prev)
        if return_numpy:
            return [tensor_to_numpy(f) for f in fetches]
        return fetches

    @staticmethod
    def _first_run(program, compiled, args, miss_s):
        """A signature's first run: the ledger's `miss` (the compile's
        verify + passes, `miss_s` seconds), then the run under a FLOP count
        whose total goes to perf_attribution as the program's record."""
        from .. import compile_cache as _cc
        from .. import telemetry as _tm

        feed_arrays = args[0]
        name = f"replay[{len(compiled.work.ops)}ops,{len(feed_arrays)}feeds]"
        if not _tm.enabled():
            return compiled(*args)
        fp = _cc.fingerprint_text(
            f"executor-replay-v1|{program.to_text()}|{_cc.aval_signature(list(feed_arrays))}")
        _cc.record("static_executor", name, "miss", seconds=miss_s, fingerprint=fp,
                   signature=f"{len(feed_arrays)}feeds")
        from ..profiler import perf_attribution as _pa

        with _pa.counting_flops() as count:
            fetches = compiled(*args)
        dev = next((t.device for t in args[1] if isinstance(t, Tensor)), None)
        mem = ({"peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
               if dev is not None and dev.type == "cuda" else {})
        _pa.record_compiled("static_executor", name, flops=count.total, memory=mem,
                            compile_seconds=miss_s,
                            extra={"program_id": id(program),
                                   "flops_dispatched": count.dispatched,
                                   "flops_kernels": count.kernels})
        return fetches

    @staticmethod
    def _check_written_state(program, param_arrays, accum_arrays):
        """FLAGS_check_nan_inf: the guardian's check of what the run wrote
        back, the updated parameters and every optimizer accumulator."""
        from ..framework import guardian as _guardian

        pos = {v: i for i, v in enumerate(program.param_vars)}
        touched = []
        for upd in program.opt_updates:
            pvs = upd.param_var if isinstance(upd.param_var, tuple) else (upd.param_var,)
            touched.extend(param_arrays[pos[pv]] for pv in pvs)
        for accs in accum_arrays:
            touched.extend(accs)
        _guardian.check_compiled_state(touched, origin="static_executor")

    # ---- compilation ----
    @staticmethod
    def _program_structure_key(program: Program):
        """Structural identity of the instruction list. Every OpInstr
        carries a process-global monotonic serial (program.py `_op_serial`)
        that is never reused, so an op REPLACED in place (same op count)
        gets a fresh serial and therefore a new key; the stale entry is
        evicted instead of silently replayed. O(#ops) per run on purpose:
        an in-place `program.ops[i] = ...` edit is only seen by looking."""
        ops_key = tuple(op.seq for op in program.ops)
        grads_key = tuple(
            (loss, tuple(pvs), tuple(gvs)) for loss, pvs, gvs in program.grad_requests
        )
        opts_key = tuple((u.param_var, u.grad_var) for u in program.opt_updates)
        return (ops_key, grads_key, opts_key)

    def _compile(self, program: Program, feed_names, fetch_vars):
        from .. import telemetry as _tm
        from . import passes as _passes

        telemetry_on = _tm.enabled()
        structure = self._program_structure_key(program)
        # the pipeline flag is part of the entry's identity: toggling
        # FLAGS_program_passes must miss, not replay the other mode's entry
        passes_on = _passes.pipeline_enabled()
        key = (feed_names, fetch_vars, structure, passes_on)
        hit = program._compiled.get(key)
        if telemetry_on:
            _tm.counter(
                "paddle_tpu_executor_compile_cache_total",
                "static Executor compiled-program cache lookups", ("result",),
            ).labels(result="hit" if hit is not None else "miss").inc()
        if hit is not None:
            return hit, None
        t0 = time.perf_counter()
        # evict entries for the same (feed, fetch, passes-mode) signature
        # whose program structure went stale — they can never hit again
        stale = [
            k for k in program._compiled
            if k[0] == feed_names and k[1] == fetch_vars and k[3] == passes_on
        ]
        for k in stale:
            del program._compiled[k]
        if stale and telemetry_on:
            _tm.counter(
                "paddle_tpu_executor_compile_cache_evictions_total",
                "stale compiled-program cache entries dropped on recompile",
            ).inc(len(stale))

        # verify BEFORE passes (flag-gated, miss only): a malformed program
        # fails here with a diagnostic naming the op/var; the pipeline then
        # re-verifies after every rewriting pass and once post-pipeline
        from .analysis import verifier as _verifier

        if _verifier.verify_enabled():
            _verifier.verify(program, feed_names=feed_names, fetch_vars=fetch_vars)

        # pass pipeline (FLAGS_program_passes, default on): rewrite a CLONE
        # per signature — DCE prunes to THIS fetch set and fusion patterns
        # collapse clusters, while the caller's Program keeps every op
        work = program
        if passes_on:
            work, _pass_result = _passes.run_default_pipeline(
                program, fetch_vars=fetch_vars, feed_names=feed_names
            )
        compiled = _Compiled(work, feed_names, fetch_vars)
        miss_s = time.perf_counter() - t0
        if telemetry_on:
            _tm.histogram(
                "paddle_tpu_executor_compile_seconds",
                "wall time of a static Executor compile miss (verify, pass "
                "pipeline, replay bookkeeping)",
            ).observe(miss_s)
        program._compiled[key] = compiled
        return compiled, miss_s

    @staticmethod
    def _apply_fused_update(upd, accs, lr, grads, param_arrays, pos_of_param):
        """One flat-bucket kernel for a whole minimize() call's params:
        gather grads/params into padded flat buffers, run fused_adamw_apply
        with seed 0 and clip scale 1 (as the JAX package does every step:
        a bf16 moment2's rounding bits would repeat from step to step),
        scatter params back, count the step in `t`."""
        from ..ops.fused_optimizer import fused_adamw_apply

        m_flat, v_flat, t = accs
        t2 = int(t.item()) + 1
        # f32 scalars, as the JAX package computes them on the device
        c1 = float(np.float32(1.0) - np.power(np.float32(upd.beta1), np.float32(t2)))
        c2 = float(np.float32(1.0) - np.power(np.float32(upd.beta2), np.float32(t2)))
        params = [param_arrays[pos_of_param[pv]] for pv in upd.param_vars]
        n = sum(upd.index[pv][1] for pv in upd.param_vars)
        dev, pdt = params[0].device, params[0].dtype
        g_flat = torch.zeros(upd.n_pad, dtype=torch.float32, device=dev)
        p_flat = torch.zeros(upd.n_pad, dtype=pdt, device=dev)
        torch.cat([g.reshape(-1).float() for g in grads], out=g_flat[:n])
        torch.cat([p.detach().reshape(-1) for p in params], out=p_flat[:n])
        fused_adamw_apply(p_flat, m_flat, v_flat, g_flat, lr=lr, clip_scale=1.0, c1=c1, c2=c2,
                          seed=0, beta1=upd.beta1, beta2=upd.beta2, eps=upd.eps, wd=upd.wd,
                          decoupled=upd.decoupled)
        for pv, p in zip(upd.param_vars, params):
            off, size, shape = upd.index[pv]
            p.copy_(p_flat[off:off + size].view(shape))
        t.fill_(t2)


def global_scope():
    """Minimal Scope (paddle.static.global_scope): find_var by name over
    the default main program's named vars."""

    class _Scope:
        def find_var(self, name):
            prog = default_main_program()
            for vid, n in prog._var_names.items():
                if n == name:
                    return prog._var_tensors.get(vid)
            return None

    return _Scope()


class scope_guard:
    def __init__(self, scope):
        self.scope = scope

    def __enter__(self):
        return self.scope

    def __exit__(self, *exc):
        return False
