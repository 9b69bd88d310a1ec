"""Flat-bucket engine for the one-pass AdamW kernel (FLAGS_fused_optimizer),
the counterpart of paddle_tpu/optimizer/fused_engine.py.

Parameters with their grads, moment1 and moment2 are flattened into
contiguous buckets keyed by (dtype, weight decay, lr scale, need_clip),
parameters in `parameters()` order; each bucket updates through one
launch of the fused AdamW kernel (`ops.fused_optimizer.fused_adamw_apply`)
per step. The layout is the JAX engine's: the same keys, order, offsets
and `pad_to_tile` padding, so every element gets the same flat index, and
with it the same stochastic-rounding noise, as in the JAX package.

moment1/moment2 live flat for good and update in place. Params and grads
are concatenated into flat copies each step and the new params are
copied back into each parameter (paddle_tpu/optimizer/fused_engine.py
:298-330); making the parameters views of their bucket is later work.
A global-norm clip enters the kernel as one scalar operand on the device.
Param groups partition separately, in group order, each with its own
clip; buckets of one key share the engine's `buckets` as in the JAX
engine. A bf16 parameter (amp.decorate O2) has a bf16 bucket: the kernel
updates in f32 and stores bf16, with no master copy. `view_into` shows
the moments and beta powers per parameter for `state_dict`.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from ..nn.clip import ClipGradByGlobalNorm
from ..ops.fused_optimizer import fused_adamw_apply, pad_to_tile
from ..regularizer import L1Decay


class FlatAdamWEngine:
    """Per-optimizer flat-bucket store and step executor for Adam/AdamW."""

    def __init__(self, opt):
        self.opt = opt
        # key -> bucket; key = (dtype, wd value, lr scale, need_clip)
        self.buckets: dict = {}

    def _partition(self, entries):
        """(p, g, wd, lr_scale) entries -> flat-fusable buckets (f32/bf16
        params whose grad has the param's shape) and a per-param rest."""
        from .optimizer import _wd_value

        buckets = defaultdict(list)
        rest = []
        for p, g, wd, s in entries:
            fusable = (not isinstance(wd, L1Decay) and p.dtype in (torch.float32, torch.bfloat16)
                       and g.shape == p.shape)
            if fusable:
                key = (p.dtype, _wd_value(wd), float(s), bool(getattr(p, "need_clip", True)))
                buckets[key].append((p, g))
            else:
                rest.append((p, g, wd, s))
        return buckets, rest

    def _build_bucket(self, key, plist):
        opt = self.opt
        ids = tuple(id(p) for p, _ in plist)
        new_ids = set(ids)
        # composition changed: dissolve every overlapping bucket, flat or
        # stacked, so its state is inherited below and not zeroed
        for k2, b2 in list(self.buckets.items()):
            if new_ids.intersection(b2["ids"]):
                self._defuse_bucket(b2)
                del self.buckets[k2]
        for old_ids, old_st in list(opt._fused_buckets.items()):
            if new_ids.intersection(old_ids):
                opt._defuse_bucket(old_st)
                del opt._fused_buckets[old_ids]

        index, off = {}, 0
        for p, _ in plist:
            index[id(p)] = (off, p.numel(), tuple(p.shape))
            off += p.numel()
        n, n_pad = off, pad_to_tile(off)
        dev = plist[0][0].device

        def gather(name, dtype):
            flat = torch.zeros(n_pad, dtype=dtype, device=dev)
            for p, _ in plist:
                prev = opt._pop_param_state(name, id(p))
                if prev is not None:
                    o, size, _ = index[id(p)]
                    flat[o:o + size] = prev.reshape(-1).to(dtype)
            return flat

        def gather_scalar(name):
            vals = [opt._pop_param_state(name, id(p)) for p, _ in plist]
            return next((np.float32(v) for v in vals if v is not None), np.float32(1.0))

        bucket = {
            "ids": ids, "index": index, "n": n, "n_pad": n_pad,
            "moment1": gather("moment1", torch.float32),
            "moment2": gather("moment2", opt._m2_dtype),
            "beta1_pow": gather_scalar("beta1_pow"),
            "beta2_pow": gather_scalar("beta2_pow"),
        }
        self.buckets[key] = bucket
        return bucket

    def _bucket_for(self, key, plist):
        b = self.buckets.get(key)
        if b is None or b["ids"] != tuple(id(p) for p, _ in plist):
            from .. import telemetry as _tm

            if not _tm.enabled():
                return self._build_bucket(key, plist)
            from ..profiler import perf_attribution as _pa
            from ..profiler.utils import RecordEvent, TracerEventType

            name = f"bucket[{str(key[0]).replace('torch.', '')},n={sum(p.numel() for p, _ in plist)}]"
            with RecordEvent(f"FlatAdamWEngine.build_{name}", TracerEventType.Optimization):
                b = self._build_bucket(key, plist)
            # one record a bucket (nothing is compiled: the kernel is built
            # once for every bucket): the bytes one launch must move
            m2_bytes = b["moment2"].element_size()
            p_bytes = plist[0][0].element_size()
            # p, m1 and m2 read and written, the f32 grad read
            _pa.record_compiled(
                "fused_optimizer", name,
                bytes_accessed=float(b["n_pad"]) * (2 * p_bytes + 2 * 4 + 2 * m2_bytes + 4),
                extra={"n_elems": b["n_pad"], "m2_dtype": str(b["moment2"].dtype)})
        return b

    def step(self, groups):
        """groups = [(clip, entries)], entries = [(p, g, wd, lr_scale)] with
        UNCLIPPED grads (Optimizer._collect_groups)."""
        opt = self.opt
        for clip, entries in groups:
            entries = [(p, g, opt._effective_wd(p, wd), s) for p, g, wd, s in entries]
            scale = None
            if isinstance(clip, ClipGradByGlobalNorm):
                # the norm is reduced here; the scaling rides the kernel as an operand
                scale = clip.global_scale([g for p, g, _, _ in entries
                                           if getattr(p, "need_clip", True)])
            elif clip is not None:
                # a clip with no scalar form: apply it first
                pgs = clip([(p, g) for p, g, _, _ in entries])
                entries = [(p, g2, wd, s) for (p, _, wd, s), (_, g2) in zip(entries, pgs)]
            buckets, rest = self._partition(entries)
            for key, plist in buckets.items():
                self._apply_bucket(key, plist, scale)
            for p, g, wd, s in rest:
                if scale is not None and getattr(p, "need_clip", True):
                    g = g * scale.to(g.dtype)
                opt._apply_one(p, g, wd, s)

    def materialize(self, groups) -> int:
        """Build the buckets (and the rest's accumulators) of the current
        composition without updating anything; returns the number of
        updates the next step makes (one per bucket and per rest param)."""
        opt, n = self.opt, 0
        for _, entries in groups:
            entries = [(p, g, opt._effective_wd(p, wd), s) for p, g, wd, s in entries]
            buckets, rest = self._partition(entries)
            for key, plist in buckets.items():
                self._bucket_for(key, plist)
            for p, _, _, _ in rest:
                opt._materialize_one(p)
            n += len(buckets) + len(rest)
        return n

    def _apply_bucket(self, key, plist, clip_scale):
        opt = self.opt
        dtype, wdv, lr_scale, need_clip = key
        b = self._bucket_for(key, plist)
        pad = b["n_pad"] - b["n"]
        dev = plist[0][0].device
        g_parts = [g.reshape(-1).float() for _, g in plist]
        p_parts = [p.detach().reshape(-1) for p, _ in plist]
        if pad:
            g_parts.append(torch.zeros(pad, dtype=torch.float32, device=dev))
            p_parts.append(torch.zeros(pad, dtype=dtype, device=dev))
        G = torch.cat(g_parts)
        P = torch.cat(p_parts)
        del g_parts, p_parts
        b1p_new = b["beta1_pow"] * np.float32(opt._beta1)
        b2p_new = b["beta2_pow"] * np.float32(opt._beta2)
        seed = opt._m2_key() if opt._m2_dtype == torch.bfloat16 else 0
        fused_adamw_apply(
            P, b["moment1"], b["moment2"], G,
            lr=opt._lr_value(lr_scale),
            clip_scale=clip_scale if (clip_scale is not None and need_clip) else 1.0,
            c1=float(np.float32(1.0) - b1p_new), c2=float(np.float32(1.0) - b2p_new),
            seed=seed, beta1=opt._beta1, beta2=opt._beta2, eps=opt._eps, wd=wdv,
            decoupled=opt._wd_mode == "decoupled")
        del G
        for p, _ in plist:
            off, size, shape = b["index"][id(p)]
            p.copy_(P[off:off + size].view(shape))
        b["beta1_pow"], b["beta2_pow"] = b1p_new, b2p_new

    def _defuse_bucket(self, b):
        for pid, (off, size, shape) in b["index"].items():
            pend = self.opt._pending_state
            pend[("moment1", pid)] = b["moment1"][off:off + size].reshape(shape).clone()
            pend[("moment2", pid)] = b["moment2"][off:off + size].reshape(shape).clone()
            pend[("beta1_pow", pid)] = b["beta1_pow"]
            pend[("beta2_pow", pid)] = b["beta2_pow"]

    def state_slots(self):
        """[(holder, key, fill)] of each bucket's state (see
        Optimizer._state_slots): the flat moments update in place, the beta
        powers are host f32 values."""
        out = []
        for b in self.buckets.values():
            out.extend((b, nm, 0.0) for nm in ("moment1", "moment2"))
            out.extend((b, nm, 1.0) for nm in ("beta1_pow", "beta2_pow"))
        return out

    def digest_units(self):
        """[(name, tensor)] for the guardian's desync digest: one unit a
        flat bucket tensor, named by the bucket key as in the JAX engine."""
        out = []
        for bi, (key, b) in enumerate(sorted(self.buckets.items(), key=lambda kv: repr(kv[0]))):
            dtype, wdv, lr_scale, _need_clip = key
            tag = f"flat_bucket:{bi}[{str(dtype).replace('torch.', '')},wd={wdv},lrs={lr_scale}]"
            out.append((f"{tag}:moment1", b["moment1"]))
            out.append((f"{tag}:moment2", b["moment2"]))
        return out

    def defuse_all(self):
        for b in list(self.buckets.values()):
            self._defuse_bucket(b)
        self.buckets.clear()

    def view_into(self, view) -> None:
        """Each bucket's state as per-param values in `view` (name ->
        {id(param): value}): views of the flat moments, the bucket's beta
        powers (the state dict's format is the per-tensor path's)."""
        for b in self.buckets.values():
            for pid, (off, size, shape) in b["index"].items():
                view.setdefault("moment1", {})[pid] = b["moment1"][off:off + size].view(shape)
                view.setdefault("moment2", {})[pid] = b["moment2"][off:off + size].view(shape)
                view.setdefault("beta1_pow", {})[pid] = b["beta1_pow"]
                view.setdefault("beta2_pow", {})[pid] = b["beta2_pow"]
