#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                     # every phase, as the check runs it
    python3 chip_smoke.py --phases build,kernels

Phases, one line each (any failure raises and exits non-zero):
  device         the card's name and power limit (nvidia-smi)
  build          nvcc of the hand-written kernels from this checkout
  kernel ...     each CUDA kernel against its plain PyTorch version on the
                 card, with timings and the card's least time for the work
  serve_bf16     Llama-3-8B layer shape at 32 layers, bf16, seeded weights:
                 8 prompts of 16-1024 tokens through the continuous-batching
                 scheduler, 32 new tokens each; launch counts; per-step logits
                 of one request against a no-cache full-forward recompute
  serve_int8     the same engine with an int8 KV pool: two runs, equal ids
  predictor_f32  save_llm -> Config -> create_predictor().run() at full width,
                 1 layer, f32: ids equal the no-cache greedy oracle
  train_parity   two tiny Llamas (head_dim 16: the CUDA-core flash kernels;
                 head_dim 64: the tensor-core forward, dq and dk/dv), each
                 built twice from one set of weights, on the card (kernels)
                 and on the CPU (plain versions): 2 AMP-O1 AdamW steps with
                 FLAGS_fused_optimizer and a bf16 moment2 under the same
                 stochastic-rounding seeds;
                 losses, step-1 grads and the params after step 2 agree
  train_bf16     Llama-3-8B layer width at 4 layers, seq 4096, batch 1, AMP
                 O1 bf16, fused AdamW with a bf16 moment2: 5 steps on one
                 batch; losses finite and falling, exact launches per step,
                 ms/step, tokens/s, peak memory, and a profiled 2-step split
  rms_norm_entry incubate fused_rms_norm, forward and backward, at 4096 x 4096
                 bf16 with an f32 weight: one kernel launch; output and grads
                 against the plain version through autograd
Kernel checks (phase kernels): flash forward, paged attention (decode,
extend, int8 and f32 pages, frontiers on the planned split boundaries, a
long single row; every case launched twice for equal bits; timed as device
time through CUDA graphs over a rotation of pools that exceeds the L2, so
the pages are read cold, as the engine's layer pools are), the flash
backward (dq and dk/dv, through autograd of the wrapper, against the plain
backward and against autograd through the plain forward; every flash case
logs the kernel variant it ran, ops.attention.kernel_variant), the fused AdamW
(64M-element buckets; the whole training bucket, slice by slice; the
slices of a bucket past 2^31 elements) and RMSNorm, each against its plain
version.
Then a {"kernels": [...]} line and, last, the device line the checker reads.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, f32 CUDA cores, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

LLAMA3_8B = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
                 num_attention_heads=32, num_key_value_heads=8, intermediate_size=14336)
# Depth cut to 4 of 32 (1.135e9 params), as the training slice was set:
# at 32 layers the f32 params, grads and moment1 with a bf16 moment2 alone
# (7.24e9 params x 14 B = 101 GB) exceed one card. The measured peak at 4
# layers (25.03 GB on an H100 80GB) is 22 B a param, the optimizer step's
# flat copies of P and G included: about 14 layers would fit.
TRAIN_LAYERS, TRAIN_SEQ = 4, 4096
TINY_LLAMA = dict(vocab_size=1024, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                  num_key_value_heads=2, intermediate_size=176)
# head_dim 64: the bf16 flash forward, dq and dk/dv take their tensor-core
# variants (head_dim 16 above takes the CUDA-core ones)
TINY_LLAMA_D64 = dict(TINY_LLAMA, hidden_size=256, intermediate_size=704)

# Tolerances of kernel vs plain version on the same inputs, per output row
# (one query and head: D values w of the plain version, g of the kernel):
#   each element  |g - w| <= rtol * |w| + atol_rms * rms(w)
#   the row       ||g - w|| <= row * ||w||
# An absolute tolerance scaled by the row's RMS fits attention: p is rounded
# at other points in the two versions, and those errors scale with the
# row's size, not with each element's (an element near 0 by cancellation
# keeps the error of its terms). Set at 1.5-4x the worst error measured on
# an H100 over the cases below (bf16: 0.034 rms and 0.0052 row; int8:
# 0.016 rms and 0.0014 row; f32: 1.2e-5 rms and 1.7e-6 row).
TOL = {
    "f32": dict(rtol=1e-5, atol_rms=5e-5, row=1e-5),
    "bf16": dict(rtol=2e-2, atol_rms=5e-2, row=1e-2),  # rtol: the bf16 output's last bit
    "int8": dict(rtol=1e-2, atol_rms=2.5e-2, row=3e-3),  # int8 pages: p stays f32 on both sides
    # flash backward against the plain backward on the same saved tensors,
    # rows of dq, dk and dv. A gradient row's rounding error scales with its
    # terms, not its sum: the first query of a causal row sees one key and
    # its dq is ~0 by cancellation in both versions. So each row's scale is
    # at least `floor` x the whole tensor's RMS. Worst measured on an H100
    # over the cases below (own-row scale): f32 2.0e-2 of (1e-4, 1e-4) per
    # element and 9.2e-7 per row; bf16 0.20 of the bf16 limits per element
    # and 0.0043 per row.
    "f32_grad": dict(rtol=1e-5, atol_rms=2e-5, row=4e-6, floor=0.1),
    "bf16_grad": dict(rtol=2e-2, atol_rms=5e-2, row=1e-2, floor=0.1),
}
# p, m and an f32 v of the fused AdamW against its plain version: one f32
# ulp relative. Both round every operation once in the same order; the
# measured difference on an H100 is 0 (and bf16 moment2 bits 100% equal).
ADAMW_F32_RTOL = 2.0 ** -22
# Flash backward against autograd through the plain forward, as a relative
# Frobenius error per gradient tensor. The kernels (as the JAX kernels)
# take delta = rowsum(dO * O) from the stored O, which in bf16 is rounded:
# that shifts every ds of a row by ~2^-9 |dO||O| whatever the row's size,
# so a row-by-row bound does not fit; autograd rounds neither O nor ds.
# Worst measured on an H100: f32 6.6e-7, bf16 3.7e-3.
GRAD_VS_AUTOGRAD_REL = {torch.float32: 3e-6, torch.bfloat16: 1e-2}
LOGIT_REL_BOUND = 5e-2  # ||cached - recomputed|| / ||recomputed|| per step, bf16 over 32 layers


def _kernel_name(mangled: str) -> str:
    """`flash_fwd_tc_kernel<128>` from an Itanium-mangled kernel symbol."""
    # a length prefix may follow other digits (a hash in the namespace)
    for m, cut in ((m, c) for m in re.finditer(r"\d+(?=[A-Za-z_])", mangled)
                   for c in range(m.start(), m.end())):
        n = int(mangled[cut:m.end()])
        name = mangled[m.end():m.end() + n]
        if not name.endswith("_kernel"):
            continue
        rest, args, i = mangled[m.end() + n:], [], 1
        while rest.startswith("I") and i < len(rest) and rest[i] != "E":
            if rest[i] == "L":  # a literal: L<type><value>E
                j = rest.index("E", i)
                args.append(rest[i + 2:j])
                i = j + 1
            elif rest[i].isdigit():  # a named type
                k = re.match(r"\d+", rest[i:]).group()
                t = rest[i + len(k):i + len(k) + int(k)]
                args.append({"__nv_bfloat16": "bf16"}.get(t, t))
                i += len(k) + int(k)
            else:  # a builtin type
                args.append({"f": "float"}.get(rest[i], rest[i]))
                i += 1
        return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


def ptxas_summary(nvcc_log: str) -> list:
    """One line per kernel of `nvcc -Xptxas -v` output (its name and
    template arguments, registers, spills), and ptxas's warnings."""
    out, name, spill = [], "?", "?"
    for ln in nvcc_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = _kernel_name(m.group(1))
        elif "spill stores" in ln:
            spill = ln.split(",")[1].strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{name}: {regs} registers, {spill}")
        elif "(C7" in ln:  # ptxas performance warnings, e.g. serialized wgmma
            fn = re.search(r"function '(\w+)'", ln)
            out.append((f"{_kernel_name(fn.group(1))}: " if fn else "")
                       + ln.split(":", 1)[1].strip()[:120])
    return out


def log(phase: str, **fields) -> None:
    print(f"{phase}: " + json.dumps(fields, default=float), flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph_ms(fn, reps: int = 20, iters: int = 10) -> float:
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph, replayed `iters` times. For calls of tens of microseconds, whose
    eager time is the host's Python and launch overhead, not the card's."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    ms = time_ms(graph.replay, iters=iters, warmup=1) / reps
    del graph
    return ms


def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> dict:
    """Hold `got` to `want` under `tol` (see TOL); raise on a miss."""
    d = want.shape[-1]
    got, want = got.float().reshape(-1, d), want.float().reshape(-1, d)
    err = (got - want).abs()
    rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
    rms = rms.clamp_min(tol.get("floor", 0.0) * want.pow(2).mean().sqrt().item())
    elem = (err / (tol["rtol"] * want.abs() + tol["atol_rms"] * rms).clamp_min(1e-30)).max().item()
    row = (err.norm(dim=-1) / (rms.squeeze(-1) * math.sqrt(d)).clamp_min(1e-30)).max().item()
    rec = dict(max_abs_err=err.max().item(), worst_elem_ratio=elem, worst_row_rel_err=row, tol=tol)
    if not (elem <= 1.0 and row <= tol["row"]):
        raise AssertionError(f"{name}: kernel disagrees with its plain version: {rec}")
    return rec


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def check_flash(ta, gen, name, b, sq, sk, h, hkv, d, dtype, causal, dropout_p=0.0, timed=False):
    """The wrapper the main path calls (flash_attention_bshd_lse, default
    scale, integer seed) against the plain version on the same inputs."""
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v = rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d)
    before = ta.LAUNCHES["flash_fwd"]
    got, lse = ta.flash_attention_bshd_lse(q, k, v, causal=causal, dropout_p=dropout_p,
                                           dropout_seed=1234)
    if ta.LAUNCHES["flash_fwd"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the flash kernel exactly once")
    scale = 1.0 / math.sqrt(d)
    want, lse_w = ta._flash_plain(q, k, v, causal, scale, dropout_p, 1234)
    torch.cuda.synchronize()
    rec = dict(case=name, variant=ta.kernel_variant("flash_fwd", dtype, d),
               **compare(name, got, want, TOL["f32" if dtype == torch.float32 else "bf16"]))
    rec["lse_err"] = (lse - lse_w).abs().max().item()
    if not rec["lse_err"] <= 1e-4:
        raise AssertionError(f"{name}: lse disagrees with the plain version: {rec}")
    if timed:
        off = sk - sq
        pairs = b * h * (sum(min(sk, i + 1 + off) for i in range(sq)) if causal else sq * sk)
        flops = 4.0 * pairs * d
        bnd, by = bound_ms(flops, nbytes(q, k, v, got, lse), dtype)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        rec.update(
            ms=time_ms(lambda: ta.flash_attention_bshd(q, k, v, causal=causal)),
            plain_ms=time_ms(lambda: ta._flash_plain(q, k, v, causal, scale, 0.0, 0), iters=5),
            library_ms=time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True)),
            bound_ms=bnd, bound_by=by)
    log("kernel flash_fwd", **rec)
    return rec


def paged_pool(gen, n_pages, bs, hkv, d, dtype):
    rn = lambda: torch.randn(n_pages, bs, hkv, d, generator=gen, device="cuda")
    kp, vp = rn(), rn()
    if dtype == torch.int8:
        from paddle_tpu_torch.quantization.observers import absmax_scale, quantize_absmax

        ks, vs = absmax_scale(kp, dim=-1), absmax_scale(vp, dim=-1)
        return (quantize_absmax(kp, ks[..., None]), quantize_absmax(vp, vs[..., None]),
                dict(k_scales=ks, v_scales=vs))
    return kp.to(dtype), vp.to(dtype), {}


# per-row cache lengths of the paged checks (B = 8): frontiers inside
# pages, a short row, a full row, and last a padded row as the engine pads
# an idle decode slot (one position, a table of the reserved page 0)
PAGED_CTX = [2041, 1500, 777, 17, 2048, 1023, 300, 1]
# the decode profile's shape (profile_decode: B = 8 rows at ~1000 tokens)
PAGED_CTX_UNIFORM = [1000] * 8


def boundary_ctx(ta, kv_dtype=torch.bfloat16) -> list:
    """B = 8 cache lengths whose frontiers (ctx - 1) fall on the split
    boundaries the wrapper plans for pages of `kv_dtype` at the serving
    shape (B 8, H 32/8, D 128, a 128-page table): the last slot of a split,
    the first of the next, and rows that end 1-2 slots past one."""
    plan = ta.paged_split_plan(8, 1, 32, 8, 128, 128, kv_dtype=kv_dtype,
                               sms=ta._sm_count(torch.cuda.current_device()))
    ss = plan["split_pages"] * 16
    return [ss, ss + 1, 2 * ss + 1, 2 * ss, 2048, ss + 2, 1, 2 * ss + 2]


PAGED_L2_BYTES = 50e6  # the H100's L2: a timing that fits in it is warm


def paged_inputs(gen, qn, kv_dtype, qdt=torch.bfloat16, ctx=PAGED_CTX):
    """q [B, qn, 32, 128], one pool (k, v, scales) of 16-slot pages, a
    shuffled block table of the engine's width (128 pages) padded with page
    0, and each row's frontiers ending at its ctx - 1."""
    h, hkv, d, bs = 32, 8, 128, 16
    b, m = len(ctx), 2048 // bs
    pool = paged_pool(gen, 1 + b * m, bs, hkv, d, qdt if kv_dtype is None else kv_dtype)
    q = torch.randn(b, qn, h, d, generator=gen, device="cuda").to(qdt)
    pages = (torch.randperm(b * m, generator=gen, device="cuda") + 1).reshape(b, m).int()
    ctx_t = torch.tensor(ctx, device="cuda")
    used = (torch.arange(m, device="cuda")[None] * bs < ctx_t[:, None]) & (ctx_t[:, None] > 1)
    bt = torch.where(used, pages, 0).int()  # unused entries padded with page 0
    qpos = (ctx_t[:, None] - qn + torch.arange(qn, device="cuda")[None]).clamp_min(0).int()
    return q, pool, bt, qpos


def paged_kv_bytes(pool, qpos) -> int:
    """K/V bytes a call must read: each row's slots up to its last query's
    position, with their scales for int8 pages."""
    kp, _, sc = pool
    hkv, d = kp.shape[2], kp.shape[3]
    slots = int((qpos.max(dim=1).values + 1).sum())
    return 2 * slots * hkv * d * kp.element_size() + (2 * slots * hkv * 4 if sc else 0)


def cold_pools(gen, pool, qpos) -> list:
    """`pool` and enough more of its shape that the K/V a call touches, over
    the rotation, exceed the L2 twice: each call then reads from HBM, as
    the engine's 32 layer pools are read in turn."""
    kp = pool[0]
    n = max(4, math.ceil(2 * PAGED_L2_BYTES / paged_kv_bytes(pool, qpos)))
    return [pool] + [paged_pool(gen, *kp.shape, kp.dtype) for _ in range(n - 1)]


def rotated(call, pools):
    """A function of no argument that runs call(pool) on the next pool."""
    turn = [0]

    def fn():
        call(pools[turn[0] % len(pools)])
        turn[0] += 1
    return fn


def check_paged(ta, gen, name, qn, kv_dtype, qdt=torch.bfloat16, timed=False, ctx=PAGED_CTX):
    """The wrapper against the plain version on a shuffled pool, then a
    second launch on the same inputs, which must give the same bits.

    Timed: `ms` is device time through a CUDA graph over a rotation of
    pools with the same tables (cold_pools), so every call reads its pages
    from HBM; `eager_ms` is one call from Python on one pool, its host time
    included."""
    q, pool, bt, qpos = paged_inputs(gen, qn, kv_dtype, qdt, ctx)
    kp, vp, sc = pool
    b, _, h, d = q.shape
    plan = ta.paged_split_plan(b, qn, h, kp.shape[2], d, bt.shape[1], kv_dtype=kp.dtype,
                               sms=ta._sm_count(torch.cuda.current_device()))
    before = ta.LAUNCHES["paged_attn"]
    got = ta.flash_decode_paged_multi(q, kp, vp, bt, qpos, **sc)
    if ta.LAUNCHES["paged_attn"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the paged kernel exactly once")
    again = ta.flash_decode_paged_multi(q, kp, vp, bt, qpos, **sc)
    want = ta.paged_extend_reference(q, kp, vp, bt, qpos, **sc)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: two launches on the same inputs differ")
    tol = TOL["int8" if kv_dtype == torch.int8 else "f32" if qdt == torch.float32 else "bf16"]
    rec = dict(case=name, variant="mma" if ta.paged_uses_mma(kp.dtype, d) else "cuda_core",
               **compare(name, got, want, tol), bit_identical_relaunch=True,
               plan={k: plan[k] for k in ("split_pages", "splits", "rows_per_cta", "row_tiles", "ctas")})
    if timed:
        # each query scores every position up to its own
        kv_bytes = paged_kv_bytes(pool, qpos)
        flops = 4.0 * h * d * float((qpos.long() + 1).sum())
        bnd, by = bound_ms(flops, kv_bytes + nbytes(q, got, bt, qpos), qdt)
        pools = cold_pools(gen, pool, qpos)
        call = lambda pl: ta.flash_decode_paged_multi(q, pl[0], pl[1], bt, qpos, **pl[2])
        rec.update(ms=time_graph_ms(rotated(call, pools), reps=4 * len(pools)),
                   eager_ms=time_ms(lambda: call(pool)),
                   plain_ms=time_ms(lambda: ta.paged_extend_reference(q, kp, vp, bt, qpos, **sc),
                                    iters=5),
                   library_ms=None, bound_ms=bnd, bound_by=by, pools_rotated=len(pools),
                   touched_mb_per_call=kv_bytes / 1e6)
        if rec["ms"] < bnd:
            raise AssertionError(f"{name}: {rec['ms']} ms is under the {bnd} ms bound: a warm timing")
        del pools
    log("kernel paged_attn", **rec)
    return rec


def paged_checks(ta, gen) -> dict:
    """Every paged case; returns the record of the kernels line (the
    decode case at PAGED_CTX, with the timed decode cases by shape)."""
    ctx = "B8 ctx " + "/".join(map(str, PAGED_CTX)) + " bs16"
    edge = {kv: boundary_ctx(ta, kv) for kv in (torch.bfloat16, torch.int8, torch.float32)}
    ectx = {kv: "B8 ctx " + "/".join(map(str, c)) + " bs16 (split boundaries)" for kv, c in edge.items()}
    bf, i8, f32 = torch.bfloat16, torch.int8, torch.float32
    paged = [check_paged(ta, gen, f"decode Q1 {ctx} bf16", 1, None, timed=True),
             check_paged(ta, gen, "decode Q1 B8 ctx 1000 bs16 bf16 (the decode profile's shape)",
                         1, None, timed=True, ctx=PAGED_CTX_UNIFORM),
             check_paged(ta, gen, f"decode Q1 {ctx} int8 pages", 1, torch.int8, timed=True),
             check_paged(ta, gen, f"extend Q4 {ctx} bf16", 4, None, timed=True),
             # 160 rows in 10 row tiles of 16: each tile streams its kv head's
             # whole context, so the call reads K/V up to 10 times
             check_paged(ta, gen, f"extend Q40 {ctx} bf16 (rows over CTAs; one split: no merge)",
                         40, None, timed=True)]
    rec = dict(paged[0], by_shape=[
        {k: r[k] for k in ("case", "variant", "ms", "eager_ms", "plain_ms", "bound_ms", "max_abs_err",
                           "plan")}
        for r in paged])
    check_paged(ta, gen, f"decode Q1 {ctx} f32 (predictor)", 1, None, qdt=torch.float32)
    check_paged(ta, gen, f"decode Q1 {ectx[bf]} bf16", 1, None, ctx=edge[bf])
    check_paged(ta, gen, f"extend Q4 {ectx[bf]} bf16 (queries straddle a boundary)", 4, None,
                ctx=edge[bf])
    check_paged(ta, gen, f"extend Q4 {ectx[i8]} int8 pages", 4, i8, ctx=edge[i8])
    check_paged(ta, gen, f"decode Q1 {ectx[f32]} f32", 1, None, qdt=f32, ctx=edge[f32])
    check_paged(ta, gen, "decode Q1 B1 ctx 2048 bs16 bf16 (one long row)", 1, None, ctx=[2048])
    return rec


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def serve_prompts(n=8, seed=0):
    rng = np.random.RandomState(seed)
    # the longest first: it takes the bucketed prefill, the rest stream in
    lens = [1024, 16] + sorted(rng.randint(17, 1024, n - 2).tolist(), reverse=True)
    return [rng.randint(0, LLAMA3_8B["vocab_size"], L).tolist() for L in lens]


def step_logits_error(engine, model, prompt, steps=32):
    """Prefill + (steps-1) decodes of one request through the engine,
    against one no-cache forward of the final sequence."""
    pool = engine.pool
    pool.reset()
    pages = pool.alloc(pool.blocks_for_tokens(len(prompt) + steps))
    rows = [engine.prefill(prompt, pages)]
    seq = list(prompt)
    for _ in range(steps - 1):
        seq.append(int(np.argmax(rows[-1])))
        p = len(seq) - 1
        rows.append(engine.decode([seq[-1]], [p], [p + 1], [pages])[0])
    pool.reset()
    with torch.inference_mode():
        ref = model(torch.tensor([seq], device=engine.device))[0, len(prompt) - 1:].float().cpu().numpy()
    got = np.stack(rows)
    rel = np.linalg.norm(got - ref, axis=-1) / np.linalg.norm(ref, axis=-1)
    agree = float(np.mean(got.argmax(-1) == ref.argmax(-1)))
    return [round(float(x), 5) for x in rel], agree


def profile_decode(engine, ctx=1000, steps=8):
    """Where a decode step's time goes: B=8 rows at ~`ctx` tokens of
    context, timed on the host clock without the profiler, then the
    device time of each kernel under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    pool = engine.pool
    pool.reset()
    rows = [pool.alloc(pool.blocks_for_tokens(ctx + 2 * steps + 1)) for _ in range(8)]
    step = lambda p: engine.decode([1] * 8, [p] * 8, [p + 1] * 8, rows)
    step(ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        step(ctx + 1 + i)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(ctx + 1 + steps + i)
        torch.cuda.synchronize()
    pool.reset()
    kind = lambda n: ("paged_attn" if "paged_attn" in n else
                      "matmul" if any(t in n for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass"))
                      else "other")
    by_kind, busy = device_ms_by_kind(prof, kind, steps)
    return dict(context=ctx, batch=8, step_ms=step_ms,
                device_ms_per_step={k: round(v, 4) for k, v in sorted(by_kind.items())},
                device_busy_ms=busy if by_kind else None,
                device_idle_share=(1.0 - busy / step_ms) if by_kind else None)


def _union_us(spans) -> float:
    """Microseconds covered by a list of (start, end) intervals."""
    total, lo, hi = 0.0, None, None
    for a, b in sorted(spans):
        if hi is None or a > hi:
            total += 0.0 if hi is None else hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return total + (0.0 if hi is None else hi - lo)


def device_ms_by_kind(prof, kind, steps) -> tuple:
    """Device ms a step of each kind of kernel (`kind` maps a lowercase
    kernel name to it) and of all together, as the union of the kernels'
    intervals in the trace: the paged merge kernel is launched as a
    programmatic dependent and overlaps the split kernel it waits for, so
    a sum of durations would count that overlap twice."""
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.end > e.time_range.start:
            spans.setdefault(kind(e.name.lower()), []).append((e.time_range.start, e.time_range.end))
    by_kind = {k: _union_us(v) / 1e3 / steps for k, v in spans.items()}
    return by_kind, _union_us([x for v in spans.values() for x in v]) / 1e3 / steps


def serve_bf16(ptt, ta, state):
    from paddle_tpu_torch.inference import ContinuousBatchingScheduler, InferenceEngine, Request
    from paddle_tpu_torch.inference.scheduler import replay
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.seed(0)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(**LLAMA3_8B, device="cuda", dtype="bfloat16").eval()
    engine = InferenceEngine(model, max_seq_len=2048, block_size=16, max_batch=8)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = serve_prompts()
    engine.generate([prompts[1]], max_new_tokens=2)  # warm-up: cuBLAS handles, kernel loads
    engine.pool.reset()

    ta.reset_launch_counts()
    engine.step_counts = dict.fromkeys(engine.step_counts, 0)
    sched = ContinuousBatchingScheduler(engine)
    reqs = [Request(rid=i, prompt=list(p), max_new_tokens=32) for i, p in enumerate(prompts)]
    stats = replay(sched, reqs)
    torch.cuda.synchronize()
    launches, steps = dict(ta.LAUNCHES), dict(engine.step_counts)
    L = LLAMA3_8B["num_hidden_layers"]
    if not (launches["flash_fwd"] == L * steps["prefill"] > 0
            and launches["paged_attn"] == L * (steps["decode"] + steps["extend"]) > 0):
        raise AssertionError(f"launch counts {launches} do not match steps {steps}")
    ids = [r.prompt[r.prompt_len:] + r.generated for r in reqs]
    if any(len(x) != 32 for x in ids):
        raise AssertionError("a request did not generate 32 tokens")
    engine.pool.reset()
    if engine.generate(prompts, max_new_tokens=32) != ids:
        raise AssertionError("generate() ids differ from the replayed run's")
    rels, agree = step_logits_error(engine, model, prompts[2])
    if not max(rels) <= LOGIT_REL_BOUND:
        raise AssertionError(f"cached vs recomputed logits rel err {max(rels)} > {LOGIT_REL_BOUND}")
    prof = profile_decode(engine)
    state["launches"] = launches
    state["bf16_ids"] = ids
    log("serve_bf16", layers=L, weights_gb=sum(nbytes(p) for p in model.parameters()) / 1e9,
        init_s=init_s, prompt_lens=[len(p) for p in prompts], tokens_per_sec=stats["tokens_per_sec"],
        wall_s=stats["wall_s"], p50_ttft_ms=stats["p50_ttft_ms"], p99_ttft_ms=stats["p99_ttft_ms"],
        p50_tpot_ms=stats["p50_tpot_ms"], p99_tpot_ms=stats["p99_tpot_ms"], steps=steps,
        launches=launches, step_logits_rel_err=rels, rel_err_bound=LOGIT_REL_BOUND,
        step_argmax_agreement=agree, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log("serve_bf16 decode profile", **prof)
    return model


def serve_int8(ta, model, state):
    from paddle_tpu_torch.inference import InferenceEngine

    engine = InferenceEngine(model, max_seq_len=2048, block_size=16, max_batch=8, kv_dtype="int8")
    prompts = serve_prompts()
    ta.reset_launch_counts()
    t0 = time.perf_counter()
    first = engine.generate(prompts, max_new_tokens=32)
    wall = time.perf_counter() - t0
    paged = ta.LAUNCHES["paged_attn"]
    engine.pool.reset()
    second = engine.generate(prompts, max_new_tokens=32)
    if first != second:
        raise AssertionError("int8 KV serving is not deterministic across two runs")
    if paged <= 0:
        raise AssertionError("int8 serving launched no paged kernel")
    same = np.mean([a == b for x, y in zip(first, state["bf16_ids"]) for a, b in zip(x, y)])
    log("serve_int8", identical_runs=True, wall_s=wall, paged_launches=paged,
        pool_gb=engine.pool.pool_bytes() / 1e9, token_agreement_with_bf16=float(same))


def predictor_f32(ptt):
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.seed(1)
    cfg = dict(LLAMA3_8B, num_hidden_layers=1)
    model = LlamaForCausalLM(**cfg, device="cuda", dtype="float32").eval()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        prefix = inf.save_llm(model, os.path.join(tmp, "llama3_8b_1layer"))
        config = inf.Config(prefix)
        config.enable_llm_engine(max_new_tokens=8, max_seq_len=256, block_size=16, max_batch=4)
        pred = inf.create_predictor(config)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rng = np.random.RandomState(2)
    lens = [5, 17, 33, 64]
    ids = np.zeros((4, max(lens)), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, cfg["vocab_size"], n)
    pred.get_input_handle("input_ids").copy_from_cpu(ids)
    pred.get_input_handle("seq_lens").copy_from_cpu(np.asarray(lens))
    pred.run()
    got = pred.get_output_handle("generated_ids").copy_to_cpu()
    for i, n in enumerate(lens):
        cur = ids[i, :n].tolist()
        for _ in range(8):  # the saved weights are exactly `model`'s (f32 round trip)
            with torch.inference_mode():
                cur.append(int(model(torch.tensor([cur], device="cuda"))[0, -1].argmax()))
        if got[i].tolist() != cur[n:]:
            raise AssertionError(f"predictor ids {got[i].tolist()} != oracle {cur[n:]}")
    log("predictor_f32", prompts=len(lens), new_tokens=8, ids_equal_oracle=True)


# ---------------------------------------------------------------------------
# training kernels
# ---------------------------------------------------------------------------

def causal_pairs(b, sq, sk, h, causal) -> int:
    """Visible (query, key) pairs over all heads."""
    off = sk - sq
    return b * h * (sum(min(sk, i + 1 + off) for i in range(sq)) if causal else sq * sk)


def check_flash_bwd(ta, gen, name, b, sq, sk, h, hkv, d, dtype, causal, dropout_p=0.0,
                    use_lse=False, timed=False):
    """Gradients through the flash wrapper the main path calls (its
    autograd backward launches the dq and dk/dv kernels once each) against
    (a) the plain backward on the same saved tensors and (b) autograd
    through the plain forward."""
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    q, k, v, do = rn(b, sq, h, d), rn(b, sk, hkv, d), rn(b, sk, hkv, d), rn(b, sq, h, d)
    g_lse = torch.randn(b, h, sq, generator=gen, device="cuda") if use_lse else None
    scale, seed = 1.0 / math.sqrt(d), 1234
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = dict(ta.LAUNCHES)
    out, lse = ta.flash_attention_bshd_lse(*leaves, causal=causal, dropout_p=dropout_p,
                                           dropout_seed=seed)
    outs, cots = ([out, lse], [do, g_lse]) if use_lse else ([out], [do])
    got = torch.autograd.grad(outs, leaves, cots)
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv"):
        if ta.LAUNCHES[kname] != before[kname] + 1:
            raise AssertionError(f"{name}: {kname} was not launched exactly once")
    out, lse = out.detach(), lse.detach()
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    if use_lse:
        delta = delta - g_lse
    delta = delta.contiguous()
    args = (q, k, v, do, lse, delta, causal, scale, dropout_p, seed)
    want = ta._flash_bwd_plain(*args)
    pl = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out_p, lse_p = ta._flash_plain(*pl, causal, scale, dropout_p, seed)
    want_ag = torch.autograd.grad([out_p, lse_p] if use_lse else [out_p], pl, cots)
    del out_p, lse_p, pl
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    rec = dict(case=name, variant={kn: ta.kernel_variant(kn, dtype, d)
                                   for kn in ("flash_bwd_dq", "flash_bwd_dkdv")})
    for gname, gg, w, wa in zip(("dq", "dk", "dv"), got, want, want_ag):
        rec[gname] = compare(f"{name} {gname} vs plain backward", gg, w,
                             TOL["f32_grad" if f32 else "bf16_grad"])
        rel = ((gg.float() - wa.float()).norm() / wa.float().norm()).item()
        rec[gname + "_vs_autograd_rel_l2"] = rel
        if not rel <= GRAD_VS_AUTOGRAD_REL[dtype]:
            raise AssertionError(f"{name} {gname}: kernel vs autograd of the plain forward, "
                                 f"relative L2 {rel} > {GRAD_VS_AUTOGRAD_REL[dtype]}")
    rec["max_abs_err"] = max(rec[g]["max_abs_err"] for g in ("dq", "dk", "dv"))
    log("kernel flash_bwd", **rec)
    if not timed:
        return rec, rec
    pairs = causal_pairs(b, sq, sk, h, causal)
    dq_out = torch.empty_like(q)
    common = dict(plain_ms=time_ms(lambda: ta._flash_bwd_plain(*args), iters=3, warmup=1))
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out_l = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    common["library_ms"] = time_ms(lambda: torch.autograd.grad(out_l, (qt, kt, vt), dot,
                                                               retain_graph=True))
    del out_l
    bnd_dq, by_dq = bound_ms(6.0 * pairs * d, nbytes(q, k, v, do, lse, delta, dq_out), dtype)
    bnd_kv, by_kv = bound_ms(8.0 * pairs * d, nbytes(q, k, v, do, lse, delta, k, v), dtype)
    dq_rec = dict(max_abs_err=rec["dq"]["max_abs_err"], ms=time_ms(lambda: ta._flash_bwd_dq_cuda(*args)),
                  bound_ms=bnd_dq, bound_by=by_dq, variant=rec["variant"]["flash_bwd_dq"], **common)
    if dq_rec["variant"] != "cuda_core":
        # the earlier (CUDA-core) dq kernel on the same inputs, straight through
        # its C entry point (variant 0), outside the wrapper and its count
        from paddle_tpu_torch.ops.kernels import build
        use_drop = dropout_p > 0.0
        cc_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   delta.data_ptr(), dq_out.data_ptr(), 1, b, sq, sk, h, hkv, d, int(causal),
                   scale, int(use_drop), seed, ta._keep_threshold(dropout_p) if use_drop else 0,
                   1.0 / (1.0 - dropout_p), 0)
        dq_rec["cuda_core_ms"] = time_ms(lambda: build.check(build.function("flash_bwd_dq")(
            *cc_args, torch.cuda.current_stream().cuda_stream), "flash_bwd_dq (CUDA core)"),
            iters=5, warmup=1)
    kv_rec = dict(max_abs_err=max(rec["dk"]["max_abs_err"], rec["dv"]["max_abs_err"]),
                  ms=time_ms(lambda: ta._flash_bwd_dkdv_cuda(*args)), bound_ms=bnd_kv,
                  bound_by=by_kv, variant=rec["variant"]["flash_bwd_dkdv"], **common)
    log("kernel flash_bwd timing", case=name, variant=rec["variant"], dq=dq_rec, dkdv=kv_rec,
        note="plain_ms and library_ms are for the pair (dq, dk, dv together)")
    return dq_rec, kv_rec


ADAMW_CASES = [  # (name, moment2 dtype, decoupled, wd, clip scale)
    ("f32 m2, AdamW wd 0.01, clip 0.37", torch.float32, True, 0.01, 0.37),
    ("bf16 m2, AdamW wd 0.01, clip 1", torch.bfloat16, True, 0.01, 1.0),
    ("bf16 m2, Adam (coupled) wd 0.01, clip 0.37", torch.bfloat16, False, 0.01, 0.37),
]


ADAMW_SEED = 0x9E3779B9  # above 2^31: the uint32 path
ADAMW_SLICE = 64 * 2 ** 20  # elements per plain-version call on a large bucket
# the smallest depth at the Llama-3-8B width whose one bucket passes 2^31
# elements (2.23e9): the kernel's 64-bit offsets and a uint32 hash index >= 2^31
LARGE_BUCKET_LAYERS = 9


def adamw_bucket(gen, n, m2_dtype, pad):
    rn = lambda: torch.randn(n, generator=gen, device="cuda")
    p, g, m = rn() * 0.02, rn() * 1e-3, rn() * 1e-4
    v = (rn() * 1e-4).square().to(m2_dtype)
    for t in (p, g, m, v):
        t[n - pad:] = 0  # padding lanes, as the engine pads a bucket
    return p, m, v, g


def adamw_diff(got, want) -> dict:
    """Differences of the kernel's (p, m, v) from the plain version's."""
    (p, m, v), (wp, wm, wv) = got, want
    rel = lambda a, b: ((a.float() - b.float()).abs() / b.float().abs().clamp_min(1e-30)).max().item()
    d = dict(p_max_abs_err=(p - wp).abs().max().item(), p_max_rel_err=rel(p, wp),
             m_max_abs_err=(m - wm).abs().max().item(), m_max_rel_err=rel(m, wm))
    if v.dtype == torch.bfloat16:
        kb, wb = v.view(torch.int16).int(), wv.view(torch.int16).int()
        d.update(v_bits_equal=int((kb == wb).sum()), v_elems=v.numel(),
                 v_max_ulp_diff=(kb - wb).abs().max().item())
    else:
        d["v_max_rel_err"] = rel(v, wv)
    return d


def judge_adamw(name, diffs, padding_zero, **fields) -> dict:
    """Merge the differences of a bucket's slices and hold them to the
    limits: p, m and an f32 v within one f32 ulp; a bf16 v's bits equal
    except where the f32 v' differs by an ulp (share >= 99.99%), every
    element within one bf16 ulp; padding lanes zero."""
    rec = dict(case=name, **fields)
    for d in diffs:
        for k, x in d.items():
            rec[k] = rec.get(k, 0) + x if k in ("v_bits_equal", "v_elems") else max(rec.get(k, x), x)
    if "v_elems" in rec:
        rec["v_bits_equal_share"] = rec.pop("v_bits_equal") / rec.pop("v_elems")
        ok_v = rec["v_bits_equal_share"] >= 0.9999 and rec["v_max_ulp_diff"] <= 1
    else:
        ok_v = rec["v_max_rel_err"] <= ADAMW_F32_RTOL
    rec["padding_zero"] = padding_zero
    rec["max_abs_err"] = max(rec["p_max_abs_err"], rec["m_max_abs_err"])
    if not (ok_v and padding_zero and rec["p_max_rel_err"] <= ADAMW_F32_RTOL
            and rec["m_max_rel_err"] <= ADAMW_F32_RTOL):
        raise AssertionError(f"fused AdamW {name}: kernel disagrees with its plain version: {rec}")
    log("kernel fused_adamw", **rec)
    return rec


def check_fused_adamw(fo, gen, n=64 * 2 ** 20):
    """The wrapper (one launch) on a 64M-element bucket against the plain
    version, in each case of ADAMW_CASES."""
    pad = fo.PAD_ELEMS // 2
    c1, c2 = 1.0 - 0.9 ** 3, 1.0 - 0.999 ** 3
    for name, m2, decoupled, wd, clip in ADAMW_CASES:
        p, m, v, g = adamw_bucket(gen, n, m2, pad)
        hp = dict(beta1=0.9, beta2=0.999, eps=1e-8, wd=wd, decoupled=decoupled)
        scal = fo._scalars(1e-4, clip, c1, c2, "cuda")
        want = fo._reference_apply(p, m, v, g, scal, ADAMW_SEED, 0.9, 0.999, 1e-8, wd, decoupled,
                                   m2 == torch.bfloat16)
        before = fo.LAUNCHES["fused_adamw"]
        clip_t = torch.tensor(clip, device="cuda")  # a device scalar, as the clip gives it
        fo.fused_adamw_apply(p, m, v, g, lr=1e-4, clip_scale=clip_t, c1=c1, c2=c2, seed=ADAMW_SEED,
                             **hp)
        if fo.LAUNCHES["fused_adamw"] != before + 1:
            raise AssertionError(f"{name}: the wrapper did not launch the fused AdamW kernel once")
        torch.cuda.synchronize()
        padding_zero = all(bool((t[n - pad:] == 0).all()) for t in (p, m, v))
        judge_adamw(name, [adamw_diff((p, m, v), want)], padding_zero, n=n)
        del p, m, v, g, want


def train_bucket_elems(cfg) -> int:
    """Elements of the one flat bucket of a Llama (all params share a key)."""
    hdim, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    kv = hdim // cfg["num_attention_heads"] * cfg["num_key_value_heads"]
    layer = 2 * hdim * hdim + 2 * hdim * kv + 3 * hdim * f + 2 * hdim
    return 2 * v * hdim + cfg["num_hidden_layers"] * layer + hdim


def check_adamw_bucket(fo, gen, name, n_real, starts=None, timed=False):
    """The wrapper on a bucket of `n_real` elements as the training step
    calls it (bf16 m2, AdamW wd 0.01, clip 1; one launch), held against the
    plain version slice by slice, each slice hashed at its flat offset:
    every slice, or those that begin at `starts`.

    Timed: kernel, plain and library times. The plain version runs over the
    bucket in slices (one call would need ~60 GB of temporaries); the
    library call is torch._fused_adamw_ on the same f32 p, m, g with an f32
    v, as a list of the same slices."""
    n = fo.pad_to_tile(n_real)
    p, m, v, g = adamw_bucket(gen, n, torch.bfloat16, n - n_real)
    kw = dict(lr=1e-4, clip_scale=1.0, c1=1.0 - 0.9 ** 3, c2=1.0 - 0.999 ** 3, seed=ADAMW_SEED,
              beta1=0.9, beta2=0.999, eps=1e-8, wd=0.01, decoupled=True)
    hp = (ADAMW_SEED, 0.9, 0.999, 1e-8, 0.01, True, True)
    scal = fo._scalars(kw["lr"], 1.0, kw["c1"], kw["c2"], "cuda")
    starts = range(0, n, ADAMW_SLICE) if starts is None else starts
    saved = {i: tuple(t[i:i + ADAMW_SLICE].clone() for t in (p, m, v)) for i in starts}
    before = fo.LAUNCHES["fused_adamw"]
    fo.fused_adamw_apply(p, m, v, g, **kw)
    if fo.LAUNCHES["fused_adamw"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the fused AdamW kernel once")
    diffs = []
    for i in list(saved):
        s = slice(i, i + ADAMW_SLICE)
        want = fo._reference_apply(*saved.pop(i), g[s], scal, *hp, base=i)
        diffs.append(adamw_diff((p[s], m[s], v[s]), want))
        del want
    padding_zero = all(bool((t[n_real:] == 0).all()) for t in (p, m, v))
    rec = judge_adamw(name, diffs, padding_zero, n=n, slices_compared=len(diffs))
    if not timed:
        return rec

    def plain():
        for i in range(0, n, ADAMW_SLICE):
            s = slice(i, i + ADAMW_SLICE)
            fo._reference_apply(p[s], m[s], v[s], g[s], scal, *hp, base=i)

    v32 = v.float()
    parts = lambda t: list(t.split(ADAMW_SLICE))
    steps = [torch.tensor(3.0, device="cuda") for _ in parts(p)]
    lib = lambda: torch._fused_adamw_(parts(p), parts(g), parts(m), parts(v32), [], steps, lr=1e-4,
                                      beta1=0.9, beta2=0.999, weight_decay=0.01, eps=1e-8,
                                      amsgrad=False, maximize=False)
    bnd, by = bound_ms(20.0 * n, nbytes(p, m, v, g) + nbytes(p, m, v), torch.float32)
    rec = dict(rec, ms=time_ms(lambda: fo.fused_adamw_apply(p, m, v, g, **kw), iters=10, warmup=2),
               plain_ms=time_ms(plain, iters=2, warmup=1), library_ms=time_ms(lib, iters=10, warmup=2),
               bound_ms=bnd, bound_by=by, bytes_per_elem=(nbytes(p, m, v, g) + nbytes(p, m, v)) / n)
    log("kernel fused_adamw timing", n=n, ms=rec["ms"], plain_ms=rec["plain_ms"],
        library_ms=rec["library_ms"], bound_ms=bnd, bound_by=by, bytes_per_elem=rec["bytes_per_elem"],
        note="library: torch._fused_adamw_ with an f32 moment2 (28 B/elem), no bf16 form")
    return rec


def check_rms_norm(IF, gen, name, r, d, dtype, bias, w_dtype=None, timed=False):
    """x of `dtype`; weight and bias of `w_dtype` (x's by default)."""
    w_dtype = w_dtype or dtype
    x = torch.randn(r, d, generator=gen, device="cuda").to(dtype)
    w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype)
    b = (0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype) if bias else None
    before = IF.LAUNCHES["rms_norm"]
    got = IF.fused_rms_norm(x, w, b, epsilon=1e-6)
    if IF.LAUNCHES["rms_norm"] != before + 1:
        raise AssertionError(f"{name}: the wrapper did not launch the RMSNorm kernel exactly once")
    want = IF._rms_norm_ref(x, w, b, 1e-6)
    torch.cuda.synchronize()
    rec = dict(case=name, **compare(name, got, want, TOL["f32" if dtype == torch.float32 else "bf16"]))
    if timed:
        # a weight of another dtype than x takes torch's unfused rms_norm, which warns
        warnings.filterwarnings("ignore", message="Mismatch dtype between input and weight")
        bnd, by = bound_ms(4.0 * r * d, nbytes(x, w, got) + (nbytes(b) if bias else 0), dtype)
        kern = lambda: IF.fused_rms_norm(x, w, b, epsilon=1e-6)
        lib = None if bias else (lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6))
        # ms and library_ms: device time (CUDA graph); *_eager_ms: one call
        # from Python at a time, the host's overhead included
        rec.update(ms=time_graph_ms(kern), eager_ms=time_ms(kern),
                   plain_ms=time_ms(lambda: IF._rms_norm_ref(x, w, b, 1e-6)),
                   library_ms=lib and time_graph_ms(lib),
                   library_eager_ms=lib and time_ms(lib), bound_ms=bnd, bound_by=by)
    log("kernel rms_norm", **rec)
    return rec


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

# card vs CPU, tiny Llama in bf16 O1 (bf16 GEMMs round at other points on
# the two devices); measured on an H100: loss 2.7e-5, grads 0.018,
# params 3.84 lr at most and 0.0096 lr on average
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_REL = 5e-2  # per-tensor ||g_card - g_cpu|| / ||g_cpu|| of the step-1 grads
TRAIN_PARAM_MAX_OVER_LR = 4.4  # 2 steps, each at most a flipped update of ~lr (1.1 lr with bias correction)
TRAIN_PARAM_MEAN_OVER_LR = 0.05
TRAIN_LR = 1e-3


def train_step(ptt, model, opt, ids, labels):
    with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
        loss, _ = model(ids, labels=labels)
    loss.backward()
    opt.step()
    opt.clear_grad()
    return loss


def train_parity(ptt, ta, cfg):
    """A tiny Llama on the card (kernels) and on the CPU (plain versions)
    from the same weights and batch, 2 AMP-O1 fused-AdamW steps each."""
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(3)
    ref = LlamaForCausalLM(**cfg, device="cpu")
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(0, cfg["vocab_size"], (2, 64)))
    head_dim = cfg["hidden_size"] // cfg["num_attention_heads"]
    variant = {k: ta.kernel_variant(k, torch.bfloat16, head_dim)
               for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkdv")}
    runs = {}
    before = dict(ta.LAUNCHES)
    for dev in ("cuda", "cpu"):
        model = LlamaForCausalLM(**cfg, device="meta")
        model.load_state_dict({k: t.to(dev) for k, t in ref.state_dict().items()}, assign=True)
        opt = ptt.optimizer.AdamW(TRAIN_LR, parameters=model.parameters(), weight_decay=0.01,
                                  moment2_dtype="bfloat16")
        ptt.seed(11)  # the same stochastic-rounding seeds on both sides
        x = ids.to(dev)
        with ptt.amp.auto_cast(level="O1", dtype="bfloat16"):
            loss1, _ = model(x, labels=x)
        loss1.backward()
        grads = {n: p.grad.detach().float().cpu().clone() for n, p in model.named_parameters()}
        opt.step()
        opt.clear_grad()
        loss2 = train_step(ptt, model, opt, x, x)
        runs[dev] = dict(losses=[loss1.item(), loss2.item()], grads=grads,
                         params={n: p.detach().float().cpu() for n, p in model.named_parameters()})
    launches = {k: ta.LAUNCHES[k] - before[k] for k in variant}
    if any(n != 2 * cfg["num_hidden_layers"] for n in launches.values()):
        raise AssertionError(f"train_parity: flash launches {launches}, expected one per layer "
                             "per step on the card")
    card, cpu = runs["cuda"], runs["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(card["losses"], cpu["losses"]))
    grad_rel = max(((card["grads"][n] - g).norm() / g.norm().clamp_min(1e-30)).item()
                   for n, g in cpu["grads"].items())
    dp = torch.cat([(card["params"][n] - w).abs().reshape(-1) for n, w in cpu["params"].items()])
    rec = dict(losses_card=card["losses"], losses_cpu=cpu["losses"], loss_max_rel_err=loss_rel,
               grad_max_rel_l2_err=grad_rel, param_max_abs_diff_over_lr=dp.max().item() / TRAIN_LR,
               param_mean_abs_diff_over_lr=dp.mean().item() / TRAIN_LR,
               tol=dict(loss_rel=TRAIN_LOSS_RTOL, grad_rel_l2=TRAIN_GRAD_REL,
                        param_max_over_lr=TRAIN_PARAM_MAX_OVER_LR,
                        param_mean_over_lr=TRAIN_PARAM_MEAN_OVER_LR))
    # Adam normalises the gradient: where |g| is near its rounding noise
    # one step can move a param by up to lr either way, so the params are
    # held to two flipped updates at most, and on average to a small part of lr
    if not (loss_rel <= TRAIN_LOSS_RTOL and grad_rel <= TRAIN_GRAD_REL
            and rec["param_max_abs_diff_over_lr"] <= TRAIN_PARAM_MAX_OVER_LR
            and rec["param_mean_abs_diff_over_lr"] <= TRAIN_PARAM_MEAN_OVER_LR):
        raise AssertionError(f"train_parity: card and CPU runs disagree: {rec}")
    log("train_parity", layers=cfg["num_hidden_layers"], hidden=cfg["hidden_size"],
        head_dim=head_dim, variant=variant, launches=launches, steps=2, **rec)


def profile_train(ptt, model, opt, ids, step_ms, steps=2):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            train_step(ptt, model, opt, ids, ids)
        torch.cuda.synchronize()
    by_kind = {}
    for e in prof.key_averages():
        us = e.self_device_time_total
        if e.device_type != torch.autograd.DeviceType.CUDA or us <= 0:
            continue
        n = e.key.lower()
        kind = ("flash_fwd" if "flash_fwd" in n else
                "flash_bwd" if "flash_bwd" in n else
                "optimizer" if "fused_adamw" in n else
                "gemm" if any(t in n for t in ("gemm", "gemv", "nvjet", "xmma", "cutlass")) else
                "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
    busy = sum(by_kind.values())
    return dict(steps=steps, step_ms=step_ms,
                device_ms_per_step={k: round(v, 3) for k, v in sorted(by_kind.items())},
                device_busy_ms=busy if by_kind else None,
                device_idle_share=(1.0 - busy / step_ms) if by_kind else None)


def rms_norm_entry(ta, IF, state):
    """The fused_rms_norm entry point as a user calls it, forward and
    backward, at the Llama-3-8B width (4096 tokens x 4096, bf16): its own
    path, apart from training, where nn.RMSNorm runs the plain rms_norm
    as in the JAX package."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(1, TRAIN_SEQ, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    x.requires_grad_(True)
    w = torch.nn.Parameter((1.0 + 0.1 * torch.randn(4096, generator=gen, device="cuda")))
    g_out = torch.randn(1, TRAIN_SEQ, 4096, generator=gen, device="cuda").to(torch.bfloat16)
    ta.reset_launch_counts()
    out = IF.fused_rms_norm(x, w)
    out.backward(g_out)
    torch.cuda.synchronize()
    launches = IF.LAUNCHES["rms_norm"]
    ok = (launches == 1 and out.shape == x.shape and out.dtype == torch.bfloat16
          and all(bool(torch.isfinite(t).all()) for t in (out, x.grad, w.grad)))
    if not ok:
        raise AssertionError(f"rms_norm_entry: launches {launches}, or a non-finite output/grad")
    state["rms_norm_launches"] = {"rms_norm": launches}
    # the same inputs and output cotangent through the plain version and autograd
    xr, wr = (t.detach().clone().requires_grad_(True) for t in (x, w))
    want = IF._rms_norm_ref(xr, wr, None, 1e-6)
    want.backward(g_out)
    tol = TOL["bf16"]
    rec = dict(out=compare("rms_norm_entry out", out.detach(), want.detach(), tol),
               dx=compare("rms_norm_entry dx", x.grad, xr.grad, tol),
               dw=compare("rms_norm_entry dw", w.grad[None], wr.grad[None], tol))
    log("rms_norm_entry", shape=list(x.shape), x_dtype="bfloat16", w_dtype="float32",
        launches=launches, grads_finite=True, **rec)


TRAIN_PER_STEP = {"flash_fwd": TRAIN_LAYERS, "flash_bwd_dq": TRAIN_LAYERS,
                  "flash_bwd_dkdv": TRAIN_LAYERS, "fused_adamw": 1}


def train_bf16(ptt, ta, state, steps=5):
    from paddle_tpu_torch.models.llama import LlamaForCausalLM

    cfg = dict(LLAMA3_8B, num_hidden_layers=TRAIN_LAYERS)
    ptt.set_flags({"FLAGS_fused_optimizer": True})
    ptt.seed(0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = LlamaForCausalLM(**cfg, device="cuda")
    opt = ptt.optimizer.AdamW(1e-4, parameters=model.parameters(), weight_decay=0.01,
                              moment2_dtype="bfloat16")
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg["vocab_size"], (1, TRAIN_SEQ))).cuda()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the main path: every count 0 before it, read after it. Step 1 also
    # builds the optimizer bucket, so ms/step is timed over steps 2..N.
    ta.reset_launch_counts()
    losses, per_step = [], []
    for i in range(steps):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        before = dict(ta.LAUNCHES)
        losses.append(train_step(ptt, model, opt, ids, ids))
        per_step.append({k: ta.LAUNCHES[k] - before[k] for k in TRAIN_PER_STEP})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
    launches = dict(ta.LAUNCHES)
    losses = [x.item() for x in losses]
    if any(d != TRAIN_PER_STEP for d in per_step):
        raise AssertionError(f"train_bf16: launches per step {per_step} != {TRAIN_PER_STEP}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"train_bf16: losses not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = profile_train(ptt, model, opt, ids, step_ms)
    state["train_launches"] = launches
    log("train_bf16", layers=TRAIN_LAYERS, seq=TRAIN_SEQ, batch=1,
        params_b=sum(p.numel() for p in model.parameters()) / 1e9, init_s=init_s,
        losses=losses, ms_per_step=step_ms, tokens_per_sec=TRAIN_SEQ / (step_ms / 1e3),
        peak_mem_gb=peak, launches=launches, launches_per_step=per_step[0])
    log("train_bf16 profile", **prof)
    del model, opt
    torch.cuda.empty_cache()



def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="build,kernels,serve_bf16,serve_int8,predictor_f32,"
                                        "train_parity,train_bf16,rms_norm_entry",
                    help="comma list of phases to run (default: all)")
    phases = set(ap.parse_args(argv).phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import attention as ta
    from paddle_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    log("env", python=sys.version.split()[0], torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 products in full f32 (the default)
    ptt.set_device("cuda")

    t0 = time.perf_counter()
    logs = build.build(force=True)
    log("build", seconds=time.perf_counter() - t0,
        ptxas={k: ptxas_summary(v) for k, v in logs.items()})

    state: dict = {}
    records = {}
    if "kernels" in phases:
        gen = torch.Generator(device="cuda").manual_seed(0)
        bf = torch.bfloat16
        timed = [check_flash(ta, gen, f"bf16 causal B1 S{s} H32/8 D128{note}", 1, s, s, 32, 8, 128,
                             bf, True, timed=True)
                 for s, note in ((1024, " (serve prefill)"), (2048, ""), (4096, " (train)"))]
        records["flash_fwd"] = dict(timed[0], by_shape=[
            {k: r[k] for k in ("case", "variant", "ms", "plain_ms", "library_ms", "bound_ms",
                               "max_abs_err")} for r in timed])
        check_flash(ta, gen, "bf16 causal B2 Sq300 Sk777 H32/8 D128 (ragged tiles)", 2, 300, 777,
                    32, 8, 128, bf, True)
        check_flash(ta, gen, "bf16 causal B2 S2048 H32/8 D128", 2, 2048, 2048, 32, 8, 128, bf, True)
        check_flash(ta, gen, "bf16 dropout p=0.1 seed 1234 S256 H8/2 D128 causal", 1, 256, 256, 8, 2,
                    128, bf, True, dropout_p=0.1)
        for causal in (True, False):
            check_flash(ta, gen, f"bf16 {'causal' if causal else 'non-causal'} B2 S512 H12/12 D64 "
                        "(ERNIE heads)", 2, 512, 512, 12, 12, 64, bf, causal, timed=causal)
        check_flash(ta, gen, "bf16 causal S256 H8/2 D96 (a head dim of the CUDA-core variant only)",
                    1, 256, 256, 8, 2, 96, bf, True)
        check_flash(ta, gen, "f32 S40 H4/4 D64 non-causal", 2, 40, 40, 4, 4, 64, torch.float32, False)
        check_flash(ta, gen, "f32 dropout p=0.1 seed 1234 S256 H8/2 D128 causal", 1, 256, 256, 8, 2,
                    128, torch.float32, True, dropout_p=0.1)
        records["paged_attn"] = paged_checks(ta, gen)
        records["flash_bwd_dq"], records["flash_bwd_dkdv"] = check_flash_bwd(
            ta, gen, "bf16 causal B1 S4096 H32/8 D128 (train)", 1, 4096, 4096, 32, 8, 128,
            torch.bfloat16, True, timed=True)
        check_flash_bwd(ta, gen, "bf16 causal B1 Sq300 Sk777 H32/8 D128 (ragged tiles)", 1, 300,
                        777, 32, 8, 128, bf, True)
        check_flash_bwd(ta, gen, "bf16 causal B1 Sq301 Sk777 H32/8 D128 (Sq % 4 != 0)", 1, 301,
                        777, 32, 8, 128, bf, True)
        check_flash_bwd(ta, gen, "bf16 causal B2 S2048 H32/8 D128", 2, 2048, 2048, 32, 8, 128, bf,
                        True)
        check_flash_bwd(ta, gen, "bf16 dropout p=0.1 S256 H8/2 D128 causal", 1, 256, 256, 8, 2, 128,
                        bf, True, dropout_p=0.1)
        check_flash_bwd(ta, gen, "bf16 causal S256 H8/2 D128, loss on out and lse", 1, 256, 256, 8, 2,
                        128, bf, True, use_lse=True)
        for causal in (True, False):
            check_flash_bwd(ta, gen, f"bf16 {'causal' if causal else 'non-causal'} B2 S512 H12/12 "
                            "D64 (ERNIE heads)", 2, 512, 512, 12, 12, 64, bf, causal, timed=causal)
        check_flash_bwd(ta, gen, "bf16 dropout p=0.1 B1 S333 H4/4 D64 causal", 1, 333, 333, 4, 4, 64,
                        bf, True, dropout_p=0.1)
        check_flash_bwd(ta, gen, "bf16 causal S256 H8/2 D96 (a head dim of the CUDA-core variant "
                        "only)", 1, 256, 256, 8, 2, 96, bf, True)
        check_flash_bwd(ta, gen, "f32 dropout p=0.1 S256 H8/2 D128 causal", 1, 256, 256, 8, 2, 128,
                        torch.float32, True, dropout_p=0.1)
        check_flash_bwd(ta, gen, "f32 S40 H4/4 D64 non-causal", 2, 40, 40, 4, 4, 64, torch.float32,
                        False)
        check_flash_bwd(ta, gen, "f32 causal S128 H4/2 D64, loss on out and lse", 1, 128, 128, 4, 2,
                        64, torch.float32, True, use_lse=True)
        from paddle_tpu_torch.incubate.nn import functional as IF
        from paddle_tpu_torch.ops import fused_optimizer as fo

        check_fused_adamw(fo, gen)
        n_train = train_bucket_elems(dict(LLAMA3_8B, num_hidden_layers=TRAIN_LAYERS))
        records["fused_adamw"] = check_adamw_bucket(
            fo, gen, f"bf16 m2, AdamW wd 0.01, the {TRAIN_LAYERS}-layer training bucket", n_train,
            timed=True)
        torch.cuda.empty_cache()
        n_large = train_bucket_elems(dict(LLAMA3_8B, num_hidden_layers=LARGE_BUCKET_LAYERS))
        check_adamw_bucket(fo, gen, f"bf16 m2, AdamW wd 0.01, a {LARGE_BUCKET_LAYERS}-layer bucket "
                           "(past 2^31 elements): the slices across 2^31 and the last",
                           n_large, starts=[2 ** 31 - ADAMW_SLICE // 2, 2 ** 31 + ADAMW_SLICE // 2,
                                            fo.pad_to_tile(n_large) - ADAMW_SLICE])
        torch.cuda.empty_cache()
        rms = [check_rms_norm(IF, gen, "bf16 R4096 D4096, f32 weight (the entry point's types)",
                              4096, 4096, torch.bfloat16, False, w_dtype=torch.float32, timed=True),
               check_rms_norm(IF, gen, "bf16 R4096 D4096", 4096, 4096, torch.bfloat16, False,
                              timed=True)]
        records["rms_norm"] = dict(rms[0], by_shape=[
            {k: r[k] for k in ("case", "ms", "eager_ms", "plain_ms", "library_ms",
                               "library_eager_ms", "bound_ms", "max_abs_err")} for r in rms])
        check_rms_norm(IF, gen, "bf16 R4096 D4096 bias", 4096, 4096, torch.bfloat16, True, timed=True)
        check_rms_norm(IF, gen, "f32 R4096 D4096", 4096, 4096, torch.float32, False)
        check_rms_norm(IF, gen, "bf16 R333 D1032 (ragged R)", 333, 1032, torch.bfloat16, True)
        check_rms_norm(IF, gen, "bf16 R64 D16392 bias (wide rows)", 64, 16392, torch.bfloat16,
                       True)
        torch.cuda.empty_cache()
    if "serve_bf16" in phases:
        model = serve_bf16(ptt, ta, state)
        if "serve_int8" in phases:
            serve_int8(ta, model, state)
        del model
        torch.cuda.empty_cache()
    if "predictor_f32" in phases:
        predictor_f32(ptt)
    if "train_parity" in phases:
        for cfg in (TINY_LLAMA, TINY_LLAMA_D64):
            train_parity(ptt, ta, cfg)
    if "train_bf16" in phases:
        train_bf16(ptt, ta, state)
    if "rms_norm_entry" in phases:
        from paddle_tpu_torch.incubate.nn import functional as IF

        rms_norm_entry(ta, IF, state)

    k = "paddle_tpu_torch/ops/kernels/"
    sources = {
        "flash_fwd": (k + "flash_fwd.cu", "paddle_tpu/ops/pallas.py:427"),
        "paged_attn": (k + "paged_attn.cu", "paddle_tpu/ops/pallas.py:961"),
        "flash_bwd_dq": (k + "flash_bwd.cu", "paddle_tpu/ops/pallas.py:609 (pallas_call :649)"),
        "flash_bwd_dkdv": (k + "flash_bwd.cu", "paddle_tpu/ops/pallas.py:609 (pallas_call :687)"),
        "fused_adamw": (k + "fused_adamw.cu", "paddle_tpu/ops/fused_optimizer.py:140"),
        "rms_norm": (k + "rms_norm.cu", "paddle_tpu/incubate/nn/functional/__init__.py:67"),
    }
    by_path = {"serve_bf16": state.get("launches", {}), "train_bf16": state.get("train_launches", {}),
               "fused_rms_norm": state.get("rms_norm_launches", {})}
    kernels = []
    for name, (src, replaces) in sources.items():
        rec = records.get(name, {})
        counts = {path: c[name] for path, c in by_path.items() if name in c}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=sum(counts.values()) if counts else None, launches_by_path=counts,
            max_abs_err=rec.get("max_abs_err"), ms=rec.get("ms"), plain_ms=rec.get("plain_ms"),
            bound_ms=rec.get("bound_ms"), bound_by=rec.get("bound_by"),
            library_ms=rec.get("library_ms"), variant=rec.get("variant", "cuda_core"),
            **({"by_shape": rec["by_shape"]} if "by_shape" in rec else {})))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
