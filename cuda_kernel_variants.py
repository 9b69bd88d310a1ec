#!/usr/bin/env python3
"""Compare design variants of the port's hand-written CUDA kernels on one card.

    python3 cuda_kernel_variants.py [--rms-norm-baseline PATH] [--paged-baseline PATH]
                                    [--only paged_attn,flash_bwd_dq,rms_norm]

Each variant is a committed kernel source built by
`paddle_tpu_torch.ops.kernels.build.build_variants` with one of the
macros the source leaves open (`-DPTT_DQ_STAGES=2`, ...), or another
source of the same C interface, and called through its C entry point on
the same inputs as the committed kernel. Every variant is first held
against the plain PyTorch version (chip_smoke.py's TOL); the times are
then taken in turns, the list forward and then backward, within this one
run. One JSON line per comparison, beside the card's name and power limit.

  flash_bwd_dq  bf16 causal B1 S4096 H32/8 D128 (the training shape): the
                committed tensor-core kernel (64-key tiles, 3 stages)
                against 2 and 4 stages, 128-key tiles (2 stages: 3 do not
                fit in shared memory) and the CUDA-core kernel.
                Event-timed.
  rms_norm      bf16 R4096 D4096 with an f32 and a bf16 weight: the
                committed kernel (128 threads a CTA) against 64, 256 and
                512 threads, the kernel of --rms-norm-baseline (for example
                the rms_norm.cu of an earlier commit, unpacked with `git
                archive`), F.rms_norm and a plain copy of the same bytes
                (x.clone()). Device time through CUDA graphs.
  paged_attn    decode Q1 at chip_smoke's PAGED_CTX (bf16 and int8 pages)
                and at uniform contexts of 1000 (bf16): the committed kernel
                (the planned split, ops.attention.paged_split_plan; a ring of
                at most 2 stages) against fixed pages a split (an argument
                of the C entry point: 8, 16, 26, 32, and 128, one split and no
                merge), other ring depths
                (PTT_PAGED_STAGES 3, 4, 6) and the kernel of --paged-baseline
                (for example the earlier one-CTA-per-(b, kv head) paged_attn.cu,
                unpacked with `git archive` under .smoke/; its C interface
                has no workspace or plan arguments). Device time through CUDA
                graphs over a rotation of pools whose touched K/V exceed the
                L2 twice (chip_smoke.cold_pools), so every call is cold.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import warnings

import torch

import chip_smoke as cs


def build_variants(build, lib: str, variants: dict, kernel: str, keep: str) -> dict:
    """{label: ctypes entry point `kernel`} of each variant of library
    `lib`; logs each one's ptxas registers and spills (lines with `keep`)."""
    fns = {}
    for label, (so, log) in build.build_variants(lib, variants).items():
        cs.log(f"variant build {lib}", variant=label,
               ptxas=[ln for ln in cs.ptxas_summary(log) if keep in ln])
        fns[label] = build.bind(so, kernel)
    return fns


def in_turns(calls: dict, timer) -> dict:
    """Each call timed twice: the list forward, then backward."""
    times = {name: [] for name in calls}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            times[name].append(timer(calls[name]))
    return times


def compare_dq(ta, build, gen) -> None:
    fns = build_variants(build, "flash_bwd", {
        "2 stages": (None, {"PTT_DQ_STAGES": 2}),
        "4 stages": (None, {"PTT_DQ_STAGES": 4}),
        "128-key tiles, 2 stages": (None, {"PTT_DQ_KEYS": 128, "PTT_DQ_STAGES": 2}),
    }, "flash_bwd_dq", "dq_tc_kernel<128")
    b, s, h, hkv, d = 1, 4096, 32, 8, 128
    rn = lambda *shape: torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v, do = rn(b, s, h, d), rn(b, s, hkv, d), rn(b, s, hkv, d), rn(b, s, h, d)
    scale = d ** -0.5
    out, lse = ta._flash_cuda(q, k, v, True, scale, 0.0, 0)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta, True, scale, 0.0, 0)
    want = ta._flash_bwd_plain(*args)[0]

    def launcher(fn, variant):
        def call():
            dq = torch.empty_like(q)
            build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           delta.data_ptr(), dq.data_ptr(), 1, b, s, s, h, hkv, d, 1, scale, 0, 0, 0,
                           1.0, variant, torch.cuda.current_stream().cuda_stream),
                        "flash_bwd_dq variant")
            return dq
        return call

    calls = {"committed: 64-key tiles, 3 stages": lambda: ta._flash_bwd_dq_cuda(*args),
             **{name: launcher(fn, 1) for name, fn in fns.items()},
             "CUDA-core kernel": launcher(build.function("flash_bwd_dq"), 0)}
    errs = {name: cs.compare(f"dq {name}", call(), want, cs.TOL["bf16_grad"])["worst_row_rel_err"]
            for name, call in calls.items()}
    cs.log("variants flash_bwd_dq", case="bf16 causal B1 S4096 H32/8 D128", worst_row_rel_err=errs,
           ms=in_turns(calls, cs.time_ms))


def compare_rms(IF, build, gen, baseline) -> None:
    variants = {f"{n} threads": (None, {"PTT_RMS_THREADS": n}) for n in (64, 256, 512)}
    if baseline:
        variants["baseline"] = (baseline, {})
    fns = build_variants(build, "rms_norm", variants, "rms_norm", "rms_norm_kernel<bf16")
    r = d = 4096
    x = torch.randn(r, d, generator=gen, device="cuda").to(torch.bfloat16)
    # a weight of another dtype than x takes torch's unfused rms_norm, which warns
    warnings.filterwarnings("ignore", message="Mismatch dtype between input and weight")
    for w_dtype in (torch.float32, torch.bfloat16):
        w = (1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(w_dtype)
        want = IF._rms_norm_ref(x, w, None, 1e-6)

        def launcher(fn):
            def call():
                out = torch.empty_like(x)
                build.check(fn(x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 1,
                               0 if w_dtype == torch.float32 else 1, r, d, 1e-6,
                               torch.cuda.current_stream().cuda_stream), "rms_norm variant")
                return out
            return call

        kernels = {"committed: 128 threads": lambda: IF.fused_rms_norm(x, w),
                   **{name: launcher(fn) for name, fn in fns.items()}}
        errs = {name: cs.compare(f"rms_norm {name}", call(), want, cs.TOL["bf16"])["worst_row_rel_err"]
                for name, call in kernels.items()}
        calls = dict(kernels, **{"F.rms_norm": lambda: torch.nn.functional.rms_norm(x, (d,), w, 1e-6),
                                 "copy of the same bytes": lambda: x.clone()})
        cs.log("variants rms_norm", case=f"bf16 R{r} D{d}, {str(w_dtype)[6:]} weight",
               baseline=baseline, worst_row_rel_err=errs,
               device_ms=in_turns(calls, cs.time_graph_ms))


# the C interface of the paged kernel before split-K (no workspace or plan)
_PAGED_BASELINE_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                        + [ctypes.c_float, ctypes.c_void_p])


def profile_split(call, n: int = 20) -> dict:
    """Device microseconds a call by kernel name (torch.profiler, n calls
    on one pool: warm)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / n for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def compare_paged(ta, build, gen, baseline) -> None:
    variants = {f"{n} stages": (None, {"PTT_PAGED_STAGES": n}) for n in (3, 4, 6)}
    if baseline:
        variants["baseline"] = (baseline, {})
    fns = build_variants(build, "paged_attn", variants, "paged_attn", "paged_attn")
    base = fns.pop("baseline", None)
    if base is not None:
        base.argtypes = _PAGED_BASELINE_ARGS
    code = ta._DTYPE_CODE
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def entry(fn, split_pages):
        """The committed C interface of `fn`, called as the wrapper calls it."""
        def call(q, pool, bt, qpos):
            kp, vp, sc = pool
            b, qn, h, d = q.shape
            plan = ta.paged_split_plan(b, qn, h, kp.shape[2], d, bt.shape[1],
                                       ta._sm_count(torch.cuda.current_device()), kp.dtype,
                                       split_pages)
            out = torch.empty_like(q)
            ws = torch.empty(max(plan["workspace_floats"], 1), device="cuda")
            ks, vs = sc.get("k_scales"), sc.get("v_scales")
            build.check(fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr() if sc else None,
                           vs.data_ptr() if sc else None, bt.data_ptr(), qpos.data_ptr(),
                           out.data_ptr(), ws.data_ptr(), code[q.dtype], code[kp.dtype], b, qn, h,
                           kp.shape[2], d, kp.shape[1], bt.shape[1], plan["split_pages"],
                           plan["rows_per_cta"], d ** -0.5, stream()), "paged_attn variant")
            return out
        return call

    def baseline_call(q, pool, bt, qpos):
        kp, vp, sc = pool
        b, qn, h, d = q.shape
        out = torch.empty_like(q)
        ks, vs = sc.get("k_scales"), sc.get("v_scales")
        build.check(base(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr() if sc else None,
                         vs.data_ptr() if sc else None, bt.data_ptr(), qpos.data_ptr(),
                         out.data_ptr(), code[q.dtype], code[kp.dtype], b, qn, h, kp.shape[2], d,
                         kp.shape[1], bt.shape[1], d ** -0.5, stream()), "paged_attn baseline")
        return out

    committed = build.function("paged_attn")
    kernels = {"committed: the planned split, <= 2 stages": entry(committed, None),
               **{f"{n} pages a split": entry(committed, n) for n in (8, 16, 26, 32, 128)},
               **{name: entry(fn, None) for name, fn in fns.items()}}
    if base is not None:
        kernels["baseline"] = baseline_call
    for label, kv, ctx in (("bf16", None, cs.PAGED_CTX), ("bf16", None, cs.PAGED_CTX_UNIFORM),
                           ("int8 pages", torch.int8, cs.PAGED_CTX)):
        q, pool, bt, qpos = cs.paged_inputs(gen, 1, kv, torch.bfloat16, ctx)
        want = ta.paged_extend_reference(q, pool[0], pool[1], bt, qpos, **pool[2])
        tol = cs.TOL["int8" if kv == torch.int8 else "bf16"]
        errs = {name: cs.compare(f"paged {name}", call(q, pool, bt, qpos), want, tol)["worst_row_rel_err"]
                for name, call in kernels.items()}
        pools = cs.cold_pools(gen, pool, qpos)
        timer = lambda call: cs.time_graph_ms(
            cs.rotated(lambda pl: call(q, pl, bt, qpos), pools), reps=4 * len(pools))
        kv_bytes = cs.paged_kv_bytes(pool, qpos)
        split = profile_split(lambda: kernels["committed: the planned split, <= 2 stages"](
            q, pool, bt, qpos))
        plan = ta.paged_split_plan(8, 1, 32, 8, 128, 128, ta._sm_count(torch.cuda.current_device()),
                                   pool[0].dtype)
        cs.log("variants paged_attn", case=f"decode Q1 B8 ctx {'/'.join(map(str, ctx))} bs16 {label}",
               committed_plan=plan, committed_us_by_kernel=split,
               baseline=baseline, pools_rotated=len(pools), touched_mb_per_call=kv_bytes / 1e6,
               kv_bound_ms=kv_bytes / cs.PEAK_BYTES * 1e3, worst_row_rel_err=errs,
               device_ms=in_turns(kernels, timer))
        del pools, pool
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rms-norm-baseline", default=None,
                    help="another rms_norm.cu with the same C interface, timed beside the committed one")
    ap.add_argument("--paged-baseline", default=None,
                    help="an earlier paged_attn.cu (the C interface without workspace and plan), "
                         "timed beside the committed one")
    ap.add_argument("--only", default="paged_attn,flash_bwd_dq,rms_norm",
                    help="comma list of the comparisons to run")
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not torch.cuda.is_available():
        print("cuda_kernel_variants: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 2
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.incubate.nn import functional as IF
    from paddle_tpu_torch.ops import attention as ta
    from paddle_tpu_torch.ops.kernels import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    ptt.set_device("cuda")
    build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    if "paged_attn" in only:
        compare_paged(ta, build, gen, args.paged_baseline)
        torch.cuda.empty_cache()
    if "flash_bwd_dq" in only:
        compare_dq(ta, build, gen)
        torch.cuda.empty_cache()
    if "rms_norm" in only:
        compare_rms(IF, build, gen, args.rms_norm_baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
