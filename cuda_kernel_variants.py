#!/usr/bin/env python3
"""Compare design variants of the port's hand-written CUDA kernels on one card.

    python3 cuda_kernel_variants.py [--rms-norm-baseline PATH]

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
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rms-norm-baseline", default=None,
                    help="another rms_norm.cu with the same C interface, timed beside the committed one")
    args = ap.parse_args(argv)
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
    compare_dq(ta, build, gen)
    torch.cuda.empty_cache()
    compare_rms(IF, build, gen, args.rms_norm_baseline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
