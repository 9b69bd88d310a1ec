"""Launch counts of the hand-written kernels.

Each wrapper adds one to its kernel's count where it launches the kernel
and nowhere else, so a run can show that its main path went through the
kernels. One dict for every kernel of the port (`ops.attention.LAUNCHES`
is the same object). The flash kernels also count their launches by
storage type and variant in `LAUNCH_VARIANTS` ({(kernel, dtype name,
variant): count}), so a run shows which variant its main path ran.

`count_flops` is where a launch that no dispatch-level counter sees (a
kernel called through ctypes) reports its work to an active FLOP count
(profiler.perf_attribution.counting_flops); with none active it is one
list read.
"""
LAUNCHES = {"flash_fwd": 0, "paged_attn": 0, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0,
            "fused_adamw": 0, "rms_norm": 0}
LAUNCH_VARIANTS: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCH_VARIANTS.clear()


def count_launch(kernel: str, dtype=None, variant=None) -> None:
    """One launch of `kernel` (of a flash kernel: with its storage type and
    variant)."""
    LAUNCHES[kernel] += 1
    if variant is not None:
        key = (kernel, str(dtype).replace("torch.", ""), variant)
        LAUNCH_VARIANTS[key] = LAUNCH_VARIANTS.get(key, 0) + 1


# [running total] while a FLOP count is active, else [None]
FLOP_TALLY: list = [None]


def count_flops(n: float) -> None:
    """Add `n` FLOPs of a hand-written kernel's launch to the active count."""
    if FLOP_TALLY[0] is not None:
        FLOP_TALLY[0] += float(n)
