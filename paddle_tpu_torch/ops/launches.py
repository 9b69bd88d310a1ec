"""Launch counts of the hand-written kernels.

Each wrapper adds one to its kernel's count where it launches the kernel
and nowhere else, so a run can show that its main path went through the
kernels. One dict for every kernel of the port (`ops.attention.LAUNCHES`
is the same object).
"""
LAUNCHES = {"flash_fwd": 0, "paged_attn": 0, "flash_bwd_dq": 0, "flash_bwd_dkdv": 0,
            "fused_adamw": 0, "rms_norm": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
