"""A card-vs-CPU parity phase of chip_smoke.py (amp_parity, resnet_parity,
...) over several reference seeds: how far the card's runs land from the
CPU's as the tiny model's initial weights change. One JSON line a seed:
the phase's records, the last the failing one when it fails.

    python3 tools/parity_seeds.py --phase amp_parity [--tree DIR] [--seeds 3,4,5]

The phases seed their reference weights with 3; this runs them with each
seed in its place. --tree runs another checkout's chip_smoke.py and
package (a parent unpacked with `git archive`), so two trees compare in
one call. Needs the card, as chip_smoke.py does.
"""
from __future__ import annotations

import argparse
import ast
import inspect
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phase", required=True)
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--seeds", default="3,4,5,6,7,8,9,10")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    import chip_smoke as cs
    import paddle_tpu_torch as ptt
    from paddle_tpu_torch.ops import attention as ta
    from paddle_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("parity_seeds: CUDA is not available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptt.set_device("cuda")
    build.build(force=True)
    phase = getattr(cs, args.phase)
    call_args = (ptt, ta)[:len(inspect.signature(phase).parameters)]
    seed = ptt.seed
    for s in (int(v) for v in args.seeds.split(",")):
        recs = []
        ptt.seed = lambda v, s=s: seed(s if v == 3 else v)
        cs.log = lambda name, **fields: recs.append(fields)
        failed = False
        try:
            phase(*call_args)
        except AssertionError as e:  # the failing record; the phase's later cases do not run
            failed = True
            msg = str(e)
            recs.append(ast.literal_eval(msg[msg.index("{"):]))
        finally:
            ptt.seed = seed
            ptt.set_device("cuda")
        print(json.dumps({"tree": args.tree, "phase": args.phase, "ref_seed": s, "failed": failed,
                          "records": recs}, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
