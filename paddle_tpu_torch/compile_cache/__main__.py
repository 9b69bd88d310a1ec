"""`python -m paddle_tpu_torch.compile_cache` (counterpart of
paddle_tpu/compile_cache/__main__.py and tools/compile_cache.py).

    python -m paddle_tpu_torch.compile_cache report [--input DUMP] [--json]
    python -m paddle_tpu_torch.compile_cache stats  [--dir DIR]
    python -m paddle_tpu_torch.compile_cache verify [--dir DIR]
    python -m paddle_tpu_torch.compile_cache gc     [--dir DIR] --max-bytes N

- `report`: the engine-load -> first-token decomposition of a ledger dump
  (`ledger.dump_json(path)`); `--json` prints the raw report dict. Exits
  1 when the dump holds no engine window.
- `stats`: entry count, bytes and a per-origin breakdown of the store.
- `verify`: every entry through the marker + CRC checks a restore makes;
  exits 1 when one is corrupt.
- `gc`: drop corrupt entries, then evict the least recently used until
  the store fits `--max-bytes`.

`--dir` defaults to $PADDLE_TPU_COMPILE_CACHE_DIR; stats, verify and gc
print one JSON document.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

from . import ledger, report
from .store import ENV_DIR, CompileCacheStore


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.compile_cache",
        description="compile-cache cold-start report and store maintenance",
    )
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--dir", default=None, help=f"cache directory (default: ${ENV_DIR})")
    sub = p.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("report", help="cold-start timeline from a ledger dump")
    rp.add_argument("--input", "-i", default=None,
                    help="ledger dump path (default: the live in-process ledger)")
    rp.add_argument("--json", action="store_true", help="emit the raw dict")
    sub.add_parser("stats", parents=[common], help="entry count / bytes / per-origin breakdown")
    sub.add_parser("verify", parents=[common],
                   help="CRC+marker check every entry; exit 1 on any corrupt entry")
    gp = sub.add_parser("gc", parents=[common],
                        help="drop corrupt entries, evict LRU to fit a byte budget")
    gp.add_argument("--max-bytes", type=int, required=True,
                    help="payload budget; 0 empties the cache")
    args = p.parse_args(argv)

    if args.cmd == "report":
        data = None
        if args.input:
            try:
                data = ledger.load_dump(args.input)
            except (OSError, ValueError) as e:
                print(f"compile_cache: unreadable dump {args.input}: {e}", file=sys.stderr)
                return 2
        rep = report.cold_start_report(data)
        print(json.dumps(rep, indent=1, sort_keys=True) if args.json
              else report.format_report(rep))
        return 0 if rep.get("available") else 1

    root = args.dir or os.environ.get(ENV_DIR)
    if not root:
        print(f"compile_cache: no cache dir (pass --dir or set {ENV_DIR})", file=sys.stderr)
        return 2
    st = CompileCacheStore(root)
    if args.cmd == "stats":
        print(json.dumps(st.stats(), indent=1, sort_keys=True))
        return 0
    if args.cmd == "verify":
        rep = st.verify()
        print(json.dumps(rep, indent=1, sort_keys=True))
        return 0 if not rep.get("corrupt") else 1
    print(json.dumps(st.gc(max_bytes=args.max_bytes), indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
