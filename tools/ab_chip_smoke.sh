#!/bin/sh
# Parent against change on one card, in turns (A B B A): chip_smoke.py's
# given phases run from the parent's tree, from this tree, from this tree
# again, and from the parent's again, each run headed "=== parent" or
# "=== change".
#   git archive <parent> | tar -x -C .ab_parent      (a directory .gitignore lists)
#   sh tools/ab_chip_smoke.sh .ab_parent train_bf16,ernie_seq128
set -e
parent=$1
phases=$2
here=$(pwd)
for side in parent change change parent; do
    echo "=== $side"
    if [ "$side" = parent ]; then cd "$parent"; else cd "$here"; fi
    python3 chip_smoke.py --phases "$phases"
    cd "$here"
done
