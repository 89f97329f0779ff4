#!/bin/bash
# Phase 4 of chip_smoke.py (the full-width bf16 serving drive) for two
# checkouts in turns on one GPU: OTHER, this one, this one, OTHER. Each run
# builds its own checkout's kernels and prints its tok/s, wall time, stream
# TTFTs and launch counts. Compare two versions only within one call: the
# drive is host-bound and its wall time varies from run to run.
#
# Usage, from the repository root (OTHER: e.g. `git archive` of the parent
# unpacked under build/):
#
#     bash scripts/ab_phase4.sh OTHER
set -u
other=${1:?usage: scripts/ab_phase4.sh OTHER_CHECKOUT}
echo "card: $(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader)"
drive='import chip_smoke as c
from lumen_tpu_torch.ops.cuda_build import build_all
build_all(c.all_kernels())
r = c.drive_serving(0, c.card_line())
print("RESULT tok/s", r["tok_s"], "wall_s", r["wall_s"], "ttft_ms", r["ttft_ms"], "launches", r["launches"])'
rc=0
for who in other this this other; do
  if [ "$who" = other ]; then dir=$other; else dir=.; fi
  echo "== $who ($dir)"
  (cd "$dir" && python3 -c "$drive" 2>&1 | grep -E "RESULT|phase 4: |Error") || rc=1
done
exit $rc
