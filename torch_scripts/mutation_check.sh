#!/usr/bin/env bash
# Does chip_smoke.py's kernel check bite?  Needs an NVIDIA GPU and nvcc.
#
#     bash torch_scripts/mutation_check.sh
#
# Copies the repository into a temporary directory three times: unchanged,
# with the softmax scale taken for the padded head dim (48) instead of the
# real one (40), and with one K/V tile's copy skipped so that its shared-memory
# stage is stale.  Each copy runs the bf16 check of chip_smoke.py at three
# self-attention shapes of the serving path.  The unchanged copy must print
# "ok" three times, each broken copy "CAUGHT" three times; the script fails
# otherwise.  The repository itself is never modified.
set -euo pipefail
repo="$(cd "$(dirname "$0")/.." && pwd)"
src=celebbasis_tpu_torch/csrc/flash_attention_fwd.cu
check='import chip_smoke as c, torch
for a in [(4, 8, 4096, 4096, 40), (4, 8, 1024, 1024, 80), (4, 8, 256, 256, 160)]:
    try:
        c.check_shape("flash_attention_nhd", *a, torch.bfloat16, False)
    except RuntimeError:
        print("CAUGHT", a)
'
for mutation in none scale stale; do
  work="$(mktemp -d)"
  cp -r "$repo/." "$work"
  rm -rf "$work/celebbasis_tpu_torch/_build"
  case $mutation in
    scale) sed -i 's/const float scale_log2 = p.scale \* kLog2e;/const float scale_log2 = p.scale * kLog2e * 0.9129f;/' "$work/$src" ;;
    stale) sed -i 's/auto load_kv = \[&\](int t) {/auto load_kv = [\&](int t) { if (t == 3) return;/' "$work/$src" ;;
  esac
  echo "== mutation: $mutation"
  if [ $mutation != none ] && cmp -s "$repo/$src" "$work/$src"; then
    echo "the mutation did not apply"; exit 1
  fi
  out="$(cd "$work" && python3 -c "$check")"
  echo "$out"
  caught=$(grep -c '^CAUGHT' <<<"$out" || true)
  rm -rf "$work"
  if [ $mutation = none ] && [ "$caught" != 0 ]; then echo "FAIL: the right kernel was refused"; exit 1; fi
  if [ $mutation != none ] && [ "$caught" != 3 ]; then echo "FAIL: a broken kernel passed"; exit 1; fi
done
echo "mutation check: ok"
