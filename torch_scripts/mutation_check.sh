#!/usr/bin/env bash
# Does chip_smoke.py's kernel check bite?  Needs an NVIDIA GPU and nvcc.
#
#     bash torch_scripts/mutation_check.sh
#
# Copies the repository into a temporary directory once per case: unchanged,
# and with one kernel broken:
#   forward   scale   the softmax scale taken for the padded head dim (48)
#                     instead of the real one (40);
#             stale   one K/V tile's copy skipped, so that its shared-memory
#                     stage is stale;
#   backward  dqscale the final scale of dq dropped;
#             delta   delta = rowsum(dO * O) dropped from ds in the dq kernel;
#             dvp     p^T taken 10 % too small in the dk/dv kernel.
# Each copy runs the bf16 check of chip_smoke.py at three self-attention
# shapes: the forward check at the serving shapes, the training check (forward
# with logsumexp, dq, dk/dv) at the train step's shapes with a peaked softmax.
# The unchanged copy must print no "CAUGHT", each broken copy three; the
# script fails otherwise.  The repository itself is never modified.
set -euo pipefail
repo="$(cd "$(dirname "$0")/.." && pwd)"
fwd=celebbasis_tpu_torch/csrc/flash_attention_fwd.cu
bwd=celebbasis_tpu_torch/csrc/flash_attention_bwd.cu
check_fwd='import chip_smoke as c, torch
for a in [(4, 8, 4096, 4096, 40), (4, 8, 1024, 1024, 80), (4, 8, 256, 256, 160)]:
    try:
        c.check_shape("flash_attention_nhd", *a, torch.bfloat16, False)
    except RuntimeError:
        print("CAUGHT", a)
'
check_bwd='import chip_smoke as c, torch
for a in [(2, 8, 4096, 4096, 40), (2, 8, 1024, 1024, 80), (2, 8, 256, 256, 160)]:
    try:
        c.check_train_shape("nhd", *a, torch.bfloat16, False, q_scale=4.0)
    except RuntimeError:
        print("CAUGHT", a)
'
for mutation in none scale stale dqscale delta dvp; do
  work="$(mktemp -d)"
  cp -r "$repo/." "$work"
  rm -rf "$work/celebbasis_tpu_torch/_build"
  src=$bwd
  case $mutation in
    scale) src=$fwd; sed -i 's/const float scale_log2 = p.scale \* kLog2e;/const float scale_log2 = p.scale * kLog2e * 0.9129f;/' "$work/$src" ;;
    stale) src=$fwd; sed -i 's/auto load_kv = \[&\](int t) {/auto load_kv = [\&](int t) { if (t == 3) return;/' "$work/$src" ;;
    dqscale) sed -i 's/dq_acc\[j\]\[2 \* r\] \* p.scale/dq_acc[j][2 * r]/; s/dq_acc\[j\]\[2 \* r + 1\] \* p.scale/dq_acc[j][2 * r + 1]/' "$work/$src" ;;
    delta) sed -i 's/s\[j\]\[e\] = pv \* (dp\[j\]\[e\] - dl\[e >> 1\]);/s[j][e] = pv * dp[j][e];/' "$work/$src" ;;
    dvp) sed -i 's/sT\[j\]\[e\] = pv; /sT[j][e] = pv * 0.9f; /' "$work/$src" ;;
  esac
  echo "== mutation: $mutation"
  if [ $mutation != none ] && cmp -s "$repo/$src" "$work/$src"; then
    echo "the mutation did not apply"; exit 1
  fi
  case $mutation in
    none) out="$(cd "$work" && python3 -c "$check_fwd" && python3 -c "$check_bwd")" ;;
    scale|stale) out="$(cd "$work" && python3 -c "$check_fwd")" ;;
    *) out="$(cd "$work" && python3 -c "$check_bwd")" ;;
  esac
  echo "$out"
  caught=$(grep -c '^CAUGHT' <<<"$out" || true)
  rm -rf "$work"
  if [ $mutation = none ] && [ "$caught" != 0 ]; then echo "FAIL: a right kernel was refused"; exit 1; fi
  if [ $mutation != none ] && [ "$caught" != 3 ]; then echo "FAIL: a broken kernel passed"; exit 1; fi
done
echo "mutation check: ok"
