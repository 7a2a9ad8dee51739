#!/usr/bin/env bash
# Does chip_smoke.py's kernel check bite?  Needs an NVIDIA GPU and nvcc.
#
#     bash torch_scripts/mutation_check.sh [case ...]
#
# Copies the repository into a temporary directory once per case (all cases
# when none is named): unchanged ("none"), and with one kernel broken:
#   forward   scale   the softmax scale taken for the padded head dim (48)
#                     instead of the real one (40);
#             stale   one K/V tile's copy skipped, so that its shared-memory
#                     stage is stale;
#   backward  dqscale the final scale of dq dropped;
#             delta   delta = rowsum(dO * O) dropped from ds in the dq kernel;
#             dvp     p^T taken 10 % too small in the dk/dv kernel;
#             split   the first query split's partial sums left out of the
#                     dk/dv reduction;
#   geglu     erf     the exact (erf) GELU in place of the tanh form, in the
#                     bf16 kernel only;
#             residual  x dropped from x + GEGLU(LN(x));
#   int8      rowscale  the activation scale taken from the row's first
#                     64-value K tile instead of the whole row.
# Each copy runs the bf16 check of chip_smoke.py at three shapes: the forward
# check at the serving shapes, the training check (forward with logsumexp,
# dq, dk/dv) at the train step's shapes with a peaked softmax (for "split":
# at the three 77-key training shapes, whose dk/dv splits the query stream
# over 8, 8 and 4 blocks), the GEGLU
# block check and the int8 check at the serving shapes of the 64^2, 32^2 and
# 16^2 levels.  The unchanged copy must print no "CAUGHT", each broken copy
# three; the script fails otherwise.  The repository itself is never
# modified.
set -euo pipefail
repo="$(cd "$(dirname "$0")/.." && pwd)"
fwd=celebbasis_tpu_torch/csrc/flash_attention_fwd.cu
bwd=celebbasis_tpu_torch/csrc/flash_attention_bwd.cu
ffn=celebbasis_tpu_torch/csrc/geglu.cu
i8=celebbasis_tpu_torch/csrc/int8_matmul.cu
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
check_split='import chip_smoke as c, torch
for a in [(2, 8, 4096, 77, 40), (2, 8, 1024, 77, 80), (2, 8, 256, 77, 160)]:
    try:
        c.check_train_shape("nhd", *a, torch.bfloat16, False)
    except RuntimeError:
        print("CAUGHT", a)
'
check_geglu='import chip_smoke as c, torch
for a in [(16384, 320), (4096, 640), (1024, 1280)]:
    try:
        c.check_geglu("geglu_block", *a, torch.bfloat16, False)
    except RuntimeError:
        print("CAUGHT", a)
'
check_int8='import chip_smoke as c, torch
for a in [(16384, 320, 2560), (4096, 640, 640), (1024, 1280, 1280)]:
    try:
        c.check_int8(*a, torch.bfloat16, False)
    except RuntimeError:
        print("CAUGHT", a)
'
cases="${*:-none scale stale dqscale delta dvp split erf residual rowscale}"
for mutation in $cases; do
  work="$(mktemp -d)"
  cp -r "$repo/." "$work"
  rm -rf "$work/celebbasis_tpu_torch/_build"
  src=$bwd
  case $mutation in
    scale) src=$fwd; sed -i 's/const float scale_log2 = p.scale \* kLog2e;/const float scale_log2 = p.scale * kLog2e * 0.9129f;/' "$work/$src" ;;
    stale) src=$fwd; sed -i 's/auto load_kv = \[&\](int t) {/auto load_kv = [\&](int t) { if (t == 3) return;/' "$work/$src" ;;
    dqscale) sed -i 's/dq\[4 \* j + 2 \* r\] \* p.scale/dq[4 * j + 2 * r]/; s/dq\[4 \* j + 2 \* r + 1\] \* p.scale/dq[4 * j + 2 * r + 1]/' "$work/$src" ;;
    delta) sed -i 's/sc\[4 \* j + e\] = pv \* (dp\[4 \* j + e\] - dl\[e >> 1\]);/sc[4 * j + e] = pv * dp[4 * j + e];/' "$work/$src" ;;
    dvp) sed -i 's/sT\[4 \* j + e\] = pv; /sT[4 * j + e] = pv * 0.9f; /' "$work/$src" ;;
    split) sed -i 's/for (int s = 0; s < splits; ++s) {/for (int s = 1; s < splits; ++s) {/' "$work/$src" ;;
    erf) src=$ffn; sed -i 's/y\[e\] = hv \* gelu_tanh(gv);/y[e] = hv * gv * normcdff(gv);/' "$work/$src" ;;
    residual) src=$ffn; sed -i 's/v = to_f32(static_cast<const T\*>(p.x)\[row \* p.x_s + col\]) + acc;/v = acc;/' "$work/$src" ;;
    rowscale) src=$i8; sed -i 's/for (int k = lane; k < K; k += 32) amax/for (int k = lane; k < min(K, 64); k += 32) amax/' "$work/$src" ;;
  esac
  echo "== mutation: $mutation"
  if [ $mutation != none ] && cmp -s "$repo/$src" "$work/$src"; then
    echo "the mutation did not apply"; exit 1
  fi
  case $mutation in
    none) out="$(cd "$work" && python3 -c "$check_fwd" && python3 -c "$check_bwd" && python3 -c "$check_split" && python3 -c "$check_geglu" && python3 -c "$check_int8")" ;;
    scale|stale) out="$(cd "$work" && python3 -c "$check_fwd")" ;;
    erf|residual) out="$(cd "$work" && python3 -c "$check_geglu")" ;;
    rowscale) out="$(cd "$work" && python3 -c "$check_int8")" ;;
    split) out="$(cd "$work" && python3 -c "$check_split")" ;;
    *) out="$(cd "$work" && python3 -c "$check_bwd")" ;;
  esac
  echo "$out"
  caught=$(grep -c '^CAUGHT' <<<"$out" || true)
  rm -rf "$work"
  if [ $mutation = none ] && [ "$caught" != 0 ]; then echo "FAIL: a right kernel was refused"; exit 1; fi
  if [ $mutation != none ] && [ "$caught" != 3 ]; then echo "FAIL: a broken kernel passed"; exit 1; fi
done
echo "mutation check: ok"
