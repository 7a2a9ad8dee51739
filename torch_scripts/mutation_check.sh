#!/usr/bin/env bash
# Does chip_smoke.py's kernel check bite?  Needs an NVIDIA GPU and nvcc.
#
#     bash torch_scripts/mutation_check.sh [case ...]
#
# Copies the repository into a temporary directory once per case (all cases
# when none is named): unchanged ("none"), and with one kernel broken:
#   forward   scale   the softmax scale taken for the padded head dim (48)
#                     instead of the real one (40);
#             stale   the fourth K/V tile of every query tile's stream not
#                     loaded (its stage's full barrier arrived at without
#                     the TMA load), so that the stage is stale;
#             rescale the running output's rescale by the new row max
#                     dropped in consumer warpgroup 0;
#   backward  dqscale the final scale of dq dropped;
#             delta   delta = rowsum(dO * O) dropped from ds in the dq kernel;
#             dvp     p^T taken 10 % too small in the dk/dv kernel;
#             split   the first query split's partial sums left out of the
#                     dk/dv reduction;
#   geglu     erf     the exact (erf) GELU in place of the tanh form, in the
#                     bf16 kernel only;
#             residual  x dropped from x + GEGLU(LN(x));
#             peer    the y piece of the blocks of column slice 1 left out of
#                     the cluster's exchange (they send another piece in its
#                     place, so that no barrier waits forever);
#             gsplit  the first inner split's partial sums left out of the
#                     reduction (geglu_finish);
#   int8      rowscale  the activation scale taken from the row's first 64
#                     values instead of the whole row (both quantisers);
#             i8order the dequantisation taken as acc * (xs * ws) instead of
#                     (acc * xs) * ws;
#             i8stage the second ring stage of every block read from the
#                     stage after it, whose full barrier was not waited on;
#   strides   dqstride dq written with the strides of a contiguous
#                     (B, H, N, D) tensor (o's) instead of its own: the
#                     (B, N, H, D) order that torch.empty_like gives a per-head
#                     view of the AttentionBlock's interleaved projection
#                     (ops/flash_attention.py; every write stays in bounds);
#   model     qkvswap the legacy UNet's AttentionBlock takes its q and k
#                     slices of the interleaved [head][q|k|v][dh] projection
#                     the wrong way round (models/unet.py: every shape
#                     stays right).  On the CPU,
#                     tests/test_torch_legacy_models.py::
#                     test_attention_block_and_legacy_resblocks fails on the
#                     same edit (run it in a copy: the case's sed below).
# Each copy runs the bf16 check of chip_smoke.py at three shapes: the forward
# check at the serving shapes, the training check (forward with logsumexp,
# dq, dk/dv) at the train step's shapes with a peaked softmax (for "split":
# at the three 77-key training shapes, whose dk/dv splits the query stream
# over 8, 8 and 4 blocks), the GEGLU block check at the serving shapes of
# the 64^2, 32^2 and 16^2 levels (for "peer": the 32^2, 16^2 and mid levels,
# whose clusters hold 2, 4 and 4 blocks over the output columns; for
# "gsplit": the 16^2 and mid serving levels and the 16^2 training level,
# whose inner dimension the plan splits), and the int8 check (every mode
# that can run the shape) at the serving shapes of the 64^2 FF-in
# projection and the 32^2 and 16^2 q/k/v/out ones, and for "qkvswap" the
# legacy phase's AttentionBlock check (chip_smoke.check_attention_block) on
# the CelebA-HQ UNet's blocks at 32^2, 16^2 and 8^2, and for "dqstride" the
# training check on the interleaved views at the CelebA-HQ train step's
# three AttentionBlock shapes (batch 48, D = 32).  The unchanged copy must print no "CAUGHT", each broken copy
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
check_peer='import chip_smoke as c, torch
for a in [(4096, 640), (1024, 1280), (256, 1280)]:
    try:
        c.check_geglu("geglu_block", *a, torch.bfloat16, False)
    except RuntimeError:
        print("CAUGHT", a)
'
check_gsplit='import chip_smoke as c, torch
from celebbasis_tpu_torch.ops import geglu
for a in [(1024, 1280), (256, 1280), (512, 1280)]:
    assert geglu.plan(torch.device("cuda"), torch.bfloat16, *a, 4 * a[1])["splits"] > 1, a
    try:
        c.check_geglu("geglu_block", *a, torch.bfloat16, False)
    except RuntimeError:
        print("CAUGHT", a)
'
check_qkv='import chip_smoke as c, os, torch, yaml
from celebbasis_tpu_torch import legacy
with open(os.path.join(c.LEGACY_CONFIGS, "celebahq-ldm-vq-4.yaml")) as f:
    ldm = legacy.prepare(yaml.safe_load(f), seed=0)
for blk, side in c.celebahq_attention_blocks(ldm):
    try:
        c.check_attention_block(blk, side)
    except RuntimeError:
        print("CAUGHT", side)
'
check_strided='import chip_smoke as c, torch
for a in c.LEGACY_TRAIN_SHAPES[:3]:
    B, H, N, D, layout = a
    try:
        c.check_train_shape(layout, B, H, N, N, D, torch.bfloat16, False)
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
cases="${*:-none scale stale rescale dqscale delta dvp split erf residual peer gsplit rowscale i8order i8stage qkvswap dqstride}"
for mutation in $cases; do
  work="$(mktemp -d)"
  cp -r "$repo/." "$work"
  rm -rf "$work/celebbasis_tpu_torch/_build"
  src=$bwd
  case $mutation in
    scale) src=$fwd; sed -i 's/const float scale_log2 = p.scale \* kLog2e;/const float scale_log2 = p.scale * kLog2e * 0.9129f;/' "$work/$src" ;;
    stale) src=$fwd; sed -i 's/mbar_arrive_tx(&full\[s\], 2 \* BN \* kPanelRowBytes \* P.panels);/if (t == 3) { mbar_arrive(\&full[s]); continue; } mbar_arrive_tx(\&full[s], 2 * BN * kPanelRowBytes * P.panels);/' "$work/$src" ;;
    rescale) src=$fwd; sed -i 's/for (int i = 0; i < DP \/ 2; ++i) o\[i\] \*= alpha\[(i >> 1) \& 1\];/if (wg != 0) for (int i = 0; i < DP \/ 2; ++i) o[i] *= alpha[(i >> 1) \& 1];/' "$work/$src" ;;
    dqscale) sed -i 's/dq\[4 \* j + 2 \* r\] \* p.scale/dq[4 * j + 2 * r]/; s/dq\[4 \* j + 2 \* r + 1\] \* p.scale/dq[4 * j + 2 * r + 1]/' "$work/$src" ;;
    delta) sed -i 's/sc\[4 \* j + e\] = pv \* (dp\[4 \* j + e\] - dl\[e >> 1\]);/sc[4 * j + e] = pv * dp[4 * j + e];/' "$work/$src" ;;
    dvp) sed -i 's/sT\[4 \* j + e\] = pv; /sT[4 * j + e] = pv * 0.9f; /' "$work/$src" ;;
    split) sed -i 's/for (int s = 0; s < splits; ++s) {/for (int s = 1; s < splits; ++s) {/' "$work/$src" ;;
    erf) src=$ffn; sed -i 's/gelu_tanh_fast(\(g\[[01]\] + bg\.[xy]\))/(\1) * normcdff(\1)/g' "$work/$src" ;;
    residual) src=$ffn; sed -i 's/v = to_f32(static_cast<const T\*>(p.x)\[row \* p.x_s + col\]) + acc;/v = acc;/' "$work/$src" ;;
    peer) src=$ffn; sed -i 's/sY + piece, kYPieceBytes,/sY + (kr == 1 ? 0 : piece), kYPieceBytes,/' "$work/$src" ;;
    gsplit) src=$ffn; sed -i 's/float acc = p.part\[i\];/float acc = 0.f;/' "$work/$src" ;;
    rowscale) src=$i8; sed -i 's/if (vi < vend) amax = fmaxf(amax, absmax_vec<T>(v\[j\]));/if (vi < vend \&\& vi * (16 \/ (int)sizeof(T)) < 64) amax = fmaxf(amax, absmax_vec<T>(v[j]));/' "$work/$src" ;;
    i8order) src=$i8; sed -i 's/((float)(int)(acc\[0\]\[e\] + acc\[1\]\[e\]) \* sx\[h\]) \* ws\[j\]\.x/(float)(int)(acc[0][e] + acc[1][e]) * (sx[h] * ws[j].x)/' "$work/$src" ;;
    qkvswap) src=celebbasis_tpu_torch/models/unet.py; sed -i 's/for i in range(3))/for i in (1, 0, 2))/' "$work/$src" ;;
    dqstride) src=celebbasis_tpu_torch/ops/flash_attention.py; sed -i 's/_stride_array((q, k, v, do, dq), num_heads)/_stride_array((q, k, v, do, o), num_heads)/' "$work/$src" ;;
    i8stage) src=$i8; sed -i 's/const unsigned char\* st = ring + s \* p.stage_bytes;/const unsigned char* st = ring + (it == 1 ? (s + 1) % S : s) * p.stage_bytes;/' "$work/$src" ;;
  esac
  echo "== mutation: $mutation"
  if [ $mutation != none ] && cmp -s "$repo/$src" "$work/$src"; then
    echo "the mutation did not apply"; exit 1
  fi
  case $mutation in
    none) out="$(cd "$work" && python3 -c "$check_fwd" && python3 -c "$check_bwd" && python3 -c "$check_split" && python3 -c "$check_geglu" && python3 -c "$check_peer" && python3 -c "$check_gsplit" && python3 -c "$check_int8" && python3 -c "$check_qkv" && python3 -c "$check_strided")" ;;
    qkvswap) out="$(cd "$work" && python3 -c "$check_qkv")" ;;
    dqstride) out="$(cd "$work" && python3 -c "$check_strided")" ;;
    scale|stale|rescale) out="$(cd "$work" && python3 -c "$check_fwd")" ;;
    erf|residual) out="$(cd "$work" && python3 -c "$check_geglu")" ;;
    peer) out="$(cd "$work" && python3 -c "$check_peer")" ;;
    gsplit) out="$(cd "$work" && python3 -c "$check_gsplit")" ;;
    rowscale|i8order|i8stage) out="$(cd "$work" && python3 -c "$check_int8")" ;;
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
