// Flash-attention forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces three Pallas TPU kernels of celebbasis_tpu/ops/flash_attention.py:
//   * _fwd_kernel_packed (via _forward_nhd, public flash_attention_nhd):
//     q/k/v/o as untransposed (B, N, H*D);
//   * _fwd_kernel_infer (via _forward(with_stats=False), public
//     flash_attention): q/k/v/o as (B, H, N, D);
//   * _fwd_kernel with stats (via _forward(with_stats=True), the forward of
//     the differentiated call): the same output plus, per query row, the
//     logsumexp of the scaled logits (fp32), which the backward kernels of
//     flash_attention_bwd.cu read.  It is the LSE = true instantiation of the
//     kernels below (entry flash_attention_fwd_lse); its output equals the
//     inference forward's bit for bit, the arithmetic being the same code.
// All compute, per (batch, head), softmax(q k^T * D^-0.5) v with an online
// softmax over key tiles, fp32 statistics and fp32 accumulators, and padded
// keys masked with -1e30.  One kernel serves both layouts: it takes base
// pointers plus the batch, head and row strides (in elements; the element
// stride along the head dim is 1), so the packed layout is read in place and
// the per-head layout is the same code with other strides.
//
// What bounds it on an H100.  For SD v1 self-attention at N = M = 4096,
// D = 40 the work is 4*N*M*D flop per head against 4*N*D*2 bytes of q, k, v
// and o: about 2000 flop per byte, far above the card's ~295 flop/byte ridge,
// so memory does not bound it -- provided the (N, M) score matrix never
// reaches device memory.  Two units could: the tensor cores (the products,
// with the head dim padded to 48 at D = 40) and the exponential unit (MUFU,
// 16 ex2 a clock per SM: one per score, which at D = 40 takes longer than
// the score's share of the products).  In practice the loop of one
// warpgroup is a chain of latencies (a product, then the softmax that needs
// it, then the next product that needs the softmax), so what decides the
// speed is how many such chains an SM runs side by side and how well their
// products and softmaxes interleave.
//
// What the design does about it (bf16; the head dim is padded to DP = 48,
// 80, 160 or 256 in shared memory only):
//   * both products are wgmma (m64nNk16, bf16 operands, fp32 accumulators):
//     S = q k^T with q as the register A operand (read from shared memory
//     once per query tile; from shared memory at DP = 256, where the (64,
//     256) fp32 accumulator leaves no room) and k K-major; O += P v with P
//     rounded to bf16 from the S accumulator as the register A operand and v
//     read MN-major from the same swizzled panels;
//   * a block is a producer and WG consumer warpgroups of 64 query rows
//     each: three at DP = 48 (160 registers each), two above (232 each;
//     three (64, DP) accumulators beside the S tiles would not fit), one
//     where blocks of 128 rows would fill at most half of the SMs (256 and
//     64 tokens).  The producer hands its registers to the consumers
//     (setmaxnreg) and one of its threads issues TMA loads
//     (cp.async.bulk.tensor from 4-D tensor maps, hopper.cuh): an item's q
//     rows, then a ring of K/V stages with a full and an empty mbarrier
//     each; no block-wide barrier in the loop.  A box of 16 columns reads
//     zeros past the head dim and past the last row, so the next head's
//     columns in the packed layout are never read as data;
//   * the products overlap the softmax twice over: inside a warpgroup, the
//     next tile's S = q k^T and this tile's O += P v are issued together and
//     the softmax of the new S runs while O += P v is still on the tensor
//     cores; across the warpgroups, they take turns to issue their products
//     (named barriers, round robin), so that one's softmax runs while the
//     others' products do.  Every step issues its products unconditionally:
//     a product issued under a branch leaves copies of its accumulators,
//     and ptxas then makes every wgmma wait for the one before it;
//   * the grid is persistent, one block per SM, so the producer loads the
//     next item's q, k and v while the consumers finish this one, and short
//     sequences (77 keys, one K/V tile) do not pay a load latency per
//     block.  With three warpgroups a block walks a contiguous range of
//     64-row query tiles (ranges differ by at most one tile), so that the
//     SMs finish together where whole 192-row items would leave the last
//     wave part-filled.  One host function (FwdPlan, plan_at) picks the
//     instantiation and the grid of a launch; flash_attention_fwd_plan
//     reports what it picks;
//   * tiles are static by head dim (FwdShape, FwdTiles,
//     flash_attention_fwd_config): 128 keys at DP = 48 and 80, 64 at 160 and
//     256, three K/V stages (two at 256); where all keys fit in one tile of
//     80 (M = 77, the cross-attention), a tile of 80 keys, so that no
//     exponentials and products are spent on 51 masked keys;
//   * the ragged last key tile is masked in registers (-1e30 on the raw
//     scores; the scale is positive), ragged query rows are zero-filled by
//     the TMA and never stored, and the epilogue stores only the columns
//     below D; log2(e) is folded into the scale (ex2.approx).
// fp32 inputs take a plain-FMA kernel with the same tiling idea, so that
// fp32 callers get fp32 products: wgmma has no fp32 products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu
// (flash_common.cuh and hopper.cuh beside it hold the helpers shared with
// the backward.)  Plain C interface at the bottom; no PyTorch headers.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kThreads = 128;   // the fp32 kernel
// The consumer warpgroups take turns to issue their products: named
// barriers kTurn .. kTurn + 2 (0 is __syncthreads); kSetUp orders the
// barriers' initialisation before the consumers' first wait.
constexpr int kTurn = 1, kSetUp = 4;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (B, H, N) contiguous; written only by the LSE variants
  int B, H, N, M, D;
  Strides qs, ks, vs, os;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma kernel, warp-specialised
// ---------------------------------------------------------------------------

// WG consumer warpgroups of 64 query rows each: two or three, which take
// turns on the tensor cores, or one where the grid of 128-row tiles would
// leave half of the SMs idle (256 and 64 tokens)
template <int DP, int BN, int WG>
struct FwdShape {
  static constexpr int BM = 64 * WG;              // query rows of a block
  static constexpr int STAGES = DP == 256 ? 2 : 3;   // K/V stages
  // q, the A operand of S = q k^T, stays in registers (where it fits beside
  // the (64, DP) accumulator)
  static constexpr bool A_REGS = DP <= 160;
  // + the producer: a warpgroup whose registers go to the consumers (one of
  // its threads issues the loads) beside two or three consumer warpgroups,
  // else a warp
  static constexpr int THREADS = 128 * WG + (WG >= 2 ? 128 : 32);
  static constexpr int PRODUCER_REGS = WG == 3 ? 24 : 40;
  static constexpr int CONSUMER_REGS = WG == 3 ? 160 : 232;
  static constexpr int Q_BYTES = BM * DP * 2;
  static constexpr int KV_BYTES = BN * DP * 2;    // a k or v tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 2) * 8;
  static_assert(SMEM <= 232448, "shared memory of one block");
};

// At a padded head dim: keys of a K/V tile, keys of the short tile taken
// when every key fits in it (0: none), and the consumer warpgroups of a
// block where the grid fills the card (three at 48, where the softmax of
// a 40-wide head costs as much as its products, and a third warpgroup's
// softmax overlaps two others' products; two above, where three (64, DP)
// accumulators and the S tiles do not fit in their registers)
template <int DP_>
struct FwdTiles {
  static constexpr int DP = DP_;
  static constexpr int BN = DP <= 80 ? 128 : 64;
  static constexpr int BN_SHORT = DP == 256 ? 0 : 80;
  static constexpr int WG = DP == 48 ? 3 : 2;
};

struct FwdBf16Params {
  TileMap q, k, v;
  Params p;
  int panels;   // 16-column panels a box covers: ceil(D / 16)
};

template <int DP, int BN, int WG, bool LSE>
__global__ void __launch_bounds__(FwdShape<DP, BN, WG>::THREADS, 1)
    flash_fwd_wgmma(const __grid_constant__ FwdBf16Params P) {
  using S = FwdShape<DP, BN, WG>;
  constexpr bool kPingPong = WG >= 2;
  constexpr int BM = S::BM, STAGES = S::STAGES, NP = DP / kPanel;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sKV = smem + S::Q_BYTES;   // [stage][k | v]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;

  const Params& p = P.p;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = warp_uniform(tid >> 5);
  const int n_tiles = (p.M + BN - 1) / BN;
  // The work: B * H * ceil(N / 64) query tiles of 64 rows, a head's tiles
  // consecutive (so that the blocks in flight share K/V in L2), taken in
  // items of up to WG tiles of one head; warpgroup w computes the item's
  // tile w, if it has one.  With three warpgroups a block owns a contiguous
  // range of tiles -- ranges differ by at most one tile, so that the SMs
  // finish together where items of three tiles would leave a last wave
  // part-filled -- and cuts it into items at head boundaries.  Otherwise a
  // block takes every gridDim.x-th item of WG tiles from a head's start:
  // with two tiles an item, a range's cuts would add items.
  constexpr bool kRanges = WG == 3;
  const int tpb = (p.N + 63) / 64, ipb = (tpb + WG - 1) / WG;
  const long long heads = (long long)p.B * p.H;
  const long long lo =
      kRanges ? heads * tpb * blockIdx.x / gridDim.x : blockIdx.x;
  const long long hi =
      kRanges ? heads * tpb * (blockIdx.x + 1) / gridDim.x : heads * ipb;
  // the item at `pos` (a tile, or an item): its head, first query row and
  // tiles; returns the next pos
  auto item_at = [&](long long pos, int& bh, int& q0, int& tiles) {
    if constexpr (kRanges) {
      bh = (int)(pos / tpb);
      const int tile = (int)(pos - (long long)bh * tpb);
      const long long left = hi - pos < tpb - tile ? hi - pos : tpb - tile;
      tiles = left < WG ? (int)left : WG;
      q0 = tile * 64;
      return pos + tiles;
    } else {
      bh = (int)(pos / ipb);
      const int tile = (int)(pos - (long long)bh * ipb) * WG;
      tiles = tpb - tile < WG ? tpb - tile : WG;
      q0 = tile * 64;
      return pos + gridDim.x;
    }
  };

  // The loading thread sets up the barriers and starts its loads at once;
  // the consumers wait for the set-up on a named barrier that the
  // producer's warps only arrive at, and zero the head-dim padding that no
  // load writes meanwhile.
  const int consumers = 128 * WG;
  if (warp == 4 * WG && lane == 0) {
    prefetch_tensormap(&P.q.map);
    prefetch_tensormap(&P.k.map);
    prefetch_tensormap(&P.v.map);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WG);   // one arrival per consumer warp
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * WG);
    mbar_init_fence();
  }
  if (warp >= 4 * WG) {   // the producer: one thread issues the loads
    __syncwarp();
    bar_arrive(kSetUp, S::THREADS);
    if constexpr (kPingPong) regs_dealloc<S::PRODUCER_REGS>();
    if (warp == 4 * WG && lane == 0) {
      int it = 0, local = 0;
      for (long long pos = lo; pos < hi; ++local) {
        int bh, q0, tiles;
        pos = item_at(pos, bh, q0, tiles);
        const int b = bh / p.H, h = bh - b * p.H;
        if (local > 0) mbar_wait(qempty, (local - 1) & 1);
        mbar_arrive_tx(qfull, BM * kPanelRowBytes * P.panels);
        load_panels(sQ, P.q, qfull, BM, q0, h, b, P.panels);
        for (int t = 0; t < n_tiles; ++t, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* sK = sKV + s * 2 * S::KV_BYTES;
          mbar_arrive_tx(&full[s], 2 * BN * kPanelRowBytes * P.panels);
          load_panels(sK, P.k, &full[s], BN, t * BN, h, b, P.panels);
          load_panels(sK + S::KV_BYTES, P.v, &full[s], BN, t * BN, h, b,
                      P.panels);
        }
      }
    }
    return;
  }

  if (P.panels < NP) {
    zero_padding<DP>(sQ, BM, P.panels, tid, consumers);
    for (int s = 0; s < 2 * STAGES; ++s)
      zero_padding<DP>(sKV + s * S::KV_BYTES, BN, P.panels, tid, consumers);
    fence_proxy_async();
  }
  bar_sync(kSetUp, S::THREADS);

  // consumer warpgroup `wg` owns query rows [64 wg, 64 wg + 64) of the
  // block's tile; this thread holds rows lane / 4 and lane / 4 + 8 of its
  // warp's 16, and columns 8 j + 2 (lane % 4) + {0, 1} of each 8
  if constexpr (kPingPong) regs_alloc<S::CONSUMER_REGS>();
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const float scale_log2 = p.scale * kLog2e;
  uint32_t aq[S::A_REGS ? NP : 1][4];
  uint32_t pa[BN / 16][4];   // P of the last tile, the A operand of P v
  float sc[BN / 2], o[DP / 2];

  if (kPingPong && wg == WG - 1) bar_arrive(kTurn, 256);   // 0 issues first
  int it = 0, local = 0;
  for (long long pos = lo; pos < hi; ++local) {
    int bh, q0, tiles;
    pos = item_at(pos, bh, q0, tiles);
    const int b = bh / p.H, h = bh - b * p.H;
    mbar_wait(qfull, local & 1);
    if (wg >= tiles) {
      // no query tile for this warpgroup in this item: it passes its turns
      // and releases q and the K/V stages in the order the others do
      if (lane == 0) mbar_arrive(qempty);
      for (int t = 0; t <= n_tiles; ++t) {
        const int cur = it + t;
        if (t < n_tiles) mbar_wait(&full[cur % STAGES], (cur / STAGES) & 1);
        if (kPingPong) bar_sync(kTurn + wg, 256);
        if (kPingPong) bar_arrive(kTurn + (wg + 1) % WG, 256);
        if (t > 0 && lane == 0) mbar_arrive(&empty[(cur - 1) % STAGES]);
      }
      it += n_tiles;
      continue;
    }
    float m_i[2] = {kNegInf, kNegInf};   // running max, log2 domain
    float l_i[2] = {0.f, 0.f};           // per-thread partial row sums
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sc[i] = 0.f;
    if constexpr (S::A_REGS) {
      load_a(aq, sQ, BM, wg * 64 + w * 16, lane);
      __syncwarp();
      if (lane == 0) mbar_arrive(qempty);   // q is in registers
    }

    // S = q k^T into sc, from the K half of `stage`
    auto issue_s = [&](int stage) {
      const unsigned char* sK = sKV + stage * 2 * S::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        if constexpr (S::A_REGS)
          Mma<BN>::template rs<0>(sc, aq[kk], desc_kmajor(sK, BN, 0, kk),
                                  kk > 0);
        else
          Mma<BN>::template ss<0>(sc, desc_kmajor(sQ, BM, wg * 64, kk),
                                  desc_kmajor(sK, BN, 0, kk), kk > 0);
      }
      wgmma_commit();
    };
    // O += P v, P from pa, v the V half of `stage`
    auto issue_pv = [&](int stage) {
      const unsigned char* sV =
          sKV + stage * 2 * S::KV_BYTES + S::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        Mma<DP>::template rs<1>(o, pa[kk], desc_mnmajor(sV, BN, kk, 0), 1);
      wgmma_commit();
    };
    // the online softmax of key tile t, in sc; returns each row's rescale
    // of the running output in alpha
    float alpha[2];
    auto softmax = [&](int t) {
      // mask the ragged last key tile (raw scores; the scale is positive)
      const int kbase = t * BN;
      if (kbase + BN > p.M) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kbase + j * 8 + t4 * 2 + (e & 1) >= p.M)
              sc[4 * j + e] = kNegInf;
      }
      // in the log2 domain, the scale folded into one FMA; four partial
      // maxima and sums a row, for shorter dependency chains
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx[4] = {kNegInf, kNegInf, kNegInf, kNegInf};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          mx[2 * (j & 1)] = fmaxf(mx[2 * (j & 1)], sc[4 * j + 2 * r]);
          mx[2 * (j & 1) + 1] =
              fmaxf(mx[2 * (j & 1) + 1], sc[4 * j + 2 * r + 1]);
        }
        float m = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float m_new = fmaxf(m_i[r], m * scale_log2);
        alpha[r] = exp2_approx(m_i[r] - m_new);
        m_i[r] = m_new;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const float p0 =
              exp2_approx(fmaf(sc[4 * j + 2 * r], scale_log2, -m_new));
          const float p1 =
              exp2_approx(fmaf(sc[4 * j + 2 * r + 1], scale_log2, -m_new));
          sc[4 * j + 2 * r] = p0;
          sc[4 * j + 2 * r + 1] = p1;
          sum[2 * (j & 1)] += p0;
          sum[2 * (j & 1) + 1] += p1;
        }
        l_i[r] = l_i[r] * alpha[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
      }
    };
    auto to_pa = [&] {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) acc_to_a(pa[kk], sc, kk);
    };
    auto release_q = [&](int t) {   // after the last product that reads q
      if (!S::A_REGS && t == n_tiles - 1 && lane == 0) mbar_arrive(qempty);
    };

    // Every step issues its products unconditionally (a product issued
    // under a branch leaves copies of its accumulators that ptxas answers
    // by serialising every wgmma), so the first S and the last P v are a
    // prologue and an epilogue of their own.  Step t issues S_t = q k_t^T
    // and O += P_{t-1} v_{t-1}, then runs the softmax of S_t while
    // O += P v is still on the tensor cores.
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    if (kPingPong) bar_sync(kTurn + wg, 256);
    wgmma_fence();
    issue_s(it % STAGES);
    if (kPingPong) bar_arrive(kTurn + (wg + 1) % WG, 256);
    wgmma_wait<0>();
    fence_regs(sc);
    release_q(0);
    softmax(0);
    to_pa();
    for (int t = 1; t < n_tiles; ++t) {
      const int cur = it + t, prev = cur - 1;
      mbar_wait(&full[cur % STAGES], (cur / STAGES) & 1);
      if (kPingPong) bar_sync(kTurn + wg, 256);
      wgmma_fence();
      issue_s(cur % STAGES);
      issue_pv(prev % STAGES);
      if (kPingPong) bar_arrive(kTurn + (wg + 1) % WG, 256);
      wgmma_wait<1>();
      fence_regs(sc);
      release_q(t);
      softmax(t);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(&empty[prev % STAGES]);
      // the running output to the new max, then P_t as the next A operand
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      to_pa();
    }
    {
      const int last = it + n_tiles - 1;
      if (kPingPong) bar_sync(kTurn + wg, 256);
      wgmma_fence();
      issue_pv(last % STAGES);
      if (kPingPong) bar_arrive(kTurn + (wg + 1) % WG, 256);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty[last % STAGES]);
    }
    it += n_tiles;

    // epilogue: finish the row sums across the four threads of a row,
    // divide, and store the rows and columns that exist
    __nv_bfloat16* go =
        static_cast<__nv_bfloat16*>(p.o) + b * p.os.b + h * p.os.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_i[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = q0 + wg * 64 + w * 16 + g + r * 8;
      if (row < p.N) {
        __nv_bfloat16* orow = go + (long long)row * p.os.n;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = j * 8 + t4 * 2;
          if (col < p.D) {
            *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                __floats2bfloat162_rn(o[4 * j + 2 * r] * inv,
                                      o[4 * j + 2 * r + 1] * inv);
          }
        }
        if constexpr (LSE) {
          // m is in the log2 domain with the scale folded in
          if (t4 == 0)
            p.lse[(long long)bh * p.N + row] = (m_i[r] + log2f(l)) * kLn2;
        }
      }
    }
  }
}

// streaming multiprocessors of the current device (0 if it cannot be read):
// the persistent grid's size
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

// How a bf16 launch spreads over the card: the one place it is decided.
// The launch takes its instantiation and grid from here, and
// flash_attention_fwd_plan reports the same numbers.
struct FwdPlan {
  int dp;            // padded head dim
  int keys;          // keys a K/V tile: the main tile or the short one
  int warpgroups;    // consumer warpgroups of a block, 64 query rows each
  long long tiles;   // query tiles of 64 rows over every (batch, head)
  long long items;   // what the blocks walk (the kernel's item_at)
  int blocks;        // one per SM, or one per item where the items are fewer
};

// The short key tile where every key fits in it and it pads M less than the
// main tile does (M = 77: 80 keys, not 128); one consumer warpgroup where
// blocks of 128 rows would fill at most half of the SMs, else the head
// dim's count.  Items: ranges of three tiles, or a head's tiles in items of
// WG, as the kernel's walk counts them.
template <int DP>
FwdPlan plan_at(const Params& p, int sms) {
  using T = FwdTiles<DP>;
  FwdPlan f;
  f.dp = DP;
  f.keys = T::BN;
  if (T::BN_SHORT > 0 && p.M <= T::BN_SHORT &&
      T::BN_SHORT < (p.M + T::BN - 1) / T::BN * T::BN)
    f.keys = T::BN_SHORT;
  const long long heads = (long long)p.B * p.H;
  const long long per_head = (p.N + 63) / 64;
  f.warpgroups = 2 * heads * ((p.N + 127) / 128) <= sms ? 1 : T::WG;
  f.tiles = heads * per_head;
  f.items = f.warpgroups == 3
                ? (f.tiles + 2) / 3
                : heads * ((per_head + f.warpgroups - 1) / f.warpgroups);
  f.blocks = (int)(f.items < sms ? f.items : sms);
  return f;
}

FwdPlan fwd_plan(const Params& p, int sms) {
  if (p.D <= 48) return plan_at<48>(p, sms);
  if (p.D <= 80) return plan_at<80>(p, sms);
  if (p.D <= 160) return plan_at<160>(p, sms);
  return plan_at<256>(p, sms);
}

template <int DP, int BN, int WG, bool LSE>
int launch_wgmma(const Params& p, int blocks, cudaStream_t stream) {
  using S = FwdShape<DP, BN, WG>;
  FwdBf16Params P = {};
  P.p = p;
  P.panels = (p.D + kPanel - 1) / kPanel;
  if (!make_map(P.q, p.q, p.qs, p.B, p.H, p.N, p.D, S::BM) ||
      !make_map(P.k, p.k, p.ks, p.B, p.H, p.M, p.D, BN) ||
      !make_map(P.v, p.v, p.vs, p.B, p.H, p.M, p.D, BN))
    return kMapRefused;
  // per device and cheap, so set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP, BN, WG, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return e;
  flash_fwd_wgmma<DP, BN, WG, LSE>
      <<<(unsigned)blocks, S::THREADS, S::SMEM, stream>>>(P);
  return cudaGetLastError();
}

template <int DP, int BN, bool LSE>
int launch_rows(const Params& p, const FwdPlan& f, cudaStream_t stream) {
  if (f.warpgroups == 1)
    return launch_wgmma<DP, BN, 1, LSE>(p, f.blocks, stream);
  return launch_wgmma<DP, BN, FwdTiles<DP>::WG, LSE>(p, f.blocks, stream);
}

template <int DP, bool LSE>
int launch_bf16(const Params& p, cudaStream_t stream) {
  using T = FwdTiles<DP>;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const FwdPlan f = plan_at<DP>(p, sms);
  if constexpr (T::BN_SHORT > 0) {
    if (f.keys == T::BN_SHORT)
      return launch_rows<DP, T::BN_SHORT, LSE>(p, f, stream);
  }
  return launch_rows<DP, T::BN, LSE>(p, f, stream);
}

// ---------------------------------------------------------------------------
// fp32: plain-FMA kernel (fp32 products, as an fp32 caller expects)
// ---------------------------------------------------------------------------
// A block owns 16 query rows (4 per warp) of one (batch, head) and streams
// tiles of 32 keys.  Lane j of a warp scores key j of the tile against the
// warp's four rows; lane j also owns output columns j, j + 32, ...

template <int NREG, bool LSE>   // D <= 32 * NREG
__global__ void __launch_bounds__(kThreads) flash_fwd_f32(const Params p) {
  constexpr int BM = 16, BN = 32, RPW = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, LD = D + 1;   // odd row stride: no bank conflicts
  float* sQ = reinterpret_cast<float*>(smem_raw);
  float* sK = sQ + BM * LD;
  float* sV = sK + BN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const float* gq = static_cast<const float*>(p.q) + b * p.qs.b + h * p.qs.h;
  const float* gk = static_cast<const float*>(p.k) + b * p.ks.b + h * p.ks.h;
  const float* gv = static_cast<const float*>(p.v) + b * p.vs.b + h * p.vs.h;
  float* go = static_cast<float*>(p.o) + b * p.os.b + h * p.os.h;

  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int gr = q0 + r;
    sQ[r * LD + c] =
        gr < p.N ? gq[(long long)gr * p.qs.n + c] * p.scale : 0.f;
  }

  float acc[RPW][NREG];
  float m_i[RPW], l_i[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m_i[r] = kNegInf;
    l_i[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NREG; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = (p.M + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int kbase = t * BN;
    __syncthreads();   // previous tile consumed (and sQ written, first time)
    for (int i = tid; i < BN * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int gr = kbase + r;
      const bool ok = gr < p.M;
      sK[r * LD + c] = ok ? gk[(long long)gr * p.ks.n + c] : 0.f;
      sV[r * LD + c] = ok ? gv[(long long)gr * p.vs.n + c] : 0.f;
    }
    __syncthreads();

    float s[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = 0.f;
    const float* krow = sK + lane * LD;
    const float* qrow = sQ + warp * RPW * LD;
    for (int c = 0; c < D; ++c) {
      const float kv = krow[c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) s[r] = fmaf(qrow[r * LD + c], kv, s[r]);
    }
    const bool valid = kbase + lane < p.M;

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float sv = valid ? s[r] : kNegInf;
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[r], mx);
      const float alpha = expf(m_i[r] - m_new);
      const float pj = expf(sv - m_new);
      float sum = pj;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m_i[r] = m_new;
      l_i[r] = l_i[r] * alpha + sum;
#pragma unroll
      for (int i = 0; i < NREG; ++i) acc[r][i] *= alpha;
      for (int j = 0; j < BN; ++j) {
        const float pb = __shfl_sync(0xffffffffu, pj, j);
        const float* vrow = sV + j * LD;
#pragma unroll
        for (int i = 0; i < NREG; ++i) {
          const int c = lane + 32 * i;
          if (c < D) acc[r][i] = fmaf(pb, vrow[c], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row < p.N) {
      const float inv = 1.f / l_i[r];
#pragma unroll
      for (int i = 0; i < NREG; ++i) {
        const int c = lane + 32 * i;
        if (c < D) go[(long long)row * p.os.n + c] = acc[r][i] * inv;
      }
      if constexpr (LSE) {
        if (lane == 0)
          p.lse[(long long)blockIdx.y * p.N + row] = m_i[r] + logf(l_i[r]);
      }
    }
  }
}

template <int NREG, bool LSE>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = (16 + 32 + 32) * (p.D + 1) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_f32<NREG, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.N + 15) / 16, p.B * p.H);
  flash_fwd_f32<NREG, LSE><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <bool LSE>
int dispatch(const Params& p, int dtype, cudaStream_t st) {
  if (bad_dims(p.B, p.H, p.N, p.M, p.D)) return -1;
  if (dtype == 1) {
    // Padded widths: those of the SD v1 UNet (head dims 40, 80, 160) and the
    // limit.  Any other head dim runs at the next width up, its extra columns
    // zero-filled in shared memory; a width of its own is one line here.
    if (p.D <= 48) return launch_bf16<48, LSE>(p, st);
    if (p.D <= 80) return launch_bf16<80, LSE>(p, st);
    if (p.D <= 160) return launch_bf16<160, LSE>(p, st);
    return launch_bf16<256, LSE>(p, st);
  }
  if (dtype == 0) {
    if (p.D <= 32) return launch_f32<1, LSE>(p, st);
    if (p.D <= 64) return launch_f32<2, LSE>(p, st);
    if (p.D <= 128) return launch_f32<4, LSE>(p, st);
    return launch_f32<8, LSE>(p, st);
  }
  return -1;
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int N, int M, int D,
                   const long long* strides, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.lse = lse;
  p.B = B; p.H = H; p.N = N; p.M = M; p.D = D;
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.os = strides_at(strides, 3);
  p.scale = scale;
  return p;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
// dtype: 0 = float32, 1 = bfloat16.  `strides` is a host array of 12 element
// strides: (batch, head, row) for q, k, v, o in turn; the head dim is
// contiguous.  bf16 needs 16-byte aligned base pointers and strides that are
// multiples of 8 (what the TMA unit takes).  Returns 0 on success, a
// cudaError_t value if the launch was refused, -1 for arguments this kernel
// does not take (D not a multiple of 8, D > 256, unknown dtype, empty
// tensors), or -2 if the driver refused a tensor map.

// The inference forward (the two Pallas inference kernels).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int H, int N, int M, int D, const long long* strides, float scale,
    void* stream) {
  const Params p = make_params(q, k, v, o, nullptr, B, H, N, M, D, strides,
                               scale);
  return dispatch<false>(p, dtype, static_cast<cudaStream_t>(stream));
}

// The training forward (Pallas _fwd_kernel with stats): the same o, and per
// row lse = max + log(sum) of the scaled logits, fp32, (B, H, N) contiguous.
extern "C" int flash_attention_fwd_lse(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype, int B, int H, int N, int M, int D, const long long* strides,
    float scale, void* stream) {
  const Params p = make_params(q, k, v, o, lse, B, H, N, M, D, strides, scale);
  return dispatch<true>(p, dtype, static_cast<cudaStream_t>(stream));
}

// The bf16 instantiations a head dim takes: out[] = {padded head dim, keys
// a tile, keys of the short tile taken when every key fits in it (0: none),
// K/V stages, consumer warpgroups of a block where the grid fills the card,
// the registers they raise theirs to; then for that block and for one of a
// single consumer warpgroup: query rows, threads, shared bytes with the main
// tile, with the short tile (0: none)}.  Returns -1 for a head dim the
// kernel does not take.
extern "C" int flash_attention_fwd_config(int D, int* out) {
  if (bad_dims(1, 1, 1, 1, D)) return -1;
  auto fill = [out](auto tiles, int dp) {
    using T = decltype(tiles);
    constexpr int SHORT = T::BN_SHORT ? T::BN_SHORT : T::BN;
    using SW = FwdShape<T::DP, T::BN, T::WG>;
    using S1 = FwdShape<T::DP, T::BN, 1>;
    const int v[14] = {dp, T::BN, T::BN_SHORT, SW::STAGES, T::WG,
                       SW::CONSUMER_REGS,
                       SW::BM, SW::THREADS, SW::SMEM,
                       T::BN_SHORT ? FwdShape<T::DP, SHORT, T::WG>::SMEM : 0,
                       S1::BM, S1::THREADS, S1::SMEM,
                       T::BN_SHORT ? FwdShape<T::DP, SHORT, 1>::SMEM : 0};
    for (int i = 0; i < 14; ++i) out[i] = v[i];
    return 0;
  };
  if (D <= 48) return fill(FwdTiles<48>{}, 48);
  if (D <= 80) return fill(FwdTiles<80>{}, 80);
  if (D <= 160) return fill(FwdTiles<160>{}, 160);
  return fill(FwdTiles<256>{}, 256);
}

// How a bf16 launch at this shape spreads over the current device, as the
// launch itself decides it: out[] = {padded head dim, keys a tile, consumer
// warpgroups of a block (64 query rows each), query tiles of 64 rows,
// items the blocks walk, blocks, SMs}.  Returns -1 for dims the kernel does
// not take, a cudaError_t value if the device could not be read, else 0.
extern "C" int flash_attention_fwd_plan(int B, int H, int N, int M, int D,
                                        int* out) {
  if (bad_dims(B, H, N, M, D)) return -1;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  Params p = {};
  p.B = B; p.H = H; p.N = N; p.M = M; p.D = D;
  const FwdPlan f = fwd_plan(p, sms);
  const int v[7] = {f.dp, f.keys, f.warpgroups, (int)f.tiles, (int)f.items,
                    f.blocks, sms};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == -1) return "arguments not supported by flash_attention_fwd";
  if (code == kMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map (driver entry point "
           "missing, or strides the TMA unit does not take)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
