// Flash-attention backward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces two Pallas TPU kernels of celebbasis_tpu/ops/flash_attention.py:
//   * _dq_kernel  (flash_bwd_dq_*):  one block per query tile streams the K/V
//     tiles:  p = exp(q k^T scale - lse),  dp = dO v^T,  ds = p (dp - delta),
//     dq = (sum ds k) scale;  missing key columns get p = 0;
//   * _dkv_kernel (flash_bwd_dkv_*): one block per key tile streams the Q/dO
//     tiles:  dv = sum p^T dO,  dk = (sum ds^T q) scale;  missing query rows
//     contribute nothing.
// lse is the per-row logsumexp that the training forward
// (flash_attention_fwd_lse) saved; delta = rowsum(dO * O), which the JAX
// package computes with XLA ops outside its kernels, is a small kernel of its
// own here (flash_bwd_delta) so that it reads O and dO in place.
//
// Every output element is owned by exactly one block and summed in a fixed
// order: no atomics, so gradients are the same bits run to run.  Where dk/dv
// splits a key tile's query stream over several blocks, each writes fp32
// partial sums and flash_bwd_dkv_reduce adds them in split order.  As in the
// forward, all tensors come with (batch, head, row) element strides, so the
// packed (B, N, H*D) layout and the per-head (B, H, N, D) layout are read
// and written in place, and bounds checks take the place of padding.
//
// What bounds it on an H100.  With W = B*H*N*M*D, dq does 6W flop (three
// products: it recomputes s and dp, the price of owning dq without atomics)
// and dkv 8W (four) against O(B*H*(N+M)*D) bytes: at N = M = 4096, D = 40
// that is thousands of flop per byte, so both are bound by tensor-core
// operations -- as long as p and ds never reach device memory, and as long as
// the products run on wgmma, the only instruction that reaches the tensor
// cores' full rate.
//
// What the design does about it (bf16; the head dim is padded to DP = 48,
// 80, 160 or 256 in shared memory only):
//   * every product is a wgmma (m64nNk16, bf16 operands, fp32 accumulators),
//     a warpgroup of 128 threads per 64 rows.  dq: s = q k^T and dp = dO v^T,
//     ds = p (dp - delta) in registers, rounded to bf16 as the register A
//     operand of dq += ds k (k read MN-major from the same shared tile).
//     dk/dv work on the transposed problem, s^T = k q^T and dp^T = v dO^T,
//     so that p^T and ds^T come out in the accumulator layout that repacks
//     to the A operand of dv += p^T dO and dk += ds^T q.  The block's own
//     operand of the first two products (q and dO for dq, k and v for dk/dv)
//     is read from shared memory once and kept in registers at DP <= 80;
//   * a producer feeds a ring of shared-memory stages with TMA
//     (cp.async.bulk.tensor), one mbarrier pair per stage, no block-wide
//     barrier in the loop; a producer warpgroup hands its registers to the
//     consumers (setmaxnreg).  Tensor maps are 4-D -- the head dim (D wide,
//     16-column boxes) and the head, row and batch dims ordered by stride --
//     so a box reads the zeros past the head dim and past the last row
//     itself, and the 32-byte swizzle it writes is the layout both wgmma
//     views read (hopper.cuh).  The host encodes the four maps of a call
//     (cuTensorMapEncodeTiled, taken through cudaGetDriverEntryPoint: no
//     -lcuda) and passes them in a __grid_constant__ parameter;
//   * two consumer warpgroups take turns to issue their first products
//     (named barriers), so that one's exponentials overlap the other's
//     products;
//   * dq: a block owns 128 query rows (two consumer warpgroups sharing each
//     K/V tile) at DP <= 80, 64 rows at 160 and 256 (the (64, DP) fp32
//     accumulator then fills a warpgroup's registers); K/V tiles of 128 keys
//     at DP = 48, 64 at 80 and 160, 32 at 256;
//   * dk/dv: a block owns 128 keys (one warpgroup per 64) at DP <= 80.  At
//     DP = 160 and 256 two (64, DP) fp32 accumulators leave no registers for
//     s^T and dp^T, so both warpgroups take the same 64 keys and each owns
//     half of the head dim's columns of dk and dv, both computing s^T and
//     dp^T (1.5x the products instead of spilled accumulators).  Q/dO tiles
//     of 128 query rows at DP = 48, 64 at 80 and 160, 32 at 256.  Where
//     B*H*ceil(M / keys) blocks leave SMs idle (M = 77 at every level, and
//     the small levels), the wrapper splits the query stream over `splits`
//     blocks per key tile (its dkv_split_plan);
//   * the tile sizes and the head-dim split are static by head dim; wgmma at
//     every head dim (it beat the mma.sync kernels it replaced at 160 and 256
//     as well: PERF.md);
//   * log2(e) is folded into the scale and into lse (ex2.approx).
// fp32 inputs take plain-FMA kernels with fp32 products throughout, as the
// Pallas bodies have: wgmma has no fp32 products.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu
// Plain C interface at the bottom; no PyTorch headers.

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kThreads = 128;
// Two consumer warpgroups take turns to issue their first products, so that
// one's exponentials overlap the other's products: named barriers kTurn and
// kTurn + 1 (0 is __syncthreads).
constexpr int kTurn = 1;

constexpr float kRowAbsent = 1e30f;   // lse of a missing query row: p = 0

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // (B, H, N) contiguous
  float* delta;       // (B, H, N) contiguous
  void* dq;
  void* dk;
  void* dv;
  int B, H, N, M, D;
  Strides qs, ks, vs, os, dos, dqs, dks, dvs;
  float scale;
};

template <typename T>
__device__ __forceinline__ const T* at(const void* base, const Strides& s,
                                       int b, int h) {
  return static_cast<const T*>(base) + b * s.b + h * s.h;
}

template <typename T>
__device__ __forceinline__ T* at(void* base, const Strides& s, int b, int h) {
  return static_cast<T*>(base) + b * s.b + h * s.h;
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O), fp32; one warp per row
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_delta(
    const BwdParams p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + warp;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  if (row >= p.N) return;
  const T* o = at<T>(p.o, p.os, b, h) + (long long)row * p.os.n;
  const T* g = at<T>(p.dout, p.dos, b, h) + (long long)row * p.dos.n;
  float sum = 0.f;
  for (int c = lane; c < p.D; c += 32)
    sum = fmaf(to_float(o[c]), to_float(g[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) p.delta[(long long)blockIdx.y * p.N + row] = sum;
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma kernels
// ---------------------------------------------------------------------------

struct Bf16Params {
  TileMap q, k, v, dout;
  BwdParams p;
  float* dk_part;   // (splits, B*H, M, D) fp32 partial sums, splits > 1
  float* dv_part;
  int splits;       // blocks over the query stream of one dk/dv key tile
  int panels;       // 16-column panels a box covers: ceil(D / 16)
};

// -- dq: a block owns BM query rows and streams K/V tiles ---------------------

template <int DP>
struct DqShape {
  static constexpr int WG = DP <= 80 ? 2 : 1;      // consumer warpgroups
  static constexpr int BM = 64 * WG;               // query rows of a block
  // keys of a K/V tile
  static constexpr int BN = DP == 48 ? 128 : (DP == 256 ? 32 : 64);
  static constexpr int STAGES = DP <= 80 ? 4 : 3;
  // q and dO, the A operands of the first two products, stay in registers
  // (where they fit beside the accumulators)
  static constexpr bool A_REGS = DP <= 80;
  // + the producer: a warpgroup whose registers go to the consumers (one of
  // its warps issues the loads) beside two consumer warpgroups, else a warp
  static constexpr int THREADS = 128 * WG + (WG == 2 ? 128 : 32);
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int Q_BYTES = BM * DP * 2;      // q or dO
  static constexpr int KV_BYTES = BN * DP * 2;     // a k or v tile
  static constexpr int BAR_OFF = 2 * Q_BYTES + STAGES * 2 * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8;
};

template <int DP>
__global__ void __launch_bounds__(DqShape<DP>::THREADS, 1)
    flash_bwd_dq_wgmma(const __grid_constant__ Bf16Params P) {
  using S = DqShape<DP>;
  constexpr int BM = S::BM, BN = S::BN, STAGES = S::STAGES, NP = DP / kPanel;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sQ = smem;
  unsigned char* sDO = smem + S::Q_BYTES;
  unsigned char* sKV = smem + 2 * S::Q_BYTES;   // [stage][k | v]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const BwdParams& p = P.p;
  const int tid = threadIdx.x, warp = warp_uniform(tid >> 5);
  const int lane = tid & 31, q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const int n_tiles = (p.M + BN - 1) / BN;

  if (P.panels < NP) {
    zero_padding<DP>(sQ, BM, P.panels, tid, S::THREADS);
    zero_padding<DP>(sDO, BM, P.panels, tid, S::THREADS);
    for (int s = 0; s < 2 * STAGES; ++s)
      zero_padding<DP>(sKV + s * S::KV_BYTES, BN, P.panels, tid, S::THREADS);
    fence_proxy_async();
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * S::WG);   // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * S::WG) {   // the producer
    if constexpr (S::WG == 2) regs_dealloc<S::PRODUCER_REGS>();
    if (warp > 4 * S::WG) return;
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * BM * kPanelRowBytes * P.panels);
      load_panels(sQ, P.q, qbar, BM, q0, h, b, P.panels);
      load_panels(sDO, P.dout, qbar, BM, q0, h, b, P.panels);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        unsigned char* sK = sKV + s * 2 * S::KV_BYTES;
        mbar_arrive_tx(&full[s], 2 * BN * kPanelRowBytes * P.panels);
        load_panels(sK, P.k, &full[s], BN, t * BN, h, b, P.panels);
        load_panels(sK + S::KV_BYTES, P.v, &full[s], BN, t * BN, h, b,
                    P.panels);
      }
    }
    return;
  }

  // consumer warpgroup `wg` owns query rows [64 wg, 64 wg + 64) of the block;
  // this thread holds rows lane / 4 and lane / 4 + 8 of its warp's 16
  if constexpr (S::WG == 2) regs_alloc<S::CONSUMER_REGS>();
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + w * 16 + g + r * 8;
    const long long at_row = (long long)blockIdx.y * p.N + row;
    lse2[r] = row < p.N ? p.lse[at_row] * kLog2e : 0.f;
    dl[r] = row < p.N ? p.delta[at_row] : 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

  constexpr bool kPingPong = S::WG == 2;
  if (kPingPong && wg == 1) bar_arrive(kTurn, 256);
  mbar_wait(qbar, 0);
  uint32_t aq[S::A_REGS ? NP : 1][4], ado[S::A_REGS ? NP : 1][4];
  if constexpr (S::A_REGS) {
    load_a(aq, sQ, BM, wg * 64 + w * 16, lane);
    load_a(ado, sDO, BM, wg * 64 + w * 16, lane);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const unsigned char* sK = sKV + s * 2 * S::KV_BYTES;
    const unsigned char* sV = sK + S::KV_BYTES;

    float sc[BN / 2], dp[BN / 2];
    if (kPingPong) bar_sync(kTurn + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {   // q k^T, dO v^T
      if constexpr (S::A_REGS) {
        Mma<BN>::template rs<0>(sc, aq[kk], desc_kmajor(sK, BN, 0, kk),
                                kk > 0);
        Mma<BN>::template rs<0>(dp, ado[kk], desc_kmajor(sV, BN, 0, kk),
                                kk > 0);
      } else {
        Mma<BN>::template ss<0>(sc, desc_kmajor(sQ, BM, wg * 64, kk),
                                desc_kmajor(sK, BN, 0, kk), kk > 0);
        Mma<BN>::template ss<0>(dp, desc_kmajor(sDO, BM, wg * 64, kk),
                                desc_kmajor(sV, BN, 0, kk), kk > 0);
      }
    }
    wgmma_commit();
    if (kPingPong) bar_arrive(kTurn + (wg ^ 1), 256);
    wgmma_wait<0>();

    // ds = p (dp - delta), p = 0 at missing keys; kept in sc
    const int kbase = t * BN;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbase + j * 8 + t4 * 2 + (e & 1);
        const float pv =
            col < p.M
                ? exp2_approx(fmaf(sc[4 * j + e], scale_log2, -lse2[e >> 1]))
                : 0.f;
        sc[4 * j + e] = pv * (dp[4 * j + e] - dl[e >> 1]);
      }
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {   // dq += ds k
      uint32_t a[4];
      acc_to_a(a, sc, kk);
      Mma<DP>::template rs<1>(dq, a, desc_mnmajor(sK, BN, kk, 0), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* gdq = at<__nv_bfloat16>(p.dq, p.dqs, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + w * 16 + g + r * 8;
    if (row < p.N) {
      __nv_bfloat16* out = gdq + (long long)row * p.dqs.n;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + t4 * 2;
        if (col < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(dq[4 * j + 2 * r] * p.scale,
                                    dq[4 * j + 2 * r + 1] * p.scale);
        }
      }
    }
  }
}

// -- dk/dv: a block owns BNK keys and streams Q/dO tiles ----------------------

template <int DP>
struct DkvShape {
  // warpgroups that share 64 keys, each owning DP / DSPLIT columns of dk, dv
  static constexpr int DSPLIT = DP > 80 ? 2 : 1;
  static constexpr int BNK = 128 / DSPLIT;          // keys of a block
  // query rows of a Q/dO tile
  static constexpr int BM = DP == 48 ? 128 : (DP == 256 ? 32 : 64);
  static constexpr int DC = DP / DSPLIT;
  static constexpr int STAGES = DP <= 80 ? 4 : 3;
  // k and v, the A operands of the first two products, stay in registers
  // (where they fit beside the accumulators)
  static constexpr bool A_REGS = DSPLIT == 1;
  // + a producer warpgroup, whose registers go to the consumers (one of its
  // warps issues the loads)
  static constexpr int THREADS = 384;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
  static constexpr int KV_BYTES = BNK * DP * 2;     // k or v
  static constexpr int Q_BYTES = BM * DP * 2;       // a q or dO tile
  static constexpr int STAT_OFF = 2 * KV_BYTES + STAGES * 2 * Q_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * BM * 4;
  static constexpr int SMEM = BAR_OFF + (2 * STAGES + 1) * 8;
  static_assert(DC % kPanel == 0, "column slices must be whole panels");
};

template <int DP>
__global__ void __launch_bounds__(DkvShape<DP>::THREADS, 1)
    flash_bwd_dkv_wgmma(const __grid_constant__ Bf16Params P) {
  using S = DkvShape<DP>;
  constexpr int BNK = S::BNK, BM = S::BM, DC = S::DC, STAGES = S::STAGES;
  constexpr int NP = DP / kPanel;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sK = smem;
  unsigned char* sV = smem + S::KV_BYTES;
  unsigned char* sQD = smem + 2 * S::KV_BYTES;   // [stage][q | dO]
  float* sStat = reinterpret_cast<float*>(smem + S::STAT_OFF);
  // [stage][lse * log2(e) | delta][BM]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const BwdParams& p = P.p;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = warp_uniform(tid >> 5);
  const int key_tiles = (p.M + BNK - 1) / BNK;
  const int split = blockIdx.x / key_tiles;
  const int k0 = (blockIdx.x - split * key_tiles) * BNK;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  // this block's share of the query tiles
  const int q_tiles = (p.N + BM - 1) / BM;
  const int t_begin = (int)((long long)split * q_tiles / P.splits);
  const int n_tiles =
      (int)((long long)(split + 1) * q_tiles / P.splits) - t_begin;

  if (P.panels < NP) {
    zero_padding<DP>(sK, BNK, P.panels, tid, S::THREADS);
    zero_padding<DP>(sV, BNK, P.panels, tid, S::THREADS);
    for (int s = 0; s < 2 * STAGES; ++s)
      zero_padding<DP>(sQD + s * S::Q_BYTES, BM, P.panels, tid, S::THREADS);
    fence_proxy_async();
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);   // the TMA bytes and the producer's lanes
      mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    mbar_init(kvbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {   // the producer warpgroup
    regs_dealloc<S::PRODUCER_REGS>();
    if (warp > 8) return;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * BNK * kPanelRowBytes * P.panels);
      load_panels(sK, P.k, kvbar, BNK, k0, h, b, P.panels);
      load_panels(sV, P.v, kvbar, BNK, k0, h, b, P.panels);
    }
    const float* glse = p.lse + (long long)blockIdx.y * p.N;
    const float* gdelta = p.delta + (long long)blockIdx.y * p.N;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES, row0 = (t_begin + i) * BM;
      if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
      float* st = sStat + s * 2 * BM;
      for (int r = lane; r < BM; r += 32) {
        const int row = row0 + r;
        st[r] = row < p.N ? glse[row] * kLog2e : kRowAbsent;
        st[BM + r] = row < p.N ? gdelta[row] : 0.f;
      }
      if (lane == 0) {
        unsigned char* sQ = sQD + s * 2 * S::Q_BYTES;
        mbar_arrive_tx(&full[s], 2 * BM * kPanelRowBytes * P.panels);
        load_panels(sQ, P.q, &full[s], BM, row0, h, b, P.panels);
        load_panels(sQ + S::Q_BYTES, P.dout, &full[s], BM, row0, h, b,
                    P.panels);
      }
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumer warpgroup `wg`: keys [kw * 64, kw * 64 + 64) of the block,
  // columns [c0, c0 + DC) of dk and dv
  regs_alloc<S::CONSUMER_REGS>();
  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int kw = S::DSPLIT == 1 ? wg : 0;
  const int c0 = S::DSPLIT == 1 ? 0 : wg * DC;
  const float scale_log2 = p.scale * kLog2e;
  float dk[DC / 2], dv[DC / 2];
#pragma unroll
  for (int i = 0; i < DC / 2; ++i) dk[i] = dv[i] = 0.f;

  constexpr bool kPingPong = true;
  if (kPingPong && wg == 1) bar_arrive(kTurn, 256);
  mbar_wait(kvbar, 0);
  uint32_t ak[S::A_REGS ? NP : 1][4], av[S::A_REGS ? NP : 1][4];
  if constexpr (S::A_REGS) {
    load_a(ak, sK, BNK, kw * 64 + w * 16, lane);
    load_a(av, sV, BNK, kw * 64 + w * 16, lane);
  }
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    const unsigned char* sQ = sQD + s * 2 * S::Q_BYTES;
    const unsigned char* sDO = sQ + S::Q_BYTES;
    const float* st = sStat + s * 2 * BM;

    // transposed problem: rows are this warpgroup's 64 keys, columns the
    // tile's query rows
    float sT[BM / 2], dpT[BM / 2];
    if (kPingPong) bar_sync(kTurn + wg, 256);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NP; ++kk) {   // k q^T, v dO^T
      if constexpr (S::A_REGS) {
        Mma<BM>::template rs<0>(sT, ak[kk], desc_kmajor(sQ, BM, 0, kk),
                                kk > 0);
        Mma<BM>::template rs<0>(dpT, av[kk], desc_kmajor(sDO, BM, 0, kk),
                                kk > 0);
      } else {
        Mma<BM>::template ss<0>(sT, desc_kmajor(sK, BNK, kw * 64, kk),
                                desc_kmajor(sQ, BM, 0, kk), kk > 0);
        Mma<BM>::template ss<0>(dpT, desc_kmajor(sV, BNK, kw * 64, kk),
                                desc_kmajor(sDO, BM, 0, kk), kk > 0);
      }
    }
    wgmma_commit();
    if (kPingPong) bar_arrive(kTurn + (wg ^ 1), 256);
    wgmma_wait<0>();

#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = j * 8 + t4 * 2 + (e & 1);
        const float pv = exp2_approx(fmaf(sT[4 * j + e], scale_log2, -st[qi]));
        dpT[4 * j + e] = pv * (dpT[4 * j + e] - st[BM + qi]);   // ds^T
        sT[4 * j + e] = pv;                                     // p^T
      }
    fence_regs(dk);
    fence_regs(dv);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {   // dv += p^T dO
      uint32_t a[4];
      acc_to_a(a, sT, kk);
      Mma<DC>::template rs<1>(dv, a, desc_mnmajor(sDO, BM, kk, c0 / kPanel),
                              1);
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {   // dk += ds^T q
      uint32_t a[4];
      acc_to_a(a, dpT, kk);
      Mma<DC>::template rs<1>(dk, a, desc_mnmajor(sQ, BM, kk, c0 / kPanel),
                              1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  __nv_bfloat16* gdk = at<__nv_bfloat16>(p.dk, p.dks, b, h);
  __nv_bfloat16* gdv = at<__nv_bfloat16>(p.dv, p.dvs, b, h);
  const long long part0 =
      ((long long)split * p.B * p.H + blockIdx.y) * p.M * p.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw * 64 + w * 16 + g + r * 8;
    if (key >= p.M) continue;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      const int col = c0 + j * 8 + t4 * 2;
      if (col >= p.D) continue;
      const float k0v = dk[4 * j + 2 * r], k1v = dk[4 * j + 2 * r + 1];
      const float v0v = dv[4 * j + 2 * r], v1v = dv[4 * j + 2 * r + 1];
      if (P.splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>(gdk + (long long)key * p.dks.n +
                                           col) =
            __floats2bfloat162_rn(k0v * p.scale, k1v * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(gdv + (long long)key * p.dvs.n +
                                           col) =
            __floats2bfloat162_rn(v0v, v1v);
      } else {
        const long long at_part = part0 + (long long)key * p.D + col;
        *reinterpret_cast<float2*>(P.dk_part + at_part) =
            make_float2(k0v, k1v);
        *reinterpret_cast<float2*>(P.dv_part + at_part) =
            make_float2(v0v, v1v);
      }
    }
  }
}

// the split query stream: dk, dv = the partial sums added in split order,
// one thread per two columns
__global__ void __launch_bounds__(256) flash_bwd_dkv_reduce(
    const BwdParams p, const float* dk_part, const float* dv_part,
    int splits) {
  const int half = p.D / 2;
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)p.B * p.H * p.M * half) return;
  const long long row = i / half;   // (b * H + h) * M + key
  const int col = (int)(i - row * half) * 2;
  const int key = (int)(row % p.M), bh = (int)(row / p.M);
  const int b = bh / p.H, h = bh - b * p.H;
  const long long step = (long long)p.B * p.H * p.M * p.D;
  const float* pk = dk_part + row * p.D + col;
  const float* pv = dv_part + row * p.D + col;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float2 a = *reinterpret_cast<const float2*>(pk + s * step);
    const float2 c = *reinterpret_cast<const float2*>(pv + s * step);
    sk.x += a.x; sk.y += a.y;
    sv.x += c.x; sv.y += c.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(at<__nv_bfloat16>(p.dk, p.dks, b, h) +
                                     (long long)key * p.dks.n + col) =
      __floats2bfloat162_rn(sk.x * p.scale, sk.y * p.scale);
  *reinterpret_cast<__nv_bfloat162*>(at<__nv_bfloat16>(p.dv, p.dvs, b, h) +
                                     (long long)key * p.dvs.n + col) =
      __floats2bfloat162_rn(sv.x, sv.y);
}

// -- host side ----------------------------------------------------------------

// q and dO maps with boxes of `q_rows` rows, k and v with `k_rows`
int make_maps(Bf16Params& P, int q_rows, int k_rows) {
  const BwdParams& p = P.p;
  const bool ok =
      make_map(P.q, p.q, p.qs, p.B, p.H, p.N, p.D, q_rows) &&
      make_map(P.dout, p.dout, p.dos, p.B, p.H, p.N, p.D, q_rows) &&
      make_map(P.k, p.k, p.ks, p.B, p.H, p.M, p.D, k_rows) &&
      make_map(P.v, p.v, p.vs, p.B, p.H, p.M, p.D, k_rows);
  P.panels = (p.D + kPanel - 1) / kPanel;
  return ok ? 0 : kMapRefused;
}

template <int DP>
int launch_dq_wgmma(Bf16Params& P, cudaStream_t stream) {
  using S = DqShape<DP>;
  const int rc = make_maps(P, S::BM, S::BN);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((P.p.N + S::BM - 1) / S::BM, P.p.B * P.p.H);
  flash_bwd_dq_wgmma<DP><<<grid, S::THREADS, S::SMEM, stream>>>(P);
  return cudaGetLastError();
}

template <int DP>
int launch_dkv_wgmma(Bf16Params& P, cudaStream_t stream) {
  using S = DkvShape<DP>;
  const int rc = make_maps(P, S::BM, S::BNK);
  if (rc != 0) return rc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::SMEM);
  if (e != cudaSuccess) return e;
  const BwdParams& p = P.p;
  dim3 grid((p.M + S::BNK - 1) / S::BNK * P.splits, p.B * p.H);
  flash_bwd_dkv_wgmma<DP><<<grid, S::THREADS, S::SMEM, stream>>>(P);
  e = cudaGetLastError();
  if (e != cudaSuccess || P.splits == 1) return e;
  const long long n = (long long)p.B * p.H * p.M * (p.D / 2);
  flash_bwd_dkv_reduce<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      p, P.dk_part, P.dv_part, P.splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: plain-FMA kernels (fp32 products throughout)
// ---------------------------------------------------------------------------
// dq: a block owns 16 query rows (4 per warp) and streams tiles of 32 keys;
// lane j scores key j against the warp's rows and owns columns j, j + 32, ...
// of dq.  dkv is the mirror image: a block owns 16 keys (4 per warp) and
// streams tiles of 32 query rows; lane i holds query row i.

template <int NREG>   // D <= 32 * NREG
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32(
    const BwdParams p) {
  constexpr int BM = 16, BN = 32, RPW = 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, LD = D + 1;   // odd row stride: no bank conflicts
  float* sQ = reinterpret_cast<float*>(smem_raw);   // pre-scaled
  float* sDO = sQ + BM * LD;
  float* sK = sDO + BM * LD;
  float* sV = sK + BN * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const float* gq = at<float>(p.q, p.qs, b, h);
  const float* gk = at<float>(p.k, p.ks, b, h);
  const float* gv = at<float>(p.v, p.vs, b, h);
  const float* gdo = at<float>(p.dout, p.dos, b, h);
  float* gdq = at<float>(p.dq, p.dqs, b, h);

  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int gr = q0 + r;
    const bool ok = gr < p.N;
    sQ[r * LD + c] = ok ? gq[(long long)gr * p.qs.n + c] * p.scale : 0.f;
    sDO[r * LD + c] = ok ? gdo[(long long)gr * p.dos.n + c] : 0.f;
  }

  float acc[RPW][NREG], lse[RPW], dl[RPW];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    const long long at_row = (long long)blockIdx.y * p.N + row;
    lse[r] = row < p.N ? p.lse[at_row] : 0.f;
    dl[r] = row < p.N ? p.delta[at_row] : 0.f;
#pragma unroll
    for (int i = 0; i < NREG; ++i) acc[r][i] = 0.f;
  }

  const int n_tiles = (p.M + BN - 1) / BN;
  for (int t = 0; t < n_tiles; ++t) {
    const int kbase = t * BN;
    __syncthreads();   // previous tile consumed (and sQ, sDO written)
    for (int i = tid; i < BN * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int gr = kbase + r;
      const bool ok = gr < p.M;
      sK[r * LD + c] = ok ? gk[(long long)gr * p.ks.n + c] : 0.f;
      sV[r * LD + c] = ok ? gv[(long long)gr * p.vs.n + c] : 0.f;
    }
    __syncthreads();

    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
    const float* krow = sK + lane * LD;
    const float* vrow = sV + lane * LD;
    const float* qrow = sQ + warp * RPW * LD;
    const float* dorow = sDO + warp * RPW * LD;
    for (int c = 0; c < D; ++c) {
      const float kv = krow[c], vv = vrow[c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        s[r] = fmaf(qrow[r * LD + c], kv, s[r]);
        dp[r] = fmaf(dorow[r * LD + c], vv, dp[r]);
      }
    }
    const bool valid = kbase + lane < p.M;

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float pj = valid ? expf(s[r] - lse[r]) : 0.f;
      const float ds = pj * (dp[r] - dl[r]);
      for (int j = 0; j < BN; ++j) {
        const float dsb = __shfl_sync(0xffffffffu, ds, j);
        const float* kj = sK + j * LD;
#pragma unroll
        for (int i = 0; i < NREG; ++i) {
          const int c = lane + 32 * i;
          if (c < D) acc[r][i] = fmaf(dsb, kj[c], acc[r][i]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int row = q0 + warp * RPW + r;
    if (row < p.N) {
#pragma unroll
      for (int i = 0; i < NREG; ++i) {
        const int c = lane + 32 * i;
        if (c < D) gdq[(long long)row * p.dqs.n + c] = acc[r][i] * p.scale;
      }
    }
  }
}

template <int NREG>
cudaError_t launch_dq_f32(const BwdParams& p, cudaStream_t stream) {
  const int smem = (16 + 16 + 32 + 32) * (p.D + 1) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_f32<NREG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.N + 15) / 16, p.B * p.H);
  flash_bwd_dq_f32<NREG><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NREG>   // D <= 32 * NREG
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32(
    const BwdParams p) {
  constexpr int BN = 16, BM = 32, RPW = 4;   // keys owned, query rows a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = p.D, LD = D + 1;
  float* sK = reinterpret_cast<float*>(smem_raw);
  float* sV = sK + BN * LD;
  float* sQ = sV + BN * LD;
  float* sDO = sQ + BM * LD;
  float* sLse = sDO + BM * LD;
  float* sDl = sLse + BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = blockIdx.x * BN;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const float* gq = at<float>(p.q, p.qs, b, h);
  const float* gk = at<float>(p.k, p.ks, b, h);
  const float* gv = at<float>(p.v, p.vs, b, h);
  const float* gdo = at<float>(p.dout, p.dos, b, h);
  const float* glse = p.lse + (long long)blockIdx.y * p.N;
  const float* gdelta = p.delta + (long long)blockIdx.y * p.N;

  for (int i = tid; i < BN * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int gr = k0 + r;
    const bool ok = gr < p.M;
    sK[r * LD + c] = ok ? gk[(long long)gr * p.ks.n + c] : 0.f;
    sV[r * LD + c] = ok ? gv[(long long)gr * p.vs.n + c] : 0.f;
  }

  float dk[RPW][NREG], dv[RPW][NREG];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int i = 0; i < NREG; ++i) dk[r][i] = dv[r][i] = 0.f;

  const int n_tiles = (p.N + BM - 1) / BM;
  for (int t = 0; t < n_tiles; ++t) {
    const int qbase = t * BM;
    __syncthreads();   // previous tile consumed (and sK, sV written)
    for (int i = tid; i < BM * D; i += kThreads) {
      const int r = i / D, c = i - r * D;
      const int gr = qbase + r;
      const bool ok = gr < p.N;
      sQ[r * LD + c] = ok ? gq[(long long)gr * p.qs.n + c] : 0.f;
      sDO[r * LD + c] = ok ? gdo[(long long)gr * p.dos.n + c] : 0.f;
    }
    if (tid < BM) {
      const int gr = qbase + tid;
      sLse[tid] = gr < p.N ? glse[gr] : kRowAbsent;
      sDl[tid] = gr < p.N ? gdelta[gr] : 0.f;
    }
    __syncthreads();

    float s[RPW], dp[RPW];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r] = dp[r] = 0.f;
    const float* qrow = sQ + lane * LD;
    const float* dorow = sDO + lane * LD;
    const float* krow = sK + warp * RPW * LD;
    const float* vrow = sV + warp * RPW * LD;
    for (int c = 0; c < D; ++c) {
      const float qv = qrow[c], gv_ = dorow[c];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        s[r] = fmaf(krow[r * LD + c], qv, s[r]);
        dp[r] = fmaf(vrow[r * LD + c], gv_, dp[r]);
      }
    }
    const float lse_i = sLse[lane], dl_i = sDl[lane];

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const float pi = expf(fmaf(s[r], p.scale, -lse_i));
      const float ds = pi * (dp[r] - dl_i);
      for (int i = 0; i < BM; ++i) {
        const float pb = __shfl_sync(0xffffffffu, pi, i);
        const float dsb = __shfl_sync(0xffffffffu, ds, i);
        const float* qi = sQ + i * LD;
        const float* doi = sDO + i * LD;
#pragma unroll
        for (int n = 0; n < NREG; ++n) {
          const int c = lane + 32 * n;
          if (c < D) {
            dv[r][n] = fmaf(pb, doi[c], dv[r][n]);
            dk[r][n] = fmaf(dsb, qi[c], dk[r][n]);
          }
        }
      }
    }
  }

  float* gdk = at<float>(p.dk, p.dks, b, h);
  float* gdv = at<float>(p.dv, p.dvs, b, h);
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int key = k0 + warp * RPW + r;
    if (key < p.M) {
#pragma unroll
      for (int n = 0; n < NREG; ++n) {
        const int c = lane + 32 * n;
        if (c < D) {
          gdk[(long long)key * p.dks.n + c] = dk[r][n] * p.scale;
          gdv[(long long)key * p.dvs.n + c] = dv[r][n];
        }
      }
    }
  }
}

template <int NREG>
cudaError_t launch_dkv_f32(const BwdParams& p, cudaStream_t stream) {
  const int smem = ((16 + 16 + 32 + 32) * (p.D + 1) + 2 * 32) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_f32<NREG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + 15) / 16, p.B * p.H);
  flash_bwd_dkv_f32<NREG><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
// dtype: 0 = float32, 1 = bfloat16.  `strides` is a host array of (batch,
// head, row) element strides for the tensors named at each function, in that
// order; the head dim is contiguous.  lse and delta are fp32, (B, H, N)
// contiguous.  bf16 needs 16-byte aligned base pointers and strides that are
// multiples of 8.  Returns 0 on success, a cudaError_t value if the launch
// was refused, -1 for arguments these kernels do not take, or -2 if the
// driver refused a tensor map.

// delta = rowsum(dO * O).  strides: o, dout.
extern "C" int flash_attention_bwd_delta(
    const void* o, const void* dout, float* delta, int dtype, int B, int H,
    int N, int D, const long long* strides, void* stream) {
  if (bad_dims(B, H, N, 1, D)) return -1;
  BwdParams p = {};
  p.o = o; p.dout = dout; p.delta = delta;
  p.B = B; p.H = H; p.N = N; p.M = 0; p.D = D;
  p.os = strides_at(strides, 0);
  p.dos = strides_at(strides, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + kThreads / 32 - 1) / (kThreads / 32), B * H);
  if (dtype == 1)
    flash_bwd_delta<__nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
  else if (dtype == 0)
    flash_bwd_delta<float><<<grid, kThreads, 0, st>>>(p);
  else
    return -1;
  return cudaGetLastError();
}

// dq.  strides: q, k, v, dout, dq.
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int dtype, int B, int H,
    int N, int M, int D, const long long* strides, float scale,
    void* stream) {
  if (bad_dims(B, H, N, M, D)) return -1;
  BwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse;
  p.delta = const_cast<float*>(delta);
  p.dq = dq;
  p.B = B; p.H = H; p.N = N; p.M = M; p.D = D;
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.dos = strides_at(strides, 3);
  p.dqs = strides_at(strides, 4);
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    Bf16Params P = {};
    P.p = p;
    P.splits = 1;
    if (D <= 48) return launch_dq_wgmma<48>(P, st);
    if (D <= 80) return launch_dq_wgmma<80>(P, st);
    if (D <= 160) return launch_dq_wgmma<160>(P, st);
    return launch_dq_wgmma<256>(P, st);
  }
  if (dtype == 0) {
    if (D <= 32) return launch_dq_f32<1>(p, st);
    if (D <= 64) return launch_dq_f32<2>(p, st);
    if (D <= 128) return launch_dq_f32<4>(p, st);
    return launch_dq_f32<8>(p, st);
  }
  return -1;
}

// dk and dv.  strides: q, k, v, dout, dk, dv.  bf16 only: `splits` blocks
// share the query stream of each key tile; with splits > 1, dk_part and
// dv_part are (splits, B, H, M, D) fp32 scratch.  fp32 takes splits = 1.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, float* dk_part,
    float* dv_part, int dtype, int B, int H, int N, int M, int D, int splits,
    const long long* strides, float scale, void* stream) {
  if (bad_dims(B, H, N, M, D) || splits < 1 || splits > 65535 ||
      (splits > 1 && (dtype != 1 || !dk_part || !dv_part)))
    return -1;
  BwdParams p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.lse = lse;
  p.delta = const_cast<float*>(delta);
  p.dk = dk; p.dv = dv;
  p.B = B; p.H = H; p.N = N; p.M = M; p.D = D;
  p.qs = strides_at(strides, 0);
  p.ks = strides_at(strides, 1);
  p.vs = strides_at(strides, 2);
  p.dos = strides_at(strides, 3);
  p.dks = strides_at(strides, 4);
  p.dvs = strides_at(strides, 5);
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    Bf16Params P = {};
    P.p = p;
    P.dk_part = dk_part;
    P.dv_part = dv_part;
    P.splits = splits;
    if (D <= 48) return launch_dkv_wgmma<48>(P, st);
    if (D <= 80) return launch_dkv_wgmma<80>(P, st);
    if (D <= 160) return launch_dkv_wgmma<160>(P, st);
    return launch_dkv_wgmma<256>(P, st);
  }
  if (dtype == 0) {
    if (D <= 32) return launch_dkv_f32<1>(p, st);
    if (D <= 64) return launch_dkv_f32<2>(p, st);
    if (D <= 128) return launch_dkv_f32<4>(p, st);
    return launch_dkv_f32<8>(p, st);
  }
  return -1;
}

// The bf16 instantiation a head dim takes: out[] = {padded head dim; dq:
// query rows a block, keys a tile, threads, shared bytes, registers its
// consumer warpgroups raise theirs to (0: no hand-over); dk/dv: keys a
// block, query rows a tile, threads, shared bytes, consumer registers}.
// Returns -1 for a head dim the kernels do not take.
extern "C" int flash_attention_bwd_config(int D, int* out) {
  if (bad_dims(1, 1, 1, 1, D)) return -1;
  auto fill = [out](auto dq, auto dkv, int dp) {
    using Q = decltype(dq);
    using K = decltype(dkv);
    const int v[11] = {dp,     Q::BM,      Q::BN,     Q::THREADS,
                       Q::SMEM, Q::WG == 2 ? Q::CONSUMER_REGS : 0,
                       K::BNK, K::BM,      K::THREADS, K::SMEM,
                       K::CONSUMER_REGS};
    for (int i = 0; i < 11; ++i) out[i] = v[i];
    return 0;
  };
  if (D <= 48) return fill(DqShape<48>{}, DkvShape<48>{}, 48);
  if (D <= 80) return fill(DqShape<80>{}, DkvShape<80>{}, 80);
  if (D <= 160) return fill(DqShape<160>{}, DkvShape<160>{}, 160);
  return fill(DqShape<256>{}, DkvShape<256>{}, 256);
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == -1) return "arguments not supported by flash_attention_bwd";
  if (code == kMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map (driver entry point "
           "missing, or strides the TMA unit does not take)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
