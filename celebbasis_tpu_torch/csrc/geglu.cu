// Fused GEGLU feed-forward for NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces two Pallas TPU kernels of celebbasis_tpu/ops/geglu.py:
//   * _kernel_block (via _geglu_block_pallas, public geglu_block): the whole
//     transformer FF sub-block  out = x + GEGLU(LN(x)),  the with_ln variant;
//   * _kernel (via _geglu_pallas, public geglu_ffn): GEGLU(x) alone.
// GEGLU(u) = ((u W1h + b1h) * gelu_tanh(u W1g + b1g)) W2 + b2, with
// inner = W2's rows (4C in the UNet).  As in the Pallas bodies: LayerNorm in
// fp32 with the variance E[x^2] - mu^2 (eps given), scale and bias fp32, the
// normalised rows rounded to x's type; both products accumulate in fp32;
// biases and the tanh GELU in fp32; the gated rows y rounded to x's type
// before the second product; x + acc + b2 added in fp32 with one rounding.
// What the Pallas kernel is for stays: the (rows, 2 inner) product and the
// gated rows y never reach device memory.
//
// Weights are read in place through their strides in the layout of the
// port's nn.Linear parameters: W1^T is (2*inner, C) with rows [0, inner) the
// h half and [inner, 2*inner) the gate half, W2^T is (C, inner); both have
// the reduction dimension contiguous (K-major wgmma B operands).  x and out
// are (rows, C) with unit column stride.
//
// What bounds it on an H100.  At SD v1 shapes the work is 24*rows*C^2 flop
// against x, out and the weights (6*C^2 values): the tensor cores bound it --
// as long as y stays on chip and the weights are not re-read from L2 for
// every few rows.  A row tile of R rows reads all the weights (24 C^2 bytes
// in bf16) and does 24 R C^2 flop on them: R flop per byte of L2 traffic.
// What stands in the way of a large R is the fp32 accumulator: (R, C) fp32 is
// 320 KB for 64 rows at C = 1280, more than a block's registers.  Past that,
// what the products leave over: the GELU, done by the same threads between
// product 1 and product 2, and the exchange of y between blocks.
//
// What the design does about it (bf16):
//   * a block owns 64 rows and 320 output columns: two consumer warpgroups
//     of 160 columns each, an m64n160 fp32 accumulator (80 registers a
//     thread).  Where C > 320, a thread-block cluster gives a row tile K =
//     ceil(C / 320) blocks: block kr owns output columns [320 kr, 320 kr +
//     320) and computes product 1 (h and gate) for its 1/K share of each
//     inner chunk of 128 K columns only, writes its bf16 y piece (64 rows x
//     128 columns) into its own shared memory and sends it to the other K -
//     1 blocks with bulk copies (cp.async.bulk shared::cta -> shared::cluster,
//     completing on their mbarrier), so that each block runs product 2 on the
//     whole y chunk against its own 320 columns of W2.  A cluster may also
//     hold M = 2 row tiles: each weight piece is loaded once, by one of the
//     two, and multicast to both (the plan takes M = 1 where clusters of 2 K
//     blocks would leave enough SMs idle to cost a wave).  The weights are
//     read from L2 once per 64 M rows, where the mma.sync kernel before it
//     read them per 64, 32 or 16 rows (C = 320, 640, 1280);
//   * both products are wgmma (m64nNk16, bf16 operands from shared memory,
//     fp32 accumulators) on 128-byte-swizzled tiles: product 1 as m64n128
//     per warpgroup, its B tile the warpgroup's 64 h rows of W1^T above the
//     64 matching gate rows, so that accumulator columns j and j + 64 (the h
//     and gate values of one inner column) sit in the same thread: bias,
//     GELU and gate in registers (the biases from shared memory), y rounded
//     to bf16 and stored once; product 2 as m64n160 from the y tile;
//   * a producer warpgroup (whose registers go to the consumers, setmaxnreg)
//     keeps a ring of weight pieces in flight (one thread issues TMA loads,
//     cp.async.bulk.tensor with 64-column boxes, full and empty mbarriers a
//     stage): per inner chunk the W1 rows of the block's share, 64 columns of
//     C a stage, then the W2 rows of its columns, 64 inner columns a stage;
//     a box reads zeros past C, past inner and past the last row.  The
//     128-byte rows make a quarter of the TMA requests of 32-byte boxes;
//   * a first pass (geglu_stage_rows) writes the LN'd rows to a workspace,
//     and each W1 stage brings the matching 64 x 64 piece along, loaded once
//     and multicast to the row tile's K blocks: a resident (64, C) tile would
//     leave too few ring stages at C >= 640, and at C = 320 it was slower
//     than the streamed rows, its LayerNorm holding back the first product;
//   * the inner dimension is split over blocks (grid.y) where that saves
//     waves of chunks (the 16^2 and mid levels, the training shapes); each
//     split writes fp32 partial sums and geglu_finish adds them in split
//     order, so the bits repeat (no atomics anywhere);
//   * every product is issued unconditionally (a product issued under a
//     branch makes ptxas serialise every wgmma).
// The tanh GELU is evaluated through its identity 0.5 (1 + tanh z) =
// 1 / (1 + e^(-2 z)), in fp32.  One host function (plan) picks the
// instantiation, cluster, splits and workspace of a launch; geglu_plan
// reports them, and the wrapper sizes the workspace from it.
//
// fp32 takes a plain-FMA kernel (16 rows a block, fp32 products and tanhf),
// so that fp32 callers get fp32 products: wgmma has no fp32 products.
//
// Plain C interface at the bottom; no PyTorch headers.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxSmem = 232448;

struct Params {
  const void* x;
  const float* ln_scale;   // (C,) fp32, with_ln only
  const float* ln_bias;
  const void* w1;          // W1^T rows: element (n, k) at w1[n * w1_s + k]
  const float* b1;         // (2 * inner,) fp32
  const void* w2;          // W2^T rows: element (c, k) at w2[c * w2_s + k]
  const float* b2;         // (C,) fp32
  void* out;               // (rows, C) contiguous
  float* part;             // (splits, rows, C) fp32, when splits > 1
  int rows, C, inner, with_ln, splits;
  long long x_s, w1_s, w2_s;
  float eps;
};

__device__ __forceinline__ float gelu_tanh(float v) {
  const float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
  return 0.5f * v * (1.f + tanhf(kBeta * (v + kKappa * v * v * v)));
}

// the same function through the identity 0.5 (1 + tanh z) = 1 / (1 +
// e^(-2 z)): one exponential and one division, no branches (tanhf's
// polynomial and exponential paths diverge inside a warp); fp32, within a
// few units in the last place of gelu_tanh
__device__ __forceinline__ float gelu_tanh_fast(float v) {
  const float kMinus2BetaLog2e = -2.f * 0.7978845608028654f * 1.4426950408889634f;
  const float kKappa = 0.044715f;
  const float e = exp2f(kMinus2BetaLog2e * (v + kKappa * v * v * v));
  return __fdividef(v, 1.f + e);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// LayerNorm statistics of one row of `src` (fp32, variance E[x^2] - mu^2),
// by the 32 lanes of a warp; mu = 0, rstd = 1 without LN
template <typename T>
__device__ __forceinline__ void row_stats(const T* src, const Params& p,
                                          int lane, float& mu, float& rstd) {
  mu = 0.f;
  rstd = 1.f;
  if (!p.with_ln) return;
  float s = 0.f, s2 = 0.f;
  for (int c = lane; c < p.C; c += 32) {
    const float v = to_f32(src[c]);
    s += v;
    s2 += v * v;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  mu = s / p.C;
  const float var = fmaxf(s2 / p.C - mu * mu, 0.f);
  rstd = rsqrtf(var + p.eps);
}

// the normalised (with_ln) or plain value of column c of a row, fp32
template <typename T>
__device__ __forceinline__ float row_value(const T* src, const Params& p,
                                           int c, float mu, float rstd) {
  const float v = to_f32(src[c]);
  return p.with_ln ? (v - mu) * rstd * p.ln_scale[c] + p.ln_bias[c] : v;
}

// the output of (row, col) from its fp32 sum: round((x + acc) + b2) with LN
// (the residual), round(acc + b2) without
template <typename T>
__device__ __forceinline__ T finish_value(const Params& p, long long row,
                                          int col, float acc) {
  float v = acc;
  if (p.with_ln)
    v = to_f32(static_cast<const T*>(p.x)[row * p.x_s + col]) + acc;
  return T(v + p.b2[col]);
}

// the result of (row, col): into the split's partial sums, or finished
template <typename T>
__device__ __forceinline__ void store_out(const Params& p, int row, int col,
                                          float acc) {
  if (p.splits > 1) {
    p.part[((long long)blockIdx.y * p.rows + row) * p.C + col] = acc;
    return;
  }
  static_cast<T*>(p.out)[(long long)row * p.C + col] =
      finish_value<T>(p, row, col, acc);
}

// ---------------------------------------------------------------------------
// bf16: TMA-fed wgmma kernel, a cluster of blocks over the output columns
// ---------------------------------------------------------------------------

constexpr int kRows = 64;              // rows of a block: one m64 tile
constexpr int kCols = 320;             // output columns of a block
constexpr int kColsWG = 160;           // ... of a consumer warpgroup
constexpr int kShare = 128;            // inner columns a block gates a chunk
constexpr int kShareWG = 64;           // ... a consumer warpgroup
constexpr int kBK = kBlock128;         // reduction columns of a ring stage
constexpr int kSteps = kBK / 16;       // 16-deep wgmma steps of a stage
constexpr int kW1Rows = 2 * kShare;    // W1^T rows of a stage: h and gate
constexpr int kW1Bytes = kW1Rows * kRow128;     // 32 KB
constexpr int kUBytes = kRows * kRow128;        // 8 KB of LN'd rows
constexpr int kStageBytes = kCols * kRow128;    // 40 KB: W2, or W1 + u
constexpr int kMaxPartners = 2;        // row tiles of a cluster
constexpr int kMaxSplits = 16;         // blocks over the inner dimension
constexpr int kThreadsBf16 = 384;      // two consumer warpgroups + producer
constexpr int kConsumers = 256;
// registers a thread after setmaxnreg: the block holds 168 x 384, and
// 128 (168 - producer) >= 256 (consumer - 168)
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kYPieceBytes = kRows * kShare * 2;   // a block's y piece
// named barrier: the block's y piece written
constexpr int kYWritten = 1;
static_assert(kUBytes + kW1Bytes <= kStageBytes, "u + W1 piece");

// KMAX: the largest K the instantiation takes (C <= 320 KMAX)
template <int KMAX>
struct Bf16Shape {
  static constexpr int Y_BYTES = kRows * kShare * KMAX * 2;   // a y chunk
  // b1's h and gate values of the block's share of two chunks
  static constexpr int BIAS_BYTES = 2 * 2 * kShare * 4;
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT =
      (kMaxSmem - Y_BYTES - BIAS_BYTES - BAR_BYTES) / kStageBytes;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int BIAS_OFF = Y_BYTES + STAGES * kStageBytes;
  static constexpr int BAR_OFF = BIAS_OFF + BIAS_BYTES;
  static constexpr int SMEM = BAR_OFF + BAR_BYTES;
  static_assert(STAGES >= 3, "three stages must fit");
  static_assert((2 * STAGES + 2) * 8 <= BAR_BYTES, "barriers");
  static_assert(SMEM <= kMaxSmem, "shared memory of one block");
};

struct Bf16Params {
  TileMap w1, w2, u;   // u: the workspace's LN'd rows
  Params p;
  int K;               // blocks over the output columns of a row tile
  int M;               // row tiles of a cluster (weight pieces multicast)
  int chunks;          // inner chunks of kShare * K columns
  int p1_pieces;       // W1 stages a chunk: ceil(C / 64)
};

// The first pass: the LN'd (or plain) rows, bf16, into the workspace as a
// (rows, C) contiguous tensor; one warp a row.
__global__ void geglu_stage_rows(const Params p, __nv_bfloat16* u) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= p.rows) return;
  const __nv_bfloat16* src =
      static_cast<const __nv_bfloat16*>(p.x) + (long long)row * p.x_s;
  float mu, rstd;
  row_stats(src, p, lane, mu, rstd);
  for (int c = lane; c < p.C; c += 32)
    u[(long long)row * p.C + c] =
        __float2bfloat16(row_value(src, p, c, mu, rstd));
}

template <int KMAX>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    geglu_bf16(const __grid_constant__ Bf16Params P) {
  using S = Bf16Shape<KMAX>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sY = smem;                    // y chunk: 64 x kShare K
  unsigned char* ring = sY + S::Y_BYTES;       // [stage]: W1 + u, or W2
  // [chunk % 2][h | gate][kShare]: b1 of the block's share of a chunk
  float* sB = reinterpret_cast<float*>(smem + S::BIAS_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* empty = full + STAGES;
  uint64_t* yfull = empty + STAGES;    // a chunk's y pieces have arrived
  uint64_t* yempty = yfull + 1;        // the row tile's product 2 is done

  const Params& p = P.p;
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = warp_uniform(tid >> 5);
  // the cluster: M row tiles x K blocks over the output columns; this
  // block owns column slice kr of row tile mr
  const int K = P.K, M = P.M, CS = K * M, rank = cluster_rank();
  const int kr = rank % K, mr = rank / K;
  const int row0 = (int)((blockIdx.x / CS) * M + mr) * kRows;
  // weight pieces go to the row partners (same columns), the LN'd rows to
  // the column partners (same row tile): the blocks that write into this
  // block's stages, and into which it writes
  uint16_t w_mask = 0, u_mask = 0;
  for (int m = 0; m < M; ++m) w_mask |= 1u << (kr + K * m);
  for (int d = 0; d < K; ++d) u_mask |= 1u << (d + K * mr);
  const uint16_t writers = w_mask | u_mask;
  const int j_begin = (int)((long long)blockIdx.y * P.chunks / p.splits);
  const int j_end = (int)((long long)(blockIdx.y + 1) * P.chunks / p.splits);
  const int chunks = j_end - j_begin;
  const int bi = kShare * K;              // inner columns of a chunk
  const int NP1 = P.p1_pieces, NP2 = bi / kBK;

  if (warp == 8 && lane == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      // one arrival a consumer warp of every block this block writes into:
      // the loads that refill a stage write it there too
      mbar_init(&empty[s], kConsumers / 32 * __popc(writers));
    }
    mbar_init(yfull, 1);                       // + the peers' y pieces
    mbar_init(yempty, kConsumers / 32 * K);    // every consumer warp of
                                               // the row tile's blocks
    mbar_init_fence();
  }
  // every block's barriers exist before any block arrives on them
  __syncwarp();
  cluster_sync();

  if (warp >= 8) {   // the producer: one thread issues the loads
    regs_dealloc<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      prefetch_tensormap(&P.w1.map);
      prefetch_tensormap(&P.w2.map);
      prefetch_tensormap(&P.u.map);
      // each block issues its share of a stage's boxes; every block's
      // barrier expects them all
      int it = 0;
      for (int c = 0; c < chunks; ++c) {
        const int n0 = (j_begin + c) * bi;
        // product 1: per consumer warpgroup its 64 h rows of W1^T above the
        // 64 matching gate rows (the map's head index is the half)
        for (int pc = 0; pc < NP1; ++pc, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = ring + s * kStageBytes;
          // the chunk's first stage also brings b1 of the block's share
          const int nb = pc > 0 ? 0 : min(kShare, p.inner - n0 - kr * kShare);
          const uint32_t bias_bytes = nb > 0 ? nb * 4 : 0;
          mbar_arrive_tx(&full[s], kW1Bytes + kUBytes + 2 * bias_bytes);
          if (bias_bytes) {
            float* dst = sB + (c & 1) * 2 * kShare;
            bulk_load(dst, p.b1 + n0 + kr * kShare, bias_bytes, &full[s]);
            bulk_load(dst + kShare, p.b1 + p.inner + n0 + kr * kShare,
                      bias_bytes, &full[s]);
          }
          for (int b = mr; b < 4; b += M)
            load_box_multicast(st + (b >> 1) * 2 * kShareWG * kRow128 +
                                   (b & 1) * kShareWG * kRow128,
                               P.w1, &full[s], pc * kBK,
                               n0 + kr * kShare + (b >> 1) * kShareWG, b & 1,
                               0, w_mask);
          if (kr == 0)
            load_box_multicast(st + kW1Bytes, P.u, &full[s], pc * kBK, row0,
                               0, 0, u_mask);
        }
        // product 2: the block's 320 rows of W2^T, 160 a warpgroup
        for (int q = 0; q < NP2; ++q, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = ring + s * kStageBytes;
          mbar_arrive_tx(&full[s], kStageBytes);
          for (int b = mr; b < 2; b += M)
            load_box_multicast(st + b * kColsWG * kRow128, P.w2, &full[s],
                               n0 + q * kBK, kr * kCols + b * kColsWG, 0, 0,
                               w_mask);
        }
      }
    }
  } else {
    regs_alloc<kConsumerRegs>();

    // consumer warpgroup wg: all 64 rows; output columns [160 wg, 160 wg +
    // 160) of the block's 320, and inner columns [64 wg, 64 wg + 64) of the
    // block's share of each chunk.  This thread holds rows lane / 4 and
    // lane / 4 + 8 of its warp's 16 (accumulator layout: hopper.cuh)
    const int wg = warp >> 2, w = warp & 3, t4 = lane & 3;
    const uint32_t y_local = smem_u32(sY);
    float acc[kColsWG / 2];              // product 2: out columns
    float hg[2 * kShareWG / 2];          // product 1: h | gate columns
#pragma unroll
    for (int i = 0; i < kColsWG / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kShareWG; ++i) hg[i] = 0.f;

    // stage `it`'s batch has retired: its buffer may take the next load
    // from every block that writes into it
    auto release = [&](int it) {
      if (lane == 0)
        for (int d = 0; d < CS; ++d)
          if (writers >> d & 1)
            mbar_arrive_remote(cluster_addr(smem_u32(&empty[it % STAGES]), d));
    };
    int it = 0, pending = -1;   // the stage of the batch still in flight
    for (int c = 0; c < chunks; ++c) {
      // product 1: [h | gate] (64 x 128) = u W1^T over C, a stage at a time,
      // one batch kept in flight while the next stage is waited for
      for (int pc = 0; pc < NP1; ++pc, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = ring + s * kStageBytes;
        const unsigned char* su = st + kW1Bytes;
        const unsigned char* sw = st + wg * 2 * kShareWG * kRow128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          Mma<2 * kShareWG>::template ss<0>(hg, desc_k128(su, kk),
                                            desc_k128(sw, kk),
                                            (pc | kk) != 0);
        wgmma_commit();
        wgmma_wait<1>();
        if (pending >= 0) release(pending);
        if (pc == 0 && c > 0) {
          // product 2 of the last chunk has retired: its y tile is free, as
          // far as this warp goes, in every block of the row tile
          __syncwarp();
          if (lane == 0)
            for (int d = 0; d < K; ++d)
              mbar_arrive_remote(cluster_addr(smem_u32(yempty), d + K * mr));
        }
        pending = it;
      }
      wgmma_wait<0>();
      fence_regs(hg);
      release(pending);
      pending = -1;

      // y = (h + b1h) * gelu(g + b1g) in fp32, rounded to bf16 (columns
      // beyond inner give 0), into this block's piece of the y tile, once
      // every block of the row tile is done with the last chunk's.  This
      // thread's columns are 8 j + 2 t4 + {0, 1} of the warpgroup's 64
      const int n_share = (j_begin + c) * bi + kr * kShare + wg * kShareWG;
      const float* bias = sB + (c & 1) * 2 * kShare + wg * kShareWG + 2 * t4;
      uint32_t yv[kShareWG / 8][2];
#pragma unroll
      for (int j = 0; j < kShareWG / 8; ++j) {
        const float2 bh = *reinterpret_cast<const float2*>(bias + j * 8);
        const float2 bg =
            *reinterpret_cast<const float2*>(bias + kShare + j * 8);
        const bool in = n_share + j * 8 + 2 * t4 < p.inner;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float* h = hg + 4 * j + 2 * r;
          const float* g = hg + 4 * (j + kShareWG / 8) + 2 * r;
          yv[j][r] = in ? bf16x2((h[0] + bh.x) * gelu_tanh_fast(g[0] + bg.x),
                                 (h[1] + bh.y) * gelu_tanh_fast(g[1] + bg.y))
                        : 0u;
        }
      }
      if (c > 0) mbar_wait(yempty, (c - 1) & 1);
      const int y_col = kr * kShare + wg * kShareWG + 2 * t4;
#pragma unroll
      for (int j = 0; j < kShareWG / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(
              sY + swz128_offset(w * 16 + (lane >> 2) + 8 * r, y_col + j * 8,
                                 kRows)) = yv[j][r];
      fence_proxy_async();
      bar_sync(kYWritten, kConsumers);
      if (tid == 0) {
        // the piece (64 rows x 128 columns, contiguous) to the other blocks
        // of the row tile; they expect it on their yfull
        const int piece = kr * kYPieceBytes;
        mbar_arrive_tx(yfull, (K - 1) * kYPieceBytes);
        for (int d = 0; d < K; ++d)
          if (d != kr)
            bulk_copy_peer(cluster_addr(y_local + piece, d + K * mr),
                           sY + piece, kYPieceBytes,
                           cluster_addr(smem_u32(yfull), d + K * mr));
      }
      mbar_wait(yfull, c & 1);

      // product 2: acc (64 x 160) += y (64 x bi) W2^T, a stage at a time
      for (int q = 0; q < NP2; ++q, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* sw = ring + s * kStageBytes +
                                  wg * kColsWG * kRow128;
        const unsigned char* sy = sY + q * kUBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk)
          Mma<kColsWG>::template ss<0>(acc, desc_k128(sy, kk),
                                       desc_k128(sw, kk), 1);
        wgmma_commit();
        wgmma_wait<1>();
        if (pending >= 0) release(pending);
        pending = it;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (pending >= 0) release(pending);

    // epilogue: the rows and columns that exist
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + w * 16 + (lane >> 2) + 8 * r;
      if (row >= p.rows) continue;
#pragma unroll
      for (int j = 0; j < kColsWG / 8; ++j) {
        const int col = kr * kCols + wg * kColsWG + j * 8 + 2 * t4;
        if (col >= p.C) continue;   // C is a multiple of 8: both exist
        const float a0 = acc[4 * j + 2 * r], a1 = acc[4 * j + 2 * r + 1];
        if (p.splits > 1) {
          *reinterpret_cast<float2*>(
              p.part + ((long long)blockIdx.y * p.rows + row) * p.C + col) =
              make_float2(a0, a1);
        } else {
          __nv_bfloat162 o;
          o.x = finish_value<__nv_bfloat16>(p, row, col, a0);
          o.y = finish_value<__nv_bfloat16>(p, row, col + 1, a1);
          *reinterpret_cast<__nv_bfloat162*>(
              static_cast<__nv_bfloat16*>(p.out) + (long long)row * p.C +
              col) = o;
        }
      }
    }
  }
  // no block leaves while another may still write into its shared memory or
  // arrive on its barriers
  __syncwarp();
  cluster_sync();
}

// ---------------------------------------------------------------------------
// fp32: plain-FMA kernel (fp32 products, as an fp32 caller expects)
// ---------------------------------------------------------------------------
// A block owns 16 rows.  Product 1: thread t computes the h and gate values
// of inner column t % 64 for rows t / 64 + 4i; W1 chunks of 32 k staged in
// shared memory (odd row stride: no bank conflicts).  Product 2: thread t
// owns output columns t + 256i (i < NC) of all 16 rows; W2 chunks of C rows
// x 16 k staged likewise.  Synchronous loads: this kernel is for fp32
// callers (the tiny models, checks), not for speed.

constexpr int kF32Rows = 16, kF32Threads = 256, kF32Warps = 8;
constexpr int kBI = 64;                 // inner columns per sweep step

__host__ __device__ constexpr int f32_smem(int C) {
  return (kF32Rows * C + 2 * kBI * 33 + kF32Rows * kBI + C * 17) * 4;
}

template <int NC>   // C <= 256 * NC
__global__ void __launch_bounds__(kF32Threads, 1) geglu_f32(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int C = p.C;
  float* sX = reinterpret_cast<float*>(smem_raw);   // [16][C]
  float* sW1 = sX + kF32Rows * C;                   // [128][33]
  float* sY = sW1 + 2 * kBI * 33;                   // [16][64]
  float* sW2 = sY + kF32Rows * kBI;                 // [C][17]
  const float* w1 = static_cast<const float*>(p.w1);
  const float* w2 = static_cast<const float*>(p.w2);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kF32Rows;
  const int J = (p.inner + kBI - 1) / kBI;
  const int j_begin = (int)((long long)blockIdx.y * J / p.splits);
  const int j_end = (int)((long long)(blockIdx.y + 1) * J / p.splits);

  // the block's rows, normalised (with_ln) or as they are; one warp a row
  for (int r = warp; r < kF32Rows; r += kF32Warps) {
    const int gr = row0 + r;
    const float* src = static_cast<const float*>(p.x) + (long long)gr * p.x_s;
    float mu = 0.f, rstd = 1.f;
    if (gr < p.rows) row_stats(src, p, lane, mu, rstd);
    for (int c = lane; c < C; c += 32)
      sX[r * C + c] = gr < p.rows ? row_value(src, p, c, mu, rstd) : 0.f;
  }

  float acc[kF32Rows][NC];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[r][i] = 0.f;

  const int jj = tid & (kBI - 1), rb = tid / kBI;   // product-1 ownership
  for (int j = j_begin; j < j_end; ++j) {
    float h[4] = {0.f, 0.f, 0.f, 0.f}, g[4] = {0.f, 0.f, 0.f, 0.f};
    const int n = j * kBI + jj;
    for (int k0 = 0; k0 < C; k0 += 32) {
      __syncthreads();   // sX written; the previous chunk consumed
      for (int i = tid; i < 2 * kBI * 32; i += kF32Threads) {
        const int r = i >> 5, kk = i & 31;
        const int nr = j * kBI + (r & (kBI - 1)), k = k0 + kk;
        sW1[r * 33 + kk] =
            nr < p.inner && k < C
                ? w1[(long long)(r < kBI ? nr : p.inner + nr) * p.w1_s + k]
                : 0.f;
      }
      __syncthreads();
      const int kn = min(32, C - k0);
      for (int kk = 0; kk < kn; ++kk) {
        const float wh = sW1[jj * 33 + kk], wg = sW1[(kBI + jj) * 33 + kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float xv = sX[(rb + 4 * i) * C + k0 + kk];
          h[i] = fmaf(xv, wh, h[i]);
          g[i] = fmaf(xv, wg, g[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sY[(rb + 4 * i) * kBI + jj] =
          n < p.inner ? (h[i] + p.b1[n]) * gelu_tanh(g[i] + p.b1[p.inner + n])
                      : 0.f;
    for (int kc = 0; kc < kBI / 16; ++kc) {
      __syncthreads();   // sY written; the previous W2 chunk consumed
      for (int i = tid; i < C * 16; i += kF32Threads) {
        const int c = i >> 4, kk = i & 15;
        const int k = j * kBI + kc * 16 + kk;
        sW2[c * 17 + kk] = k < p.inner ? w2[(long long)c * p.w2_s + k] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < 16; ++kk) {
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float yv = sY[r * kBI + kc * 16 + kk];
#pragma unroll
          for (int i = 0; i < NC; ++i) {
            const int c = tid + kF32Threads * i;
            if (c < C) acc[r][i] = fmaf(yv, sW2[c * 17 + kk], acc[r][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int row = row0 + r;
    if (row >= p.rows) continue;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = tid + kF32Threads * i;
      if (c < C) store_out<float>(p, row, c, acc[r][i]);
    }
  }
}

// ---------------------------------------------------------------------------
// split inner dimension: the partial sums, added in split order
// ---------------------------------------------------------------------------

template <typename T>
__global__ void geglu_finish(const Params p) {
  const long long n = (long long)p.rows * p.C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = p.part[i];
    for (int s = 1; s < p.splits; ++s) acc += p.part[s * n + i];
    const long long row = i / p.C;
    const int col = (int)(i - row * p.C);
    static_cast<T*>(p.out)[i] = finish_value<T>(p, row, col, acc);
  }
}

template <typename T>
cudaError_t launch_finish(const Params& p, cudaStream_t stream) {
  const long long n = (long long)p.rows * p.C;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  geglu_finish<T><<<blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// the plan: the one place a launch's tiling is chosen
// ---------------------------------------------------------------------------

// streaming multiprocessors of the current device (0 if it cannot be read)
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <int KMAX>
cudaLaunchConfig_t bf16_config(int cluster, dim3 grid,
                               cudaLaunchAttribute* attr,
                               cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreadsBf16);
  cfg.dynamicSmemBytes = Bf16Shape<KMAX>::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// blocks of an instantiation that can run at once in clusters of `cluster`
// blocks: a cluster takes that many SMs of one GPC, so SMs may be left over
// (cached; one device type a process); -1 if the runtime cannot say
template <int KMAX>
int resident_blocks(int cluster) {
  static int cache[KMAX * kMaxPartners + 1] = {};
  if (cache[cluster] == 0) {
    const auto kernel = geglu_bf16<KMAX>;
    int clusters = 0;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        bf16_config<KMAX>(cluster, dim3(cluster), &attr, nullptr);
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Bf16Shape<KMAX>::SMEM) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg) !=
            cudaSuccess)
      clusters = 0;
    cache[cluster] = clusters > 0 ? clusters * cluster : -1;
  }
  return cache[cluster];
}

struct Plan {
  int variant;          // bf16: 1, 2 or 4 (the instantiation's KMAX); fp32: 0
  int cluster;          // K: blocks over the output columns of a row tile
  int partners;         // M: row tiles of a cluster (bf16), each weight
                        // piece multicast to them
  int rows;             // rows a block
  int threads;
  int smem;             // dynamic shared bytes a block
  int stages;           // ring stages (bf16)
  int splits;           // blocks over the inner dimension
  int chunk;            // inner columns a sweep step (a row tile's)
  int capacity;         // blocks that run at once
  long long row_tiles;  // (bf16: a multiple of M)
  long long workspace;  // bytes: partial sums, then (bf16) the LN'd rows
};

// The instantiation's numbers, and the row partners M and splits of a
// launch: the pair that takes the fewest chunk-times, counting the waves of
// blocks (clusters of K M blocks may leave SMs unused: resident_blocks)
// times a block's chunks plus one for what a block spends outside its
// chunks (set-up, the first loads, the epilogue); among equals, two row
// tiles a cluster (half the weights' L2 reads) and then the fewest splits
// (the least partial-sum traffic).
template <int KMAX>
void bf16_shape(Plan& f, long long tiles, int chunks, int sms) {
  using S = Bf16Shape<KMAX>;
  f.variant = KMAX;
  f.threads = kThreadsBf16;
  f.smem = S::SMEM;
  f.stages = S::STAGES;
  long long best = -1;
  for (int m = kMaxPartners; m >= 1; --m) {
    const int r = resident_blocks<KMAX>(f.cluster * m);
    const int cap = r > 0 && r < sms ? r : sms;
    const long long blocks = (tiles + m - 1) / m * m * f.cluster;
    for (int sp = 1; sp <= chunks && sp <= kMaxSplits; ++sp) {
      const long long waves = (blocks * sp + cap - 1) / cap;
      const long long cost = waves * ((chunks + sp - 1) / sp + 1);
      if (best < 0 || cost < best) {
        best = cost;
        f.partners = m;
        f.splits = sp;
        f.capacity = cap;
      }
    }
  }
  f.row_tiles = (tiles + f.partners - 1) / f.partners * f.partners;
}

inline long long align256(long long n) { return (n + 255) / 256 * 256; }

// bf16: clusters of M row tiles of 64 rows x K = ceil(C / 320) blocks of
// 320 columns, the inner dimension split where that saves waves of chunks
// (bf16_shape); fp32: blocks of 16 rows, the inner dimension split as far
// as the blocks fill the card once.
Plan plan(int dtype, int rows, int C, int inner, int sms) {
  Plan f = {};
  if (dtype == 1) {
    f.cluster = (C + kCols - 1) / kCols;
    f.rows = kRows;
    f.chunk = kShare * f.cluster;
    const long long tiles = (rows + kRows - 1) / kRows;
    const int chunks = (inner + f.chunk - 1) / f.chunk;
    if (f.cluster == 1) bf16_shape<1>(f, tiles, chunks, sms);
    else if (f.cluster == 2) bf16_shape<2>(f, tiles, chunks, sms);
    else bf16_shape<4>(f, tiles, chunks, sms);
  } else {
    // fp32: as many splits as fill the card once
    f.cluster = f.partners = 1;
    f.rows = kF32Rows;
    f.threads = kF32Threads;
    f.smem = f32_smem(C);
    f.chunk = kBI;
    f.capacity = sms;
    f.row_tiles = (rows + kF32Rows - 1) / kF32Rows;
    const int chunks = (inner + f.chunk - 1) / f.chunk;
    const long long fill =
        f.row_tiles < f.capacity ? f.capacity / f.row_tiles : 1;
    f.splits = (int)(fill < chunks ? fill : chunks);
  }
  const long long part =
      f.splits > 1 ? align256((long long)f.splits * rows * C * 4) : 0;
  f.workspace = part + (dtype == 1 ? align256((long long)rows * C * 2) : 0);
  return f;
}

template <int KMAX>
int launch_bf16(const Params& p, const Plan& f, cudaStream_t stream) {
  Bf16Params P = {};
  P.p = p;
  P.K = f.cluster;
  P.M = f.partners;
  P.chunks = (p.inner + f.chunk - 1) / f.chunk;
  P.p1_pieces = (p.C + kBK - 1) / kBK;
  // W1^T as (1, 2 halves, inner rows, C): the head index is the half
  const Strides s1 = {0, (long long)p.inner * p.w1_s, p.w1_s};
  const Strides s2 = {0, 0, p.w2_s};
  if (!make_map(P.w1, p.w1, s1, 1, 2, p.inner, p.C, kShareWG, kBK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(P.w2, p.w2, s2, 1, 1, p.C, p.inner, kColsWG, kBK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return kMapRefused;
  // the first pass: the LN'd rows into the workspace, after the partial sums
  __nv_bfloat16* u = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<unsigned char*>(p.part) +
      (f.splits > 1 ? align256((long long)f.splits * p.rows * p.C * 4) : 0));
  geglu_stage_rows<<<(p.rows + 7) / 8, 256, 0, stream>>>(p, u);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const Strides su = {0, 0, p.C};
  if (!make_map(P.u, u, su, 1, 1, p.rows, p.C, kRows, kBK,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return kMapRefused;
  const auto kernel = geglu_bf16<KMAX>;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Bf16Shape<KMAX>::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = bf16_config<KMAX>(
      f.cluster * f.partners,
      dim3((unsigned)(f.row_tiles * f.cluster), f.splits), &attr, stream);
  e = cudaLaunchKernelEx(&cfg, kernel, P);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int NC>
cudaError_t launch_f32(const Params& p, const Plan& f, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      geglu_f32<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)f.row_tiles, f.splits);
  geglu_f32<NC><<<grid, kF32Threads, f.smem, stream>>>(p);
  return cudaGetLastError();
}

int dispatch(const Params& p, int dtype, const Plan& f, cudaStream_t st) {
  int e;
  if (dtype == 1) {
    if (f.variant == 1) e = launch_bf16<1>(p, f, st);
    else if (f.variant == 2) e = launch_bf16<2>(p, f, st);
    else e = launch_bf16<4>(p, f, st);
  } else {
    if (p.C <= 256) e = launch_f32<1>(p, f, st);
    else if (p.C <= 512) e = launch_f32<2>(p, f, st);
    else if (p.C <= 768) e = launch_f32<3>(p, f, st);
    else if (p.C <= 1024) e = launch_f32<4>(p, f, st);
    else e = launch_f32<5>(p, f, st);
  }
  if (e != 0 || p.splits == 1) return e;
  return dtype == 1 ? launch_finish<__nv_bfloat16>(p, st)
                    : launch_finish<float>(p, st);
}

// sizes the kernels do not take
bool bad_args(int dtype, int rows, int C, int inner) {
  return rows <= 0 || C <= 0 || C > 1280 || inner <= 0 ||
         (dtype != 0 && dtype != 1) ||
         (dtype == 1 && (C % 8 || inner % 8)) ||
         (dtype == 0 && f32_smem(C) > kMaxSmem);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2 and out of that type; LN
// scale and bias, b1 and b2 fp32).  with_ln: 1 = x + GEGLU(LN(x)) (Pallas
// _kernel_block), 0 = GEGLU(x) (Pallas _kernel).  x_s, w1_s, w2_s: row
// strides in elements (column stride 1).  `part` is the workspace of
// geglu_plan's size (the split partial sums, then, in bf16, a copy of the
// LN'd rows); `splits` must be geglu_plan's.  bf16 needs
// C and inner multiples of 8, 16-byte aligned w1, w2 and b1 pointers (b1 is
// copied by the bulk-copy unit) and weight row strides that are multiples of
// 8.  Returns 0 on success, a cudaError_t
// value if a launch was refused, -1 for arguments the kernels do not take,
// or -2 if the driver refused a tensor map.

extern "C" int geglu_fwd(const void* x, const float* ln_scale,
                         const float* ln_bias, const void* w1,
                         const float* b1, const void* w2, const float* b2,
                         void* out, float* part, int dtype, int with_ln,
                         int rows, int C, int inner, int splits,
                         long long x_s, long long w1_s, long long w2_s,
                         float eps, void* stream) {
  if (bad_args(dtype, rows, C, inner)) return -1;
  if (dtype == 1 && (w1_s % 8 || w2_s % 8 ||
                     reinterpret_cast<uintptr_t>(w1) % 16 ||
                     reinterpret_cast<uintptr_t>(w2) % 16 ||
                     reinterpret_cast<uintptr_t>(b1) % 16))
    return -1;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const Plan f = plan(dtype, rows, C, inner, sms);
  if (splits != f.splits || (f.workspace > 0 && part == nullptr)) return -1;
  Params p;
  p.x = x; p.ln_scale = ln_scale; p.ln_bias = ln_bias;
  p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.out = out; p.part = part;
  p.rows = rows; p.C = C; p.inner = inner; p.with_ln = with_ln;
  p.splits = splits;
  p.x_s = x_s; p.w1_s = w1_s; p.w2_s = w2_s;
  p.eps = eps;
  return dispatch(p, dtype, f, static_cast<cudaStream_t>(stream));
}

// How a launch at this shape runs on a device of `sm_count` SMs, as
// geglu_fwd decides it: out[] = {variant (bf16: the instantiation's
// largest K, 1, 2 or 4; fp32: 0), K (blocks over the output columns of a
// row tile), row tiles of a cluster (a cluster is K times that many blocks),
// rows a block, threads, dynamic shared bytes, ring stages, splits of the
// inner dimension, inner columns a sweep step, blocks that fill the card
// once, row tiles, workspace bytes}.  Returns -1 for arguments the kernels do not take.
extern "C" int geglu_plan(int dtype, int rows, int C, int inner, int sm_count,
                          long long* out) {
  if (bad_args(dtype, rows, C, inner) || sm_count <= 0) return -1;
  const Plan f = plan(dtype, rows, C, inner, sm_count);
  const long long v[12] = {f.variant, f.cluster,  f.partners, f.rows,
                           f.threads, f.smem,     f.stages,   f.splits,
                           f.chunk,   f.capacity, f.row_tiles, f.workspace};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* geglu_error_string(int code) {
  if (code == -1)
    return "arguments not supported by geglu_fwd (or splits other than "
           "geglu_plan's)";
  if (code == kMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map (driver entry point "
           "missing, or strides the TMA unit does not take)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
