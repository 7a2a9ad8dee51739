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
//
// Weights are read in place through their strides in the layout of the
// port's nn.Linear parameters: W1^T is (2*inner, C) with rows [0, inner) the
// h half and [inner, 2*inner) the gate half, W2^T is (C, inner); both have
// the reduction dimension contiguous, which is what mma.sync's col-major B
// operand wants.  x and out are (rows, C) with unit column stride.
//
// What bounds it on an H100.  At SD v1 shapes the work is 24*rows*C^2 flop
// against x, out and the weights (6*C^2 values): several thousand flop per
// byte of device memory, so tensor-core operations bound it -- as long as the
// (rows, 4C) gated intermediate never leaves the SM.  What stands in the way
// is the fp32 accumulator of a row tile: (rows_per_block, C) fp32 is 320 KB
// for 64 rows at C = 1280, more than a block's shared memory or the register
// file.
//
// What the design does about it: few enough rows per block that the
// accumulator fits in registers.  A block of 8 warps owns BM rows and all C
// output columns; each warp keeps BM x C/8 fp32 accumulators (80 a thread):
// BM = 64 at C <= 320, 32 at C <= 640, 16 at C <= 1280.  The block sweeps the
// inner dimension 64 columns at a time: (1) the h and gate tiles of the
// first product from the LN'd rows held in shared memory (bf16) and W1
// chunks, (2) bias, GELU and gate in registers, y rounded to bf16 into
// shared memory, (3) acc += y W2 for the block's rows.  Weight chunks stream
// through a ring of shared-memory stages filled by cp.async, one barrier per
// chunk.  The cost of this
// choice: the weights (39 MB in bf16 at C = 1280) are read once per row
// tile, mostly from the 50 MB L2, which is why the same operations take about
// twice as long at the wide levels as at C = 320 (PERF.md).  Where the row
// tiles alone cannot fill the card, the inner dimension is split over blocks
// (grid.y); each split writes fp32 partial sums and geglu_finish adds them in
// a fixed order, so the result repeats bit for bit.  Rows and columns beyond
// the tensors are zero-filled in shared memory and skipped on store; no
// padding copy in device memory.
//
// bf16 takes mma.sync.m16n8k16 with fp32 accumulation; fp32 takes a
// plain-FMA kernel of the same structure (16 rows a block, fp32 products and
// tanhf), so that fp32 callers get fp32 products.  wgmma, TMA and a
// thread-block cluster that shares the accumulator over several SMs (so that
// the weights are read once per larger row tile) are left for a later change.
//
// Plain C interface at the bottom; no PyTorch headers.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 8, kThreads = 256;
constexpr int kBI = 64;                 // inner columns per sweep step
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// The block's input rows, normalised (with_ln) or as they are, into a
// BM x LD shared tile of type T; columns in [C, cols_padded) and rows beyond
// the tensor are zero.  One warp per row; fp32 statistics.
template <typename T, int BM>
__device__ __forceinline__ void load_rows(T* sX, int LD, int cols_padded,
                                          const Params& p, int row0,
                                          int warp, int lane) {
  const T* gx = static_cast<const T*>(p.x);
  for (int r = warp; r < BM; r += kWarps) {
    const int gr = row0 + r;
    T* dst = sX + r * LD;
    if (gr >= p.rows) {
      for (int c = lane; c < cols_padded; c += 32) dst[c] = T(0.f);
      continue;
    }
    const T* src = gx + gr * p.x_s;
    float mu = 0.f, rstd = 1.f;
    if (p.with_ln) {
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
    for (int c = lane; c < cols_padded; c += 32) {
      float v = 0.f;
      if (c < p.C) {
        v = to_f32(src[c]);
        if (p.with_ln) v = (v - mu) * rstd * p.ln_scale[c] + p.ln_bias[c];
      }
      dst[c] = T(v);
    }
  }
}

// out = round((x + acc) + b2) or round(acc + b2); or, split, the partial sum
template <typename T>
__device__ __forceinline__ void store_out(const Params& p, int row, int col,
                                          float acc) {
  if (p.splits > 1) {
    p.part[((long long)blockIdx.y * p.rows + row) * p.C + col] = acc;
    return;
  }
  float v = acc;
  if (p.with_ln)
    v = to_f32(static_cast<const T*>(p.x)[row * p.x_s + col]) + acc;
  v += p.b2[col];
  static_cast<T*>(p.out)[(long long)row * p.C + col] = T(v);
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

template <int BM, int NT8, int KW1>
struct Bf16Tile {
  static constexpr int CP = 64 * NT8;          // C padded: 8 warps x NT8 x 8
  static constexpr int MW = BM / 16;           // m16 tiles of the block
  static constexpr int CG = kWarps / MW;       // column groups in product 1
  static constexpr int NB1 = kBI / CG;         // h (and gate) columns a warp
  static constexpr int NH = NB1 / 8;
  static constexpr int LDX = CP + 8, LDW1 = KW1 + 8, LDW2 = 16 + 8,
                       LDY = kBI + 8;
  static constexpr int KC1 = CP / KW1;         // W1 chunks (KW1 k) per step
  static constexpr int KC2 = kBI / 16;         // W2 chunks (16 k) per step
  static constexpr int PER_J = KC1 + KC2;
  static constexpr int W1_CHUNK = 2 * kBI * LDW1, W2_CHUNK = CP * LDW2;
  static constexpr int STAGE = W1_CHUNK > W2_CHUNK ? W1_CHUNK : W2_CHUNK;
  static constexpr int FIXED = (BM * LDX + BM * LDY) * 2;
  // as many stages as shared memory holds, up to 8: with one block of 8
  // warps a SM, the chunks in flight are what hides the L2 latency
  static constexpr int FIT = (kMaxSmem - FIXED) / (STAGE * 2);
  static constexpr int NST = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = FIXED + NST * STAGE * 2;
  static_assert(NST >= 2, "two stages must fit");
};

template <int BM, int NT8, int KW1>
__global__ void __launch_bounds__(kThreads, 1) geglu_bf16(const Params p) {
  using L = Bf16Tile<BM, NT8, KW1>;
  constexpr int CP = L::CP, NB1 = L::NB1, NH = L::NH, LDX = L::LDX,
                LDW1 = L::LDW1, LDW2 = L::LDW2, LDY = L::LDY, KC1 = L::KC1,
                PER_J = L::PER_J, STAGE = L::STAGE, NST = L::NST;
  constexpr int MT = BM / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sY = sX + BM * LDX;
  __nv_bfloat16* sW = sY + BM * LDY;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int mg = warp % L::MW, cg = warp / L::MW;   // product-1 warp tile
  const __nv_bfloat16* w1 = static_cast<const __nv_bfloat16*>(p.w1);
  const __nv_bfloat16* w2 = static_cast<const __nv_bfloat16*>(p.w2);
  const int J = (p.inner + kBI - 1) / kBI;
  const int j_begin = (int)((long long)blockIdx.y * J / p.splits);
  const int j_end = (int)((long long)(blockIdx.y + 1) * J / p.splits);
  const int Q = (j_end - j_begin) * PER_J;

  // chunk q of the sweep: per inner step j, KC1 chunks of W1 (64 h rows and
  // the 64 matching gate rows, KW1 k each), then 4 chunks of W2 (CP rows,
  // 16 k each)
  auto load_chunk = [&](int q) {
    __nv_bfloat16* dst = sW + (q % NST) * STAGE;
    const int j = j_begin + q / PER_J, c = q % PER_J;
    if (c < KC1) {
      constexpr int CH = KW1 / 8;    // 16-byte pieces of a row
      for (int i = tid; i < 2 * kBI * CH; i += kThreads) {
        const int r = i / CH, ch = i % CH;
        const int n = j * kBI + (r & (kBI - 1)), k = c * KW1 + ch * 8;
        const bool ok = n < p.inner && k < p.C;
        const __nv_bfloat16* src =
            w1 + (long long)(r < kBI ? n : p.inner + n) * p.w1_s + k;
        cp_async16(dst + r * LDW1 + ch * 8, ok ? src : w1, ok);
      }
    } else {
      const int k0 = j * kBI + (c - KC1) * 16;
      for (int i = tid; i < CP * 2; i += kThreads) {
        const int n = i >> 1, h = i & 1;
        const int k = k0 + h * 8;
        const bool ok = n < p.C && k < p.inner;
        cp_async16(dst + n * LDW2 + h * 8,
                   ok ? w2 + (long long)n * p.w2_s + k : w2, ok);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < Q) load_chunk(s);
    cp_async_commit();
  }
  load_rows<__nv_bfloat16, BM>(sX, LDX, CP, p, row0, warp, lane);

  float acc[MT][NT8][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  float hacc[NH][4], gacc[NH][4];

  for (int q = 0; q < Q; ++q) {
    // NST stages, one barrier per chunk: once chunk q has landed and every
    // warp is past chunk q - 1, that chunk's stage takes chunk q + NST - 1
    cp_async_wait<NST - 2>();
    __syncthreads();
    if (q + NST - 1 < Q) load_chunk(q + NST - 1);
    cp_async_commit();
    const __nv_bfloat16* st = sW + (q % NST) * STAGE;
    const int j = j_begin + q / PER_J, c = q % PER_J;

    if (c < KC1) {
      // product 1: h and gate tiles (16 x NB1 each) of this warp
      if (c == 0) {
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) hacc[n][e] = gacc[n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < KW1 / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sX + (mg * 16 + (lane & 15)) * LDX + c * KW1 +
                           kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n = 0; n < NH; ++n) {
          // lanes 0-15: the h rows, 16-31: the same columns' gate rows
          uint32_t b[4];
          ldmatrix_x4(b, st + ((lane >> 4) * kBI + cg * NB1 + n * 8 +
                               (lane & 7)) * LDW1 +
                             kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16(hacc[n], a, b[0], b[1]);
          mma_bf16(gacc[n], a, b[2], b[3]);
        }
      }
      if (c == KC1 - 1) {
        // y = (h + b1h) * gelu(g + b1g) in fp32, rounded to bf16; columns
        // beyond `inner` give 0
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = mg * 16 + (lane >> 2) + half * 8;
            const int col = cg * NB1 + n * 8 + (lane & 3) * 2;
            float y[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ni = j * kBI + col + e;
              y[e] = 0.f;
              if (ni < p.inner) {
                const float hv = hacc[n][2 * half + e] + p.b1[ni];
                const float gv = gacc[n][2 * half + e] + p.b1[p.inner + ni];
                y[e] = hv * gelu_tanh(gv);
              }
            }
            *reinterpret_cast<__nv_bfloat162*>(sY + row * LDY + col) =
                __floats2bfloat162_rn(y[0], y[1]);
          }
      }
    } else {
      // product 2: acc (BM x NT8*8 of this warp) += y[:, 16 k] W2 chunk
      const int kc = c - KC1;
      uint32_t a[MT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        ldmatrix_x4(a[m], sY + (m * 16 + (lane & 15)) * LDY + kc * 16 +
                              (lane >> 4) * 8);
      const __nv_bfloat16* sB = st + warp * NT8 * 8 * LDW2;
#pragma unroll
      for (int n = 0; n + 1 < NT8; n += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sB + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * LDW2 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16(acc[m][n], a[m], b[0], b[1]);
          mma_bf16(acc[m][n + 1], a[m], b[2], b[3]);
        }
      }
      if constexpr (NT8 % 2 == 1) {
        uint32_t b[2];
        ldmatrix_x2(b, sB + ((NT8 - 1) * 8 + (lane & 7)) * LDW2 +
                           ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma_bf16(acc[m][NT8 - 1], a[m], b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + m * 16 + (lane >> 2) + half * 8;
      if (row >= p.rows) continue;
#pragma unroll
      for (int n = 0; n < NT8; ++n) {
        const int col = warp * NT8 * 8 + n * 8 + (lane & 3) * 2;
        if (col < p.C) {   // C is a multiple of 8: both columns exist
          store_out<__nv_bfloat16>(p, row, col, acc[m][n][2 * half]);
          store_out<__nv_bfloat16>(p, row, col + 1, acc[m][n][2 * half + 1]);
        }
      }
    }
}

template <int BM, int NT8, int KW1>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  using L = Bf16Tile<BM, NT8, KW1>;
  // per device and cheap, so set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      geglu_bf16<BM, NT8, KW1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((p.rows + BM - 1) / BM, p.splits);
  geglu_bf16<BM, NT8, KW1><<<grid, kThreads, L::SMEM, stream>>>(p);
  return cudaGetLastError();
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

constexpr int kF32Rows = 16;

__host__ __device__ constexpr int f32_smem(int C) {
  return (kF32Rows * C + 2 * kBI * 33 + kF32Rows * kBI + C * 17) * 4;
}

template <int NC>   // C <= 256 * NC
__global__ void __launch_bounds__(kThreads, 1) geglu_f32(const Params p) {
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

  load_rows<float, kF32Rows>(sX, C, C, p, row0, warp, lane);

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
      for (int i = tid; i < 2 * kBI * 32; i += kThreads) {
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
      for (int i = tid; i < C * 16; i += kThreads) {
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
            const int c = tid + kThreads * i;
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
      const int c = tid + kThreads * i;
      if (c < C) store_out<float>(p, row, c, acc[r][i]);
    }
  }
}

template <int NC>
cudaError_t launch_f32(const Params& p, cudaStream_t stream) {
  const int smem = f32_smem(p.C);
  cudaError_t e = cudaFuncSetAttribute(
      geglu_f32<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.rows + kF32Rows - 1) / kF32Rows, p.splits);
  geglu_f32<NC><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
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
    const int row = (int)(i / p.C), col = (int)(i - (long long)row * p.C);
    float v = acc;
    if (p.with_ln)
      v = to_f32(static_cast<const T*>(p.x)[row * p.x_s + col]) + acc;
    v += p.b2[col];
    static_cast<T*>(p.out)[i] = T(v);
  }
}

template <typename T>
cudaError_t launch_finish(const Params& p, cudaStream_t stream) {
  const long long n = (long long)p.rows * p.C;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  geglu_finish<T><<<blocks, 256, 0, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, int dtype, cudaStream_t st) {
  cudaError_t e;
  if (dtype == 1) {
    // row tiles by width, so that 8 warps x 80 fp32 accumulators hold the
    // block's (BM, C) sums: the SD v1 widths 320, 640 and 1280; a narrower
    // C runs at the next width up, its extra columns zero-filled.  The wide
    // levels take W1 in chunks of 128 k: half the barriers, and chunks that
    // still fit the stage a W2 chunk of C rows needs
    if (p.C <= 320) e = launch_bf16<64, 5, 64>(p, st);
    else if (p.C <= 640) e = launch_bf16<32, 10, 128>(p, st);
    else e = launch_bf16<16, 20, 128>(p, st);
  } else {
    if (p.C <= 256) e = launch_f32<1>(p, st);
    else if (p.C <= 512) e = launch_f32<2>(p, st);
    else if (p.C <= 768) e = launch_f32<3>(p, st);
    else if (p.C <= 1024) e = launch_f32<4>(p, st);
    else e = launch_f32<5>(p, st);
  }
  if (e != cudaSuccess || p.splits == 1) return e;
  return dtype == 1 ? launch_finish<__nv_bfloat16>(p, st)
                    : launch_finish<float>(p, st);
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2 and out of that type; LN
// scale and bias, b1 and b2 fp32).  with_ln: 1 = x + GEGLU(LN(x)) (Pallas
// _kernel_block), 0 = GEGLU(x) (Pallas _kernel).  x_s, w1_s, w2_s: row
// strides in elements (column stride 1).  `part` is (splits, rows, C) fp32
// scratch, needed when splits > 1.  bf16 needs C and inner multiples of 8,
// 16-byte aligned weight pointers and row strides that are multiples of 8.
// Returns 0 on success, a cudaError_t value if a launch was refused, or -1
// for arguments the kernels do not take.

extern "C" int geglu_fwd(const void* x, const float* ln_scale,
                         const float* ln_bias, const void* w1,
                         const float* b1, const void* w2, const float* b2,
                         void* out, float* part, int dtype, int with_ln,
                         int rows, int C, int inner, int splits,
                         long long x_s, long long w1_s, long long w2_s,
                         float eps, void* stream) {
  if (rows <= 0 || C <= 0 || C > 1280 || inner <= 0 || splits < 1 ||
      (dtype != 0 && dtype != 1) || (splits > 1 && part == nullptr))
    return -1;
  if (dtype == 1 && (C % 8 || inner % 8 || w1_s % 8 || w2_s % 8 ||
                     reinterpret_cast<uintptr_t>(w1) % 16 ||
                     reinterpret_cast<uintptr_t>(w2) % 16))
    return -1;
  if (dtype == 0 && f32_smem(C) > kMaxSmem) return -1;
  Params p;
  p.x = x; p.ln_scale = ln_scale; p.ln_bias = ln_bias;
  p.w1 = w1; p.b1 = b1; p.w2 = w2; p.b2 = b2;
  p.out = out; p.part = part;
  p.rows = rows; p.C = C; p.inner = inner; p.with_ln = with_ln;
  p.splits = splits;
  p.x_s = x_s; p.w1_s = w1_s; p.w2_s = w2_s;
  p.eps = eps;
  return dispatch(p, dtype, static_cast<cudaStream_t>(stream));
}

extern "C" const char* geglu_error_string(int code) {
  if (code == -1) return "arguments not supported by geglu_fwd";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
