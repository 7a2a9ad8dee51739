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
// keys masked with -1e30.  One kernel serves both layouts: it
// takes base pointers plus the batch, head and row strides (in elements; the
// element stride along the head dim is 1), so the packed layout is read in
// place and the per-head layout is the same code with other strides.
//
// What bounds it on an H100.  For SD v1 self-attention at N = M = 4096,
// D = 40 the work is 4*N*M*D flop per head against 4*N*D*2 bytes of q, k, v
// and o: about 2000 flop per byte, far above the card's ~295 flop/byte ridge,
// so the kernel is bound by tensor-core operations, not by memory -- provided
// the (N, M) score matrix never reaches device memory.  What keeps a simple
// kernel away from that bound is (a) head dims 40/80/160 that do not fill
// 16-wide MMA steps (40 is padded to 48: one sixth of the products are with
// zeros), (b) the exp and rescale work of the softmax, which runs on the
// ordinary ALUs beside the tensor cores, and (c) mma.sync instead of wgmma.
//
// What the design does about it.  A block owns one (batch, head, query tile
// of 64 or 128 rows); each of its warps owns 16 rows.  K/V tiles of 64 keys
// stream through two shared-memory stages filled by cp.async, one barrier
// per tile, so the next tile arrives while this one is consumed.  Scores,
// running max, running sum and the output accumulator live in fp32
// registers, so the score matrix never leaves the SM; the exponentials are
// ex2.approx with the softmax scale folded into one FMA.  The head dim is
// padded to a multiple of 16 in shared memory only (zero-filled columns),
// never in device memory.  The ragged last key tile (M = 77) is masked in
// registers and its missing rows are zero-filled in shared memory; the
// ragged last query tile is zero-filled on load and skipped on store.  bf16
// inputs take mma.sync.m16n8k16 with fp32 accumulation (operands in the
// input type, as the Pallas body's dot_general does); fp32 inputs take a
// plain-FMA kernel with the same tiling idea, so that fp32 callers get fp32
// products.  wgmma, TMA and warp specialisation are left for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu
// (flash_common.cuh beside it holds the helpers shared with the backward.)
// Plain C interface at the bottom; no PyTorch headers.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;   // (B, H, N) contiguous; written only by the LSE variants
  int B, H, N, M, D;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  float scale;
};

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

template <int DP, int BM, bool LSE>
__global__ void __launch_bounds__(BM * 2) flash_fwd_bf16(const Params p) {
  constexpr int BN = 64, LD = DP + 8, NT = BM * 2;   // one warp per 16 rows
  // Q fragments stay in registers where the accumulators leave room
  constexpr bool kQInRegs = DP <= 128;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sKV = sQ + BM * LD;   // [stage][K | V][BN][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;

  const __nv_bfloat16* gq = static_cast<const __nv_bfloat16*>(p.q) +
                            b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* gk = static_cast<const __nv_bfloat16*>(p.k) +
                            b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* gv = static_cast<const __nv_bfloat16*>(p.v) +
                            b * p.v_sb + h * p.v_sh;
  __nv_bfloat16* go = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb +
                      h * p.o_sh;

  const int n_tiles = (p.M + BN - 1) / BN;
  auto load_kv = [&](int t) {
    __nv_bfloat16* sK = sKV + (t & 1) * 2 * BN * LD;
    load_tile_bf16<BN, DP, NT>(sK, gk, p.k_sn, t * BN, p.M, p.D, tid);
    load_tile_bf16<BN, DP, NT>(sK + BN * LD, gv, p.v_sn, t * BN, p.M, p.D,
                               tid);
  };

  // group 0: Q and the first K/V tile
  load_tile_bf16<BM, DP, NT>(sQ, gq, p.q_sn, q0, p.N, p.D, tid);
  load_kv(0);
  cp_async_commit();

  float o_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[j][e] = 0.f;
  float m_i[2] = {kNegInf, kNegInf};   // running max, log2 domain
  float l_i[2] = {0.f, 0.f};           // per-thread partial row sums
  const float scale_log2 = p.scale * kLog2e;
  uint32_t qf[DP / 16][4];   // used only when kQInRegs

  for (int t = 0; t < n_tiles; ++t) {
    // two stages, one barrier per tile: once tile t has landed and every
    // warp is past tile t - 1, that tile's stage takes tile t + 1, which
    // streams in while tile t is consumed
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
    }
    const __nv_bfloat16* sK = sKV + (t & 1) * 2 * BN * LD;
    const __nv_bfloat16* sV = sK + BN * LD;
    const int kbase = t * BN;

    if constexpr (kQInRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldmatrix_x4(qf[kk], sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                                  (lane >> 4) * 8);
      }
    }

    // S = Q K^T: 16 rows x 64 keys per warp, fp32
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      if constexpr (kQInRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldmatrix_x4(a, sQ + (warp * 16 + (lane & 15)) * LD + kk * 16 +
                           (lane >> 4) * 8);
      }
#pragma unroll
      for (int nj = 0; nj < BN / 16; ++nj) {
        uint32_t bk[4];
        ldmatrix_x4(bk, sK + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nj], a, bk[0], bk[1]);
        mma_bf16(s[2 * nj + 1], a, bk[2], bk[3]);
      }
    }

    // mask the ragged last key tile (raw scores; the scale is positive)
    if (kbase + BN > p.M) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kbase + j * 8 + (lane & 3) * 2 + (e & 1) >= p.M)
            s[j][e] = kNegInf;
    }

    // online softmax in the log2 domain, the scale folded into one FMA;
    // this thread holds rows (lane/4) and (lane/4 + 8)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[r], mx * scale_log2);
      const float alpha = exp2_approx(m_i[r] - m_new);
      m_i[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = exp2_approx(fmaf(s[j][2 * r], scale_log2, -m_new));
        const float p1 =
            exp2_approx(fmaf(s[j][2 * r + 1], scale_log2, -m_new));
        s[j][2 * r] = p0;
        s[j][2 * r + 1] = p1;
        sum += p0 + p1;
      }
      l_i[r] = l_i[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        o_acc[j][2 * r] *= alpha;
        o_acc[j][2 * r + 1] *= alpha;
      }
    }

    // O += P V, P rounded to bf16 as the MMA's A operand
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dj = 0; dj < DP / 16; ++dj) {
        uint32_t bv[4];
        ldmatrix_x4_trans(
            bv, sV + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                    dj * 16 + (lane >> 4) * 8);
        mma_bf16(o_acc[2 * dj], a, bv[0], bv[1]);
        mma_bf16(o_acc[2 * dj + 1], a, bv[2], bv[3]);
      }
    }
  }

  // epilogue: finish the row sums across the four threads of a row, divide,
  // and store the rows and columns that exist
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    if (row < p.N) {
      __nv_bfloat16* orow = go + (long long)row * p.o_sn;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (col < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o_acc[j][2 * r] * inv,
                                    o_acc[j][2 * r + 1] * inv);
        }
      }
      if constexpr (LSE) {
        // m is in the log2 domain with the scale folded in
        if ((lane & 3) == 0)
          p.lse[(long long)blockIdx.y * p.N + row] =
              (m_i[r] + log2f(l)) * kLn2;
      }
    }
  }
}

template <int DP, int BM, bool LSE>
cudaError_t launch_bf16_tile(const Params& p, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  constexpr int smem = (BM + 2 * (64 + 64)) * LD * 2;   // Q + 2 stages of K, V
  // per device and cheap, so set on every launch
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<DP, BM, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.N + BM - 1) / BM, p.B * p.H);
  flash_fwd_bf16<DP, BM, LSE><<<grid, BM * 2, smem, stream>>>(p);
  return cudaGetLastError();
}

// Long query sequences take 128-row tiles (eight warps share each K/V tile,
// which halves the copies per product); short ones keep 64 rows so that the
// grid still fills the card.
template <int DP, bool LSE>
cudaError_t launch_bf16(const Params& p, cudaStream_t stream) {
  if (p.N >= 1024) return launch_bf16_tile<DP, 128, LSE>(p, stream);
  return launch_bf16_tile<DP, 64, LSE>(p, stream);
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
  const float* gq = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* gk = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* gv = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* go = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < BM * D; i += kThreads) {
    const int r = i / D, c = i - r * D;
    const int gr = q0 + r;
    sQ[r * LD + c] = gr < p.N ? gq[(long long)gr * p.q_sn + c] * p.scale : 0.f;
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
      sK[r * LD + c] = ok ? gk[(long long)gr * p.k_sn + c] : 0.f;
      sV[r * LD + c] = ok ? gv[(long long)gr * p.v_sn + c] : 0.f;
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
        if (c < D) go[(long long)row * p.o_sn + c] = acc[r][i] * inv;
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
  if (p.D <= 0 || p.D > 256 || p.D % 8 != 0 || p.B <= 0 || p.H <= 0 ||
      p.N <= 0 || p.M <= 0)
    return -1;
  if ((long long)p.B * p.H > 65535) return -1;
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
  p.q_sb = strides[0]; p.q_sh = strides[1]; p.q_sn = strides[2];
  p.k_sb = strides[3]; p.k_sh = strides[4]; p.k_sn = strides[5];
  p.v_sb = strides[6]; p.v_sh = strides[7]; p.v_sn = strides[8];
  p.o_sb = strides[9]; p.o_sh = strides[10]; p.o_sn = strides[11];
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
// multiples of 8.  Returns 0 on success, a cudaError_t value if the launch
// was refused, or -1 for arguments this kernel does not take (D not a
// multiple of 8, D > 256, unknown dtype, empty tensors).

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

extern "C" const char* flash_attention_error_string(int code) {
  if (code == -1) return "arguments not supported by flash_attention_fwd";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
