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
// order: no atomics, so gradients are the same bits run to run.  As in the
// forward, all tensors come with (batch, head, row) element strides, so the
// packed (B, N, H*D) layout and the per-head (B, H, N, D) layout are read
// and written in place, and bounds checks take the place of padding.
//
// What bounds it on an H100.  With W = B*H*N*M*D, dq does 6W flop (three
// products) and dkv 8W (four) against O(B*H*(N+M)*D) bytes: at N = M = 4096,
// D = 40 that is thousands of flop per byte, so both are bound by tensor-core
// operations -- as long as p and ds never reach device memory.  What keeps
// these simple kernels away from the bound: head dims 40/80/160 on 16-deep
// MMA steps, the exponentials on the ordinary ALUs, mma.sync instead of
// wgmma, operand fragments re-read from shared memory for every tile, and for
// dkv at head dims above 80 a recomputation (below).
//
// What the design does about it.  bf16: each warp owns 16 rows of its block's
// tile (query rows for dq, keys for dkv -- dkv works on the transposed
// problem, s^T = k q^T, so that its accumulators are rows of dk and dv); the
// streamed tiles pass through two cp.async stages with one barrier per tile;
// s, dp, p and ds live in fp32 registers and are rounded to bf16 only as MMA
// operands; accumulation is fp32.  dkv needs two (16, D) accumulators per
// warp, which do not fit in registers beyond D = 80: there a block has eight
// warps, and the two warps that share 16 keys each own one half of the head
// dim's columns and both compute s^T and dp^T (1.5x the products instead of
// spilled accumulators).  At the widest padded head dim (256) the streamed
// tile is 32 rows instead of 64, for the same reason.  fp32 inputs take
// plain-FMA kernels with fp32 products throughout, as the Pallas bodies have.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu
// Plain C interface at the bottom; no PyTorch headers.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;
constexpr float kRowAbsent = 1e30f;   // lse of a missing query row: p = 0

struct Strides {
  long long b, h, n;   // elements between batches, heads, rows
};

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
// bf16, dq: a block owns 64 query rows and streams K/V tiles
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_bf16(
    const BwdParams p) {
  constexpr int BM = 64, BN = DP > 160 ? 32 : 64, LD = DP + 8, NT = kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sDO = sQ + BM * LD;
  __nv_bfloat16* sKV = sDO + BM * LD;   // [stage][K | V][BN][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * BM;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const __nv_bfloat16* gq = at<__nv_bfloat16>(p.q, p.qs, b, h);
  const __nv_bfloat16* gk = at<__nv_bfloat16>(p.k, p.ks, b, h);
  const __nv_bfloat16* gv = at<__nv_bfloat16>(p.v, p.vs, b, h);
  const __nv_bfloat16* gdo = at<__nv_bfloat16>(p.dout, p.dos, b, h);
  __nv_bfloat16* gdq = at<__nv_bfloat16>(p.dq, p.dqs, b, h);

  const int n_tiles = (p.M + BN - 1) / BN;
  auto load_kv = [&](int t) {
    __nv_bfloat16* sK = sKV + (t & 1) * 2 * BN * LD;
    load_tile_bf16<BN, DP, NT>(sK, gk, p.ks.n, t * BN, p.M, p.D, tid);
    load_tile_bf16<BN, DP, NT>(sK + BN * LD, gv, p.vs.n, t * BN, p.M, p.D,
                               tid);
  };
  load_tile_bf16<BM, DP, NT>(sQ, gq, p.qs.n, q0, p.N, p.D, tid);
  load_tile_bf16<BM, DP, NT>(sDO, gdo, p.dos.n, q0, p.N, p.D, tid);
  load_kv(0);
  cp_async_commit();

  // this thread holds rows (lane / 4) and (lane / 4 + 8) of its warp's 16
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    const long long at_row = (long long)blockIdx.y * p.N + row;
    lse2[r] = row < p.N ? p.lse[at_row] * kLog2e : 0.f;
    dl[r] = row < p.N ? p.delta[at_row] : 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;

  float dq_acc[DP / 8][4];
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    // two stages, one barrier per tile, as in the forward
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_kv(t + 1);
      cp_async_commit();
    }
    const __nv_bfloat16* sK = sKV + (t & 1) * 2 * BN * LD;
    const __nv_bfloat16* sV = sK + BN * LD;
    const int kbase = t * BN;

    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    warp_mma_abt<DP, BN>(s, sQ + warp * 16 * LD, sK, lane);     // q k^T
    warp_mma_abt<DP, BN>(dp, sDO + warp * 16 * LD, sV, lane);   // dO v^T

    // ds = p (dp - delta), p = 0 at missing keys; kept in s
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kbase + j * 8 + (lane & 3) * 2 + (e & 1);
        const float pv =
            col < p.M
                ? exp2_approx(fmaf(s[j][e], scale_log2, -lse2[e >> 1]))
                : 0.f;
        s[j][e] = pv * (dp[j][e] - dl[e >> 1]);
      }
    warp_mma_pb<LD, BN, DP>(dq_acc, s, sK, 0, lane);   // dq += ds k
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + (lane >> 2) + r * 8;
    if (row < p.N) {
      __nv_bfloat16* out = gdq + (long long)row * p.dqs.n;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = j * 8 + (lane & 3) * 2;
        if (col < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(out + col) =
              __floats2bfloat162_rn(dq_acc[j][2 * r] * p.scale,
                                    dq_acc[j][2 * r + 1] * p.scale);
        }
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int BM = 64, BN = DP > 160 ? 32 : 64, LD = DP + 8;
  constexpr int smem = (2 * BM + 4 * BN) * LD * 2;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_bf16<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.N + BM - 1) / BM, p.B * p.H);
  flash_bwd_dq_bf16<DP><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, dk and dv: a block owns 64 keys and streams Q/dO tiles
// ---------------------------------------------------------------------------
// DSPLIT warps share each group of 16 keys and split the head dim's columns
// of dk and dv between them.

template <int DP, int DSPLIT>
__global__ void __launch_bounds__(kThreads * DSPLIT) flash_bwd_dkv_bf16(
    const BwdParams p) {
  constexpr int BN = 64, BM = DP > 160 ? 32 : 64, LD = DP + 8;
  constexpr int NT = kThreads * DSPLIT, DC = DP / DSPLIT;
  static_assert(DC % 16 == 0, "column halves must be whole MMA steps");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + BN * LD;
  __nv_bfloat16* sQD = sV + BN * LD;   // [stage][Q | dO][BM][LD]
  float* sStat = reinterpret_cast<float*>(sQD + 4 * BM * LD);
  // [stage][lse * log2(e) | delta][BM]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kw = warp & 3, c0 = (warp >> 2) * DC;
  const int k0 = blockIdx.x * BN;
  const int b = blockIdx.y / p.H, h = blockIdx.y - b * p.H;
  const __nv_bfloat16* gq = at<__nv_bfloat16>(p.q, p.qs, b, h);
  const __nv_bfloat16* gk = at<__nv_bfloat16>(p.k, p.ks, b, h);
  const __nv_bfloat16* gv = at<__nv_bfloat16>(p.v, p.vs, b, h);
  const __nv_bfloat16* gdo = at<__nv_bfloat16>(p.dout, p.dos, b, h);
  const float* glse = p.lse + (long long)blockIdx.y * p.N;
  const float* gdelta = p.delta + (long long)blockIdx.y * p.N;

  const int n_tiles = (p.N + BM - 1) / BM;
  auto load_qd = [&](int t) {
    __nv_bfloat16* sQ = sQD + (t & 1) * 2 * BM * LD;
    load_tile_bf16<BM, DP, NT>(sQ, gq, p.qs.n, t * BM, p.N, p.D, tid);
    load_tile_bf16<BM, DP, NT>(sQ + BM * LD, gdo, p.dos.n, t * BM, p.N, p.D,
                               tid);
    float* st = sStat + (t & 1) * 2 * BM;
    for (int i = tid; i < BM; i += NT) {
      const int row = t * BM + i;
      st[i] = row < p.N ? glse[row] * kLog2e : kRowAbsent;
      st[BM + i] = row < p.N ? gdelta[row] : 0.f;
    }
  };
  load_tile_bf16<BN, DP, NT>(sK, gk, p.ks.n, k0, p.M, p.D, tid);
  load_tile_bf16<BN, DP, NT>(sV, gv, p.vs.n, k0, p.M, p.D, tid);
  load_qd(0);
  cp_async_commit();

  const float scale_log2 = p.scale * kLog2e;
  float dk_acc[DC / 8][4], dv_acc[DC / 8][4];
#pragma unroll
  for (int j = 0; j < DC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < n_tiles) {
      load_qd(t + 1);
      cp_async_commit();
    }
    const __nv_bfloat16* sQ = sQD + (t & 1) * 2 * BM * LD;
    const __nv_bfloat16* sDO = sQ + BM * LD;
    const float* st = sStat + (t & 1) * 2 * BM;

    // transposed problem: rows are this warp's 16 keys, columns the tile's
    // query rows
    float sT[BM / 8][4], dpT[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
    warp_mma_abt<DP, BM>(sT, sK + kw * 16 * LD, sQ, lane);     // k q^T
    warp_mma_abt<DP, BM>(dpT, sV + kw * 16 * LD, sDO, lane);   // v dO^T

#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = j * 8 + (lane & 3) * 2 + (e & 1);
        const float pv = exp2_approx(fmaf(sT[j][e], scale_log2, -st[i]));
        dpT[j][e] = pv * (dpT[j][e] - st[BM + i]);   // ds^T
        sT[j][e] = pv;                               // p^T
      }
    warp_mma_pb<LD, BM, DC>(dv_acc, sT, sDO, c0, lane);   // dv += p^T dO
    warp_mma_pb<LD, BM, DC>(dk_acc, dpT, sQ, c0, lane);   // dk += ds^T q
  }

  __nv_bfloat16* gdk = at<__nv_bfloat16>(p.dk, p.dks, b, h);
  __nv_bfloat16* gdv = at<__nv_bfloat16>(p.dv, p.dvs, b, h);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw * 16 + (lane >> 2) + r * 8;
    if (key < p.M) {
      __nv_bfloat16* out_k = gdk + (long long)key * p.dks.n;
      __nv_bfloat16* out_v = gdv + (long long)key * p.dvs.n;
#pragma unroll
      for (int j = 0; j < DC / 8; ++j) {
        const int col = c0 + j * 8 + (lane & 3) * 2;
        if (col < p.D) {
          *reinterpret_cast<__nv_bfloat162*>(out_k + col) =
              __floats2bfloat162_rn(dk_acc[j][2 * r] * p.scale,
                                    dk_acc[j][2 * r + 1] * p.scale);
          *reinterpret_cast<__nv_bfloat162*>(out_v + col) =
              __floats2bfloat162_rn(dv_acc[j][2 * r], dv_acc[j][2 * r + 1]);
        }
      }
    }
  }
}

template <int DP, int DSPLIT>
cudaError_t launch_dkv_bf16(const BwdParams& p, cudaStream_t stream) {
  constexpr int BN = 64, BM = DP > 160 ? 32 : 64, LD = DP + 8;
  constexpr int smem = (2 * BN + 4 * BM) * LD * 2 + 4 * BM * 4;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16<DP, DSPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((p.M + BN - 1) / BN, p.B * p.H);
  flash_bwd_dkv_bf16<DP, DSPLIT>
      <<<grid, kThreads * DSPLIT, smem, stream>>>(p);
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

bool bad_dims(int B, int H, int N, int M, int D) {
  return D <= 0 || D > 256 || D % 8 != 0 || B <= 0 || H <= 0 || N <= 0 ||
         M <= 0 || (long long)B * H > 65535;
}

Strides strides_at(const long long* s, int i) {
  return Strides{s[3 * i], s[3 * i + 1], s[3 * i + 2]};
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
// was refused, or -1 for arguments these kernels do not take.

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
    if (D <= 48) return launch_dq_bf16<48>(p, st);
    if (D <= 80) return launch_dq_bf16<80>(p, st);
    if (D <= 160) return launch_dq_bf16<160>(p, st);
    return launch_dq_bf16<256>(p, st);
  }
  if (dtype == 0) {
    if (D <= 32) return launch_dq_f32<1>(p, st);
    if (D <= 64) return launch_dq_f32<2>(p, st);
    if (D <= 128) return launch_dq_f32<4>(p, st);
    return launch_dq_f32<8>(p, st);
  }
  return -1;
}

// dk and dv.  strides: q, k, v, dout, dk, dv.
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int dtype,
    int B, int H, int N, int M, int D, const long long* strides, float scale,
    void* stream) {
  if (bad_dims(B, H, N, M, D)) return -1;
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
    if (D <= 48) return launch_dkv_bf16<48, 1>(p, st);
    if (D <= 80) return launch_dkv_bf16<80, 1>(p, st);
    if (D <= 160) return launch_dkv_bf16<160, 2>(p, st);
    return launch_dkv_bf16<256, 2>(p, st);
  }
  if (dtype == 0) {
    if (D <= 32) return launch_dkv_f32<1>(p, st);
    if (D <= 64) return launch_dkv_f32<2>(p, st);
    if (D <= 128) return launch_dkv_f32<4>(p, st);
    return launch_dkv_f32<8>(p, st);
  }
  return -1;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == -1) return "arguments not supported by flash_attention_bwd";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
