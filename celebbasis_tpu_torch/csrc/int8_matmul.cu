// Int8 matrix product with per-row dynamic activation quantisation, for
// NVIDIA Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel _kernel of celebbasis_tpu/ops/quant.py (via
// int8_matmul): out = x @ dequant(w_q), where
//   xs[m]  = max(max_k |x[m, k]|, 1e-8) * fp32(1/127) (over the WHOLE row)
//   xq     = clip(round_half_even(x / xs), -127, 127)  int8
//   acc    = xq @ w_q                                  int8 x int8 -> int32
//   out    = ((float)acc * xs[m]) * ws[n]              fp32 -> x's type.
// The scale is a product with the fp32 reciprocal of 127, which is what XLA
// makes of the JAX kernel's "/ 127.0"; x / xs is an IEEE division (no
// fast-math), the rounding rint (half to even, as jnp.round), and the two
// products of the dequantisation are taken in that order, so the result
// equals the plain version bit for bit.
//
// Two kernels.  quantize_rows: one warp per row finds the row's absmax and
// writes the int8 row (K padded with zeros to a multiple of 16 bytes) and
// its scale.  int8_gemm: 128 x 128 output tiles, 8 warps of 64 x 32, K in
// chunks of 64 bytes through three cp.async stages in shared memory,
// mma.sync.m16n8k32 s8 x s8 -> s32 on the integer tensor cores, and the
// dequantisation in the epilogue.  The B operand is w_q^T, i.e. (N, K) with
// K contiguous (the col-major operand mma.sync wants); the wrapper hands
// over the (N, K) buffer that quantize_per_channel stores.
//
// What bounds it on an H100.  At the UNet's projection shapes (e.g. 16384 x
// 320 -> 2560) the product is 2MNK int8 operations against x (2 or 4 bytes a
// value), the int8 weights and the output: several hundred operations per
// byte, near the ridge of 1979 TOP/s over 3.35 TB/s, so both matter; the
// quantised copy of x (one byte a value) is written and read once more,
// which costs a fifth of x's own traffic in bf16.  mma.sync reaches only part
// of the int8 rate that wgmma gives; wgmma and TMA are left for a later
// change.
//
// Plain C interface at the bottom; no PyTorch headers.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBM = 128, kBN = 128, kBK = 64;   // bytes of K per chunk
constexpr int kLD = kBK + 16;                   // row stride of a stage tile
constexpr int kStages = 3, kThreads = 256;
constexpr int kStageBytes = (kBM + kBN) * kLD;
constexpr int kSmem = kStages * kStageBytes;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void quantize_rows(const T* __restrict__ x, long long x_s, int M,
                              int K, int Kp, int8_t* __restrict__ xq,
                              float* __restrict__ xs) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= M) return;
  const T* row = x + warp * x_s;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(row[k])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = fmaxf(amax, 1e-8f) * (1.f / 127.f);
  int8_t* q = xq + (long long)warp * Kp;
  for (int k = lane; k < Kp; k += 32) {
    float v = 0.f;
    if (k < K) v = fminf(fmaxf(rintf(to_f32(row[k]) / s), -127.f), 127.f);
    q[k] = static_cast<int8_t>(v);
  }
  if (lane == 0) xs[warp] = s;
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ldmatrix moves 8 x 16-byte rows, whatever they hold: 16 int8 values a row
// land in a thread as the 4-value groups the m16n8k32 fragments want, with
// the same addressing as the bf16 tiles of the flash kernels.
template <typename T>
__global__ void __launch_bounds__(kThreads) int8_gemm(
    const int8_t* __restrict__ xq, const float* __restrict__ xs,
    const int8_t* __restrict__ wt, const float* __restrict__ ws, T* out,
    int M, int N, int Kp, long long w_s) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = smem_raw;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int wm = warp >> 2, wn = warp & 3;   // warp tile 64 x 32

  auto load = [&](int chunk) {
    unsigned char* sA = smem + (chunk % kStages) * kStageBytes;
    unsigned char* sB = sA + kBM * kLD;
    const int k0 = chunk * kBK;
    for (int i = tid; i < (kBM + kBN) * 4; i += kThreads) {
      const int r = (i >> 2) & (kBM - 1), ch = i & 3, k = k0 + ch * 16;
      if (i < kBM * 4) {
        const bool ok = m0 + r < M && k < Kp;
        cp_async16(sA + r * kLD + ch * 16,
                   ok ? xq + (long long)(m0 + r) * Kp + k : xq, ok);
      } else {
        const bool ok = n0 + r < N && k < Kp;
        cp_async16(sB + r * kLD + ch * 16,
                   ok ? wt + (long long)(n0 + r) * w_s + k : wt, ok);
      }
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int n_chunks = (Kp + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load(s);
    cp_async_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1);
    cp_async_commit();
    const unsigned char* sA = smem + (c % kStages) * kStageBytes;
    const unsigned char* sB = sA + kBM * kLD;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], sA + (wm * 64 + i * 16 + (lane & 15)) * kLD +
                              kk * 32 + (lane >> 4) * 16);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, sB + (wn * 32 + j * 16 + (lane & 7) +
                             ((lane >> 4) << 3)) * kLD +
                           kk * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_s8(acc[i][2 * j], a[i], b[0], b[1]);
          mma_s8(acc[i][2 * j + 1], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm * 64 + i * 16 + (lane >> 2) + half * 8;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn * 32 + j * 8 + (lane & 3) * 2 + e;
          if (n < N)
            out[(long long)m * N + n] =
                T(((float)acc[i][j][2 * half + e] * sx) * ws[n]);
        }
    }
}

template <typename T>
int run(const T* x, long long x_s, const int8_t* wt, long long w_s,
        const float* ws, T* out, int8_t* xq, float* xs, int M, int N, int K,
        int Kp, cudaStream_t st) {
  const int warps_per_block = 8;
  quantize_rows<T><<<(M + warps_per_block - 1) / warps_per_block,
                     32 * warps_per_block, 0, st>>>(x, x_s, M, K, Kp, xq, xs);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(int8_gemm<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm<T><<<grid, kThreads, kSmem, st>>>(xq, xs, wt, ws, out, M, N, Kp,
                                              w_s);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
// dtype: 0 = float32, 1 = bfloat16 (x and out).  x (M, K) with row stride
// x_s; wt = w_q^T, (N, K) int8 with row stride w_s, 16-byte aligned, w_s a
// multiple of 16 and the bytes in [K, Kp) of each row zero; ws (N,) fp32;
// out (M, N) contiguous.  Scratch from the caller: xq (M, Kp) int8 and xs
// (M,) fp32, Kp = K rounded up to a multiple of 16.  Returns 0 on success,
// a cudaError_t value if a launch was refused, or -1 for arguments the
// kernels do not take.

extern "C" int int8_matmul_fwd(const void* x, long long x_s, const void* wt,
                               long long w_s, const float* ws, void* out,
                               void* xq, float* xs, int dtype, int M, int N,
                               int K, void* stream) {
  const int Kp = (K + 15) / 16 * 16;
  if (M <= 0 || N <= 0 || K <= 0 || w_s < Kp || w_s % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(xq) % 16 || M > 65535 * kBM)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return run(static_cast<const __nv_bfloat16*>(x), x_s,
               static_cast<const int8_t*>(wt), w_s, ws,
               static_cast<__nv_bfloat16*>(out), static_cast<int8_t*>(xq), xs,
               M, N, K, Kp, st);
  if (dtype == 0)
    return run(static_cast<const float*>(x), x_s,
               static_cast<const int8_t*>(wt), w_s, ws,
               static_cast<float*>(out), static_cast<int8_t*>(xq), xs, M, N,
               K, Kp, st);
  return -1;
}

extern "C" const char* int8_matmul_error_string(int code) {
  if (code == -1) return "arguments not supported by int8_matmul_fwd";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
