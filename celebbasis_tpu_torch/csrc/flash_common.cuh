// Device helpers shared by the flash-attention sources (forward and
// backward): ldmatrix / mma.sync wrappers, cp.async tile loads, and the two
// warp-level tile products every kernel is built from.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&t);
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16-byte asynchronous copy global -> shared; with `pred` false nothing is
// read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Queues the copy of ROWS x D bf16 values (16 bytes at a time) into a
// ROWS x (DP + 8) shared tile; rows at or beyond `rows_total` and columns in
// [D, DP) are zero-filled.
template <int ROWS, int DP, int NT>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst,
                                               const __nv_bfloat16* src,
                                               long long row_stride, int row0,
                                               int rows_total, int D,
                                               int tid) {
  constexpr int LD = DP + 8;
  constexpr int CH = DP / 8;
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i - r * CH;
    const int gr = row0 + r;
    const bool ok = gr < rows_total && c * 8 < D;
    const __nv_bfloat16* from =
        ok ? src + (long long)gr * row_stride + c * 8 : src;
    cp_async16(dst + r * LD + c * 8, from, ok);
  }
}

// acc (16 x NB, fp32, one warp) += A B^T over the padded head dim.  `sA`
// points at the warp's 16 rows of a shared tile with row stride DP + 8, `sB`
// at an NB-row tile of the same stride.
template <int DP, int NB>
__device__ __forceinline__ void warp_mma_abt(float (&acc)[NB / 8][4],
                                             const __nv_bfloat16* sA,
                                             const __nv_bfloat16* sB,
                                             int lane) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, sA + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int nj = 0; nj < NB / 16; ++nj) {
      uint32_t b[4];
      ldmatrix_x4(b, sB + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                         kk * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(acc[2 * nj], a, b[0], b[1]);
      mma_bf16(acc[2 * nj + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DC, fp32, one warp) += P B[:, c0 : c0 + DC], where P (16 x NB)
// lies in the accumulator layout of warp_mma_abt and is rounded to bf16 as
// the MMA's A operand, and `sB` is an NB-row shared tile of row stride LD.
template <int LD, int NB, int DC>
__device__ __forceinline__ void warp_mma_pb(float (&acc)[DC / 8][4],
                                            const float (&pm)[NB / 8][4],
                                            const __nv_bfloat16* sB, int c0,
                                            int lane) {
#pragma unroll
  for (int kk = 0; kk < NB / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(pm[2 * kk][0], pm[2 * kk][1]);
    a[1] = pack_bf16(pm[2 * kk][2], pm[2 * kk][3]);
    a[2] = pack_bf16(pm[2 * kk + 1][0], pm[2 * kk + 1][1]);
    a[3] = pack_bf16(pm[2 * kk + 1][2], pm[2 * kk + 1][3]);
#pragma unroll
    for (int dj = 0; dj < DC / 16; ++dj) {
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, sB + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 +
                 dj * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dj], a, b[0], b[1]);
      mma_bf16(acc[2 * dj + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace flash
