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
// fast-math), the rounding half to even (as jnp.round), and the two products
// of the dequantisation are taken in that order, so the result equals the
// plain version bit for bit.
//
// What bounds it on an H100.  At the UNet's projection shapes the bytes: x
// read once (2 or 4 bytes a value), the int8 weights, the output written once
// (at 16384 x 320 -> 2560 in bf16 the output is 84 of the 95 MB); the 2MNK
// int8 operations take half that time or less at the int8 tensor-core rate.
// The design keeps the quantised copy of x off device memory where it can
// and keeps the output stores streaming:
//   * fused (one launch): a block owns a row tile of 128 rows; TMA brings
//     its x rows into shared memory (in two halves, over the staging tiles
//     and the ring's last stages, which are not yet in use), the block
//     quantises them into a resident int8 tile (a group of threads a row; xq
//     and xs never reach device memory) and then walks its N tiles of 128
//     columns;
//   * streamed (x's tile too long to stay resident beside the staging
//     tiles, or too few rows for the row tiles to fill the card):
//     quantize_rows writes xq and xs (16-byte loads, a group of threads a
//     row, many warps in flight), and the product kernel, launched while it
//     still runs (programmatic dependent launch), takes the A tiles by TMA
//     too once it has finished;
//   * the products: two consumer warpgroups of 64 rows each run wgmma
//     m64n128k32 s8 x s8 -> s32 on 128-byte-swizzled K-major tiles, each
//     into two accumulators (even and odd k32 steps: two chains of dependent
//     products keep the tensor cores busier than one); one producer thread
//     keeps a ring of W tiles (and, streamed, A tiles) in flight by TMA, with
//     full and empty mbarriers a stage; the producer warpgroup hands its
//     registers to the consumers (setmaxnreg);
//   * the epilogue dequantises in registers (ws of the block's N tiles wait
//     in shared memory), rounds to x's type and writes a 128-byte-swizzled
//     staging tile (no bank conflicts), which one thread of the warpgroup
//     hands to a TMA store that runs on during the next tile's products (two
//     staging tiles a warpgroup where they fit).  Where out's row stride is
//     not a multiple of 16 bytes, or the resident row tile leaves no room for
//     staging, the warpgroup stores from its registers.
// One host function (plan) picks the mode, the N split, the ring stages and
// the staging tiles of a launch; int8_matmul_plan reports them.  The
// "// phase:" lines mark where torch_scripts/int8_phases.py puts its cycle
// stamps in a temporary copy.
//
// Plain C interface at the bottom; no PyTorch headers.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxSmem = 232448;
constexpr int kBM = 128;                  // rows of a row tile
constexpr int kBN = 128;                  // output columns of an N tile
constexpr int kKC = 128;                  // int8 values (bytes) of K a stage
constexpr int kKSteps = kKC / 32;         // k32 wgmma steps a stage
constexpr int kTileBytes = kBM * kKC;     // an A or a W tile: 16 KB
constexpr int kThreads = 384;             // two consumer warpgroups + producer
constexpr int kConsumers = 256;
constexpr int kMaxStages = 8;
constexpr int kBarBytes = (2 * kMaxStages + 2) * 8;
constexpr int kVMax = 8;                  // 16-byte vectors a thread holds
constexpr float kInv127 = 1.f / 127.f;
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 <= 65536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kMaxWsTiles = 32;           // N tiles a block, at most (their
                                          // ws are held in shared memory)
static_assert(kBM == kBN, "A and W tiles share the box shape of one map");

struct Params {
  CUtensorMap w;          // (N, K) int8, boxes of 128 x 128 bytes
  CUtensorMap a;          // streamed: xq (M, K) int8, the same boxes
  CUtensorMap out;        // (M, N) of x's type, boxes of 128 bytes x 64 rows
  CUtensorMap xm;         // fused: x (M, K), boxes of 128 bytes x 64 rows
  const void* x;          // (M, K), rows x_s elements apart
  const float* xs;        // streamed: (M,) the row scales
  const float* ws;        // (N,)
  void* out_ptr;          // (M, N) contiguous
  long long x_s;
  int M, N, K;
  int kchunks;            // ceil(K / 128)
  int n_tiles, splits;    // N tiles, and blocks over them a row tile
  int stages, nbuf;       // ring stages; staging tiles a warpgroup (TMA)
  int group;              // threads that quantise one row together
  int x_vec;              // x's rows may be read 16 bytes at a time
  int tma_store;          // staging tiles and TMA stores (else plain stores)
  // the shared layout (byte offsets; layout()); fused: x's row tile lies
  // at x_off over the staging tiles and the last x_slots ring stages
  int ring_off, stg_off, xs_off, ws_off, bar_off, stage_bytes, x_off,
      x_slots, x_boxes;
};

// 16 bytes of a row of x from element k0 on: one load where the row allows
// it, else element by element, zeros past K
template <typename T>
__device__ __forceinline__ uint4 load_vec(const T* row, int k0, int K,
                                          bool vec) {
  constexpr int V = 16 / sizeof(T);
  if (vec && k0 + V <= K)
    return __ldg(reinterpret_cast<const uint4*>(row + k0));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
    const uint32_t* r = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (k0 + i < K) w[i] = r[k0 + i];
  } else {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (k0 + i < K) w[i >> 1] |= (uint32_t)r[k0 + i] << (16 * (i & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the largest |value| of a vector (bf16: each half widened to fp32 by a
// shift; the bf16 max of packed pairs costs more on the card)
template <typename T>
__device__ __forceinline__ float absmax_vec(uint4 v) {
  if constexpr (sizeof(T) == 4) {
    auto f = [](uint32_t u) { return fabsf(__uint_as_float(u)); };
    return fmaxf(fmaxf(f(v.x), f(v.y)), fmaxf(f(v.z), f(v.w)));
  } else {
    auto lo = [](uint32_t u) { return fabsf(__uint_as_float(u << 16)); };
    auto hi = [](uint32_t u) {
      return fabsf(__uint_as_float(u & 0xffff0000u));
    };
    return fmaxf(fmaxf(fmaxf(lo(v.x), hi(v.x)), fmaxf(lo(v.y), hi(v.y))),
                 fmaxf(fmaxf(lo(v.z), hi(v.z)), fmaxf(lo(v.w), hi(v.w))));
  }
}

// v / s rounded as an IEEE division.  fp32: the division itself.  bf16:
// from y = 1 / s (correctly rounded, once a row), the product v y corrected
// once by its exact residual v - (v y) s (Markstein's step), three FMA-pipe
// operations in place of the division's reciprocal on the slow MUFU pipe and
// its range check; for every bf16 v that gives the IEEE quotient
// (chip_smoke.check_int8_quotients holds the kernel to it exhaustively).
template <typename T>
__device__ __forceinline__ float quotient(float v, float s, float y) {
  if constexpr (sizeof(T) == 4) {
    return __fdiv_rn(v, s);
  } else {
    const float q = __fmul_rn(v, y);
    return __fmaf_rn(__fmaf_rn(-q, s, v), y, q);
  }
}

// clip(rint(q), -127, 127) in the low byte: 1.5 * 2^23 added rounds to an
// integer (half to even) and leaves it, two's complement, in the low bits of
// the sum
__device__ __forceinline__ uint32_t q8(float q) {
  return __float_as_uint(fminf(fmaxf(q, -127.f), 127.f) + 12582912.f);
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// a vector quantised with scale s (y = 1 / s): bf16, 8 bytes (x and y);
// fp32, 4 bytes (x)
template <typename T>
__device__ __forceinline__ uint2 quant_vec(uint4 v, float s, float y) {
  auto q = [&](float f) { return q8(quotient<T>(f, s, y)); };
  if constexpr (sizeof(T) == 4) {
    return make_uint2(pack4(q(__uint_as_float(v.x)), q(__uint_as_float(v.y)),
                            q(__uint_as_float(v.z)), q(__uint_as_float(v.w))),
                      0u);
  } else {
    auto lo = [](uint32_t u) { return __uint_as_float(u << 16); };
    auto hi = [](uint32_t u) { return __uint_as_float(u & 0xffff0000u); };
    return make_uint2(pack4(q(lo(v.x)), q(hi(v.x)), q(lo(v.y)), q(hi(v.y))),
                      pack4(q(lo(v.z)), q(hi(v.z)), q(lo(v.w)), q(hi(v.w))));
  }
}

// the quantised bytes of a vector at `dst` (8 bytes in bf16, 4 in fp32)
template <typename T>
__device__ __forceinline__ void put_q(void* dst, uint2 q) {
  if constexpr (sizeof(T) == 4)
    *reinterpret_cast<uint32_t*>(dst) = q.x;
  else
    *reinterpret_cast<uint2*>(dst) = q;
}

// byte offset of (row, k) in the resident row tile: K chunks of 128 rows x
// 128 bytes one after the other, 128-byte swizzle
__device__ __forceinline__ int a_offset(int row, int k) {
  const int c = k & (kKC - 1);
  return (k / kKC) * kTileBytes + row * kKC + (((c >> 4) ^ (row & 7)) << 4) +
         (c & 15);
}

// The vectors first + l + G j (j < kVMax, below vend) of row `row` that
// thread l of the row's group of G holds; zeros elsewhere and where !in.
template <typename T>
__device__ __forceinline__ void load_vecs(uint4 (&v)[kVMax], const Params& p,
                                          int row, bool in, int first, int l,
                                          int G, int vend) {
  constexpr int V = 16 / sizeof(T);
  const T* src = static_cast<const T*>(p.x) + (long long)(in ? row : 0) * p.x_s;
#pragma unroll
  for (int j = 0; j < kVMax; ++j) {
    const int vi = first + l + G * j;
    v[j] = in && vi < vend ? load_vec<T>(src, vi * V, p.K, p.x_vec)
                           : make_uint4(0u, 0u, 0u, 0u);
  }
}

// the largest |value| of the vectors load_vecs gave this thread
template <typename T>
__device__ __forceinline__ float vecs_amax(const uint4 (&v)[kVMax], int first,
                                           int l, int G, int vend) {
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kVMax; ++j) {
    const int vi = first + l + G * j;
    if (vi < vend) amax = fmaxf(amax, absmax_vec<T>(v[j]));
  }
  return amax;
}

// the row's scale from its group's absmax values (G lanes of one warp)
__device__ __forceinline__ float group_scale(float amax, int G) {
  for (int off = G >> 1; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  return fmaxf(amax, 1e-8f) * kInv127;
}

// Fused: the block's row tile, which TMA brought into shared memory at sx
// (two halves of 64 rows, each x_boxes boxes of 64 rows x 128 bytes,
// completing on xbar[half]; zeros past K and M), quantised into sA (zeros
// past K up to the last chunk's edge), its scales into sxs.  `group`
// threads (a power of two) hold a row's vectors, at most kVMax each.
template <typename T>
__device__ __forceinline__ void quantize_tile(const Params& p, int row0,
                                              const unsigned char* sx,
                                              uint64_t* xbar, unsigned char* sA,
                                              float* sxs, int tid) {
  constexpr int V = 16 / sizeof(T);
  constexpr int kBoxValues = 128 / sizeof(T);
  const int G = p.group, per = kThreads / G, l = tid & (G - 1);
  const int vpr = p.kchunks * kKC / V;
  int waited = 0;
  for (int r0 = 0; r0 < kBM; r0 += per) {
    // every thread waits for the halves this batch of rows reaches
    for (; waited < 2 && waited * 64 < r0 + per; ++waited)
      mbar_wait(&xbar[waited], 0);
    const int r = r0 + tid / G;
    uint4 v[kVMax];
#pragma unroll
    for (int j = 0; j < kVMax; ++j) {
      const int vi = l + G * j, k = vi * V, box = k / kBoxValues;
      v[j] = r < kBM && vi < vpr && box < p.x_boxes
                 ? *reinterpret_cast<const uint4*>(
                       sx + ((r >> 6) * p.x_boxes + box) * (64 * 128) +
                       (r & 63) * 128 + (k % kBoxValues) * sizeof(T))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
    const float s = group_scale(vecs_amax<T>(v, 0, l, G, vpr), G);
    const float y = __frcp_rn(s);
    if (r >= kBM) continue;
    if (l == 0) sxs[r] = row0 + r < p.M ? s : 0.f;
#pragma unroll
    for (int j = 0; j < kVMax; ++j) {
      const int vi = l + G * j;
      if (vi < vpr)
        put_q<T>(sA + a_offset(r, vi * V), quant_vec<T>(v[j], s, y));
    }
  }
}

// Streamed: xq (rows q_s bytes apart) and xs, `group` threads a row as in
// quantize_tile, 256 / group rows a block.  A row longer than a warp's
// registers hold (group 32, more than 32 kVMax vectors) is read twice, the
// second time from L2.
template <typename T>
__global__ void __launch_bounds__(256) quantize_rows(const Params p,
                                                     int8_t* xq, float* xs,
                                                     int q_s) {
  constexpr int V = 16 / sizeof(T);
  launch_dependents();   // the product kernel may start its set-up
  const int G = p.group, l = threadIdx.x & (G - 1);
  const int row = blockIdx.x * (256 / G) + threadIdx.x / G;
  const bool in = row < p.M;
  const int vpr = (p.K + V - 1) / V, seg = G * kVMax;
  const int nseg = (vpr + seg - 1) / seg;
  uint4 v[kVMax];
  float amax = 0.f;
  for (int g = 0; g < nseg; ++g) {
    load_vecs<T>(v, p, row, in, g * seg, l, G, vpr);
    amax = fmaxf(amax, vecs_amax<T>(v, g * seg, l, G, vpr));
  }
  const float s = group_scale(amax, G), y = __frcp_rn(s);
  if (!in) return;
  if (l == 0) xs[row] = s;
  int8_t* dst = xq + (long long)row * q_s;
  // the last segment is still in the registers
  for (int g = nseg - 1; g >= 0; --g) {
    if (g != nseg - 1) load_vecs<T>(v, p, row, in, g * seg, l, G, vpr);
#pragma unroll
    for (int j = 0; j < kVMax; ++j) {
      const int vi = g * seg + l + G * j;
      if (vi < vpr) put_q<T>(dst + vi * V, quant_vec<T>(v[j], s, y));
    }
  }
}

// byte offset of (row, col) in a warpgroup's staging tile of 64 rows x kBN
// values: boxes of 128 bytes x 64 rows one after the other, 128-byte swizzle
template <typename T>
__device__ __forceinline__ int stg_offset(int row, int col) {
  const int b = col * (int)sizeof(T);
  return (b >> 7) * (64 * 128) + row * 128 +
         ((((b >> 4) & 7) ^ (row & 7)) << 4) + (b & 15);
}

template <typename T, bool STREAMED>
__global__ void __launch_bounds__(kThreads, 1)
    int8_gemm(const __grid_constant__ Params p) {
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* sA = smem;                 // fused: the quantised row tile
  unsigned char* ring = smem + p.ring_off;  // [stage]: W tile (+ A tile)
  unsigned char* stg = smem + p.stg_off;    // [warpgroup]: staging tile
  float* sxs = reinterpret_cast<float*>(smem + p.xs_off);
  float* sws = reinterpret_cast<float*>(smem + p.ws_off);  // [N tile][kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + kMaxStages;
  uint64_t* xbar = empty + kMaxStages;      // fused: x's two row halves

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = warp_uniform(tid >> 5);
  const int split = blockIdx.x % p.splits;
  const int row0 = blockIdx.x / p.splits * kBM;
  const int nt0 = split * p.n_tiles / p.splits;
  const int nt1 = (split + 1) * p.n_tiles / p.splits;
  const int S = p.stages, total = (nt1 - nt0) * p.kchunks;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // lane 0 of each consumer warp
    }
    mbar_init(&xbar[0], 1);
    mbar_init(&xbar[1], 1);
    mbar_init_fence();
  }
  __syncthreads();
  // streamed: launched while quantize_rows still runs (programmatic
  // dependent launch); xq and xs are read only once it has finished
  if constexpr (STREAMED) grid_dependency_wait();
  // the loads of stage `it` (the producer thread): the W tile of N tile
  // nt0 + it / kchunks at K chunk it % kchunks, and the A tile (streamed)
  auto issue = [&](int it) {
    const int s = it % S;
    unsigned char* st = ring + s * p.stage_bytes;
    const int n0 = (nt0 + it / p.kchunks) * kBN, k0 = it % p.kchunks * kKC;
    mbar_arrive_tx(&full[s], STREAMED ? 2 * kTileBytes : kTileBytes);
    tma_load_2d(st, &p.w, &full[s], k0, n0);
    if constexpr (STREAMED)
      tma_load_2d(st + kTileBytes, &p.a, &full[s], k0, row0);
  };
  // fused: the ring stages under x's row tile are loaded once it has been
  // quantised
  const int early = STREAMED ? S : S - p.x_slots;
  if (tid == kConsumers) {
    if constexpr (!STREAMED) {
      // x's row tile first: it holds up everything after it
      for (int h = 0; h < 2; ++h) {
        mbar_arrive_tx(&xbar[h], p.x_boxes * 64 * 128);
        for (int b = 0; b < p.x_boxes; ++b)
          tma_load_2d(smem + p.x_off + (h * p.x_boxes + b) * (64 * 128),
                      &p.xm, &xbar[h], b * (128 / (int)sizeof(T)),
                      row0 + 64 * h);
      }
    }
    prefetch_tensormap(&p.w);
    if constexpr (STREAMED) prefetch_tensormap(&p.a);
    if (p.tma_store) prefetch_tensormap(&p.out);
    for (int it = 0; it < early && it < total; ++it) issue(it);
  }
  // ws of the block's N tiles into shared memory (zeros past N), read in the
  // epilogues (a load into registers before the products would hold up
  // their first wgmma.fence)
  for (int i = tid; i < (nt1 - nt0) * kBN; i += kThreads) {
    const int c = nt0 * kBN + i;
    sws[i] = c < p.N ? __ldg(p.ws + c) : 0.f;
  }
  if constexpr (!STREAMED) {
    // the row tile quantised while the first W tiles arrive
    // phase: quantise_start
    quantize_tile<T>(p, row0, smem + p.x_off, xbar, sA, sxs, tid);
    // phase: quantise_end
    fence_proxy_async();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {   // the producer warpgroup
    regs_dealloc<kProducerRegs>();
    if (tid == kConsumers)
      for (int it = early > 0 ? early : 0; it < total; ++it) {
        if (it >= S) mbar_wait(&empty[it % S], (it / S - 1) & 1);
        issue(it);
      }
    return;
  }
  regs_alloc<kConsumerRegs>();

  // consumer warpgroup wg: rows [64 wg, 64 wg + 64) of the row tile, every
  // N tile of the block.  This thread holds rows 16 w + lane / 4 (+ 8) of
  // them and columns 8 j + 2 t4 (+ 1) of the N tile (accumulator layout:
  // hopper.cuh)
  const int wg = warp >> 2, w = warp & 3, t4 = lane & 3;
  const int wrow = wg * 64, grow0 = row0 + wrow;
  const bool leader = (tid & 127) == 0;
  const int stg_bytes = 64 * kBN * (int)sizeof(T);
  float sx[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wrow + w * 16 + (lane >> 2) + 8 * h;
    if constexpr (STREAMED)
      sx[h] = row0 + r < p.M ? p.xs[row0 + r] : 0.f;
    else
      sx[h] = sxs[r];
  }
  uint32_t acc[2][kBN / 2];
  int it = 0, buf = 0;
  for (int nt = nt0; nt < nt1; ++nt) {
    const int n0 = nt * kBN;
    // phase: tile_start
    const float* sw = sws + (nt - nt0) * kBN;   // the tile's ws
    for (int kc = 0; kc < p.kchunks; ++kc, ++it) {
      const int s = it % S;
      mbar_wait(&full[s], (it / S) & 1);
      const unsigned char* st = ring + s * p.stage_bytes;
      const unsigned char* a =
          (STREAMED ? st + kTileBytes : sA + kc * kTileBytes) + wrow * kKC;
      // two accumulators, even and odd k32 steps: two chains of dependent
      // products a warpgroup keep the tensor cores busier than one
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kKSteps; ks += 2) {
        MmaS8<kBN>::ss(acc[0], desc_k128(a, ks), desc_k128(st, ks),
                       (kc | ks) != 0);
        MmaS8<kBN>::ss(acc[1], desc_k128(a, ks + 1), desc_k128(st, ks + 1),
                       (kc | ks) != 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (kc > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    }
    // phase: products_issued
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    if (lane == 0) mbar_arrive(&empty[(it - 1) % S]);
    // phase: products_done

    // this thread's ws, all read before any store
    float2 ws[kBN / 8];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      ws[j] = *reinterpret_cast<const float2*>(sw + 8 * j + 2 * t4);

    // epilogue: dequantised, rounded to x's type; through a staging tile
    // and a TMA store, which runs on during the next tile's products, or
    // straight from the registers
    unsigned char* sb = stg + (wg * p.nbuf + buf) * stg_bytes;
    if (p.tma_store) {
      // the staging tile is free once its last TMA store has read it
      if (leader) {
        if (p.nbuf > 1) bulk_wait_read<1>();
        else bulk_wait_read<0>();
      }
      bar_sync(1 + wg, 128);
    }
    // phase: staging_free
    // this thread's pairs: dequantised (the i8order mutation's line), then
    // written by `put`
    auto each_pair = [&](auto put) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 4 * j + 2 * h, f = e + 1;
          const float v0 = ((float)(int)(acc[0][e] + acc[1][e]) * sx[h]) * ws[j].x;
          const float v1 = ((float)(int)(acc[0][f] + acc[1][f]) * sx[h]) * ws[j].y;
          put(w * 16 + (lane >> 2) + 8 * h, 8 * j + 2 * t4, v0, v1);
        }
    };
    if (p.tma_store) {
      each_pair([&](int r, int col, float v0, float v1) {
        unsigned char* at = sb + stg_offset<T>(r, col);
        if constexpr (sizeof(T) == 2)
          *reinterpret_cast<uint32_t*>(at) = bf16x2(v0, v1);
        else
          *reinterpret_cast<float2*>(at) = make_float2(v0, v1);
      });
    } else {
      T* out = static_cast<T*>(p.out_ptr);
      const bool pairs = !(p.N & 1);   // N odd: pairs are not aligned
      each_pair([&](int r, int col, float v0, float v1) {
        if (grow0 + r >= p.M) return;
        T* o = out + (long long)(grow0 + r) * p.N + n0 + col;
        if (pairs && n0 + col + 1 < p.N) {
          if constexpr (sizeof(T) == 2)
            *reinterpret_cast<uint32_t*>(o) = bf16x2(v0, v1);
          else
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n0 + col < p.N) o[0] = T(v0);
          if (n0 + col + 1 < p.N) o[1] = T(v1);
        }
      });
    }
    // phase: values_staged
    if (p.tma_store) {
      fence_proxy_async();
      bar_sync(1 + wg, 128);
      // phase: second_barrier
      if (leader && grow0 < p.M) {
        constexpr int kBoxCols = 128 / sizeof(T);
        for (int b = 0; b < kBN / kBoxCols; ++b)
          if (n0 + b * kBoxCols < p.N)
            tma_store_2d(&p.out, sb + b * 64 * 128, n0 + b * kBoxCols, grow0);
        bulk_commit();
      }
      if (p.nbuf > 1) buf ^= 1;
    }
    // phase: store_issued
  }
  if (leader && p.tma_store) bulk_wait_all();
}

// ---------------------------------------------------------------------------
// the plan: the one place a launch's mode and tiling are chosen
// ---------------------------------------------------------------------------

struct Plan {
  int mode;               // 0: fused; 1: streamed (quantize_rows first)
  int splits;             // blocks over the N tiles of a row tile
  long long row_tiles;
  int n_tiles, kchunks;
  long long blocks;
  int stages, nbuf;       // ring stages; staging tiles a warpgroup (TMA)
  int group;              // threads a row when quantising
  int smem, ring_off, stg_off, xs_off, ws_off, bar_off, stage_bytes;
  int x_off, x_slots, x_boxes;   // fused: where x's row tile lies
  int tma_store;          // staging tiles and TMA stores (else plain stores)
  long long workspace;    // streamed: xq (M x Kq int8), then xs (M fp32)
};

inline long long align256(long long n) { return (n + 255) / 256 * 256; }
inline int k_row_bytes(int K) { return (K + 15) / 16 * 16; }   // xq's Kq

// The shared layout of f.mode (the int8 row tile, fused; the ring; staging;
// the row scales, fused; ws of a block's N tiles; barriers): staging tiles
// for TMA stores where out's rows are 16-byte aligned -- two a warpgroup
// with three ring stages if they fit, else one with three -- else plain
// stores from the registers and at least two stages.  Fused, x's row tile
// must also fit over the staging tiles and the ring.  False if none fits.
bool layout(Plan& f, int es, int K, bool aligned) {
  const int a = f.mode == 0 ? f.kchunks * kTileBytes : 0;
  const int xs = f.mode == 0 ? kBM * 4 : 0;
  const int ws = (f.n_tiles < kMaxWsTiles ? f.n_tiles : kMaxWsTiles) * kBN * 4;
  f.stage_bytes = (f.mode == 0 ? 1 : 2) * kTileBytes;
  for (int nbuf = aligned ? 2 : 0; nbuf >= 0; --nbuf) {
    const int stg = 2 * nbuf * 64 * kBN * es;
    const int fixed = a + stg + xs + ws + kBarBytes;
    if (fixed > kMaxSmem) continue;
    int stages = (kMaxSmem - fixed) / f.stage_bytes;
    if (stages > kMaxStages) stages = kMaxStages;
    if (stages < (nbuf ? 3 : 2)) continue;
    f.tma_store = nbuf > 0;
    f.nbuf = nbuf;
    f.stages = stages;
    f.ring_off = a;
    f.stg_off = a + stages * f.stage_bytes;
    f.xs_off = f.stg_off + stg;
    f.ws_off = f.xs_off + xs;
    f.bar_off = f.ws_off + ws;
    f.smem = f.bar_off + kBarBytes;
    if (f.mode == 0) {
      // x's row tile (K rounded up to 128-byte boxes) over the staging
      // tiles and, where it is longer, the last ring stages
      f.x_boxes = (K * es + 127) / 128;
      const int xbytes = 2 * f.x_boxes * 64 * 128;
      if (xbytes > stg + stages * f.stage_bytes) continue;
      f.x_off = f.stg_off + stg - (xbytes > stg ? xbytes : stg);
      f.x_slots = xbytes > stg
                      ? (xbytes - stg + f.stage_bytes - 1) / f.stage_bytes
                      : 0;
    }
    return true;
  }
  return false;
}

// the smallest power of two of threads (at most 32) that hold `vectors`
// vectors in kVMax each; 0 if 32 do not
int group_for(int vectors) {
  for (int g = 1; g <= 32; g *= 2)
    if ((vectors + g - 1) / g <= kVMax) return g;
  return 0;
}

// mode -1: the plan's own choice.  Fused where the row tile fits resident
// beside the staging tiles (TMA stores) and the row tiles alone fill at
// least half the SMs; else streamed: with few rows, each of the blocks that
// split a row tile's N tiles would quantise it again, and with K past 640
// (bf16) the resident tile leaves no room for staging.  The N tiles are
// split over the fewest blocks that take the fewest tile-times: waves of
// blocks times (N tiles a block + what a block spends before its first
// product: the quantisation of its row tile, fused, or the ring's first
// loads).  False for a mode that cannot run this shape.
bool plan(int dtype, int M, int N, int K, int mode, int sms, Plan& f) {
  const int es = dtype == 1 ? 2 : 4;
  f = Plan{};
  f.kchunks = (K + kKC - 1) / kKC;
  f.n_tiles = (N + kBN - 1) / kBN;
  f.row_tiles = (M + kBM - 1) / kBM;
  const bool aligned = (long long)N * es % 16 == 0;
  // the quantisers' groups: the fewest threads a row that hold it in kVMax
  // vectors each (fused: its zero padding to the last chunk's edge too;
  // streamed: 32 at most, a longer row in segments)
  const int V = 16 / es;
  const int fused_group = group_for((f.kchunks * kKC + V - 1) / V);
  Plan fused = f;
  fused.mode = 0;
  // fused: x's rows 16-byte aligned (a contiguous x; its TMA loads)
  const bool fits = fused_group > 0 && K * es % 16 == 0 &&
                    layout(fused, es, K, aligned);
  if (mode == 0 && !fits) return false;
  if (mode == 0 || (mode < 0 && fits && fused.tma_store &&
                     f.row_tiles * 2 >= sms)) {
    f = fused;
    f.group = fused_group;
  } else {
    f.mode = 1;
    if (!layout(f, es, K, aligned)) return false;
    const int g = group_for((K + V - 1) / V);
    f.group = g > 0 ? g : 32;
    f.workspace = align256((long long)M * k_row_bytes(K)) + (long long)M * 4;
  }
  const long long lead = f.mode == 0 ? 1 + f.kchunks * es / 2 : 1;
  long long best = -1;
  for (int sp = (f.n_tiles + kMaxWsTiles - 1) / kMaxWsTiles; sp <= f.n_tiles;
       ++sp) {
    const long long blocks = f.row_tiles * sp;
    const long long waves = (blocks + sms - 1) / sms;
    const long long cost = waves * ((f.n_tiles + sp - 1) / sp + lead);
    if (best < 0 || cost < best) {
      best = cost;
      f.splits = sp;
    }
  }
  f.blocks = f.row_tiles * f.splits;
  return true;
}

// streaming multiprocessors of the current device (0 if it cannot be read)
int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return n;
}

template <typename T, bool STREAMED>
int launch_gemm(const Plan& f, const Params& p, cudaStream_t st) {
  const auto kernel = int8_gemm<T, STREAMED>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, f.smem);
  if (e != cudaSuccess) return e;
  // streamed: may start before quantize_rows ends (it waits for it)
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = STREAMED ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)f.blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = f.smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, p);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
int run(const Plan& f, Params& p, const void* wt, long long w_s, void* work,
        cudaStream_t st) {
  const CUtensorMapDataType out_type = sizeof(T) == 2
                                           ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!make_map_2d(&p.w, wt, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.K, p.N, w_s,
                   kKC, kBN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (p.tma_store &&
       !make_map_2d(&p.out, p.out_ptr, out_type, p.N, p.M,
                    (long long)p.N * sizeof(T), 128 / sizeof(T), 64,
                    CU_TENSOR_MAP_SWIZZLE_128B)))
    return kMapRefused;
  if (f.mode == 0) {
    if (!p.x_vec) return -1;   // the TMA loads need 16-byte aligned rows
    if (!make_map_2d(&p.xm, p.x, out_type, p.K, p.M, p.x_s * sizeof(T),
                     128 / sizeof(T), 64, CU_TENSOR_MAP_SWIZZLE_NONE))
      return kMapRefused;
    return launch_gemm<T, false>(f, p, st);
  }
  int8_t* xq = static_cast<int8_t*>(work);
  float* xs = reinterpret_cast<float*>(
      static_cast<unsigned char*>(work) +
      align256((long long)p.M * k_row_bytes(p.K)));
  if (!make_map_2d(&p.a, xq, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.K, p.M,
                   k_row_bytes(p.K), kKC, kBM, CU_TENSOR_MAP_SWIZZLE_128B))
    return kMapRefused;
  p.xs = xs;
  const int rows = 256 / f.group;
  quantize_rows<T><<<(p.M + rows - 1) / rows, 256, 0, st>>>(p, xq, xs,
                                                            k_row_bytes(p.K));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_gemm<T, true>(f, p, st);
}

bool bad_args(int dtype, int M, int N, int K, int mode) {
  return M <= 0 || N <= 0 || K <= 0 || (dtype != 0 && dtype != 1) ||
         mode < -1 || mode > 1;
}

}  // namespace

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
// dtype: 0 = float32, 1 = bfloat16 (x and out).  x (M, K) with row stride
// x_s elements (column stride 1); wt = w_q^T, (N, K) int8 with row stride
// w_s bytes, both 16-byte aligned and w_s a multiple of 16 (what lies past K
// in a row is never read); ws (N,) fp32; out (M, N) contiguous, 16-byte
// aligned.  mode: -1 = the plan's choice, 0 = fused, 1 = streamed.
// `workspace`: int8_matmul_plan's workspace bytes (none when it says 0).
// Returns 0 on success, a cudaError_t value if a launch was refused, -1 for
// arguments the kernels do not take, or -2 if the driver refused a tensor
// map.

extern "C" int int8_matmul_fwd(const void* x, long long x_s, const void* wt,
                               long long w_s, const float* ws, void* out,
                               void* workspace, int dtype, int M, int N,
                               int K, int mode, void* stream) {
  if (bad_args(dtype, M, N, K, mode) || x_s < K || w_s < K || w_s % 16 ||
      reinterpret_cast<uintptr_t>(wt) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return -1;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  Plan f;
  if (!plan(dtype, M, N, K, mode, sms, f) ||
      (f.workspace > 0 && workspace == nullptr))
    return -1;
  const int es = dtype == 1 ? 2 : 4;
  Params p = {};
  p.x = x;
  p.ws = ws;
  p.out_ptr = out;
  p.x_s = x_s;
  p.M = M;
  p.N = N;
  p.K = K;
  p.kchunks = f.kchunks;
  p.n_tiles = f.n_tiles;
  p.splits = f.splits;
  p.stages = f.stages;
  p.nbuf = f.nbuf;
  p.group = f.group;
  p.x_vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && x_s * es % 16 == 0;
  p.tma_store = f.tma_store;
  p.ring_off = f.ring_off;
  p.stg_off = f.stg_off;
  p.xs_off = f.xs_off;
  p.ws_off = f.ws_off;
  p.x_off = f.x_off;
  p.x_slots = f.x_slots;
  p.x_boxes = f.x_boxes;
  p.bar_off = f.bar_off;
  p.stage_bytes = f.stage_bytes;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return run<__nv_bfloat16>(f, p, wt, w_s, workspace, st);
  return run<float>(f, p, wt, w_s, workspace, st);
}

// How a launch at this shape runs on a device of `sm_count` SMs, as
// int8_matmul_fwd decides it: out[] = {mode (0 fused, 1 streamed), splits
// (blocks over a row tile's N tiles), row tiles, N tiles, K chunks of 128,
// blocks, ring stages, staging tiles a warpgroup (0: plain stores from the
// registers, else TMA stores), threads a row when quantising (fused),
// threads a block, dynamic shared bytes, workspace bytes}.  Returns -1 for
// arguments the kernels do not take (or a mode that cannot run the shape).
extern "C" int int8_matmul_plan(int dtype, int M, int N, int K, int mode,
                                int sm_count, long long* out) {
  Plan f;
  if (bad_args(dtype, M, N, K, mode) || sm_count <= 0 ||
      !plan(dtype, M, N, K, mode, sm_count, f))
    return -1;
  const long long v[12] = {f.mode,   f.splits, f.row_tiles, f.n_tiles,
                           f.kchunks, f.blocks, f.stages,   f.nbuf,
                           f.group,  kThreads, f.smem,      f.workspace};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* int8_matmul_error_string(int code) {
  if (code == -1)
    return "arguments not supported by int8_matmul_fwd (or a mode that "
           "cannot run the shape, or no workspace where the plan needs one)";
  if (code == kMapRefused)
    return "cuTensorMapEncodeTiled refused a tensor map (driver entry point "
           "missing, or strides the TMA unit does not take)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
