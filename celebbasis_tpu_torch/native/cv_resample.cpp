// OpenCV's uint8 resamplers, reproduced bit for bit: cv::resize with
// INTER_LINEAR and cv::warpAffine with INTER_LINEAR and a zero constant
// border, on interleaved (H, W, C) uint8 images. Exposed with C linkage for
// ctypes; the Python side (align/cv_resample.py) computes the output size
// and the scale factors as cv::resize does.
//
// resize (imgproc/src/resize.cpp, the non-exact INTER_LINEAR path):
//   * a source position per output pixel, fx = (float)((dx + 0.5) * scale
//     - 0.5) with scale = 1 / inv_scale in double, split into floor and
//     fraction in float; positions left of the first pixel or right of the
//     last clamp to it with fraction 0;
//   * 11-bit coefficients round((1 - f) * 2048), round(f * 2048) (round
//     half to even), a horizontal pass into int, and the vertical pass of
//     VResizeLinear's uchar specialisation:
//     (((b0 * (h0 >> 4)) >> 16) + ((b1 * (h1 >> 4)) >> 16) + 2) >> 2;
//   * a scale of exactly 2 in both axes is INTER_AREA's fast path: the
//     2x2 mean (sum + 2) >> 2, and for blocks cut by an odd edge the mean of
//     the pixels present, rounded half to even in float;
//   * an output of the input's size is a copy.
// warpAffine exists in two generations, which give different pixels;
// cv_warp_affine_u8 takes the one to reproduce. Both invert M in double
// (cv::warpAffine). OpenCV 4 (imgproc/src/imgwarp.cpp, WarpAffineInvoker
// and remapBilinear):
//   * source positions in fixed point: per column round(m0 * x * 1024),
//     per row round((m1 * y + m2) * 1024) + 16 (round half to even), their
//     sum >> 5, i.e. 1/32 pixel: the integer part >> 5, the fraction & 31;
//   * 15-bit weights (32 - fy)(32 - fx) * 32 ... from the fractions, taps
//     outside the image 0, (sum + 2^14) >> 15.
// OpenCV 5 (imgproc/src/warp_kernels.simd.hpp):
//   * the inverse rounded to float;
//   * per row, bx = (float)y * m1 + m2 in two float roundings; per pixel
//     the source position fma(m0, x, bx), fma(m3, x, by), for the pixels
//     of the vector loop (16 at a time on x86 with AVX2 or AVX-512); the
//     scalar loop after it (the last dw % 16 pixels of a row) computes
//     fma(x, m0, (float)y * m1) + m2 instead;
//   * bilinear weights are the float fractions; taps outside the image are
//     0; v0 = fma(ax, p01 - p00, p00), v1 = fma(ax, p11 - p10, p10),
//     v = fma(ay, v1 - v0, v0), rounded half to even and saturated.
//
// Built with -ffp-contract=off: every fused multiply-add above is an
// explicit std::fma, and nothing else is fused.
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// pixels per iteration of warpAffine's vector loop
constexpr int kVecPixels = 16;

inline uint8_t sat_u8(long v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// cv::resize's INTER_AREA fast path at a scale of exactly 2.
void area_half(const uint8_t* src, int H, int W, int C, uint8_t* dst, int dh,
               int dw) {
  const int full_w = W / 2;
  for (int dy = 0; dy < dh; ++dy) {
    const int sy = 2 * dy;
    const bool full_row = sy + 2 <= H;
    for (int dx = 0; dx < dw; ++dx) {
      const int sx = 2 * dx;
      for (int c = 0; c < C; ++c) {
        uint8_t* out = dst + (static_cast<size_t>(dy) * dw + dx) * C + c;
        if (full_row && dx < full_w) {
          const uint8_t* s0 = src + (static_cast<size_t>(sy) * W + sx) * C + c;
          const uint8_t* s1 = s0 + static_cast<size_t>(W) * C;
          *out = static_cast<uint8_t>((s0[0] + s0[C] + s1[0] + s1[C] + 2) >> 2);
          continue;
        }
        int sum = 0, count = 0;
        for (int y = sy; y < sy + 2 && y < H; ++y)
          for (int x = sx; x < sx + 2 && x < W; ++x) {
            sum += src[(static_cast<size_t>(y) * W + x) * C + c];
            ++count;
          }
        *out = count ? sat_u8(std::lrint(static_cast<float>(sum) /
                                         static_cast<float>(count)))
                     : 0;
      }
    }
  }
}

}  // namespace

extern "C" {

// cv::resize(src, (dw, dh), INTER_LINEAR) with inv_scale_x = dw / W (or the
// fx given), inv_scale_y likewise, as cv::resize passes them on.
void cv_resize_linear_u8(const uint8_t* src, int H, int W, int C,
                         uint8_t* dst, int dh, int dw, double inv_scale_x,
                         double inv_scale_y) {
  std::fesetround(FE_TONEAREST);
  if (dh == H && dw == W) {
    std::memcpy(dst, src, static_cast<size_t>(H) * W * C);
    return;
  }
  const double scale_x = 1.0 / inv_scale_x, scale_y = 1.0 / inv_scale_y;
  const long iscale_x = std::lrint(scale_x), iscale_y = std::lrint(scale_y);
  if (std::fabs(scale_x - iscale_x) < 2.220446049250313e-16 &&
      std::fabs(scale_y - iscale_y) < 2.220446049250313e-16 &&
      iscale_x == 2 && iscale_y == 2) {
    area_half(src, H, W, C, dst, dh, dw);
    return;
  }
  std::vector<int> xofs(dw);
  std::vector<int> a0(dw), a1(dw);
  for (int dx = 0; dx < dw; ++dx) {
    float fx = static_cast<float>((dx + 0.5) * scale_x - 0.5);
    int sx = static_cast<int>(std::floor(fx));
    fx -= static_cast<float>(sx);
    if (sx < 0) fx = 0.f, sx = 0;
    if (sx >= W - 1) fx = 0.f, sx = W - 1;
    xofs[dx] = sx;
    a0[dx] = static_cast<int>(std::lrint((1.f - fx) * 2048.f));
    a1[dx] = static_cast<int>(std::lrint(fx * 2048.f));
  }
  std::vector<int> h0(static_cast<size_t>(dw) * C), h1(h0.size());
  auto hpass = [&](int sy, int* h) {
    const uint8_t* row = src + static_cast<size_t>(sy) * W * C;
    for (int dx = 0; dx < dw; ++dx) {
      const int sx = xofs[dx];
      const int sx1 = sx + 1 < W ? sx + 1 : sx;    // a1 is 0 there
      for (int c = 0; c < C; ++c)
        h[dx * C + c] = row[sx * C + c] * a0[dx] + row[sx1 * C + c] * a1[dx];
    }
  };
  for (int dy = 0; dy < dh; ++dy) {
    float fy = static_cast<float>((dy + 0.5) * scale_y - 0.5);
    const int sy = static_cast<int>(std::floor(fy));
    fy -= static_cast<float>(sy);
    const int b0 = static_cast<int>(std::lrint((1.f - fy) * 2048.f));
    const int b1 = static_cast<int>(std::lrint(fy * 2048.f));
    const int y0 = sy < 0 ? 0 : (sy > H - 1 ? H - 1 : sy);
    const int y1 = sy + 1 < 0 ? 0 : (sy + 1 > H - 1 ? H - 1 : sy + 1);
    hpass(y0, h0.data());
    hpass(y1, h1.data());
    uint8_t* out = dst + static_cast<size_t>(dy) * dw * C;
    for (int i = 0; i < dw * C; ++i)
      out[i] = static_cast<uint8_t>(
          (((b0 * (h0[i] >> 4)) >> 16) + ((b1 * (h1[i] >> 4)) >> 16) + 2) >>
          2);
  }
}

}  // extern "C"

namespace {

// OpenCV 4's warpAffine of the inverse transform inv.
void warp_affine_v4(const uint8_t* src, int H, int W, int C, uint8_t* dst,
                    int dh, int dw, const double* inv) {
  std::vector<long> adelta(dw), bdelta(dw);
  for (int x = 0; x < dw; ++x) {
    adelta[x] = std::lrint(inv[0] * x * 1024.0);
    bdelta[x] = std::lrint(inv[3] * x * 1024.0);
  }
  for (int y = 0; y < dh; ++y) {
    const long X0 = std::lrint((inv[1] * y + inv[2]) * 1024.0) + 16;
    const long Y0 = std::lrint((inv[4] * y + inv[5]) * 1024.0) + 16;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * C;
    for (int x = 0; x < dw; ++x, out += C) {
      const long X = (X0 + adelta[x]) >> 5, Y = (Y0 + bdelta[x]) >> 5;
      const long sx = X >> 5, sy = Y >> 5, fx = X & 31, fy = Y & 31;
      const long w[4] = {(32 - fy) * (32 - fx) * 32, (32 - fy) * fx * 32,
                         fy * (32 - fx) * 32, fy * fx * 32};
      long sum[4] = {0, 0, 0, 0};
      for (int k = 0; k < 4; ++k) {
        const long tx = sx + (k & 1), ty = sy + (k >> 1);
        if (tx < 0 || tx >= W || ty < 0 || ty >= H) continue;
        const uint8_t* p = src + (static_cast<size_t>(ty) * W + tx) * C;
        for (int c = 0; c < C; ++c) sum[c] += w[k] * p[c];
      }
      for (int c = 0; c < C; ++c) out[c] = sat_u8((sum[c] + (1 << 14)) >> 15);
    }
  }
}

// OpenCV 5's warpAffine of the inverse transform inv.
void warp_affine_v5(const uint8_t* src, int H, int W, int C, uint8_t* dst,
                    int dh, int dw, const double* inv) {
  float m[6];
  for (int i = 0; i < 6; ++i) m[i] = static_cast<float>(inv[i]);
  std::vector<float> p(4 * static_cast<size_t>(C));
  const int vec_end = dw / kVecPixels * kVecPixels;
  for (int y = 0; y < dh; ++y) {
    const float fy = static_cast<float>(y);
    const float ym1 = fy * m[1], ym4 = fy * m[4];
    const float bx = ym1 + m[2], by = ym4 + m[5];
    uint8_t* out = dst + static_cast<size_t>(y) * dw * C;
    for (int x = 0; x < dw; ++x, out += C) {
      const float fx = static_cast<float>(x);
      const float sx = x < vec_end ? std::fma(m[0], fx, bx)
                                   : std::fma(fx, m[0], ym1) + m[2];
      const float sy = x < vec_end ? std::fma(m[3], fx, by)
                                   : std::fma(fx, m[3], ym4) + m[5];
      // all four taps outside (or no number): the border value
      if (!(sx >= -1.f && sx < static_cast<float>(W) && sy >= -1.f &&
            sy < static_cast<float>(H))) {
        std::memset(out, 0, C);
        continue;
      }
      const int ix = static_cast<int>(std::floor(sx));
      const int iy = static_cast<int>(std::floor(sy));
      const float ax = sx - static_cast<float>(ix);
      const float ay = sy - static_cast<float>(iy);
      for (int k = 0; k < 4; ++k) {
        const int tx = ix + (k & 1), ty = iy + (k >> 1);
        const bool in = tx >= 0 && tx < W && ty >= 0 && ty < H;
        for (int c = 0; c < C; ++c)
          p[k * C + c] =
              in ? src[(static_cast<size_t>(ty) * W + tx) * C + c] : 0.f;
      }
      for (int c = 0; c < C; ++c) {
        const float p00 = p[c], p01 = p[C + c], p10 = p[2 * C + c],
                    p11 = p[3 * C + c];
        const float v0 = std::fma(ax, p01 - p00, p00);
        const float v1 = std::fma(ax, p11 - p10, p10);
        out[c] = sat_u8(std::lrint(std::fma(ay, v1 - v0, v0)));
      }
    }
  }
}

}  // namespace

extern "C" {

// cv::warpAffine(src, M, (dw, dh), INTER_LINEAR, BORDER_CONSTANT, 0) as
// OpenCV `version` (4 or 5) computes it: M is the (2, 3) row-major
// source-to-output transform.  Returns 0, or -1 for another version.
int cv_warp_affine_u8(const uint8_t* src, int H, int W, int C, uint8_t* dst,
                      int dh, int dw, const double* M, int version) {
  std::fesetround(FE_TONEAREST);
  double d = M[0] * M[4] - M[1] * M[3];
  d = d != 0 ? 1.0 / d : 0.0;
  double inv[6] = {M[4] * d, -M[1] * d, 0.0, -M[3] * d, M[0] * d, 0.0};
  inv[2] = -inv[0] * M[2] - inv[1] * M[5];
  inv[5] = -inv[3] * M[2] - inv[4] * M[5];
  if (version == 4) {
    warp_affine_v4(src, H, W, C, dst, dh, dw, inv);
  } else if (version == 5) {
    warp_affine_v5(src, H, W, C, dst, dh, dw, inv);
  } else {
    return -1;
  }
  return 0;
}

}  // extern "C"
