// Host NMS for the face detector: greedy hard-NMS (the reference's Cython
// cpu_nms), soft-NMS (cpu_soft_nms) and a bitmask variant with the structure
// of the reference's CUDA kernel (64-box blocks, suppression bitmasks) on
// CPU threads. The same algorithms as the JAX package's native/nms.cpp.
// Exposed with C linkage for ctypes.
//
// Layout: dets is (n, 5) row-major float32 [x1, y1, x2, y2, score].
// greedy_nms writes kept indices into `keep` (capacity n) and returns the
// count.
//
// Built at first use by celebbasis_tpu_torch/align/native.py (g++).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

struct Box {
  float x1, y1, x2, y2, score;
  float area() const { return (x2 - x1 + 1.f) * (y2 - y1 + 1.f); }
};

inline float iou(const Box& a, const Box& b) {
  const float xx1 = std::max(a.x1, b.x1);
  const float yy1 = std::max(a.y1, b.y1);
  const float xx2 = std::min(a.x2, b.x2);
  const float yy2 = std::min(a.y2, b.y2);
  const float w = std::max(0.f, xx2 - xx1 + 1.f);
  const float h = std::max(0.f, yy2 - yy1 + 1.f);
  const float inter = w * h;
  return inter / (a.area() + b.area() - inter);
}

}  // namespace

extern "C" {

// Greedy hard-NMS. Returns number of kept boxes; indices in `keep` refer to
// the ORIGINAL row order of `dets` (like the reference's cpu_nms).
int greedy_nms(const float* dets, int n, float thresh, int* keep) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  std::vector<uint8_t> suppressed(n, 0);
  int n_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep[n_keep++] = i;
    const Box* bi = reinterpret_cast<const Box*>(dets + i * 5);
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      const Box* bj = reinterpret_cast<const Box*>(dets + j * 5);
      if (iou(*bi, *bj) >= thresh) suppressed[j] = 1;
    }
  }
  return n_keep;
}

// Soft-NMS (Bodla et al.): method 0=hard(linear w/ Nt), 1=linear, 2=gaussian.
// Mutates boxes_scores (n,5) in place like the reference cpu_soft_nms and
// returns the number of surviving boxes (score > threshold), compacted to the
// front of the array.
int soft_nms(float* dets, int n, float sigma, float nt, float threshold,
             int method) {
  int count = n;
  for (int i = 0; i < count; ++i) {
    // move the max-score box of [i, count) to position i
    int max_pos = i;
    for (int j = i + 1; j < count; ++j)
      if (dets[j * 5 + 4] > dets[max_pos * 5 + 4]) max_pos = j;
    for (int k = 0; k < 5; ++k) std::swap(dets[i * 5 + k], dets[max_pos * 5 + k]);
    const Box bi = *reinterpret_cast<const Box*>(dets + i * 5);
    int j = i + 1;
    while (j < count) {
      Box* bj = reinterpret_cast<Box*>(dets + j * 5);
      const float ov = iou(bi, *bj);
      float weight = 1.f;
      if (method == 1) {  // linear
        if (ov > nt) weight = 1.f - ov;
      } else if (method == 2) {  // gaussian
        weight = std::exp(-(ov * ov) / sigma);
      } else {  // hard
        if (ov > nt) weight = 0.f;
      }
      bj->score *= weight;
      if (bj->score < threshold) {
        // discard: swap with the last active box and shrink
        for (int k = 0; k < 5; ++k)
          std::swap(dets[j * 5 + k], dets[(count - 1) * 5 + k]);
        --count;
      } else {
        ++j;
      }
    }
  }
  return count;
}

// Bitmask-parallel NMS — CPU port of the CUDA blockwise algorithm
// (nms_kernel.cu): 64-box tiles, per-pair IoU into uint64 masks computed by a
// thread pool, then a serial scan OR-ing suppression words.
int bitmask_nms(const float* dets, int n, float thresh, int* keep) {
  if (n == 0) return 0;
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int a, int b) {
    return dets[a * 5 + 4] > dets[b * 5 + 4];
  });
  const int kBlock = 64;
  const int n_blocks = (n + kBlock - 1) / kBlock;
  std::vector<uint64_t> mask(static_cast<size_t>(n) * n_blocks, 0);

  auto fill_rows = [&](int row_begin, int row_end) {
    for (int i = row_begin; i < row_end; ++i) {
      const Box* bi = reinterpret_cast<const Box*>(dets + order[i] * 5);
      for (int jb = i / kBlock; jb < n_blocks; ++jb) {
        uint64_t bits = 0;
        const int j_lo = jb * kBlock;
        const int j_hi = std::min(j_lo + kBlock, n);
        for (int j = std::max(j_lo, i + 1); j < j_hi; ++j) {
          const Box* bj = reinterpret_cast<const Box*>(dets + order[j] * 5);
          if (iou(*bi, *bj) > thresh) bits |= (1ull << (j - j_lo));
        }
        mask[static_cast<size_t>(i) * n_blocks + jb] = bits;
      }
    }
  };
  const int n_threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 16u));
  std::vector<std::thread> pool;
  const int rows_per = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    const int lo = t * rows_per, hi = std::min(lo + rows_per, n);
    if (lo < hi) pool.emplace_back(fill_rows, lo, hi);
  }
  for (auto& th : pool) th.join();

  std::vector<uint64_t> removed(n_blocks, 0);
  int n_keep = 0;
  for (int i = 0; i < n; ++i) {
    const int block = i / kBlock, bit = i % kBlock;
    if (removed[block] & (1ull << bit)) continue;
    keep[n_keep++] = order[i];
    const uint64_t* row = mask.data() + static_cast<size_t>(i) * n_blocks;
    for (int jb = block; jb < n_blocks; ++jb) removed[jb] |= row[jb];
  }
  return n_keep;
}

}  // extern "C"
