// Host-side frame preparation for the fused pipelines' upload: OpenCV's
// INTER_LINEAR resize of uint8 images and its BGR -> I420 conversion,
// bit-equal to cv2.resize(..., INTER_LINEAR) and
// cv2.cvtColor(..., COLOR_BGR2YUV_I420), threaded over the batch. No
// libjpeg and no OpenCV: bound with ctypes by
// video_unscreen_tpu_torch/runtime/__init__.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 hostprep.cpp -pthread

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// OpenCV's fixed-point bilinear weights: 11 fractional bits
constexpr int kCoefBits = 11;
constexpr int kCoefScale = 1 << kCoefBits;

// Source index and the two weights of each output coordinate, as OpenCV
// computes them: half-pixel centers in float, weights rounded to nearest
// even. `clamp` folds a tap outside the source onto the border with the
// full weight (OpenCV does so along x; along y it clamps the row index
// and keeps the weights).
struct Taps {
  std::vector<int> idx;
  std::vector<int> w0, w1;
};

Taps make_taps(int src, int dst, bool clamp) {
  Taps t;
  t.idx.resize(dst);
  t.w0.resize(dst);
  t.w1.resize(dst);
  const double scale = 1.0 / (static_cast<double>(dst) / src);
  for (int d = 0; d < dst; ++d) {
    float f = static_cast<float>((d + 0.5) * scale - 0.5);
    int s = static_cast<int>(std::floor(f));
    f -= s;
    if (clamp && s < 0) { f = 0.f; s = 0; }
    if (clamp && s >= src - 1) { f = 0.f; s = src - 1; }
    t.idx[d] = s;
    t.w0[d] = static_cast<int>(std::lrint((1.f - f) * kCoefScale));
    t.w1[d] = static_cast<int>(std::lrint(f * kCoefScale));
  }
  return t;
}

// Horizontal pass of one source row into int sums (weights' scale).
void hrow(const uint8_t* row, int sw, int c, const Taps& tx, int dw,
          int32_t* out) {
  for (int x = 0; x < dw; ++x) {
    const int s0 = tx.idx[x];
    const int s1 = s0 + 1 < sw ? s0 + 1 : s0;
    const int a0 = tx.w0[x], a1 = tx.w1[x];
    for (int k = 0; k < c; ++k)
      out[x * c + k] = row[s0 * c + k] * a0 + row[s1 * c + k] * a1;
  }
}

// cv2.resize(src, (dw, dh), interpolation=INTER_LINEAR) for uint8 with c
// channels. The vertical pass is OpenCV's 8-bit one, including its
// rounding: (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2.
// An exact 2x downscale (OpenCV's INTER_AREA shortcut) gives the same
// values.
void resize_one(const uint8_t* src, int sh, int sw, int c, uint8_t* dst,
                int dh, int dw, const Taps& tx, const Taps& ty) {
  const size_t rw = static_cast<size_t>(dw) * c;
  std::vector<int32_t> r0(rw), r1(rw);
  const size_t sstride = static_cast<size_t>(sw) * c;
  for (int y = 0; y < dh; ++y) {
    int y0 = ty.idx[y], y1 = y0 + 1;
    y0 = y0 < 0 ? 0 : (y0 > sh - 1 ? sh - 1 : y0);
    y1 = y1 < 0 ? 0 : (y1 > sh - 1 ? sh - 1 : y1);
    hrow(src + y0 * sstride, sw, c, tx, dw, r0.data());
    hrow(src + y1 * sstride, sw, c, tx, dw, r1.data());
    const int b0 = ty.w0[y], b1 = ty.w1[y];
    uint8_t* out = dst + y * rw;
    for (size_t i = 0; i < rw; ++i) {
      const int v = (((b0 * (r0[i] >> 4)) >> 16)
                     + ((b1 * (r1[i] >> 4)) >> 16) + 2) >> 2;
      out[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// BT.601 studio swing, OpenCV's 20-bit fixed point (RGB -> YUV420p)
constexpr int kShift = 20;
constexpr int kCRY = 269484, kCGY = 528482, kCBY = 102760;
constexpr int kCRU = -155188, kCGU = -305135, kCBU = 460324;
constexpr int kCGV = -385875, kCBV = -74448;

inline uint8_t sat_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// cv2.cvtColor(bgr, COLOR_BGR2YUV_I420): (h, w, 3) -> (h * 3 / 2, w), the
// Y plane, then U and V at half resolution, each taken from the top-left
// pixel of its 2x2 block. h and w even.
void i420_one(const uint8_t* bgr, int h, int w, uint8_t* dst) {
  const int half = 1 << (kShift - 1);
  uint8_t* yp = dst;
  uint8_t* up = dst + static_cast<size_t>(h) * w;
  uint8_t* vp = up + static_cast<size_t>(h / 2) * (w / 2);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = bgr + static_cast<size_t>(y) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int b = row[3 * x], g = row[3 * x + 1], r = row[3 * x + 2];
      yp[static_cast<size_t>(y) * w + x] = sat_u8(
          (kCRY * r + kCGY * g + kCBY * b + half + (16 << kShift)) >> kShift);
      if ((y & 1) == 0 && (x & 1) == 0) {
        const size_t k = static_cast<size_t>(y / 2) * (w / 2) + x / 2;
        up[k] = sat_u8((kCRU * r + kCGU * g + kCBU * b + half
                        + (128 << kShift)) >> kShift);
        vp[k] = sat_u8((kCBU * r + kCGV * g + kCBV * b + half
                        + (128 << kShift)) >> kShift);
      }
    }
  }
}

template <typename Fn>
void parallel_for(int n, int threads, Fn fn) {
  if (threads > n) threads = n;
  if (threads <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next(0);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t) {
    pool.emplace_back([&]() {
      int i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// n uint8 images (srcs[i]: sh x sw x c, contiguous) -> dst, contiguous:
// each resized to dh x dw when the sizes differ (else copied), then, when
// i420 is set (c = 3, dh and dw even), converted to (dh * 3 / 2, dw) I420.
int vu_prep_batch(const uint8_t** srcs, int n, int sh, int sw, int c,
                  int dh, int dw, int i420, uint8_t* dst, int threads) {
  const bool resize = sh != dh || sw != dw;
  const size_t plane = static_cast<size_t>(dh) * dw;
  const size_t out_stride = i420 ? plane * 3 / 2 : plane * c;
  Taps tx, ty;
  if (resize) {
    tx = make_taps(sw, dw, true);
    ty = make_taps(sh, dh, false);
  }
  parallel_for(n, threads, [&](int i) {
    uint8_t* out = dst + i * out_stride;
    if (!i420) {
      if (resize) resize_one(srcs[i], sh, sw, c, out, dh, dw, tx, ty);
      else std::memcpy(out, srcs[i], plane * c);
      return;
    }
    if (!resize) {
      i420_one(srcs[i], dh, dw, out);
      return;
    }
    std::vector<uint8_t> work(plane * 3);
    resize_one(srcs[i], sh, sw, 3, work.data(), dh, dw, tx, ty);
    i420_one(work.data(), dh, dw, out);
  });
  return 0;
}

}  // extern "C"
