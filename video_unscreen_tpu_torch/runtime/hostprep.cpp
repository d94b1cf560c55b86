// Host-side frame work of the fused pipelines, threaded over the batch:
// - the upload's preparation: OpenCV's INTER_LINEAR resize of uint8 images
//   and its BGR -> I420 conversion, bit-equal to cv2.resize(...,
//   INTER_LINEAR) and cv2.cvtColor(..., COLOR_BGR2YUV_I420);
// - the host fetch's reconstruction: the HSV fg un-blends against a screen
//   colour (vu_get_fg_batch) and against a background image
//   (vu_unblend_fg_batch), and cv2's 8-bit BGR <-> HSV.
// No libjpeg and no OpenCV: bound with ctypes by
// video_unscreen_tpu_torch/runtime/__init__.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 hostprep.cpp -pthread
//        -ffp-contract=off

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


// ---------------------------------------------------------------------------
// Foreground un-blend (fgfuncs.py:84-110 semantics): fg = clamp(img_hsv -
// (1-alpha) * bg_hsv) converted back to BGR. Lets the host reconstruct the
// fg artifact from (frame, alpha, bg_color) instead of shipping a full fg
// plane over the device->host link.

namespace {

inline void bgr2hsv(float b, float g, float r, float* h, float* s,
                    float* v) {
  float mx = r > g ? (r > b ? r : b) : (g > b ? g : b);
  float mn = r < g ? (r < b ? r : b) : (g < b ? g : b);
  float c = mx - mn;
  *v = mx;
  *s = mx > 0 ? 255.0f * c / mx : 0.0f;
  float hh = 0.0f;
  if (c > 1e-8f) {
    if (mx == r) hh = 60.0f * (g - b) / c;
    else if (mx == g) hh = 120.0f + 60.0f * (b - r) / c;
    else hh = 240.0f + 60.0f * (r - g) / c;
    if (hh < 0) hh += 360.0f;
  }
  *h = hh * 0.5f;
}

inline void hsv2bgr(float h, float s, float v, float* b, float* g,
                    float* r) {
  h *= 2.0f;
  s /= 255.0f;
  float c = v * s;
  float hp = h / 60.0f;
  float x = c * (1.0f - std::abs(std::fmod(hp, 2.0f) - 1.0f));
  float rr = 0, gg = 0, bb = 0;
  int idx = static_cast<int>(hp) % 6;
  switch (idx < 0 ? idx + 6 : idx) {
    case 0: rr = c; gg = x; break;
    case 1: rr = x; gg = c; break;
    case 2: gg = c; bb = x; break;
    case 3: gg = x; bb = c; break;
    case 4: rr = x; bb = c; break;
    default: rr = c; bb = x; break;
  }
  float m = v - c;
  *b = bb + m;
  *g = gg + m;
  *r = rr + m;
}

inline uint8_t clamp_u8(float x) {
  return x <= 0 ? 0 : (x >= 255 ? 255 : static_cast<uint8_t>(x + 0.5f));
}

}  // namespace

// frames: (n, h, w, 3) BGR u8; alphas: (n, h, w) u8;
// bg_colors: (n, 3) float BGR; out: (n, h, w, 3) BGR u8 = alpha*fg.
int vu_get_fg_batch(const uint8_t* frames, const uint8_t* alphas,
                    const float* bg_colors, uint8_t* out, int n, int h,
                    int w, int threads) {
  const size_t plane = static_cast<size_t>(h) * w;
  parallel_for(n, threads, [&](int i) {
    const uint8_t* frame = frames + i * plane * 3;
    const uint8_t* alpha = alphas + i * plane;
    uint8_t* dst = out + i * plane * 3;
    float bh, bs, bv;
    bgr2hsv(bg_colors[i * 3 + 0], bg_colors[i * 3 + 1],
            bg_colors[i * 3 + 2], &bh, &bs, &bv);
    for (size_t p = 0; p < plane; ++p) {
      float a = alpha[p] / 255.0f;
      float ih, is, iv;
      bgr2hsv(frame[p * 3], frame[p * 3 + 1], frame[p * 3 + 2],
              &ih, &is, &iv);
      // bg image is the frame itself where alpha < 128
      // (tools/unscreen/green.py:125: bgimg[alpha < 128] = frame)
      float ubh = bh, ubs = bs, ubv = bv;
      if (alpha[p] < 128) { ubh = ih; ubs = is; ubv = iv; }
      float fh = ih - (1.0f - a) * ubh;
      float fs = is - (1.0f - a) * ubs;
      float fv = iv - (1.0f - a) * ubv;
      fh = fh < 0 ? 0 : (fh > 255 ? 255 : fh);
      fs = fs < 0 ? 0 : (fs > 255 ? 255 : fs);
      fv = fv < 0 ? 0 : (fv > 255 ? 255 : fv);
      float b, g, r;
      hsv2bgr(fh, fs, fv, &b, &g, &r);
      dst[p * 3] = clamp_u8(b);
      dst[p * 3 + 1] = clamp_u8(g);
      dst[p * 3 + 2] = clamp_u8(r);
    }
  });
  return 0;
}

// Per-pixel-background variant (bg mode): frames (n, h, w, 3) BGR u8,
// alphas (n, h, w) u8, bgs (n, h, w, 3) BGR u8 (the regionfilled
// background), out (n, h, w, 3) u8 = alpha*fg. Same HSV un-blend as
// vu_get_fg_batch but the background is an image, not a flat color —
// reconstructs fused bg mode's fg artifact on the host from the
// (alpha, downsampled-bg) wire payload.
int vu_unblend_fg_batch(const uint8_t* frames, const uint8_t* alphas,
                        const uint8_t* bgs, uint8_t* out, int n, int h,
                        int w, int threads) {
  const size_t plane = static_cast<size_t>(h) * w;
  parallel_for(n, threads, [&](int i) {
    const uint8_t* frame = frames + i * plane * 3;
    const uint8_t* alpha = alphas + i * plane;
    const uint8_t* bg = bgs + i * plane * 3;
    uint8_t* dst = out + i * plane * 3;
    for (size_t p = 0; p < plane; ++p) {
      float a = alpha[p] / 255.0f;
      float ih, is, iv, bh, bs, bv;
      bgr2hsv(frame[p * 3], frame[p * 3 + 1], frame[p * 3 + 2],
              &ih, &is, &iv);
      bgr2hsv(bg[p * 3], bg[p * 3 + 1], bg[p * 3 + 2], &bh, &bs, &bv);
      float fh = ih - (1.0f - a) * bh;
      float fs = is - (1.0f - a) * bs;
      float fv = iv - (1.0f - a) * bv;
      fh = fh < 0 ? 0 : (fh > 255 ? 255 : fh);
      fs = fs < 0 ? 0 : (fs > 255 ? 255 : fs);
      fv = fv < 0 ? 0 : (fv > 255 ? 255 : fv);
      float b, g, r;
      hsv2bgr(fh, fs, fv, &b, &g, &r);
      dst[p * 3] = clamp_u8(b);
      dst[p * 3 + 1] = clamp_u8(g);
      dst[p * 3 + 2] = clamp_u8(r);
    }
  });
  return 0;
}

// ---------------------------------------------------------------------------
// OpenCV's 8-bit BGR <-> HSV (H in 0..179), bit-equal to cv2.cvtColor of
// the cv2 build the JAX package runs with (5.0.0, AVX-512 dispatch), for
// fused bg mode's host reconstruction of the darkened background.
// - BGR2HSV is OpenCV's fixed-point formula (12-bit division tables).
// - HSV2BGR computes in float32 with fused multiply-adds, and its rounding
//   depends on where a pixel sits in its row: the first 32 * floor(w / 32)
//   pixels of a row go through cv2's vector loop, which truncates; the rest
//   through its scalar tail, which rounds to nearest.

namespace {

constexpr int kHsvShift = 12;
constexpr int kHsvBlock = 32;

struct HsvTables {
  int sdiv[256];
  int hdiv[256];
  HsvTables() {
    sdiv[0] = hdiv[0] = 0;
    for (int i = 1; i < 256; ++i) {
      sdiv[i] = static_cast<int>(std::lrint((255 << kHsvShift) / (1. * i)));
      hdiv[i] = static_cast<int>(std::lrint((180 << kHsvShift) / (6. * i)));
    }
  }
};

const HsvTables& hsv_tables() {
  static const HsvTables t;
  return t;
}

void bgr2hsv_cv_row(const uint8_t* src, uint8_t* dst, int w) {
  const HsvTables& t = hsv_tables();
  for (int x = 0; x < w; ++x) {
    const int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
    int v = b, vmin = b;
    if (g > v) v = g;
    if (r > v) v = r;
    if (g < vmin) vmin = g;
    if (r < vmin) vmin = r;
    const int diff = v - vmin;
    const int vr = v == r ? -1 : 0;
    const int vg = v == g ? -1 : 0;
    const int s = (diff * t.sdiv[v] + (1 << (kHsvShift - 1))) >> kHsvShift;
    int h = (vr & (g - b)) +
            (~vr & ((vg & (b - r + 2 * diff)) + (~vg & (r - g + 4 * diff))));
    h = (h * t.hdiv[diff] + (1 << (kHsvShift - 1))) >> kHsvShift;
    h += h < 0 ? 180 : 0;
    dst[3 * x] = static_cast<uint8_t>(h);
    dst[3 * x + 1] = static_cast<uint8_t>(s);
    dst[3 * x + 2] = static_cast<uint8_t>(v);
  }
}

inline uint8_t sat_u8(float x, bool truncate) {
  const float y = truncate ? std::trunc(x) : std::nearbyint(x);
  return y <= 0.f ? 0 : (y >= 255.f ? 255 : static_cast<uint8_t>(y));
}

void hsv2bgr_cv_row(const uint8_t* src, uint8_t* dst, int w) {
  static const int kSector[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                                    {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const int vec_end = w / kHsvBlock * kHsvBlock;
  for (int x = 0; x < w; ++x) {
    const float s = src[3 * x + 1] * (1.f / 255.f);
    const float v = src[3 * x + 2] * (1.f / 255.f);
    float h = src[3 * x] * (6.f / 180.f);
    int sector = static_cast<int>(std::floor(h));
    h -= static_cast<float>(sector);
    if (static_cast<unsigned>(sector) >= 6u) {
      sector = 0;
      h = 0.f;
    }
    const float tab[4] = {v, v * (1.f - s), v * std::fma(-s, h, 1.f),
                          v * std::fma(-s, 1.f - h, 1.f)};
    const bool truncate = x < vec_end;
    for (int c = 0; c < 3; ++c)
      dst[3 * x + c] = sat_u8(tab[kSector[sector][c]] * 255.f, truncate);
  }
}

}  // namespace

// rows x w pixels of 3 uint8 channels, row-major and contiguous, each row
// converted as cv2 converts a row of that width.
int vu_bgr2hsv_cv(const uint8_t* src, uint8_t* dst, int rows, int w,
                  int threads) {
  const size_t stride = static_cast<size_t>(w) * 3;
  parallel_for(rows, threads, [&](int y) {
    bgr2hsv_cv_row(src + y * stride, dst + y * stride, w);
  });
  return 0;
}

int vu_hsv2bgr_cv(const uint8_t* src, uint8_t* dst, int rows, int w,
                  int threads) {
  const size_t stride = static_cast<size_t>(w) * 3;
  parallel_for(rows, threads, [&](int y) {
    hsv2bgr_cv_row(src + y * stride, dst + y * stride, w);
  });
  return 0;
}

}  // extern "C"
