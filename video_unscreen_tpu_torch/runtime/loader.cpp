// Native data-loader runtime: threaded JPEG decode/encode + resize.
//
// The port's own copy of video_unscreen_tpu/runtime/loader.cpp (the
// PyTorch package imports nothing of the JAX one), bound with ctypes by
// video_unscreen_tpu_torch/runtime/__init__.py. Unlike the original, the
// encoder also writes single-channel (JCS_GRAYSCALE) JPEGs, as cv2.imwrite
// does for a 2-D image.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 loader.cpp -ljpeg -pthread

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Bilinear resize (half-pixel centers), BGR u8, for decode_batch's
// target_hw. Float weights: within a few levels of cv2.INTER_LINEAR, not
// bit-equal (hostprep.cpp has OpenCV's fixed-point scheme).
void resize_bilinear(const uint8_t* src, int sh, int sw, uint8_t* dst,
                     int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    if (y0 > sh - 2) y0 = sh - 2;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const uint8_t* p00 = src + (y0 * sw + x0) * 3;
      const uint8_t* p01 = p00 + 3;
      const uint8_t* p10 = p00 + sw * 3;
      const uint8_t* p11 = p10 + 3;
      uint8_t* out = dst + (y * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + wx * (p01[c] - p00[c]);
        float bot = p10[c] + wx * (p11[c] - p10[c]);
        out[c] = static_cast<uint8_t>(top + wy * (bot - top) + 0.5f);
      }
    }
  }
}

// Decode one JPEG file to BGR u8 (channels 3) or to libjpeg's grayscale
// output (channels 1: the luma plane of a colour file, as cv2.imread's
// IMREAD_GRAYSCALE reads it; only at the file's own size). Returns 0 on
// success.
int decode_one(const char* path, int target_h, int target_w, int channels,
               uint8_t* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  if (channels == 1 &&
      (static_cast<int>(cinfo.image_height) != target_h ||
       static_cast<int>(cinfo.image_width) != target_w)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 3;
  }
  // libjpeg-turbo BGR output, or the grayscale one
  cinfo.out_color_space = channels == 1 ? JCS_GRAYSCALE : JCS_EXT_BGR;
  jpeg_start_decompress(&cinfo);
  const int sw = cinfo.output_width;
  const int sh = cinfo.output_height;
  std::vector<uint8_t> buf(static_cast<size_t>(sw) * sh * channels);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + static_cast<size_t>(cinfo.output_scanline)
                   * sw * channels;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);

  if (target_h == sh && target_w == sw) {
    std::memcpy(out, buf.data(), buf.size());
  } else {
    resize_bilinear(buf.data(), sh, sw, out, target_h, target_w);
  }
  return 0;
}

// Encode one BGR (c = 3) or gray (c = 1) u8 buffer to a JPEG file.
// Returns 0 on success.
int encode_one(const char* path, const uint8_t* img, int h, int w, int c,
               int quality) {
  FILE* f = fopen(path, "wb");
  if (!f) return 1;
  jpeg_compress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_compress(&cinfo);
  jpeg_stdio_dest(&cinfo, f);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = c;
  cinfo.in_color_space = c == 1 ? JCS_GRAYSCALE : JCS_EXT_BGR;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(
        img + static_cast<size_t>(cinfo.next_scanline) * w * c);
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  fclose(f);
  return 0;
}

template <typename Fn>
void parallel_for(int n, int threads, Fn fn) {
  if (threads < 1) threads = 1;
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

// Decode n JPEGs into out (n, target_h, target_w, 3) BGR u8.
// Returns the number of failures; failed slots are zero-filled.
int vu_decode_batch(const char** paths, int n, int target_h, int target_w,
                    uint8_t* out, int threads) {
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(target_h) * target_w * 3;
  parallel_for(n, threads, [&](int i) {
    if (decode_one(paths[i], target_h, target_w, 3, out + i * stride) !=
        0) {
      std::memset(out + i * stride, 0, stride);
      failures.fetch_add(1);
    }
  });
  return failures.load();
}

// Decode n JPEGs of h x w into out (n, h, w) gray u8, libjpeg's grayscale
// output (a colour file's luma plane, as cv2.imread(..., IMREAD_GRAYSCALE)
// gives it). Returns the number of failures (a file of another size
// fails); failed slots are zero-filled.
int vu_decode_gray_batch(const char** paths, int n, int h, int w,
                         uint8_t* out, int threads) {
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(h) * w;
  parallel_for(n, threads, [&](int i) {
    if (decode_one(paths[i], h, w, 1, out + i * stride) != 0) {
      std::memset(out + i * stride, 0, stride);
      failures.fetch_add(1);
    }
  });
  return failures.load();
}

// Encode n u8 images (n, h, w, c), c = 3 (BGR) or 1 (gray), to paths.
// Returns failure count.
int vu_encode_batch(const char** paths, const uint8_t* imgs, int n, int h,
                    int w, int c, int quality, int threads) {
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(h) * w * c;
  parallel_for(n, threads, [&](int i) {
    if (encode_one(paths[i], imgs + i * stride, h, w, c, quality) != 0) {
      failures.fetch_add(1);
    }
  });
  return failures.load();
}

// Probe a JPEG's dimensions without full decode. Returns 0 on success.
int vu_probe(const char* path, int* h, int* w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  jpeg_error_mgr jerr;
  cinfo.err = jpeg_std_error(&jerr);
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  int ok = jpeg_read_header(&cinfo, TRUE) == JPEG_HEADER_OK;
  if (ok) {
    *h = cinfo.image_height;
    *w = cinfo.image_width;
  }
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return ok ? 0 : 2;
}

}  // extern "C"
