// The port's JPEG codec: threaded decode and encode of baseline files,
// with no library.
//
// Written from ITU-T T.81 (JPEG) and the JFIF 1.02 specification, and held
// bit for bit to what libjpeg-turbo gives with the settings cv2 uses:
//
// - decode: sequential Huffman scans (SOF0, SOF1), 8-bit samples, 1 or 3
//   components, luma sampling 1x1, 2x1, 2x2 or 1x2 over chroma 1x1, the
//   file's own DQT and DHT tables, DRI and RSTn, byte stuffing and fill
//   bytes; APPn and COM segments are skipped. The integer ("islow") IDCT,
//   fancy (triangle) upsampling of the chroma planes and the YCbCr -> BGR
//   tables of libjpeg. A grayscale read is the luma plane alone.
// - encode: what jpeg_set_defaults + jpeg_set_quality(q, TRUE) write: a
//   JFIF 1.01 APP0, the two quality-scaled Annex K tables, SOF0, the four
//   Annex K Huffman tables; 4:2:0 YCbCr for BGR, one component for gray;
//   libjpeg's colour conversion, 2x2 downsampling, integer FDCT and its
//   reciprocal quantisation.
//
// Everything else (progressive, arithmetic-coded, lossless, hierarchical,
// 12-bit, CMYK, RGB-coded, other sampling) is refused with its name, as is
// a file that ends before its last block. Integer arithmetic only, so the
// bits are the same on every machine. Bound with ctypes by
// video_unscreen_tpu_torch/runtime/__init__.py.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread loader.cpp

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <stdexcept>
#include <string>
#include <thread>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw JpegError(what); }

// zigzag position -> natural (row-major) position
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// ---------------------------------------------------------------- tables
// Annex K: the example quantisation tables (natural order) and Huffman
// tables (bits[1..16], then the symbols).
const uint8_t kLumaQuant[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kChromaQuant[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1,
                                 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                   1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                   7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ------------------------------------------------- integer DCT constants
// libjpeg's islow transforms: 13-bit fixed-point constants, 2 extra bits
// kept between the passes.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// The post-IDCT range limit: libjpeg indexes its table with the descaled
// value & 0x3FF, so the value wraps as a signed 10-bit number before it is
// clamped to 0..255 around the centre 128.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int v = 0; v < 1024; ++v) {
      const int s = v < 512 ? v : v - 1024;
      t[v] = static_cast<uint8_t>(std::clamp(s + 128, 0, 255));
    }
  }
};
const RangeLimit kIdctLimit;

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// jpeg_idct_islow: dequantise the (natural-order) coefficients with `q`
// and write the 8x8 samples at `out` (row stride `stride`).
void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* qc = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      const int dc = (int(in[0]) * qc[0]) * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int(in[16]) * qc[16], z3 = int(in[48]) * qc[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int(in[0]) * qc[0];
    z3 = int(in[32]) * qc[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int(in[56]) * qc[56];
    tmp1 = int(in[40]) * qc[40];
    tmp2 = int(in[24]) * qc[24];
    tmp3 = int(in[8]) * qc[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits - kPass1Bits;
    w[0] = int(descale(tmp10 + tmp3, n));
    w[56] = int(descale(tmp10 - tmp3, n));
    w[8] = int(descale(tmp11 + tmp2, n));
    w[48] = int(descale(tmp11 - tmp2, n));
    w[16] = int(descale(tmp12 + tmp1, n));
    w[40] = int(descale(tmp12 - tmp1, n));
    w[24] = int(descale(tmp13 + tmp0, n));
    w[32] = int(descale(tmp13 - tmp0, n));
  }
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + static_cast<size_t>(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint8_t v = lim[descale(w[0], kPass1Bits + 3) & 0x3FF];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = kConstBits + kPass1Bits + 3;
    o[0] = lim[descale(tmp10 + tmp3, n) & 0x3FF];
    o[7] = lim[descale(tmp10 - tmp3, n) & 0x3FF];
    o[1] = lim[descale(tmp11 + tmp2, n) & 0x3FF];
    o[6] = lim[descale(tmp11 - tmp2, n) & 0x3FF];
    o[2] = lim[descale(tmp12 + tmp1, n) & 0x3FF];
    o[5] = lim[descale(tmp12 - tmp1, n) & 0x3FF];
    o[3] = lim[descale(tmp13 + tmp0, n) & 0x3FF];
    o[4] = lim[descale(tmp13 - tmp0, n) & 0x3FF];
  }
}

// jpeg_fdct_islow on 8x8 samples already centred (sample - 128), in place;
// the results are scaled up by 8.
void fdct_islow(int* d) {
  for (int r = 0; r < 8; ++r) {
    int* p = d + 8 * r;
    const int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    const int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    const int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    const int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int((tmp10 + tmp11) * (1 << kPass1Bits));
    p[4] = int((tmp10 - tmp11) * (1 << kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int n = kConstBits - kPass1Bits;
    p[2] = int(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[6] = int(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
    const int64_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    p[7] = int(descale(t4 + z1 + z3, n));
    p[5] = int(descale(t5 + z2 + z4, n));
    p[3] = int(descale(t6 + z2 + z3, n));
    p[1] = int(descale(t7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; ++c) {
    int* p = d + c;
    const int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    const int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    const int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    const int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = int(descale(tmp10 + tmp11, kPass1Bits));
    p[32] = int(descale(tmp10 - tmp11, kPass1Bits));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    constexpr int n = kConstBits + kPass1Bits;
    p[16] = int(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[48] = int(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    const int64_t t4 = tmp4 * FIX_0_298631336, t5 = tmp5 * FIX_2_053119869;
    const int64_t t6 = tmp6 * FIX_3_072711026, t7 = tmp7 * FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560 + z5;
    z4 = z4 * -FIX_0_390180644 + z5;
    p[56] = int(descale(t4 + z1 + z3, n));
    p[40] = int(descale(t5 + z2 + z4, n));
    p[24] = int(descale(t6 + z2 + z3, n));
    p[8] = int(descale(t7 + z1 + z4, n));
  }
}

// ------------------------------------------------- colour conversion
// libjpeg's 16-bit fixed point: FIX(x) rounds x * 2^16.
constexpr int kScaleBits = 16;
constexpr int64_t kOneHalf = int64_t(1) << (kScaleBits - 1);
constexpr int64_t fix(double x) {
  return static_cast<int64_t>(x * (1L << kScaleBits) + 0.5);
}

// YCbCr -> RGB (jdcolor.c): R = Y + Cr_r[Cr], B = Y + Cb_b[Cb],
// G = Y + ((Cb_g[Cb] + Cr_g[Cr]) >> 16), each clamped to 0..255.
struct YccToRgb {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccToRgb() {
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kOneHalf) >> kScaleBits);
      cb_b[i] = int((fix(1.77200) * x + kOneHalf) >> kScaleBits);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kOneHalf;
    }
  }
};
const YccToRgb kYcc;

// RGB -> YCbCr (jccolor.c): one table per term; the Cb and Cr offsets
// carry ONE_HALF - 1, so 255 never rounds up to 256.
struct RgbToYcc {
  int64_t r_y[256], g_y[256], b_y[256], r_cb[256], g_cb[256], b_cb[256],
      g_cr[256], b_cr[256];
  RgbToYcc() {
    const int64_t cbcr_offset = int64_t(128) << kScaleBits;
    for (int i = 0; i < 256; ++i) {
      r_y[i] = fix(0.29900) * i;
      g_y[i] = fix(0.58700) * i;
      b_y[i] = fix(0.11400) * i + kOneHalf;
      r_cb[i] = -fix(0.16874) * i;
      g_cb[i] = -fix(0.33126) * i;
      b_cb[i] = fix(0.50000) * i + cbcr_offset + kOneHalf - 1;  // = r_cr
      g_cr[i] = -fix(0.41869) * i;
      b_cr[i] = -fix(0.08131) * i;
    }
  }
};
const RgbToYcc kRgb;

// ------------------------------------------------------------- Huffman
struct HuffDecode {
  bool present = false;
  int maxcode[18];     // largest code of each length, -1 if none
  int valoffset[18];   // symbol index - code, for each length
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length (0: longer)
  uint8_t look_sym[512];
};

// Annex C: the canonical codes of bits[0..15] (codes of length 1..16).
// Returns the number of symbols; fails on a table that overflows.
int canonical_codes(const uint8_t* bits, uint16_t* code, uint8_t* size) {
  int p = 0;
  uint32_t c = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l - 1]; ++i) {
      if (p >= 256) fail("a Huffman table with more than 256 codes");
      size[p] = static_cast<uint8_t>(l);
      code[p++] = static_cast<uint16_t>(c++);
    }
    if (c > (1u << l)) fail("a Huffman table whose codes overflow");
    c <<= 1;
  }
  return p;
}

void build_decode(HuffDecode& h, const uint8_t* bits, const uint8_t* vals,
                  bool dc) {
  uint16_t code[256];
  uint8_t size[256];
  const int n = canonical_codes(bits, code, size);
  for (int i = 0; i < n; ++i) {
    if (dc && vals[i] > 15) fail("a DC Huffman table with a symbol > 15");
    h.vals[i] = vals[i];
  }
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l - 1]) {
      h.valoffset[l] = p - code[p];
      p += bits[l - 1];
      h.maxcode[l] = code[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.maxcode[17] = 0x7FFFFFFF;
  std::memset(h.look_len, 0, sizeof h.look_len);
  for (int i = 0; i < n; ++i) {
    if (size[i] > 9) continue;
    const int shift = 9 - size[i];
    for (int j = 0; j < (1 << shift); ++j) {
      h.look_len[(code[i] << shift) | j] = size[i];
      h.look_sym[(code[i] << shift) | j] = vals[i];
    }
  }
  h.present = true;
}

// Entropy-coded bits, MSB first. Stuffed 0xFF 0x00 reads as 0xFF (any
// fill 0xFFs before it included, as libjpeg reads them); at a marker the
// reader stops and supplies zero bits, as libjpeg does; the end of the
// file before a marker means the file was cut.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int n = 0;
  bool at_marker = false;

  void fill() {
    while (n <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (p >= end) fail("truncated: the file ends inside its scan data");
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) ++q;
          if (q >= end) fail("truncated: the file ends inside its scan data");
          if (*q == 0) {
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker's 0xFF
            p = q - 1;
            b = 0;
          }
        } else {
          ++p;
        }
      }
      buf = (buf << 8) | b;
      n += 8;
    }
  }
  int bits(int k) {  // k <= 16
    if (n < k) fill();
    n -= k;
    return static_cast<int>((buf >> n) & ((1u << k) - 1));
  }
  int decode(const HuffDecode& h) {
    if (n < 16) fill();
    const int look = static_cast<int>((buf >> (n - 9)) & 511);
    if (h.look_len[look]) {
      n -= h.look_len[look];
      return h.look_sym[look];
    }
    for (int l = 10; l <= 16; ++l) {
      const int c = static_cast<int>((buf >> (n - l)) & ((1u << l) - 1));
      if (c <= h.maxcode[l]) {
        n -= l;
        return h.vals[h.valoffset[l] + c];
      }
    }
    fail("corrupt scan data: a bad Huffman code");
  }
  void reset() {  // at a restart: drop the rest of the byte
    buf = 0;
    n = 0;
    at_marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------- decoder
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;    // block grid of the padded plane
  std::vector<uint8_t> plane;  // (bh * 8, bw * 8) samples
  int pred = 0;
  bool seen = false;     // decoded by some scan
};

struct Decoder {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  int width = 0, height = 0, precision = 0, sof = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool have_frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  int restart = 0;
  int16_t quant[4][64];
  bool quant_set[4] = {false, false, false, false};
  HuffDecode dc[4], ac[4];
  std::vector<Component> comps;

  Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

  int byte() {
    if (pos >= size) fail("truncated: the file ends inside its headers");
    return data[pos++];
  }
  int word() {
    const int hi = byte();
    return (hi << 8) | byte();
  }
  int next_marker() {  // skip to the next 0xFF xx, xx not 0 or 0xFF
    for (;;) {
      int b = byte();
      if (b != 0xFF) continue;
      do b = byte(); while (b == 0xFF);
      if (b != 0) return b;
    }
  }

  static std::string mode_name(int m) {  // with its article
    switch (m) {
      case 0xC2: return "a progressive";
      case 0xC3: return "a lossless";
      case 0xC5: case 0xC6: case 0xC7: return "a hierarchical (differential)";
      case 0xC9: return "an arithmetic-coded";
      case 0xCA: return "a progressive arithmetic-coded";
      case 0xCB: return "a lossless arithmetic-coded";
      default: return "a hierarchical arithmetic-coded";
    }
  }

  // The frame header of any SOFn: the size and components. What the
  // decoder cannot read is refused later (check_frame), so that probe
  // answers for every JPEG.
  void read_frame(int marker) {
    if (have_frame) fail("two frame headers");
    sof = marker;
    const int len = word();
    precision = byte();
    height = word();
    width = word();
    const int nc = byte();
    if (len != 8 + 3 * nc) fail("a bad SOF length");
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = byte();
      const int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad sampling factors or table index in SOF");
      comps.push_back(std::move(c));
    }
    for (auto& c : comps) {
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    have_frame = true;
  }

  void check_frame() const {
    if (!have_frame) fail("no frame header before the scan");
    if (sof != 0xC0 && sof != 0xC1)
      fail(mode_name(sof) + " JPEG (SOF" + std::to_string(sof - 0xC0) +
           "); only sequential Huffman files are read");
    if (precision != 8)
      fail("a " + std::to_string(precision) +
           "-bit JPEG; only 8-bit samples are read");
    if (height == 0) fail("a frame of height 0 (its height in a DNL)");
    if (width == 0) fail("a frame of width 0");
    const int nc = static_cast<int>(comps.size());
    if (nc == 4) fail("a CMYK or YCCK JPEG (4 components)");
    if (nc != 1 && nc != 3)
      fail("a JPEG of " + std::to_string(nc) + " components");
    if (nc == 3) {
      const Component& y = comps[0];
      const bool chroma11 = comps[1].h == 1 && comps[1].v == 1 &&
                            comps[2].h == 1 && comps[2].v == 1;
      if (!chroma11 || y.h > 2 || y.v > 2)
        fail("the sampling " + std::to_string(y.h) + "x" +
             std::to_string(y.v) + ", " + std::to_string(comps[1].h) + "x" +
             std::to_string(comps[1].v) + ", " + std::to_string(comps[2].h) +
             "x" + std::to_string(comps[2].v) +
             "; only luma 1x1, 2x1, 2x2 or 1x2 over chroma 1x1 is read");
    }
    if (!jfif && nc == 3) {
      if (adobe && adobe_transform == 0)
        fail("an RGB-coded JPEG (Adobe transform 0)");
      if (!adobe && comps[0].id == 'R' && comps[1].id == 'G' &&
          comps[2].id == 'B')
        fail("an RGB-coded JPEG (component ids R, G, B)");
    }
  }

  void read_dqt(int len) {
    const size_t stop = pos + len - 2;
    while (pos < stop) {
      const int pq = byte();
      const int t = pq & 15;
      if (t > 3 || (pq >> 4) > 1) fail("a bad DQT table");
      for (int k = 0; k < 64; ++k) {
        const int v = (pq >> 4) ? word() : byte();
        // libjpeg keeps islow multipliers in a 16-bit short
        quant[t][kNatural[k]] = static_cast<int16_t>(v);
      }
      quant_set[t] = true;
    }
    if (pos != stop) fail("a bad DQT length");
  }

  void read_dht(int len) {
    const size_t stop = pos + len - 2;
    while (pos < stop) {
      const int tc = byte();
      const int cls = tc >> 4, t = tc & 15;
      if (cls > 1 || t > 3) fail("a bad DHT table class or index");
      uint8_t bits[16], vals[256];
      int count = 0;
      for (int i = 0; i < 16; ++i) count += bits[i] = byte();
      if (count > 256) fail("a DHT table of more than 256 symbols");
      for (int i = 0; i < count; ++i) vals[i] = byte();
      build_decode(cls == 0 ? dc[t] : ac[t], bits, vals, cls == 0);
    }
    if (pos != stop) fail("a bad DHT length");
  }

  void read_app(int marker, int len) {
    const size_t start = pos;
    if (pos + len - 2 > size) fail("truncated: the file ends inside APP");
    const uint8_t* b = data + pos;
    if (marker == 0xE0 && len >= 16 && std::memcmp(b, "JFIF\0", 5) == 0)
      jfif = true;
    if (marker == 0xEE && len >= 14 && std::memcmp(b, "Adobe", 5) == 0) {
      adobe = true;
      adobe_transform = b[11];
    }
    pos = start + len - 2;
  }

  // Read the headers up to the first SOS (or the frame, when
  // `frame_only`). Returns the marker that stopped it.
  int read_headers(bool frame_only) {
    if (size < 2 || data[0] != 0xFF || data[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (read_segment(m, frame_only)) return m;
    }
  }

  // One marker segment; true when the caller should stop (SOS, EOI, or
  // SOF when `frame_only`).
  bool read_segment(int m, bool frame_only) {
    if (m == 0xD9 || m == 0xDA) return true;
    if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) return false;
    const int len = word();
    if (len < 2) fail("a marker segment of length < 2");
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      pos -= 2;
      read_frame(m);
      return frame_only;
    }
    if (m == 0xCC) fail("an arithmetic-coded JPEG (DAC)");
    if (m == 0xDC) fail("a frame height given by DNL");
    if (m == 0xDB) {
      read_dqt(len);
    } else if (m == 0xC4) {
      read_dht(len);
    } else if (m == 0xDD) {
      if (len != 4) fail("a bad DRI length");
      restart = word();
    } else if (m >= 0xE0 && m <= 0xEF) {
      read_app(m, len);
    } else {  // COM and anything else: skipped
      if (pos + len - 2 > size) fail("truncated: the file ends in a segment");
      pos += len - 2;
    }
    return false;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const HuffDecode& hd = dc[c.td];
    const HuffDecode& ha = ac[c.ta];
    if (br.n < 32) br.fill();
    int s = br.decode(hd);
    if (s) s = extend(br.bits(s), s);
    c.pred += s;
    blk[0] = static_cast<int16_t>(c.pred);
    for (int k = 1; k < 64; ++k) {
      if (br.n < 32) br.fill();
      const int rs = br.decode(ha);
      const int r = rs >> 4;
      const int sz = rs & 15;
      if (sz) {
        k += r;
        if (k > 63) fail("corrupt scan data: a coefficient past the 64th");
        blk[kNatural[k]] = static_cast<int16_t>(extend(br.bits(sz), sz));
      } else {
        if (r != 15) break;  // EOB
        k += 15;             // ZRL
      }
    }
  }

  void restart_marker(BitReader& br, int& expect) {
    br.reset();
    pos = static_cast<size_t>(br.p - data);
    const int m = next_marker();
    if (m != 0xD0 + expect)
      fail("corrupt scan data: marker 0x" + std::to_string(m) +
           " where RST" + std::to_string(expect) + " belongs");
    expect = (expect + 1) & 7;
    br.p = data + pos;
    for (auto& c : comps) c.pred = 0;
  }

  // One scan (after its SOS marker), decoded into the component planes;
  // `need[i]`: component i's samples are wanted (else only its entropy
  // data is read).
  void read_scan(const std::vector<bool>& need) {
    const int len = word();
    const int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns) fail("a bad SOS header");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      const int id = byte(), t = byte();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == id) found = &c;
      if (!found) fail("a scan names a component not in the frame");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].present ||
          !ac[found->ta].present)
        fail("a scan uses a Huffman table that was not defined");
      if (!quant_set[found->tq])
        fail("a component uses a quantisation table that was not defined");
      sc.push_back(found);
    }
    pos += 3;  // Ss, Se, Ah/Al: sequential scans code all 64 at once
    if (pos > size) fail("truncated: the file ends in SOS");
    for (auto* c : sc) c->pred = 0;

    int units_x, units_y;  // MCUs of the scan
    if (ns == 1) {
      Component& c = *sc[0];
      const int cw = (width * c.h + hmax - 1) / hmax;
      const int ch = (height * c.v + vmax - 1) / vmax;
      units_x = (cw + 7) / 8;
      units_y = (ch + 7) / 8;
    } else {
      units_x = mcux;
      units_y = mcuy;
      int blocks = 0;
      for (auto* c : sc) blocks += c->h * c->v;
      if (blocks > 10) fail("an MCU of more than 10 blocks");
    }
    BitReader br{data + pos, data + size};
    alignas(16) int16_t blk[64];
    int expect = 0, left = restart;
    for (int my = 0; my < units_y; ++my) {
      for (int mx = 0; mx < units_x; ++mx) {
        if (restart && left == 0) {
          restart_marker(br, expect);
          left = restart;
        }
        for (auto* c : sc) {
          const int bh = ns == 1 ? 1 : c->v, bwid = ns == 1 ? 1 : c->h;
          const bool idct = need[c - comps.data()];
          const size_t stride = static_cast<size_t>(c->bw) * 8;
          for (int by = 0; by < bh; ++by) {
            for (int bx = 0; bx < bwid; ++bx) {
              decode_block(br, *c, blk);
              if (!idct) continue;
              const int row = (my * bh + by) * 8, col = (mx * bwid + bx) * 8;
              idct_islow(blk, quant[c->tq],
                         c->plane.data() + row * stride + col,
                         static_cast<int>(stride));
            }
          }
        }
        if (restart) --left;
      }
    }
    for (auto* c : sc) c->seen = true;
    pos = static_cast<size_t>(br.p - data);
  }

  // Decode the whole file: the component planes (only component 0 when
  // `gray`).
  void decode(bool gray) {
    int m = read_headers(false);
    check_frame();
    std::vector<bool> need(comps.size(), !gray);
    need[0] = true;
    for (auto& c : comps) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign(static_cast<size_t>(c.bw) * 8 * c.bh * 8, 0);
    }
    for (;;) {
      if (m == 0xD9) break;
      read_scan(need);
      bool all = true;
      for (auto& c : comps) all = all && c.seen;
      if (all) break;  // a sequential file is whole once each component is
      do m = next_marker(); while (!read_segment(m, false));
    }
    for (auto& c : comps)
      if (!c.seen) fail("truncated: a component has no scan");
  }
};

// One chroma row upsampled to full width (jdsample.c) into `out`, which
// holds 2 * cw + 2 samples: the plane `c` of cw x ch real samples (row
// stride `stride`), the luma sampling (hs, vs) over chroma 1x1, the output
// row `y`. Fancy (triangle) filters, the nearer sample weighted 3/4; rows
// past the plane's edges repeat its first or last row (libjpeg's context
// rows). libjpeg takes its box filter for h2v1 and h2v2 planes of 1 or 2
// columns.
void upsample_row(const uint8_t* c, size_t stride, int cw, int ch, int hs,
                  int vs, int y, uint8_t* out, int* colsum) {
  const int i = vs == 2 ? y >> 1 : y;
  const uint8_t* near = c + i * stride;
  const bool above = (y & 1) == 0;
  const uint8_t* far = c + (above ? std::max(i - 1, 0)
                                  : std::min(i + 1, ch - 1)) * stride;
  if (hs == 1 && vs == 1) {
    std::memcpy(out, near, cw);
  } else if (hs == 1) {  // h1v2: biases 1 above, 2 below
    const int bias = above ? 1 : 2;
    for (int x = 0; x < cw; ++x) out[x] = (near[x] * 3 + far[x] + bias) >> 2;
  } else if (cw <= 2) {
    for (int x = 0; x < 2 * cw; ++x) out[x] = near[x >> 1];
  } else if (vs == 1) {  // h2v1: biases 1 left, 2 right
    out[0] = near[0];
    out[1] = (near[0] * 3 + near[1] + 2) >> 2;
    for (int j = 1; j < cw - 1; ++j) {
      const int v = near[j] * 3;
      out[2 * j] = (v + near[j - 1] + 1) >> 2;
      out[2 * j + 1] = (v + near[j + 1] + 2) >> 2;
    }
    out[2 * cw - 2] = (near[cw - 1] * 3 + near[cw - 2] + 1) >> 2;
    out[2 * cw - 1] = near[cw - 1];
  } else {  // h2v2: column sums 3 near + far, then across: biases 8, 7
    for (int j = 0; j < cw; ++j) colsum[j] = near[j] * 3 + far[j];
    out[0] = (colsum[0] * 4 + 8) >> 4;
    out[1] = (colsum[0] * 3 + colsum[1] + 7) >> 4;
    for (int j = 1; j < cw - 1; ++j) {
      out[2 * j] = (colsum[j] * 3 + colsum[j - 1] + 8) >> 4;
      out[2 * j + 1] = (colsum[j] * 3 + colsum[j + 1] + 7) >> 4;
    }
    out[2 * cw - 2] = (colsum[cw - 1] * 3 + colsum[cw - 2] + 8) >> 4;
    out[2 * cw - 1] = (colsum[cw - 1] * 4 + 7) >> 4;
  }
}

// Decode a JPEG held in memory to BGR (channels 3) or gray (channels 1)
// at its own size into `out` (h * w * channels).
void decode_memory(const uint8_t* data, size_t size, int channels,
                   std::vector<uint8_t>& out, int& h, int& w) {
  Decoder d(data, size);
  d.decode(channels == 1);
  h = d.height;
  w = d.width;
  out.resize(static_cast<size_t>(h) * w * channels);
  const Component& y = d.comps[0];
  const size_t ys = static_cast<size_t>(y.bw) * 8;
  if (channels == 1 || d.comps.size() == 1) {
    for (int r = 0; r < h; ++r) {
      const uint8_t* src = y.plane.data() + r * ys;
      uint8_t* dst = out.data() + static_cast<size_t>(r) * w * channels;
      if (channels == 1) {
        std::memcpy(dst, src, w);
      } else {
        for (int x = 0; x < w; ++x) dst[3 * x] = dst[3 * x + 1] =
            dst[3 * x + 2] = src[x];
      }
    }
    return;
  }
  const Component& cb = d.comps[1];
  const Component& cr = d.comps[2];
  const size_t cs = static_cast<size_t>(cb.bw) * 8;
  const int cw = (w + y.h - 1) / y.h, ch = (h + y.v - 1) / y.v;
  std::vector<uint8_t> ub(2 * cw + 2), ur(2 * cw + 2);
  std::vector<int> colsum(cw + 2);
  for (int r = 0; r < h; ++r) {
    upsample_row(cb.plane.data(), cs, cw, ch, y.h, y.v, r, ub.data(),
                 colsum.data());
    upsample_row(cr.plane.data(), cs, cw, ch, y.h, y.v, r, ur.data(),
                 colsum.data());
    const uint8_t* yr = y.plane.data() + r * ys;
    uint8_t* o = out.data() + static_cast<size_t>(r) * w * 3;
    for (int x = 0; x < w; ++x) {
      const int yy = yr[x], b = ub[x], c = ur[x];
      o[3 * x] = clamp255(yy + kYcc.cb_b[b]);
      o[3 * x + 1] = clamp255(
          yy + int((kYcc.cb_g[b] + kYcc.cr_g[c]) >> kScaleBits));
      o[3 * x + 2] = clamp255(yy + kYcc.cr_r[c]);
    }
  }
}

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  buf.clear();
  uint8_t chunk[1 << 16];
  size_t n;
  while ((n = fread(chunk, 1, sizeof chunk, f)) > 0)
    buf.insert(buf.end(), chunk, chunk + n);
  const bool ok = !ferror(f);
  fclose(f);
  return ok;
}

// ------------------------------------------------------------- encoder
struct HuffEncode {
  uint16_t code[256];
  uint8_t size[256];
};

HuffEncode build_encode(const uint8_t* bits, const uint8_t* vals) {
  HuffEncode e{};
  uint16_t code[256];
  uint8_t size[256];
  const int n = canonical_codes(bits, code, size);
  for (int i = 0; i < n; ++i) {
    e.code[vals[i]] = code[i];
    e.size[vals[i]] = size[i];
  }
  return e;
}

const HuffEncode kDcLuma = build_encode(kDcLumaBits, kDcVals);
const HuffEncode kDcChroma = build_encode(kDcChromaBits, kDcVals);
const HuffEncode kAcLuma = build_encode(kAcLumaBits, kAcLumaVals);
const HuffEncode kAcChroma = build_encode(kAcChromaBits, kAcChromaVals);

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int n = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int k) {
    buf = (buf << k) | (bits & ((1u << k) - 1));
    n += k;
    while (n >= 8) {
      n -= 8;
      const uint8_t b = static_cast<uint8_t>(buf >> n);
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);  // byte stuffing
    }
  }
  void flush() {  // pad the last byte with 1-bits
    if (n) put(0x7F, 8 - n);
  }
};

// libjpeg's quality scaling (jcparam.c), baseline: 1..255.
void scaled_quant(const uint8_t* base, int quality, uint16_t* q) {
  quality = std::clamp(quality, 1, 100);
  const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    const long v = (static_cast<long>(base[i]) * scale + 50) / 100;
    q[i] = static_cast<uint16_t>(std::clamp(v, 1L, 255L));
  }
}

// libjpeg-turbo's quantisation by reciprocal (jcdctmgr.c, 16-bit
// DCTELEM): for divisor d = 8q, |x| becomes ((|x| + c) * r) >> s.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 31;
  while (!(divisor >> b)) --b;  // floor(log2(divisor))
  int r = 16 + b;
  uint32_t fq = static_cast<uint32_t>((uint64_t(1) << r) / divisor);
  const uint32_t fr = static_cast<uint32_t>((uint64_t(1) << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {  // a power of two
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

struct Encoder {
  int h, w, c;
  uint16_t q[2][64];
  Divisor div[2][64];
  std::vector<uint8_t> out;

  void marker_segment(int m, const std::vector<uint8_t>& body) {
    out.push_back(0xFF);
    out.push_back(static_cast<uint8_t>(m));
    const size_t len = body.size() + 2;
    out.push_back(static_cast<uint8_t>(len >> 8));
    out.push_back(static_cast<uint8_t>(len & 0xFF));
    out.insert(out.end(), body.begin(), body.end());
  }
  void dht(int cls_id, const uint8_t* bits, const uint8_t* vals) {
    std::vector<uint8_t> b{static_cast<uint8_t>(cls_id)};
    int count = 0;
    for (int i = 0; i < 16; ++i) {
      b.push_back(bits[i]);
      count += bits[i];
    }
    b.insert(b.end(), vals, vals + count);
    marker_segment(0xC4, b);
  }

  void headers() {
    out = {0xFF, 0xD8};
    // JFIF 1.01, no units, 1:1 density, no thumbnail
    marker_segment(0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    const int ntab = c == 3 ? 2 : 1;
    for (int t = 0; t < ntab; ++t) {
      std::vector<uint8_t> b{static_cast<uint8_t>(t)};
      for (int k = 0; k < 64; ++k) b.push_back(
          static_cast<uint8_t>(q[t][kNatural[k]]));
      marker_segment(0xDB, b);
    }
    std::vector<uint8_t> sof{8, static_cast<uint8_t>(h >> 8),
                             static_cast<uint8_t>(h & 0xFF),
                             static_cast<uint8_t>(w >> 8),
                             static_cast<uint8_t>(w & 0xFF),
                             static_cast<uint8_t>(c)};
    if (c == 3) {
      sof.insert(sof.end(), {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
    } else {
      sof.insert(sof.end(), {1, 0x11, 0});
    }
    marker_segment(0xC0, sof);
    dht(0x00, kDcLumaBits, kDcVals);
    dht(0x10, kAcLumaBits, kAcLumaVals);
    if (c == 3) {
      dht(0x01, kDcChromaBits, kDcVals);
      dht(0x11, kAcChromaBits, kAcChromaVals);
      marker_segment(0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});
    } else {
      marker_segment(0xDA, {1, 1, 0x00, 0, 63, 0});
    }
  }

  // FDCT and quantise the 8x8 samples at `p` (stride `stride`) with
  // table `t` into zigzag-free natural order `coef`.
  void transform(const uint8_t* p, size_t stride, int t, int* coef) const {
    int d[64];
    for (int r = 0; r < 8; ++r)
      for (int x = 0; x < 8; ++x) d[8 * r + x] = p[r * stride + x] - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {
      const Divisor& dv = div[t][i];
      const int x = d[i];
      const uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
      const int v = static_cast<int>(
          (static_cast<uint64_t>((a + dv.corr) & 0xFFFFFFFF) * dv.recip) >>
          dv.shift);
      coef[i] = x < 0 ? -v : v;
    }
  }

  static void code_block(BitWriter& bw, const int* coef, int& pred,
                         const HuffEncode& dc, const HuffEncode& ac) {
    int diff = coef[0] - pred;
    pred = coef[0];
    int mag = diff < 0 ? -diff : diff;
    int nbits = 0;
    while (mag >> nbits) ++nbits;
    bw.put(dc.code[nbits], dc.size[nbits]);
    if (nbits) bw.put(diff < 0 ? diff - 1 : diff, nbits);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      const int v = coef[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac.code[0xF0], ac.size[0xF0]);
        run -= 16;
      }
      mag = v < 0 ? -v : v;
      nbits = 0;
      while (mag >> nbits) ++nbits;
      const int rs = (run << 4) | nbits;
      bw.put(ac.code[rs], ac.size[rs]);
      bw.put(v < 0 ? v - 1 : v, nbits);
      run = 0;
    }
    if (run) bw.put(ac.code[0], ac.size[0]);
  }

  void encode(const uint8_t* img, int quality) {
    scaled_quant(kLumaQuant, quality, q[0]);
    scaled_quant(kChromaQuant, quality, q[1]);
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < 64; ++i) div[t][i] = reciprocal(q[t][i] * 8u);
    headers();
    BitWriter bw(out);
    int coef[64];
    if (c == 1) {
      // one component, MCU = one block; edges replicated to the block
      const int bw8 = (w + 7) / 8, bh8 = (h + 7) / 8;
      const size_t stride = static_cast<size_t>(bw8) * 8;
      std::vector<uint8_t> plane(stride * bh8 * 8);
      for (int r = 0; r < bh8 * 8; ++r) {
        const uint8_t* src = img + static_cast<size_t>(std::min(r, h - 1)) * w;
        uint8_t* dst = plane.data() + r * stride;
        for (int x = 0; x < bw8 * 8; ++x) dst[x] = src[std::min(x, w - 1)];
      }
      int pred = 0;
      for (int by = 0; by < bh8; ++by)
        for (int bx = 0; bx < bw8; ++bx) {
          transform(plane.data() + by * 8 * stride + bx * 8, stride, 0, coef);
          code_block(bw, coef, pred, kDcLuma, kAcLuma);
        }
    } else {
      encode_420(img, bw, coef);
    }
    bw.flush();
    out.push_back(0xFF);
    out.push_back(0xD9);
  }

  // 4:2:0 YCbCr from BGR. Luma: the image, edges replicated, in blocks of
  // 8; MCU blocks past the luma blocks are libjpeg's dummy blocks (AC 0,
  // DC of the block before). Chroma: 2x2 means with biases 1, 2, 1, 2, ...
  // along the row, over the image with its right edge replicated to the
  // MCU and its last row repeated to an even count; the rows past
  // ceil(h/2) repeat the last.
  void encode_420(const uint8_t* img, BitWriter& bw, int* coef) {
    const int mx_n = (w + 15) / 16, my_n = (h + 15) / 16;
    const int lbw = (w + 7) / 8, lbh = (h + 7) / 8;  // real luma blocks
    const size_t ls = static_cast<size_t>(lbw) * 8;
    const size_t cs = static_cast<size_t>(mx_n) * 8;
    const int full_w = mx_n * 16;
    std::vector<uint8_t> yp(ls * lbh * 8), cbp(cs * my_n * 8),
        crp(cs * my_n * 8);
    std::vector<uint8_t> ycc(static_cast<size_t>(full_w) * 3 * 2);
    const int ch = (h + 1) / 2;
    for (int i = 0; i < my_n * 8; ++i) {
      if (i >= ch) {  // repeat the last chroma row
        std::memcpy(&cbp[i * cs], &cbp[(ch - 1) * cs], cs);
        std::memcpy(&crp[i * cs], &crp[(ch - 1) * cs], cs);
        continue;
      }
      for (int k = 0; k < 2; ++k) {  // the two source rows, converted
        const int r = std::min(2 * i + k, h - 1);
        const uint8_t* src = img + static_cast<size_t>(r) * w * 3;
        uint8_t* o = &ycc[k * full_w * 3];
        for (int x = 0; x < full_w; ++x) {
          const uint8_t* px = src + 3 * std::min(x, w - 1);
          const int b = px[0], g = px[1], rr = px[2];
          o[3 * x] = static_cast<uint8_t>(
              (kRgb.r_y[rr] + kRgb.g_y[g] + kRgb.b_y[b]) >> kScaleBits);
          o[3 * x + 1] = static_cast<uint8_t>(
              (kRgb.r_cb[rr] + kRgb.g_cb[g] + kRgb.b_cb[b]) >> kScaleBits);
          o[3 * x + 2] = static_cast<uint8_t>(
              (kRgb.b_cb[rr] + kRgb.g_cr[g] + kRgb.b_cr[b]) >> kScaleBits);
        }
        const int yr = 2 * i + k;
        if (yr < lbh * 8)
          for (int x = 0; x < lbw * 8; ++x) yp[yr * ls + x] = o[3 * x];
      }
      const uint8_t* r0 = &ycc[0];
      const uint8_t* r1 = &ycc[full_w * 3];
      for (int j = 0; j < mx_n * 8; ++j) {
        const int bias = (j & 1) ? 2 : 1;
        for (int p = 1; p <= 2; ++p) {
          const int s = r0[6 * j + p] + r0[6 * j + 3 + p] + r1[6 * j + p] +
                        r1[6 * j + 3 + p];
          (p == 1 ? cbp : crp)[i * cs + j] =
              static_cast<uint8_t>((s + bias) >> 2);
        }
      }
    }
    // luma rows past the image (the bottom of its last real block row)
    for (int r = h; r < lbh * 8; ++r)
      std::memcpy(&yp[r * ls], &yp[(h - 1) * ls], ls);
    int py = 0, pcb = 0, pcr = 0;
    int ycoef[4][64];
    for (int my = 0; my < my_n; ++my) {
      for (int mx = 0; mx < mx_n; ++mx) {
        for (int k = 0; k < 4; ++k) {
          const int by = 2 * my + (k >> 1), bx = 2 * mx + (k & 1);
          int* cf = ycoef[k];
          if (by < lbh && bx < lbw) {
            transform(&yp[by * 8 * ls + bx * 8], ls, 0, cf);
          } else {
            std::memset(cf, 0, sizeof ycoef[k]);
            // right of the image: the DC of the block to the left; below
            // it: the DC of the MCU's block just before
            cf[0] = ycoef[by < lbh ? k - 1 : 1][0];
          }
          code_block(bw, cf, py, kDcLuma, kAcLuma);
        }
        transform(&cbp[my * 8 * cs + mx * 8], cs, 1, coef);
        code_block(bw, coef, pcb, kDcChroma, kAcChroma);
        transform(&crp[my * 8 * cs + mx * 8], cs, 1, coef);
        code_block(bw, coef, pcr, kDcChroma, kAcChroma);
      }
    }
  }
};

// ------------------------------------------------------------ the API
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
    if (y0 < 0) y0 = 0;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    const int y1 = std::min(y0 + 1, sh - 1);
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      if (x0 > sw - 2) x0 = sw - 2;
      if (x0 < 0) x0 = 0;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      const int x1 = std::min(x0 + 1, sw - 1);
      const uint8_t* p00 = src + (y0 * sw + x0) * 3;
      const uint8_t* p01 = src + (y0 * sw + x1) * 3;
      const uint8_t* p10 = src + (y1 * sw + x0) * 3;
      const uint8_t* p11 = src + (y1 * sw + x1) * 3;
      uint8_t* out = dst + (y * dw + x) * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + wx * (p01[c] - p00[c]);
        float bot = p10[c] + wx * (p11[c] - p10[c]);
        out[c] = static_cast<uint8_t>(top + wy * (bot - top) + 0.5f);
      }
    }
  }
}

// Decode one file into `out` (target_h x target_w x channels; gray only
// at the file's own size). Returns "" or what went wrong.
std::string decode_one(const char* path, int target_h, int target_w,
                       int channels, uint8_t* out) {
  std::vector<uint8_t> file, img;
  if (!read_file(path, file)) return "cannot be read";
  int h = 0, w = 0;
  try {
    decode_memory(file.data(), file.size(), channels, img, h, w);
  } catch (const JpegError& e) {
    return e.what();
  } catch (const std::bad_alloc&) {
    return "out of memory";
  }
  if (h == target_h && w == target_w) {
    std::memcpy(out, img.data(), img.size());
  } else if (channels == 1) {
    return "is " + std::to_string(h) + "x" + std::to_string(w) +
           ", not " + std::to_string(target_h) + "x" +
           std::to_string(target_w);
  } else {
    resize_bilinear(img.data(), h, w, out, target_h, target_w);
  }
  return "";
}

template <typename Fn>
void parallel_for(int n, int threads, Fn fn) {
  if (threads < 1) threads = 1;
  threads = std::min(threads, std::max(n, 1));
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

// The first failure of a batch: the lowest failed index and its reason,
// copied to the caller's buffer when the batch ends.
struct FirstFailure {
  std::mutex mu;
  int index = -1;
  std::string why;
  void note(int i, const std::string& what) {
    std::lock_guard<std::mutex> lock(mu);
    if (index < 0 || i < index) {
      index = i;
      why = what;
    }
  }
  void report(int* first, char* msg, int cap) const {
    *first = index;
    if (cap > 0) std::snprintf(msg, cap, "%s", why.c_str());
  }
};

// Decode n files of one kind (channels 3: resized to target; 1: the
// target's size) into out, zero-filling failed slots.
int decode_batch(const char** paths, int n, int target_h, int target_w,
                 int channels, uint8_t* out, int threads, int* first,
                 char* msg, int cap) {
  std::atomic<int> failures(0);
  FirstFailure ff;
  const size_t stride = static_cast<size_t>(target_h) * target_w * channels;
  parallel_for(n, threads, [&](int i) {
    const std::string err =
        decode_one(paths[i], target_h, target_w, channels, out + i * stride);
    if (!err.empty()) {
      std::memset(out + i * stride, 0, stride);
      failures.fetch_add(1);
      ff.note(i, err);
    }
  });
  ff.report(first, msg, cap);
  return failures.load();
}

}  // namespace

extern "C" {

// Decode n JPEGs into out (n, target_h, target_w, 3) BGR u8 (resized when
// a file has another size). Returns the number of failures; failed slots
// are zero-filled, and the lowest failed index (-1 if none) and its
// reason go to *first and msg (cap bytes).
int vu_decode_batch(const char** paths, int n, int target_h, int target_w,
                    uint8_t* out, int threads, int* first, char* msg,
                    int cap) {
  return decode_batch(paths, n, target_h, target_w, 3, out, threads, first,
                      msg, cap);
}

// Decode n JPEGs of h x w into out (n, h, w) gray u8: the luma plane of a
// colour file, as cv2.imread(..., IMREAD_GRAYSCALE) gives it. Returns the
// number of failures (a file of another size fails), reported as
// vu_decode_batch reports them.
int vu_decode_gray_batch(const char** paths, int n, int h, int w,
                         uint8_t* out, int threads, int* first, char* msg,
                         int cap) {
  return decode_batch(paths, n, h, w, 1, out, threads, first, msg, cap);
}

// Encode n u8 images (n, h, w, c), c = 3 (BGR, as 4:2:0 YCbCr) or 1
// (gray), at `quality` to paths. Returns the failure count.
int vu_encode_batch(const char** paths, const uint8_t* imgs, int n, int h,
                    int w, int c, int quality, int threads) {
  std::atomic<int> failures(0);
  const size_t stride = static_cast<size_t>(h) * w * c;
  parallel_for(n, threads, [&](int i) {
    Encoder e{h, w, c, {}, {}, {}};
    bool ok = false;
    try {
      e.encode(imgs + i * stride, quality);
      FILE* f = fopen(paths[i], "wb");
      if (f) {
        ok = fwrite(e.out.data(), 1, e.out.size(), f) == e.out.size();
        ok = (fclose(f) == 0) && ok;
      }
    } catch (const std::bad_alloc&) {
      ok = false;
    }
    if (!ok) failures.fetch_add(1);
  });
  return failures.load();
}

// Encode one u8 image (h, w, c) to memory: writes at most cap bytes to
// out and returns the JPEG's size (larger than cap: nothing was written;
// call again with room), or -1 on failure.
long vu_encode_memory(const uint8_t* img, int h, int w, int c, int quality,
                      uint8_t* out, long cap) {
  try {
    Encoder e{h, w, c, {}, {}, {}};
    e.encode(img, quality);
    const long n = static_cast<long>(e.out.size());
    if (n <= cap) std::memcpy(out, e.out.data(), e.out.size());
    return n;
  } catch (const std::bad_alloc&) {
    return -1;
  }
}

// The size of a JPEG file from its frame header, without decoding it.
// Returns 0 on success, else 1 with the reason in msg (cap bytes).
int vu_probe(const char* path, int* h, int* w, char* msg, int cap) {
  std::vector<uint8_t> file;
  std::string err;
  if (!read_file(path, file)) {
    err = "cannot be read";
  } else {
    try {
      Decoder d(file.data(), file.size());
      d.read_headers(true);
      if (!d.have_frame) fail("has no frame header");
      *h = d.height;
      *w = d.width;
    } catch (const JpegError& e) {
      err = e.what();
    }
  }
  if (err.empty()) return 0;
  if (cap > 0) std::snprintf(msg, cap, "%s", err.c_str());
  return 1;
}

}  // extern "C"
