// Iterated grayscale morphology (K2) and the fused trimap (K1) for Hopper.
//
// Replaces the Pallas TPU kernels `video_unscreen_tpu/ops/pallas/morph.py`:
//   K2 `_morph_kernel` (entry `pallas_dilate`): `iters` dilations (or
//      erosions) of one (H, W) f32 mask by a small structuring element;
//   K1 `_trimap_kernel` (entry `pallas_trimap`): the dilate chain and the
//      erode chain of the same mask, then 255 where erode > 127, 0 where
//      dilate < 128, else 128.
// Semantics are those of `ops/morphology.py:_morph`: out[y, x] = max (or
// min) of in[y + dy, x + dx] over the anchor and the SE offsets, where a
// neighbour outside the image counts as -inf (dilate) or +inf (erode).
//
// What bounds it: memory. Per output pixel the work is iters * |SE|
// compares (5-point cross, 5 iterations: 25), far below the card's compare
// rate, so the least time is one read of the mask and one write of the
// result (544x960 f32: 4.2 MB, about 1.25 us at 3.35 TB/s). The TPU kernel
// kept the whole mask in VMEM; here no block holds a whole frame, so each
// block loads a TILE x TILE output tile plus a halo of iters * r cells into
// shared memory once, runs every iteration there in ping-pong buffers, and
// writes its tile once. Each iteration shrinks the region still valid by r,
// so the halo is recomputed by neighbouring blocks (redundant compute,
// no extra device-memory traffic). Chains longer than HALO_MAX / r
// iterations run as several launches: max and min compose exactly, so the
// split is bit-exact. The trimap runs both chains from one load and writes
// only the selected value: one read, one write.
//
// Border trap: cells of the halo that lie outside the image are never read
// as values. Every neighbour read checks the image bounds and substitutes
// the fill, on every iteration, so the border neither grows nor erodes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TILE = 32;       // output tile edge
constexpr int HALO_MAX = 16;   // most halo cells one launch carries
constexpr int MAX_OFFS = 48;   // SE cells besides the anchor (k <= 7)
constexpr int THREADS = 256;
constexpr int PER_THREAD = TILE * TILE / THREADS;

struct Offsets {
  int n;  // number of offsets, anchor excluded
  int r;  // largest |dy| or |dx|
  signed char dy[MAX_OFFS];
  signed char dx[MAX_OFFS];
};

// Copy the (S x S) window whose top-left image cell is (gy0, gx0) into
// shared memory. Cells outside the image are zero; they are never read as
// values (see step()).
__device__ void load_window(const float* __restrict__ in, float* buf, int S,
                            int gy0, int gx0, int H, int W) {
  for (int i = threadIdx.x; i < S * S; i += blockDim.x) {
    int y = gy0 + i / S, x = gx0 + i % S;
    buf[i] = (y >= 0 && y < H && x >= 0 && x < W) ? in[y * W + x] : 0.f;
  }
}

// One iteration over the square [lo, hi) of window cells.
template <bool DILATE>
__device__ void step(const float* src, float* dst, int S, int lo, int hi,
                     int gy0, int gx0, int H, int W, const Offsets& o) {
  const float fill = DILATE ? -CUDART_INF_F : CUDART_INF_F;
  const int span = hi - lo;
  for (int i = threadIdx.x; i < span * span; i += blockDim.x) {
    const int sy = lo + i / span, sx = lo + i % span;
    const int y = gy0 + sy, x = gx0 + sx;
    float acc = src[sy * S + sx];
    for (int k = 0; k < o.n; ++k) {
      const int ny = y + o.dy[k], nx = x + o.dx[k];
      const float v = (ny >= 0 && ny < H && nx >= 0 && nx < W)
                          ? src[(sy + o.dy[k]) * S + sx + o.dx[k]]
                          : fill;
      acc = DILATE ? fmaxf(acc, v) : fminf(acc, v);
    }
    dst[sy * S + sx] = acc;
  }
}

// Run `iters` iterations starting from `src` (a window buffer); returns the
// buffer that holds the result. `a` and `b` are the ping-pong buffers.
template <bool DILATE>
__device__ const float* chain(const float* src, float* a, float* b, int S,
                              int iters, int gy0, int gx0, int H, int W,
                              const Offsets& o) {
  float* dst = a;
  for (int t = 1; t <= iters; ++t) {
    step<DILATE>(src, dst, S, t * o.r, S - t * o.r, gy0, gx0, H, W, o);
    __syncthreads();
    src = dst;
    dst = (dst == a) ? b : a;
  }
  return src;
}

template <bool DILATE>
__global__ void morph_kernel(const float* __restrict__ in,
                             float* __restrict__ out, int H, int W, int iters,
                             Offsets o) {
  extern __shared__ float smem[];
  const int R = iters * o.r, S = TILE + 2 * R;
  float* w0 = smem;
  float* w1 = smem + S * S;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int gy0 = y0 - R, gx0 = x0 - R;
  load_window(in, w0, S, gy0, gx0, H, W);
  __syncthreads();
  // the loaded window is not needed again: it is the second ping-pong buffer
  const float* res = chain<DILATE>(w0, w1, w0, S, iters, gy0, gx0, H, W, o);
  for (int i = threadIdx.x; i < TILE * TILE; i += blockDim.x) {
    const int ty = i / TILE, tx = i % TILE, y = y0 + ty, x = x0 + tx;
    if (y < H && x < W) out[y * W + x] = res[(R + ty) * S + R + tx];
  }
}

// dsrc feeds the dilate chain and esrc the erode chain; they are the same
// mask unless the host split a long chain across launches.
__global__ void trimap_kernel(const float* __restrict__ dsrc,
                              const float* __restrict__ esrc,
                              float* __restrict__ out, int H, int W,
                              int iters, Offsets o) {
  extern __shared__ float smem[];
  const int R = iters * o.r, S = TILE + 2 * R;
  float* w0 = smem;
  float* w1 = smem + S * S;
  float* w2 = smem + 2 * S * S;
  const int y0 = blockIdx.y * TILE, x0 = blockIdx.x * TILE;
  const int gy0 = y0 - R, gx0 = x0 - R;

  load_window(dsrc, w0, S, gy0, gx0, H, W);
  __syncthreads();
  const float* res = chain<true>(w0, w1, w2, S, iters, gy0, gx0, H, W, o);
  float dil[PER_THREAD];
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    dil[k] = res[(R + i / TILE) * S + R + i % TILE];
  }
  __syncthreads();  // the erode chain reuses the ping-pong buffers
  if (esrc != dsrc) {
    load_window(esrc, w0, S, gy0, gx0, H, W);
    __syncthreads();
  }
  res = chain<false>(w0, w1, w2, S, iters, gy0, gx0, H, W, o);
  for (int k = 0; k < PER_THREAD; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int ty = i / TILE, tx = i % TILE, y = y0 + ty, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const float ero = res[(R + ty) * S + R + tx];
    float tri = ero > 127.f ? 255.f : 128.f;
    out[y * W + x] = dil[k] < 128.f ? 0.f : tri;
  }
}

// SE offsets from the host's (dy, dx) pairs; the anchor is dropped. Returns
// false when the element is larger than the kernel takes.
bool make_offsets(const int* offs, int n_offs, Offsets* o) {
  o->n = 0;
  o->r = 0;
  for (int i = 0; i < n_offs; ++i) {
    const int dy = offs[2 * i], dx = offs[2 * i + 1];
    if (dy == 0 && dx == 0) continue;
    if (o->n == MAX_OFFS || dy < -HALO_MAX || dy > HALO_MAX ||
        dx < -HALO_MAX || dx > HALO_MAX)
      return false;
    o->dy[o->n] = static_cast<signed char>(dy);
    o->dx[o->n] = static_cast<signed char>(dx);
    ++o->n;
    const int a = dy < 0 ? -dy : dy, b = dx < 0 ? -dx : dx;
    if (a > o->r) o->r = a;
    if (b > o->r) o->r = b;
  }
  return o->r <= HALO_MAX;
}

int per_launch(const Offsets& o) { return o.r ? HALO_MAX / o.r : 1 << 30; }

dim3 grid_for(int H, int W) {
  return dim3((W + TILE - 1) / TILE, (H + TILE - 1) / TILE);
}

// Shared memory for `buffers` windows of a launch running `iters` iterations.
size_t smem_bytes(const Offsets& o, int iters, int buffers) {
  const size_t S = TILE + 2 * static_cast<size_t>(iters) * o.r;
  return buffers * S * S * sizeof(float);
}

// `iters` iterations from in to out as ceil(iters / per_launch) launches,
// ping-ponging through tmp so that the last one writes out. Adds the
// number of launches to *launches.
cudaError_t morph_chain(const float* in, float* out, float* tmp, int H,
                        int W, const Offsets& o, int iters, bool dilate,
                        cudaStream_t stream, int* launches) {
  const int step_iters = per_launch(o);
  const int n_launch = iters <= step_iters ? 1
                                           : (iters + step_iters - 1) / step_iters;
  if (n_launch > 1 && tmp == nullptr) return cudaErrorInvalidValue;
  const float* src = in;
  int left = iters;
  for (int j = 0; j < n_launch; ++j) {
    const int n = left < step_iters ? left : step_iters;
    float* dst = ((n_launch - 1 - j) % 2 == 0) ? out : tmp;
    if (dilate)
      morph_kernel<true><<<grid_for(H, W), THREADS, smem_bytes(o, n, 2), stream>>>(
          src, dst, H, W, n, o);
    else
      morph_kernel<false><<<grid_for(H, W), THREADS, smem_bytes(o, n, 2), stream>>>(
          src, dst, H, W, n, o);
    src = dst;
    left -= n;
  }
  *launches += n_launch;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Every entry sets *launches (a host int) to the number of kernels it
// launched on `stream`.

// K2: out = dilate (or erode) of in, `iters` times. tmp is an (H, W)
// scratch buffer, used when the chain takes more than one launch. offs
// holds n_offs (dy, dx) pairs.
int vut_morph(const float* in, float* out, float* tmp, int H, int W,
              const int* offs, int n_offs, int iters, int dilate,
              void* stream, int* launches) {
  *launches = 0;
  Offsets o;
  if (H <= 0 || W <= 0 || iters < 0 || !make_offsets(offs, n_offs, &o))
    return cudaErrorInvalidValue;
  return morph_chain(in, out, tmp, H, W, o, iters, dilate != 0,
                     static_cast<cudaStream_t>(stream), launches);
}

// K1: the {0, 128, 255} trimap of in. tmp_d and tmp_e are (H, W) scratch
// buffers, used when iters * r > HALO_MAX: the chains then start as K2
// launches and the last HALO_MAX / r iterations run fused with the select.
int vut_trimap(const float* in, float* out, float* tmp_d, float* tmp_e,
               int H, int W, const int* offs, int n_offs, int iters,
               void* stream, int* launches) {
  *launches = 0;
  Offsets o;
  if (H <= 0 || W <= 0 || iters < 0 || !make_offsets(offs, n_offs, &o))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int last = iters < per_launch(o) ? iters : per_launch(o);
  const float* dsrc = in;
  const float* esrc = in;
  if (iters > last) {
    if (tmp_d == nullptr || tmp_e == nullptr) return cudaErrorInvalidValue;
    // out is free until the final launch: it serves as the chains' scratch
    cudaError_t err =
        morph_chain(in, tmp_d, out, H, W, o, iters - last, true, s, launches);
    if (err != cudaSuccess) return err;
    err = morph_chain(in, tmp_e, out, H, W, o, iters - last, false, s,
                      launches);
    if (err != cudaSuccess) return err;
    dsrc = tmp_d;
    esrc = tmp_e;
  }
  trimap_kernel<<<grid_for(H, W), THREADS, smem_bytes(o, last, 3), s>>>(
      dsrc, esrc, out, H, W, last, o);
  *launches += 1;
  return cudaGetLastError();
}

const char* vut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
