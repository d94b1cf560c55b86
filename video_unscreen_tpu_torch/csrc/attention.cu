// Masked memory attention, the STM memory read (K4), for Hopper.
//
// Replaces the Pallas TPU kernel `video_unscreen_tpu/ops/pallas/
// attention.py:_attn_kernel` (entries `masked_memory_attention`,
// `_fwd_call`): out = softmax(q k^T / sqrt(dk), keys masked by kv_mask) v,
// by the online max/sum recurrence, and the log-sum-exp per query.
// Semantics kept exactly:
//   - a masked score is -1e30 (not -inf), so exp(s - m) is never NaN;
//   - m_new = max(m, rowmax(s)); p = exp(s - m_new); a = exp(m - m_new);
//     l = l * a + rowsum(p); acc = acc * a + p v; m = m_new;
//   - at the end a query whose m is still below -0.5e30 saw no valid key:
//     its output and its LSE are 0; otherwise out = acc / max(l, 1e-30)
//     and lse = m + log(max(l, 1e-30));
//   - scale = 1 / sqrtf(dk) in f32; expf/logf, no fast-math intrinsics.
// A key past Lk is treated as a masked key with a zero value row, as the
// TPU kernel's padding makes it; no load reads past an array's end.
//
// What bounds it: operations. Per query and key it does dk + dv
// multiply-adds (2 * Lq * Lk * (dk + dv) flops); at the bg path's shape
// (Lq 2040, Lk 22440, dk 128, dv 512) that is 58.6 GFLOP against 63 MB of
// inputs and outputs, far above the card's f32 balance point (67 TFLOP/s
// over 3.35 TB/s = 20 flop/byte).
//
// Design: a grid of (64-query tiles) x (128-column chunks of dv). The wide
// value (dv = 512) is the trouble spot: a (64, 512) f32 accumulator fits
// neither one thread block's registers nor leaves shared memory for the
// tiles. Each block owns a (64, 128) slice of the output: its 256 threads
// keep a 4 x 8 register tile of the accumulator each. It streams 64-key
// tiles of K, its V chunk and the mask through shared memory, and keeps
// its own running max and sum. The q k^T tile (20% of the flops) is
// recomputed by the dv / 128 blocks of a query tile, about 60% more work
// in all, for a grid of 128 blocks at the bg shape (one wave on 132 SMs)
// and no cross-block reduction. The 16 threads that share a row group
// compute that group's scores and hold its m and l in registers, so the
// row max and sum are 16-lane shuffles and the rescale needs no shared
// memory. Plain SIMT f32 FMAs; tensor cores (wgmma), TMA staging and
// skipping fully masked key tiles (exact: such a tile leaves m, l and acc
// as they are once a valid key has been seen) are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int DK_MAX = 128;     // widest key a block stages
constexpr int DVC = 128;        // value columns per block
constexpr int THREADS = 256;
constexpr int LDQ = DK_MAX + 4; // row pitch (floats) of the Q and K tiles
constexpr int LDV = DVC + 4;    // row pitch of the V tile
constexpr int LDP = BK + 4;     // row pitch of the probability tile
constexpr float NEG = -1e30f;

constexpr size_t SMEM_FLOATS =
    BQ * LDQ + BK * LDQ + BK * LDV + BQ * LDP + BK;
constexpr size_t SMEM_BYTES = SMEM_FLOATS * sizeof(float);

// Stage rows [row0, row0 + rows) x columns [col0, col0 + width) of a
// row-major (n_rows, ld) array into a (rows, pitch) shared tile, zero
// outside the array. width and col0 are multiples of 4 (float4 loads).
__device__ void stage(const float* __restrict__ src, float* dst, int rows,
                      int width, int pitch, int row0, int col0, int n_rows,
                      int n_cols, int ld) {
  const int vec_per_row = width / 4;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = (i % vec_per_row) * 4;
    const int gr = row0 + r, gc = col0 + c;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < n_rows && gc < n_cols)
      val = *reinterpret_cast<const float4*>(src + (size_t)gr * ld + gc);
    *reinterpret_cast<float4*>(dst + r * pitch + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                float* __restrict__ out, float* __restrict__ lse, int Lq,
                int Lk, int dk, int dv, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                 // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;        // [BK][LDQ]
  float* Vs = Ks + BK * LDQ;        // [BK][LDV]
  float* Ps = Vs + BK * LDV;        // [BQ][LDP]
  float* Ms = Ps + BQ * LDP;        // [BK]

  const int q0 = blockIdx.x * BQ;
  const int c0 = blockIdx.y * DVC;
  const int tq = threadIdx.x >> 4;  // row group: rows 4 tq .. 4 tq + 3
  const int tl = threadIdx.x & 15;  // lane in the row group
  const int r0 = tq * 4;
  const int dk4 = (dk + 3) & ~3;    // dk is a multiple of 4 (host check)

  stage(q, Qs, BQ, dk4, LDQ, q0, 0, Lq, dk, dk);

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  }

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    stage(k, Ks, BK, dk4, LDQ, k0, 0, Lk, dk, dk);
    stage(v, Vs, BK, DVC, LDV, k0, c0, Lk, dv, dv);
    for (int j = threadIdx.x; j < BK; j += blockDim.x)
      Ms[j] = (k0 + j < Lk) ? mask[k0 + j] : 0.f;
    __syncthreads();

    // scores of rows r0..r0+3 against keys tl + 16 b
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    for (int d = 0; d < dk4; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        qa[a] = *reinterpret_cast<const float4*>(Qs + (r0 + a) * LDQ + d);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        kb[b] = *reinterpret_cast<const float4*>(Ks + (tl + 16 * b) * LDQ + d);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          s[a][b] = fmaf(qa[a].x, kb[b].x, s[a][b]);
          s[a][b] = fmaf(qa[a].y, kb[b].y, s[a][b]);
          s[a][b] = fmaf(qa[a].z, kb[b].z, s[a][b]);
          s[a][b] = fmaf(qa[a].w, kb[b].w, s[a][b]);
        }
    }

    // online softmax: the 16 lanes of a row group hold the row's 64 keys
    float alpha[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = NEG;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        s[a][b] = Ms[tl + 16 * b] > 0.f ? s[a][b] * scale : NEG;
        mx = fmaxf(mx, s[a][b]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float p = expf(s[a][b] - m_new);
        Ps[(r0 + a) * LDP + tl + 16 * b] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[a] = expf(m[a] - m_new);
      l[a] = l[a] * alpha[a] + sum;
      m[a] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + P V for columns 4 tl .. +3 and 64 + 4 tl .. +3
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] *= alpha[a];
    for (int j = 0; j < BK; j += 4) {
      float4 pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        pa[a] = *reinterpret_cast<const float4*>(Ps + (r0 + a) * LDP + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 v0 =
            *reinterpret_cast<const float4*>(Vs + (j + jj) * LDV + 4 * tl);
        const float4 v1 = *reinterpret_cast<const float4*>(
            Vs + (j + jj) * LDV + 64 + 4 * tl);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float p = jj == 0 ? pa[a].x
                          : jj == 1 ? pa[a].y
                          : jj == 2 ? pa[a].z
                                    : pa[a].w;
          acc[a][0] = fmaf(p, v0.x, acc[a][0]);
          acc[a][1] = fmaf(p, v0.y, acc[a][1]);
          acc[a][2] = fmaf(p, v0.z, acc[a][2]);
          acc[a][3] = fmaf(p, v0.w, acc[a][3]);
          acc[a][4] = fmaf(p, v1.x, acc[a][4]);
          acc[a][5] = fmaf(p, v1.y, acc[a][5]);
          acc[a][6] = fmaf(p, v1.z, acc[a][6]);
          acc[a][7] = fmaf(p, v1.w, acc[a][7]);
        }
      }
    }
    __syncthreads();  // the next tile overwrites Ks, Vs, Ps and Ms
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + r0 + a;
    if (row >= Lq) continue;
    const float l_fin = fmaxf(l[a], 1e-30f);
    const bool any_valid = m[a] > NEG * 0.5f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c0 + (c < 4 ? 4 * tl + c : 64 + 4 * tl + c - 4);
      if (col < dv)
        out[(size_t)row * dv + col] = any_valid ? acc[a][c] / l_fin : 0.f;
    }
    if (blockIdx.y == 0 && tl == 0)
      lse[row] = any_valid ? m[a] + logf(l_fin) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// The backward (K5 dQ, K6 dK and dV).
//
// Replace the Pallas TPU kernels `video_unscreen_tpu/ops/pallas/
// attention.py:_bwd_dq_kernel` (K5) and `:_bwd_dkv_kernel` (K6), the flash
// backward of `_mma_bwd`. With the forward's lse and delta = rowsum(dO o O)
// (a plain reduction in the wrapper), for every (query, key) pair:
//   P = expf(s - lse) with s = q.k * scale, or -1e30 at a masked key (so a
//   masked key, and a query with no valid key, whose lse is 0, get P = 0);
//   dP = dO . V (over all dv columns); dS = P (dP - delta);
//   K5: dQ = (sum_keys dS K) * scale;
//   K6: dK = (sum_queries dS Q) * scale and dV = sum_queries P dO.
// The forward's conventions hold: scale = 1 / sqrtf(dk) in f32, expf, no
// fast-math; a query past Lq and a key past Lk are zero rows whose P and
// dS are set to 0; no load reads past an array's end.
//
// What bounds them: operations. K5 does dk + dv + dk multiply-adds per
// (query, key) pair (2 Lq Lk (2 dk + dv) flops), K6 2 dk + 2 dv
// (2 Lq Lk (2 dk + 2 dv)); at bg's shape over every key that is 1.05 and
// 1.75 ms of f32 work at 67 TFLOP/s against 0.1 ms of bytes at 3.35 TB/s.
//
// Design. The wide value is again the trap: dS needs dP summed over all
// dv = 512 columns, so a block that forms dS cannot own a 128-column
// slice of dv as K4's blocks do. Both kernels keep a (64 x 64) dP tile in
// registers (4 x 4 a thread) and stream dO and V through shared memory in
// 128-column chunks to fill it, then write dS (or P) to a shared tile and
// multiply it into a (64 x 128) register accumulator (4 x 8 a thread), as
// K4 multiplies P into its value chunk.
//  - K5: one block per 64-query tile walks every 64-key tile. At bg's
//    shape that is 32 blocks for 132 SMs: splitting the key range across
//    blocks (with a second pass or atomics for dQ) is later work.
//  - K6: a grid of (64-key tiles) x (1 + dv / 128) roles, each walking
//    every 64-query tile. Role 0 forms dS (streaming the dv chunks of dO
//    and V for dP) and accumulates dK; role c >= 1 forms only P and
//    accumulates the c-th 128-column chunk of dV. P is recomputed by every
//    role (about 40% more work than the least), which keeps each block's
//    accumulator in registers and needs no cross-block reduction; role 0
//    does three times the work of a dV role.
//  - A key tile whose mask is all zero has P = dS = 0 for every query:
//    K5 skips it (adding an exact 0 changes nothing) and K6 writes its
//    zero rows and stops. This is exact for finite inputs; at bg's shape
//    with the STM mask it skips 10 of every 11 key tiles.
// Shared memory: four (64, 132) f32 tiles (Q, K, and the dO and V chunks),
// the (64, 68) dS tile and three 64-float vectors: 153,344 bytes, one block
// per SM. Plain SIMT f32 FMAs; wgmma, TMA and a split of K5's key range
// are later work.

constexpr size_t SMEM_BWD_FLOATS = 4 * BQ * LDQ + BQ * LDP + 3 * BQ;
constexpr size_t SMEM_BWD_BYTES = SMEM_BWD_FLOATS * sizeof(float);
static_assert(BQ == BK, "the backward's tiles are square");

// acc[a][c] += sum_j T[r0 + a][j] X[j][col(c)] over a 64-wide shared tile
// T (pitch LDP) and the rows of X (pitch LDQ); col(c) is 4 tl + c for
// c < 4 and 64 + 4 tl + c - 4 otherwise, as in the forward.
__device__ __forceinline__ void tile_mma(const float* T, const float* X,
                                         int r0, int tl, float acc[4][8]) {
  for (int j = 0; j < BK; j += 4) {
    float4 ta[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      ta[a] = *reinterpret_cast<const float4*>(T + (r0 + a) * LDP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 x0 =
          *reinterpret_cast<const float4*>(X + (j + jj) * LDQ + 4 * tl);
      const float4 x1 =
          *reinterpret_cast<const float4*>(X + (j + jj) * LDQ + 64 + 4 * tl);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float t = jj == 0 ? ta[a].x
                        : jj == 1 ? ta[a].y
                        : jj == 2 ? ta[a].z
                                  : ta[a].w;
        acc[a][0] = fmaf(t, x0.x, acc[a][0]);
        acc[a][1] = fmaf(t, x0.y, acc[a][1]);
        acc[a][2] = fmaf(t, x0.z, acc[a][2]);
        acc[a][3] = fmaf(t, x0.w, acc[a][3]);
        acc[a][4] = fmaf(t, x1.x, acc[a][4]);
        acc[a][5] = fmaf(t, x1.y, acc[a][5]);
        acc[a][6] = fmaf(t, x1.z, acc[a][6]);
        acc[a][7] = fmaf(t, x1.w, acc[a][7]);
      }
    }
  }
}

// out[a][b] += sum_d A[r0 + a][d] B[tl + 16 b][d] for d < width, over two
// shared tiles of pitch LDQ (the 4 x 4 register tile of a 64 x 64 product
// of rows, as the forward's scores).
__device__ __forceinline__ void rows_dot(const float* A, const float* B,
                                         int width, int r0, int tl,
                                         float out[4][4]) {
  for (int d = 0; d < width; d += 4) {
    float4 aa[4], bb[4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
      aa[a] = *reinterpret_cast<const float4*>(A + (r0 + a) * LDQ + d);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      bb[b] = *reinterpret_cast<const float4*>(B + (tl + 16 * b) * LDQ + d);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        out[a][b] = fmaf(aa[a].x, bb[b].x, out[a][b]);
        out[a][b] = fmaf(aa[a].y, bb[b].y, out[a][b]);
        out[a][b] = fmaf(aa[a].z, bb[b].z, out[a][b]);
        out[a][b] = fmaf(aa[a].w, bb[b].w, out[a][b]);
      }
  }
}

// dP tile: rows of A_src (tile at a0, n_a rows) against rows of B_src
// (tile at b0, n_b rows), both (., dv), streamed through As and Bs in
// 128-column chunks.
__device__ __forceinline__ void dp_tile(const float* __restrict__ a_src,
                                        int a0, int n_a,
                                        const float* __restrict__ b_src,
                                        int b0, int n_b, int dv, float* As,
                                        float* Bs, int r0, int tl,
                                        float dp[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) dp[a][b] = 0.f;
  for (int c0 = 0; c0 < dv; c0 += DVC) {
    const int cw = min(DVC, dv - c0);
    stage(a_src, As, BQ, cw, LDQ, a0, c0, n_a, dv, dv);
    stage(b_src, Bs, BK, cw, LDQ, b0, c0, n_b, dv, dv);
    __syncthreads();
    rows_dot(As, Bs, cw, r0, tl, dp);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ mask,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dq,
                   int Lq, int Lk, int dk, int dv, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                 // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;        // [BK][LDQ]
  float* Os = Ks + BK * LDQ;        // [BQ][LDQ] a dv chunk of dO
  float* Vs = Os + BQ * LDQ;        // [BK][LDQ] a dv chunk of V
  float* Ss = Vs + BK * LDQ;        // [BQ][LDP] dS
  float* Ms = Ss + BQ * LDP;        // [BK]
  float* Ls = Ms + BK;              // [BQ] lse
  float* Ds = Ls + BQ;              // [BQ] delta

  const int q0 = blockIdx.x * BQ;
  const int tq = threadIdx.x >> 4, tl = threadIdx.x & 15, r0 = tq * 4;

  stage(q, Qs, BQ, dk, LDQ, q0, 0, Lq, dk, dk);
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    Ls[i] = q0 + i < Lq ? lse[q0 + i] : 0.f;
    Ds[i] = q0 + i < Lq ? delta[q0 + i] : 0.f;
  }

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += BK) {
    float mv = 0.f;
    if (threadIdx.x < BK && k0 + (int)threadIdx.x < Lk)
      mv = mask[k0 + threadIdx.x];
    if (threadIdx.x < BK) Ms[threadIdx.x] = mv;
    // a tile with no valid key has dS = 0: skip it (exact)
    if (!__syncthreads_or(mv > 0.f)) continue;
    stage(k, Ks, BK, dk, LDQ, k0, 0, Lk, dk, dk);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    rows_dot(Qs, Ks, dk, r0, tl, s);
    float dp[4][4];
    dp_tile(dout, q0, Lq, v, k0, Lk, dv, Os, Vs, r0, tl, dp);

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + a;
      const bool live = q0 + r < Lq;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tl + 16 * b;
        const float sv = Ms[j] > 0.f ? s[a][b] * scale : NEG;
        const float p = expf(sv - Ls[r]);
        Ss[r * LDP + j] = live ? p * (dp[a][b] - Ds[r]) : 0.f;
      }
    }
    __syncthreads();
    tile_mma(Ss, Ks, r0, tl, acc);
    __syncthreads();  // the next tile overwrites Ks, Ss and Ms
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + r0 + a;
    if (row >= Lq) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c < 4 ? 4 * tl + c : 64 + 4 * tl + c - 4;
      if (col < dk) dq[(size_t)row * dk + col] = acc[a][c] * scale;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ grad_k, float* __restrict__ grad_v,
                    int Lq, int Lk, int dk, int dv, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;                 // [BK][LDQ]
  float* Qs = Ks + BK * LDQ;        // [BQ][LDQ]
  float* Os = Qs + BQ * LDQ;        // [BQ][LDQ] a dv chunk of dO
  float* Vs = Os + BQ * LDQ;        // [BK][LDQ] a dv chunk of V (role 0)
  float* Ts = Vs + BK * LDQ;        // [BK][LDP] dS^T (role 0) or P^T
  float* Ms = Ts + BK * LDP;        // [BK]
  float* Ls = Ms + BK;              // [BQ] lse
  float* Ds = Ls + BQ;              // [BQ] delta

  const int k0 = blockIdx.x * BK;
  const int role = blockIdx.y;      // 0: dK; c >= 1: dV columns c0..
  const int c0 = (role - 1) * DVC;
  const int cw = role ? min(DVC, dv - c0) : 0;
  const int tq = threadIdx.x >> 4, tl = threadIdx.x & 15, r0 = tq * 4;

  float mv = 0.f;
  if (threadIdx.x < BK && k0 + (int)threadIdx.x < Lk)
    mv = mask[k0 + threadIdx.x];
  if (threadIdx.x < BK) Ms[threadIdx.x] = mv;
  if (!__syncthreads_or(mv > 0.f)) {
    // no valid key in the tile: its rows of dK (or of the dV chunk) are 0
    const int width = role ? cw : dk, ld = role ? dv : dk;
    const int col0 = role ? c0 : 0;
    float* dst = role ? grad_v : grad_k;
    for (int i = threadIdx.x; i < BK * width; i += blockDim.x) {
      const int r = k0 + i / width;
      if (r < Lk) dst[(size_t)r * ld + col0 + i % width] = 0.f;
    }
    return;
  }
  stage(k, Ks, BK, dk, LDQ, k0, 0, Lk, dk, dk);

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    stage(q, Qs, BQ, dk, LDQ, q0, 0, Lq, dk, dk);
    if (role) stage(dout, Os, BQ, cw, LDQ, q0, c0, Lq, dv, dv);
    for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
      Ls[i] = q0 + i < Lq ? lse[q0 + i] : 0.f;
      Ds[i] = q0 + i < Lq ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    // rows r0..r0+3 are keys, columns tl + 16 b queries
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) s[a][b] = 0.f;
    rows_dot(Ks, Qs, dk, r0, tl, s);
    float dp[4][4];
    if (role == 0) dp_tile(v, k0, Lk, dout, q0, Lq, dv, Vs, Os, r0, tl, dp);

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = r0 + a;
      const bool valid = Ms[r] > 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = tl + 16 * b;
        const float sv = valid ? s[a][b] * scale : NEG;
        const float p = expf(sv - Ls[j]);
        const float t = role == 0 ? p * (dp[a][b] - Ds[j]) : p;
        Ts[r * LDP + j] = q0 + j < Lq ? t : 0.f;
      }
    }
    __syncthreads();
    tile_mma(Ts, role == 0 ? Qs : Os, r0, tl, acc);
    __syncthreads();  // the next query tile overwrites Qs, Os, Ts, Ls, Ds
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = k0 + r0 + a;
    if (row >= Lk) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = c < 4 ? 4 * tl + c : 64 + 4 * tl + c - 4;
      if (role == 0) {
        if (col < dk) grad_k[(size_t)row * dk + col] = acc[a][c] * scale;
      } else if (col < cw) {
        grad_v[(size_t)row * dv + c0 + col] = acc[a][c];
      }
    }
  }
}

// The shapes the entries refuse (the wrappers refuse them first).
bool bad_shape(int Lq, int Lk, int dk, int dv) {
  return Lq <= 0 || Lk <= 0 || dk <= 0 || dk > DK_MAX || dk % 4 != 0 ||
         dv <= 0 || dv % 4 != 0;
}

}  // namespace

extern "C" {

// K4: out (Lq, dv) and lse (Lq,) of the masked attention of q (Lq, dk)
// over k (Lk, dk), v (Lk, dv) and kv_mask (Lk,) (a key is valid where the
// mask is > 0). All arrays row-major float32, 16-byte aligned; dk a
// multiple of 4 and at most 128, dv a multiple of 4. Sets *launches.
int vut_attention(const float* q, const float* k, const float* v,
                  const float* kv_mask, float* out, float* lse, int Lq,
                  int Lk, int dk, int dv, void* stream, int* launches) {
  *launches = 0;
  if (bad_shape(Lq, Lk, dk, dv)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  const dim3 grid((Lq + BQ - 1) / BQ, (dv + DVC - 1) / DVC);
  attn_fwd_kernel<<<grid, THREADS, SMEM_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      q, k, v, kv_mask, out, lse, Lq, Lk, dk, dv, scale);
  *launches = 1;
  return cudaGetLastError();
}

// K5: dq (Lq, dk) of the masked attention, from dout (Lq, dv), the
// forward's lse (Lq,) and delta = rowsum(dout * out) (Lq,); the other
// arguments as for vut_attention. Sets *launches.
int vut_attention_bwd_dq(const float* q, const float* k, const float* v,
                         const float* kv_mask, const float* dout,
                         const float* lse, const float* delta, float* dq,
                         int Lq, int Lk, int dk, int dv, void* stream,
                         int* launches) {
  *launches = 0;
  if (bad_shape(Lq, Lk, dk, dv)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BWD_BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  attn_bwd_dq_kernel<<<(Lq + BQ - 1) / BQ, THREADS, SMEM_BWD_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      q, k, v, kv_mask, dout, lse, delta, dq, Lq, Lk, dk, dv, scale);
  *launches = 1;
  return cudaGetLastError();
}

// K6: grad_k (Lk, dk) and grad_v (Lk, dv) of the masked attention, one
// launch; the arguments as for vut_attention_bwd_dq. Sets *launches.
int vut_attention_bwd_dkv(const float* q, const float* k, const float* v,
                          const float* kv_mask, const float* dout,
                          const float* lse, const float* delta,
                          float* grad_k, float* grad_v, int Lq, int Lk,
                          int dk, int dv, void* stream, int* launches) {
  *launches = 0;
  if (bad_shape(Lq, Lk, dk, dv)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BWD_BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  const dim3 grid((Lk + BK - 1) / BK, 1 + (dv + DVC - 1) / DVC);
  attn_bwd_dkv_kernel<<<grid, THREADS, SMEM_BWD_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      q, k, v, kv_mask, dout, lse, delta, grad_k, grad_v, Lq, Lk, dk, dv,
      scale);
  *launches = 1;
  return cudaGetLastError();
}

}  // extern "C"
