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
  if (Lq <= 0 || Lk <= 0 || dk <= 0 || dk > DK_MAX || dk % 4 != 0 ||
      dv <= 0 || dv % 4 != 0)
    return cudaErrorInvalidValue;
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

}  // extern "C"
