// Masked memory attention, the STM memory read (K4), and its backward (K5
// dQ, K6 dK and dV), for Hopper.
//
// Replace the Pallas TPU kernels of `video_unscreen_tpu/ops/pallas/
// attention.py`: `_attn_kernel` (K4, entries `masked_memory_attention`,
// `_fwd_call`), `_bwd_dq_kernel` (K5) and `_bwd_dkv_kernel` (K6), the flash
// backward of `_mma_bwd`. Every array carries a leading batch axis B (the
// JAX package vmaps the read, which makes the batch a grid axis of one
// pallas_call; here it is blockIdx.z): q (B, Lq, dk), k (B, Lk, dk),
// v (B, Lk, dv), kv_mask (B, Lk), dout (B, Lq, dv), lse and delta (B, Lq).
//
// K4: out = softmax(q k^T * scale, keys masked by kv_mask) v by the online
// max/sum recurrence, and the log-sum-exp per query. Semantics kept
// exactly:
//   - a masked score is -1e30 (not -inf), so exp(s - m) is never NaN;
//   - m_new = max(m, rowmax(s)); p = exp(s - m_new); a = exp(m - m_new);
//     l = l * a + rowsum(p); acc = acc * a + p v; m = m_new;
//   - at the end a query whose m is still below -0.5e30 saw no valid key:
//     its output and its LSE are 0; otherwise out = acc / max(l, 1e-30)
//     and lse = m + log(max(l, 1e-30));
//   - scale = 1 / sqrtf(dk) in f32; expf/logf, no fast-math intrinsics.
// The backward, with the forward's lse and delta = rowsum(dO o O) (a plain
// reduction in the wrapper), for every (query, key) pair:
//   P = expf(s - lse) with s = q.k * scale, or -1e30 at a masked key (so a
//   masked key, and a query with no valid key, whose lse is 0, get P = 0);
//   dP = dO . V (over all dv columns); dS = P (dP - delta);
//   K5: dQ = (sum_keys dS K) * scale;
//   K6: dK = (sum_queries dS Q) * scale and dV = sum_queries P dO.
// A key past Lk is a masked key with a zero value row and a query past Lq
// a zero row whose dS is 0, as the TPU kernels' padding makes them; no
// load reads past an array's end.
//
// The live-tile list (`live_tiles_kernel`, one block per batch item): the
// indices, in increasing order, of the 64-key tiles that hold a key with
// mask > 0, and their count. K4 and K5 walk that list instead of every
// tile. This is exact: once a valid key has been seen, a fully masked tile
// has p = expf(-1e30 - m) = 0 for every key and leaves (m, l, acc) as they
// were; before that, the first valid tile's a = expf(-1e30 - m_new) = 0
// wipes whatever the masked tiles added; with no valid key at all the list
// is empty and the zero-valid rule applies. In the backward a fully masked
// tile has P = dS = 0. On the bg path (an empty bank plus the previous
// frame) the list holds 33 of 351 tiles.
//
// What bounds them: operations. Per (query, key) pair K4 does dk + dv
// multiply-adds, K5 2 dk + dv, K6 2 dk + 2 dv (half of them, S and dV, on
// the FMA units); at bg's shape (Lq 2040, Lk 22440, dk 128, dv 512) over
// every key that is 58.6, 70.3 and 117 GFLOP against ~0.1 GB of bytes.
//
// Products: 3xTF32 on the tensor cores (the scheme of CUTLASS's
// OpMultiplyAddFastF32). The path is f32 and one TF32 pass keeps ~11 bits,
// which would break the 1e-5 parity, so each operand x is split into
// big = tf32(x) (cvt.rna.tf32.f32) and small = tf32(x - big), and each
// product accumulates small*big + big*small + big*big in f32. The
// instruction is mma.sync.m16n8k8 (TF32), not wgmma: wgmma takes TF32
// operands only K-major in shared memory, while P V and dS K read V and K
// with the key (the reduction axis) as rows, MN-major, and the big/small
// split would need both halves of every tile written to shared memory
// (twice the bytes, which the 227 KB does not hold next to a double-
// buffered ring at dv 512). mma.sync takes its operands from registers, so
// the split happens on the fragment load. Tiles are staged with cp.async
// (zero-filled past an array's end) into double-buffered rings: the next
// tile loads while the current one is multiplied.
//
// K4 design: a grid of (64-query tiles) x (128-column chunks of dv) x B.
// A (64, 512) f32 accumulator with a double-buffered (64, 512) V ring does
// not fit one block (256 KB of V alone), so each block owns a (64, 128)
// slice of the output and recomputes the q k^T tile (20% of the flops) for
// its slice; at bg's shape that is 128 blocks, one wave on 132 SMs, where
// one block per query tile would be 32. Eight warps: warp w takes query
// rows 16 (w % 4) and, for the scores, keys 32 (w / 4) of the tile; for
// the output, columns 64 (w / 4) of the chunk. The two warps of a row
// group swap their partial row max and sum through shared memory.
//
// K5 design: a grid of (64-query tiles) x (key splits) x B. Each block
// takes an equal share of its batch item's live-tile list (an empty share
// writes zeros) and accumulates a (64, dk) dQ in registers; with one split
// it writes dQ * scale, else its partial sum into a (splits, B, Lq, dk)
// workspace that `dq_reduce_kernel` sums in fixed order and scales. No
// atomics: two calls return the same bits. dS needs dP over all dv, so per
// key tile the block streams dO and V in 64-column chunks through the ring
// (a (64, 512) tile of each does not fit), keeps the (64 x 64) S and dP in
// registers, writes dS to shared memory, and multiplies it into dQ.
//
// K6 design: one block per 32 keys and batch item, 16 warps in two roles
// (a grid of blocks listed by `dkv_grid` in the wrapper). Each block keeps
// its 32 keys' K and V rows in shared memory, so S, P and dP are formed
// once per (key, query) pair. Per 64-query tile the 8 FMA warps form S
// and P = expf(s - lse) (to shared memory) while the 8 tensor-core warps
// start dP; then, per 128-column chunk of dO, the tensor-core warps
// accumulate dP^T += V_c dO_c^T in registers while the FMA warps
// accumulate dV_c += P^T dO_c (dV (32, 512) lives in the FMA warps'
// registers, 64 floats a thread); after the last chunk the
// tensor-core warps form dS = P (dP - delta) (to shared memory) and
// dK += dS^T Q (dK (32, 128) in their registers), then queue the next
// tile's Q while the FMA warps finish the chunk. The roles run
// concurrently on the SM's tensor and FMA pipes, with one block barrier a
// chunk: the dO chunks stream through a cp.async double buffer (the next
// chunk loads while the current one is multiplied). dP and dK are 3xTF32
// (warp w takes keys 16 (w % 2) and queries 16 (w / 2) of dP, columns
// 32 (w / 2) of dK). S and dV run on the FMA units in the order of a plain
// f32 product (each score summed over dk in order, each dV entry over the
// queries in order), because the plain f32 version is itself inexact
// where dV is a long sum that cancels: with one valid key P is 1 for every
// query and dV[key] is the sum of dO's Lq rows, which in f32 is ~1.6e-4
// off the exact value at bg's 2040 queries, at entries near 0 where the
// check allows 1e-5 (`tools/check_torch_dkv_precision.py`). Only the same
// order meets it there; the same sum from exact 64-query partials misses
// it. A block whose 32 keys are all masked writes zero rows and stops.
// Where blocks would leave SMs idle, 2-4 blocks share a key block: each
// takes a share of its dV chunks, and group 0 also forms dP, dS and dK.
// Small reads share every key block; a single read over more than a wave
// shares the key blocks of its last, partial wave. The order of every sum
// stays that of one block, so no second pass and no atomics. dv is at
// most 512 (the STM's 512; a wider V would not fit the registers and
// shared memory).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per tile
constexpr int DK_MAX = 128;     // widest key a block stages
constexpr int DVC = 128;        // value columns per K4 block (and K6 role)
constexpr int DC = 64;          // dv columns per K5 chunk
constexpr int THREADS = 256;
constexpr int LDQ = DK_MAX + 4; // row pitch (floats) of the Q and K tiles
constexpr int LDV = DVC + 8;    // row pitch of K4's V tile (read k-major)
constexpr int LDC = DC + 4;     // row pitch of K5's dO and V chunks
constexpr int LDP = BK + 4;     // row pitch of the P / dS tiles
constexpr float NEG = -1e30f;
static_assert(BQ == BK, "the tiles are square");

// Row pitches are 4 mod 32 floats where a fragment reads 8 rows x 4
// columns and 8 mod 32 where it reads 4 rows x 8 columns, so the 32 lanes
// of a warp hit 32 banks; K is read both ways (by S and by dS K), so its
// second read is a 2-way conflict.

constexpr size_t SMEM_FWD_FLOATS =
    BQ * LDQ + 2 * BK * LDQ + 2 * BK * LDV + BQ * LDP + 2 * BK + 4 * BQ;
constexpr size_t SMEM_FWD_BYTES = SMEM_FWD_FLOATS * sizeof(float);
constexpr size_t SMEM_DQ_FLOATS = BQ * LDQ + 2 * BK * LDQ + 2 * BQ * LDC +
                                  2 * BK * LDC + BQ * LDP + 2 * BK + 2 * BQ;
constexpr size_t SMEM_DQ_BYTES = SMEM_DQ_FLOATS * sizeof(float);

// ---------------------------------------------------------------------------
// Asynchronous staging.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled (nothing read) where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage rows [row0, row0 + rows) x columns [col0, col0 + width) of a
// row-major (n_rows, ld) array into a (rows, pitch) shared tile, zero
// outside [0, n_rows) x [0, n_cols). width, col0 and n_cols are multiples
// of 4 (16-byte copies).
__device__ __forceinline__ void stage_async(const float* __restrict__ src,
                                            float* dst, int rows, int width,
                                            int pitch, int row0, int col0,
                                            int n_rows, int n_cols, int ld) {
  const int vec_per_row = width / 4;
  for (int i = threadIdx.x; i < rows * vec_per_row; i += blockDim.x) {
    const int r = i / vec_per_row, c = (i % vec_per_row) * 4;
    const int gr = row0 + r, gc = col0 + c;
    const bool ok = gr < n_rows && gc < n_cols;
    cp_async16(dst + r * pitch + c, ok ? src + (size_t)gr * ld + gc : src,
               ok);
  }
}

// The mask of keys [k0, k0 + BK), 0 past Lk.
__device__ __forceinline__ void stage_mask_async(const float* __restrict__ m,
                                                 float* dst, int k0,
                                                 int Lk) {
  for (int j = threadIdx.x; j < BK; j += blockDim.x) {
    const bool ok = k0 + j < Lk;
    cp_async4(dst + j, ok ? m + k0 + j : m, ok);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core products (mma.sync.m16n8k8, f32 accumulate).
//
// Fragments (lane = 4 g + t): A (16 x 8, row-major) holds (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4); B (8 x 8) holds (k t, n g) and (k t + 4,
// n g); C (16 x 8) holds (g, 2 t), (g, 2 t + 1), (g + 8, 2 t), (g + 8,
// 2 t + 1).

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows r0.., columns k0.. of a row-major shared tile.
__device__ __forceinline__ void load_a(const float* A, int lda, int r0,
                                       int k0, int g, int t, uint32_t ab[4],
                                       uint32_t as[4]) {
  const float* p = A + (r0 + g) * lda + k0 + t;
  split_tf32(p[0], ab[0], as[0]);
  split_tf32(p[8 * lda], ab[1], as[1]);
  split_tf32(p[4], ab[2], as[2]);
  split_tf32(p[8 * lda + 4], ab[3], as[3]);
}

// B fragment (k0.., n0..) of B = T^T, T a row-major (n, k) shared tile.
__device__ __forceinline__ void load_b_nk(const float* T, int ld, int n0,
                                          int k0, int g, int t,
                                          uint32_t bb[2], uint32_t bs[2]) {
  const float* p = T + (n0 + g) * ld + k0 + t;
  split_tf32(p[0], bb[0], bs[0]);
  split_tf32(p[4], bb[1], bs[1]);
}

// B fragment (k0.., n0..) of a row-major (k, n) shared tile.
__device__ __forceinline__ void load_b_kn(const float* B, int ld, int k0,
                                          int n0, int g, int t,
                                          uint32_t bb[2], uint32_t bs[2]) {
  const float* p = B + (k0 + t) * ld + n0 + g;
  split_tf32(p[0], bb[0], bs[0]);
  split_tf32(p[4 * ld], bb[1], bs[1]);
}

template <int N>
__device__ __forceinline__ void zero_frags(float f[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
}

// c[j] += A B_j at f32 accuracy for one 8-deep step: A is rows wr.. and
// columns k0.. of a row-major shared tile, B_j columns n0 + 8 j.. of B,
// stored (n, k) row-major when NK (B = T^T) and (k, n) otherwise. Each
// product is small*big + big*small + big*big; the three passes go over
// the N independent accumulators in turn, so no mma waits on the one
// before it.
template <int N, bool NK>
__device__ __forceinline__ void mma_step(float c[N][4], const float* A,
                                         int lda, int wr, int k0,
                                         const float* B, int ldb, int n0,
                                         int g, int t) {
  uint32_t ab[4], as[4], bb[N][2], bs[N][2];
  load_a(A, lda, wr, k0, g, t, ab, as);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (NK)
      load_b_nk(B, ldb, n0 + 8 * j, k0, g, t, bb[j], bs[j]);
    else
      load_b_kn(B, ldb, k0, n0 + 8 * j, g, t, bb[j], bs[j]);
  }
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
  for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bb[j]);
}

// c = A B over `depth` (a multiple of 8) for one warp's 16 rows and N
// 8-column fragments, into a fresh accumulator. The tensor cores' f32
// accumulation does not round as the FMA units do, so a long chain of
// mma into one accumulator drifts: every product runs over at most one
// tile (64 keys, or 128 or 64 columns), and the caller adds it to its
// running sum on the FMA units.
template <int N, bool NK>
__device__ __forceinline__ void warp_product(float c[N][4], const float* A,
                                             int lda, int wr,
                                             const float* B, int ldb,
                                             int n0, int depth, int g,
                                             int t) {
  zero_frags<N>(c);
  for (int k0 = 0; k0 < depth; k0 += 8)
    mma_step<N, NK>(c, A, lda, wr, k0, B, ldb, n0, g, t);
}

// ---------------------------------------------------------------------------
// The live-tile list.

__global__ void __launch_bounds__(1024)
live_tiles_kernel(const float* __restrict__ mask, int Lk, int n_tiles,
                  int* __restrict__ tiles, int* __restrict__ n_live) {
  __shared__ int warp_sums[32];
  const float* m = mask + (size_t)blockIdx.x * Lk;
  int* out = tiles + (size_t)blockIdx.x * n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int base = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += blockDim.x) {
    const int tile = t0 + threadIdx.x;
    bool live = false;
    if (tile < n_tiles) {
      const int k0 = tile * BK;
#pragma unroll 16
      for (int j = 0; j < BK; ++j)
        if (k0 + j < Lk) live |= m[k0 + j] > 0.f;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_sums[warp] = __popc(bal);
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warps' counts
      int x = lane < n_warps ? warp_sums[lane] : 0;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += y;
      }
      warp_sums[lane] = x;
    }
    __syncthreads();
    if (live)
      out[base + (warp ? warp_sums[warp - 1] : 0) +
          __popc(bal & ((1u << lane) - 1u))] = tile;
    base += warp_sums[n_warps - 1];
    __syncthreads();  // the next round rewrites warp_sums
  }
  if (threadIdx.x == 0) n_live[blockIdx.x] = base;
}

// ---------------------------------------------------------------------------
// K4.

__global__ void __launch_bounds__(THREADS, 1)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                const int* __restrict__ tiles,
                const int* __restrict__ n_live, float* __restrict__ out,
                float* __restrict__ lse, int Lq, int Lk, int dk, int dv,
                float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                  // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;         // [2][BK][LDQ]
  float* Vs = Ks + 2 * BK * LDQ;     // [2][BK][LDV]
  float* Ps = Vs + 2 * BK * LDV;     // [BQ][LDP]
  float* Ms = Ps + BQ * LDP;         // [2][BK]
  float* Rmax = Ms + 2 * BK;         // [2][BQ] row max of each key half
  float* Rsum = Rmax + 2 * BQ;       // [2][BQ] row sum of each key half

  const int b = blockIdx.z;
  const int n_tiles = (Lk + BK - 1) / BK;
  q += (size_t)b * Lq * dk;
  k += (size_t)b * Lk * dk;
  v += (size_t)b * Lk * dv;
  mask += (size_t)b * Lk;
  out += (size_t)b * Lq * dv;
  lse += (size_t)b * Lq;
  const int* list = tiles + (size_t)b * n_tiles;
  const int n = n_live[b];

  const int q0 = blockIdx.x * BQ, c0 = blockIdx.y * DVC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;   // the warp's 16 query rows
  const int wh = warp >> 2;         // its half: keys 32 wh, columns 64 wh
  const int dk8 = (dk + 7) & ~7;

  auto load_tile = [&](int i) {
    const int buf = i & 1, k0 = list[i] * BK;
    stage_async(k, Ks + buf * BK * LDQ, BK, dk8, LDQ, k0, 0, Lk, dk, dk);
    stage_async(v, Vs + buf * BK * LDV, BK, DVC, LDV, k0, c0, Lk, dv, dv);
    stage_mask_async(mask, Ms + buf * BK, k0, Lk);
  };

  stage_async(q, Qs, BQ, dk8, LDQ, q0, 0, Lq, dk, dk);
  if (n > 0) load_tile(0);
  cp_async_commit();

  // rows wr + g (h = 0) and wr + g + 8 (h = 1)
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[8][4];
  zero_frags<8>(acc);

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_tile(i + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kb = Ks + (i & 1) * BK * LDQ;
    const float* Vb = Vs + (i & 1) * BK * LDV;
    const float* Mb = Ms + (i & 1) * BK;

    float s[4][4];  // scores of rows wr.., keys 32 wh + 8 j..
    warp_product<4, true>(s, Qs, LDQ, wr, Kb, LDQ, 32 * wh, dk8, g, t);
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 32 * wh + 8 * j + 2 * t + (e & 1);
        s[j][e] = Mb[key] > 0.f ? s[j][e] * scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t == 0) Rmax[wh * BQ + wr + g + 8 * h] = mx[h];
    }
    __syncthreads();

    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr + g + 8 * h;
      m_new[h] = fmaxf(m[h], fmaxf(Rmax[row], Rmax[BQ + row]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = expf(s[j][2 * h] - m_new[h]);
        const float p1 = expf(s[j][2 * h + 1] - m_new[h]);
        *reinterpret_cast<float2*>(Ps + (wr + g + 8 * h) * LDP + 32 * wh +
                                   8 * j + 2 * t) = make_float2(p0, p1);
        sum[h] += p0 + p1;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      if (t == 0) Rsum[wh * BQ + wr + g + 8 * h] = sum[h];
    }
    __syncthreads();

    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wr + g + 8 * h;
      alpha[h] = expf(m[h] - m_new[h]);
      l[h] = l[h] * alpha[h] + (Rsum[row] + Rsum[BQ + row]);
      m[h] = m_new[h];
    }
    // pv = P V: rows wr.., columns 64 wh + 8 j of the chunk
    float pv[8][4];
    warp_product<8, false>(pv, Ps, LDP, wr, Vb, LDV, 64 * wh, BK, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[j][e] = fmaf(acc[j][e], alpha[e >> 1], pv[j][e]);
    __syncthreads();  // the next tile's loads overwrite this buffer and Ps
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= Lq) continue;
    const float l_fin = fmaxf(l[h], 1e-30f);
    const bool any_valid = m[h] > NEG * 0.5f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 64 * wh + 8 * j + 2 * t;
      if (col < dv)  // dv is a multiple of 4: col + 1 < dv too
        *reinterpret_cast<float2*>(out + (size_t)row * dv + col) =
            any_valid ? make_float2(acc[j][2 * h] / l_fin,
                                    acc[j][2 * h + 1] / l_fin)
                      : make_float2(0.f, 0.f);
    }
    if (blockIdx.y == 0 && wh == 0 && t == 0)
      lse[row] = any_valid ? m[h] + logf(l_fin) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K5.

__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ mask,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ tiles,
                   const int* __restrict__ n_live, float* __restrict__ dq,
                   float* __restrict__ work, int B, int Lq, int Lk, int dk,
                   int dv, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                  // [BQ][LDQ]
  float* Ks = Qs + BQ * LDQ;         // [2][BK][LDQ]
  float* Os = Ks + 2 * BK * LDQ;     // [2][BQ][LDC] a dv chunk of dO
  float* Vs = Os + 2 * BQ * LDC;     // [2][BK][LDC] a dv chunk of V
  float* Ss = Vs + 2 * BK * LDC;     // [BQ][LDP] dS
  float* Ms = Ss + BQ * LDP;         // [2][BK]
  float* Ls = Ms + 2 * BK;           // [BQ] lse
  float* Ds = Ls + BQ;               // [BQ] delta

  const int b = blockIdx.z, split = blockIdx.y, n_split = gridDim.y;
  const int n_tiles = (Lk + BK - 1) / BK;
  q += (size_t)b * Lq * dk;
  k += (size_t)b * Lk * dk;
  v += (size_t)b * Lk * dv;
  mask += (size_t)b * Lk;
  dout += (size_t)b * Lq * dv;
  lse += (size_t)b * Lq;
  delta += (size_t)b * Lq;
  const int* list = tiles + (size_t)b * n_tiles;
  const int n = n_live[b];
  const int i0 = (int)((long long)n * split / n_split);
  const int i1 = (int)((long long)n * (split + 1) / n_split);

  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp & 3) * 16;   // the warp's 16 query rows
  const int wh = warp >> 2;         // its half: keys 32 wh, dk columns 64 wh
  const int dk8 = (dk + 7) & ~7;
  const int nc = (dv + DC - 1) / DC;
  const int n_steps = (i1 - i0) * nc;  // (tile, dv chunk) steps

  // step -> tile i0 + step / nc (K tile buffer (step / nc) & 1), chunk
  // step % nc (ring slot step & 1); a tile's K and mask come with its
  // first chunk
  auto load_step = [&](int step) {
    const int it = step / nc, c = step % nc, slot = step & 1;
    const int k0 = list[i0 + it] * BK;
    if (c == 0) {
      // every column: dS K reads all 128 (zeros past dk)
      stage_async(k, Ks + (it & 1) * BK * LDQ, BK, DK_MAX, LDQ, k0, 0, Lk,
                  dk, dk);
      stage_mask_async(mask, Ms + (it & 1) * BK, k0, Lk);
    }
    stage_async(dout, Os + slot * BQ * LDC, BQ, DC, LDC, q0, c * DC, Lq, dv,
                dv);
    stage_async(v, Vs + slot * BK * LDC, BK, DC, LDC, k0, c * DC, Lk, dv,
                dv);
  };

  stage_async(q, Qs, BQ, dk8, LDQ, q0, 0, Lq, dk, dk);
  for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
    Ls[i] = q0 + i < Lq ? lse[q0 + i] : 0.f;
    Ds[i] = q0 + i < Lq ? delta[q0 + i] : 0.f;
  }
  if (n_steps > 0) load_step(0);
  cp_async_commit();

  float acc[8][4];  // dQ rows wr.., columns 64 wh + 8 j
  zero_frags<8>(acc);
  float s[4][4], dp[4][4];

  for (int step = 0; step < n_steps; ++step) {
    const int it = step / nc, c = step % nc, slot = step & 1;
    if (step + 1 < n_steps) load_step(step + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* Kb = Ks + (it & 1) * BK * LDQ;

    if (c == 0) {
      warp_product<4, true>(s, Qs, LDQ, wr, Kb, LDQ, 32 * wh, dk8, g, t);
      zero_frags<4>(dp);
    }
    // dP += dO_c V_c^T over the chunk's 64 columns
    const float* Ob = Os + slot * BQ * LDC;
    const float* Vb = Vs + slot * BK * LDC;
    float dpc[4][4];
    warp_product<4, true>(dpc, Ob, LDC, wr, Vb, LDC, 32 * wh, DC, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dp[j][e] += dpc[j][e];

    if (c == nc - 1) {
      const float* Mb = Ms + (it & 1) * BK;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wr + g + 8 * h;
          const bool live = q0 + row < Lq;
          float ds[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = 32 * wh + 8 * j + 2 * t + e;
            const float sv = Mb[key] > 0.f ? s[j][2 * h + e] * scale : NEG;
            const float p = expf(sv - Ls[row]);
            ds[e] = live ? p * (dp[j][2 * h + e] - Ds[row]) : 0.f;
          }
          *reinterpret_cast<float2*>(Ss + row * LDP + 32 * wh + 8 * j +
                                     2 * t) = make_float2(ds[0], ds[1]);
        }
      __syncthreads();
      // dQ += dS K: rows wr.., columns 64 wh + 8 j, over the tile's keys
      float dqt[8][4];
      warp_product<8, false>(dqt, Ss, LDP, wr, Kb, LDQ, 64 * wh, BK, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += dqt[j][e];
    }
    __syncthreads();  // the next steps' loads overwrite this slot, Ss, Ks
  }
  cp_async_wait<0>();

  // one split: dQ * scale; else this split's partial sum
  float* dst = n_split == 1
                   ? dq + (size_t)b * Lq * dk
                   : work + ((size_t)split * B + b) * Lq * dk;
  const float f = n_split == 1 ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wr + g + 8 * h;
    if (row >= Lq) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 64 * wh + 8 * j + 2 * t;
      if (col < dk)  // dk is a multiple of 4: col + 1 < dk too
        *reinterpret_cast<float2*>(dst + (size_t)row * dk + col) =
            make_float2(acc[j][2 * h] * f, acc[j][2 * h + 1] * f);
    }
  }
}

// dq[i] = scale * sum over splits s (in order) of work[s][i].
__global__ void dq_reduce_kernel(const float* __restrict__ work,
                                 float* __restrict__ dq, size_t n,
                                 int n_split, float scale) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int s = 0; s < n_split; ++s) sum += work[s * n + i];
    dq[i] = sum * scale;
  }
}

// ---------------------------------------------------------------------------
// K6.
//
// Shared memory: the block's resident K (32, 132) and V (32, 516) rows, the
// tile's Q (64, 132), two dO chunks (64, 132) of the ring, the (64, 40) P
// and dS tiles (query-major), the tile's lse and delta and the key mask:
// 205,440 bytes.

constexpr int THREADS6 = 512;            // 8 tensor-core + 8 FMA warps
constexpr int BKV = 32;                  // keys per K6 block
constexpr int DVC6 = 128;                // dv columns per dO chunk
constexpr int NC6 = 4;                   // chunks K6 holds: dv <= 512
constexpr int LDV6 = NC6 * DVC6 + 4;     // row pitch of the resident V
constexpr int LDO6 = DVC6 + 4;           // row pitch of a dO chunk
constexpr int LDT6 = BKV + 8;            // row pitch of the P and dS tiles
constexpr size_t SMEM_DKV_FLOATS = BQ * LDQ + 2 * BQ * LDO6 + BKV * LDV6 +
                                   BKV * LDQ + 2 * BQ * LDT6 + 2 * BQ + BKV;
constexpr size_t SMEM_DKV_BYTES = SMEM_DKV_FLOATS * sizeof(float);

// A timing diagnostic (tools/time_torch_dkv_parts.py) builds K6 with parts
// of its work switched off, one bit of VUT_DKV_SKIP each: 1 the dV
// products, 2 dP, 4 the S loop, 8 dK. Its outputs are then wrong. The
// library is built without it: nothing is skipped.
#ifndef VUT_DKV_SKIP
#define VUT_DKV_SKIP 0
#endif

// c = A B as warp_product<N, false> forms it, for an A stored transposed:
// A(r, k) at T[k * ldt + r] (the query-major dS tile read as dS^T).
template <int N>
__device__ __forceinline__ void warp_product_at(float c[N][4], const float* T,
                                                int ldt, int r0,
                                                const float* B, int ldb,
                                                int n0, int depth, int g,
                                                int t) {
  zero_frags<N>(c);
#pragma unroll
  for (int k0 = 0; k0 < depth; k0 += 8) {
    uint32_t ab[4], as[4], bb[N][2], bs[N][2];
    const float* p = T + (k0 + t) * ldt + r0 + g;
    split_tf32(p[0], ab[0], as[0]);
    split_tf32(p[8], ab[1], as[1]);
    split_tf32(p[4 * ldt], ab[2], as[2]);
    split_tf32(p[4 * ldt + 8], ab[3], as[3]);
#pragma unroll
    for (int j = 0; j < N; ++j)
      load_b_kn(B, ldb, k0, n0 + 8 * j, g, t, bb[j], bs[j]);
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[j], as, bb[j]);
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bs[j]);
#pragma unroll
    for (int j = 0; j < N; ++j) mma_tf32(c[j], ab, bb[j]);
  }
}

// Barrier 1 among the 256 threads of the tensor-core warps only, barrier
// 2 among those of the FMA warps.
__device__ __forceinline__ void mma_warps_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}
__device__ __forceinline__ void fma_warps_sync() {
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
}

// warp_product<N, NK> over a fixed depth, unrolled.
template <int N, bool NK, int DEPTH>
__device__ __forceinline__ void warp_product_n(float c[N][4], const float* A,
                                               int lda, int wr,
                                               const float* B, int ldb,
                                               int n0, int g, int t) {
  zero_frags<N>(c);
#pragma unroll
  for (int k0 = 0; k0 < DEPTH; k0 += 8)
    mma_step<N, NK>(c, A, lda, wr, k0, B, ldb, n0, g, t);
}

__global__ void __launch_bounds__(THREADS6, 1)
attn_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ mask,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ grad_k, float* __restrict__ grad_v,
                    int Lq, int Lk, int dk, int dv, int tail0, int g_head,
                    int g_tail, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                  // [BQ][LDQ]
  float* Os = Qs + BQ * LDQ;         // [2][BQ][LDO6] a dv chunk of dO
  float* Vs = Os + 2 * BQ * LDO6;    // [BKV][LDV6]
  float* Ks = Vs + BKV * LDV6;       // [BKV][LDQ]
  float* Ps = Ks + BKV * LDQ;        // [BQ][LDT6] P (query-major)
  float* Ss = Ps + BQ * LDT6;        // [BQ][LDT6] dS (query-major)
  float* Ls = Ss + BQ * LDT6;        // [BQ] lse
  float* Ds = Ls + BQ;               // [BQ] delta
  float* Ms = Ds + BQ;               // [BKV]

  // key blocks [0, tail0) take g_head blocks each, the rest g_tail
  const int b = blockIdx.z, x = blockIdx.x, head = tail0 * g_head;
  const int n_group = x < head ? g_head : g_tail;
  const int kb = x < head ? x / g_head : tail0 + (x - head) / g_tail;
  const int group = x < head ? x % g_head : (x - head) % g_tail;
  q += (size_t)b * Lq * dk;
  k += (size_t)b * Lk * dk;
  v += (size_t)b * Lk * dv;
  mask += (size_t)b * Lk;
  dout += (size_t)b * Lq * dv;
  lse += (size_t)b * Lq;
  delta += (size_t)b * Lq;
  grad_k += (size_t)b * Lk * dk;
  grad_v += (size_t)b * Lk * dv;

  const int k0 = kb * BKV;
  const int nc = (dv + DVC6 - 1) / DVC6;
  // this group's dV chunks [v0, v1); group 0 also forms dP over every
  // chunk, dS and dK, so it streams all of them
  const int v0 = nc * group / n_group, v1 = nc * (group + 1) / n_group;
  const bool first = group == 0;
  const int cb = first ? 0 : v0, ce = first ? nc : v1;

  float mv = 0.f;
  if (threadIdx.x < BKV && k0 + (int)threadIdx.x < Lk)
    mv = mask[k0 + threadIdx.x];
  if (threadIdx.x < BKV) Ms[threadIdx.x] = mv;
  if (!__syncthreads_or(mv > 0.f)) {
    // no valid key in the block: zero rows of dV's chunks (and of dK)
    const int c0 = v0 * DVC6, w = min(dv, v1 * DVC6) - c0;
    for (int i = threadIdx.x; i < BKV * w; i += blockDim.x) {
      const int r = k0 + i / w;
      if (r < Lk) grad_v[(size_t)r * dv + c0 + i % w] = 0.f;
    }
    for (int i = threadIdx.x; first && i < BKV * dk; i += blockDim.x) {
      const int r = k0 + i / dk;
      if (r < Lk) grad_k[(size_t)r * dk + i % dk] = 0.f;
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_ch = ce - cb;
  const int n_qt = (Lq + BQ - 1) / BQ;
  const int n_steps = n_qt * n_ch;

  // step s -> query tile s / n_ch, dO chunk cb + s % n_ch (ring slot
  // s & 1). Every thread stages.
  auto load_step = [&](int s) {
    stage_async(dout, Os + (s & 1) * BQ * LDO6, BQ, DVC6, LDO6,
                s / n_ch * BQ, (cb + s % n_ch) * DVC6, Lq, dv, dv);
  };
  // the start of step s: wait for its chunk (and, at a tile's first step,
  // the tile's Q), then (every thread past the barrier, so done with step
  // s - 1) queue step s + 1 into the slot step s - 1 used
  auto begin_step = [&](int s) {
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < n_steps) load_step(s + 1);
    cp_async_commit();
  };
  // Q, lse and delta of tile t (every column: dS^T Q reads all 128, zeros
  // past dk), staged by the 256 tensor-core threads at the end of tile
  // t - 1, once its dK is done with Q (by all 512 for tile 0)
  auto stage_q = [&](int t, int u, int n_u) {
    const int q0 = t * BQ;
    for (int i = u; i < BQ * DK_MAX / 4; i += n_u) {
      const int r = i / (DK_MAX / 4), c = (i % (DK_MAX / 4)) * 4;
      const bool ok = q0 + r < Lq && c < dk;
      cp_async16(Qs + r * LDQ + c, ok ? q + (size_t)(q0 + r) * dk + c : q,
                 ok);
    }
    for (int j = u; j < BQ; j += n_u) {
      const bool ok = q0 + j < Lq;
      cp_async4(Ls + j, ok ? lse + q0 + j : lse, ok);
      cp_async4(Ds + j, ok ? delta + q0 + j : delta, ok);
    }
    cp_async_commit();
  };
  // Where a block streams one chunk a tile, S, dS and the next tile's Q
  // share a step: the tensor-core warps then wait at a block barrier for S.
  const bool s_barrier = n_ch == 1;
  // At a tile's first step the FMA warps form S = Q K^T, each score summed
  // over dk in order as a plain f32 product sums it (thread u: keys
  // u % 16 + 16 a, queries u / 16 + 16 i), then P = expf(s - lse) into
  // Ps, while the tensor-core warps start dP.
  auto scores = [&](int it) {
    const int u = threadIdx.x - 256, sk = u & 15, sq = u >> 4;
    float sc[2][4] = {};
#pragma unroll 2
    for (int d = 0; d < (VUT_DKV_SKIP & 4 ? 0 : dk); d += 4) {
      float4 kr[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        kr[a] = *reinterpret_cast<const float4*>(Ks + (sk + 16 * a) * LDQ +
                                                 d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(Qs + (sq + 16 * i) * LDQ + d);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          sc[a][i] = fmaf(kr[a].x, x.x, sc[a][i]);
          sc[a][i] = fmaf(kr[a].y, x.y, sc[a][i]);
          sc[a][i] = fmaf(kr[a].z, x.z, sc[a][i]);
          sc[a][i] = fmaf(kr[a].w, x.w, sc[a][i]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = sk + 16 * a, col = sq + 16 * i;
        const float sv = Ms[key] > 0.f ? sc[a][i] * scale : NEG;
        Ps[col * LDT6 + key] = it * BQ + col < Lq ? expf(sv - Ls[col]) : 0.f;
      }
    if (s_barrier)
      __syncthreads();
    else
      fma_warps_sync();  // P whole before dV reads it
  };

  stage_async(k, Ks, BKV, (dk + 7) & ~7, LDQ, k0, 0, Lk, dk, dk);
  stage_async(v, Vs, BKV, nc * DVC6, LDV6, k0, 0, Lk, dv, dv);
  load_step(0);
  stage_q(0, threadIdx.x, THREADS6);

  if (warp < 8) {
    // tensor-core warps: dP^T += V_c dO_c^T per chunk, then dS = P (dP -
    // delta) and dK += dS^T Q per tile (3xTF32). Warp w takes keys
    // 16 (w % 2) and queries 16 (w / 2) of dP, columns 32 (w / 2) of dK.
    const int g = lane >> 2, t_ = lane & 3;
    const int wr = (warp & 1) * 16, wc = warp >> 1;
    float acc_k[4][4], dp[2][4];
    zero_frags<4>(acc_k);
    for (int it = 0; it < n_qt; ++it) {
      for (int c = cb; c < ce; ++c) {
        const int s = it * n_ch + c - cb;
        begin_step(s);
        if (c == cb) {
          zero_frags<2>(dp);
          if (s_barrier) __syncthreads();  // S done
        }
        if (!(VUT_DKV_SKIP & 2) && first) {
          const float* Ob = Os + (s & 1) * BQ * LDO6;
          const int cw8 = min(DVC6, ((dv + 7) & ~7) - c * DVC6);
          float dpc[2][4];
          if (cw8 == DVC6)
            warp_product_n<2, true, DVC6>(dpc, Vs + c * DVC6, LDV6, wr, Ob,
                                          LDO6, 16 * wc, g, t_);
          else
            warp_product<2, true>(dpc, Vs + c * DVC6, LDV6, wr, Ob, LDO6,
                                  16 * wc, cw8, g, t_);
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[j][e] += dpc[j][e];
        }
        if (first && c == nc - 1) {
          // dS = P (dP - delta), then dK += dS^T Q over the tile
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = 16 * wc + 8 * j + 2 * t_ + (e & 1);
              const int at = col * LDT6 + wr + g + 8 * (e >> 1);
              Ss[at] = Ps[at] * (dp[j][e] - Ds[col]);
            }
          mma_warps_sync();
          float kt[4][4];
          if (!(VUT_DKV_SKIP & 8))
            warp_product_at<4>(kt, Ss, LDT6, wr, Qs, LDQ, 32 * wc, BQ, g, t_);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc_k[j][e] += kt[j][e];
          mma_warps_sync();  // every dK product is done with Q
        }
        // the next tile's Q loads while the FMA warps finish this chunk
        if (c == ce - 1 && it + 1 < n_qt) stage_q(it + 1, threadIdx.x, 256);
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = k0 + wr + g + 8 * h;
      if (!first || row >= Lk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 32 * wc + 8 * j + 2 * t_;
        if (col < dk)  // dk is a multiple of 4: col + 1 < dk too
          *reinterpret_cast<float2*>(grad_k + (size_t)row * dk + col) =
              make_float2(acc_k[j][2 * h] * scale,
                          acc_k[j][2 * h + 1] * scale);
      }
    }
  } else {
    // FMA warps: per chunk dV_c += P^T dO_c query by query in order (a
    // plain f32 product's order); thread f takes keys 4 vk + a, columns
    // c DVC6 + 4 vc + e
    const int f = threadIdx.x - 256, vk = f & 7, vc = f >> 3;
    float acc_v[NC6][4][4];
#pragma unroll
    for (int c = 0; c < NC6; ++c) zero_frags<4>(acc_v[c]);
    for (int it = 0; it < n_qt; ++it) {
#pragma unroll
      for (int c = 0; c < NC6; ++c) {
        if (c < cb || c >= ce) continue;
        const int s = it * n_ch + c - cb;
        begin_step(s);
        if (c == cb) scores(it);
        if (!(VUT_DKV_SKIP & 1) && c >= v0 && c < v1) {
          const float* Ob = Os + (s & 1) * BQ * LDO6;
#pragma unroll 8
          for (int j = 0; j < BQ; ++j) {
            const float4 pj =
                *reinterpret_cast<const float4*>(Ps + j * LDT6 + 4 * vk);
            const float4 oj =
                *reinterpret_cast<const float4*>(Ob + j * LDO6 + 4 * vc);
            const float pa[4] = {pj.x, pj.y, pj.z, pj.w};
            const float ob[4] = {oj.x, oj.y, oj.z, oj.w};
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                acc_v[c][a][e] = fmaf(pa[a], ob[e], acc_v[c][a][e]);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = k0 + 4 * vk + a;
      if (row >= Lk) continue;
#pragma unroll
      for (int c = 0; c < NC6; ++c) {
        const int col = c * DVC6 + 4 * vc;
        if (c >= v0 && c < v1 && col < dv)  // dv is a multiple of 4
          *reinterpret_cast<float4*>(grad_v + (size_t)row * dv + col) =
              make_float4(acc_v[c][a][0], acc_v[c][a][1], acc_v[c][a][2],
                          acc_v[c][a][3]);
      }
    }
  }
}

// The shapes the entries refuse (the wrappers refuse them first).
bool bad_shape(int B, int Lq, int Lk, int dk, int dv) {
  return B <= 0 || B > 65535 || Lq <= 0 || Lk <= 0 || dk <= 0 ||
         dk > DK_MAX || dk % 4 != 0 || dv <= 0 || dv % 4 != 0;
}

}  // namespace

extern "C" {

// The live-tile list of kv_mask (B, Lk): tiles (B, ceil(Lk / 64)) int32
// gets, per batch item, the indices of the 64-key tiles holding a key
// > 0, in increasing order, and n_live (B,) their count. Sets *launches.
int vut_attention_tiles(const float* kv_mask, int* tiles, int* n_live,
                        int B, int Lk, void* stream, int* launches) {
  *launches = 0;
  if (B <= 0 || Lk <= 0) return cudaErrorInvalidValue;
  live_tiles_kernel<<<B, 1024, 0, static_cast<cudaStream_t>(stream)>>>(
      kv_mask, Lk, (Lk + BK - 1) / BK, tiles, n_live);
  *launches = 1;
  return cudaGetLastError();
}

// K4: out (B, Lq, dv) and lse (B, Lq) of the masked attention of q
// (B, Lq, dk) over k (B, Lk, dk), v (B, Lk, dv) and kv_mask (B, Lk) (a key
// is valid where the mask is > 0), walking the live-tile list (tiles,
// n_live) of vut_attention_tiles. All arrays row-major float32, 16-byte
// aligned; dk a multiple of 4 and at most 128, dv a multiple of 4. Sets
// *launches.
int vut_attention(const float* q, const float* k, const float* v,
                  const float* kv_mask, const int* tiles, const int* n_live,
                  float* out, float* lse, int B, int Lq, int Lk, int dk,
                  int dv, void* stream, int* launches) {
  *launches = 0;
  if (bad_shape(B, Lq, Lk, dk, dv)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_FWD_BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  const dim3 grid((Lq + BQ - 1) / BQ, (dv + DVC - 1) / DVC, B);
  attn_fwd_kernel<<<grid, THREADS, SMEM_FWD_BYTES,
                    static_cast<cudaStream_t>(stream)>>>(
      q, k, v, kv_mask, tiles, n_live, out, lse, Lq, Lk, dk, dv, scale);
  *launches = 1;
  return cudaGetLastError();
}

// K5: dq (B, Lq, dk) of the masked attention, from dout (B, Lq, dv), the
// forward's lse (B, Lq) and delta = rowsum(dout * out) (B, Lq), over
// `splits` shares of the live-tile list; with splits > 1, work is a
// (splits, B, Lq, dk) float32 scratch and a second launch sums it. The
// other arguments as for vut_attention. Sets *launches.
int vut_attention_bwd_dq(const float* q, const float* k, const float* v,
                         const float* kv_mask, const float* dout,
                         const float* lse, const float* delta,
                         const int* tiles, const int* n_live, float* dq,
                         float* work, int B, int Lq, int Lk, int dk, int dv,
                         int splits, void* stream, int* launches) {
  *launches = 0;
  if (bad_shape(B, Lq, Lk, dk, dv) || splits <= 0 || splits > 65535 ||
      (splits > 1 && work == nullptr))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_DQ_BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Lq + BQ - 1) / BQ, splits, B);
  attn_bwd_dq_kernel<<<grid, THREADS, SMEM_DQ_BYTES, st>>>(
      q, k, v, kv_mask, dout, lse, delta, tiles, n_live, dq, work, B, Lq, Lk,
      dk, dv, scale);
  *launches = 1;
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t n = (size_t)B * Lq * dk;
  const int blocks = (int)((n + 4 * 256 - 1) / (4 * 256));
  dq_reduce_kernel<<<blocks, 256, 0, st>>>(work, dq, n, splits, scale);
  *launches = 2;
  return cudaGetLastError();
}

// K6: grad_k (B, Lk, dk) and grad_v (B, Lk, dv) of the masked attention,
// dv at most 512, one launch. Each 32-key block's dV chunks are shared by
// g_head blocks for key blocks [0, tail0) and by g_tail blocks for the
// rest (group 0 also forms dP, dS and dK); each count at most one block
// per 128-column chunk of dv. The other arguments as for
// vut_attention_bwd_dq. Sets *launches.
int vut_attention_bwd_dkv(const float* q, const float* k, const float* v,
                          const float* kv_mask, const float* dout,
                          const float* lse, const float* delta,
                          float* grad_k, float* grad_v, int B, int Lq,
                          int Lk, int dk, int dv, int tail0, int g_head,
                          int g_tail, void* stream, int* launches) {
  *launches = 0;
  const int n_kb = (Lk + BKV - 1) / BKV, nc = (dv + DVC6 - 1) / DVC6;
  if (bad_shape(B, Lq, Lk, dk, dv) || dv > NC6 * DVC6 || tail0 < 0 ||
      tail0 > n_kb || g_head <= 0 || g_head > nc || g_tail <= 0 ||
      g_tail > nc)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_DKV_BYTES));
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(dk));
  const dim3 grid(tail0 * g_head + (n_kb - tail0) * g_tail, 1, B);
  attn_bwd_dkv_kernel<<<grid, THREADS6, SMEM_DKV_BYTES,
                        static_cast<cudaStream_t>(stream)>>>(
      q, k, v, kv_mask, dout, lse, delta, grad_k, grad_v, Lq, Lk, dk, dv,
      tail0, g_head, g_tail, scale);
  *launches = 1;
  return cudaGetLastError();
}

}  // extern "C"
