// Iterated grayscale morphology (K2) and the fused trimap (K1) for Hopper.
//
// Replaces the Pallas TPU kernels `video_unscreen_tpu/ops/pallas/morph.py`:
//   K2 `_morph_kernel` (entry `pallas_dilate`): `iters` dilations (or
//      erosions) of an (H, W) f32 mask by a small structuring element;
//   K1 `_trimap_kernel` (entry `pallas_trimap`): the dilate chain and the
//      erode chain of the same mask, then 255 where erode > 127, 0 where
//      dilate < 128, else 128.
// Semantics are those of `ops/morphology.py:_morph`: out[y, x] = max (or
// min) of in[y + dy, x + dx] over the anchor and the SE offsets, where a
// neighbour outside the image counts as -inf (dilate) or +inf (erode).
// Both take a batch (B, H, W) in one launch: the batch is the grid's z.
//
// What bounds it: memory, for the chains the paths run. Per pixel the work
// is iters * |SE| compares (5-point cross, 40 iterations: 160), against 8
// bytes read and written; at 544x960 the bytes take 1.25 us at 3.35 TB/s,
// and so do the compares of the longest chain at 67 TFLOP/s. What held the
// first kernel far above that was latency: a barrier per iteration
// for ~6 cells a thread, runtime divisions and four bounds checks per
// neighbour, halo windows reloaded and recomputed per launch, and three
// launches for a 40-iteration chain. What holds this one: the launch and
// one DRAM round trip on short chains (a few us), and on long ones the
// halo it recomputes (at 40 iterations a block updates ~4x the cells of
// its output tile) at a few cell updates a clock per SM.
//
// Design:
// - The window lives in registers. A block is a column of warps; each warp
//   spans the window's 128 columns (4 per lane, one float4) and holds 4
//   rows of it (6 for chains of more than 20 rows of halo, whose windows
//   must be taller than 32 warps of 4). Vertical neighbours are in the
//   thread's own registers,
//   horizontal ones one warp shuffle away, and only a warp's edge rows go
//   through shared memory: one barrier an iteration, double-buffered.
// - Every chain is one launch while its halo fits the window (48
//   iterations of the cross, 96 columns of halo; K2 blocks have up to 32
//   warps, K1 blocks 16, for K1's two chains): the window carries
//   iters * reach rows and columns of halo, recomputed as the iterations
//   shrink the region still needed; rows that fall out of that region stop
//   being updated (a warp-uniform test per row).
// - Every chain is a max chain: an erosion runs as -dilate(-x) (negation
//   is exact, so min(a, b) == -max(-a, -b) bit for bit), negated as it is
//   loaded and stored. K1 runs its two chains in lockstep on x and -x
//   with the same neighbour structure and writes only the selected value:
//   one read, one write.
// - The two SEs the paths use are compile-time types with unrolled
//   neighbours: the 5-point cross (`ellipse_offsets(3)` and
//   `cross_offsets(3)`) and the 4x4 ellipse (a cross around (-1, -1) plus
//   the anchor). Any other SE within 4 cells of its anchor takes the
//   generic kernel, which walks a runtime list of offsets: still one CUDA
//   launch, and quick to compile.
// - The fill is written once: cells outside the image are loaded as -inf
//   and never updated (rows: not live; columns: reset to -inf in blocks
//   that cross a side of the image), so no neighbour read checks a bound,
//   and the result is exact, because -inf is the identity of max. (A TMA
//   tile load would fill such cells with zero, not -inf.)
// - Loads and stores are 128-bit where rows are 16-byte aligned (W % 4 ==
//   0). The tiles of a launch are sized to fill the card's SMs once (twice
//   for chains of at most 4 rows of halo); the loads go straight to
//   registers, so no staging copy (cp.async or TMA into shared memory) is
//   needed: the window is read once and kept, and the blocks of one wave
//   overlap their loads with each other's work.

#include <cuda_runtime.h>

#include <limits>

namespace {

constexpr int C = 4;             // columns a thread holds: one float4
// Rows a thread holds: 4 for chains of at most SHORT_HALO rows of halo,
// whose smaller warps hide latency better, and 6 for longer ones, whose
// windows must be tall.
constexpr int V_SHORT = 4, V_LONG = 6;
constexpr int SHORT_HALO = 20;
constexpr int WIN_W = 32 * C;    // window width: one warp spans it
constexpr int K2_THREADS = 1024; // most threads of a K2 block
constexpr int K1_THREADS = 512;  // most threads of a K1 block
constexpr int MIN_OUT_W = 32;    // narrowest output tile a launch takes
constexpr int MIN_OUT_H = 16;    // lowest output tile a launch takes
constexpr int GEN_REACH = 4;     // the generic SE: offsets within 4 cells
constexpr int GEN_SPAN = 2 * GEN_REACH + 1;
constexpr int MAX_CELLS = GEN_SPAN * GEN_SPAN - 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;  // a block's shared memory on Hopper
constexpr float NEG_INF = -std::numeric_limits<float>::infinity();

// The SE's cells besides the anchor, for the generic kernel.
struct SeList {
  int n;
  signed char dy[MAX_CELLS], dx[MAX_CELLS];
};

struct Geom {
  int H, W, iters;
  int out_w, out_h;  // the output tile of a block
  int left, top;     // halo columns left of the tile, rows above it
  int up, down;      // rows a step reads above and below a cell
  int vec;           // rows start 16-byte aligned: float4 loads, stores
  int neg;           // K2 erodes: it dilates -x and stores the negation
};

// Structuring elements. E is the window around output row r: E[r + dy][x
// + dx] is the cell (dy, dx) away from column x = c + LEFT of the thread.
// EXT_EDGE: whether the rows from the neighbouring warps need their
// horizontal neighbours too (two warp shuffles a row).
struct Cross {  // ellipse_offsets(3) == cross_offsets(3)
  static constexpr int UP = 1, DOWN = 1, LEFT = 1, RIGHT = 1;
  static constexpr bool EXT_EDGE = false;
  template <int EW>
  __device__ __forceinline__ static float apply(const float (*E)[EW], int r,
                                                int x, const SeList&) {
    return fmaxf(fmaxf(E[r][x - 1], E[r][x + 1]),
                 fmaxf(E[r][x], fmaxf(E[r - 1][x], E[r + 1][x])));
  }
};

struct Ellipse4 {  // ellipse_offsets(4): anchored at (2, 2) of a 4x4 grid
  static constexpr int UP = 2, DOWN = 0, LEFT = 2, RIGHT = 0;
  static constexpr bool EXT_EDGE = true;
  template <int EW>
  __device__ __forceinline__ static float apply(const float (*E)[EW], int r,
                                                int x, const SeList&) {
    // (0,0) (0,-1) (-1,-2) (-1,-1) (-1,0) (-2,-1)
    return fmaxf(fmaxf(fmaxf(E[r][x], E[r][x - 1]),
                       fmaxf(E[r - 1][x - 2], E[r - 1][x - 1])),
                 fmaxf(E[r - 1][x], E[r - 2][x - 1]));
  }
};

struct Generic {  // any SE within GEN_REACH cells of its anchor
  static constexpr int UP = GEN_REACH, DOWN = GEN_REACH, LEFT = GEN_REACH,
                       RIGHT = GEN_REACH;
  static constexpr bool EXT_EDGE = true;
  template <int EW>
  __device__ __forceinline__ static float apply(const float (*E)[EW], int r,
                                                int x, const SeList& m) {
    float a = E[r][x];
#pragma unroll 1
    for (int k = 0; k < m.n; ++k) a = fmaxf(a, E[r + m.dy[k]][x + m.dx[k]]);
    return a;
  }
};

// Row y of src at the thread's columns x0..x0+3, negated if neg; cells
// outside the image read as -inf.
__device__ __forceinline__ void load_row(const float* __restrict__ src,
                                         const Geom& g, int y, int x0,
                                         bool neg, float (&a)[C]) {
  const float sign = neg ? -1.f : 1.f;  // exact: a sign flip
#pragma unroll
  for (int c = 0; c < C; ++c) a[c] = NEG_INF;
  if (y < 0 || y >= g.H) return;
  const float* row = src + static_cast<size_t>(y) * g.W;
  if (g.vec && x0 >= 0 && x0 + C <= g.W) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + x0));
    a[0] = sign * q.x; a[1] = sign * q.y; a[2] = sign * q.z;
    a[3] = sign * q.w;
    return;
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (x0 + c >= 0 && x0 + c < g.W) a[c] = sign * __ldg(row + x0 + c);
}

// e = [lane - 1's last L cells | the row | lane + 1's first R cells]. The
// window's edge lanes read their own cells there: garbage that spreads one
// reach an iteration, so it never reaches the output tile.
template <int L, int R, int EW>
__device__ __forceinline__ void extend(float (&e)[EW], const float (&a)[C]) {
#pragma unroll
  for (int k = 0; k < L; ++k) e[k] = __shfl_up_sync(FULL, a[C - L + k], 1);
#pragma unroll
  for (int c = 0; c < C; ++c) e[L + c] = a[c];
#pragma unroll
  for (int k = 0; k < R; ++k) e[L + C + k] = __shfl_down_sync(FULL, a[k], 1);
}

// A neighbouring warp's row into e: extended if the SE reads its
// horizontal neighbours, else the centre cells alone (the rest unread).
template <class SE, int EW>
__device__ __forceinline__ void edge_row(float (&e)[EW], float4 q,
                                         bool have) {
  float a[C] = {q.x, q.y, q.z, q.w};
  if (!have) {  // above the window's first warp, below its last: garbage
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = NEG_INF;
  }
  if (SE::EXT_EDGE) {
    extend<SE::LEFT, SE::RIGHT>(e, a);
  } else {
#pragma unroll
    for (int k = 0; k < EW; ++k) e[k] = NEG_INF;
#pragma unroll
    for (int c = 0; c < C; ++c) e[SE::LEFT + c] = a[c];
  }
}

// One iteration of chain ch: rows [lo, hi) of the image are updated in
// place. s holds every warp's published edge rows (see the kernel).
template <class SE, int NCH, int V>
__device__ __forceinline__ void step(float (&v)[V][C], int ch,
                                     const float4* s, int warp, int nw,
                                     int y0, int lo, int hi, bool clamp_x,
                                     const bool (&col_in)[C],
                                     const SeList& m) {
  constexpr int U = SE::UP, D = SE::DOWN, L = SE::LEFT, R = SE::RIGHT;
  constexpr int X = U + D, EW = L + C + R;
  const int lane = threadIdx.x;
  const float4 none = make_float4(0.f, 0.f, 0.f, 0.f);
  float E[U + V + D][EW];
  // rows above: warp - 1's bottom U rows, published at k = 0..U-1
#pragma unroll
  for (int j = -U; j < 0; ++j)
    edge_row<SE>(E[j + U],
                 warp > 0 ? s[(((warp - 1) * NCH + ch) * X + U + j) * 32 +
                              lane]
                          : none,
                 warp > 0);
#pragma unroll
  for (int j = 0; j < D; ++j) extend<L, R>(E[j + U], v[j]);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    // the row D below row i enters the window before row i is overwritten
    const int j = i + D;
    if (j >= V) {
      const bool have = warp + 1 < nw;
      edge_row<SE>(E[j + U],
                   have ? s[(((warp + 1) * NCH + ch) * X + U + j - V) * 32 +
                            lane]
                        : none,
                   have);
    } else {
      extend<L, R>(E[j + U], v[j < V ? j : V - 1]);
    }
    const int y = y0 + i;
    if (y >= lo && y < hi) {  // warp-uniform
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float n = SE::template apply<EW>(E, i + U, c + L, m);
        v[i][c] = (clamp_x && !col_in[c]) ? NEG_INF : n;
      }
    }
  }
}

// One block: the window of rows [oy - top, oy - top + V * nw) and columns
// [ox - left, ox - left + 128) around the output tile at (oy, ox). Warp w
// holds window rows V w .. V w + V - 1, lane l columns 4l..4l+3. TRI: K1,
// whose chain 0 dilates in and chain 1 dilates -in_e.
template <class SE, bool TRI, int V>
__global__ void __launch_bounds__(TRI ? K1_THREADS : K2_THREADS)
morph_kernel(const float* __restrict__ in, const float* __restrict__ in_e,
             float* __restrict__ out, Geom g, SeList m) {
  constexpr int NCH = TRI ? 2 : 1;
  constexpr int U = SE::UP, D = SE::DOWN, X = U + D;
  // [2 buffers][nw warps][NCH chains][X rows][32 lanes]: a warp publishes
  // its bottom U rows (k < U, read by the warp below as the rows above it)
  // and its top D rows (k >= U, read by the warp above)
  extern __shared__ float4 xch[];
  const int lane = threadIdx.x, warp = threadIdx.y, nw = blockDim.y;
  const size_t plane = static_cast<size_t>(g.H) * g.W;
  in += blockIdx.z * plane;
  in_e += blockIdx.z * plane;
  out += blockIdx.z * plane;
  const int ox = blockIdx.x * g.out_w, oy = blockIdx.y * g.out_h;
  const int x0 = ox - g.left + lane * C;
  const int y0 = oy - g.top + warp * V;

  float v[NCH][V][C];
#pragma unroll
  for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
    for (int i = 0; i < V; ++i)
      load_row(ch ? in_e : in, g, y0 + i, x0, ch == 1 || g.neg, v[ch][i]);

  // blocks whose window crosses a side of the image keep those columns at
  // -inf (block-uniform)
  const bool clamp_x = ox - g.left < 0 || ox - g.left + WIN_W > g.W;
  bool col_in[C];
#pragma unroll
  for (int c = 0; c < C; ++c) col_in[c] = x0 + c >= 0 && x0 + c < g.W;

  for (int t = 1; t <= g.iters; ++t) {
    float4* s = xch + static_cast<size_t>(t & 1) * nw * NCH * X * 32;
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
#pragma unroll
      for (int k = 0; k < X; ++k) {
        const float* r = v[ch][k < U ? V - U + k : k - U];
        s[((warp * NCH + ch) * X + k) * 32 + lane] =
            make_float4(r[0], r[1], r[2], r[3]);
      }
    __syncthreads();
    // the rows iteration t must get right: those the remaining
    // iterations read to produce the output tile
    const int lo = max(0, oy - (g.iters - t) * g.up);
    const int hi = min(g.H, oy + g.out_h + (g.iters - t) * g.down);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch)
      step<SE, NCH, V>(v[ch], ch, s, warp, nw, y0, lo, hi, clamp_x, col_in,
                       m);
  }

  // halos round to 4 columns, so a lane's 4 columns are all in the output
  // tile or all out of it
  if (x0 < ox || x0 >= ox + g.out_w) return;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int y = y0 + i;
    if (y < oy || y >= oy + g.out_h || y >= g.H) continue;
    float r[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (TRI) {  // dilate v[0], erode -v[1]
        const float tri = -v[NCH - 1][i][c] > 127.f ? 255.f : 128.f;
        r[c] = v[0][i][c] < 128.f ? 0.f : tri;
      } else {
        r[c] = g.neg ? -v[0][i][c] : v[0][i][c];
      }
    }
    float* row = out + static_cast<size_t>(y) * g.W;
    if (g.vec && x0 + C <= g.W) {
      *reinterpret_cast<float4*>(row + x0) = make_float4(r[0], r[1], r[2],
                                                         r[3]);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        if (x0 + c < g.W) row[x0 + c] = r[c];
    }
  }
}

// -- host --------------------------------------------------------------------

enum SeKind { SE_CROSS, SE_ELLIPSE4, SE_GENERIC };

struct Se {
  SeKind kind;
  SeList list;
  int up, down, left, right;  // reach of one step, anchor included
};

int cdiv(int a, int b) { return (a + b - 1) / b; }
int round4(int v) { return (v + 3) & ~3; }

// The SE from the host's (dy, dx) pairs (repeats and the anchor dropped);
// false when a cell lies more than GEN_REACH from the anchor.
bool make_se(const int* offs, int n_offs, Se* se) {
  static const int cross[][2] = {{-1, 0}, {0, -1}, {0, 1}, {1, 0}};
  static const int ell4[][2] = {{-2, -1}, {-1, -2}, {-1, -1}, {-1, 0},
                                {0, -1}};
  bool on[GEN_SPAN][GEN_SPAN] = {};
  for (int i = 0; i < n_offs; ++i) {
    const int dy = offs[2 * i], dx = offs[2 * i + 1];
    if (dy < -GEN_REACH || dy > GEN_REACH || dx < -GEN_REACH ||
        dx > GEN_REACH)
      return false;
    on[dy + GEN_REACH][dx + GEN_REACH] = dy || dx;
  }
  se->list.n = 0;
  se->up = se->down = se->left = se->right = 0;
  for (int dy = -GEN_REACH; dy <= GEN_REACH; ++dy)
    for (int dx = -GEN_REACH; dx <= GEN_REACH; ++dx) {
      if (!on[dy + GEN_REACH][dx + GEN_REACH]) continue;
      se->list.dy[se->list.n] = static_cast<signed char>(dy);
      se->list.dx[se->list.n] = static_cast<signed char>(dx);
      ++se->list.n;
      se->up = -dy > se->up ? -dy : se->up;
      se->down = dy > se->down ? dy : se->down;
      se->left = -dx > se->left ? -dx : se->left;
      se->right = dx > se->right ? dx : se->right;
    }
  auto is = [&](const int (*cells)[2], int n) {
    if (se->list.n != n) return false;
    for (int i = 0; i < n; ++i)
      if (!on[cells[i][0] + GEN_REACH][cells[i][1] + GEN_REACH]) return false;
    return true;
  };
  se->kind = is(cross, 4) ? SE_CROSS : is(ell4, 5) ? SE_ELLIPSE4 : SE_GENERIC;
  return true;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 1;
  }
  return n;
}

// Rows a kernel's exchange buffer holds per warp (the template's reach).
int exchange_rows(SeKind k) {
  return k == SE_CROSS ? Cross::UP + Cross::DOWN
         : k == SE_ELLIPSE4 ? Ellipse4::UP + Ellipse4::DOWN
                            : Generic::UP + Generic::DOWN;
}

size_t smem_bytes(SeKind k, bool tri, int nw) {
  return 2 * static_cast<size_t>(nw) * (tri ? 2 : 1) * exchange_rows(k) *
         32 * sizeof(float4);
}

int max_warps(SeKind k, bool tri) {
  int nw = (tri ? K1_THREADS : K2_THREADS) / 32;
  while (nw > 1 && smem_bytes(k, tri, nw) > SMEM_MAX) --nw;
  return nw;
}

// Rows a thread holds in a launch of `iters` iterations.
int rows_per_thread(const Se& se, int iters) {
  return iters * (se.up + se.down) <= SHORT_HALO ? V_SHORT : V_LONG;
}

// Whether one launch carries `iters` iterations: the halos leave an output
// tile of at least MIN_OUT_W x MIN_OUT_H.
bool fits(const Se& se, bool tri, int iters) {
  return WIN_W - round4(iters * se.left) - round4(iters * se.right) >=
             MIN_OUT_W &&
         max_warps(se.kind, tri) * rows_per_thread(se, iters) -
                 iters * (se.up + se.down) >=
             MIN_OUT_H;
}

// The most iterations one launch carries.
int per_launch(const Se& se, bool tri) {
  if (se.up + se.down + se.left + se.right == 0) return 1 << 30;
  int n = 1;
  while (fits(se, tri, n + 1)) ++n;
  return n;
}

struct Launch {
  Geom g;
  int v;  // rows a thread holds
  dim3 grid, block;
  size_t smem;
};

// Tiles of one launch of `iters` (<= per_launch) iterations: 128 window
// columns less the halos wide, and as high as fills the card's SMs with
// one block each (two for short chains), or
// higher where the batch needs more than that of the highest tiles.
Launch plan(const Se& se, bool tri, int H, int W, int B, int iters,
            bool vec, bool neg) {
  Launch l;
  Geom& g = l.g;
  g.H = H;
  g.W = W;
  g.iters = iters;
  g.up = se.up;
  g.down = se.down;
  g.top = iters * se.up;
  g.left = round4(iters * se.left);
  g.vec = vec;
  g.neg = neg;
  const int bottom = iters * se.down;
  const int V = l.v = rows_per_thread(se, iters);
  g.out_w = WIN_W - g.left - round4(iters * se.right);
  const int out_h_max = max_warps(se.kind, tri) * V - g.top - bottom;
  const int ncols = cdiv(W, g.out_w);
  // chains of at most 4 rows of halo are memory-bound: two blocks an SM
  const int per_sm = g.top + bottom <= 4 ? 2 : 1;
  const int per_item = sm_count() * per_sm / (B * ncols);
  int rows = cdiv(H, out_h_max);
  if (per_item > rows) rows = per_item < H ? per_item : H;
  g.out_h = cdiv(H, rows);
  rows = cdiv(H, g.out_h);
  const int nw = cdiv(g.out_h + g.top + bottom, V);
  l.grid = dim3(ncols, rows, B);
  l.block = dim3(32, nw);
  l.smem = smem_bytes(se.kind, tri, nw);
  return l;
}

template <class SE, bool TRI, int V>
cudaError_t launch_v(const Launch& l, const float* in, const float* in_e,
                     float* out, const SeList& m, cudaStream_t stream) {
  static size_t smem_set = 48 * 1024;
  if (l.smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        morph_kernel<SE, TRI, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(l.smem));
    if (err != cudaSuccess) return err;
    smem_set = l.smem;
  }
  morph_kernel<SE, TRI, V><<<l.grid, l.block, l.smem, stream>>>(
      in, in_e, out, l.g, m);
  return cudaGetLastError();
}

template <class SE, bool TRI>
cudaError_t launch_as(const Launch& l, const float* in, const float* in_e,
                      float* out, const SeList& m, cudaStream_t stream) {
  return l.v == V_SHORT
             ? launch_v<SE, TRI, V_SHORT>(l, in, in_e, out, m, stream)
             : launch_v<SE, TRI, V_LONG>(l, in, in_e, out, m, stream);
}

// One launch: K2 (dilate, or erode if neg) of in, or K1 (tri) of the
// dilate chain's in and the erode chain's in_e.
cudaError_t launch(const Se& se, bool tri, int H, int W, int B, int iters,
                   bool neg, const float* in, const float* in_e, float* out,
                   cudaStream_t stream) {
  const bool vec = W % 4 == 0 &&
                   ((reinterpret_cast<size_t>(in) |
                     reinterpret_cast<size_t>(in_e) |
                     reinterpret_cast<size_t>(out)) & 15) == 0;
  const Launch l = plan(se, tri, H, W, B, iters, vec, neg);
  const SeList& m = se.list;
  switch (se.kind) {
    case SE_CROSS:
      return tri ? launch_as<Cross, true>(l, in, in_e, out, m, stream)
                 : launch_as<Cross, false>(l, in, in_e, out, m, stream);
    case SE_ELLIPSE4:
      return tri ? launch_as<Ellipse4, true>(l, in, in_e, out, m, stream)
                 : launch_as<Ellipse4, false>(l, in, in_e, out, m, stream);
    default:
      return tri ? launch_as<Generic, true>(l, in, in_e, out, m, stream)
                 : launch_as<Generic, false>(l, in, in_e, out, m, stream);
  }
}

// `iters` iterations from in to out as ceil(iters / per_launch) launches
// of near-equal length, ping-ponging through tmp so that the last one
// writes out. Adds the number of launches to *launches.
cudaError_t morph_chain(const float* in, float* out, float* tmp, int H,
                        int W, int B, const Se& se, int iters, bool dilate,
                        cudaStream_t stream, int* launches) {
  const int n_launch = iters <= 0 ? 1 : cdiv(iters, per_launch(se, false));
  if (n_launch > 1 && tmp == nullptr) return cudaErrorInvalidValue;
  const float* src = in;
  for (int j = 0; j < n_launch; ++j) {
    const int n = iters / n_launch + (j < iters % n_launch);
    float* dst = ((n_launch - 1 - j) % 2 == 0) ? out : tmp;
    const cudaError_t err =
        launch(se, false, H, W, B, n, !dilate, src, src, dst, stream);
    if (err != cudaSuccess) return err;
    ++*launches;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Every entry sets *launches (a host int) to the number of kernels it
// launched on `stream`. Tensors are (B, H, W) f32, contiguous.

// K2: out = dilate (or erode) of in, `iters` times. tmp is a scratch
// tensor of in's shape, used when the chain takes more than one launch
// (more than 48 iterations of the cross). offs holds n_offs (dy, dx) pairs.
int vut_morph(const float* in, float* out, float* tmp, int H, int W, int B,
              const int* offs, int n_offs, int iters, int dilate,
              void* stream, int* launches) {
  *launches = 0;
  Se se;
  if (H <= 0 || W <= 0 || B <= 0 || iters < 0 ||
      !make_se(offs, n_offs, &se))
    return cudaErrorInvalidValue;
  return morph_chain(in, out, tmp, H, W, B, se, iters, dilate != 0,
                     static_cast<cudaStream_t>(stream), launches);
}

// K1: the {0, 128, 255} trimap of in, one launch while the chains fit it.
// tmp_d and tmp_e are scratch tensors of in's shape, used for longer
// chains: they then start as K2 launches and the last per_launch
// iterations run fused with the select.
int vut_trimap(const float* in, float* out, float* tmp_d, float* tmp_e,
               int H, int W, int B, const int* offs, int n_offs, int iters,
               void* stream, int* launches) {
  *launches = 0;
  Se se;
  if (H <= 0 || W <= 0 || B <= 0 || iters < 0 ||
      !make_se(offs, n_offs, &se))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fused = per_launch(se, true);
  const int last = iters < fused ? iters : fused;
  const float* dsrc = in;
  const float* esrc = in;
  if (iters > last) {
    if (tmp_d == nullptr || tmp_e == nullptr) return cudaErrorInvalidValue;
    // out is free until the final launch: it serves as the chains' scratch
    cudaError_t err = morph_chain(in, tmp_d, out, H, W, B, se, iters - last,
                                  true, s, launches);
    if (err != cudaSuccess) return err;
    err = morph_chain(in, tmp_e, out, H, W, B, se, iters - last, false, s,
                      launches);
    if (err != cudaSuccess) return err;
    dsrc = tmp_d;
    esrc = tmp_e;
  }
  const cudaError_t err =
      launch(se, true, H, W, B, last, false, dsrc, esrc, out, s);
  if (err != cudaSuccess) return err;
  *launches += 1;
  return cudaSuccess;
}

const char* vut_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
