// 4-connected component labels with dense ids (K3) for Hopper.
//
// Replaces the Pallas TPU kernel `video_unscreen_tpu/ops/pallas/flood.py:
// _flood_kernel` (entry `connected_components_compact`). Outputs, for the
// foreground `mask > 0` of one (H, W) f32 mask:
//   labels[i]  = 1 + the largest flat index in i's component (0 off the
//                mask), the labels of `ops/connected.py:connected_components`;
//   compact[i] = the component's rank 1..K when components are ordered by
//                their last pixel (their root) in raster order.
//
// Algorithm: union-find label equivalence instead of the TPU's segmented
// max-scan sweeps, in four launches:
//   (1) `local_merge`, one 1024-thread block per 32x32 tile, one warp per
//       tile row: a ballot gives the row's foreground bits, and each pixel
//       points at the last pixel of its run in the row (runs are merged
//       with no atomics). A vertical link is made once per run of pixels
//       whose upper neighbours are foreground too, at its leftmost pixel
//       (the run-based merge of Hennequin et al., DASIP 2018, for
//       4-connectivity). The union-find lives in shared memory; every
//       pixel gets its tile root as a flat image index, -1 off the mask.
//   (2) `edge_merge`, 64 threads a tile: links across the tile's left and
//       top edges in device memory, again once per run of pixels along
//       the edge whose neighbours one step along the edge link too; its
//       walks split the paths they take, which keeps the trees that (3)
//       walks shallow.
//   (3) `compress_rank`, 1024 pixels a block: every pixel is pointed
//       straight at its root, the block counts its roots, and a single-
//       pass decoupled look-back scan (Merrill and Garland 2016; blocks
//       take their index from a ticket, so a block only waits on blocks
//       that started before it) gives each root its raster rank, written
//       at compact[root];
//   (4) `finish`: every pixel reads its root's rank; labels become root + 1.
// Links always go from the smaller root to the larger index (atomicMax), so
// every parent index is >= its child's and the root of a component is its
// largest flat index: root + 1 is the reference label exactly, whatever
// order the unions run in.
//
// A link is skipped only where it is implied by links that are never
// skipped: inside a tile, the vertical link at (x, y) when (x - 1, y) and
// (x - 1, y - 1) are foreground (the link one column left, itself made or
// implied, and the two row runs join them); on a tile edge, the link at an
// edge pixel when the edge pixel one step back along the edge, in the same
// tile, and its neighbour across the edge are foreground. The chains of
// implication run left or up inside one tile and end at a link that is
// made, so none is circular (two skips that each assumed the other would
// leave a 2x2 block at a tile corner split).
//
// Divergence from the reference: union-find always converges, while the
// TPU flood stops after 64 sweeps. The two agree on every mask that the
// reference labels within 64 sweeps (all natural mattes); on a mask that
// needs more sweeps the reference leaves a component split and this kernel
// does not.
//
// What bounds it: memory and latency. The least traffic is one read of the
// f32 mask and one write of each int32 map (12 bytes a pixel: 7.4 us at
// 1080x1920, 0.5 us at 272x480, at 3.35 TB/s). The parent array lives in
// the labels output, so the passes after the first touch device memory that
// stays in the 50 MB L2; at 272x480 the launches' fixed cost is the time.

#include <cuda_runtime.h>

namespace {

constexpr int FT = 32;          // tile edge of the local merge
constexpr int RANK_PIX = 1024;  // pixels (threads) per compress_rank block
// status words of the look-back: flag in the high 32 bits, count in the low
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long INCLUSIVE = 2ull << 32;

__device__ int find_root(volatile int* parent, int x) {
  int p = parent[x];
  while (p != x) {
    x = p;
    p = parent[x];
  }
  return x;
}

// The root of x, pointing each node on the way at its grandparent (path
// splitting) so that later walks are shorter. atomicMax keeps this safe
// beside concurrent links: a parent only ever rises to an ancestor, and a
// root (whose parent is itself) is never written here.
__device__ int find_split(int* parent, int x) {
  volatile int* vp = parent;
  int p = vp[x];
  while (true) {
    const int gp = vp[p];
    if (gp == p) return p;
    atomicMax(&parent[x], gp);
    x = p;
    p = gp;
  }
}

// Join the trees of a and b, linking the smaller root under the larger.
// If the smaller root was linked elsewhere meanwhile, atomicMax keeps the
// larger parent and the loop joins that one as well.
__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_split(parent, a);
    b = find_split(parent, b);
    if (a == b) return;
    if (a < b) {
      const int old = atomicMax(&parent[a], b);
      if (old == a) return;
      a = old;
    } else {
      const int old = atomicMax(&parent[b], a);
      if (old == b) return;
      b = old;
    }
  }
}

__device__ __forceinline__ bool bit(unsigned bits, int i) {
  return (bits >> i) & 1u;
}

// (1) Tile-local union-find over row runs; writes each foreground pixel's
// tile root as a flat image index (the local-to-image map keeps the order
// of indices), and -1 off the mask. Also clears the look-back's status
// words and ticket for (3).
__global__ void __launch_bounds__(FT * FT)
local_merge(const float* __restrict__ mask, int* parent,
            unsigned long long* status, int n_status, int* ticket, int H,
            int W) {
  __shared__ int s[FT * FT];
  __shared__ unsigned rows[FT];
  const int lx = threadIdx.x, ly = threadIdx.y, l = ly * FT + lx;
  const int x0 = blockIdx.x * FT, y0 = blockIdx.y * FT;
  const int x = x0 + lx, y = y0 + ly;
  const bool inside = x < W && y < H;
  const bool fg = inside && mask[(size_t)y * W + x] > 0.f;
  const unsigned bits = __ballot_sync(0xffffffffu, fg);
  if (lx == 0) rows[ly] = bits;
  // the run through lx ends before the first background bit at or after it
  const unsigned gap = ~bits & (0xffffffffu << lx);
  const int end = gap ? __ffs(gap) - 2 : FT - 1;
  s[l] = fg ? ly * FT + end : -1;
  const int blk = blockIdx.y * gridDim.x + blockIdx.x;
  const int n_threads = gridDim.x * gridDim.y * FT * FT;
  for (int i = blk * FT * FT + l; i < n_status; i += n_threads) status[i] = 0;
  if (blk == 0 && l == 0) *ticket = 0;
  __syncthreads();
  if (fg && ly > 0 && bit(rows[ly - 1], lx) &&
      !(lx > 0 && bit(bits, lx - 1) && bit(rows[ly - 1], lx - 1)))
    unite(s, l, l - FT);
  __syncthreads();
  if (!inside) return;
  if (fg) {
    const int r = find_root(s, l);
    parent[(size_t)y * W + x] = (y0 + r / FT) * W + x0 + r % FT;
  } else {
    parent[(size_t)y * W + x] = -1;
  }
}

// (2) Links across tile edges: thread e < 32 takes row y0 + e of the
// tile's left edge, thread 32 + e column x0 + e of its top edge.
__global__ void __launch_bounds__(2 * FT)
edge_merge(int* parent, int H, int W) {
  const int x0 = blockIdx.x * FT, y0 = blockIdx.y * FT;
  const int e = threadIdx.x & (FT - 1);
  auto fg = [&](int yy, int xx) { return parent[yy * W + xx] >= 0; };
  if (threadIdx.x < FT) {
    const int y = y0 + e;
    if (x0 == 0 || y >= H || !fg(y, x0) || !fg(y, x0 - 1)) return;
    if (e > 0 && fg(y - 1, x0) && fg(y - 1, x0 - 1)) return;
    unite(parent, y * W + x0, y * W + x0 - 1);
  } else {
    const int x = x0 + e;
    if (y0 == 0 || x >= W || !fg(y0, x) || !fg(y0 - 1, x)) return;
    if (e > 0 && fg(y0, x - 1) && fg(y0 - 1, x - 1)) return;
    unite(parent, y0 * W + x, (y0 - 1) * W + x);
  }
}

// (3) Point every foreground pixel at its root, and write each root's
// 1-based raster rank into compact[root].
__global__ void __launch_bounds__(RANK_PIX)
compress_rank(int* parent, int* compact, unsigned long long* status,
              int* ticket, int n) {
  __shared__ int s_blk, s_prefix;
  __shared__ int warp_base[RANK_PIX / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_blk = atomicAdd(ticket, 1);
  __syncthreads();
  const int blk = s_blk;
  const int i = blk * RANK_PIX + threadIdx.x;
  bool is_root = false;
  if (i < n) {
    const int p = parent[i];
    is_root = p == i;
    if (p >= 0 && !is_root) parent[i] = find_root(parent, i);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, is_root);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    // exclusive scan of the warps' counts, and the block's total
    const int c = warp_base[lane];
    int x = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    warp_base[lane] = x - c;
    const int total = __shfl_sync(0xffffffffu, x, 31);
    int prefix = 0;
    if (blk > 0) {
      if (lane == 0) atomicExch(&status[blk], AGGREGATE | (unsigned)total);
      // look back over windows of 32 predecessors: add aggregates up to
      // the nearest inclusive prefix; spin while one has published nothing
      for (int base = blk - 1;;) {
        const int j = base - lane;
        const unsigned long long st =
            j >= 0 ? *reinterpret_cast<volatile unsigned long long*>(
                         &status[j])
                   : static_cast<unsigned long long>(INCLUSIVE);
        const unsigned long long flag = st & ~0xffffffffull;
        if (__any_sync(0xffffffffu, flag == 0)) continue;
        const unsigned inc = __ballot_sync(0xffffffffu, flag == INCLUSIVE);
        int v = static_cast<int>(st & 0xffffffffull);
        if (inc && lane > __ffs(inc) - 1) v = 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        prefix += v;
        if (inc) break;
        base -= 32;
      }
    }
    if (lane == 0) {
      atomicExch(&status[blk], INCLUSIVE | (unsigned)(prefix + total));
      s_prefix = prefix;
    }
  }
  __syncthreads();
  if (is_root)
    compact[i] = s_prefix + warp_base[warp] +
                 __popc(ballot & ((1u << lane) - 1u)) + 1;
}

// (4) Every pixel reads its root's rank; labels become root + 1.
__global__ void finish(int* labels, int* compact, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = labels[i];
  if (r < 0) {
    labels[i] = 0;
    compact[i] = 0;
  } else {
    if (r != i) compact[i] = compact[r];  // a root holds its rank already
    labels[i] = r + 1;
  }
}

// Launch the phases on `s`; with ev non-null, record ev[0] before the
// first and ev[p + 1] after phase p. scratch holds the look-back's status
// words (8 bytes per block of RANK_PIX pixels) and its ticket. Returns the
// launches.
int launch_flood(const float* mask, int* labels, int* compact, int* scratch,
                 int H, int W, cudaStream_t s, cudaEvent_t* ev) {
  const int n = H * W;
  const dim3 tiles((W + FT - 1) / FT, (H + FT - 1) / FT);
  const int nb = (n + RANK_PIX - 1) / RANK_PIX;
  auto* status = reinterpret_cast<unsigned long long*>(scratch);
  int* ticket = scratch + 2 * nb;
  int p = 0;
  auto mark = [&]() {
    if (ev) cudaEventRecord(ev[p], s);
    ++p;
  };
  mark();
  local_merge<<<tiles, dim3(FT, FT), 0, s>>>(mask, labels, status, nb,
                                              ticket, H, W);
  mark();
  edge_merge<<<tiles, 2 * FT, 0, s>>>(labels, H, W);
  mark();
  compress_rank<<<nb, RANK_PIX, 0, s>>>(labels, compact, status, ticket, n);
  mark();
  finish<<<(n + 255) / 256, 256, 0, s>>>(labels, compact, n);
  mark();
  return p - 1;
}

bool bad_flood_shape(int H, int W) {
  return H <= 0 || W <= 0 || static_cast<long long>(H) * W > (1ll << 30);
}

}  // namespace

extern "C" {

// K3. labels and compact are (H, W) int32 outputs; scratch holds
// 2 ceil(H * W / 1024) + 1 int32, 8-byte aligned. Sets *launches (a host int) to the
// number of kernels it launched on `stream`.
int vut_flood(const float* mask, int* labels, int* compact, int* scratch,
              int H, int W, void* stream, int* launches) {
  *launches = 0;
  if (bad_flood_shape(H, W)) return cudaErrorInvalidValue;
  *launches = launch_flood(mask, labels, compact, scratch, H, W,
                           static_cast<cudaStream_t>(stream), nullptr);
  return cudaGetLastError();
}

// The names of K3's phases, in launch order, comma-separated.
const char* vut_flood_phase_names() {
  return "local_merge,edge_merge,compress_rank,finish";
}

// Measurement only: `reps` calls of K3 back to back on `stream`, with a
// CUDA event between phases; waits for them and writes each phase's mean
// device ms (event to event) to the host array phase_ms (one entry a
// launch). Queue it behind a sleep kernel so the host's launch cost stays
// out of the times. Sets *launches to one call's launches.
int vut_flood_phases(const float* mask, int* labels, int* compact,
                     int* scratch, int H, int W, int reps, void* stream,
                     float* phase_ms, int* launches) {
  *launches = 0;
  if (bad_flood_shape(H, W) || reps <= 0) return cudaErrorInvalidValue;
  constexpr int MAX_MARKS = 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaEvent_t* ev = new cudaEvent_t[reps * MAX_MARKS];
  cudaError_t err = cudaSuccess;
  int made = 0, n = 0;
  for (; made < reps * MAX_MARKS && err == cudaSuccess; ++made)
    err = cudaEventCreate(&ev[made]);
  if (err == cudaSuccess) {
    for (int r = 0; r < reps; ++r)
      n = launch_flood(mask, labels, compact, scratch, H, W, s,
                       ev + r * MAX_MARKS);
    err = cudaEventSynchronize(ev[(reps - 1) * MAX_MARKS + n]);
  }
  for (int p = 0; p < n && err == cudaSuccess; ++p) {
    float sum = 0.f;
    for (int r = 0; r < reps && err == cudaSuccess; ++r) {
      float ms = 0.f;
      err = cudaEventElapsedTime(&ms, ev[r * MAX_MARKS + p],
                                 ev[r * MAX_MARKS + p + 1]);
      sum += ms;
    }
    phase_ms[p] = sum / reps;
  }
  for (int i = 0; i < made; ++i) cudaEventDestroy(ev[i]);
  delete[] ev;
  *launches = n;
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // extern "C"
