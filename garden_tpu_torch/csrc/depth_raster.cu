// Depth-only raster of the shadow-cascade atlas for Hopper (sm_90a).
//
// Replaces three TPU Pallas kernels of garden_tpu/render/raster.py:
//   depth_super_kernel  <- _depth_super_kernel (split pass 1, from
//                          _rasterize_depth_split): every atlas tile
//                          max-reduces the big list of its super-tile;
//   depth_grid_kernel   <- _depth_grid_kernel (split pass 2): each active
//                          tile max-merges its own list onto pass 1's output,
//                          in place, with an early exit;
//   depth_dense_kernel  <- _depth_kernel (rasterize_depth's dense path): every
//                          tile draws the shared big list, then its own list
//                          with the same early exit.
// Their plain PyTorch versions are depth_super_plain, depth_grid_plain and
// depth_dense_plain in garden_tpu_torch/render/raster.py; kernel and plain
// version must agree bit for bit.
//
// What each computes. A record is a triangle's 16 floats in edge-coefficient
// form (raster._pack_edge_records). Per record and pixel centre (px, py):
//   e0 = a0 px + b0 py + c0, e1 = a1 px + b1 py + c1, e2 = S - e0 - e1,
//   z  = z2 + e0 inv_area dz0 + e1 inv_area dz1   (reverse-Z, larger = nearer),
//   candidate when e0, e1, e2 >= 0, 0 < z <= 1, id >= 0 and, with atlas rects,
//   (px, py) lies in the rect of the record's cascade (lane 15);
//   depth = max(depth, candidate ? z : 0).
// Lists are walked in blocks of 16 slots, as the TPU kernels do. The early
// exit is the TPU kernels' own: after grid block cb a tile stops once the
// smallest depth over all its pixels (the padding past the frame included)
// is >= bound[cb + 1], the suffix max of the remaining blocks' zmax. Only
// the same rule at the same 16-slot granularity gives the same result:
// zmax = z2 + max(dz0, dz1, 0) is not a rounding-safe bound, so stopping
// elsewhere could change a pixel by an ulp.
//
// What bounds them on the H100. Per (slot, pixel) ~25 float operations and
// no memory traffic: the work is ALU-bound in tiles x slots x pixels (3072
// tiles of 128x16 x <= 64 big slots in pass 1 of the flagship atlas; <= 768
// tiles x <= 64 slots in pass 2; 768 tiles of 128x128 x (64 + 256) slots in
// the dense default). With -fmad=false each counted operation is one
// instruction while the card's 67 TFLOP/s counts an FMA as two, so such a
// kernel reaches at most ~50% of its operations bound unless it skips
// work. Bytes are small: each tile reads its list's records once (64 B a
// slot) and writes its pixels once.
//
// What the design does about it. One 256-thread block per tile. Tile widths
// divide 256, so a thread keeps one pixel column and P = tile pixels / 256
// rows of it (8 for 128x16, 64 for 128x128) with their running maxima in
// registers; only py changes along them. Pixels of a warp are 32
// consecutive columns, so loads and stores of the depth image are
// coalesced. Built with -fmad=false so each multiply and add rounds as the
// plain version's separate PyTorch ops do.
// - depth_super and depth_grid stage their tile's records once into shared
//   memory and walk every slot (merge_records; empty slots skipped by a
//   block-uniform branch); every thread reads the same record at the same
//   time (a broadcast). The early exit takes a block-wide min (warp
//   shuffles, then shared memory) once per 16-slot block.
// - depth_dense first culls its scanned slots (the big list's used blocks,
//   then the grid blocks), one thread a slot, exactly (cull.cuh): a slot
//   whose edges cannot all be >= 0 at any pixel centre of the tile, or
//   whose cascade rect the tile misses, cannot raise a depth. The
//   survivors are compacted into shared memory in list order (warp ballots
//   and a block prefix sum), each flagged when the tile lies wholly inside
//   its rect (the per-pixel rect test then drops out), and only they are
//   walked. On the translucent shadow map most tiles keep no slot and just
//   store zeros. The early exit stays at the original 16-slot block ends:
//   after every grid block the tile minimum is compared with bound[cb + 1]
//   as merge_grid does, a block the cull emptied reuses the last minimum
//   (its depths did not change), and the walk ends once no survivor is
//   left. `kept` (optional) receives each tile's survivor count.

#include <cuda_runtime.h>
#include <math.h>

#include "cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdge = 16;
constexpr int kBlock = 16;
constexpr int kMaxRects = 8;
constexpr int kMaxSlots = 1024;          // depth_dense: n_big + cap

// Per-block state shared by the three kernels.
struct Shared {
  float rects[kMaxRects][4];  // atlas rects: x0 x1 y0 y1
  float red[kWarps];          // block-min scratch
};

// The pixels of this thread inside its tile: one column, rows
// row0, row0 + rstep, ... (tile_w divides kThreads).
struct Pixels {
  int col, row0, rstep;
  float px, py0;
};

__device__ __forceinline__ Pixels tile_pixels(int tx, int ty, int tile_w,
                                              int tile_h) {
  Pixels p;
  p.col = threadIdx.x % tile_w;
  p.row0 = threadIdx.x / tile_w;
  p.rstep = kThreads / tile_w;
  p.px = (float)(tx * tile_w + p.col) + 0.5f;
  p.py0 = (float)(ty * tile_h + p.row0) + 0.5f;
  return p;
}

__device__ __forceinline__ void load_rects(Shared& sh, const float* rects,
                                           int n_rects) {
  if (threadIdx.x < n_rects * 4) sh.rects[threadIdx.x / 4][threadIdx.x % 4] = rects[threadIdx.x];
}

// Stage list slots [0, n) into shared records; -1 slots get the sentinel row.
__device__ __forceinline__ void stage(const float* __restrict__ records,
                                      const int* __restrict__ list, int n,
                                      int t_count, float* s_rec) {
  for (int i = threadIdx.x; i < n * kEdge; i += kThreads) {
    const int t = list[i / kEdge];
    const int row = t >= 0 ? t : t_count;
    s_rec[i] = records[(size_t)row * kEdge + i % kEdge];
  }
}

// Max-merge staged records [s0, s1) into this thread's P pixels. This is the
// per-record test all three kernels share.
template <int P>
__device__ __forceinline__ void merge_records(const float* s_rec, int s0,
                                              int s1, const Shared& sh,
                                              int n_rects, const Pixels& pix,
                                              float (&depth)[P]) {
  for (int s = s0; s < s1; ++s) {
    const float* d = s_rec + s * kEdge;
    if (!(d[14] >= 0.0f)) continue;        // empty slot: block-uniform
    float y_lo = -INFINITY, y_hi = INFINITY;
    if (n_rects > 0) {
      float x0 = 0.0f, x1 = 0.0f, y0 = 0.0f, y1 = 0.0f;
      for (int c = 0; c < n_rects; ++c) {
        if (d[15] == (float)c) {
          x0 = sh.rects[c][0];
          x1 = sh.rects[c][1];
          y0 = sh.rects[c][2];
          y1 = sh.rects[c][3];
        }
      }
      if (!(pix.px >= x0 && pix.px < x1)) continue;   // this thread's column
      y_lo = y0;
      y_hi = y1;
    }
    const float ax0 = d[0] * pix.px, ax1 = d[1] * pix.px;
    const float b0 = d[3], b1 = d[4], c0 = d[6], c1 = d[7];
    const float sum = d[9], z2 = d[10], dz0 = d[11], dz1 = d[12];
    const float inv_area = d[13];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float py = pix.py0 + (float)(i * pix.rstep);
      const float e0 = ax0 + b0 * py + c0;
      const float e1 = ax1 + b1 * py + c1;
      const float e2 = sum - e0 - e1;
      const float z = z2 + e0 * inv_area * dz0 + e1 * inv_area * dz1;
      const bool cand = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z <= 1.0f &&
                        z > 0.0f && py >= y_lo && py < y_hi;
      depth[i] = fmaxf(depth[i], cand ? z : 0.0f);
    }
  }
}

// Smallest depth over the whole tile; the same value in every thread.
template <int P>
__device__ __forceinline__ float tile_min(const float (&depth)[P], Shared& sh) {
  float m = depth[0];
#pragma unroll
  for (int i = 1; i < P; ++i) m = fminf(m, depth[i]);
  for (int o = 16; o > 0; o >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __syncthreads();                        // the previous readers are done
  if ((threadIdx.x & 31) == 0) sh.red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = sh.red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fminf(m, sh.red[w]);
  return m;
}

// Merge the grid list's blocks [0, n_blocks) staged at s_rec[base..], stopping
// after block cb once the tile's minimum depth is >= bound[cb + 1].
template <int P>
__device__ __forceinline__ void merge_grid(const float* s_rec, int base,
                                           int n_blocks, const float* bound,
                                           Shared& sh, int n_rects,
                                           const Pixels& pix, float (&depth)[P]) {
  for (int cb = 0; cb < n_blocks; ++cb) {
    merge_records<P>(s_rec, base + cb * kBlock, base + (cb + 1) * kBlock, sh,
                     n_rects, pix, depth);
    if (tile_min<P>(depth, sh) >= bound[cb + 1]) break;
  }
}

template <int P>
__device__ __forceinline__ void store(float* __restrict__ img, int w_pad, int tx,
                                      int ty, int tile_w, int tile_h,
                                      const Pixels& pix, const float (&depth)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = ty * tile_h + pix.row0 + i * pix.rstep;
    img[(size_t)y * w_pad + tx * tile_w + pix.col] = depth[i];
  }
}

__device__ __forceinline__ int blocks_of(int count, int cap) {
  const int n = (count + kBlock - 1) / kBlock;
  return min(n, cap / kBlock);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
depth_super_kernel(const float* __restrict__ records,
                   const int* __restrict__ sup_tris,
                   const int* __restrict__ sup_counts, int cap, int t_count,
                   int tiles_x, int tile_w, int tile_h, int sup_x, int sup_y,
                   int sups_x, const float* __restrict__ rects, int n_rects,
                   float* __restrict__ depth_img) {
  extern __shared__ float s_rec[];
  __shared__ Shared sh;
  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.x / tiles_x;
  const int sup = (ty / sup_y) * sups_x + tx / sup_x;
  const int n = blocks_of(sup_counts[sup], cap) * kBlock;
  load_rects(sh, rects, n_rects);
  stage(records, sup_tris + (size_t)sup * cap, n, t_count, s_rec);
  __syncthreads();
  const Pixels pix = tile_pixels(tx, ty, tile_w, tile_h);
  float depth[P];
#pragma unroll
  for (int i = 0; i < P; ++i) depth[i] = 0.0f;
  merge_records<P>(s_rec, 0, n, sh, n_rects, pix, depth);
  store<P>(depth_img, tiles_x * tile_w, tx, ty, tile_w, tile_h, pix, depth);
}

template <int P>
__global__ void __launch_bounds__(kThreads)
depth_grid_kernel(const float* __restrict__ records,
                  const int* __restrict__ act_ids,
                  const int* __restrict__ act_cnt,
                  const int* __restrict__ tile_tris,
                  const float* __restrict__ bound, int cap, int t_count,
                  int tiles_x, int tile_w, int tile_h,
                  const float* __restrict__ rects, int n_rects,
                  float* __restrict__ depth_img) {
  extern __shared__ float s_rec[];
  __shared__ Shared sh;
  const int i = blockIdx.x;
  const int n_blocks = blocks_of(act_cnt[i], cap);
  if (n_blocks == 0) return;               // the tile keeps pass 1's depth
  const int tile = act_ids[i];
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int w_pad = tiles_x * tile_w;
  load_rects(sh, rects, n_rects);
  stage(records, tile_tris + (size_t)i * cap, n_blocks * kBlock, t_count, s_rec);
  const Pixels pix = tile_pixels(tx, ty, tile_w, tile_h);
  float depth[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int y = ty * tile_h + pix.row0 + k * pix.rstep;
    depth[k] = depth_img[(size_t)y * w_pad + tx * tile_w + pix.col];
  }
  __syncthreads();
  merge_grid<P>(s_rec, 0, n_blocks, bound + (size_t)i * (cap / kBlock + 1), sh,
                n_rects, pix, depth);
  store<P>(depth_img, w_pad, tx, ty, tile_w, tile_h, pix, depth);
}

// Max-merge one surviving record into this thread's P pixels: merge_records'
// per-pixel test without its empty-slot check (a survivor names a
// triangle), and the two must stay in step (the tests hold both to the
// plain versions bit for bit). Sharing one helper with merge_records
// changed depth_super's and depth_grid's code (more registers, spills) and
// slowed them by 6-10% on the card (PERF.md), so the copy stays.
// kRect: the tile straddles the record's rect, so each pixel tests it;
// otherwise the tile lies wholly inside and the test is dropped.
template <int P, bool kRect>
__device__ __forceinline__ void merge_survivor(const float* d, const Shared& sh,
                                               int n_rects, const Pixels& pix,
                                               float (&depth)[P]) {
  float y_lo = 0.0f, y_hi = 0.0f;
  if (kRect) {
    float x0 = 0.0f, x1 = 0.0f;
    for (int c = 0; c < n_rects; ++c) {
      if (d[15] == (float)c) {
        x0 = sh.rects[c][0];
        x1 = sh.rects[c][1];
        y_lo = sh.rects[c][2];
        y_hi = sh.rects[c][3];
      }
    }
    if (!(pix.px >= x0 && pix.px < x1)) return;      // this thread's column
  }
  const float ax0 = d[0] * pix.px, ax1 = d[1] * pix.px;
  const float b0 = d[3], b1 = d[4], c0 = d[6], c1 = d[7];
  const float sum = d[9], z2 = d[10], dz0 = d[11], dz1 = d[12];
  const float inv_area = d[13];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float py = pix.py0 + (float)(i * pix.rstep);
    const float e0 = ax0 + b0 * py + c0;
    const float e1 = ax1 + b1 * py + c1;
    const float e2 = sum - e0 - e1;
    const float z = z2 + e0 * inv_area * dz0 + e1 * inv_area * dz1;
    bool cand = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z <= 1.0f && z > 0.0f;
    if (kRect) cand = cand && py >= y_lo && py < y_hi;
    depth[i] = fmaxf(depth[i], cand ? z : 0.0f);
  }
}

// Max-merge the staged survivors [s0, s1); lane 14 holds 1 where the tile
// lies wholly inside the record's rect.
template <int P>
__device__ __forceinline__ void merge_survivors(const float* s_rec, int s0, int s1,
                                                const Shared& sh, int n_rects,
                                                const Pixels& pix, float (&depth)[P]) {
  for (int s = s0; s < s1; ++s) {
    const float* d = s_rec + s * kEdge;
    if (d[14] == 0.0f)                                // block-uniform
      merge_survivor<P, true>(d, sh, n_rects, pix, depth);
    else
      merge_survivor<P, false>(d, sh, n_rects, pix, depth);
  }
}

// Blocks of 256 threads resident per SM: four (at most 64 registers) up to
// 16 pixels a thread, two at 32, one at 64 (128x128 tiles, whose depths
// fill the registers).
template <int P>
__global__ void __launch_bounds__(kThreads, P <= 16 ? 4 : (P == 32 ? 2 : 1))
depth_dense_kernel(const float* __restrict__ records,
                   const int* __restrict__ tile_tris,
                   const int* __restrict__ counts,
                   const int* __restrict__ big_list,
                   const float* __restrict__ bound, int cap, int n_big,
                   int tiles_x, int tile_w, int tile_h,
                   const float* __restrict__ rects, int n_rects,
                   float* __restrict__ depth_img, int* __restrict__ kept) {
  extern __shared__ float s_rec[];         // survivors [<= n_big + cap][16]
  __shared__ Shared sh;
  __shared__ int s_blk[kMaxSlots / kBlock + 1];  // survivors before grid block cb
  __shared__ int s_warp[kWarps];
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  // the big list's used slots, counted as the reference's sum(big >= 0)
  int big_count = 0;
  for (int s0 = 0; s0 < n_big; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    big_count += __syncthreads_count(s < n_big && big_list[s] >= 0);
  }
  const int n_bigs = blocks_of(big_count, n_big) * kBlock;
  const int n_blocks = blocks_of(counts[tile], cap);
  const int n_scan = n_bigs + n_blocks * kBlock;
  load_rects(sh, rects, n_rects);
  __syncthreads();

  // the cull, one thread a slot; survivors compacted in list order, lane 14
  // (the id) then holding 1 when the tile lies wholly inside the rect; and
  // where each grid block's survivors start
  const cull::Corners corners = cull::tile_corners(tx, ty, tile_w, tile_h);
  int n_keep = 0;
  for (int s0 = 0; s0 < n_scan; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    const int id = s >= n_scan ? -1
                   : s < n_bigs ? big_list[s]
                                : tile_tris[(size_t)tile * cap + (s - n_bigs)];
    float d[16];
    int flags = 0;
    if (id >= 0) {
      cull::load_record(records, id, d);
      flags = cull::edge_flags(d, corners, &sh.rects[0][0], n_rects);
    }
    int total;
    const int pos = n_keep + cull::block_prefix<kWarps>(flags != 0, s_warp, &total);
    if (flags) {
      d[14] = (flags & cull::kInside) ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < kEdge; ++k) s_rec[pos * kEdge + k] = d[k];
    }
    if (s < n_scan && s >= n_bigs && (s - n_bigs) % kBlock == 0)
      s_blk[(s - n_bigs) / kBlock] = pos;
    n_keep += total;
  }
  if (threadIdx.x == 0) {
    s_blk[n_blocks] = n_keep;
    if (kept != nullptr) kept[tile] = n_keep;
  }
  __syncthreads();

  const Pixels pix = tile_pixels(tx, ty, tile_w, tile_h);
  float depth[P];
#pragma unroll
  for (int i = 0; i < P; ++i) depth[i] = 0.0f;
  merge_survivors<P>(s_rec, 0, s_blk[0], sh, n_rects, pix, depth);
  // the grid blocks with merge_grid's early exit, tested after every
  // original 16-slot block; a block the cull emptied leaves the depths and
  // so the tile minimum as they were
  const float* bnd = bound + (size_t)tile * (cap / kBlock + 1);
  bool have_min = false;
  float t_min = 0.0f;
  for (int cb = 0; cb < n_blocks; ++cb) {
    const int lo = s_blk[cb], hi = s_blk[cb + 1];
    if (lo == n_keep) break;                   // no survivor left to merge
    if (hi > lo) {
      merge_survivors<P>(s_rec, lo, hi, sh, n_rects, pix, depth);
      have_min = false;
    }
    if (!have_min) {
      t_min = tile_min<P>(depth, sh);
      have_min = true;
    }
    if (t_min >= bnd[cb + 1]) break;
  }
  store<P>(depth_img, tiles_x * tile_w, tx, ty, tile_w, tile_h, pix, depth);
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  }
  return cudaSuccess;
}

// P = pixels per thread; 0 when the tile is not a kernel shape.
int pixels_per_thread(int tile_w, int tile_h) {
  const int n_px = tile_w * tile_h;
  if (tile_w <= 0 || kThreads % tile_w != 0 || n_px % kThreads != 0) return 0;
  const int p = n_px / kThreads;
  return (p == 4 || p == 8 || p == 16 || p == 32 || p == 64) ? p : 0;
}

}  // namespace

#define GTT_DISPATCH(P_EXPR, LAUNCH) \
  switch (P_EXPR) {                  \
    case 4: LAUNCH(4)                \
    case 8: LAUNCH(8)                \
    case 16: LAUNCH(16)              \
    case 32: LAUNCH(32)              \
    case 64: LAUNCH(64)              \
    default: return (int)cudaErrorInvalidValue; \
  }

// C entry points (loaded with ctypes). Each returns a cudaError_t code; 0 = OK.
// depth_dense: `kept` (one int a tile, or null) receives each tile's
// surviving slots.

extern "C" int depth_super_launch(const float* records, const int* sup_tris,
                                  const int* sup_counts, int cap, int t_count,
                                  int n_tiles, int tiles_x, int tile_w,
                                  int tile_h, int sup_x, int sup_y, int sups_x,
                                  const float* rects, int n_rects,
                                  float* depth, int smem, void* stream) {
  if (n_rects > kMaxRects) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GTT_SUPER(P)                                                         \
  {                                                                          \
    cudaError_t err = prepare(depth_super_kernel<P>, smem);                  \
    if (err != cudaSuccess) return (int)err;                                 \
    depth_super_kernel<P><<<n_tiles, kThreads, smem, st>>>(                  \
        records, sup_tris, sup_counts, cap, t_count, tiles_x, tile_w, tile_h, \
        sup_x, sup_y, sups_x, rects, n_rects, depth);                        \
    return (int)cudaGetLastError();                                          \
  }
  GTT_DISPATCH(pixels_per_thread(tile_w, tile_h), GTT_SUPER)
#undef GTT_SUPER
}

extern "C" int depth_grid_launch(const float* records, const int* act_ids,
                                 const int* act_cnt, const int* tile_tris,
                                 const float* bound, int cap, int t_count,
                                 int rows, int tiles_x, int tile_w, int tile_h,
                                 const float* rects, int n_rects, float* depth,
                                 int smem, void* stream) {
  if (n_rects > kMaxRects) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GTT_GRID(P)                                                          \
  {                                                                          \
    cudaError_t err = prepare(depth_grid_kernel<P>, smem);                   \
    if (err != cudaSuccess) return (int)err;                                 \
    depth_grid_kernel<P><<<rows, kThreads, smem, st>>>(                      \
        records, act_ids, act_cnt, tile_tris, bound, cap, t_count, tiles_x,  \
        tile_w, tile_h, rects, n_rects, depth);                              \
    return (int)cudaGetLastError();                                          \
  }
  GTT_DISPATCH(pixels_per_thread(tile_w, tile_h), GTT_GRID)
#undef GTT_GRID
}

extern "C" int depth_dense_launch(const float* records, const int* tile_tris,
                                  const int* counts, const int* big_list,
                                  const float* bound, int cap, int n_big,
                                  int n_tiles, int tiles_x,
                                  int tile_w, int tile_h, const float* rects,
                                  int n_rects, float* depth, int* kept, int smem,
                                  void* stream) {
  if (n_rects > kMaxRects || n_big + cap > kMaxSlots || cap % kBlock != 0 ||
      n_big % kBlock != 0 || smem < (n_big + cap) * kEdge * 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GTT_DENSE(P)                                                         \
  {                                                                          \
    cudaError_t err = prepare(depth_dense_kernel<P>, smem);                  \
    if (err != cudaSuccess) return (int)err;                                 \
    depth_dense_kernel<P><<<n_tiles, kThreads, smem, st>>>(                  \
        records, tile_tris, counts, big_list, bound, cap, n_big, tiles_x,    \
        tile_w, tile_h, rects, n_rects, depth, kept);                        \
    return (int)cudaGetLastError();                                          \
  }
  GTT_DISPATCH(pixels_per_thread(tile_w, tile_h), GTT_DENSE)
#undef GTT_DENSE
}

#undef GTT_DISPATCH
