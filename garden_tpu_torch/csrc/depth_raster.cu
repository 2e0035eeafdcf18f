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
// is >= bound[cb + 1], the suffix max of the remaining blocks' zmax.
//
// Why skipping slots is exact. Each kernel first culls its tile's scanned
// slots (cull.cuh): a slot whose edges cannot all be >= 0 at any pixel
// centre of the tile, or whose cascade rect the tile misses, is never a
// candidate there, so it takes fmaxf(d, 0) = d for every depth d >= 0
// (depths start at +0.0 and only rise; no -0.0 arises). The survivors are
// compacted into shared memory in list order, but order does not matter to
// a max: it is exact and commutative, so any subset of non-candidates may
// go. The early exit is another matter: zmax = z2 + max(dz0, dz1, 0) is not
// a rounding-safe bound, so only the same rule at the same 16-slot
// granularity gives the same result, and stopping elsewhere could change a
// pixel by an ulp. So the exit stays at the ORIGINAL block ends: after
// every grid block the tile minimum is compared with bound[cb + 1], a block
// the cull emptied reuses the last minimum (its depths did not change, so
// neither did the minimum the plain version takes there), and the walk ends
// once no survivor is left (the remaining blocks change nothing, exit or
// not).
//
// What bounds them on the H100. Per (slot, pixel) ~25 float operations and
// no memory traffic: ALU-bound in tiles x slots x pixels, with -fmad=false
// each counted operation one instruction while the card's 67 TFLOP/s
// counts an FMA as two, so a kernel that keeps its operation count reaches
// at most ~50% of an operations bound: past that only skipping work helps.
// Bytes are small (each tile reads its list's records once, 64 B a slot,
// and writes its pixels once) except depth_super's output, the whole atlas
// (25 MB at 3072x2048), which sets its bound once the cull has removed
// most of its pairs. The first design walked every slot of every list at
// every pixel: depth_super's lists come from a bounding-box test over a
// whole super-tile (4x8 atlas tiles), so most of their casters reach few of
// its 32 tiles (on the flagship atlas 28.7% of the named slots reach the
// tile), and depth_grid's from the corner binning, which admits a small
// caster by its footprint, not its edges; the longest lists (64 slots x
// 2048 pixels) ended the launch.
//
// What the design does about it. One 256-thread block per tile (depth_grid:
// per active row). Tile widths divide 256, so a thread keeps one pixel
// column and P = tile pixels / 256 rows of it (8 for 128x16, 64 for
// 128x128) with their running maxima in registers; only py changes along
// them. Pixels of a warp are 32 consecutive columns, so loads and stores of
// the depth image are coalesced. Built with -fmad=false so each multiply
// and add rounds as the plain version's separate PyTorch ops do.
// 1. The cull (cull_compact, shared by the three): one thread a scanned
//    slot (depth_dense: the big list's used blocks, then the grid blocks),
//    the survivors compacted in list order (warp ballots and a block prefix
//    sum), each flagged in lane 14 (the id, no longer needed) when the tile
//    lies wholly inside its rect, so the per-pixel rect test drops out.
//    `kept` (optional, one int a tile or active row) receives the count.
// 2. depth_super and depth_grid then cull once more per warp (mark_warps):
//    one thread a (survivor, warp) pair tests the survivor against the
//    bounding rect of that warp's pixel centres, by the same exact
//    argument, and sets the warp's bit in lane 14. A warp skips a survivor
//    whose bit is clear (a warp-uniform branch): at 128x16 a warp holds 32
//    columns, and on the flagship atlas those keep about half (depth_super)
//    and a third (depth_grid) of the tile's kept (slot, pixel) pairs. On
//    each of its pixel rows a warp then votes, and where no lane's pixel
//    is inside the triangle it skips the depth (no lane is a candidate, so
//    every depth keeps its value). Without the two skips depth_super ran
//    0.026 ms and depth_grid 0.052 on the flagship atlas, with them 0.021
//    and 0.034 (PERF.md).
// 3. The walk: every thread of a warp reads the same record at the same
//    time (a broadcast). depth_super has no exit, and a tile that keeps no
//    slot stores zeros. depth_grid and depth_dense keep the early exit at
//    the original block ends (walk_grid); the block-wide minimum is warp
//    shuffles, then shared memory. A depth_grid row that keeps no slot
//    neither reads nor writes the image (the update is in place). On the
//    translucent shadow map most depth_dense tiles keep no slot and just
//    store zeros.

#include <cuda_runtime.h>
#include <math.h>

#include "cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdge = 16;
constexpr int kBlock = 16;
constexpr int kMaxRects = 8;
constexpr int kMaxSlots = 1024;          // depth_dense: n_big + cap; depth_grid: cap

// Blocks of 256 threads resident per SM (at most 64 registers for four).
// depth_dense: four up to 16 pixels a thread, two at 32, one at 64 (128x128
// tiles, whose depths fill the registers). depth_super and depth_grid, whose
// warp marks and row votes take more registers: four at 8 (128x16 tiles)
// and below; at 16 (128x32) four spill depth_grid, so one from there.
template <int P>
constexpr int kDenseMinBlocks = P <= 16 ? 4 : (P == 32 ? 2 : 1);
template <int P>
constexpr int kSplitMinBlocks = P <= 8 ? 4 : 1;

// Per-block state shared by the three kernels.
struct Shared {
  float rects[kMaxRects][4];  // atlas rects: x0 x1 y0 y1
  float red[kWarps];          // block-min scratch
  int warp[kWarps];           // block-prefix scratch
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

// The bounding rect of warp w's pixel centres in tile (tx, ty): lanes
// 32w .. 32w + 31 of tile_pixels (exact: integers + 0.5).
template <int P>
__device__ __forceinline__ cull::Corners warp_corners(int tx, int ty, int tile_w,
                                                      int tile_h, int w) {
  const int t0 = 32 * w, t1 = t0 + 31;
  const int rstep = kThreads / tile_w;
  const bool wide = tile_w >= 32;        // the warp's lanes share one row0
  cull::Corners c;
  c.x_lo = (float)(tx * tile_w + (wide ? t0 % tile_w : 0)) + 0.5f;
  c.x_hi = (float)(tx * tile_w + (wide ? t1 % tile_w : tile_w - 1)) + 0.5f;
  c.y_lo = (float)(ty * tile_h + t0 / tile_w) + 0.5f;
  c.y_hi = (float)(ty * tile_h + t1 / tile_w + (P - 1) * rstep) + 0.5f;
  return c;
}

__device__ __forceinline__ void load_rects(Shared& sh, const float* rects,
                                           int n_rects) {
  if (threadIdx.x < n_rects * 4) sh.rects[threadIdx.x / 4][threadIdx.x % 4] = rects[threadIdx.x];
}

__device__ __forceinline__ int blocks_of(int count, int cap) {
  const int n = (count + kBlock - 1) / kBlock;
  return min(n, cap / kBlock);
}

// The cull of scanned slots [0, n_scan), slot s naming triangle id_of(s)
// (< 0: empty), one thread a slot: the survivors' records are compacted into
// s_rec in list order, lane 14 holding 1 where the tile lies wholly inside
// the record's rect, else 0; with s_blk, s_blk[cb] receives the survivors
// before grid block cb (slots grid0 + 16 cb ..). Returns the survivor count,
// the same in every thread; a barrier must precede reading s_rec.
template <typename IdOf>
__device__ __forceinline__ int cull_compact(const float* __restrict__ records,
                                            IdOf id_of, int n_scan, int grid0,
                                            const cull::Corners& corners,
                                            Shared& sh, int n_rects, float* s_rec,
                                            int* s_blk) {
  int n_keep = 0;
  for (int s0 = 0; s0 < n_scan; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    const int id = s < n_scan ? id_of(s) : -1;
    float d[16];
    int flags = 0;
    if (id >= 0) {
      cull::load_record(records, id, d);
      flags = cull::edge_flags(d, corners, &sh.rects[0][0], n_rects);
    }
    int total;
    const int pos = n_keep + cull::block_prefix<kWarps>(flags != 0, sh.warp, &total);
    if (flags) {
      d[14] = (flags & cull::kInside) ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < kEdge; ++k) s_rec[pos * kEdge + k] = d[k];
    }
    if (s_blk != nullptr && s < n_scan && s >= grid0 && (s - grid0) % kBlock == 0)
      s_blk[(s - grid0) / kBlock] = pos;
    n_keep += total;
  }
  return n_keep;
}

// The cull once more per warp: sets bit 1 + w of lane 14 of each of the
// n_keep staged survivors whose edges and rect may reach a pixel centre of
// warp w (the bounding rect of its pixels, warp_corners). One thread a
// (survivor, warp) pair, the kWarps pairs of a survivor in consecutive
// lanes, one ballot a warp. Needs a barrier before and after.
template <int P>
__device__ __forceinline__ void mark_warps(float* s_rec, int n_keep, int tx, int ty,
                                           int tile_w, int tile_h, const Shared& sh,
                                           int n_rects) {
  const int w = threadIdx.x % kWarps;     // kThreads is a multiple of kWarps
  const cull::Corners c = warp_corners<P>(tx, ty, tile_w, tile_h, w);
  const int n_pairs = n_keep * kWarps;
  for (int j0 = 0; j0 < n_pairs; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const bool pair = j < n_pairs;
    float* d = s_rec + (pair ? j / kWarps : 0) * kEdge;
    const bool reach = pair && cull::edge_flags(d, c, &sh.rects[0][0], n_rects) != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, reach);
    if (pair && w == 0)
      d[14] += (float)(((ballot >> (threadIdx.x & 31)) & ((1u << kWarps) - 1u)) << 1);
  }
}

// Max-merge one surviving record into this thread's P pixels. kRect: the
// tile straddles the record's rect, so each pixel tests it; otherwise the
// tile lies wholly inside and the test is dropped. kVote: a warp skips the
// depth of a pixel row where none of its pixels is inside. A survivor
// names a triangle, so the id test always passes.
template <int P, bool kRect, bool kVote>
__device__ __forceinline__ void merge_survivor(const float* d, const Shared& sh,
                                               int n_rects, const Pixels& pix,
                                               float (&depth)[P]) {
  float y_lo = 0.0f, y_hi = 0.0f;
  bool col_ok = true;
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
    col_ok = pix.px >= x0 && pix.px < x1;
    if (!kVote && !col_ok) return;                   // this thread's column
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
    bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
    if (kRect) inside = inside && col_ok && py >= y_lo && py < y_hi;
    if (kVote && !__any_sync(0xffffffffu, inside)) continue;   // warp-uniform
    const float z = z2 + e0 * inv_area * dz0 + e1 * inv_area * dz1;
    const bool cand = inside && z <= 1.0f && z > 0.0f;
    depth[i] = fmaxf(depth[i], cand ? z : 0.0f);
  }
}

// Max-merge the staged survivors [s0, s1). Lane 14: bit 0 set where the
// tile lies wholly inside the record's rect; with kWarpSkip, bit 1 + w set
// where the record may reach warp w (mark_warps), and the rows vote.
template <int P, bool kWarpSkip>
__device__ __forceinline__ void merge_survivors(const float* s_rec, int s0, int s1,
                                                const Shared& sh, int n_rects,
                                                const Pixels& pix, float (&depth)[P]) {
  const int warp_bit = 2 << (threadIdx.x >> 5);
  for (int s = s0; s < s1; ++s) {
    const float* d = s_rec + s * kEdge;
    const int f = (int)d[14];
    if (kWarpSkip && !(f & warp_bit)) continue;       // warp-uniform
    if (f & 1)                                        // block-uniform
      merge_survivor<P, false, kWarpSkip>(d, sh, n_rects, pix, depth);
    else
      merge_survivor<P, true, kWarpSkip>(d, sh, n_rects, pix, depth);
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

// Merge the survivors of grid blocks [0, n_blocks) (block cb's are
// [s_blk[cb], s_blk[cb + 1])) with the early exit of the reference: after
// every original block the tile stops once its minimum is >= bnd[cb + 1]; a
// block the cull emptied leaves the depths, and so the minimum, as they
// were; the walk ends once no survivor is left.
template <int P, bool kWarpSkip>
__device__ __forceinline__ void walk_grid(const float* s_rec, const int* s_blk,
                                          int n_blocks, int n_keep, const float* bnd,
                                          Shared& sh, int n_rects, const Pixels& pix,
                                          float (&depth)[P]) {
  bool have_min = false;
  float t_min = 0.0f;
  for (int cb = 0; cb < n_blocks; ++cb) {
    const int lo = s_blk[cb], hi = s_blk[cb + 1];
    if (lo == n_keep) break;                   // no survivor left to merge
    if (hi > lo) {
      merge_survivors<P, kWarpSkip>(s_rec, lo, hi, sh, n_rects, pix, depth);
      have_min = false;
    }
    if (!have_min) {
      t_min = tile_min<P>(depth, sh);
      have_min = true;
    }
    if (t_min >= bnd[cb + 1]) break;
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

template <int P>
__global__ void __launch_bounds__(kThreads, kSplitMinBlocks<P>)
depth_super_kernel(const float* __restrict__ records,
                   const int* __restrict__ sup_tris,
                   const int* __restrict__ sup_counts, int cap, int tiles_x,
                   int tile_w, int tile_h, int sup_x, int sup_y, int sups_x,
                   const float* __restrict__ rects, int n_rects,
                   float* __restrict__ depth_img, int* __restrict__ kept) {
  extern __shared__ float s_rec[];         // survivors [<= cap][16]
  __shared__ Shared sh;
  const int tx = blockIdx.x % tiles_x;
  const int ty = blockIdx.x / tiles_x;
  const int sup = (ty / sup_y) * sups_x + tx / sup_x;
  const int* list = sup_tris + (size_t)sup * cap;
  // the first slots' ids load beside the count, not after it
  const int first = threadIdx.x < cap ? list[threadIdx.x] : -1;
  const int n_scan = blocks_of(sup_counts[sup], cap) * kBlock;
  load_rects(sh, rects, n_rects);
  __syncthreads();
  const int n_keep = cull_compact(
      records, [=](int s) { return s == (int)threadIdx.x ? first : list[s]; }, n_scan,
      n_scan, cull::tile_corners(tx, ty, tile_w, tile_h), sh, n_rects, s_rec, nullptr);
  if (threadIdx.x == 0 && kept != nullptr) kept[blockIdx.x] = n_keep;
  if (n_keep > 0) {                        // uniform; most tiles keep none
    __syncthreads();
    mark_warps<P>(s_rec, n_keep, tx, ty, tile_w, tile_h, sh, n_rects);
    __syncthreads();
  }
  const Pixels pix = tile_pixels(tx, ty, tile_w, tile_h);
  float depth[P];
#pragma unroll
  for (int i = 0; i < P; ++i) depth[i] = 0.0f;
  merge_survivors<P, true>(s_rec, 0, n_keep, sh, n_rects, pix, depth);
  store<P>(depth_img, tiles_x * tile_w, tx, ty, tile_w, tile_h, pix, depth);
}

template <int P>
__global__ void __launch_bounds__(kThreads, kSplitMinBlocks<P>)
depth_grid_kernel(const float* __restrict__ records,
                  const int* __restrict__ act_ids,
                  const int* __restrict__ act_cnt,
                  const int* __restrict__ tile_tris,
                  const float* __restrict__ bound, int cap, int tiles_x,
                  int tile_w, int tile_h, const float* __restrict__ rects,
                  int n_rects, float* __restrict__ depth_img,
                  int* __restrict__ kept) {
  extern __shared__ float s_rec[];         // survivors [<= cap][16]
  __shared__ Shared sh;
  __shared__ int s_blk[kMaxSlots / kBlock + 1];  // survivors before grid block cb
  const int i = blockIdx.x;
  const int* list = tile_tris + (size_t)i * cap;
  const int n_blocks = blocks_of(act_cnt[i], cap);
  const int tile = act_ids[i];
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int w_pad = tiles_x * tile_w;
  load_rects(sh, rects, n_rects);
  __syncthreads();
  const int n_keep = cull_compact(records, [list](int s) { return list[s]; },
                                  n_blocks * kBlock, 0,
                                  cull::tile_corners(tx, ty, tile_w, tile_h), sh,
                                  n_rects, s_rec, s_blk);
  if (threadIdx.x == 0) {
    s_blk[n_blocks] = n_keep;
    if (kept != nullptr) kept[i] = n_keep;
  }
  if (n_keep == 0) return;                 // the tile keeps pass 1's depth
  __syncthreads();
  mark_warps<P>(s_rec, n_keep, tx, ty, tile_w, tile_h, sh, n_rects);
  __syncthreads();
  const Pixels pix = tile_pixels(tx, ty, tile_w, tile_h);
  float depth[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int y = ty * tile_h + pix.row0 + k * pix.rstep;
    depth[k] = depth_img[(size_t)y * w_pad + tx * tile_w + pix.col];
  }
  walk_grid<P, true>(s_rec, s_blk, n_blocks, n_keep,
                     bound + (size_t)i * (cap / kBlock + 1), sh, n_rects, pix, depth);
  store<P>(depth_img, w_pad, tx, ty, tile_w, tile_h, pix, depth);
}

template <int P>
__global__ void __launch_bounds__(kThreads, kDenseMinBlocks<P>)
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
  const int* list = tile_tris + (size_t)tile * cap;
  load_rects(sh, rects, n_rects);
  __syncthreads();
  const int n_keep = cull_compact(
      records, [=](int s) { return s < n_bigs ? big_list[s] : list[s - n_bigs]; },
      n_bigs + n_blocks * kBlock, n_bigs, cull::tile_corners(tx, ty, tile_w, tile_h),
      sh, n_rects, s_rec, s_blk);
  if (threadIdx.x == 0) {
    s_blk[n_blocks] = n_keep;
    if (kept != nullptr) kept[tile] = n_keep;
  }
  __syncthreads();

  const Pixels pix = tile_pixels(tx, ty, tile_w, tile_h);
  float depth[P];
#pragma unroll
  for (int i = 0; i < P; ++i) depth[i] = 0.0f;
  merge_survivors<P, false>(s_rec, 0, s_blk[0], sh, n_rects, pix, depth);
  walk_grid<P, false>(s_rec, s_blk, n_blocks, n_keep,
                      bound + (size_t)tile * (cap / kBlock + 1), sh, n_rects, pix, depth);
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
// `kept` (one int a tile, depth_grid: an active row; or null) receives the
// slots that survive the cull. smem: dynamic shared memory for the
// survivors, at least (list slots) x 64 bytes.

extern "C" int depth_super_launch(const float* records, const int* sup_tris,
                                  const int* sup_counts, int cap, int n_tiles,
                                  int tiles_x, int tile_w, int tile_h, int sup_x,
                                  int sup_y, int sups_x, const float* rects,
                                  int n_rects, float* depth, int* kept, int smem,
                                  void* stream) {
  if (n_rects > kMaxRects || cap % kBlock != 0 || smem < cap * kEdge * 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GTT_SUPER(P)                                                         \
  {                                                                          \
    cudaError_t err = prepare(depth_super_kernel<P>, smem);                  \
    if (err != cudaSuccess) return (int)err;                                 \
    depth_super_kernel<P><<<n_tiles, kThreads, smem, st>>>(                  \
        records, sup_tris, sup_counts, cap, tiles_x, tile_w, tile_h, sup_x,  \
        sup_y, sups_x, rects, n_rects, depth, kept);                         \
    return (int)cudaGetLastError();                                          \
  }
  GTT_DISPATCH(pixels_per_thread(tile_w, tile_h), GTT_SUPER)
#undef GTT_SUPER
}

extern "C" int depth_grid_launch(const float* records, const int* act_ids,
                                 const int* act_cnt, const int* tile_tris,
                                 const float* bound, int cap, int rows,
                                 int tiles_x, int tile_w, int tile_h,
                                 const float* rects, int n_rects, float* depth,
                                 int* kept, int smem, void* stream) {
  if (n_rects > kMaxRects || cap > kMaxSlots || cap % kBlock != 0 ||
      smem < cap * kEdge * 4)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GTT_GRID(P)                                                          \
  {                                                                          \
    cudaError_t err = prepare(depth_grid_kernel<P>, smem);                   \
    if (err != cudaSuccess) return (int)err;                                 \
    depth_grid_kernel<P><<<rows, kThreads, smem, st>>>(                      \
        records, act_ids, act_cnt, tile_tris, bound, cap, tiles_x, tile_w,   \
        tile_h, rects, n_rects, depth, kept);                                \
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
