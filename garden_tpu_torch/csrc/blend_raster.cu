// Ordered alpha-blend raster and weighted-blended OIT accumulation for
// Hopper (sm_90a).
//
// sorted_blend_launch replaces the TPU Pallas kernel `_blend_kernel`
// (garden_tpu/render/raster.py, called from rasterize_sorted_blend): the
// sorted back-to-front translucent pass and the translucent shadow map's
// tint. Its plain PyTorch version is
// garden_tpu_torch/render/raster.py:blend_plain.
//
// oit_launch replaces `_oit_kernel` (garden_tpu/render/oit.py, called from
// rasterize_oit). Its plain version is garden_tpu_torch/render/oit.py:
// oit_plain.
//
// Each must equal its plain version bit for bit: the kernels evaluate the
// same float32 operations in the same order, and are compiled with
// -fmad=false so that no multiply and add contract into one rounding.
//
// What they compute. Records are 16 floats in vertex form,
// [x0 y0 x1 y1 x2 y2 | z0 z1 z2 | inv_area | ...]; a pixel is inside when
// all three edge functions e0 = (px - x1)(y2 - y1) - (py - y1)(x2 - x1)
// (and rotations) are >= 0, with b0 = e0 inv_area, b1 = e1 inv_area.
//
// - sorted_blend: lanes 10.. are [id | r g b a | atlas]. Every tile blends
//   the shared big list's used 16-slot blocks, then its own list's blocks,
//   ONE TRIANGLE AT A TIME IN LIST ORDER (back-to-front when binned with
//   a depth priority): z = b0 z0 + b1 z1 + (1 - b0 - b1) z2, a hit needs
//   z >= the opaque depth (reverse-Z), z <= 1, id >= 0 and, with atlas
//   rects, the pixel inside the rect named by lane 15; then
//   o = o (1 - a) + c a with a = alpha on a hit, 0 elsewhere.
// - oit: lanes 10.. are [r g b a | 0 0]. Every tile walks its merged list
//   (big list first) over slots [0, count), sentinel slots included, and
//   accumulates, where inside, z >= opaque and z <= 1 (z = b0 z0 + b1 z1 +
//   b2 z2): w = clamp(10 z^2 + 0.01, 0.01, 30) alpha, sum rgb w, sum w, and
//   reveal *= 1 - alpha.
//
// What bounds them on the H100. Per (slot, pixel) ~45 float operations
// (blend) or ~50 (OIT); with -fmad=false every counted operation is one
// instruction, while the card's 67 TFLOP/s counts an FMA as two, so a
// design that keeps the operation count reaches at most ~50% of an
// operations bound. Past that only skipping work helps, so both cull the
// slots that cannot change a pixel. The blend is then no longer bound by
// ALU work: on the translucent shadow map (3072 tiles of 128x16, every tile
// scanning all 64 big casters) few (slot, tile) pairs can reach the tile,
// and what is left is bytes: the RGB destination read once, the result
// written once, and the opaque depth only of the tiles that keep a slot
// (~154 MB at 3072x2048).
//
// What sorted_blend does about it. One block of 256 threads per row band
// of 2048 pixels (a 128x16 atlas tile is one band, a 128x32 main-view tile
// two): the longest lists decide the launch's end (on the glass frame's
// sorted pass a dozen tiles keep 64-66 slots, 378 of 510 keep none), and
// bands spread each of those tiles over two SMs.
// 1. Warp 0 starts bulk copies (the Tensor Memory Accelerator's
//    cp.async.bulk, completing on an mbarrier) of the band's in-frame hdr
//    rows into shared memory. Frames whose rows are not 16-byte aligned
//    take plain loads and stores instead, which on the glass frame's
//    shapes ran 17% (sorted pass) and 25% (atlas tint) slower (PERF.md).
// 2. Meanwhile the block culls the scanned slots (the big list's used
//    16-slot blocks, then the tile's), one thread a slot, exactly
//    (cull.cuh): a slot whose edges all stay < 0 over the tile, or whose
//    cascade rect the tile misses, cannot change a pixel. Survivors are
//    compacted into shared memory IN LIST ORDER (warp ballots and a block
//    prefix sum), each with a flag for a tile that lies wholly inside its
//    rect, which drops the per-pixel rect test. `kept` (optional)
//    receives the survivor count.
// 3. A band with no survivor is a straight copy of hdr: its opaque depth
//    is never read (on the translucent shadow map 2,735 of 3,072 tiles
//    keep no slot). Otherwise the band's opaque-depth rows are copied in
//    the same way, on a second mbarrier, and each thread walks the
//    survivors ONE TRIANGLE AT A TIME for its 8 pixels of one column,
//    colours in registers; per slot, the column's share of each edge is
//    computed once. Two blocks share an SM; more would slow the longest
//    tiles.
// 4. The band's rows go back to device memory as 16-byte stores.
// Preconditions of the cull's exactness: finite colours and no -0.0 in
// the destination (a culled slot would have added c * 0).
//
// What oit does. Its merged lists put the whole 64-slot big list, holes
// included, in front of every tile's own list (up to 320 slots), and a
// 128x128 tile binned by bounding boxes holds many slots that miss most of
// it. One block of 256 threads per row band of 1024 pixels (a 128x128 tile
// is sixteen 128x8 bands that read the same list), kOitPixels = 4 rows of
// one column a thread: the bands that keep the most slots end the launch,
// and small bands spread them over more SMs (on the H100, 128x32, 128x16
// and 128x8 bands ran 0.155, 0.071 and 0.067 ms; PERF.md).
// 1. A band wholly below the frame returns at once (at 1080p, 135 band rows
//    of 144).
// 2. The cull per band, one thread a slot of [0, count), exactly (cull.cuh,
//    vertex form, no rects): a hole (id < 0) is dropped, and so is a slot
//    whose edge stays < 0 at the band's corner pixel centres. Survivors are
//    compacted into shared memory IN LIST ORDER (warp ballots and a block
//    prefix sum): float sums are not associative, so the accumulation order
//    is the result. `kept` (optional, one int a band of the band grid)
//    receives the survivor count.
//    Why the result is unchanged. A culled slot is not visible at any pixel
//    of the band, so it adds c * 0 to sums that start at +0.0 and can never
//    become -0.0 (round to nearest gives x + (-x) = +0.0), which leaves
//    them as they are for a finite colour c, and multiplies reveal by 1. A
//    hole's all-zero record has alpha 0, so even where it is visible it
//    adds exactly zero and multiplies by 1: that is why the plain version's
//    walk over holes and the kernel's skip agree.
// 3. A band with no survivor stores accum 0 and reveal 1, the plain
//    version's result there, without reading its opaque depth. Otherwise the
//    band's opaque depth comes into shared memory, and each thread walks the
//    survivors with its accumulators (5 floats a pixel) in registers, so a
//    pixel's destination is written once; per slot, the column's share of
//    each edge, fl(fl(px - xa) fl(yb - ya)), is computed once (the same
//    product, so the same value). A warp holds 32 pixels of one row: where
//    none of them is inside the triangle (a warp vote), the rest of the
//    pair's work is skipped, for the same reason a culled slot changes
//    nothing. Four blocks share an SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRec = 16;
constexpr int kBlock = 16;
constexpr int kMaxRects = 8;
constexpr int kMaxSlots = 1024;          // sorted_blend: n_big + cap
constexpr int kBlendPixels = 8;          // sorted_blend pixels a thread
constexpr int kOitPixels = 4;            // OIT pixels a thread (5 accumulators each)

// -- copies of the band's image rows into shared memory: the Tensor Memory
// Accelerator's bulk copy, completing on an mbarrier, where rows are
// 16-byte aligned, else plain loads ------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait for phase `parity` of the barrier to complete. A copy that never
// completes is a fault: after ~2^31 cycles the block traps (a launch error
// on the host) instead of hanging the card.
__device__ __forceinline__ void bar_wait(unsigned long long* bar, unsigned parity) {
  const long long start = clock64();
  unsigned done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(smem_addr(bar)),
        "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 31)) __trap();
  }
}

// Copy `rows` rows of `n` floats, global row r at src + r * src_stride to
// shared row r at dst + r * dst_stride. bulk (rows and n * 4 a multiple of
// 16 bytes): warp 0 starts one bulk copy a row, and bar_wait(bar) completes
// them; else every thread loads and stores floats, complete at the next
// __syncthreads.
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride,
                                          const float* src, size_t src_stride,
                                          int rows, int n, bool bulk,
                                          unsigned long long* bar) {
  if (!bulk) {
    for (int k = threadIdx.x; k < rows * n; k += kThreads) {
      const int r = k / n, v = k % n;
      dst[r * dst_stride + v] = src[r * src_stride + v];
    }
    return;
  }
  if (threadIdx.x >= 32) return;
  if (threadIdx.x == 0)            // arrive once, expecting the rows' bytes
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                     smem_addr(bar)), "r"(rows * n * 4) : "memory");
  __syncwarp();                    // the expected bytes are set before any copy
  for (int r = threadIdx.x; r < rows; r += 32)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst + r * dst_stride)),
        "l"(src + r * src_stride), "r"(n * 4), "r"(smem_addr(bar)) : "memory");
}

// This thread's pixels of the tile: column `col`, rows row0 + i * (256 /
// tile_w); smem offsets of pixel i step by 256 pixels (tile_w divides 256).
struct Pix {
  int col, row0, row_step;
  float px;
};

// Blend staged record d over this thread's P pixels, colours in registers,
// the opaque depth of pixel i at opq[i * 256]. kRect: the tile straddles
// the record's rect, so every pixel tests it. The float operations and
// their order are blend_plain's; the column's share of each edge,
// fl(fl(px - xa) fl(yb - ya)), is the same for every pixel of the thread.
template <int P, bool kRect>
__device__ __forceinline__ void blend_record(const float* d, const Pix& pix,
                                             float ty0, const float* opq,
                                             const float* s_rect, int n_rects,
                                             float (&o_r)[P], float (&o_g)[P],
                                             float (&o_b)[P]) {
  const float x0 = d[0], y0 = d[1], x1 = d[2], y1 = d[3], x2 = d[4], y2 = d[5];
  const float z0 = d[6], z1 = d[7], z2 = d[8], inv_area = d[9];
  const float cr = d[11], cg = d[12], cb = d[13], ca = d[14];
  const float u0 = (pix.px - x1) * (y2 - y1);
  const float u1 = (pix.px - x2) * (y0 - y2);
  const float u2 = (pix.px - x0) * (y1 - y0);
  const float w0 = x2 - x1, w1 = x0 - x2, w2 = x1 - x0;
  bool in_cols = true;
  float ry0 = 0.0f, ry1 = 0.0f;
  if (kRect) {
    float rx0 = 0.0f, rx1 = 0.0f;
    for (int r = 0; r < n_rects; ++r) {
      if (d[15] == (float)r) {
        rx0 = s_rect[r * 4 + 0];
        rx1 = s_rect[r * 4 + 1];
        ry0 = s_rect[r * 4 + 2];
        ry1 = s_rect[r * 4 + 3];
      }
    }
    in_cols = pix.px >= rx0 && pix.px < rx1;
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float py = ty0 + 0.5f + (float)(pix.row0 + i * pix.row_step);
    const float e0 = u0 - (py - y1) * w0;
    const float e1 = u1 - (py - y2) * w1;
    const float e2 = u2 - (py - y0) * w2;
    const float b0 = e0 * inv_area;
    const float b1 = e1 * inv_area;
    const float z = b0 * z0 + b1 * z1 + (1.0f - b0 - b1) * z2;
    bool hit = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z >= opq[i * kThreads] &&
               z <= 1.0f;
    if (kRect) hit = hit && in_cols && py >= ry0 && py < ry1;
    const float a = hit ? ca : 0.0f;
    const float keep = 1.0f - a;
    o_r[i] = o_r[i] * keep + cr * a;
    o_g[i] = o_g[i] * keep + cg * a;
    o_b[i] = o_b[i] * keep + cb * a;
  }
}

// One block per row band of 2048 pixels (8 a thread): a 128x16 atlas tile
// is one band, a 128x32 main-view tile two, so the few tiles with the
// longest lists spread over two SMs. Two blocks resident per SM (at most
// 128 registers): more would share each SM among more blocks and slow the
// longest tiles, which end the launch.
__global__ void __launch_bounds__(kThreads, 2)
sorted_blend_kernel(const float* __restrict__ records,
                    const int* __restrict__ tile_tris,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_list,
                    const float* __restrict__ opaque_depth,
                    const float* __restrict__ hdr, int cap, int n_big,
                    int tiles_x, int tile_w, int tile_h, int bands, int width,
                    int height,
                    const float* __restrict__ rects, int n_rects, int bulk,
                    float* __restrict__ out, int* __restrict__ kept) {
  // block: one of `bands` row bands of band_h rows of a tile; dynamic smem:
  // the band's hdr rows [band_h][tile_w * 3], its opaque depth
  // [band_h][tile_w], then the surviving records [<= n_big + cap][16]
  extern __shared__ __align__(128) float smem[];
  __shared__ int s_warp[kWarps];
  __shared__ int s_big_used;
  __shared__ float s_rect[kMaxRects * 4];
  __shared__ unsigned long long s_bar[2];      // hdr, opaque depth
  const int band_h = tile_h / bands;
  float* s_hdr = smem;
  float* s_opq = smem + tile_w * band_h * 3;
  float* s_rec = s_opq + tile_w * band_h;

  const int tile = blockIdx.x / bands;
  const int band = blockIdx.x % bands;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int x0 = tx * tile_w, y0 = ty * tile_h + band * band_h;
  const int n_in = min(tile_w, width - x0);     // columns inside the frame
  const int rows_in = max(0, min(band_h, height - y0));

  if (threadIdx.x == 0) {
    s_big_used = 0;
    bar_init(&s_bar[0], 1);
    bar_init(&s_bar[1], 1);
  }
  if (threadIdx.x < n_rects * 4) s_rect[threadIdx.x] = rects[threadIdx.x];
  __syncthreads();

  // 1. start loading the band's hdr rows inside the frame into shared
  // memory; bulk copies land while the slots are culled (the pixels past
  // the frame are blended from whatever smem holds and never stored)
  const size_t g0 = (size_t)y0 * width + x0;
  copy_rows(s_hdr, tile_w * 3, hdr + g0 * 3, (size_t)width * 3, rows_in, n_in * 3,
            bulk, &s_bar[0]);

  // 2. the scanned slots: the big list's used blocks, then the tile's blocks
  int used = 0;
  for (int s = threadIdx.x; s < n_big; s += kThreads) used += big_list[s] >= 0;
  if (used) atomicAdd(&s_big_used, used);
  __syncthreads();
  const int big_end = min((s_big_used + kBlock - 1) / kBlock * kBlock, n_big);
  const int grid_end = min((counts[tile] + kBlock - 1) / kBlock * kBlock, cap);
  const int n_scan = big_end + grid_end;

  // 3. the cull over the whole tile (every band keeps the same slots), one
  // thread a slot, and the survivors compacted in list order into s_rec;
  // lane 10 (the id) then holds 1 when the tile lies wholly inside the
  // record's rect, else 0
  const cull::Corners corners = cull::tile_corners(tx, ty, tile_w, tile_h);
  int n_keep = 0;
  for (int s0 = 0; s0 < n_scan; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    const int id = s >= n_scan  ? -1
                   : s < big_end ? big_list[s]
                                 : tile_tris[(size_t)tile * cap + (s - big_end)];
    float d[16];
    int flags = 0;
    if (id >= 0) {
      cull::load_record(records, id, d);
      flags = cull::vertex_flags(d, corners, s_rect, n_rects);
    }
    int total;
    const int pos = n_keep + cull::block_prefix<kWarps>(flags != 0, s_warp, &total);
    if (flags) {
      d[10] = (flags & cull::kInside) ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < kRec; ++k) s_rec[pos * kRec + k] = d[k];
    }
    n_keep += total;
  }
  if (kept != nullptr && band == 0 && threadIdx.x == 0) kept[tile] = n_keep;
  // the opaque depth only where a slot survives: a band with none copies hdr
  if (n_keep > 0)
    copy_rows(s_opq, tile_w, opaque_depth + g0, (size_t)width, rows_in, n_in, bulk,
              &s_bar[1]);
  if (bulk) {
    bar_wait(&s_bar[0], 0);
    if (n_keep > 0) bar_wait(&s_bar[1], 0);
  }
  __syncthreads();

  // 4. blend the survivors in order over this thread's pixels, then put
  // the result back into s_hdr
  if (n_keep > 0) {
    Pix pix;
    pix.col = threadIdx.x % tile_w;
    pix.row0 = threadIdx.x / tile_w;
    pix.row_step = kThreads / tile_w;
    pix.px = (float)x0 + 0.5f + (float)pix.col;
    const float ty0 = (float)y0;
    const int p0 = pix.row0 * tile_w + pix.col;      // pixel 0's smem index
    const float* opq = s_opq + p0;
    constexpr int P = kBlendPixels;
    float o_r[P], o_g[P], o_b[P];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      o_r[i] = s_hdr[(p0 + i * kThreads) * 3 + 0];
      o_g[i] = s_hdr[(p0 + i * kThreads) * 3 + 1];
      o_b[i] = s_hdr[(p0 + i * kThreads) * 3 + 2];
    }
    for (int s = 0; s < n_keep; ++s) {
      const float* d = s_rec + s * kRec;
      if (d[10] == 0.0f)                       // block-uniform
        blend_record<P, true>(d, pix, ty0, opq, s_rect, n_rects, o_r, o_g, o_b);
      else
        blend_record<P, false>(d, pix, ty0, opq, s_rect, n_rects, o_r, o_g, o_b);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
      s_hdr[(p0 + i * kThreads) * 3 + 0] = o_r[i];
      s_hdr[(p0 + i * kThreads) * 3 + 1] = o_g[i];
      s_hdr[(p0 + i * kThreads) * 3 + 2] = o_b[i];
    }
    __syncthreads();
  }

  // 5. write the band's rows inside the frame, a warp's consecutive threads
  // on consecutive addresses: 16-byte stores where rows are aligned
  if (bulk) {
    const int per_row = n_in * 3 / 4;
    for (int k = threadIdx.x; k < rows_in * per_row; k += kThreads) {
      const int r = k / per_row, v = k % per_row;
      const float4 val = reinterpret_cast<const float4*>(s_hdr + r * tile_w * 3)[v];
      reinterpret_cast<float4*>(out + (g0 + (size_t)r * width) * 3)[v] = val;
    }
  } else {
    const int per_row = n_in * 3;
    for (int k = threadIdx.x; k < rows_in * per_row; k += kThreads) {
      const int r = k / per_row, v = k % per_row;
      out[(g0 + (size_t)r * width) * 3 + v] = s_hdr[r * tile_w * 3 + v];
    }
  }
}

// One block per row band of 1024 pixels (n_sub bands a tile), kOitPixels
// rows of one column a thread; four blocks resident per SM (at most 64
// registers).
__global__ void __launch_bounds__(kThreads, 4)
oit_kernel(const float* __restrict__ records, const int* __restrict__ tile_tris,
           const int* __restrict__ counts,
           const float* __restrict__ opaque_depth, int cap, int tiles_x,
           int tile, int width, int height, int n_sub,
           float* __restrict__ accum, float* __restrict__ reveal_out,
           int* __restrict__ kept) {
  // dynamic smem: the band's opaque depth [1024], then the survivors'
  // records [<= cap][16]
  extern __shared__ float smem[];
  __shared__ int s_warp[kWarps];
  constexpr int P = kOitPixels;
  float* s_opq = smem;
  float* s_rec = smem + kThreads * P;
  const int t_idx = blockIdx.x / n_sub;
  const int band = blockIdx.x % n_sub;
  const int tx = t_idx % tiles_x;
  const int ty = t_idx / tiles_x;
  const int band_h = tile / n_sub;
  const int brow = ty * n_sub + band;          // the band's row of the band grid
  // 1. nothing of a band wholly below the frame is stored
  if (brow * band_h >= height) return;

  // 2. the cull over the band, one thread a slot, survivors in list order
  const int n_scan = min(counts[t_idx], cap);
  const cull::Corners corners = cull::tile_corners(tx, brow, tile, band_h);
  int n_keep = 0;
  for (int s0 = 0; s0 < n_scan; s0 += kThreads) {
    const int s = s0 + threadIdx.x;
    const int id = s < n_scan ? tile_tris[(size_t)t_idx * cap + s] : -1;
    float d[16];
    int flags = 0;
    if (id >= 0) {
      cull::load_record(records, id, d);
      flags = cull::vertex_flags(d, corners, nullptr, 0);
    }
    int total;
    const int pos = n_keep + cull::block_prefix<kWarps>(flags != 0, s_warp, &total);
    if (flags) {
#pragma unroll
      for (int k = 0; k < kRec; ++k) s_rec[pos * kRec + k] = d[k];
    }
    n_keep += total;
  }
  if (kept != nullptr && threadIdx.x == 0) kept[brow * tiles_x + tx] = n_keep;

  const int col = threadIdx.x % tile;
  const int row0 = band * band_h + threadIdx.x / tile;
  const int row_step = kThreads / tile;
  const int x = tx * tile + col;
  const int y_top = ty * tile + row0;           // this thread's first row
  // 3. without a survivor, the plain version's sums stay +0.0 and reveal 1
  if (n_keep == 0) {
    if (x >= width) return;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int y = y_top + i * row_step;
      if (y >= height) continue;
      const size_t o = (size_t)y * width + x;
      reinterpret_cast<float4*>(accum)[o] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      reveal_out[o] = 1.0f;
    }
    return;
  }
  // past the frame the opaque depth pads with 2.0: nothing passes
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = y_top + i * row_step;
    s_opq[threadIdx.x + i * kThreads] =
        (x < width && y < height) ? opaque_depth[(size_t)y * width + x] : 2.0f;
  }
  __syncthreads();

  const float px = (float)(tx * tile) + 0.5f + (float)col;
  const float py0 = (float)(ty * tile) + 0.5f + (float)row0;
  const float* opq = s_opq + threadIdx.x;
  float acc_r[P], acc_g[P], acc_b[P], acc_w[P], rev[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    acc_r[i] = 0.0f;
    acc_g[i] = 0.0f;
    acc_b[i] = 0.0f;
    acc_w[i] = 0.0f;
    rev[i] = 1.0f;
  }
  for (int s = 0; s < n_keep; ++s) {
    const float* d = s_rec + s * kRec;
    const float x0 = d[0], y0 = d[1], x1 = d[2], y1 = d[3], x2 = d[4], y2 = d[5];
    const float z0 = d[6], z1 = d[7], z2 = d[8], inv_area = d[9];
    const float cr = d[10], cg = d[11], cb = d[12], alpha = d[13];
    const float pass = 1.0f - alpha;
    const float u0 = (px - x1) * (y2 - y1);
    const float u1 = (px - x2) * (y0 - y2);
    const float u2 = (px - x0) * (y1 - y0);
    const float w0 = x2 - x1, w1 = x0 - x2, w2 = x1 - x0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float py = py0 + (float)(i * row_step);
      const float e0 = u0 - (py - y1) * w0;
      const float e1 = u1 - (py - y2) * w1;
      const float e2 = u2 - (py - y0) * w2;
      const bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
      // a warp row with no pixel inside would add c * 0 and multiply by 1
      if (!__any_sync(0xffffffffu, inside)) continue;
      const float z = e0 * inv_area * z0 + e1 * inv_area * z1 + e2 * inv_area * z2;
      const bool vis = inside && z >= opq[i * kThreads] && z <= 1.0f;
      const float wgt = fminf(fmaxf(z * z * 10.0f + 0.01f, 0.01f), 30.0f) * alpha;
      const float wv = vis ? wgt : 0.0f;
      acc_r[i] = acc_r[i] + cr * wv;
      acc_g[i] = acc_g[i] + cg * wv;
      acc_b[i] = acc_b[i] + cb * wv;
      acc_w[i] = acc_w[i] + wv;
      rev[i] = rev[i] * (vis ? pass : 1.0f);
    }
  }

  if (x >= width) return;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = y_top + i * row_step;
    if (y >= height) continue;
    const size_t o = (size_t)y * width + x;
    reinterpret_cast<float4*>(accum)[o] = make_float4(acc_r[i], acc_g[i], acc_b[i],
                                                      acc_w[i]);
    reveal_out[o] = rev[i];
  }
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  if (smem > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem);
  return cudaSuccess;
}

}  // namespace

// C entry points (loaded with ctypes). Each returns a cudaError_t code;
// 0 = OK. Lists have 16k slots (cap, n_big). sorted_blend: each tile runs
// as `bands` row bands of 2048 pixels, one block each, 8 pixels a thread
// (tile_w * tile_h == 2048 * bands); `smem` is at least
// tile_w * tile_h / bands * 16 + (n_big + cap) * 64 bytes; `kept` (one int
// a tile, or null) receives each tile's surviving slots.
// oit: `n_sub` is the row bands a tile splits into, one thread block each
// (tile * tile == 1024 * n_sub); tile divides 256; `smem` is at least
// 4096 + cap * 64 bytes; accum is 16-byte aligned; `kept` (one int for each band of the band grid,
// ceil(height / band_h) rows of tiles_x, or null) receives each band's
// surviving slots.
extern "C" int sorted_blend_launch(
    const float* records, const int* tile_tris, const int* counts,
    const int* big_list, const float* opaque_depth, const float* hdr, int cap,
    int n_big, int n_tiles, int tiles_x, int tile_w, int tile_h, int width,
    int height, int bands, const float* rects, int n_rects, float* out,
    int* kept, int smem, void* stream) {
  if (bands < 1 || tile_h % bands != 0 ||
      tile_w * tile_h != kThreads * kBlendPixels * bands || kThreads % tile_w != 0 ||
      n_rects > kMaxRects || n_big + cap > kMaxSlots || cap % kBlock != 0 ||
      n_big % kBlock != 0 ||
      smem < tile_w * (tile_h / bands) * 16 + (n_big + cap) * kRec * 4)
    return (int)cudaErrorInvalidValue;
  // the bulk copies and 16-byte stores need 16-byte aligned rows
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
  };
  const int bulk = tile_w % 4 == 0 && width % 4 == 0 && aligned(opaque_depth) &&
                   aligned(hdr) && aligned(out);
  cudaError_t err = prepare(sorted_blend_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sorted_blend_kernel<<<n_tiles * bands, kThreads, smem, s>>>(
      records, tile_tris, counts, big_list, opaque_depth, hdr, cap, n_big,
      tiles_x, tile_w, tile_h, bands, width, height, rects, n_rects, bulk, out,
      kept);
  return (int)cudaGetLastError();
}

extern "C" int oit_launch(const float* records, const int* tile_tris,
                          const int* counts, const float* opaque_depth, int cap,
                          int n_tiles, int tiles_x, int tile, int width,
                          int height, int n_sub, float* accum, float* reveal,
                          int* kept, int smem, void* stream) {
  if (n_sub < 1 || tile * tile != kThreads * kOitPixels * n_sub || tile % n_sub != 0 ||
      kThreads % tile != 0 || smem < (kThreads * kOitPixels + cap * kRec) * 4 ||
      (reinterpret_cast<uintptr_t>(accum) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(oit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  oit_kernel<<<n_tiles * n_sub, kThreads, smem, s>>>(
      records, tile_tris, counts, opaque_depth, cap, tiles_x, tile, width,
      height, n_sub, accum, reveal, kept);
  return (int)cudaGetLastError();
}
