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
// (blend) or ~50 (OIT) and no memory traffic; the list's records (64 B a
// slot) are read once per thread block and the image planes once each way.
// Both are bound by that ALU work at the lists' lengths.
//
// What the design does about it. One thread block of 256 threads per tile
// (the blend: 16 pixels a thread at 128x32, 8 at 128x16), or per row band
// of 16 pixels a thread (the OIT: its 128x128 tiles split into four 128x32
// bands that read the same list): each thread keeps its pixels' running colour (3 floats) or
// accumulators (5 floats) in registers for the whole walk, so a pixel's
// destination is read once and written once. Tile widths divide 256, so a
// thread owns one pixel column: px is one register and py is recomputed
// per pixel (exact: integers plus 0.5). The walk is sequential over
// slots, as the blend order demands, and parallel over pixels only. The
// tile's records are staged once into shared memory; every thread reads
// the same record at the same time (a broadcast), and empty slots are
// skipped by a block-uniform branch (the blend) or walked (the OIT, whose
// all-zero sentinel adds exactly zero, as the reference's loop does).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRec = 16;
constexpr int kBlock = 16;
constexpr int kMaxRects = 8;
constexpr int kOitPixels = 16;           // OIT pixels a thread (5 accumulators each)

// Stage slots [0, n) of `ids` (the sentinel row t_count where -1) into
// shared memory, 16 floats a slot.
__device__ void stage(const float* __restrict__ records, const int* ids, int n,
                      int t_count, float* s_rec) {
  for (int i = threadIdx.x; i < n * kRec; i += kThreads) {
    const int t = ids[i / kRec];
    const int row = t >= 0 ? t : t_count;
    s_rec[i] = records[(size_t)row * kRec + i % kRec];
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
sorted_blend_kernel(const float* __restrict__ records,
                    const int* __restrict__ tile_tris,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_list,
                    const float* __restrict__ opaque_depth,
                    const float* __restrict__ hdr, int cap, int n_big,
                    int t_count, int tiles_x, int tile_w, int tile_h,
                    int width, int height, const float* __restrict__ rects,
                    int n_rects, float* __restrict__ out) {
  extern __shared__ float smem[];          // [n_big + cap][16] records
  __shared__ int s_ids[1024];
  __shared__ int s_big_used;
  __shared__ float s_rect[kMaxRects * 4];

  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;

  // the scanned slots: the big list's used blocks, then the tile's blocks
  if (threadIdx.x == 0) s_big_used = 0;
  if (threadIdx.x < n_rects * 4) s_rect[threadIdx.x] = rects[threadIdx.x];
  __syncthreads();
  int used = 0;
  for (int s = threadIdx.x; s < n_big; s += kThreads) used += big_list[s] >= 0;
  if (used) atomicAdd(&s_big_used, used);
  __syncthreads();
  const int big_end = min((s_big_used + kBlock - 1) / kBlock * kBlock, n_big);
  const int grid_end = min((counts[tile] + kBlock - 1) / kBlock * kBlock, cap);
  const int n_scan = big_end + grid_end;
  for (int s = threadIdx.x; s < n_scan; s += kThreads)
    s_ids[s] = s < big_end ? big_list[s] : tile_tris[(size_t)tile * cap + (s - big_end)];
  __syncthreads();
  stage(records, s_ids, n_scan, t_count, smem);
  __syncthreads();

  // pixel i of this thread: column threadIdx.x % tile_w, tile row
  // threadIdx.x / tile_w + i * (256 / tile_w)
  const int col = threadIdx.x % tile_w;
  const int row0 = threadIdx.x / tile_w;
  const int row_step = kThreads / tile_w;
  const float px = (float)(tx * tile_w) + 0.5f + (float)col;
  const int x = tx * tile_w + col;
  float opq[P], o_r[P], o_g[P], o_b[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = ty * tile_h + row0 + i * row_step;
    const bool in = x < width && y < height;
    const size_t o = (size_t)y * width + x;
    opq[i] = in ? opaque_depth[o] : 0.0f;
    o_r[i] = in ? hdr[o * 3 + 0] : 0.0f;
    o_g[i] = in ? hdr[o * 3 + 1] : 0.0f;
    o_b[i] = in ? hdr[o * 3 + 2] : 0.0f;
  }

  for (int s = 0; s < n_scan; ++s) {
    const float* d = smem + s * kRec;
    if (d[10] < 0.0f) continue;                      // empty slot: block-uniform
    const float x0 = d[0], y0 = d[1], x1 = d[2], y1 = d[3], x2 = d[4], y2 = d[5];
    const float z0 = d[6], z1 = d[7], z2 = d[8], inv_area = d[9];
    const float cr = d[11], cg = d[12], cb = d[13], ca = d[14];
    float rx0 = 0.0f, rx1 = 0.0f, ry0 = 0.0f, ry1 = 0.0f;
    for (int r = 0; r < n_rects; ++r) {
      if (d[15] == (float)r) {
        rx0 = s_rect[r * 4 + 0];
        rx1 = s_rect[r * 4 + 1];
        ry0 = s_rect[r * 4 + 2];
        ry1 = s_rect[r * 4 + 3];
      }
    }
    const bool in_cols = n_rects == 0 || (px >= rx0 && px < rx1);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float py = (float)(ty * tile_h) + 0.5f + (float)(row0 + i * row_step);
      const float e0 = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1);
      const float e1 = (px - x2) * (y0 - y2) - (py - y2) * (x0 - x2);
      const float e2 = (px - x0) * (y1 - y0) - (py - y0) * (x1 - x0);
      const float b0 = e0 * inv_area;
      const float b1 = e1 * inv_area;
      const float z = b0 * z0 + b1 * z1 + (1.0f - b0 - b1) * z2;
      bool hit = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z >= opq[i] && z <= 1.0f;
      if (n_rects > 0) hit = hit && in_cols && py >= ry0 && py < ry1;
      const float a = hit ? ca : 0.0f;
      const float keep = 1.0f - a;
      o_r[i] = o_r[i] * keep + cr * a;
      o_g[i] = o_g[i] * keep + cg * a;
      o_b[i] = o_b[i] * keep + cb * a;
    }
  }

#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = ty * tile_h + row0 + i * row_step;
    if (x >= width || y >= height) continue;
    const size_t o = (size_t)y * width + x;
    out[o * 3 + 0] = o_r[i];
    out[o * 3 + 1] = o_g[i];
    out[o * 3 + 2] = o_b[i];
  }
}

__global__ void __launch_bounds__(kThreads)
oit_kernel(const float* __restrict__ records, const int* __restrict__ tile_tris,
           const int* __restrict__ counts,
           const float* __restrict__ opaque_depth, int cap, int t_count,
           int tiles_x, int tile, int width, int height, int n_sub,
           float* __restrict__ accum, float* __restrict__ reveal_out) {
  extern __shared__ float smem[];          // [cap][16] records
  const int t_idx = blockIdx.x / n_sub;
  const int band = blockIdx.x % n_sub;
  const int tx = t_idx % tiles_x;
  const int ty = t_idx / tiles_x;
  const int band_h = tile / n_sub;
  const int n_scan = min(counts[t_idx], cap);
  stage(records, tile_tris + (size_t)t_idx * cap, n_scan, t_count, smem);
  __syncthreads();

  const int col = threadIdx.x % tile;
  const int row0 = band * band_h + threadIdx.x / tile;
  const int row_step = kThreads / tile;
  const float px = (float)(tx * tile) + 0.5f + (float)col;
  const int x = tx * tile + col;
  constexpr int P = kOitPixels;
  float opq[P], acc_r[P], acc_g[P], acc_b[P], acc_w[P], rev[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = ty * tile + row0 + i * row_step;
    // past the frame the opaque depth pads with 2.0: nothing passes
    opq[i] = (x < width && y < height) ? opaque_depth[(size_t)y * width + x] : 2.0f;
    acc_r[i] = 0.0f;
    acc_g[i] = 0.0f;
    acc_b[i] = 0.0f;
    acc_w[i] = 0.0f;
    rev[i] = 1.0f;
  }

  for (int s = 0; s < n_scan; ++s) {
    const float* d = smem + s * kRec;
    const float x0 = d[0], y0 = d[1], x1 = d[2], y1 = d[3], x2 = d[4], y2 = d[5];
    const float z0 = d[6], z1 = d[7], z2 = d[8], inv_area = d[9];
    const float cr = d[10], cg = d[11], cb = d[12], alpha = d[13];
    const float pass = 1.0f - alpha;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float py = (float)(ty * tile) + 0.5f + (float)(row0 + i * row_step);
      const float e0 = (px - x1) * (y2 - y1) - (py - y1) * (x2 - x1);
      const float e1 = (px - x2) * (y0 - y2) - (py - y2) * (x0 - x2);
      const float e2 = (px - x0) * (y1 - y0) - (py - y0) * (x1 - x0);
      const float z = e0 * inv_area * z0 + e1 * inv_area * z1 + e2 * inv_area * z2;
      const bool vis = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f && z >= opq[i] &&
                       z <= 1.0f;
      const float wgt = fminf(fmaxf(z * z * 10.0f + 0.01f, 0.01f), 30.0f) * alpha;
      const float wv = vis ? wgt : 0.0f;
      acc_r[i] = acc_r[i] + cr * wv;
      acc_g[i] = acc_g[i] + cg * wv;
      acc_b[i] = acc_b[i] + cb * wv;
      acc_w[i] = acc_w[i] + wv;
      rev[i] = rev[i] * (vis ? pass : 1.0f);
    }
  }

#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = ty * tile + row0 + i * row_step;
    if (x >= width || y >= height) continue;
    const size_t o = (size_t)y * width + x;
    accum[o * 4 + 0] = acc_r[i];
    accum[o * 4 + 1] = acc_g[i];
    accum[o * 4 + 2] = acc_b[i];
    accum[o * 4 + 3] = acc_w[i];
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
// 0 = OK. Lists have 16k slots (cap, n_big). sorted_blend: `p` is the
// number of pixels a thread owns, 8 or 16 (tile_w * tile_h == 256 * p).
// oit: `n_sub` is the row bands a tile splits into, one thread block each
// (tile * tile == 256 * 16 * n_sub). tile_w divides 256.
extern "C" int sorted_blend_launch(
    const float* records, const int* tile_tris, const int* counts,
    const int* big_list, const float* opaque_depth, const float* hdr, int cap,
    int n_big, int t_count, int n_tiles, int tiles_x, int tile_w, int tile_h,
    int width, int height, int p, const float* rects, int n_rects, float* out,
    int smem, void* stream) {
  if (tile_w * tile_h != kThreads * p || kThreads % tile_w != 0 ||
      n_rects > kMaxRects || n_big + cap > 1024 || cap % kBlock != 0 ||
      n_big % kBlock != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GTT_LAUNCH(P)                                                          \
  case P: {                                                                    \
    cudaError_t err = prepare(sorted_blend_kernel<P>, smem);                   \
    if (err != cudaSuccess) return (int)err;                                   \
    sorted_blend_kernel<P><<<n_tiles, kThreads, smem, s>>>(                    \
        records, tile_tris, counts, big_list, opaque_depth, hdr, cap, n_big,   \
        t_count, tiles_x, tile_w, tile_h, width, height, rects, n_rects, out); \
    return (int)cudaGetLastError();                                            \
  }
  switch (p) {
    GTT_LAUNCH(8)
    GTT_LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GTT_LAUNCH
}

extern "C" int oit_launch(const float* records, const int* tile_tris,
                          const int* counts, const float* opaque_depth, int cap,
                          int t_count, int n_tiles, int tiles_x, int tile,
                          int width, int height, int n_sub, float* accum,
                          float* reveal, int smem, void* stream) {
  if (tile * tile != kThreads * kOitPixels * n_sub || tile % n_sub != 0 ||
      kThreads % tile != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(oit_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  oit_kernel<<<n_tiles * n_sub, kThreads, smem, s>>>(
      records, tile_tris, counts, opaque_depth, cap, t_count, tiles_x, tile,
      width, height, n_sub, accum, reveal);
  return (int)cudaGetLastError();
}
