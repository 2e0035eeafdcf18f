// The exact per-tile slot cull shared by every raster kernel: sorted_blend
// and oit (blend_raster.cu, K6, K7), raster_shade and visibility
// (raster_shade.cu, K1, K5), depth_super, depth_grid and depth_dense
// (depth_raster.cu, K2-K4). Its PyTorch twin is
// garden_tpu_torch/render/raster.py:tile_slot_keep, which must pick the
// same slots: both evaluate the expressions below in float32 with every
// multiply and add rounded on its own (-fmad=false here). The argument
// holds for any rectangle of pixel centres, so depth_super and depth_grid
// also run it over each warp's pixels.
//
// Why it is exact. Rounding to nearest is monotone. So an edge function
// evaluated as the pixel loop evaluates it,
//   vertex form  e = fl(fl(fl(px - xa) fl(yb - ya)) - fl(fl(py - ya) fl(xb - xa)))
//   edge form    e = fl(fl(fl(a px) + fl(b py)) + c),
// is monotone in px and in py separately, in the directions the signs of
// its coefficients give, and its largest value over the tile's pixel
// centres is the same expression at one corner centre. If that value is
// < 0 no pixel of the tile passes the edge test. The edge form's third edge
// e2 = fl(fl(S - e0) - e1) falls as e0 and e1 rise, so fl(fl(S - min e0) -
// min e1) bounds it from above. A NaN corner value keeps the slot. The
// cull never reads z, the id lane's value or the opaque depth.
//
// A culled slot changes no pixel: the blend adds c * 0 to o * fl(1 - 0) =
// o, which is o itself for a finite colour c and a destination o that is
// not -0.0; the depth raster takes fmaxf(d, 0) = d for d >= 0.

#pragma once

#include <cuda_runtime.h>

namespace cull {

constexpr int kKeep = 1;    // the slot may reach a pixel of the tile
constexpr int kInside = 2;  // ... and the tile lies wholly inside its rect

// The tile's first and last pixel centres, formed as the pixel loops form
// them ((float)(tile origin) + 0.5f + (float)offset; all exact).
struct Corners {
  float x_lo, x_hi, y_lo, y_hi;
};

__device__ __forceinline__ Corners tile_corners(int tx, int ty, int tile_w,
                                                int tile_h) {
  Corners c;
  c.x_lo = (float)(tx * tile_w) + 0.5f;
  c.x_hi = (float)(tx * tile_w) + 0.5f + (float)(tile_w - 1);
  c.y_lo = (float)(ty * tile_h) + 0.5f;
  c.y_hi = (float)(ty * tile_h) + 0.5f + (float)(tile_h - 1);
  return c;
}

// Largest value over the tile of the vertex-form edge (px - xa)(yb - ya) -
// (py - ya)(xb - xa).
__device__ __forceinline__ float vertex_edge_max(float xa, float ya, float xb,
                                                 float yb, const Corners& k) {
  const float a = yb - ya;
  const float b = xb - xa;
  const float px = a >= 0.0f ? k.x_hi : k.x_lo;
  const float py = b >= 0.0f ? k.y_lo : k.y_hi;
  return (px - xa) * a - (py - ya) * b;
}

// Largest (or smallest) value over the tile of the edge-form edge
// a px + b py + c.
__device__ __forceinline__ float edge_extreme(float a, float b, float c,
                                              const Corners& k, bool largest) {
  const float px = (a >= 0.0f) == largest ? k.x_hi : k.x_lo;
  const float py = (b >= 0.0f) == largest ? k.y_hi : k.y_lo;
  return a * px + b * py + c;
}

// The rect of cascade `idx` (rects: n rows of x0 x1 y0 y1; the last match
// wins, none: all zero) against the tile: 0 when the tile misses it, else
// kKeep, with kInside when every pixel centre of the tile lies inside it
// (then the per-pixel rect test always passes). No rects: kKeep | kInside.
__device__ __forceinline__ int rect_flags(float idx, const Corners& k,
                                          const float* rects, int n_rects) {
  if (n_rects == 0) return kKeep | kInside;
  float x0 = 0.0f, x1 = 0.0f, y0 = 0.0f, y1 = 0.0f;
  for (int r = 0; r < n_rects; ++r) {
    if (idx == (float)r) {
      x0 = rects[r * 4 + 0];
      x1 = rects[r * 4 + 1];
      y0 = rects[r * 4 + 2];
      y1 = rects[r * 4 + 3];
    }
  }
  if (!(k.x_hi >= x0 && k.x_lo < x1 && k.y_hi >= y0 && k.y_lo < y1)) return 0;
  const bool inside = k.x_lo >= x0 && k.x_hi < x1 && k.y_lo >= y0 && k.y_hi < y1;
  return inside ? kKeep | kInside : kKeep;
}

// The cull of a vertex-form record [x0 y0 x1 y1 x2 y2 | ... | atlas].
__device__ __forceinline__ int vertex_flags(const float* d, const Corners& k,
                                            const float* rects, int n_rects) {
  if (vertex_edge_max(d[2], d[3], d[4], d[5], k) < 0.0f ||
      vertex_edge_max(d[4], d[5], d[0], d[1], k) < 0.0f ||
      vertex_edge_max(d[0], d[1], d[2], d[3], k) < 0.0f)
    return 0;
  return rect_flags(d[15], k, rects, n_rects);
}

// The cull of an edge-form record [a0 a1 a2 | b0 b1 b2 | c0 c1 c2 | S | ... |
// atlas].
__device__ __forceinline__ int edge_flags(const float* d, const Corners& k,
                                          const float* rects, int n_rects) {
  if (edge_extreme(d[0], d[3], d[6], k, true) < 0.0f ||
      edge_extreme(d[1], d[4], d[7], k, true) < 0.0f)
    return 0;
  const float e0_min = edge_extreme(d[0], d[3], d[6], k, false);
  const float e1_min = edge_extreme(d[1], d[4], d[7], k, false);
  if (d[9] - e0_min - e1_min < 0.0f) return 0;
  return rect_flags(d[15], k, rects, n_rects);
}

// Block-wide exclusive prefix count of `flag` in thread order: the number
// of set flags in lower threads; *total gets the block's count. Warp
// ballots, then the warps' counts through shared memory. Every thread of
// the block calls it.
template <int kWarps>
__device__ __forceinline__ int block_prefix(bool flag, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int before = __popc(ballot & ((1u << lane) - 1u));
  int sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    before += w < warp ? c : 0;
    sum += c;
  }
  *total = sum;
  __syncthreads();  // s_warp is free again
  return before;
}

// Load a record's 16 floats (row `id` of `records`) into registers.
__device__ __forceinline__ void load_record(const float* __restrict__ records,
                                            int id, float (&d)[16]) {
  const float* r = records + (size_t)id * 16;
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = r[k];
}

}  // namespace cull
