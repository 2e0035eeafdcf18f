// The HUD composite for Hopper (sm_90a): one block a 32x8 tile of the frame,
// one thread a pixel, the sprites culled against the tile.
//
// It replaces no TPU Pallas kernel: the JAX package composites the sprites
// with jnp ops (garden_tpu/render/sprites.py), and the port's plain version
// is garden_tpu_torch/render/sprites.py: composite_sprites_plain. That makes
// one full-frame pass a sprite, ~33 elementwise launches each over every
// pixel: the engine frame's 82 sprites are ~2,700 launches and ~22 device ms
// for a HUD that covers a few thousand pixels. composite_sprites_launch
// computes the same image in one launch.
//
// What it computes. For each pixel, in push order over the first `count`
// sprites: the rect test on the pixel's integer centre (x >= rx, x < rx +
// rw, the same on the rows), the nearest texel of the sprite's atlas region
// (u = (x - rx) / max(rw, 1e-6), tx = clamp(int(gx + u * gw), 0, A - 1), the
// same for v and ty), rgb = texel.rgb * colour.rgb, alpha = (texel.a *
// colour.a) * inside, and out = out * (1 - alpha) + rgb * alpha. The pixel is
// read once and written once, out of place.
//
// Equal bits. Each step is the plain loop's float32 operation in its order,
// by the rules of torch_float.cuh (built with -fmad=false; the division of
// two tensors is IEEE's; the clamp tests NaN first; the float-to-int cast
// truncates and saturates as PyTorch's does). A sprite the tile's cull drops
// is outside its rect at every pixel of the tile, where the loop blends it
// with alpha exactly 0: out * 1 + rgb * (+-0). That leaves every bit of the
// pixel unless a channel is -0.0 (the sum gives +0.0) or NaN (made anew), or
// rgb or alpha is not finite. So a thread whose pixel holds a -0.0 or NaN
// channel blends the dropped sprites too, until it holds none; and a sprite
// is kept in every tile when texel x colour could leave the finite floats:
// `atlas_max` is the largest |texel| of the atlas (inf when it holds a
// non-finite value), and a colour channel c with |c| * atlas_max not finite
// keeps its sprite (a non-finite colour always does).
//
// The cull. The columns x >= rx, x < rx + rw of a tile's columns [lo, hi]
// are not empty exactly when hi >= rx and max(lo, ceil(rx)) < rx + rw, the
// loop's own comparisons at the first column that passes the first test; the
// rows the same. It keeps push order: the kept sprites of a pass are listed
// by a warp ballot and a prefix over the block's warps.
//
// What bounds it on the H100. The image is read and written once: 1920 x
// 1080 x 3 float32 each way, 49.8 MB, ~0.015 ms at 3.35 TB/s. The sprites
// are ~2 flops a pixel a kept sprite, and each block reads the sprites'
// 48 bytes each from L2 once a pass.
//
// What the design does about it. A block stages up to 256 sprites at a time
// in shared memory, one a thread, culls them and lists the kept ones; every
// thread keeps its pixel in registers across the passes and walks the list,
// so a pixel no sprite reaches costs its read and its write. The texels come
// through the read-only cache; a font atlas of 256 x 256 x 4 floats is 1 MB
// and stays in L2.

#include <cuda_runtime.h>

#include "torch_float.cuh"

namespace {

constexpr int kTileW = 32;                   // sprites.TILE_W
constexpr int kTileH = 8;                    // sprites.TILE_H
constexpr int kThreads = kTileW * kTileH;    // a pixel a thread
constexpr int kWarps = kThreads / 32;
constexpr int kPass = kThreads;              // the sprites staged a pass, one a thread

// some integer column x in [lo, hi] has x >= s and x < e
__device__ __forceinline__ bool reaches(float s, float e, float lo, float hi) {
  return hi >= s && fmaxf(lo, ceilf(s)) < e;
}

// texel x colour stays finite for every |texel| <= atlas_max
__device__ __forceinline__ bool bounded(float4 c, float atlas_max) {
  return isfinite(fabsf(c.x) * atlas_max) && isfinite(fabsf(c.y) * atlas_max) &&
         isfinite(fabsf(c.z) * atlas_max) && isfinite(fabsf(c.w) * atlas_max);
}

// a channel that a blend of alpha 0 changes: -0.0 or NaN
__device__ __forceinline__ bool unsettled(float v) {
  return (v == 0.0f && signbit(v)) || isnan(v);
}

// one step of the plain loop at pixel (fx, fy)
__device__ __forceinline__ void blend(float& r, float& g, float& b, float fx, float fy,
                                      float4 rc, float4 rg, float4 cl,
                                      const float4* __restrict__ atlas, int a) {
  const bool inside = fx >= rc.x && fx < rc.x + rc.z && fy >= rc.y && fy < rc.y + rc.w;
  const float u = (fx - rc.x) / clamp_min(rc.z, F32(1e-6));
  const float v = (fy - rc.y) / clamp_min(rc.w, F32(1e-6));
  const int tx = min(max(static_cast<int>(rg.x + u * rg.z), 0), a - 1);
  const int ty = min(max(static_cast<int>(rg.y + v * rg.w), 0), a - 1);
  const float4 t = __ldg(atlas + static_cast<size_t>(ty) * a + tx);
  const float alpha = (t.w * cl.w) * (inside ? 1.0f : 0.0f);
  const float keep = 1.0f - alpha;
  r = r * keep + (t.x * cl.x) * alpha;
  g = g * keep + (t.y * cl.y) * alpha;
  b = b * keep + (t.z * cl.z) * alpha;
}

__global__ void __launch_bounds__(kThreads) composite_sprites_kernel(
    const float* __restrict__ image, const float4* __restrict__ atlas,
    const float4* __restrict__ rects, const float4* __restrict__ regions,
    const float4* __restrict__ colors, int count, int height, int width, int a,
    float atlas_max, float* __restrict__ out, int* __restrict__ pairs) {
  __shared__ float4 s_rect[kPass], s_region[kPass], s_color[kPass];
  __shared__ int s_list[kPass];
  __shared__ int s_warp[kWarps];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + t % kTileW, y = y0 + t / kTileW;
  const bool live = x < width && y < height;
  const size_t at = (static_cast<size_t>(y) * width + x) * 3;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (live) {
    r = image[at];
    g = image[at + 1];
    b = image[at + 2];
  }
  const float fx = static_cast<float>(x), fy = static_cast<float>(y);
  // the tile's columns and rows inside the frame
  const int x1 = min(x0 + kTileW, width) - 1, y1 = min(y0 + kTileH, height) - 1;
  int kept = 0;
  for (int base = 0; base < count; base += kPass) {
    const int n = min(kPass, count - base);
    bool keep = false;
    if (t < n) {
      const float4 rc = rects[base + t], cl = colors[base + t];
      s_rect[t] = rc;
      s_region[t] = regions[base + t];
      s_color[t] = cl;
      keep = !bounded(cl, atlas_max) ||
             (reaches(rc.x, rc.x + rc.z, static_cast<float>(x0), static_cast<float>(x1)) &&
              reaches(rc.y, rc.y + rc.w, static_cast<float>(y0), static_cast<float>(y1)));
    }
    const unsigned vote = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(vote);
    __syncthreads();
    int before = 0, listed = 0;
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? s_warp[w] : 0;
      listed += s_warp[w];
    }
    if (keep) s_list[before + __popc(vote & ((1u << lane) - 1u))] = t;
    __syncthreads();
    int next = 0;   // the pass's first sprite not yet blended or passed over
    for (int j = 0; j <= listed; ++j) {
      const int i = j < listed ? s_list[j] : n;
      for (; next < i && (unsettled(r) || unsettled(g) || unsettled(b)); ++next)
        blend(r, g, b, fx, fy, s_rect[next], s_region[next], s_color[next], atlas, a);
      if (j < listed) blend(r, g, b, fx, fy, s_rect[i], s_region[i], s_color[i], atlas, a);
      next = i + 1;
    }
    kept += listed;
    __syncthreads();   // the next pass restages the sprites
  }
  if (pairs != nullptr && t == 0)
    pairs[blockIdx.y * gridDim.x + blockIdx.x] = kept * (x1 - x0 + 1) * (y1 - y0 + 1);
  if (live) {
    out[at] = r;
    out[at + 1] = g;
    out[at + 2] = b;
  }
}

}  // namespace

// C entry point of the composite: image and out (height x width x 3), atlas
// (a x a x 4), rects, regions and colors (count x 4, each row 16-byte
// aligned), float32 on the card; atlas_max the largest |texel| (inf when the
// atlas holds a non-finite value). pairs, when not null, gets the (pixel,
// sprite) pairs each tile tests, row-major over the ceil(height / 8) x
// ceil(width / 32) tiles. Returns a cudaError_t code.
extern "C" int composite_sprites_launch(const float* image, const float* atlas,
                                        const float* rects, const float* regions,
                                        const float* colors, int count, int height, int width,
                                        int a, float atlas_max, float* out, int* pairs,
                                        void* stream) {
  if (count <= 0 || height <= 0 || width <= 0) return (int)cudaSuccess;
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  composite_sprites_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      image, reinterpret_cast<const float4*>(atlas), reinterpret_cast<const float4*>(rects),
      reinterpret_cast<const float4*>(regions), reinterpret_cast<const float4*>(colors), count,
      height, width, a, atlas_max, out, pairs);
  return (int)cudaGetLastError();
}
