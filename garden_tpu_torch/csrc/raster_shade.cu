// Fused visibility raster + G-buffer finish for Hopper (sm_90a), and the
// same visibility raster without the finish.
//
// raster_shade_launch replaces the TPU Pallas kernel `_raster_shade_kernel`
// with gbuf=True (garden_tpu/render/raster.py, called from
// rasterize_visibility_shaded); its plain PyTorch version is
// garden_tpu_torch/render/raster.py:raster_shade_plain. visibility_launch
// replaces `_raster_kernel` (rasterize_visibility, the refraction pass's
// raster): the same kernel instantiated without its shading phase, with
// the big list and the tile list each padded to 16-slot blocks, so the
// blocks fall where the TPU kernel's separate big and grid loops put them;
// its plain version is raster.py:visibility_plain. Each must agree with
// its plain version bit for bit on depth, tri_id and barycentrics.
//
// What it computes. The frame is cut into tiles of tile_w x tile_h pixels.
// Every tile scans a list of triangles: the shared big list (n_big slots),
// then its own binned list (cap slots, `counts[tile]` of them used). Each
// slot names a triangle's 16-float edge record (e_k = a_k px + b_k py + c_k,
// e2 = S - e0 - e1, z = z2 + b0 dz0 + b1 dz1). A pixel takes a triangle when
// all three edges are >= 0, 0 < z <= 1 and z is strictly nearer than its
// best so far (reverse-Z: larger is nearer). Slots are visited in blocks of
// 16 in list order and, inside a block, in bit-reversed order
// (0, 8, 4, 12, ...): that is the order in which the TPU kernel's halving
// tournament lets equal depths win. The winner's 36-float shading record
// then gives 18 finished G-buffer planes (perspective-correct normal and
// uv, material, texture, instance, screen-space velocity); empty pixels
// get zeros.
//
// What bounds it on the H100. Per (slot, pixel) the test is ~20 float
// operations and no memory traffic, so the kernel is bound by that ALU work
// (tiles x slots x pixels), plus the bytes of each tile's list: up to
// 128 slots x (64 B edge + 144 B shading) read once per tile. Outputs are
// 22 floats per pixel written once (4 without the shading phase).
//
// What the design does about it. One thread block per tile, 256 threads,
// each thread owning tile_w*tile_h/256 pixels in registers (16 for the
// 32x128 main tiles), so the per-pixel state never leaves registers. The
// tile's edge and shading records are staged once into shared memory;
// every thread then reads the same record at the same time (a broadcast),
// and empty slots are skipped with a block-uniform branch. Pixels of one
// warp are 32 consecutive columns, so every output store is coalesced.
// Compiled with -fmad=false so that each multiply and add rounds as the
// plain PyTorch version's separate ops do; a contracted FMA would move edge
// values by an ulp and flip tri_id on triangle edges.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kEdge = 16;
constexpr int kRec = 36;
constexpr int kPlanes = 18;
constexpr int kBlock = 16;

template <int P, bool kShade>
__global__ void __launch_bounds__(kThreads)
raster_shade_kernel(const float* __restrict__ edge,
                    const float* __restrict__ shade,
                    const int* __restrict__ tile_tris,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_list,
                    int n_big, int cap, int t_count, int rec_width,
                    int tiles_x, int tile_w, int tile_h,
                    int width, int height,
                    float* __restrict__ depth, int* __restrict__ tri_id,
                    float* __restrict__ b0_out, float* __restrict__ b1_out,
                    float* __restrict__ planes) {
  extern __shared__ float smem[];
  const int n_slots = (n_big + cap + kBlock - 1) / kBlock * kBlock;
  float* s_edge = smem;                                  // [n_slots][16]
  float* s_rec = smem + n_slots * kEdge;                 // [n_slots][36]
  int* s_tri = reinterpret_cast<int*>(s_rec + (kShade ? n_slots * kRec : 0));

  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int count = counts[tile];
  int n_scan = (count + n_big + kBlock - 1) / kBlock * kBlock;
  if (n_scan > n_slots) n_scan = n_slots;

  // stage the tile's list: triangle ids, then edge and shading records
  for (int s = threadIdx.x; s < n_scan; s += kThreads) {
    int t = -1;
    if (s < n_big) {
      t = big_list[s];
    } else if (s - n_big < cap) {
      t = tile_tris[(size_t)tile * cap + (s - n_big)];
    }
    s_tri[s] = t;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_scan * kEdge; i += kThreads) {
    const int t = s_tri[i / kEdge];
    const int row = t >= 0 ? t : t_count;
    s_edge[i] = edge[(size_t)row * kEdge + i % kEdge];
  }
  if (kShade) {
    for (int i = threadIdx.x; i < n_scan * kRec; i += kThreads) {
      const int t = s_tri[i / kRec];
      const int row = t >= 0 ? t : t_count;
      s_rec[i] = shade[(size_t)row * rec_width + i % kRec];
    }
  }
  __syncthreads();

  float px[P], py[P], best_z[P], best_b0[P], best_b1[P];
  int best_s[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = threadIdx.x + i * kThreads;
    px[i] = (float)(tx * tile_w) + 0.5f + (float)(p % tile_w);
    py[i] = (float)(ty * tile_h) + 0.5f + (float)(p / tile_w);
    best_z[i] = 0.0f;
    best_b0[i] = 0.0f;
    best_b1[i] = 0.0f;
    best_s[i] = -1;
  }

  for (int blk = 0; blk < n_scan; blk += kBlock) {
    for (int j = 0; j < kBlock; ++j) {
      const int s = blk + (int)(__brev((unsigned)j) >> 28);  // bit-reversed
      if (s_tri[s] < 0) continue;                            // block-uniform
      const float* d = s_edge + s * kEdge;
      const float a0 = d[0], a1 = d[1], bb0 = d[3], bb1 = d[4];
      const float c0 = d[6], c1 = d[7], sum = d[9], z2 = d[10];
      const float dz0 = d[11], dz1 = d[12], inv_area = d[13];
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float e0 = a0 * px[i] + bb0 * py[i] + c0;
        const float e1 = a1 * px[i] + bb1 * py[i] + c1;
        const float e2 = sum - e0 - e1;
        const float w0 = e0 * inv_area;
        const float w1 = e1 * inv_area;
        const float z = z2 + w0 * dz0 + w1 * dz1;
        const bool cand = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f &&
                          z <= 1.0f && z > 0.0f;
        if (cand && z > best_z[i]) {
          best_z[i] = z;
          best_b0[i] = w0;
          best_b1[i] = w1;
          best_s[i] = s;
        }
      }
    }
  }

  const size_t plane = (size_t)width * height;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int p = threadIdx.x + i * kThreads;
    const int x = tx * tile_w + p % tile_w;
    const int y = ty * tile_h + p / tile_w;
    if (x >= width || y >= height) continue;
    const size_t o = (size_t)y * width + x;
    const int s = best_s[i];
    depth[o] = best_z[i];
    b0_out[o] = best_b0[i];
    b1_out[o] = best_b1[i];
    if (!kShade) {
      tri_id[o] = s < 0 ? -1 : s_tri[s];
      continue;
    }
    if (s < 0) {
      tri_id[o] = -1;
#pragma unroll
      for (int c = 0; c < kPlanes; ++c) planes[c * plane + o] = 0.0f;
      continue;
    }
    tri_id[o] = s_tri[s];
    const float* r = s_rec + s * kRec;
    const float b0 = best_b0[i];
    const float b1 = best_b1[i];
    const float b2 = 1.0f - b0 - b1;
    float w0 = b0 * r[32];
    float w1 = b1 * r[33];
    float w2 = b2 * r[34];
    const float inv_s = 1.0f / fmaxf(w0 + w1 + w2, 1e-12f);
    w0 = w0 * inv_s;
    w1 = w1 * inv_s;
    w2 = w2 * inv_s;
    const float nx = r[0] * w0 + r[3] * w1 + r[6] * w2;
    const float ny = r[1] * w0 + r[4] * w1 + r[7] * w2;
    const float nz = r[2] * w0 + r[5] * w1 + r[8] * w2;
    const float inv_len = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, 1e-12f));
    planes[0 * plane + o] = nx * inv_len;
    planes[1 * plane + o] = ny * inv_len;
    planes[2 * plane + o] = nz * inv_len;
    planes[3 * plane + o] = r[9] * w0 + r[11] * w1 + r[13] * w2;
    planes[4 * plane + o] = r[10] * w0 + r[12] * w1 + r[14] * w2;
#pragma unroll
    for (int c = 0; c < 11; ++c) planes[(5 + c) * plane + o] = r[15 + c];
    planes[16 * plane + o] = px[i] - (r[26] * b0 + r[28] * b1 + r[30] * b2);
    planes[17 * plane + o] = py[i] - (r[27] * b0 + r[29] * b1 + r[31] * b2);
  }
}

template <int P, bool kShade>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream,
                   const float* edge, const float* shade, const int* tile_tris,
                   const int* counts, const int* big_list, int n_big, int cap,
                   int t_count, int rec_width, int tiles_x, int tile_w,
                   int tile_h, int width, int height, float* depth,
                   int* tri_id, float* b0, float* b1, float* planes) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_shade_kernel<P, kShade>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  raster_shade_kernel<P, kShade><<<grid, kThreads, smem, stream>>>(
      edge, shade, tile_tris, counts, big_list, n_big, cap, t_count,
      rec_width, tiles_x, tile_w, tile_h, width, height, depth, tri_id, b0,
      b1, planes);
  return cudaGetLastError();
}

}  // namespace

// C entry point (loaded with ctypes). Returns a cudaError_t code; 0 = OK.
extern "C" int raster_shade_launch(
    const float* edge, const float* shade, const int* tile_tris,
    const int* counts, const int* big_list, int n_big, int cap, int t_count,
    int rec_width, int n_tiles, int tiles_x, int tile_w, int tile_h,
    int width, int height, int smem, float* depth, int* tri_id, float* b0,
    float* b1, float* planes, void* stream) {
  const int n_px = tile_w * tile_h;
  if (n_px % kThreads != 0 || rec_width < kRec) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GTT_LAUNCH(P)                                                        \
  case P:                                                                    \
    return (int)launch<P, true>(grid, smem, s, edge, shade, tile_tris,       \
                                counts, big_list, n_big, cap, t_count,       \
                                rec_width, tiles_x, tile_w, tile_h, width,   \
                                height, depth, tri_id, b0, b1, planes);
  switch (n_px / kThreads) {
    GTT_LAUNCH(4)
    GTT_LAUNCH(8)
    GTT_LAUNCH(16)
    GTT_LAUNCH(32)
    GTT_LAUNCH(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GTT_LAUNCH
}

// C entry point of the visibility raster without shading (the refraction
// pass). n_big and cap must be multiples of 16. Returns a cudaError_t code.
extern "C" int visibility_launch(
    const float* edge, const int* tile_tris, const int* counts,
    const int* big_list, int n_big, int cap, int t_count, int n_tiles,
    int tiles_x, int tile_w, int tile_h, int width, int height, int smem,
    float* depth, int* tri_id, float* b0, float* b1, void* stream) {
  const int n_px = tile_w * tile_h;
  if (n_px % kThreads != 0 || n_big % kBlock != 0 || cap % kBlock != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GTT_LAUNCH(P)                                                        \
  case P:                                                                    \
    return (int)launch<P, false>(grid, smem, s, edge, nullptr, tile_tris,    \
                                 counts, big_list, n_big, cap, t_count, 0,   \
                                 tiles_x, tile_w, tile_h, width, height,     \
                                 depth, tri_id, b0, b1, nullptr);
  switch (n_px / kThreads) {
    GTT_LAUNCH(4)
    GTT_LAUNCH(8)
    GTT_LAUNCH(16)
    GTT_LAUNCH(32)
    GTT_LAUNCH(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef GTT_LAUNCH
}
