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
// What bounds it on the H100. The outputs: 22 floats a pixel written once
// (~182 MB at 1920x1080, >= 0.054 ms; 4 floats without the shading phase).
// The test of a (slot, pixel) pair is ~22 float operations, and with
// -fmad=false each is one instruction. The first design, one block per 128x32
// tile testing every slot of its list at every pixel, spent most of its
// time on slots that reach none of the tile's pixels (every tile scans the
// whole 32-slot big list, the ground's 11 m triangles and the nearest boxes'
// faces, and grid entries are binned by bounding box), and the tiles with
// the longest lists ended the launch.
//
// What the design does about it. Each tile runs as row bands of 1024
// pixels (a 128x32 tile is four 128x8 bands), one block of 256 threads
// each, a thread owning kPixels = 4 rows of one column (tile widths divide
// 256), its best depth, barycentrics and slot in registers; four blocks
// share an SM. Small bands spread the longest lists over more SMs (on the
// H100, 1, 2 and 4 bands a tile ran K1 in 0.098, 0.083 and 0.080 ms;
// PERF.md).
// 1. The cull, one thread a scanned slot, exactly (cull.cuh, edge form, as
//    depth_dense's), over the band: the edges' largest values over the
//    band's pixel centres are taken at its corner centres, and a slot whose
//    edge stays < 0 there is never a candidate at any pixel of the band
//    (culling over the whole tile instead ran K1 2% and K5 8% slower;
//    PERF.md). The survivors' edge records and triangle ids are compacted
//    into shared memory IN SCAN ORDER (blocks in list order, bit-reversed
//    inside a block; warp ballots and a block prefix sum). The sequential
//    strict > over the survivors then picks the same winner among equal
//    depths as the scan over every slot: removing slots that are never
//    candidates cannot change a winner. `kept` (optional, one int a band of
//    the band grid) receives the survivor count.
// 2. Each thread walks the survivors for its pixels, every thread reading
//    the same record at the same time (a broadcast). The column's share of
//    each edge, a_k px, is computed once a slot (the same product, so the
//    same value). A warp holds 32 pixels of one row: where none of them is
//    inside the triangle (a warp vote), the depth test is skipped.
// 3. The finish reads the winner's shading record from device memory by
//    its triangle id (neighbouring pixels mostly share a winner, so the
//    loads hit the cache); staging the survivors' records in shared memory
//    instead ran 10% slower (PERF.md).
// Pixels of one warp are 32 consecutive columns, so every output store is
// coalesced. Compiled with -fmad=false so that each multiply and add rounds
// as the plain PyTorch version's separate ops do; a contracted FMA would
// move edge values by an ulp and flip tri_id on triangle edges.

#include <cuda_runtime.h>

#include "cull.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kEdge = 16;
constexpr int kRec = 36;
constexpr int kPlanes = 18;
constexpr int kBlock = 16;
constexpr int kPixels = 4;               // pixels a thread; a band is 1024

// One block per row band of 1024 pixels (a 128x32 tile is four 128x8
// bands), kPixels rows of one column a thread; each band culls the tile's
// slots over its own rows. Four blocks resident per SM (at most 64
// registers).
template <bool kShade>
__global__ void __launch_bounds__(kThreads, 4)
raster_shade_kernel(const float* __restrict__ edge,
                    const float* __restrict__ shade,
                    const int* __restrict__ tile_tris,
                    const int* __restrict__ counts,
                    const int* __restrict__ big_list,
                    int n_big, int cap, int rec_width,
                    int tiles_x, int tile_w, int tile_h, int bands,
                    int width, int height,
                    float* __restrict__ depth, int* __restrict__ tri_id,
                    float* __restrict__ b0_out, float* __restrict__ b1_out,
                    float* __restrict__ planes, int* __restrict__ kept) {
  extern __shared__ float smem[];
  __shared__ int s_warp[kWarps];
  const int n_slots = (n_big + cap + kBlock - 1) / kBlock * kBlock;
  float* s_edge = smem;                                  // survivors [][16]
  int* s_tri = reinterpret_cast<int*>(smem + n_slots * kEdge);  // their ids

  const int tile = blockIdx.x / bands;
  const int band = blockIdx.x % bands;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int band_h = tile_h / bands;
  const int brow = ty * bands + band;           // the band's row of the band grid
  if (brow * band_h >= height) return;          // nothing to store
  int n_scan = (counts[tile] + n_big + kBlock - 1) / kBlock * kBlock;
  if (n_scan > n_slots) n_scan = n_slots;

  // 1. the cull over the band, one thread a scanned slot, in scan order
  const cull::Corners corners = cull::tile_corners(tx, brow, tile_w, band_h);
  int n_keep = 0;
  for (int r0 = 0; r0 < n_scan; r0 += kThreads) {
    const int r = r0 + threadIdx.x;                      // rank in scan order
    const int s = (r & ~(kBlock - 1)) + (int)(__brev((unsigned)(r & (kBlock - 1))) >> 28);
    int id = -1;
    if (r < n_scan) {
      if (s < n_big) {
        id = big_list[s];
      } else if (s - n_big < cap) {
        id = tile_tris[(size_t)tile * cap + (s - n_big)];
      }
    }
    float d[16];
    int flags = 0;
    if (id >= 0) {
      cull::load_record(edge, id, d);
      flags = cull::edge_flags(d, corners, nullptr, 0);
    }
    int total;
    const int pos = n_keep + cull::block_prefix<kWarps>(flags != 0, s_warp, &total);
    if (flags) {
#pragma unroll
      for (int k = 0; k < kEdge; ++k) s_edge[pos * kEdge + k] = d[k];
      s_tri[pos] = id;
    }
    n_keep += total;
  }
  if (kept != nullptr && threadIdx.x == 0) kept[brow * tiles_x + tx] = n_keep;
  __syncthreads();

  // 2. the nearest survivor of each of this thread's pixels
  const int col = threadIdx.x % tile_w;
  const int row0 = band * band_h + threadIdx.x / tile_w;
  const int row_step = kThreads / tile_w;
  const float px = (float)(tx * tile_w) + 0.5f + (float)col;
  const float py0 = (float)(ty * tile_h) + 0.5f + (float)row0;
  constexpr int P = kPixels;
  float best_z[P], best_b0[P], best_b1[P];
  int best_s[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    best_z[i] = 0.0f;
    best_b0[i] = 0.0f;
    best_b1[i] = 0.0f;
    best_s[i] = -1;
  }
  for (int s = 0; s < n_keep; ++s) {
    const float* d = s_edge + s * kEdge;
    const float ax0 = d[0] * px, ax1 = d[1] * px;
    const float bb0 = d[3], bb1 = d[4], c0 = d[6], c1 = d[7];
    const float sum = d[9], z2 = d[10], dz0 = d[11], dz1 = d[12];
    const float inv_area = d[13];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float py = py0 + (float)(i * row_step);
      const float e0 = ax0 + bb0 * py + c0;
      const float e1 = ax1 + bb1 * py + c1;
      const float e2 = sum - e0 - e1;
      const bool inside = e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
      // no pixel of this warp row is a candidate: skip its depth test
      if (!__any_sync(0xffffffffu, inside)) continue;
      const float w0 = e0 * inv_area;
      const float w1 = e1 * inv_area;
      const float z = z2 + w0 * dz0 + w1 * dz1;
      const bool cand = inside && z <= 1.0f && z > 0.0f;
      if (cand && z > best_z[i]) {
        best_z[i] = z;
        best_b0[i] = w0;
        best_b1[i] = w1;
        best_s[i] = s;
      }
    }
  }

  // 3. outputs, and the G-buffer finish from the winner's shading record
  const int x = tx * tile_w + col;
  if (x >= width) return;
  const size_t plane = (size_t)width * height;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int y = ty * tile_h + row0 + i * row_step;
    if (y >= height) continue;
    const size_t o = (size_t)y * width + x;
    const int s = best_s[i];
    const int t = s < 0 ? -1 : s_tri[s];
    depth[o] = best_z[i];
    b0_out[o] = best_b0[i];
    b1_out[o] = best_b1[i];
    tri_id[o] = t;
    if (!kShade) continue;
    if (s < 0) {
#pragma unroll
      for (int c = 0; c < kPlanes; ++c) planes[c * plane + o] = 0.0f;
      continue;
    }
    const float* r = shade + (size_t)t * rec_width;
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
    const float py = py0 + (float)(i * row_step);
    planes[16 * plane + o] = px - (r[26] * b0 + r[28] * b1 + r[30] * b2);
    planes[17 * plane + o] = py - (r[27] * b0 + r[29] * b1 + r[31] * b2);
  }
}

template <bool kShade>
cudaError_t launch(dim3 grid, int smem, cudaStream_t stream,
                   const float* edge, const float* shade, const int* tile_tris,
                   const int* counts, const int* big_list, int n_big, int cap,
                   int rec_width, int tiles_x, int tile_w,
                   int tile_h, int bands, int width, int height, float* depth,
                   int* tri_id, float* b0, float* b1, float* planes, int* kept) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        raster_shade_kernel<kShade>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  raster_shade_kernel<kShade><<<grid, kThreads, smem, stream>>>(
      edge, shade, tile_tris, counts, big_list, n_big, cap, rec_width,
      tiles_x, tile_w, tile_h, bands, width, height, depth, tri_id, b0, b1,
      planes, kept);
  return cudaGetLastError();
}

// Row bands of 1024 pixels a tile; 0 when the tile is not a kernel shape
// (its width must divide the block's 256 threads).
int bands_of(int tile_w, int tile_h) {
  if (tile_w <= 0 || tile_h <= 0 || kThreads % tile_w != 0 ||
      tile_w * tile_h % (kThreads * kPixels) != 0)
    return 0;
  return tile_w * tile_h / (kThreads * kPixels);
}

}  // namespace

// C entry point (loaded with ctypes). Returns a cudaError_t code; 0 = OK.
// Each tile runs as row bands of 1024 pixels, one block each (the tile's
// width divides 256, its pixels are a multiple of 1024); `smem` is at
// least ceil16(n_big + cap) * 68 bytes; `kept` (one int for each band of
// the band grid, ceil(height / band_h) rows of tiles_x, or null) receives
// each band's surviving slots.
extern "C" int raster_shade_launch(
    const float* edge, const float* shade, const int* tile_tris,
    const int* counts, const int* big_list, int n_big, int cap,
    int rec_width, int n_tiles, int tiles_x, int tile_w, int tile_h,
    int width, int height, int smem, float* depth, int* tri_id,
    float* b0, float* b1, float* planes, int* kept, void* stream) {
  const int n_slots = (n_big + cap + kBlock - 1) / kBlock * kBlock;
  const int bands = bands_of(tile_w, tile_h);
  if (rec_width < kRec || bands == 0 || smem < n_slots * (kEdge + 1) * 4)
    return (int)cudaErrorInvalidValue;
  return (int)launch<true>(dim3(n_tiles * bands), smem,
                           static_cast<cudaStream_t>(stream), edge, shade,
                           tile_tris, counts, big_list, n_big, cap, rec_width,
                           tiles_x, tile_w, tile_h, bands, width, height, depth,
                           tri_id, b0, b1, planes, kept);
}

// C entry point of the visibility raster without shading (the refraction
// pass). n_big and cap must be multiples of 16; `smem` at least
// (n_big + cap) * 68 bytes; tiles and `kept` as above. Returns a
// cudaError_t code.
extern "C" int visibility_launch(
    const float* edge, const int* tile_tris, const int* counts,
    const int* big_list, int n_big, int cap, int n_tiles,
    int tiles_x, int tile_w, int tile_h, int width, int height, int smem,
    float* depth, int* tri_id, float* b0, float* b1, int* kept, void* stream) {
  const int bands = bands_of(tile_w, tile_h);
  if (n_big % kBlock != 0 || cap % kBlock != 0 || bands == 0 ||
      smem < (n_big + cap) * (kEdge + 1) * 4)
    return (int)cudaErrorInvalidValue;
  return (int)launch<false>(dim3(n_tiles * bands), smem,
                            static_cast<cudaStream_t>(stream), edge, nullptr,
                            tile_tris, counts, big_list, n_big, cap, 0, tiles_x,
                            tile_w, tile_h, bands, width, height, depth, tri_id,
                            b0, b1, nullptr, kept);
}
