// The cloud march and the cloud shadow for Hopper (sm_90a): one thread a
// ray, the procedural noise evaluated in registers.
//
// They replace no TPU Pallas kernel: the JAX package computes the clouds
// with jnp ops (garden_tpu/render/clouds.py), and the port's plain versions
// are garden_tpu_torch/render/clouds.py:render_clouds_plain and
// cloud_shadow_plain, over ops/noise.py. Those run each multiply, hash and
// select as its own elementwise op: a density evaluation (two Perlin-Worley
// and one Worley noise, 97 hashed lattice cells) is ~4,000 launches over
// every ray, and a 10-step march of three evaluations a step ~120,000.
// cloud_march_launch and cloud_shadow_launch compute the same values in
// one launch each.
//
// What they compute. cloud_march: for each half-res view ray (n x 3), the
// set-up of render_clouds (the ray and the sun normalized, the slab's entry
// and exit distances, the phase and the tints), its `steps`-step march
// (at each step the density at the sample and at two taps toward the sun,
// the powder and Beer-Lambert terms), the alpha, the rgb division and the
// horizon fade; it writes rgb (n x 3) and alpha (n). A ray with
// mu <= 0.02 (below the layer) writes 0 and 0 and marches nothing: the
// plain version's masked arithmetic gives exactly that. cloud_shadow: for
// each ground point (n x 3), the density where its sun ray meets the cloud
// base and 400 units beyond, and the transmittance exp(-2.5 d).
//
// Equal bits. The plain versions run on the card as PyTorch's CUDA ops,
// and each step here is the same float32 operation in the same order, by
// the rules of torch_float.cuh (the host passes the reciprocals of the
// Python divisors, rounded as PyTorch rounds them). The hash works in
// native uint32, where ops/noise.py carries the same 32 bits in int64.
//
// What bounds it on the H100: operations. A density evaluation is ~3,993
// float and integer operations on registers alone (benchmark/metrics/
// clouds_roofline_pct.sim.py counts them), a ray reads 12 bytes and
// writes 16; at the world sim's frame the march and the shadow need 37.8
// GFLOP, 0.565 ms at 67 TFLOP/s. -fmad=false and the integer multiplies
// of the hash (half the float rate) keep the kernel well above that.
//
// What the design does about it. A thread holds its ray's whole state in
// registers; the sky's rays are whole rows of the half-res image, so a
// warp's rays are all up or all down except on the horizon's row, and the
// march has a fixed trip count. The step loop stays rolled and the density
// is one function called from three sites, so the source compiles in
// seconds. The Worley jitter's 10-bit integers become floats through the
// exponent field (2^23 + k - 2^23, exact) rather than the slow integer
// conversion. While a profiler records, the march also counts its up rays
// (a warp ballot and one atomic a warp).

#include <cuda_runtime.h>
#include <stdint.h>

#include "torch_float.cuh"

namespace {

constexpr int kThreads = 256;

constexpr uint32_t kPrimeX = 501125321u;
constexpr uint32_t kPrimeY = 1136930381u;
constexpr uint32_t kPrimeZ = 1720413743u;

// clouds.BRIGHT and clouds.DARK, the sunlit and the ambient tint
__constant__ const float kBright[3] = {F32(1.0), F32(0.98), F32(0.95)};
__constant__ const float kDark[3] = {F32(0.25), F32(0.28), F32(0.34)};

__device__ __forceinline__ uint32_t seed_word(int seed) {
  return static_cast<uint32_t>(seed) * 0x9E3779B9u + 0x85EBCA6Bu;
}

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h *= 0x27D4EB2Fu;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  return h ^ (h >> 13);
}

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ float grad3(uint32_t h, float fx, float fy, float fz) {
  const uint32_t g = (h >> 3) % 12u;
  const float u = g < 8u ? fx : fy;
  const float v = g < 4u ? fy : ((g == 12u || g == 14u) ? fx : fz);
  return ((g & 1u) == 0u ? u : -u) + ((g & 2u) == 0u ? v : -v);
}

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + t * (b - a);
}

// noise.perlin3
__device__ __forceinline__ float perlin3(float x, float y, float z, int seed) {
  const int ix = static_cast<int>(floorf(x));
  const int iy = static_cast<int>(floorf(y));
  const int iz = static_cast<int>(floorf(z));
  const float fx = x - static_cast<float>(ix);
  const float fy = y - static_cast<float>(iy);
  const float fz = z - static_cast<float>(iz);
  const float u = fade(fx), v = fade(fy), w = fade(fz);
  const uint32_t sw = seed_word(seed);
  const uint32_t hx0 = sw ^ (static_cast<uint32_t>(ix) * kPrimeX);
  const uint32_t hx1 = sw ^ ((static_cast<uint32_t>(ix) + 1u) * kPrimeX);
  const uint32_t hy0 = static_cast<uint32_t>(iy) * kPrimeY;
  const uint32_t hy1 = (static_cast<uint32_t>(iy) + 1u) * kPrimeY;
  const uint32_t hz0 = static_cast<uint32_t>(iz) * kPrimeZ;
  const uint32_t hz1 = (static_cast<uint32_t>(iz) + 1u) * kPrimeZ;
  const float gx = fx - 1.0f, gy = fy - 1.0f, gz = fz - 1.0f;
  const float n000 = grad3(avalanche(hx0 ^ hy0 ^ hz0), fx, fy, fz);
  const float n100 = grad3(avalanche(hx1 ^ hy0 ^ hz0), gx, fy, fz);
  const float n010 = grad3(avalanche(hx0 ^ hy1 ^ hz0), fx, gy, fz);
  const float n110 = grad3(avalanche(hx1 ^ hy1 ^ hz0), gx, gy, fz);
  const float n001 = grad3(avalanche(hx0 ^ hy0 ^ hz1), fx, fy, gz);
  const float n101 = grad3(avalanche(hx1 ^ hy0 ^ hz1), gx, fy, gz);
  const float n011 = grad3(avalanche(hx0 ^ hy1 ^ hz1), fx, gy, gz);
  const float n111 = grad3(avalanche(hx1 ^ hy1 ^ hz1), gx, gy, gz);
  const float nxy0 = lerp(lerp(n000, n100, u), lerp(n010, n110, u), v);
  const float nxy1 = lerp(lerp(n001, n101, u), lerp(n011, n111, u), v);
  return lerp(nxy0, nxy1, w) * F32(1.1547);
}

// k < 2^23 as a float, exactly: (float)k without the integer conversion
__device__ __forceinline__ float small_uint_to_float(uint32_t k) {
  return __uint_as_float(0x4B000000u | k) - 8388608.0f;
}

// noise.worley3
__device__ __forceinline__ float worley3(float x, float y, float z, int seed) {
  const float flx = floorf(x), fly = floorf(y), flz = floorf(z);
  const float fx = x - flx, fy = y - fly, fz = z - flz;
  const uint32_t sw = seed_word(seed);
  uint32_t hx[3], hy[3], hz[3];
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float off = static_cast<float>(o - 1);
    hx[o] = sw ^ (static_cast<uint32_t>(static_cast<int>(flx + off)) * kPrimeX);
    hy[o] = static_cast<uint32_t>(static_cast<int>(fly + off)) * kPrimeY;
    hz[o] = static_cast<uint32_t>(static_cast<int>(flz + off)) * kPrimeZ;
  }
  const float inv1023 = 1.0f / 1023.0f;   // PyTorch's `/ 1023.0`
  float best = 8.0f;
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        const uint32_t h = avalanche(hx[ox] ^ hy[oy] ^ hz[oz]);
        const float jx = small_uint_to_float(h & 0x3FFu) * inv1023;
        const float jy = small_uint_to_float((h >> 10) & 0x3FFu) * inv1023;
        const float jz = small_uint_to_float((h >> 20) & 0x3FFu) * inv1023;
        const float dx = (jx + static_cast<float>(ox - 1)) - fx;
        const float dy = (jy + static_cast<float>(oy - 1)) - fy;
        const float dz = (jz + static_cast<float>(oz - 1)) - fz;
        best = fminf(best, dx * dx + dy * dy + dz * dz);
      }
    }
  }
  return clamp_max(sqrtf(best), 1.0f);
}

// noise.perlin_worley3
__device__ __forceinline__ float perlin_worley3(float x, float y, float z, int seed) {
  const float p = perlin3(x, y, z, seed) * 0.5f + 0.5f;
  const float w = 1.0f - worley3(x, y, z, seed + 31);
  return clamp((p - (1.0f - w)) / clamp_min(w, F32(1e-3)), 0.0f, 1.0f);
}

// clouds._density at world position (px, py, pz); `tw` is time * 0.01 and
// `cov` 1 - coverage * 1.6, both as PyTorch rounds them. One body, called
// from every site.
__device__ __noinline__ float density(float px, float py, float pz, float tw,
                                      float cov, int seed) {
  const float x = px * F32(0.004) + tw;
  const float y = py * F32(0.01);
  const float z = pz * F32(0.004);
  float base = perlin_worley3(x, z, y, seed);
  base = F32(0.7) * base
         + F32(0.3) * perlin_worley3(x * 2.0f, z * 2.0f, y * 2.0f, seed + 3);
  const float shaped = clamp((base - cov) * (1.0f / F32(0.4)), 0.0f, 1.0f);
  const float detail = 1.0f - worley3(x * 6.0f, z * 6.0f, y * 6.0f, seed + 5);
  return clamp(shaped - (1.0f - shaped) * detail * F32(0.3), 0.0f, 1.0f);
}

// The march's constants, each a float32 as the plain version's op sees it.
struct March {
  float cam_h;      // camera_height
  float base;       // base_km
  float c0, c1;     // base_km - camera_height, top_km - camera_height
  float inv_thick;  // 1 / (top_km - base_km)
  float inv_steps;  // 1 / steps
  float cov;        // 1 - coverage * 1.6
  int steps;
  int seed;
};

__global__ void __launch_bounds__(kThreads)
cloud_march_kernel(const float* __restrict__ view, const float* __restrict__ sun,
                   const float* __restrict__ time, int n, March m,
                   float* __restrict__ rgb, float* __restrict__ alpha,
                   unsigned long long* __restrict__ up_count) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool up = false;
  if (i < n) {
    float vx = view[3 * i], vy = view[3 * i + 1], vz = view[3 * i + 2];
    normalize(vx, vy, vz);
    const float mu = vy;
    up = mu > F32(0.02);
    float r = 0.0f, g = 0.0f, b = 0.0f, a_out = 0.0f;
    if (up) {
      float lx = sun[0], ly = sun[1], lz = sun[2];
      normalize(lx, ly, lz);
      const float tw = time[0] * F32(0.01);
      const float mu_safe = clamp_min(mu, F32(0.02));
      const float t0 = m.c0 / mu_safe;
      const float t1 = m.c1 / mu_safe;
      const float dt = clamp_min(t1 - t0, 0.0f) * m.inv_steps;

      // phase: silver lining toward the sun (x ** 8 by squaring)
      float c = clamp(dot3(vx, vy, vz, lx, ly, lz), 0.0f, 1.0f);
      c = c * c;
      c = c * c;
      const float phase = F32(0.4) * (c * c) * 4.0f + F32(0.6);
      const float sun_light = clamp(ly, 0.0f, 1.0f);
      const float tint = F32(0.4) * phase + F32(0.9);
      const float dark_k = F32(0.7) * sun_light + F32(0.3);

      // the taps toward the sun
      const float ax = lx * 200.0f, ay = ly * 200.0f, az = lz * 200.0f;
      const float bx = lx * 600.0f, by = ly * 600.0f, bz = lz * 600.0f;
      float trans = 1.0f, light = 0.0f;
#pragma unroll 1
      for (int s = 0; s < m.steps; ++s) {
        const float t = t0 + static_cast<float>(s + 0.5) * dt;
        const float px = vx * t * 1000.0f;
        const float py = vy * t * 1000.0f;
        const float pz = vz * t * 1000.0f;
        const float h01 = ((t * mu + m.cam_h) - m.base) * m.inv_thick;
        const float falloff = clamp(4.0f * h01 * (1.0f - h01), 0.0f, 1.0f);
        const float dens = density(px, py, pz, tw, m.cov, m.seed) * falloff;
        const float occ =
            density(px + ax, py + ay, pz + az, tw, m.cov, m.seed) * 0.5f
            + density(px + bx, py + by, pz + bz, tw, m.cov, m.seed) * F32(0.3);
        const float shade = expf(-occ * 2.0f);
        const float powder = 1.0f - expf(-dens * 4.0f);
        const float absorb = dens * dt * 3.0f;
        const float e = expf(-absorb);
        const float contrib = trans * (1.0f - e);
        light = light + contrib * shade * (F32(0.6) * powder + F32(0.4));
        trans = trans * e;
      }
      const float a = 1.0f - trans;
      const float a4 = a * 0.25f;
      const float a_safe = clamp_min(a, F32(1e-5));
      r = (light * ((tint * kBright[0]) * sun_light) + a4 * (kDark[0] * dark_k)) / a_safe;
      g = (light * ((tint * kBright[1]) * sun_light) + a4 * (kDark[1] * dark_k)) / a_safe;
      b = (light * ((tint * kBright[2]) * sun_light) + a4 * (kDark[2] * dark_k)) / a_safe;
      const float fade = clamp((mu - F32(0.02)) * (1.0f / F32(0.08)), 0.0f, 1.0f);
      a_out = a * fade;
    }
    rgb[3 * i] = r;
    rgb[3 * i + 1] = g;
    rgb[3 * i + 2] = b;
    alpha[i] = a_out;
  }
  if (up_count != nullptr) {
    const unsigned ballot = __ballot_sync(0xffffffffu, up);
    if ((threadIdx.x & 31) == 0 && ballot != 0u)
      atomicAdd(up_count, static_cast<unsigned long long>(__popc(ballot)));
  }
}

__global__ void __launch_bounds__(kThreads)
cloud_shadow_kernel(const float* __restrict__ pos, const float* __restrict__ sun,
                    const float* __restrict__ time, int n, float base_units,
                    float cov, int seed, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float lx = sun[0], ly = sun[1], lz = sun[2];
  normalize(lx, ly, lz);
  const float tw = time[0] * F32(0.01);
  const float mu = clamp_min(ly, F32(0.05));
  const float py = pos[3 * i + 1];
  // distance along the sun ray to the cloud base
  const float t = (base_units - py) / mu;
  const float qx = pos[3 * i] + lx * t;
  const float qy = py + ly * t;
  const float qz = pos[3 * i + 2] + lz * t;
  float d = density(qx, qy, qz, tw, cov, seed);
  d = F32(0.7) * d
      + F32(0.3) * density(qx + lx * 400.0f, qy + ly * 400.0f, qz + lz * 400.0f,
                           tw, cov, seed);
  out[i] = expf(-d * 2.5f);
}

}  // namespace

// C entry point of the cloud march over n rays. view (n x 3), sun (3,),
// time (1,) float32 on the card; the constants as the struct March names
// them; rgb (n x 3) and alpha (n) are written; up_count, when not null,
// gains the number of rays with mu > 0.02. Returns a cudaError_t code.
extern "C" int cloud_march_launch(
    const float* view, const float* sun, const float* time, int n, float cam_h,
    float base, float c0, float c1, float inv_thick, float inv_steps, float cov,
    int steps, int seed, float* rgb, float* alpha, unsigned long long* up_count,
    void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const March m{cam_h, base, c0, c1, inv_thick, inv_steps, cov, steps, seed};
  cloud_march_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(view, sun, time, n, m,
                                                            rgb, alpha, up_count);
  return (int)cudaGetLastError();
}

// C entry point of the cloud shadow over n ground points: pos (n x 3),
// sun (3,), time (1,); base_units is base_km * 1000 and cov as above; out
// (n) receives the sun's transmittance. Returns a cudaError_t code.
extern "C" int cloud_shadow_launch(const float* pos, const float* sun,
                                   const float* time, int n, float base_units,
                                   float cov, int seed, float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cloud_shadow_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(pos, sun, time, n,
                                                             base_units, cov, seed,
                                                             out);
  return (int)cudaGetLastError();
}
