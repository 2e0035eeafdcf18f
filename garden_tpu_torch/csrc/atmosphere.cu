// The sky and the aerial perspective for Hopper (sm_90a): one thread a
// ray, the ray's whole march in registers.
//
// They replace no TPU Pallas kernel: the JAX package computes the
// atmosphere with jnp ops (garden_tpu/render/atmosphere.py), and the port's
// plain versions are garden_tpu_torch/render/atmosphere.py:
// sky_radiance_plain and aerial_perspective_plain. Those run each multiply,
// exp and select as its own elementwise op over every ray: a 12-step sky is
// ~1,570 launches, each over (rays x 3) float32 intermediates in memory.
// sky_radiance_launch and aerial_perspective_launch compute the same values
// in one launch each.
//
// What they compute. sky_radiance: for each view ray (n x 3), the ray and
// the sun normalized, the ray's exits through the top of the atmosphere
// and into the ground, a `steps`-sample march (at each sample the Rayleigh
// and Mie densities, the sun's transmittance from the Chapman airmass, the
// view transmittance and the in-scatter), the multi-scatter floor, the
// ground albedo of rays that hit the earth and the sun disk; it writes the
// radiance (n x 3). aerial_perspective: for each pixel's view ray (n x 3)
// and its depth in km (n), the same march over `steps` samples up to the
// surface; it writes the transmittance and the in-scatter (n x 3 each).
// Both read the sun's direction from the card, so nothing is read back to
// the host.
//
// Equal bits. The plain versions run on the card as PyTorch's CUDA ops,
// and each step here is the same float32 operation in the same order, by
// the rules of torch_float.cuh: the host passes the values that depend on
// the call (the camera height's products, 1 / steps) rounded as PyTorch
// rounds them; the Mie phase's torch.pow(x, 1.5) is powf; a select of the
// plain version (torch.where) computes only the branch it keeps here,
// which gives the kept branch's bits.
//
// What bounds it on the H100. A march sample is ~130 float operations (two
// Chapman airmasses, seven exponentials and the three channels' sums; the
// count is chip_smoke.py's OPS_ATM_SAMPLE), a ray reads 12 bytes (16 with a
// depth) and writes 12 (24 for the aerial perspective). At play's frame the
// four calls march ~16.6 M samples: the skies are bound by their
// operations (~0.019 ms at 67 TFLOP/s), the aerial perspective by its ~83
// MB (~0.025 ms at 3.35 TB/s).
//
// What the design does about it. A thread holds its ray's radiance and
// optical depth, three channels each, in registers through the march, so
// the intermediates the plain version writes and reads never leave the
// chip. The sun's zenith cosine is the same for every thread, so the
// Chapman branch never diverges within a warp. The step loop stays rolled.

#include <cuda_runtime.h>

#include "torch_float.cuh"

namespace {

constexpr int kThreads = 256;

// atmosphere.py's constants, as Python doubles
constexpr double kPi = 3.141592653589793;   // math.pi
constexpr double kRGround = 6360.0;         // R_GROUND, km
constexpr double kHRayleigh = 8.0;          // H_RAYLEIGH, km
constexpr double kHMie = 1.2;               // H_MIE, km
constexpr double kMieScat = 3.996e-3;       // BETA_MIE_SCAT, 1/km
constexpr double kMieAbs = 4.4e-3;          // BETA_MIE_ABS, 1/km
constexpr double kMieG = 0.8;               // MIE_G
constexpr double kMieGG = kMieG * kMieG;    // _phase_mie's gg
constexpr double kSunIntensity = 16.0;      // SUN_INTENSITY

// BETA_RAYLEIGH and BETA_OZONE (1/km); the multi-scatter tint and the
// ground albedo of sky_radiance
__constant__ const float kBetaRayleigh[3] = {F32(5.802e-3), F32(13.558e-3), F32(33.1e-3)};
__constant__ const float kBetaOzone[3] = {F32(0.650e-3), F32(1.881e-3), F32(0.085e-3)};
__constant__ const float kMultiScatter[3] = {F32(0.35), F32(0.45), F32(0.7)};
__constant__ const float kGround[3] = {F32(0.3), F32(0.25), F32(0.2)};

// atmosphere._chapman(x, cos_chi); only the branch torch.where keeps
__device__ __forceinline__ float chapman(float x, float cos_chi) {
  const float c = sqrtf(x * F32(2.0 * kPi));
  if (cos_chi >= 0.0f) return c / (c * cos_chi + 1.0f);
  const float sin_chi = sqrtf(clamp_min(1.0f - cos_chi * cos_chi, 0.0f));
  const float x_horizon = x * sin_chi;
  const float ch0 = sqrtf(x_horizon * F32(2.0 * kPi)) * F32(0.5) + 1.0f;
  return 2.0f * expf(x - x_horizon) * ch0 - c / (c * (-cos_chi) + 1.0f);
}

// atmosphere._optical_depth_to_space; inv_scale is 1 / scale_height as
// PyTorch's division by it multiplies
__device__ __forceinline__ float optical_depth(float h, float cos_z, float scale,
                                               float inv_scale) {
  const float x = (h + F32(kRGround)) * inv_scale;
  const float od = scale * expf(-h * inv_scale) * chapman(x, cos_z);
  return clamp_max(od, F32(1e4));
}

// atmosphere.sun_transmittance at height h (km) and sun zenith cosine
// cos_z, into t (3)
__device__ __forceinline__ void sun_transmittance(float h, float cos_z, float* t) {
  const float od_r = optical_depth(h, cos_z, F32(kHRayleigh), 1.0f / F32(kHRayleigh));
  const float od_m = optical_depth(h, cos_z, F32(kHMie), 1.0f / F32(kHMie));
  // R_GROUND / (R_GROUND + h): a Python number over a tensor is the
  // tensor's reciprocal times the number
  const float sin_h = (1.0f / (clamp_min(h, 0.0f) + F32(kRGround))) * F32(kRGround);
  const float horizon_mu = -sqrtf(clamp_min(1.0f - sin_h * sin_h, 0.0f));
  const bool blocked = cos_z < horizon_mu;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float tau = (od_r * kBetaRayleigh[c] + od_m * F32(kMieScat + kMieAbs))
                      + od_r * kBetaOzone[c] * F32(0.1);
    t[c] = blocked ? 0.0f : expf(-tau);
  }
}

__device__ __forceinline__ float phase_rayleigh(float cos_t) {
  return F32(3.0 / (16.0 * kPi)) * (1.0f + cos_t * cos_t);
}

__device__ __forceinline__ float phase_mie(float cos_t) {
  const float num = F32(3.0 / (8.0 * kPi)) * (F32(1.0 - kMieGG) * (1.0f + cos_t * cos_t));
  const float base = clamp_min(F32(1.0 + kMieGG) - F32(2.0 * kMieG) * cos_t, F32(1e-6));
  return num / (F32(2.0 + kMieGG) * powf(base, 1.5f));
}

// One march sample of sky_radiance and aerial_perspective at height y
// (clamped) and step length dt: the view transmittance, in-scatter and
// optical depth of each channel, in place.
__device__ __forceinline__ void march_sample(float y, float dt, float mu_sun, float ph_r,
                                             float ph_m, float* lum, float* tau) {
  const float dens_r = expf(-y * (1.0f / F32(kHRayleigh)));
  const float dens_m = expf(-y * (1.0f / F32(kHMie)));
  float t_sun[3];
  sun_transmittance(y, mu_sun, t_sun);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float step_tau =
        (kBetaRayleigh[c] * dens_r + F32(kMieScat + kMieAbs) * dens_m) * dt;
    const float t_view = expf(-(tau[c] + F32(0.5) * step_tau));
    const float scat = kBetaRayleigh[c] * dens_r * ph_r + F32(kMieScat) * dens_m * ph_m;
    lum[c] = lum[c] + F32(kSunIntensity) * scat * t_sun[c] * t_view * dt;
    tau[c] = tau[c] + step_tau;
  }
}

// The values of a sky_radiance call that depend on the camera height h0
// and the step count, each a float32 as the plain version's op sees it.
struct Sky {
  float h0;         // camera_height_km
  float r0;         // R_GROUND + h0
  float r0_sq;      // r0 * r0
  float two_r0;     // 2 r0
  float top_c;      // R_TOP^2 - r0^2
  float ground_c;   // R_GROUND^2 - r0^2
  float inv_steps;  // 1 / steps
  int steps;
};

__global__ void __launch_bounds__(kThreads)
sky_radiance_kernel(const float* __restrict__ view, const float* __restrict__ sun, int n,
                    Sky s, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float vx = view[3 * i], vy = view[3 * i + 1], vz = view[3 * i + 2];
  normalize(vx, vy, vz);
  float lx = sun[0], ly = sun[1], lz = sun[2];
  normalize(lx, ly, lz);
  const float mu_v = vy;
  const float b = mu_v * s.r0;
  const float t_top = -b + sqrtf(clamp_min(b * b + s.top_c, 0.0f));
  const float disc_g = b * b + s.ground_c;
  const bool hits_ground = (mu_v < 0.0f) && (disc_g > 0.0f);
  const float t_ground = -b - sqrtf(clamp_min(disc_g, 0.0f));
  const float t_max = clamp(hits_ground ? clamp_min(t_ground, 0.0f) : t_top, 0.0f, 400.0f);

  const float cos_sun = dot3(vx, vy, vz, lx, ly, lz);
  const float ph_r = phase_rayleigh(cos_sun);
  const float ph_m = phase_mie(cos_sun);
  const float mu_sun = ly;
  float lum[3] = {0.0f, 0.0f, 0.0f}, tau[3] = {0.0f, 0.0f, 0.0f};
  const float dt = t_max * s.inv_steps;
#pragma unroll 1
  for (int k = 0; k < s.steps; ++k) {
    const float t = static_cast<float>(k + 0.5) * dt;
    const float y = sqrtf((t * t + s.r0_sq) + s.two_r0 * t * mu_v) - F32(kRGround);
    march_sample(clamp_min(y, 0.0f), dt, mu_sun, ph_r, ph_m, lum, tau);
  }

  const float mu_c = clamp(mu_sun, 0.0f, 1.0f);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    lum[c] = lum[c] + F32(0.075) * kMultiScatter[c] * mu_c * (1.0f - expf(-tau[c]));
  if (hits_ground) {
    float t_ground_sun[3];
    sun_transmittance(0.0f, mu_sun, t_ground_sun);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ground = kGround[c] * F32(kSunIntensity / kPi) * mu_c * t_ground_sun[c];
      lum[c] = ground * expf(-tau[c]) + lum[c];
    }
  } else if (cos_sun > F32(0.99955)) {   // the sun disk
    float t_sun[3];
    sun_transmittance(s.h0, mu_sun, t_sun);
#pragma unroll
    for (int c = 0; c < 3; ++c) lum[c] = F32(kSunIntensity * 80.0) * t_sun[c] + lum[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * i + c] = lum[c];
}

__global__ void __launch_bounds__(kThreads)
aerial_perspective_kernel(const float* __restrict__ depth, const float* __restrict__ view,
                          const float* __restrict__ sun, int n, float h0, float inv_steps,
                          int steps, float* __restrict__ trans,
                          float* __restrict__ inscatter) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float vx = view[3 * i], vy = view[3 * i + 1], vz = view[3 * i + 2];
  normalize(vx, vy, vz);
  float lx = sun[0], ly = sun[1], lz = sun[2];
  normalize(lx, ly, lz);
  const float mu_v = vy;
  const float mu_sun = ly;
  const float cos_sun = dot3(vx, vy, vz, lx, ly, lz);
  const float ph_r = phase_rayleigh(cos_sun);
  const float ph_m = phase_mie(cos_sun);
  const float dt = depth[i] * inv_steps;
  float lum[3] = {0.0f, 0.0f, 0.0f}, tau[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll 1
  for (int k = 0; k < steps; ++k) {
    const float t = static_cast<float>(k + 0.5) * dt;
    march_sample(clamp_min(t * mu_v + h0, 0.0f), dt, mu_sun, ph_r, ph_m, lum, tau);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    trans[3 * i + c] = expf(-tau[c]);
    inscatter[3 * i + c] = lum[c];
  }
}

}  // namespace

// C entry point of the sky over n rays: view (n x 3) and sun (3,) float32
// on the card; the call's constants as the struct Sky names them; out
// (n x 3) receives the radiance. Returns a cudaError_t code.
extern "C" int sky_radiance_launch(const float* view, const float* sun, int n, float h0,
                                   float r0, float r0_sq, float two_r0, float top_c,
                                   float ground_c, float inv_steps, int steps, float* out,
                                   void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  const Sky s{h0, r0, r0_sq, two_r0, top_c, ground_c, inv_steps, steps};
  sky_radiance_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(view, sun, n, s, out);
  return (int)cudaGetLastError();
}

// C entry point of the aerial perspective over n pixels: depth (n) in km,
// view (n x 3) and sun (3,) float32 on the card; h0 the camera height in km,
// inv_steps 1 / steps; trans and inscatter (n x 3 each) are written.
// Returns a cudaError_t code.
extern "C" int aerial_perspective_launch(const float* depth, const float* view,
                                         const float* sun, int n, float h0, float inv_steps,
                                         int steps, float* trans, float* inscatter,
                                         void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  aerial_perspective_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      depth, view, sun, n, h0, inv_steps, steps, trans, inscatter);
  return (int)cudaGetLastError();
}
