// PyTorch's float32 elementwise ops as its CUDA kernels round them, for the
// kernels that must give a plain PyTorch version's bits: the cloud march
// and shadow (clouds.cu) and the atmosphere (atmosphere.cu).
//
// The rules, each checked against PyTorch's kernels on the card: a source
// built with -fmad=false, so no multiply and add contract; a Python number
// reaches a float32 op as the double rounded to float (F32); a tensor
// divided by a Python number is multiplied by the float reciprocal that
// the host computes (the wrappers pass it), a Python number divided by a
// tensor is the tensor's reciprocal times the number, a division of two
// tensors is IEEE's; clamps test NaN first and then take fmaxf/fminf;
// torch.sum over three components adds (x0 + x2) + x1, as PyTorch's
// reduction splits three inputs over two lanes; expf, powf, rsqrtf and
// sqrtf are the CUDA math library's, as in PyTorch.

#pragma once

#include <cuda_runtime.h>

// Python floats as PyTorch passes them to a float32 op: the double rounded
// to float
#define F32(x) (static_cast<float>(x))

namespace {

// torch.clamp(x, lo, hi), torch.clamp(x, min=lo), torch.clamp(x, max=hi)
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_max(float x, float hi) {
  return isnan(x) ? x : fminf(x, hi);
}

// m3.dot over three components: torch.sum's (x0 + x2) + x1
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return (ax * bx + az * bz) + ay * by;
}

// m3.normalize, in place
__device__ __forceinline__ void normalize(float& x, float& y, float& z) {
  const float s = rsqrtf(clamp_min(dot3(x, y, z, x, y, z), F32(1e-12)));
  x = x * s;
  y = y * s;
  z = z * s;
}

}  // namespace
