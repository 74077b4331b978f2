// Shared device code of the MLP kernels: the positional encoding and its
// backward, softplus(beta=100).  Every kernel runs its products on the
// tensor cores.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float sp100(float a) {
  // softplus(beta=100) = logaddexp(0, 100 a) / 100, stable for every a
  const float z = 100.f * a;
  return (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) * 0.01f;
}

__device__ __forceinline__ float sig100(float a) {
  return 1.f / (1.f + expf(-100.f * a));
}

// Positional encoding of one row: [u, sin(f0 u), cos(f0 u), sin(f1 u), ...]
// with f_i = 2^i; with v != nullptr also the tangent of the encoding along v.
__device__ __forceinline__ void encode_row(const float u[3], const float* v,
                                           int multires, float* enc,
                                           float* denc) {
  for (int c = 0; c < 3; ++c) {
    enc[c] = u[c];
    if (denc) denc[c] = v[c];
  }
  float f = 1.f;
  for (int i = 0; i < multires; ++i) {
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(f * u[c], &s, &co);
      enc[3 + 6 * i + c] = s;
      enc[6 + 6 * i + c] = co;
      if (denc) {
        denc[3 + 6 * i + c] = co * (f * v[c]);
        denc[6 + 6 * i + c] = -s * (f * v[c]);
      }
    }
    f *= 2.f;
  }
}

// Cotangent of u from the cotangents of the encoding (r) and, when rd is
// given, of its tangent along v (the second-order term of the eikonal
// backward).  Mirrors pallas_geometry.pe_backward.
__device__ __forceinline__ void encode_backward_row(const float u[3],
                                                    const float* v,
                                                    int multires,
                                                    const float* r,
                                                    const float* rd,
                                                    float ct[3]) {
  for (int c = 0; c < 3; ++c) ct[c] = r[c];
  float f = 1.f;
  for (int i = 0; i < multires; ++i) {
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(f * u[c], &s, &co);
      ct[c] += f * (r[3 + 6 * i + c] * co - r[6 + 6 * i + c] * s);
      if (rd)
        ct[c] -= f * f * v[c] *
                 (rd[3 + 6 * i + c] * s + rd[6 + 6 * i + c] * co);
    }
    f *= 2.f;
  }
}
