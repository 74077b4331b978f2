// Shared device code of the MLP kernels: the positional encoding and its
// backward, softplus(beta=100), the fixed-order sum of per-block weight
// gradients (K1-bwd, K3-bwd), and K3-fwd's layer description (SdfDims) and
// register-tiled f32 product tile_mm.  tile_mm serves K3-fwd alone: K1,
// K2 and K3-bwd run their products on the tensor cores (tc_mma.cuh).
//
// tile_mm (Hopper, f32 CUDA cores): every product streams its weight rows
// from L2/L1 with __ldg while the 64-row activation tile stays in shared
// memory.  A block of 256 threads (8 warps) computes a [64 x N] product;
// warp w owns rows 8w..8w+7 and lane t owns columns t, t+32, ... (TN =
// ceil(N/32) of them), so every shared-memory activation read is a
// warp-wide broadcast and every weight read is a coalesced 128-byte row
// segment.  Ragged widths are masked per column; nothing is padded in
// memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SDF_MAXL 16          // most layers a network may have
#define SDF_TILE 64          // rows of one product tile (8 warps x 8 rows)
#define SDF_THREADS 256
#define SDF_MAXW 288         // widest layer the column tiling covers (9 x 32)

struct SdfDims {
  int L;                     // number of linear layers
  int multires;              // octaves of the positional encoding
  int d_embed;               // 3 * (1 + 2 * multires)
  int ld;                    // shared-memory row stride (>= every width)
  int skip_mask;             // bit l set: layer l reads [h | enc] / sqrt(2)
  int n;                     // rows of the call
  float scale;               // SDFNetwork.scale
  int ins[SDF_MAXL];
  int outs[SDF_MAXL];
  const float* wT[SDF_MAXL];  // [in][out] row-major effective weights
  const float* b[SDF_MAXL];   // [out]
};

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

// Y[64][N] = X[64][K] @ B[K][N]; X, Y in shared memory (strides ldx, ldy),
// B in global memory, row-major with stride ldb.  Warp w owns rows 8w ..
// 8w + 7.  Columns >= N are neither read nor written.
template <int TN>
__device__ __forceinline__ void tile_mm(const float* X, int ldx, int K,
                                        const float* __restrict__ B, int ldb,
                                        int N, float* Y, int ldy) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const float* xr = X + (ty * 8) * ldx;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 32 * j;
      bv[j] = n < N ? __ldg(B + (size_t)k * ldb + n) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = xr[i * ldx + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 32 * j;
      if (n < N) Y[(ty * 8 + i) * ldy + n] = acc[i][j];
    }
}

// out[j] = sum over blocks b (in order) of part[b][j]: the fixed-order
// second pass of the weight-gradient sums, so they are deterministic.
__global__ void reduce_partials_kernel(const float* __restrict__ part, int G,
                                       long long P, float* out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float s = 0.f;
  for (int b = 0; b < G; ++b) s += part[(size_t)b * P + j];
  out[j] = s;
}

// Runtime dispatch on the number of 32-column groups a width needs.
#define SDF_TN_DISPATCH(N, CALL)                  \
  switch (((N) + 31) / 32) {                      \
    case 1: { constexpr int TN = 1; CALL; } break; \
    case 2: { constexpr int TN = 2; CALL; } break; \
    case 3: { constexpr int TN = 3; CALL; } break; \
    case 4: { constexpr int TN = 4; CALL; } break; \
    case 5: { constexpr int TN = 5; CALL; } break; \
    case 6: { constexpr int TN = 6; CALL; } break; \
    case 7: { constexpr int TN = 7; CALL; } break; \
    case 8: { constexpr int TN = 8; CALL; } break; \
    default: { constexpr int TN = 9; CALL; } break; \
  }
