// K1-fwd: fused positional encoding -> SDF MLP -> [sdf/scale | feature] and
// the input gradient dsdf/dx from an in-kernel reverse sweep.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_geometry.py
// (_make_geom.run_fwd, body _build_fwd_kernel).
//
// Bound: operations.  Per row the forward products cost 2S FLOPs and the
// reverse sweep another ~2S (S = 524,544 multiply-adds at full width), while
// a row moves only 12 bytes in and 1,040 bytes out.  The design keeps the
// 64-row activation tile in shared memory for the whole chain, so no
// activation crosses device memory; the hidden pre-activations the reverse
// sweep needs go to a per-block scratch (the whole stash of one tile is
// 9 x 64 x 260 floats, too large for shared memory next to the tile) that a
// persistent block reuses tile after tile, so it stays hot in L2.  The
// sweep's first step needs no product: the cotangent e0/scale of the last
// layer's output selects row 0 of its weight.
//
// K1-fwd-stash (entry point geometry_fwd_stash) replaces
// _make_geom.run_fwd_stash (body _build_fwd_kernel_stashing): the same
// kernel, which also writes the pre-activations of layers 0..L-2, rounded
// to bf16 (round to nearest even), to a [n][sum of their widths] side
// output for K1-bwd-stash: 4,018 bytes more per row at full width, still
// far below the operations bound.  The stash never feeds (out, grad).
#include <cuda_bf16.h>

#include "sdf_mlp.cuh"

__global__ void __launch_bounds__(SDF_THREADS, 1)
geometry_fwd_kernel(SdfDims d, const float* __restrict__ x, float* out,
                    float* grad, float* stash_all, int n_tiles,
                    __nv_bfloat16* bstash, int stash_cols) {
  extern __shared__ float smem[];
  const int ld = d.ld;
  float* E = smem;                              // [64][64] enc, then its cot
  float* X = E + SDF_TILE * SDF_ENC_LD;         // [64][ld]
  float* Y = X + SDF_TILE * ld;                 // [64][ld]
  const size_t stash_layer = (size_t)SDF_TILE * ld;
  float* stash = stash_all + (size_t)blockIdx.x * d.L * stash_layer;
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int tid = threadIdx.x;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * SDF_TILE;
    if (tid < SDF_TILE) {
      const int row = row0 + tid;
      float u[3];
      for (int c = 0; c < 3; ++c)
        u[c] = row < d.n ? x[row * 3 + c] * d.scale : 0.f;
      encode_row(u, nullptr, d.multires, E + tid * SDF_ENC_LD, nullptr);
    }
    __syncthreads();
    forward_hidden(d, E, X, Y, stash, stash_layer);
    if (bstash) {
      // the hidden pre-activations, from the scratch to the bf16 stash
      int so = 0;
      for (int l = 0; l + 1 < d.L; ++l) {
        const int N = d.outs[l];
        const float* st = stash + l * stash_layer;
        for (int idx = tid; idx < SDF_TILE * N; idx += SDF_THREADS) {
          const int r = idx / N, c = idx - r * N;
          const int row = row0 + r;
          if (row < d.n)
            bstash[(size_t)row * stash_cols + so + c] =
                __float2bfloat16_rn(st[r * ld + c]);
        }
        so += N;
      }
    }

    // last layer -> [sdf / scale | feature]
    const int lL = d.L - 1;
    {
      const float* xin = lL == 0 ? E : X;
      const int ldx = lL == 0 ? SDF_ENC_LD : ld;
      const int K = d.ins[lL], N = d.outs[lL];
      SDF_TN_DISPATCH(N, tile_mm<TN>(xin, ldx, K, d.wT[lL], N, N, Y, ld));
      __syncthreads();
      for (int idx = tid; idx < SDF_TILE * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const int row = row0 + r;
        if (row < d.n)
          out[(size_t)row * N + c] =
              (Y[r * ld + c] + __ldg(d.b[lL] + c)) * (c == 0 ? inv_scale : 1.f);
      }
      __syncthreads();
      // cotangent e0/scale through the last layer: row 0 of its weight
      for (int idx = tid; idx < SDF_TILE * K; idx += SDF_THREADS) {
        const int r = idx / K, k = idx - r * K;
        Y[r * ld + k] = __ldg(d.wt[lL] + k) * inv_scale;
      }
      for (int idx = tid; idx < SDF_TILE * SDF_ENC_LD; idx += SDF_THREADS)
        E[idx] = 0.f;
      __syncthreads();
    }

    // reverse sweep: Y holds the cotangent of layer l's input
    for (int l = lL; l >= 0; --l) {
      const int K = d.ins[l];
      if (l < lL) {
        SDF_TN_DISPATCH(K, tile_mm<TN>(X, ld, d.outs[l], d.wt[l], K, K, Y, ld));
        __syncthreads();
      }
      if ((d.skip_mask >> l) & 1) {
        const int hw = K - d.d_embed;
        for (int idx = tid; idx < SDF_TILE * K; idx += SDF_THREADS) {
          const int r = idx / K, k = idx - r * K;
          const float v = Y[r * ld + k] * inv_sqrt2;
          if (k >= hw) E[r * SDF_ENC_LD + k - hw] += v;
          else Y[r * ld + k] = v;
        }
        __syncthreads();
      }
      if (l == 0) {
        for (int idx = tid; idx < SDF_TILE * d.d_embed; idx += SDF_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          E[r * SDF_ENC_LD + c] += Y[r * ld + c];
        }
      } else {
        const int W = d.outs[l - 1];
        const float* a = stash + (l - 1) * stash_layer;
        for (int idx = tid; idx < SDF_TILE * W; idx += SDF_THREADS) {
          const int r = idx / W, k = idx - r * W;
          X[r * ld + k] = Y[r * ld + k] * sig100(a[r * ld + k]);
        }
      }
      __syncthreads();
    }

    if (tid < SDF_TILE) {
      const int row = row0 + tid;
      if (row < d.n) {
        float u[3], ct[3];
        for (int c = 0; c < 3; ++c) u[c] = x[row * 3 + c] * d.scale;
        encode_backward_row(u, nullptr, d.multires, E + tid * SDF_ENC_LD,
                            nullptr, ct);
        for (int c = 0; c < 3; ++c) grad[row * 3 + c] = ct[c] * d.scale;
      }
    }
    __syncthreads();
  }
}

// The weight pointers start at pw: [wT[L], wt[L], b[L]].
static int launch_fwd(const int* ia, const unsigned long long* p, float scale,
                      unsigned long long stream, __nv_bfloat16* bstash,
                      int pw) {
  SdfDims d;
  int rc = sdf_dims_from_args(ia, scale, &d);
  if (rc) return rc;
  const int L = d.L;
  int stash_cols = 0;
  for (int l = 0; l < L; ++l) {
    d.wT[l] = (const float*)p[pw + l];
    d.wt[l] = (const float*)p[pw + L + l];
    d.b[l] = (const float*)p[pw + 2 * L + l];
    if (l + 1 < L) stash_cols += d.outs[l];
  }
  const int grid = ia[6];
  const int n_tiles = (d.n + SDF_TILE - 1) / SDF_TILE;
  const size_t smem =
      (size_t)(SDF_TILE * SDF_ENC_LD + 2 * SDF_TILE * d.ld) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      geometry_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  geometry_fwd_kernel<<<grid, SDF_THREADS, smem, (cudaStream_t)stream>>>(
      d, (const float*)p[0], (float*)p[1], (float*)p[2], (float*)p[3],
      n_tiles, bstash, stash_cols);
  return (int)cudaGetLastError();
}

// Integer arguments: [L, multires, d_embed, ld, skip_mask, n, grid,
// ins[L], outs[L]].  Pointers: [x, out, grad, stash, wT[L], wt[L], b[L]].
// Returns a cudaError_t value; 0 when the launch was accepted.
extern "C" int geometry_fwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  return launch_fwd(ia, p, scale, stream, nullptr, 4);
}

// Integer arguments as geometry_fwd.  Pointers: [x, out, grad, scratch,
// bf16 stash [n][sum of outs[0..L-2]], wT[L], wt[L], b[L]].
extern "C" int geometry_fwd_stash(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_fwd(ia, p, scale, stream, (__nv_bfloat16*)p[4], 5);
}
