// The mma.sync body of K1-fwd: fused positional encoding -> SDF MLP ->
// [sdf/scale | feature] and the input gradient dsdf/dx from an in-kernel
// reverse sweep, which K1-fwd-stash and the bf16 mode's K1-fwd-stash-bf16
// run, only under the stash switch (K1-fwd itself runs on wgmma:
// geometry_fwd_wg.cu in f32, geometry_fwd_bf16_wg.cu in bf16).
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_geometry.py
// (_make_geom.run_fwd, body _build_fwd_kernel).
//
// Bound: operations.  Per row the forward products cost 2S FLOPs and the
// reverse sweep another ~2S (S = 524,544 multiply-adds at full width), while
// a row moves only 12 bytes in and 1,040 bytes out.  Every product runs on
// the tensor cores in 3xTF32 (tc_mma.cuh), so the least time is three TF32
// products' worth: 3 x 4S FLOPs a row over 495 TFLOP/s.  The 64-row
// activation tile stays in shared memory for the whole chain and the
// weights (packed once per call, pre-split into TF32 big and small halves)
// are staged slice by slice into a shared-memory ring by cp.async, the next
// slice in flight while the current one is multiplied.  The hidden
// pre-activations the reverse sweep needs go to a per-block scratch in
// device memory, 9 x 64 x ld floats a tile, written once and read once;
// at 132 blocks that is ~82 MB, more than the 50 MB L2 holds, so it costs
// device-memory traffic: 8 hidden layers x 256 floats, ~8 KB a row each
// way, 1.1 GB a call at full width (0.32 ms at 3.35 TB/s), below the
// operations bound.  The sweep's first step needs no product: the
// cotangent e0/scale of the last layer's output selects row 0 of its
// weight, rebuilt exactly as big + small.
//
// K1-fwd-stash (entry point geometry_fwd_stash) replaces
// _make_geom.run_fwd_stash (body _build_fwd_kernel_stashing): the same
// kernel, which also writes the pre-activations of layers 0..L-2, rounded
// to bf16 (round to nearest even), to a [n][sum of their widths] side
// output for K1-bwd-stash: 4,018 bytes more per row at full width, still
// far below the operations bound.  The stash never feeds (out, grad).
//
// K1-fwd-stash-bf16 (entry point geometry_fwd_stash_bf16) is the same
// kernel in the bf16 operand mode of pallas_geometry (_mm_fns(bf16=True),
// the JAX step's default): every product on bf16 operands (rounded to
// nearest even) with an f32 sum, on bf16 mma (tc_mma.cuh, BF) from
// pack_weights_bf16's pack; the encoding,
// softplus, skip, biases and the reverse sweep's elementwise steps stay
// f32, and the sweep's seed e0 / scale meets the last layer's bf16 row 0
// rounded to bf16 itself, as JAX's dot rounds it.  Bound: operations, one
// bf16 product's worth of the same FLOPs over 989 TFLOP/s.
#include <cuda_bf16.h>

#include "sdf_mlp.cuh"
#include "tc_mma.cuh"

template <bool BF>
__global__ void __launch_bounds__(TC_THREADS, 1)
geometry_fwd_kernel(TcDims d, const float* __restrict__ x, float* out,
                    float* grad, float* stash_all, int n_tiles,
                    __nv_bfloat16* bstash, int stash_cols) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d.ld, eld = d.eld;
  float* E = smem;                              // [64][eld] enc, then its cot
  float* X = E + TC_TILE * eld;                 // [64][ld]
  float* Y = X + TC_TILE * ld;                  // [64][ld]
  float* ring = Y + TC_TILE * ld;               // two weight-slice stages
  const size_t stash_layer = (size_t)TC_TILE * ld;
  float* stash = stash_all + (size_t)blockIdx.x * d.L * stash_layer;
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int tid = threadIdx.x;
  const int lL = d.L - 1;

  // the products read padding columns, which must be finite
  for (int i = tid; i < TC_TILE * (eld + 2 * ld); i += TC_THREADS)
    smem[i] = 0.f;
  __syncthreads();

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * TC_TILE;
    if (tid < TC_TILE) {
      const int row = row0 + tid;
      float u[3];
      for (int c = 0; c < 3; ++c)
        u[c] = row < d.n ? x[row * 3 + c] * d.scale : 0.f;
      encode_row(u, nullptr, d.multires, E + tid * eld, nullptr);
    }
    __syncthreads();

    // hidden layers: a_l = x_l W_l^T + b_l to the scratch, x_{l+1} =
    // softplus(a_l) (/ sqrt 2 and the encoding appended before a skip)
    int so = 0;
    for (int l = 0; l < lL; ++l) {
      const int N = d.outs[l];
      tc_product<2, BF>(d, l == 0 ? E : X, l == 0 ? eld : ld, d.kp[l],
                    d.fwd_off[l], d.fwd_st[l], d.np[l], Y, ld, ring);
      __syncthreads();
      const bool skip_next = (d.skip_mask >> (l + 1)) & 1;
      const float post = skip_next ? inv_sqrt2 : 1.f;
      const float* bias = d.b[l];
      float* st = stash + l * stash_layer;
      for (int idx = tid; idx < TC_TILE * N; idx += TC_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const float a = Y[r * ld + c] + __ldg(bias + c);
        st[r * ld + c] = a;
        X[r * ld + c] = sp100(a) * post;
        const int row = row0 + r;
        if (bstash && row < d.n)
          bstash[(size_t)row * stash_cols + so + c] = __float2bfloat16_rn(a);
      }
      so += N;
      if (skip_next)
        for (int idx = tid; idx < TC_TILE * d.d_embed; idx += TC_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          X[r * ld + N + c] = E[r * eld + c] * inv_sqrt2;
        }
      __syncthreads();
    }

    // last layer -> [sdf / scale | feature]
    {
      const int K = d.ins[lL], N = d.outs[lL];
      tc_product<2, BF>(d, lL == 0 ? E : X, lL == 0 ? eld : ld, d.kp[lL],
                    d.fwd_off[lL], d.fwd_st[lL], d.np[lL], Y, ld, ring);
      __syncthreads();
      for (int idx = tid; idx < TC_TILE * N; idx += TC_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const int row = row0 + r;
        if (row < d.n)
          out[(size_t)row * N + c] =
              (Y[r * ld + c] + __ldg(d.b[lL] + c)) * (c == 0 ? inv_scale : 1.f);
      }
      __syncthreads();
      // cotangent e0/scale through the last layer: row 0 of its weight
      // (bf16: the low halves of word row 0, times e0/scale in bf16)
      const float* w0 = d.pack + d.rev_off[lL];
      const float seed =
          BF ? __bfloat162float(__float2bfloat16_rn(inv_scale)) : inv_scale;
      for (int idx = tid; idx < TC_TILE * K; idx += TC_THREADS) {
        const int r = idx / K, k = idx - r * K;
        const float w =
            BF ? __uint_as_float(__float_as_uint(__ldg(w0 + k)) << 16)
               : __ldg(w0 + k) + __ldg(w0 + d.H + k);
        Y[r * ld + k] = w * seed;
      }
      for (int idx = tid; idx < TC_TILE * eld; idx += TC_THREADS) E[idx] = 0.f;
      __syncthreads();
    }

    // reverse sweep: Y holds the cotangent of layer l's input
    for (int l = lL; l >= 0; --l) {
      const int K = d.ins[l];
      if (l < lL) {
        tc_product<2, BF>(d, X, ld, d.np[l], d.rev_off[l], d.rev_st[l],
                          d.kp[l], Y, ld, ring);
        __syncthreads();
      }
      if ((d.skip_mask >> l) & 1) {
        const int hw = K - d.d_embed;
        for (int idx = tid; idx < TC_TILE * K; idx += TC_THREADS) {
          const int r = idx / K, k = idx - r * K;
          const float v = Y[r * ld + k] * inv_sqrt2;
          if (k >= hw) E[r * eld + k - hw] += v;
          else Y[r * ld + k] = v;
        }
        __syncthreads();
      }
      if (l == 0) {
        for (int idx = tid; idx < TC_TILE * d.d_embed; idx += TC_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          E[r * eld + c] += Y[r * ld + c];
        }
      } else {
        const int W = d.outs[l - 1];
        const float* a = stash + (l - 1) * stash_layer;
        tc_rows_for<8>(
            TC_TILE, W, [&](int r, int k) { return a[r * ld + k]; },
            [&](int r, int k) { return Y[r * ld + k]; },
            [&](int r, int k, float av, float y) {
              X[r * ld + k] = y * sig100(av);
            });
      }
      __syncthreads();
    }

    if (tid < TC_TILE) {
      const int row = row0 + tid;
      if (row < d.n) {
        float u[3], ct[3];
        for (int c = 0; c < 3; ++c) u[c] = x[row * 3 + c] * d.scale;
        encode_backward_row(u, nullptr, d.multires, E + tid * eld, nullptr,
                            ct);
        for (int c = 0; c < 3; ++c) grad[row * 3 + c] = ct[c] * d.scale;
      }
    }
    __syncthreads();
  }
}

// Pointers: [x, out, grad, scratch, (bf16 stash,) pack, b[L]]; the biases
// start at pw + 1.
template <bool BF>
static int launch_fwd(const int* ia, const unsigned long long* p, float scale,
                      unsigned long long stream, __nv_bfloat16* bstash,
                      int pw) {
  TcDims d;
  int rc = tc_dims_from_args(ia, scale, (const float*)p[pw], &d, BF);
  if (rc) return rc;
  int stash_cols = 0;
  for (int l = 0; l < d.L; ++l) {
    d.b[l] = (const float*)p[pw + 1 + l];
    if (l + 1 < d.L) stash_cols += d.outs[l];
  }
  const int grid = ia[6];
  const int n_tiles = (d.n + TC_TILE - 1) / TC_TILE;
  const size_t smem = tc_smem_bytes(d, (size_t)TC_TILE * (d.eld + 2 * d.ld));
  if (!smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      geometry_fwd_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  geometry_fwd_kernel<BF><<<grid, TC_THREADS, smem, (cudaStream_t)stream>>>(
      d, (const float*)p[0], (float*)p[1], (float*)p[2], (float*)p[3],
      n_tiles, bstash, stash_cols);
  return (int)cudaGetLastError();
}

// Integer arguments: tc_dims_from_args'.  Pointers: [x, out, grad, scratch,
// bf16 stash [n][sum of outs[0..L-2]], pack, b[L]].  Returns a cudaError_t
// value; 0 when the launch was accepted.
extern "C" int geometry_fwd_stash(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_fwd<false>(ia, p, scale, stream, (__nv_bfloat16*)p[4], 5);
}

// geometry_fwd_stash's arguments, the pack pack_weights_bf16's:
// K1-fwd-stash-bf16.
extern "C" int geometry_fwd_stash_bf16(const int* ia,
                                       const unsigned long long* p,
                                       float scale,
                                       unsigned long long stream) {
  return launch_fwd<true>(ia, p, scale, stream, (__nv_bfloat16*)p[4], 5);
}
