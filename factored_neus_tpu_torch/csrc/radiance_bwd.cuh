// K3-bwd: the backward of K3-fwd (the kernel's body; entry point in
// radiance_bwd.cu).  Given ct_rgb it recomputes
// the forward, then reverse-sweeps: the sigmoid's y (1 - y), the ReLU
// masks a > 0, the weight and bias gradients summed over all rows, and the
// cotangents of pts, normals, feature and, through the positional
// encoding's Jacobian, of the view directions.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_radiance.py
// (_make_radiance.run_bwd, body _build_bwd_kernel).
//
// Bound: operations, 6 x 271,360 FLOPs per row at full width (forward,
// weight gradient and input cotangent of every layer) against ~2 KB moved
// per row.  Every product runs on the tensor cores in 3xTF32 (tc_mma.cuh:
// the forward X W^T and the input cotangents R W with the weights staged
// by cp.async from the step's one K3 pack, pre-split into TF32 big and
// small halves; the weight gradients X^T R from the two tiles in shared
// memory), so the least time is three TF32 products' worth of those FLOPs
// over 495 TFLOP/s.  A persistent block (12 warps, one per SM) walks
// 64-row tiles.  The hidden activations h = relu(a) (their sign is the
// ReLU mask) go to a per-block scratch, 4 x 64 x 300 floats a tile (40.6 MB
// at 132 blocks), written once and read twice.  Each block accumulates its
// weight gradients into its own slice of a partial buffer, tile after
// tile (P = 272,387 floats, 1.09 MB a slice, 143.8 MB over 132 blocks:
// with the scratch far above the 50 MB L2, so each tile's read-modify-
// write of its slice, 2.2 GB a call, is device-memory traffic, moved in
// coalesced rows through the idle weight ring), and a second kernel sums
// the slices in a fixed order: deterministic, no atomics.
//
// Shared memory at full width: two tiles of 64 x 300 floats (ld = 296 + 4:
// the first layer's 289-wide input rounded to 8, then 4 mod 8), 153,600 B,
// and the ring, two stages of 16 rows of the widest staged block (W0 at
// stride 296), big and small, 75,776 B: 229,376 B of the 232,448 a block
// may use.  There is no room for a third tile to keep the first layer's
// input x0: it is built in A for the forward, and again from the global
// inputs when the reverse sweep reaches layer 0, where A is free; its
// cotangent R W0 then overwrites it once dW0 is summed.  R W0 is 296
// columns wide, past the 288 a product covers (TC_MAXW), so input
// cotangents run as products of at most 256 columns.
//
// The body is a template on BF, bf16 operands, which tc_mma.cuh's
// products take; only the 3xTF32 instantiation (BF = false) is built.
// K3-bwd-bf16 runs on wgmma in radiance_bwd_bf16_wg.cu.
#pragma once

#include "radiance_mlp.cuh"

template <bool BF>
__global__ void __launch_bounds__(TC_THREADS, 1)
radiance_bwd_kernel(TcDims d, int squeeze, const float* __restrict__ pts,
                    const float* __restrict__ nrm,
                    const float* __restrict__ dirs,
                    const float* __restrict__ feat,
                    const float* __restrict__ ct_rgb, float* ct_pts,
                    float* ct_nrm, float* ct_dirs, float* ct_feat,
                    float* stash_all, float* part_all, long long P,
                    int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d.ld;
  float* A = smem;                      // [64][ld] layer input / r_in
  float* R = A + TC_TILE * ld;          // [64][ld] product / output cot
  float* ring = R + TC_TILE * ld;       // two weight-slice stages
  const size_t stash_layer = (size_t)TC_TILE * ld;
  float* stash = stash_all + (size_t)blockIdx.x * (d.L - 1) * stash_layer;
  float* part = part_all + (size_t)blockIdx.x * P;
  const int tid = threadIdx.x;
  const int lL = d.L - 1;
  const int d_view = d.d_embed;
  const int off_n = 3 + d_view, off_f = 6 + d_view;
  const int K0 = d.ins[0], d_feat = K0 - off_f;

  // the products read padding columns, which must be finite
  for (int i = tid; i < 2 * TC_TILE * ld; i += TC_THREADS) smem[i] = 0.f;
  __syncthreads();

  // x0 into A; its padding columns [K0, kp0) zero, as the first layer's
  // products read them
  auto load_x0 = [&](int row0) {
    const int pad = d.kp[0] - K0;
    for (int idx = tid; idx < TC_TILE * pad; idx += TC_THREADS)
      A[(idx / pad) * ld + K0 + idx % pad] = 0.f;
    build_x0(d, ld, row0, pts, nrm, dirs, feat, A);
  };

  bool first = true;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, first = false) {
    const int row0 = t * TC_TILE;
    load_x0(row0);

    // forward: h_l = relu(a_l) to A and the scratch
    for (int l = 0; l < lL; ++l) {
      const int N = d.outs[l];
      tc_product<2, BF>(d, A, ld, d.kp[l], d.fwd_off[l], d.fwd_st[l], d.np[l],
                        R, ld, ring);
      __syncthreads();
      float* st = stash + l * stash_layer;
      const float* bias = d.b[l];
      for (int idx = tid; idx < TC_TILE * N; idx += TC_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const float h = fmaxf(R[r * ld + c] + __ldg(bias + c), 0.f);
        st[r * ld + c] = h;
        A[r * ld + c] = h;
      }
      __syncthreads();
    }

    // last layer and the seed: r = ct_rgb y (1 - y), or ct_rgb; zero in
    // the padding columns [N, np), which the reverse products read
    {
      const int N = d.outs[lL], np = d.np[lL];
      tc_product<2, BF>(d, A, ld, d.kp[lL], d.fwd_off[lL], d.fwd_st[lL], np, R,
                        ld, ring);
      __syncthreads();
      for (int idx = tid; idx < TC_TILE * np; idx += TC_THREADS) {
        const int r = idx / np, c = idx - r * np;
        const int row = row0 + r;
        float v = 0.f;
        if (c < N && row < d.n) {
          v = ct_rgb[(size_t)row * N + c];
          if (squeeze) {
            const float y =
                1.f / (1.f + expf(-(R[r * ld + c] + __ldg(d.b[lL] + c))));
            v = v * y * (1.f - y);
          }
        }
        R[r * ld + c] = v;
      }
      __syncthreads();
    }

    // reverse sweep: at layer l, R holds the cotangent of a_l; A the layer
    // input, h_{l-1} (left by the forward for the last layer, else rebuilt
    // from the scratch) or x0 (rebuilt from the inputs)
    long long off = P;
    for (int l = lL; l >= 0; --l) {
      const int K = d.ins[l], N = d.outs[l];
      off -= (long long)K * N + N;
      if (l == 0) {
        load_x0(row0);
      } else if (l < lL) {
        const float* st = stash + (l - 1) * stash_layer;
        tc_rows_for<8>(
            TC_TILE, K, [&](int r, int k) { return st[r * ld + k]; },
            [&](int r, int k) { return 0.f; },
            [&](int r, int k, float h, float) { A[r * ld + k] = h; });
        __syncthreads();
      }

      // weight gradient [in][out] and bias gradient over the tile's rows
      tc_weight_grad<BF>(A, ld, K, R, ld, N, part + off, first, ring);
      float* pb = part + off + (long long)K * N;
      for (int c = tid; c < N; c += TC_THREADS) {
        float s = 0.f;
        for (int r = 0; r < TC_TILE; ++r) s += R[r * ld + c];
        pb[c] = first ? s : pb[c] + s;
      }
      __syncthreads();

      // input cotangent A = R W_l, in products of at most 256 columns
      for (int c0 = 0; c0 < d.kp[l]; c0 += 256)
        tc_product<2, BF>(d, R, ld, d.np[l], d.rev_off[l] + c0, d.rev_st[l],
                          min(256, d.kp[l] - c0), A + c0, ld, ring);
      __syncthreads();
      if (l > 0) {
        // through the ReLU: r_{l-1} = r_in where h_{l-1} > 0
        const float* st = stash + (l - 1) * stash_layer;
        tc_rows_for<8>(
            TC_TILE, K, [&](int r, int k) { return st[r * ld + k]; },
            [&](int r, int k) { return A[r * ld + k]; },
            [&](int r, int k, float h, float v) {
              R[r * ld + k] = h > 0.f ? v : 0.f;
            });
        __syncthreads();
      }
    }

    // split the x0 cotangent in A: pts, dirs through the PE Jacobian,
    // normals, feature
    if (tid < TC_TILE) {
      const int row = row0 + tid;
      if (row < d.n) {
        const float* xr = A + tid * ld;
        float u[3], cd[3];
        for (int c = 0; c < 3; ++c) u[c] = dirs[row * 3 + c];
        encode_backward_row(u, nullptr, d.multires, xr + 3, nullptr, cd);
        for (int c = 0; c < 3; ++c) {
          ct_pts[row * 3 + c] = xr[c];
          ct_dirs[row * 3 + c] = cd[c];
          ct_nrm[row * 3 + c] = xr[off_n + c];
        }
      }
    }
    for (int idx = tid; idx < TC_TILE * d_feat; idx += TC_THREADS) {
      const int r = idx / d_feat, c = idx - r * d_feat;
      const int row = row0 + r;
      if (row < d.n)
        ct_feat[(size_t)row * d_feat + c] = A[r * ld + off_f + c];
    }
    __syncthreads();
  }
}

// Integer arguments: rad_tc_dims_from_args'.  Pointers: [pts, normals,
// dirs, feat, ct_rgb, ct_pts, ct_normals, ct_dirs, ct_feat, scratch,
// partials, grads, pack, b[L]].  grads receives, per layer, dW as
// [in][out] followed by db [out].  Returns a cudaError_t value.
template <bool BF>
static int launch_radiance_bwd(const int* ia, const unsigned long long* p,
                               unsigned long long stream) {
  TcDims d;
  int squeeze;
  int rc = rad_tc_dims_from_args(ia, (const float*)p[12], &d, &squeeze, BF);
  if (rc) return rc;
  long long P = 0;
  for (int l = 0; l < d.L; ++l) {
    d.b[l] = (const float*)p[13 + l];
    P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
  }
  const int grid = ia[6];
  const int n_tiles = (d.n + TC_TILE - 1) / TC_TILE;
  const size_t smem = tc_smem_bytes(d, (size_t)2 * TC_TILE * d.ld);
  if (!smem || grid < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      radiance_bwd_kernel<BF>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  radiance_bwd_kernel<BF><<<grid, TC_THREADS, smem, s>>>(
      d, squeeze, (const float*)p[0], (const float*)p[1],
      (const float*)p[2], (const float*)p[3], (const float*)p[4],
      (float*)p[5], (float*)p[6], (float*)p[7], (float*)p[8], (float*)p[9],
      (float*)p[10], P, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rb = 256;
  reduce_partials_kernel<<<(int)((P + rb - 1) / rb), rb, 0, s>>>(
      (const float*)p[10], grid, P, (float*)p[11]);
  return (int)cudaGetLastError();
}
