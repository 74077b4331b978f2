// Shared device code of the radiance-MLP kernels (K3 forward and backward):
// the argument layout and the first layer's input row
// [pts (3) | PE(dirs) (d_view) | normals (3) | feature (d_feat)] of the IDR
// RenderingNetwork.  The products, the tile size and the partial-sum pass
// are those of sdf_mlp.cuh.
#pragma once

#include "sdf_mlp.cuh"

#define RAD_MAXW0 320        // widest first-layer input the kernels take

// Unpacks [L, multires, d_view, ld, squeeze_out, n, grid, ins[L], outs[L]]
// (ops/radiance_kernel.py) into SdfDims (skip_mask 0, scale 1) and the
// first layer's shared-memory stride *ld0.  Returns 0, or
// cudaErrorInvalidValue for a network these kernels cannot run.
static inline int rad_dims_from_args(const int* ia, SdfDims* d, int* ld0,
                                     int* squeeze) {
  d->L = ia[0];
  d->multires = ia[1];
  d->d_embed = ia[2];
  d->ld = ia[3];
  *squeeze = ia[4];
  d->skip_mask = 0;
  d->n = ia[5];
  d->scale = 1.f;
  if (d->L < 2 || d->L > SDF_MAXL || d->ld > SDF_MAXW ||
      d->d_embed != 3 * (1 + 2 * d->multires))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < d->L; ++l) {
    d->ins[l] = ia[7 + l];
    d->outs[l] = ia[7 + d->L + l];
    if (d->outs[l] > d->ld || (l > 0 && d->ins[l] != d->outs[l - 1]))
      return (int)cudaErrorInvalidValue;
  }
  if (d->ins[0] > RAD_MAXW0 || d->ins[0] <= 6 + d->d_embed)
    return (int)cudaErrorInvalidValue;
  *ld0 = (d->ins[0] + 3) / 4 * 4;
  return 0;
}

// Writes the first layer's input of the tile's 64 rows to X0 (stride ld0);
// rows past n are zero apart from the encoding's cosines.  Ends with a
// barrier.
__device__ __forceinline__ void build_x0(const SdfDims& d, int ld0, int row0,
                                         const float* __restrict__ pts,
                                         const float* __restrict__ nrm,
                                         const float* __restrict__ dirs,
                                         const float* __restrict__ feat,
                                         float* X0) {
  const int tid = threadIdx.x;
  const int d_view = d.d_embed;
  const int off_n = 3 + d_view, off_f = 6 + d_view;
  const int d_feat = d.ins[0] - off_f;
  if (tid < SDF_TILE) {
    const int row = row0 + tid;
    const bool valid = row < d.n;
    float* xr = X0 + tid * ld0;
    float u[3];
    for (int c = 0; c < 3; ++c) {
      xr[c] = valid ? pts[row * 3 + c] : 0.f;
      xr[off_n + c] = valid ? nrm[row * 3 + c] : 0.f;
      u[c] = valid ? dirs[row * 3 + c] : 0.f;
    }
    encode_row(u, nullptr, d.multires, xr + 3, nullptr);
  }
  for (int idx = tid; idx < SDF_TILE * d_feat; idx += SDF_THREADS) {
    const int r = idx / d_feat, c = idx - r * d_feat;
    const int row = row0 + r;
    X0[r * ld0 + off_f + c] =
        row < d.n ? __ldg(feat + (size_t)row * d_feat + c) : 0.f;
  }
  __syncthreads();
}
