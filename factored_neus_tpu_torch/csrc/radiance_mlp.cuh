// Device code of K3-fwd-bf16 (radiance_fwd.cu): its argument layout and
// the first layer's input row [pts (3) | PE(dirs) (d_view) | normals (3) |
// feature (d_feat)] of the IDR RenderingNetwork.  It runs its products on
// the tensor cores (tc_mma.cuh, bf16 mma.sync) from one weight pack.
#pragma once

#include "sdf_mlp.cuh"
#include "tc_mma.cuh"

// K3-fwd-bf16's arguments [L, multires, d_view, ld, squeeze_out, n, grid,
// ins[L], outs[L], then the bf16 pack's layout]
// (ops/radiance_kernel.kernel_iargs) into TcDims: no skip, scale 1,
// d_embed = d_view, the pack pack_weights_bf16's (the ring sized for it).
// The first layer's input may be as wide as the row stride ld: a product's
// depth is unbounded.  Only the first layer's input, whose W block another
// block of the pack follows, may be wider than 256.  Returns 0, or
// cudaErrorInvalidValue for a network or layout this code cannot run.
static inline int rad_tc_dims_from_args(const int* ia, const float* pack,
                                        TcDims* d, int* squeeze) {
  const int L = ia[0];
  d->L = L;
  d->multires = ia[1];
  d->d_embed = ia[2];
  d->ld = ia[3];
  *squeeze = ia[4];
  d->skip_mask = 0;
  d->n = ia[5];
  d->scale = 1.f;
  d->pack = pack;
  d->eld = 0;
  if (L < 2 || L > TC_MAXL || d->d_embed != 3 * (1 + 2 * d->multires) ||
      d->ld % 8 != 4)
    return (int)cudaErrorInvalidValue;
  int rc = tc_layers_from_args(ia, d->ld, d, true);
  if (rc) return rc;
  for (int l = 1; l < L; ++l)
    if (d->ins[l] != d->outs[l - 1] || d->kp[l] > 256)
      return (int)cudaErrorInvalidValue;
  if (d->ins[0] <= 6 + d->d_embed) return (int)cudaErrorInvalidValue;
  return 0;
}

// Writes the first layer's input of the tile's 64 rows to X0 (stride ld0)
// with the block's threads; rows past n are zero apart from the
// encoding's cosines.  Ends with a barrier.
__device__ __forceinline__ void build_x0(const TcDims& d, int ld0, int row0,
                                         const float* __restrict__ pts,
                                         const float* __restrict__ nrm,
                                         const float* __restrict__ dirs,
                                         const float* __restrict__ feat,
                                         float* X0) {
  const int tid = threadIdx.x;
  const int d_view = d.d_embed;
  const int off_n = 3 + d_view, off_f = 6 + d_view;
  const int d_feat = d.ins[0] - off_f;
  if (tid < TC_TILE) {
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
  for (int idx = tid; idx < TC_TILE * d_feat; idx += TC_THREADS) {
    const int r = idx / d_feat, c = idx - r * d_feat;
    const int row = row0 + r;
    X0[r * ld0 + off_f + c] =
        row < d.n ? __ldg(feat + (size_t)row * d_feat + c) : 0.f;
  }
  __syncthreads();
}
