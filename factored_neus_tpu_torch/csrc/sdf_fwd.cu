// K2: fused positional encoding + SDF MLP forward, no gradient.  Serves the
// no-grad SDF sweeps of the up-sampling ladder (with the last layer narrowed
// to the sdf column by the caller) and full [sdf | feature] evaluations.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_sdf.py
// (sdf_forward_pallas, body _build_kernel).
//
// Bound: operations (2 x 459,008 FLOPs per row for the narrowed full-width
// network against 12 bytes in and 4 out).  The design keeps the 64-row
// activation tile in shared memory through all layers and streams each
// layer's weight rows from L2, exactly like K1's forward half, with no
// stash and no reverse sweep.
#include "sdf_mlp.cuh"

__global__ void __launch_bounds__(SDF_THREADS, 1)
sdf_fwd_kernel(SdfDims d, const float* __restrict__ x, float* out) {
  extern __shared__ float smem[];
  const int ld = d.ld;
  float* E = smem;
  float* X = E + SDF_TILE * SDF_ENC_LD;
  float* Y = X + SDF_TILE * ld;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * SDF_TILE;
  if (tid < SDF_TILE) {
    const int row = row0 + tid;
    float u[3];
    for (int c = 0; c < 3; ++c)
      u[c] = row < d.n ? x[row * 3 + c] * d.scale : 0.f;
    encode_row(u, nullptr, d.multires, E + tid * SDF_ENC_LD, nullptr);
  }
  __syncthreads();
  forward_hidden(d, E, X, Y, nullptr, 0);
  const int lL = d.L - 1;
  const float* xin = lL == 0 ? E : X;
  const int ldx = lL == 0 ? SDF_ENC_LD : ld;
  const int K = d.ins[lL], N = d.outs[lL];
  SDF_TN_DISPATCH(N, tile_mm<TN>(xin, ldx, K, d.wT[lL], N, N, Y, ld));
  __syncthreads();
  const float inv_scale = 1.f / d.scale;
  for (int idx = tid; idx < SDF_TILE * N; idx += SDF_THREADS) {
    const int r = idx / N, c = idx - r * N;
    const int row = row0 + r;
    if (row < d.n)
      out[(size_t)row * N + c] =
          (Y[r * ld + c] + __ldg(d.b[lL] + c)) * (c == 0 ? inv_scale : 1.f);
  }
}

// Integer arguments: [L, multires, d_embed, ld, skip_mask, n, (unused),
// ins[L], outs[L]].  Pointers: [x, out, wT[L], b[L]].
extern "C" int sdf_fwd(const int* ia, const unsigned long long* p,
                       float scale, unsigned long long stream) {
  SdfDims d;
  int rc = sdf_dims_from_args(ia, scale, &d);
  if (rc) return rc;
  const int L = d.L;
  for (int l = 0; l < L; ++l) {
    d.wT[l] = (const float*)p[2 + l];
    d.wt[l] = nullptr;
    d.b[l] = (const float*)p[2 + L + l];
  }
  const int n_tiles = (d.n + SDF_TILE - 1) / SDF_TILE;
  const size_t smem =
      (size_t)(SDF_TILE * SDF_ENC_LD + 2 * SDF_TILE * d.ld) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      sdf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sdf_fwd_kernel<<<n_tiles, SDF_THREADS, smem, (cudaStream_t)stream>>>(
      d, (const float*)p[0], (float*)p[1]);
  return (int)cudaGetLastError();
}
