// K2: fused positional encoding + SDF MLP forward, no gradient.  Serves the
// no-grad SDF sweeps of the up-sampling ladder and the mesh grid fill (with
// the last layer narrowed to the sdf column by the caller) and full
// [sdf | feature] evaluations.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_sdf.py
// (sdf_forward_pallas, body _build_kernel).
//
// Bound: operations (2 x 459,008 FLOPs per row for the narrowed full-width
// network against 12 bytes in and 4 out).  The design is K1-fwd's forward
// half (geometry_fwd.cu) and nothing else: no tangent, no scratch, no
// reverse sweep.  Every product runs on the tensor cores in 3xTF32
// (tc_mma.cuh), so the least time is three TF32 products' worth of the
// FLOPs over 495 TFLOP/s.  Persistent blocks, one per SM, walk 64-row
// tiles; a tile's activations stay in shared memory through the whole
// layer chain while the weights (one pack a step, pre-split into TF32 big
// and small halves) are staged slice by slice into a shared-memory ring by
// cp.async.  Only the W^T blocks of the pack are read, so K2 takes K1's
// pack of the same step with the last layer's output count told as 1: its
// narrowed layer is the first column of K1's last W^T block, one n8 tile.
// Shared memory at full width (narrowed, ld 260): the encoding 64 x 44
// floats (11,264 B), two activation tiles 64 x 260 (133,120 B) and the
// ring, two stages of 16 rows of stride 264, big and small (67,584 B):
// 211,968 B of the 232,448 a block may use.
//
// K2-bf16, the same function on bf16 operands, is sdf_fwd_bf16.cu (wgmma).
#include "sdf_mlp.cuh"
#include "tc_mma.cuh"

__global__ void __launch_bounds__(TC_THREADS, 1)
sdf_fwd_kernel(TcDims d, const float* __restrict__ x, float* out,
               int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d.ld, eld = d.eld;
  float* E = smem;                              // [64][eld] encoding
  float* X = E + TC_TILE * eld;                 // [64][ld] layer input
  float* Y = X + TC_TILE * ld;                  // [64][ld] product
  float* ring = Y + TC_TILE * ld;               // two weight-slice stages
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

    // hidden layers: x_{l+1} = softplus(x_l W_l^T + b_l) (/ sqrt 2 and the
    // encoding appended before a skip)
    for (int l = 0; l < lL; ++l) {
      const int N = d.outs[l];
      tc_product<2>(d, l == 0 ? E : X, l == 0 ? eld : ld, d.kp[l],
                    d.fwd_off[l], d.fwd_st[l], d.np[l], Y, ld, ring);
      __syncthreads();
      const bool skip_next = (d.skip_mask >> (l + 1)) & 1;
      const float post = skip_next ? inv_sqrt2 : 1.f;
      const float* bias = d.b[l];
      for (int idx = tid; idx < TC_TILE * N; idx += TC_THREADS) {
        const int r = idx / N, c = idx - r * N;
        X[r * ld + c] = sp100(Y[r * ld + c] + __ldg(bias + c)) * post;
      }
      if (skip_next)
        for (int idx = tid; idx < TC_TILE * d.d_embed; idx += TC_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          X[r * ld + N + c] = E[r * eld + c] * inv_sqrt2;
        }
      __syncthreads();
    }

    // last layer -> [sdf / scale | feature], or sdf / scale when narrowed
    const int N = d.outs[lL];
    tc_product<2>(d, lL == 0 ? E : X, lL == 0 ? eld : ld, d.kp[lL],
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
  }
}

// Integer arguments: tc_dims_from_args' (the pack's layout after ins and
// outs; the last layer's outs may be narrower than the pack's block).
// Pointers: [x, out, pack, b[L]].  Returns a cudaError_t value; 0 when the
// launch was accepted.
extern "C" int sdf_fwd(const int* ia, const unsigned long long* p,
                       float scale, unsigned long long stream) {
  TcDims d;
  int rc = tc_dims_from_args(ia, scale, (const float*)p[2], &d);
  if (rc) return rc;
  for (int l = 0; l < d.L; ++l) d.b[l] = (const float*)p[3 + l];
  const int grid = ia[6];
  const int n_tiles = (d.n + TC_TILE - 1) / TC_TILE;
  const size_t smem = tc_smem_bytes(d, (size_t)TC_TILE * (d.eld + 2 * d.ld));
  if (!smem || grid < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sdf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sdf_fwd_kernel<<<grid, TC_THREADS, smem, (cudaStream_t)stream>>>(
      d, (const float*)p[0], (float*)p[1], n_tiles);
  return (int)cudaGetLastError();
}
