// K3-fwd: the fused IDR radiance MLP.  Positional encoding of the view
// directions, the concat [pts | PE(dirs) | normals | feature], the ReLU
// hidden layers, the last layer and, with squeeze_out, the sigmoid -> rgb.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_radiance.py
// (_make_radiance.run_fwd, body _build_fwd_kernel).
//
// Bound: operations.  At full width a row costs 2 x 271,360 FLOPs (layers
// 289->256, 3 x 256->256, 256->3) against 1,036 bytes in (the 256-d
// feature dominates) and 12 out.  The design is sdf_mlp.cuh's tile_mm on
// the CUDA cores: one 64-row tile per block, its activations in shared
// memory through the whole layer chain, weight rows streamed from L2 with
// __ldg (1.09 MB of f32 weights do not fit in shared memory).  The first layer's 289-wide input has its own
// stride so the hidden buffers stay 256 wide; nothing is padded in memory.
#include "radiance_mlp.cuh"

__global__ void __launch_bounds__(SDF_THREADS, 1)
radiance_fwd_kernel(SdfDims d, int ld0, int squeeze,
                    const float* __restrict__ pts,
                    const float* __restrict__ nrm,
                    const float* __restrict__ dirs,
                    const float* __restrict__ feat, float* out) {
  extern __shared__ float smem[];
  const int ld = d.ld;
  float* X0 = smem;                      // [64][ld0] first layer's input
  float* X = X0 + SDF_TILE * ld0;        // [64][ld]  hidden activations
  float* Y = X + SDF_TILE * ld;          // [64][ld]  product output
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * SDF_TILE;
  build_x0<SDF_THREADS>(d, ld0, row0, pts, nrm, dirs, feat, X0);
  for (int l = 0; l < d.L; ++l) {
    const float* xin = l == 0 ? X0 : X;
    const int ldx = l == 0 ? ld0 : ld;
    const int K = d.ins[l], N = d.outs[l];
    SDF_TN_DISPATCH(N, tile_mm<TN>(xin, ldx, K, d.wT[l], N, N, Y, ld));
    __syncthreads();
    const float* bias = d.b[l];
    if (l + 1 < d.L) {
      for (int idx = tid; idx < SDF_TILE * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        X[r * ld + c] = fmaxf(Y[r * ld + c] + __ldg(bias + c), 0.f);
      }
    } else {
      for (int idx = tid; idx < SDF_TILE * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const int row = row0 + r;
        const float a = Y[r * ld + c] + __ldg(bias + c);
        if (row < d.n)
          out[(size_t)row * N + c] = squeeze ? 1.f / (1.f + expf(-a)) : a;
      }
    }
    __syncthreads();
  }
}

// Integer arguments: [L, multires, d_view, ld, squeeze_out, n, (unused),
// ins[L], outs[L]].  Pointers: [pts, normals, dirs, feat, rgb, wT[L],
// b[L]].  Returns a cudaError_t value; 0 when the launch was accepted.
extern "C" int radiance_fwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  (void)scale;
  SdfDims d;
  int ld0, squeeze;
  int rc = rad_dims_from_args(ia, &d, &ld0, &squeeze);
  if (rc) return rc;
  const int L = d.L;
  for (int l = 0; l < L; ++l) {
    d.wT[l] = (const float*)p[5 + l];
    d.b[l] = (const float*)p[5 + L + l];
  }
  const int n_tiles = (d.n + SDF_TILE - 1) / SDF_TILE;
  const size_t smem = (size_t)SDF_TILE * (ld0 + 2 * d.ld) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      radiance_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  radiance_fwd_kernel<<<n_tiles, SDF_THREADS, smem, (cudaStream_t)stream>>>(
      d, ld0, squeeze, (const float*)p[0], (const float*)p[1],
      (const float*)p[2], (const float*)p[3], (float*)p[4]);
  return (int)cudaGetLastError();
}
