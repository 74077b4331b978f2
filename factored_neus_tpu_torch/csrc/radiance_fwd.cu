// K3-fwd-bf16: the fused IDR radiance MLP in the bf16 operand mode.
// Positional encoding of the view directions, the concat [pts | PE(dirs) |
// normals | feature], the ReLU hidden layers, the last layer and, with
// squeeze_out, the sigmoid -> rgb.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_radiance.py
// (_make_radiance(cfg, bf16=True).run_fwd, body _build_fwd_kernel with
// _mm_fns(True), rendering_apply_pallas' default): every product on bf16
// operands (to nearest even) with an f32 sum, on bf16 mma.sync
// (tc_mma.cuh, BF) from pack_weights_bf16's pack; the encoding, biases,
// ReLU and sigmoid stay f32.  K3-fwd, its f32 twin, is radiance_fwd_wg.cu
// (3xTF32 on wgmma).
//
// Bound: operations.  At full width a row costs 2 x 271,360 FLOPs (layers
// 289->256, 3 x 256->256, 256->3) against 1,036 bytes in (the 256-d
// feature dominates) and 12 out: one bf16 product's worth of the FLOPs
// over 989 TFLOP/s.  Persistent blocks, one per SM, walk 64-row tiles; a
// tile's activations stay in shared memory through the whole layer chain
// while the W^T blocks of the weight pack (built once a step) are staged
// slice by slice into the ring by cp.async.  No scratch.  Its shared
// memory: two tiles of 64 x 300 floats (ld = the 289-wide first input
// rounded to 8, plus 4).  The 289-wide x0 is 18 full k16 steps and a half
// one (the engine's last stage of a depth of 296 is 8 rows deep and reads
// no column past 296, so the zero padding [289, 296) and ld 300 serve; the
// pack pads the block to 304 rows).  The bf16 ring stages one half of 16
// rows a stage and is sized by a 64-row weight-gradient chunk
// (tc_pack.smem_bytes' count, the larger): 220,176 B in all.
#include "radiance_mlp.cuh"

__global__ void __launch_bounds__(TC_THREADS, 1)
radiance_fwd_bf16_kernel(TcDims d, int squeeze,
                         const float* __restrict__ pts,
                         const float* __restrict__ nrm,
                         const float* __restrict__ dirs,
                         const float* __restrict__ feat, float* out,
                         int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int ld = d.ld;
  float* A = smem;                      // [64][ld] layer input
  float* Y = A + TC_TILE * ld;          // [64][ld] product
  float* ring = Y + TC_TILE * ld;       // two weight-slice stages
  const int tid = threadIdx.x;
  const int lL = d.L - 1;
  const int K0 = d.ins[0], pad = d.kp[0] - K0;

  // the products read padding columns, which must be finite
  for (int i = tid; i < 2 * TC_TILE * ld; i += TC_THREADS) smem[i] = 0.f;
  __syncthreads();

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * TC_TILE;
    // x0 into A; its padding columns [K0, kp0) zero, as the first layer's
    // product reads them
    for (int idx = tid; idx < TC_TILE * pad; idx += TC_THREADS)
      A[(idx / pad) * ld + K0 + idx % pad] = 0.f;
    build_x0(d, ld, row0, pts, nrm, dirs, feat, A);

    // hidden layers: h_{l+1} = relu(h_l W_l^T + b_l), back into A
    for (int l = 0; l < lL; ++l) {
      const int N = d.outs[l];
      tc_product<2, true>(d, A, ld, d.kp[l], d.fwd_off[l], d.fwd_st[l],
                          d.np[l], Y, ld, ring);
      __syncthreads();
      const float* bias = d.b[l];
      for (int idx = tid; idx < TC_TILE * N; idx += TC_THREADS) {
        const int r = idx / N, c = idx - r * N;
        A[r * ld + c] = fmaxf(Y[r * ld + c] + __ldg(bias + c), 0.f);
      }
      __syncthreads();
    }

    // last layer -> rgb, through the sigmoid with squeeze_out
    const int N = d.outs[lL];
    tc_product<2, true>(d, A, ld, d.kp[lL], d.fwd_off[lL], d.fwd_st[lL],
                        d.np[lL], Y, ld, ring);
    __syncthreads();
    for (int idx = tid; idx < TC_TILE * N; idx += TC_THREADS) {
      const int r = idx / N, c = idx - r * N;
      const int row = row0 + r;
      if (row < d.n) {
        const float a = Y[r * ld + c] + __ldg(d.b[lL] + c);
        out[(size_t)row * N + c] = squeeze ? 1.f / (1.f + expf(-a)) : a;
      }
    }
    __syncthreads();
  }
}

// K3-fwd-bf16.  Integer arguments: rad_tc_dims_from_args'.  Pointers:
// [pts, normals, dirs, feat, rgb, pack (pack_weights_bf16's), b[L]].
// Returns a cudaError_t value; 0 when the launch was accepted.
extern "C" int radiance_fwd_bf16(const int* ia, const unsigned long long* p,
                                 float scale, unsigned long long stream) {
  (void)scale;
  TcDims d;
  int squeeze;
  int rc = rad_tc_dims_from_args(ia, (const float*)p[5], &d, &squeeze);
  if (rc) return rc;
  for (int l = 0; l < d.L; ++l) d.b[l] = (const float*)p[6 + l];
  const int grid = ia[6];
  const int n_tiles = (d.n + TC_TILE - 1) / TC_TILE;
  const size_t smem = tc_smem_bytes(d, (size_t)2 * TC_TILE * d.ld);
  if (!smem || grid < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      radiance_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  radiance_fwd_bf16_kernel<<<grid, TC_THREADS, smem, (cudaStream_t)stream>>>(
      d, squeeze, (const float*)p[0], (const float*)p[1],
      (const float*)p[2], (const float*)p[3], (float*)p[4], n_tiles);
  return (int)cudaGetLastError();
}
