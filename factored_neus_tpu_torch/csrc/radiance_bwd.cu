// K3-bwd: the backward of K3-fwd.  Given ct_rgb it recomputes the forward,
// then reverse-sweeps: the sigmoid's y (1 - y), the ReLU masks a > 0, the
// weight and bias gradients summed over all rows, and the cotangents of
// pts, normals, feature and, through the positional encoding's Jacobian,
// of the view directions.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_radiance.py
// (_make_radiance.run_bwd, body _build_bwd_kernel).
//
// Bound: operations, 6 x 271,360 FLOPs per row at full width (forward,
// weight gradient and input cotangent of every layer) against ~2 KB moved
// per row.  A persistent block walks 64-row tiles; the first layer's input
// stays in shared memory, the hidden activations h = relu(a) (their sign
// is the ReLU mask) go to a per-block scratch (35 MB at 132 blocks: under
// the 50 MB L2, but sharing it with the 143 MB of partial slices); each
// block accumulates its weight gradients into its
// own slice of a partial buffer, tile after tile, and a second kernel sums
// the slices in a fixed order: deterministic, no atomics.  The first
// layer's input cotangent is 289 columns wide, past the 288 the column
// tiling covers, so it runs as products of at most 256 columns.
#include "radiance_mlp.cuh"

__global__ void __launch_bounds__(SDF_THREADS, 1)
radiance_bwd_kernel(SdfDims d, int ld0, int squeeze,
                    const float* __restrict__ pts,
                    const float* __restrict__ nrm,
                    const float* __restrict__ dirs,
                    const float* __restrict__ feat,
                    const float* __restrict__ ct_rgb, float* ct_pts,
                    float* ct_nrm, float* ct_dirs, float* ct_feat,
                    float* stash_all, float* part_all, long long P,
                    int n_tiles) {
  extern __shared__ float smem[];
  const int ld = d.ld;
  float* X0 = smem;                      // [64][ld0] x0, then its cotangent
  float* A = X0 + SDF_TILE * ld0;        // [64][ld]  layer input / r_in
  float* R = A + SDF_TILE * ld;          // [64][ld]  output cotangent
  const size_t stash_layer = (size_t)SDF_TILE * ld;
  float* stash = stash_all + (size_t)blockIdx.x * (d.L - 1) * stash_layer;
  float* part = part_all + (size_t)blockIdx.x * P;
  const int tid = threadIdx.x;
  const int lL = d.L - 1;
  const int d_view = d.d_embed;
  const int off_n = 3 + d_view, off_f = 6 + d_view;
  const int d_feat = d.ins[0] - off_f;

  bool first = true;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, first = false) {
    const int row0 = t * SDF_TILE;
    build_x0(d, ld0, row0, pts, nrm, dirs, feat, X0);

    // forward: h_l = relu(a_l) to A and the stash
    for (int l = 0; l < lL; ++l) {
      const float* xin = l == 0 ? X0 : A;
      const int ldx = l == 0 ? ld0 : ld;
      const int K = d.ins[l], N = d.outs[l];
      SDF_TN_DISPATCH(N, tile_mm<TN>(xin, ldx, K, d.wT[l], N, N, R, ld));
      __syncthreads();
      float* st = stash + l * stash_layer;
      for (int idx = tid; idx < SDF_TILE * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const float h = fmaxf(R[r * ld + c] + __ldg(d.b[l] + c), 0.f);
        st[r * ld + c] = h;
        A[r * ld + c] = h;
      }
      __syncthreads();
    }

    // last layer and the seed: r = ct_rgb y (1 - y), or ct_rgb
    {
      const int K = d.ins[lL], N = d.outs[lL];
      SDF_TN_DISPATCH(N, tile_mm<TN>(A, ld, K, d.wT[lL], N, N, R, ld));
      __syncthreads();
      for (int idx = tid; idx < SDF_TILE * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const int row = row0 + r;
        const float ct = row < d.n ? ct_rgb[(size_t)row * N + c] : 0.f;
        float v = ct;
        if (squeeze) {
          const float y =
              1.f / (1.f + expf(-(R[r * ld + c] + __ldg(d.b[lL] + c))));
          v = ct * y * (1.f - y);
        }
        R[r * ld + c] = v;
      }
      __syncthreads();
    }

    // reverse sweep: on entry to layer l, A holds h_{l-1} (l > 0) and R the
    // cotangent of a_l
    long long off = P;
    for (int l = lL; l >= 0; --l) {
      const int K = d.ins[l], N = d.outs[l];
      off -= (long long)K * N + N;
      const float* xl = l == 0 ? X0 : A;
      const int ldxl = l == 0 ? ld0 : ld;
      SDF_TN_DISPATCH(N, tile_atb<TN>(xl, ldxl, K, R, ld, N, part + off, first));
      float* pb = part + off + (long long)K * N;
      for (int c = tid; c < N; c += SDF_THREADS) {
        float s = 0.f;
        for (int r = 0; r < SDF_TILE; ++r) s += R[r * ld + c];
        pb[c] = first ? s : pb[c] + s;
      }
      __syncthreads();
      if (l > 0) {
        // r_in = R @ W_l, masked by h_{l-1} > 0
        SDF_TN_DISPATCH(K, tile_mm<TN>(R, ld, N, d.wt[l], K, K, A, ld));
        __syncthreads();
        const float* st = stash + (l - 1) * stash_layer;
        for (int idx = tid; idx < SDF_TILE * K; idx += SDF_THREADS) {
          const int r = idx / K, k = idx - r * K;
          R[r * ld + k] = st[r * ld + k] > 0.f ? A[r * ld + k] : 0.f;
        }
        __syncthreads();
        if (l > 1) {
          const int W = d.outs[l - 2];
          const float* sp = stash + (l - 2) * stash_layer;
          for (int idx = tid; idx < SDF_TILE * W; idx += SDF_THREADS) {
            const int r = idx / W, k = idx - r * W;
            A[r * ld + k] = sp[r * ld + k];
          }
          __syncthreads();
        }
      } else {
        // cotangent of x0 into X0, in products of at most 256 columns
        for (int c0 = 0; c0 < K; c0 += 256) {
          const int Nc = min(256, K - c0);
          SDF_TN_DISPATCH(Nc, tile_mm<TN>(R, ld, N, d.wt[0] + c0, K, Nc,
                                          X0 + c0, ld0));
        }
        __syncthreads();
      }
    }

    // split the x0 cotangent: pts, dirs through the PE Jacobian, normals,
    // feature
    if (tid < SDF_TILE) {
      const int row = row0 + tid;
      if (row < d.n) {
        const float* xr = X0 + tid * ld0;
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
    for (int idx = tid; idx < SDF_TILE * d_feat; idx += SDF_THREADS) {
      const int r = idx / d_feat, c = idx - r * d_feat;
      const int row = row0 + r;
      if (row < d.n)
        ct_feat[(size_t)row * d_feat + c] = X0[r * ld0 + off_f + c];
    }
    __syncthreads();
  }
}

// Integer arguments: [L, multires, d_view, ld, squeeze_out, n, grid,
// ins[L], outs[L]].  Pointers: [pts, normals, dirs, feat, ct_rgb, ct_pts,
// ct_normals, ct_dirs, ct_feat, stash, partials, grads, wT[L], wt[L],
// b[L]].  grads receives, per layer, dW as [in][out] followed by db [out].
// Returns a cudaError_t value.
extern "C" int radiance_bwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  (void)scale;
  SdfDims d;
  int ld0, squeeze;
  int rc = rad_dims_from_args(ia, &d, &ld0, &squeeze);
  if (rc) return rc;
  const int L = d.L;
  long long P = 0;
  for (int l = 0; l < L; ++l) {
    d.wT[l] = (const float*)p[12 + l];
    d.wt[l] = (const float*)p[12 + L + l];
    d.b[l] = (const float*)p[12 + 2 * L + l];
    P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
  }
  const int grid = ia[6];
  const int n_tiles = (d.n + SDF_TILE - 1) / SDF_TILE;
  const size_t smem = (size_t)SDF_TILE * (ld0 + 2 * d.ld) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      radiance_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  radiance_bwd_kernel<<<grid, SDF_THREADS, smem, s>>>(
      d, ld0, squeeze, (const float*)p[0], (const float*)p[1],
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
