// K1-bwd: the backward of K1-fwd.  Given the cotangents (ct_out, ct_grad)
// of (out, grad), it recomputes the primal forward together with a forward
// tangent along ct_grad, stacked as 32 primal + 32 tangent rows of one
// 64-row tile, then reverse-sweeps both chains (reverse over forward: the
// Hessian-vector term of the eikonal loss) -> ct_x and the weight and bias
// gradients summed over all rows.
//
// Replaces the TPU kernel factored_neus_tpu/ops/pallas_geometry.py
// (_make_geom.run_bwd, body _build_bwd_kernel_stacked).
//
// Bound: operations.  The function needs about 11.0 S FLOPs per row
// (S = 524,544 multiply-adds at full width): the primal and tangent
// forward without the last layer, the primal's weight-gradient and
// input-cotangent products, and the tangent's, whose last layer is only a
// column of dW and a row of W since its seed is e0 / scale.  This kernel
// does 11.5 S: it runs the tangent's last layer as full stacked products,
// like the rest of the stacked forward and reverse sweep.  What differs
// from the TPU: there the grid runs in order and the weight
// gradient accumulates in revisited VMEM blocks.  Here blocks run in
// parallel, so each persistent block accumulates into its own slice of a
// partial buffer, tile after tile in a fixed order, and a second small
// kernel sums the slices in a fixed order: the result is deterministic.
// The stacked pre-activations of one tile (9 x 64 x 260 floats) do not fit
// in shared memory next to the two 64-row work tiles, so they go to a
// per-block scratch that stays hot in L2.
#include "sdf_mlp.cuh"

#define HALF (SDF_TILE / 2)

__global__ void __launch_bounds__(SDF_THREADS, 1)
geometry_bwd_kernel(SdfDims d, const float* __restrict__ x,
                    const float* __restrict__ ct_out,
                    const float* __restrict__ ct_g, float* ct_x,
                    float* stash_all, float* part_all, long long P,
                    int n_tiles) {
  extern __shared__ float smem[];
  const int ld = d.ld;
  float* E = smem;                              // [64][64] enc | denc
  float* RE = E + SDF_TILE * SDF_ENC_LD;        // [64][64] their cotangents
  float* A = RE + SDF_TILE * SDF_ENC_LD;        // [64][ld] layer input / r_in
  float* R = A + SDF_TILE * ld;                 // [64][ld] output cotangent
  const size_t stash_layer = (size_t)SDF_TILE * ld;
  float* stash = stash_all + (size_t)blockIdx.x * d.L * stash_layer;
  float* part = part_all + (size_t)blockIdx.x * P;
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int tid = threadIdx.x;
  const int lL = d.L - 1;

  bool first = true;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, first = false) {
    const int row0 = t * HALF;
    if (tid < HALF) {
      const int row = row0 + tid;
      const bool valid = row < d.n;
      float u[3], v[3];
      for (int c = 0; c < 3; ++c) {
        u[c] = valid ? x[row * 3 + c] * d.scale : 0.f;
        v[c] = valid ? ct_g[row * 3 + c] * d.scale : 0.f;
      }
      encode_row(u, v, d.multires, E + tid * SDF_ENC_LD,
                 E + (HALF + tid) * SDF_ENC_LD);
    }
    for (int idx = tid; idx < SDF_TILE * SDF_ENC_LD; idx += SDF_THREADS)
      RE[idx] = 0.f;
    __syncthreads();

    // stacked forward: primal rows take the bias and softplus, tangent rows
    // the chain rule sigma(100 a) * ad; pre-activations go to the stash
    for (int l = 0; l < lL; ++l) {
      const float* xin = l == 0 ? E : A;
      const int ldx = l == 0 ? SDF_ENC_LD : ld;
      const int K = d.ins[l], N = d.outs[l];
      SDF_TN_DISPATCH(N, tile_mm<TN>(xin, ldx, K, d.wT[l], N, N, R, ld));
      __syncthreads();
      const bool skip_next = (d.skip_mask >> (l + 1)) & 1;
      const float post = skip_next ? inv_sqrt2 : 1.f;
      float* st = stash + l * stash_layer;
      for (int idx = tid; idx < HALF * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const float a = R[r * ld + c] + __ldg(d.b[l] + c);
        const float ad = R[(HALF + r) * ld + c];
        st[r * ld + c] = a;
        st[(HALF + r) * ld + c] = ad;
        A[r * ld + c] = sp100(a) * post;
        A[(HALF + r) * ld + c] = sig100(a) * ad * post;
      }
      if (skip_next)
        for (int idx = tid; idx < SDF_TILE * d.d_embed; idx += SDF_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          A[r * ld + N + c] = E[r * SDF_ENC_LD + c] * inv_sqrt2;
        }
      __syncthreads();
    }

    // seed: cotangent of the last layer's output
    {
      const int N = d.outs[lL];
      for (int idx = tid; idx < HALF * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        const int row = row0 + r;
        const bool valid = row < d.n;
        R[r * ld + c] = valid ? ct_out[(size_t)row * N + c] *
                                    (c == 0 ? inv_scale : 1.f)
                              : 0.f;
        R[(HALF + r) * ld + c] = (valid && c == 0) ? inv_scale : 0.f;
      }
      __syncthreads();
    }

    long long off = 0;
    for (int l = 0; l < lL; ++l) off += (long long)d.ins[l] * d.outs[l] + d.outs[l];
    for (int l = lL; l >= 0; --l) {
      const int K = d.ins[l], N = d.outs[l];
      const bool skip = (d.skip_mask >> l) & 1;
      // layer input (rebuilt from the stash; the forward left X_{L-1} in A)
      if (l > 0 && l < lL) {
        const int W = d.outs[l - 1];
        const float post = skip ? inv_sqrt2 : 1.f;
        const float* st = stash + (l - 1) * stash_layer;
        for (int idx = tid; idx < HALF * W; idx += SDF_THREADS) {
          const int r = idx / W, c = idx - r * W;
          const float a = st[r * ld + c];
          const float ad = st[(HALF + r) * ld + c];
          A[r * ld + c] = sp100(a) * post;
          A[(HALF + r) * ld + c] = sig100(a) * ad * post;
        }
        if (skip)
          for (int idx = tid; idx < SDF_TILE * d.d_embed; idx += SDF_THREADS) {
            const int r = idx / d.d_embed, c = idx - r * d.d_embed;
            A[r * ld + W + c] = E[r * SDF_ENC_LD + c] * inv_sqrt2;
          }
        __syncthreads();
      }
      const float* xl = l == 0 ? E : A;
      const int ldxl = l == 0 ? SDF_ENC_LD : ld;

      // weight gradient [in][out] over both halves; bias over primal rows
      SDF_TN_DISPATCH(N, tile_atb<TN>(xl, ldxl, K, R, ld, N, part + off, first));
      float* pb = part + off + (long long)K * N;
      for (int c = tid; c < N; c += SDF_THREADS) {
        float s = 0.f;
        for (int r = 0; r < HALF; ++r) s += R[r * ld + c];
        pb[c] = first ? s : pb[c] + s;
      }
      __syncthreads();

      // input cotangents of both chains: A = R @ W^T
      SDF_TN_DISPATCH(K, tile_mm<TN>(R, ld, N, d.wt[l], K, K, A, ld));
      __syncthreads();
      if (skip) {
        const int hw = K - d.d_embed;
        for (int idx = tid; idx < SDF_TILE * K; idx += SDF_THREADS) {
          const int r = idx / K, k = idx - r * K;
          const float v = A[r * ld + k] * inv_sqrt2;
          if (k >= hw) RE[r * SDF_ENC_LD + k - hw] += v;
          else A[r * ld + k] = v;
        }
        __syncthreads();
      }
      if (l == 0) {
        for (int idx = tid; idx < SDF_TILE * d.d_embed; idx += SDF_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          RE[r * SDF_ENC_LD + c] += A[r * ld + c];
        }
      } else {
        // h = sp(a): dh/da = s; hd = s ad: d(hd)/da = 100 s (1 - s) ad,
        // d(hd)/d(ad) = s
        const int W = d.outs[l - 1];
        const float* st = stash + (l - 1) * stash_layer;
        for (int idx = tid; idx < HALF * W; idx += SDF_THREADS) {
          const int r = idx / W, k = idx - r * W;
          const float a = st[r * ld + k];
          const float ad = st[(HALF + r) * ld + k];
          const float s = sig100(a);
          const float ds = 100.f * s * (1.f - s);
          const float rh = A[r * ld + k];
          const float rdh = A[(HALF + r) * ld + k];
          R[r * ld + k] = rh * s + rdh * ds * ad;
          R[(HALF + r) * ld + k] = rdh * s;
        }
        off -= (long long)d.ins[l - 1] * W + W;
      }
      __syncthreads();
    }

    if (tid < HALF) {
      const int row = row0 + tid;
      if (row < d.n) {
        float u[3], v[3], ct[3];
        for (int c = 0; c < 3; ++c) {
          u[c] = x[row * 3 + c] * d.scale;
          v[c] = ct_g[row * 3 + c] * d.scale;
        }
        encode_backward_row(u, v, d.multires, RE + tid * SDF_ENC_LD,
                            RE + (HALF + tid) * SDF_ENC_LD, ct);
        for (int c = 0; c < 3; ++c) ct_x[row * 3 + c] = ct[c] * d.scale;
      }
    }
    __syncthreads();
  }
}

// out[j] = sum over blocks b (in order) of part[b][j]
__global__ void reduce_partials_kernel(const float* __restrict__ part, int G,
                                       long long P, float* out) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= P) return;
  float s = 0.f;
  for (int b = 0; b < G; ++b) s += part[(size_t)b * P + j];
  out[j] = s;
}

// Integer arguments: [L, multires, d_embed, ld, skip_mask, n, grid,
// ins[L], outs[L]].  Pointers: [x, ct_out, ct_grad, ct_x, stash, partials,
// grads, wT[L], wt[L], b[L]].  grads receives, per layer, dW as [in][out]
// followed by db [out].  Returns a cudaError_t value.
extern "C" int geometry_bwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  SdfDims d;
  int rc = sdf_dims_from_args(ia, scale, &d);
  if (rc) return rc;
  const int L = d.L;
  long long P = 0;
  for (int l = 0; l < L; ++l) {
    d.wT[l] = (const float*)p[7 + l];
    d.wt[l] = (const float*)p[7 + L + l];
    d.b[l] = (const float*)p[7 + 2 * L + l];
    P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
  }
  const int grid = ia[6];
  const int n_tiles = (d.n + HALF - 1) / HALF;
  const size_t smem = (size_t)(2 * SDF_TILE * SDF_ENC_LD + 2 * SDF_TILE * d.ld) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      geometry_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  geometry_bwd_kernel<<<grid, SDF_THREADS, smem, s>>>(
      d, (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (float*)p[3], (float*)p[4], (float*)p[5], P, n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rb = 256;
  reduce_partials_kernel<<<(int)((P + rb - 1) / rb), rb, 0, s>>>(
      (const float*)p[5], grid, P, (float*)p[6]);
  return (int)cudaGetLastError();
}
