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
//
// K1-bwd-stash (entry point geometry_bwd_stash) replaces
// _make_geom.run_bwd_stash (body _build_bwd_kernel_from_stash): the primal
// pre-activations come from the bf16 stash that K1-fwd-stash wrote, so
// only the tangent forward is recomputed, as a half-tile product over the
// 32 tangent rows; biases are not read.  Bound: operations, 2 S' fewer
// FLOPs per row than K1-bwd (S' = S without the last layer), against
// 4,018 more bytes read per row at full width.
//
// K1-bwd-split (entry point geometry_bwd_split) replaces the same call with
// stacked=False (body _build_bwd_kernel): the same function as K1-bwd, with
// the primal and tangent chains as separate row sets.  Each product of the
// stacked sweep becomes two half-tile products, one over each chain's 32
// rows (forward a = x W + b and ad = xd W, input cotangents r W^T and
// rd W^T), and the weight gradient two 32-row sums x^T r and xd^T rd into
// the same partial slice.  Bound: as K1-bwd.
#include <cuda_bf16.h>

#include "sdf_mlp.cuh"

#define HALF (SDF_TILE / 2)

// Column offset of layer l's pre-activations in a stash row.
__device__ __forceinline__ int stash_col(const SdfDims& d, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += d.outs[i];
  return off;
}

// The three variants: the stacked 64-row products, the stash (primal from
// the bf16 stash, tangent forward only), and the split chains.
enum BwdMode { BWD_STACKED, BWD_STASH, BWD_SPLIT };

// Y = X @ B over both chains of the tile: one 64-row product, or one
// half-tile product per chain.
template <int TN, int MODE>
__device__ __forceinline__ void chains_mm(const float* X, int ldx, int K,
                                          const float* __restrict__ B, int N,
                                          float* Y, int ldy) {
  if (MODE == BWD_SPLIT) {
    tile_mm<TN, 4>(X, ldx, K, B, N, N, Y, ldy);
    tile_mm<TN, 4>(X + HALF * ldx, ldx, K, B, N, N, Y + HALF * ldy, ldy);
  } else {
    tile_mm<TN>(X, ldx, K, B, N, N, Y, ldy);
  }
}

// C (+)= X^T @ Rm summed over both chains' rows: one 64-row sum, or one
// 32-row sum per chain into the same C.
template <int TN, int MODE>
__device__ __forceinline__ void chains_atb(const float* X, int ldx, int M,
                                           const float* Rm, int ldr, int N,
                                           float* C, bool first) {
  if (MODE == BWD_SPLIT) {
    tile_atb<TN, HALF>(X, ldx, M, Rm, ldr, N, C, first);
    tile_atb<TN, HALF>(X + HALF * ldx, ldx, M, Rm + HALF * ldr, ldr, N, C,
                       false);
  } else {
    tile_atb<TN>(X, ldx, M, Rm, ldr, N, C, first);
  }
}

template <int MODE>
__global__ void __launch_bounds__(SDF_THREADS, 1)
geometry_bwd_kernel(SdfDims d, const float* __restrict__ x,
                    const float* __restrict__ ct_out,
                    const float* __restrict__ ct_g, float* ct_x,
                    float* stash_all, float* part_all, long long P,
                    int n_tiles, const __nv_bfloat16* __restrict__ bstash,
                    int stash_cols) {
  constexpr bool FROM_STASH = MODE == BWD_STASH;
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
  const int n_rows = d.n;

  bool first = true;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x, first = false) {
    const int row0 = t * HALF;
    // primal pre-activation a_l of the tile's row r, column c: from the
    // bf16 stash (so = the layer's column offset there), or from the
    // scratch the stacked forward wrote
    auto primal = [=](int l, int so, int r, int c) -> float {
      if (FROM_STASH) {
        const int row = row0 + r;
        return row < n_rows ? __bfloat162float(
                                  bstash[(size_t)row * stash_cols + so + c])
                            : 0.f;
      }
      return stash[l * stash_layer + r * ld + c];
    };
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
    // the chain rule sigma(100 a) * ad; pre-activations go to the scratch.
    // From the stash only the tangent rows are computed.
    for (int l = 0; l < lL; ++l) {
      const float* xin = l == 0 ? E : A;
      const int ldx = l == 0 ? SDF_ENC_LD : ld;
      const int K = d.ins[l], N = d.outs[l];
      if (FROM_STASH) {
        SDF_TN_DISPATCH(N, (tile_mm<TN, 4>(xin + HALF * ldx, ldx, K,
                                           d.wT[l], N, N, R + HALF * ld,
                                           ld)));
      } else {
        SDF_TN_DISPATCH(N, (chains_mm<TN, MODE>(xin, ldx, K, d.wT[l], N, R,
                                                ld)));
      }
      __syncthreads();
      const bool skip_next = (d.skip_mask >> (l + 1)) & 1;
      const float post = skip_next ? inv_sqrt2 : 1.f;
      const int so = FROM_STASH ? stash_col(d, l) : 0;
      float* st = stash + l * stash_layer;
      for (int idx = tid; idx < HALF * N; idx += SDF_THREADS) {
        const int r = idx / N, c = idx - r * N;
        float a;
        if (FROM_STASH) {
          a = primal(l, so, r, c);
        } else {
          a = R[r * ld + c] + __ldg(d.b[l] + c);
          st[r * ld + c] = a;
          A[r * ld + c] = sp100(a) * post;
        }
        const float ad = R[(HALF + r) * ld + c];
        st[(HALF + r) * ld + c] = ad;
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
      // layer input, rebuilt from the scratch or the stash (the stacked
      // forward left X_{L-1} in A; from the stash only its tangent rows)
      if (l > 0 && (FROM_STASH || l < lL)) {
        const int W = d.outs[l - 1];
        const float post = skip ? inv_sqrt2 : 1.f;
        const int so = FROM_STASH ? stash_col(d, l - 1) : 0;
        const float* st = stash + (l - 1) * stash_layer;
        for (int idx = tid; idx < HALF * W; idx += SDF_THREADS) {
          const int r = idx / W, c = idx - r * W;
          const float a = primal(l - 1, so, r, c);
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
      SDF_TN_DISPATCH(N, (chains_atb<TN, MODE>(xl, ldxl, K, R, ld, N,
                                               part + off, first)));
      float* pb = part + off + (long long)K * N;
      for (int c = tid; c < N; c += SDF_THREADS) {
        float s = 0.f;
        for (int r = 0; r < HALF; ++r) s += R[r * ld + c];
        pb[c] = first ? s : pb[c] + s;
      }
      __syncthreads();

      // input cotangents of both chains: A = R @ W^T
      SDF_TN_DISPATCH(K, (chains_mm<TN, MODE>(R, ld, N, d.wt[l], K, A, ld)));
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
        const int so = FROM_STASH ? stash_col(d, l - 1) : 0;
        const float* st = stash + (l - 1) * stash_layer;
        for (int idx = tid; idx < HALF * W; idx += SDF_THREADS) {
          const int r = idx / W, k = idx - r * W;
          const float a = primal(l - 1, so, r, k);
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

// The weight pointers start at index 7: [wT[L], wt[L], b[L]]; from the
// stash at index 8, after the stash pointer, and without biases.
template <int MODE>
static int launch_bwd(const int* ia, const unsigned long long* p, float scale,
                      unsigned long long stream) {
  constexpr bool FROM_STASH = MODE == BWD_STASH;
  SdfDims d;
  int rc = sdf_dims_from_args(ia, scale, &d);
  if (rc) return rc;
  const int L = d.L;
  const int pw = FROM_STASH ? 8 : 7;
  long long P = 0;
  int stash_cols = 0;
  for (int l = 0; l < L; ++l) {
    d.wT[l] = (const float*)p[pw + l];
    d.wt[l] = (const float*)p[pw + L + l];
    d.b[l] = FROM_STASH ? nullptr : (const float*)p[pw + 2 * L + l];
    P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
    if (l + 1 < L) stash_cols += d.outs[l];
  }
  const __nv_bfloat16* bstash =
      FROM_STASH ? (const __nv_bfloat16*)p[7] : nullptr;
  const int grid = ia[6];
  const int n_tiles = (d.n + HALF - 1) / HALF;
  const size_t smem = (size_t)(2 * SDF_TILE * SDF_ENC_LD + 2 * SDF_TILE * d.ld) *
                      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      geometry_bwd_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  geometry_bwd_kernel<MODE><<<grid, SDF_THREADS, smem, s>>>(
      d, (const float*)p[0], (const float*)p[1], (const float*)p[2],
      (float*)p[3], (float*)p[4], (float*)p[5], P, n_tiles, bstash,
      stash_cols);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rb = 256;
  reduce_partials_kernel<<<(int)((P + rb - 1) / rb), rb, 0, s>>>(
      (const float*)p[5], grid, P, (float*)p[6]);
  return (int)cudaGetLastError();
}

// Integer arguments: [L, multires, d_embed, ld, skip_mask, n, grid,
// ins[L], outs[L]].  Pointers: [x, ct_out, ct_grad, ct_x, stash, partials,
// grads, wT[L], wt[L], b[L]].  grads receives, per layer, dW as [in][out]
// followed by db [out].  Returns a cudaError_t value.
extern "C" int geometry_bwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  return launch_bwd<BWD_STACKED>(ia, p, scale, stream);
}

// Integer arguments as geometry_bwd.  Pointers: [x, ct_out, ct_grad, ct_x,
// scratch, partials, grads, bf16 stash [n][sum of outs[0..L-2]], wT[L],
// wt[L]]; the scratch holds only the tangent pre-activations.
extern "C" int geometry_bwd_stash(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_bwd<BWD_STASH>(ia, p, scale, stream);
}

// Arguments as geometry_bwd: the same function, the two chains as separate
// half-tile products.
extern "C" int geometry_bwd_split(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_bwd<BWD_SPLIT>(ia, p, scale, stream);
}
