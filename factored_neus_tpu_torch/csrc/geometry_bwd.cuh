// K1-bwd-stash-bf16 and K1-bwd-split-bf16 on bf16 mma.sync: the backward
// of K1-fwd in the bf16 operand mode of pallas_geometry (_mm_fns(bf16=True),
// the JAX step's default), under the switches that reach them; the entry
// points are geometry_bwd_bf16.cu.  Given the cotangents (ct_out, ct_grad)
// of (out, grad), it recomputes the primal forward together with a forward
// tangent along ct_grad, 32 primal + 32 tangent rows of one 64-row tile,
// then reverse-sweeps both chains (reverse over forward: the
// Hessian-vector term of the eikonal loss) -> ct_x and the weight and bias
// gradients summed over all rows.  Every product -- the forward, the
// weight gradients X^T R and the input cotangents R W^T -- takes bf16
// operands (rounded to nearest even, the seeds ct_out / scale and e0 /
// scale included) with an f32 sum, on bf16 mma from pack_weights_bf16's
// pack (tc_mma.cuh); the encoding, softplus and its derivatives, the skip
// and the bias sums stay f32.  K1-bwd-bf16, the stacked call, is
// geometry_bwd_bf16_wg.cu on wgmma; the f32 variants are
// geometry_bwd_chains_wg.cu on wgmma.
//
// Bound: operations, one bf16 product's worth over 989 TFLOP/s of about
// 11.0 S FLOPs per row (S = 524,544 multiply-adds at full width); this
// kernel does 11.5 S (the tangent's last layer as full stacked products).
// Here blocks run in parallel, so each persistent block accumulates the
// weight gradient into its own slice of a partial buffer, tile after tile
// in a fixed order, and a second small kernel sums the slices in a fixed
// order: the result is deterministic.  Each tile adds its 64-row sums to
// the slice with a read-modify-write of the whole slice (2.1 MB at full
// width), ~8.6 GB a call; the stacked pre-activations of one tile go to a
// per-block scratch, written once and read twice.
//
// K1-bwd-stash-bf16 (entry point geometry_bwd_stash_bf16) replaces
// _make_geom.run_bwd_stash with bf16=True (body
// _build_bwd_kernel_from_stash): the primal pre-activations come from the
// bf16 stash that K1-fwd-stash-bf16 wrote, so only the tangent forward is
// recomputed, as a 32-row product over the tangent rows; biases are not
// read.  K1-bwd-split-bf16 (entry point geometry_bwd_split_bf16) replaces
// the same call as K1-bwd-bf16 with stacked=False (body _build_bwd_kernel):
// the primal and tangent chains as separate row sets, each product of the
// stacked sweep two 32-row products, one over each chain's rows; the
// weight gradient sums the primal chain's 32 rows (k-steps 0-3) and the
// tangent chain's (4-7) into the same registers before the one
// read-modify-write of the slice.
#pragma once

#include <cuda_bf16.h>

#include "sdf_mlp.cuh"
#include "tc_mma.cuh"

#define HALF (TC_TILE / 2)

// Column offset of layer l's pre-activations in a stash row.
__device__ __forceinline__ int stash_col(const TcDims& d, int l) {
  int off = 0;
  for (int i = 0; i < l; ++i) off += d.outs[i];
  return off;
}

// The two variants: the stash (primal from the bf16 stash, tangent
// forward only) and the split chains.  The numbers are part of the
// kernels' names, which tools/profile_torch_stage1.py reads.
enum BwdMode { BWD_STASH = 1, BWD_SPLIT = 2 };

// Forward product of layer l into R: both chains' rows (split: one 32-row
// product per chain), or from the stash the tangent rows alone.
template <int MODE>
__device__ __forceinline__ void bwd_forward(const TcDims& d, int l,
                                            const float* xin, int ldx,
                                            float* R, float* ring) {
  const int kp = d.kp[l], off = d.fwd_off[l], S = d.fwd_st[l], np = d.np[l];
  if (MODE == BWD_SPLIT)
    tc_product<1, true>(d, xin, ldx, kp, off, S, np, R, d.ld, ring);
  tc_product<1, true>(d, xin + HALF * ldx, ldx, kp, off, S, np,
                      R + HALF * d.ld, d.ld, ring);
}

// Input cotangents of both chains, A = R W_l (the W block of the pack).
template <int MODE>
__device__ __forceinline__ void bwd_input_cot(const TcDims& d, int l,
                                              const float* R, float* A,
                                              float* ring) {
  const int kp = d.np[l], off = d.rev_off[l], S = d.rev_st[l], np = d.kp[l];
  if (MODE == BWD_SPLIT) {
    tc_product<1, true>(d, R, d.ld, kp, off, S, np, A, d.ld, ring);
    tc_product<1, true>(d, R + HALF * d.ld, d.ld, kp, off, S, np,
                      A + HALF * d.ld, d.ld, ring);
  } else {
    tc_product<2, true>(d, R, d.ld, kp, off, S, np, A, d.ld, ring);
  }
}

template <int MODE>
__global__ void __launch_bounds__(TC_THREADS, 1)
geometry_bwd_kernel(TcDims d, const float* __restrict__ x,
                    const float* __restrict__ ct_out,
                    const float* __restrict__ ct_g, float* ct_x,
                    float* stash_all, float* part_all, long long P,
                    int n_tiles, const __nv_bfloat16* __restrict__ bstash,
                    int stash_cols) {
  constexpr bool FROM_STASH = MODE == BWD_STASH;
  extern __shared__ __align__(16) float smem[];
  const int ld = d.ld, eld = d.eld;
  float* E = smem;                              // [64][eld] enc | denc
  float* RE = E + TC_TILE * eld;                // [64][eld] their cotangents
  float* A = RE + TC_TILE * eld;                // [64][ld] layer input / r_in
  float* R = A + TC_TILE * ld;                  // [64][ld] output cotangent
  float* ring = R + TC_TILE * ld;               // two weight-slice stages
  const size_t stash_layer = (size_t)TC_TILE * ld;
  float* stash = stash_all + (size_t)blockIdx.x * d.L * stash_layer;
  float* part = part_all + (size_t)blockIdx.x * P;
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int tid = threadIdx.x;
  const int lL = d.L - 1;
  const int n_rows = d.n;

  // the products read padding columns, which must be finite
  for (int i = tid; i < TC_TILE * 2 * (eld + ld); i += TC_THREADS)
    smem[i] = 0.f;
  __syncthreads();

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
      encode_row(u, v, d.multires, E + tid * eld, E + (HALF + tid) * eld);
    }
    for (int idx = tid; idx < TC_TILE * eld; idx += TC_THREADS) RE[idx] = 0.f;
    __syncthreads();

    // stacked forward: primal rows take the bias and softplus, tangent rows
    // the chain rule sigma(100 a) * ad; pre-activations go to the scratch.
    // From the stash only the tangent rows are computed.
    for (int l = 0; l < lL; ++l) {
      const int N = d.outs[l];
      bwd_forward<MODE>(d, l, l == 0 ? E : A, l == 0 ? eld : ld, R,
                            ring);
      __syncthreads();
      const bool skip_next = (d.skip_mask >> (l + 1)) & 1;
      const float post = skip_next ? inv_sqrt2 : 1.f;
      const int so = FROM_STASH ? stash_col(d, l) : 0;
      float* st = stash + l * stash_layer;
      for (int idx = tid; idx < HALF * N; idx += TC_THREADS) {
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
        for (int idx = tid; idx < TC_TILE * d.d_embed; idx += TC_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          A[r * ld + N + c] = E[r * eld + c] * inv_sqrt2;
        }
      __syncthreads();
    }

    // seed: cotangent of the last layer's output
    {
      const int N = d.outs[lL];
      for (int idx = tid; idx < HALF * N; idx += TC_THREADS) {
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
        tc_rows_for<8>(
            HALF, W, [&](int r, int c) { return primal(l - 1, so, r, c); },
            [&](int r, int c) { return st[(HALF + r) * ld + c]; },
            [&](int r, int c, float a, float ad) {
              A[r * ld + c] = sp100(a) * post;
              A[(HALF + r) * ld + c] = sig100(a) * ad * post;
            });
        if (skip)
          for (int idx = tid; idx < TC_TILE * d.d_embed; idx += TC_THREADS) {
            const int r = idx / d.d_embed, c = idx - r * d.d_embed;
            A[r * ld + W + c] = E[r * eld + c] * inv_sqrt2;
          }
        __syncthreads();
      }

      // weight gradient [in][out] over both halves; bias over primal rows
      tc_weight_grad<true>(l == 0 ? E : A, l == 0 ? eld : ld, K, R, ld, N,
                         part + off, first, ring);
      float* pb = part + off + (long long)K * N;
      for (int c = tid; c < N; c += TC_THREADS) {
        float s = 0.f;
        for (int r = 0; r < HALF; ++r) s += R[r * ld + c];
        pb[c] = first ? s : pb[c] + s;
      }
      __syncthreads();

      // input cotangents of both chains: A = R @ W^T
      bwd_input_cot<MODE>(d, l, R, A, ring);
      __syncthreads();
      if (skip) {
        const int hw = K - d.d_embed;
        for (int idx = tid; idx < TC_TILE * K; idx += TC_THREADS) {
          const int r = idx / K, k = idx - r * K;
          const float v = A[r * ld + k] * inv_sqrt2;
          if (k >= hw) RE[r * eld + k - hw] += v;
          else A[r * ld + k] = v;
        }
        __syncthreads();
      }
      if (l == 0) {
        for (int idx = tid; idx < TC_TILE * d.d_embed; idx += TC_THREADS) {
          const int r = idx / d.d_embed, c = idx - r * d.d_embed;
          RE[r * eld + c] += A[r * ld + c];
        }
      } else {
        // h = sp(a): dh/da = s; hd = s ad: d(hd)/da = 100 s (1 - s) ad,
        // d(hd)/d(ad) = s
        const int W = d.outs[l - 1];
        const int so = FROM_STASH ? stash_col(d, l - 1) : 0;
        const float* st = stash + (l - 1) * stash_layer;
        tc_rows_for<8>(
            HALF, W, [&](int r, int k) { return primal(l - 1, so, r, k); },
            [&](int r, int k) { return st[(HALF + r) * ld + k]; },
            [&](int r, int k, float a, float ad) {
              const float s = sig100(a);
              const float ds = 100.f * s * (1.f - s);
              const float rh = A[r * ld + k];
              const float rdh = A[(HALF + r) * ld + k];
              R[r * ld + k] = rh * s + rdh * ds * ad;
              R[(HALF + r) * ld + k] = rdh * s;
            });
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
        encode_backward_row(u, v, d.multires, RE + tid * eld,
                            RE + (HALF + tid) * eld, ct);
        for (int c = 0; c < 3; ++c) ct_x[row * 3 + c] = ct[c] * d.scale;
      }
    }
    __syncthreads();
  }
}

// Pointers: [x, ct_out, ct_grad, ct_x, scratch, partials, grads, then
// (bf16 stash,) pack, b[L]]; from the stash without biases.
template <int MODE>
static int launch_bwd(const int* ia, const unsigned long long* p, float scale,
                      unsigned long long stream) {
  constexpr bool FROM_STASH = MODE == BWD_STASH;
  const int pw = FROM_STASH ? 8 : 7;
  TcDims d;
  int rc = tc_dims_from_args(ia, scale, (const float*)p[pw], &d, true);
  if (rc) return rc;
  long long P = 0;
  int stash_cols = 0;
  for (int l = 0; l < d.L; ++l) {
    d.b[l] = FROM_STASH ? nullptr : (const float*)p[pw + 1 + l];
    P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
    if (l + 1 < d.L) stash_cols += d.outs[l];
  }
  const __nv_bfloat16* bstash =
      FROM_STASH ? (const __nv_bfloat16*)p[7] : nullptr;
  const int grid = ia[6];
  const int n_tiles = (d.n + HALF - 1) / HALF;
  const size_t smem = tc_smem_bytes(d, (size_t)TC_TILE * 2 * (d.eld + d.ld));
  if (!smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      geometry_bwd_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  geometry_bwd_kernel<MODE><<<grid, TC_THREADS, smem, s>>>(
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
