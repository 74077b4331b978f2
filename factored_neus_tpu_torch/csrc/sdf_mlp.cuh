// Shared device code of the SDF-MLP kernels (geometry forward/backward and
// the forward-only sweep): the layer description, the positional encoding,
// softplus(beta=100) and the two register-tiled f32 products every layer
// runs on a 64-row tile held in shared memory.
//
// Design (Hopper, f32 CUDA cores): the full-width SDF MLP has ~2.1 MB of f32
// weights, far above the 227 KB of shared memory a block may use, so weights
// are never staged: every product streams its weight rows from L2/L1 with
// __ldg while the 64-row activation tile stays in shared memory.  A block
// of 256 threads (8 warps) computes a [64 x N] product; warp w owns rows
// 8w..8w+7 and lane t owns columns t, t+32, ... (TN = ceil(N/32) of them),
// so every shared-memory activation read is a warp-wide broadcast and every
// weight read is a coalesced 128-byte row segment.  Ragged widths (217, 257,
// 39) are masked per column; nothing is padded in memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SDF_MAXL 16          // most layers a network may have
#define SDF_TILE 64          // rows of one product tile (8 warps x 8 rows)
#define SDF_THREADS 256
#define SDF_ENC_LD 64        // shared-memory width of the encoding buffers
#define SDF_MAXW 288         // widest layer the column tiling covers (9 x 32)

struct SdfDims {
  int L;                     // number of linear layers
  int multires;              // octaves of the positional encoding
  int d_embed;               // 3 * (1 + 2 * multires)
  int ld;                    // shared-memory row stride (>= every width)
  int skip_mask;             // bit l set: layer l reads [h | enc] / sqrt(2)
  int n;                     // rows of the call
  float scale;               // SDFNetwork.scale
  int ins[SDF_MAXL];
  int outs[SDF_MAXL];
  const float* wT[SDF_MAXL];  // [in][out] row-major effective weights
  const float* wt[SDF_MAXL];  // [out][in] row-major (torch layout)
  const float* b[SDF_MAXL];   // [out]
};

// Unpacks the launcher's integer and pointer arrays (layout documented in
// ops/_cuda.py) into SdfDims.  Returns 0, or cudaErrorInvalidValue for a
// network this code cannot run.
static inline int sdf_dims_from_args(const int* ia, float scale,
                                     SdfDims* d) {
  d->L = ia[0];
  d->multires = ia[1];
  d->d_embed = ia[2];
  d->ld = ia[3];
  d->skip_mask = ia[4];
  d->n = ia[5];
  d->scale = scale;
  if (d->L < 1 || d->L > SDF_MAXL || d->d_embed > SDF_ENC_LD ||
      d->d_embed != 3 * (1 + 2 * d->multires) || (d->skip_mask & 1))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < d->L; ++l) {
    d->ins[l] = ia[7 + l];
    d->outs[l] = ia[7 + d->L + l];
    if (d->ins[l] > d->ld || d->outs[l] > d->ld || d->outs[l] > SDF_MAXW ||
        d->ins[l] > SDF_MAXW)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

__device__ __forceinline__ float sp100(float a) {
  // softplus(beta=100) = logaddexp(0, 100 a) / 100, stable for every a
  const float z = 100.f * a;
  return (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) * 0.01f;
}

__device__ __forceinline__ float sig100(float a) {
  return 1.f / (1.f + expf(-100.f * a));
}

// Positional encoding of one row: [u, sin(f0 u), cos(f0 u), sin(f1 u), ...]
// with f_i = 2^i; with v != nullptr also the tangent of the encoding along v.
__device__ __forceinline__ void encode_row(const float u[3], const float* v,
                                           int multires, float* enc,
                                           float* denc) {
  for (int c = 0; c < 3; ++c) {
    enc[c] = u[c];
    if (denc) denc[c] = v[c];
  }
  float f = 1.f;
  for (int i = 0; i < multires; ++i) {
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(f * u[c], &s, &co);
      enc[3 + 6 * i + c] = s;
      enc[6 + 6 * i + c] = co;
      if (denc) {
        denc[3 + 6 * i + c] = co * (f * v[c]);
        denc[6 + 6 * i + c] = -s * (f * v[c]);
      }
    }
    f *= 2.f;
  }
}

// Cotangent of u from the cotangents of the encoding (r) and, when rd is
// given, of its tangent along v (the second-order term of the eikonal
// backward).  Mirrors pallas_geometry.pe_backward.
__device__ __forceinline__ void encode_backward_row(const float u[3],
                                                    const float* v,
                                                    int multires,
                                                    const float* r,
                                                    const float* rd,
                                                    float ct[3]) {
  for (int c = 0; c < 3; ++c) ct[c] = r[c];
  float f = 1.f;
  for (int i = 0; i < multires; ++i) {
    for (int c = 0; c < 3; ++c) {
      float s, co;
      sincosf(f * u[c], &s, &co);
      ct[c] += f * (r[3 + 6 * i + c] * co - r[6 + 6 * i + c] * s);
      if (rd)
        ct[c] -= f * f * v[c] *
                 (rd[3 + 6 * i + c] * s + rd[6 + 6 * i + c] * co);
    }
    f *= 2.f;
  }
}

// Y[64][N] = X[64][K] @ B[K][N]; X, Y in shared memory (strides ldx, ldy),
// B in global memory, row-major with stride ldb.  Columns >= N are neither
// read nor written.
template <int TN>
__device__ __forceinline__ void tile_mm(const float* X, int ldx, int K,
                                        const float* __restrict__ B, int ldb,
                                        int N, float* Y, int ldy) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const float* xr = X + (ty * 8) * ldx;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 32 * j;
      bv[j] = n < N ? __ldg(B + (size_t)k * ldb + n) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float a = xr[i * ldx + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tx + 32 * j;
      if (n < N) Y[(ty * 8 + i) * ldy + n] = acc[i][j];
    }
}

// C[M][N] (+)= A[64][M]^T @ Bm[64][N] summed over the tile's 64 rows; A and
// Bm in shared memory, C in global memory (stride N).  first: store instead
// of accumulate.  Used for the weight gradient of one layer.
template <int TN>
__device__ __forceinline__ void tile_atb(const float* A, int lda, int M,
                                         const float* Bm, int ldb, int N,
                                         float* C, bool first) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int m0 = 0; m0 < M; m0 += 64) {
    float acc[8][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    const int mb = m0 + ty * 8;
#pragma unroll 2
    for (int r = 0; r < SDF_TILE; ++r) {
      float bv[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tx + 32 * j;
        bv[j] = n < N ? Bm[r * ldb + n] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = mb + i;
        const float a = m < M ? A[r * lda + m] : 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = mb + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tx + 32 * j;
        if (n < N) {
          float* c = C + (size_t)m * N + n;
          *c = first ? acc[i][j] : *c + acc[i][j];
        }
      }
    }
  }
}

// Runtime dispatch on the number of 32-column groups a width needs.
#define SDF_TN_DISPATCH(N, CALL)                  \
  switch (((N) + 31) / 32) {                      \
    case 1: { constexpr int TN = 1; CALL; } break; \
    case 2: { constexpr int TN = 2; CALL; } break; \
    case 3: { constexpr int TN = 3; CALL; } break; \
    case 4: { constexpr int TN = 4; CALL; } break; \
    case 5: { constexpr int TN = 5; CALL; } break; \
    case 6: { constexpr int TN = 6; CALL; } break; \
    case 7: { constexpr int TN = 7; CALL; } break; \
    case 8: { constexpr int TN = 8; CALL; } break; \
    default: { constexpr int TN = 9; CALL; } break; \
  }

// Forward over one 64-row tile.  On entry E holds the encoding (columns
// [0, d_embed)) of the tile's rows.  Runs layers 0..L-2 through softplus,
// leaving the last layer's INPUT in X (stride d.ld), and writes each hidden
// pre-activation a_l to stash[l] (stride d.ld) when stash is given.  The
// tile rows are independent; bias is added to every row.
__device__ __forceinline__ void forward_hidden(const SdfDims& d,
                                               const float* E, float* X,
                                               float* Y, float* stash,
                                               size_t stash_layer) {
  const int ld = d.ld;
  const float inv_sqrt2 = 0.70710678118654752f;
  for (int l = 0; l + 1 < d.L; ++l) {
    const float* xin = (l == 0) ? E : X;
    const int ldx = (l == 0) ? SDF_ENC_LD : ld;
    const int K = d.ins[l], N = d.outs[l];
    SDF_TN_DISPATCH(N, tile_mm<TN>(xin, ldx, K, d.wT[l], N, N, Y, ld));
    __syncthreads();
    const bool skip_next = (d.skip_mask >> (l + 1)) & 1;
    const float post = skip_next ? inv_sqrt2 : 1.f;
    const float* bias = d.b[l];
    for (int idx = threadIdx.x; idx < SDF_TILE * N; idx += SDF_THREADS) {
      const int r = idx / N, c = idx - r * N;
      const float a = Y[r * ld + c] + __ldg(bias + c);
      if (stash) stash[l * stash_layer + r * ld + c] = a;
      X[r * ld + c] = sp100(a) * post;
    }
    if (skip_next)
      for (int idx = threadIdx.x; idx < SDF_TILE * d.d_embed;
           idx += SDF_THREADS) {
        const int r = idx / d.d_embed, c = idx - r * d.d_embed;
        X[r * ld + N + c] = E[r * SDF_ENC_LD + c] * inv_sqrt2;
      }
    __syncthreads();
  }
}
