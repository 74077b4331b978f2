// Tensor-core product engine of the last mma.sync kernels, the
// switch-only K1-fwd-stash and K1-fwd-stash-bf16 (geometry_fwd.cu): the
// products an MLP kernel runs on a 64-row tile held in shared memory, in
// f32 accuracy through 3xTF32 on mma.sync (or on bf16 operands), with the
// weights staged into shared memory by cp.async.
//
//   tc_mm   Y = X B          forward (B = W^T block) and input cotangents
//                            (B = W block): X, Y in shared memory
//
// 3xTF32.  Each operand a is split into big = a rounded to TF32 (10-bit
// mantissa, to nearest, ties away: (bits + 0x1000) & ~0x1fff) and
// small = a - big (exact in f32); a b is taken as small_a big_b +
// big_a small_b + big_a big_b.  The card's m16n8k8 TF32 mma (measured by
// tools/tf32_mma_probe.py) reads an f32 operand by dropping its 13 low
// mantissa bits, sums one instruction's 8 products exactly, and adds them to
// the f32 accumulator rounding toward zero.  That last truncation, repeated
// over ~100 mma instructions of a 264-deep product, is biased and would
// cost the forward ~1.5e-5 of absolute error at full width, above K1-fwd's
// 1e-5 tolerance; so each ring stage (16 k) sums into fresh accumulators and
// is added to the running sum with a rounded f32 add.  The weights come
// pre-split from the packer
// (ops/tc_pack.pack_weights): big and small halves of one buffer, so
// the kernel splits only activations, as it loads their fragments.  That
// doubles the weight bytes staged, but they come from L2 (the SDF's 8.7 MB
// pack fits in its 50 MB) under the products,
// while a split in the kernel would be redone by every warp that reads a
// weight fragment, for every tile.
//
// Layout.  A block of 384 threads (12 warps) owns a 64-row tile: one block
// per SM, as the tiles and the ring fill shared memory, and 12 warps rather
// than 8 to hide the latency of the elementwise passes between products
// (16 cap a thread at 128 registers, and the products' accumulators spill
// kilobytes; 12 leave 168, with a few hundred bytes of spills in two of
// K1-bwd's three modes).  In tc_mm warp w takes rows 32 (w / CG) .. +31
// (two m16 tiles) and the n8 column tiles w % CG, w % CG + CG, ... (CG = 6
// column groups over 64 rows, 12 over a 32-row product), NTW of them at
// most.
// Activation rows have a stride ld = 4 (mod 8), so an A fragment (8 rows x
// 4 k) hits 32 banks; a staged weight row has a stride S = 8 (mod 32), so a
// B fragment (4 k x 8 n) does too.  Weight rows of one layer are copied in
// slices of 16 rows through a two-stage ring: slice s + 1 is in flight
// while slice s is multiplied.
//
// bf16 operands (BF = true; K1's bf16 mode, the JAX package's
// _mm_fns(bf16=True)).  Both operands of every product are rounded to bf16
// to nearest even (JAX's astype) and multiplied on m16n8k16 bf16 mma with
// an f32 sum: a bf16 x bf16 product is exact in f32.  The weights come
// rounded from the packer (ops/tc_pack.pack_weights_bf16), one half, two
// k-rows to a 32-bit word; activations are converted as their fragments
// load (__floats2bfloat162_rn, never the TF32 split, which rounds ties
// away).  A ring stage of TC_KS = 16 weight rows is one k16 step: 8 word
// rows.  Within a stage the k index is permuted: thread t's A pairs are
// columns (t, t + 4) and (t + 8, t + 12), and the packer pairs the same
// weight rows into the words of its B fragment (tc_pack.bf16_pair_rows),
// so the A fragment reads the same four floats a row as two TF32 k-steps
// and the B fragment whole words, both conflict-free at the strides above
// (ld = 4 mod 8, S = 8 mod 32 words).  tools/tf32_mma_probe.py also reads how the bf16 mma sums; each stage
// still sums into fresh accumulators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TC_TILE 64            // rows of a tile
#define TC_WARPS 12
#define TC_THREADS (32 * TC_WARPS)
#define TC_KS 16              // weight rows per ring stage
#define TC_MAXL 16            // most layers a network may have
#define TC_MAX_ENC 64         // widest positional encoding
#define TC_MAXW 288           // widest product: 6 n8 tiles of 6 column groups
#define TC_SMEM_MAX 232448    // shared memory a block may use

struct TcDims {
  int L;                      // number of linear layers
  int multires;               // octaves of the positional encoding
  int d_embed;                // 3 * (1 + 2 * multires)
  int ld;                     // activation row stride (= 4 mod 8)
  int eld;                    // encoding row stride (= 4 mod 8)
  int skip_mask;              // bit l set: layer l reads [h | enc] / sqrt(2)
  int n;                      // rows of the call
  float scale;                // SDFNetwork.scale
  int ins[TC_MAXL], outs[TC_MAXL];
  int kp[TC_MAXL], np[TC_MAXL];          // ins, outs rounded up to 8
  int fwd_off[TC_MAXL], fwd_st[TC_MAXL];  // W^T block [kp][fwd_st]
  int rev_off[TC_MAXL], rev_st[TC_MAXL];  // W block [np][rev_st]
  long long H;                // floats of one half (big or small) of the pack
  int stage;                  // floats of one ring stage (big + small)
  int ring;                   // floats of the ring (>= 2 stages)
  const float* pack;          // [big | small] of every block
  const float* b[TC_MAXL];    // biases [out]
};

__host__ __device__ inline int tc_round8(int w) { return (w + 7) / 8 * 8; }

// Shared-memory row stride of a 64-row chunk of width N: >= N + 3 and 4
// (mod 32).  The ring keeps room for one (tc_pack.smem_bytes counts it),
// the size the mma.sync backward's weight-gradient chunk needed.
__host__ __device__ inline int tc_chunk_stride(int N) {
  const int sp = N + 3;
  return sp + (36 - sp % 32) % 32;
}

// Reads the layers of the integer arguments [L, multires, d_embed, ld,
// skip_mask, n, grid, ins[L], outs[L], fwd_off[L], fwd_st[L], rev_off[L],
// rev_st[L], H] (the layout of ops/tc_pack.layout_iargs) into d (d->L and
// d->ld set), checks them against the row stride ld, and sizes the ring
// for the pack's operand type (bf16: two k-rows a word, one half).  A
// layer's input (the depth of its forward product, the width of its input
// cotangent) may be max_kp wide; its output at most TC_MAXW.  Returns 0,
// or cudaErrorInvalidValue for a layout this code cannot run.
static inline int tc_layers_from_args(const int* ia, int max_kp, TcDims* d,
                                      bool bf16 = false) {
  const int L = d->L;
  int widest = 0, chunk = 0;
  for (int l = 0; l < L; ++l) {
    d->ins[l] = ia[7 + l];
    d->outs[l] = ia[7 + L + l];
    d->kp[l] = tc_round8(d->ins[l]);
    d->np[l] = tc_round8(d->outs[l]);
    d->fwd_off[l] = ia[7 + 2 * L + l];
    d->fwd_st[l] = ia[7 + 3 * L + l];
    d->rev_off[l] = ia[7 + 4 * L + l];
    d->rev_st[l] = ia[7 + 5 * L + l];
    if (d->kp[l] > d->ld || d->np[l] > d->ld || d->kp[l] > max_kp ||
        d->np[l] > TC_MAXW || d->fwd_st[l] < d->np[l] ||
        d->rev_st[l] < d->kp[l] || (d->fwd_st[l] | d->rev_st[l] |
                                    d->fwd_off[l] | d->rev_off[l]) % 8)
      return (int)cudaErrorInvalidValue;
    widest = widest > d->fwd_st[l] ? widest : d->fwd_st[l];
    widest = widest > d->rev_st[l] ? widest : d->rev_st[l];
    const int c = TC_TILE * tc_chunk_stride(d->outs[l]) + 3;
    chunk = chunk > c ? chunk : c;
  }
  d->H = ia[7 + 6 * L];
  if (d->H % 8) return (int)cudaErrorInvalidValue;
  // the ring: two stages of TC_KS weight rows (big and small, or bf16
  // pairs), at least a 64-row chunk (tc_chunk_stride)
  d->stage = (bf16 ? TC_KS / 2 : 2 * TC_KS) * widest;
  d->ring = ((2 * d->stage > chunk ? 2 * d->stage : chunk) + 3) / 4 * 4;
  return 0;
}

// The SDF network's arguments (K1's mma.sync kernels): tc_layers_from_args'
// layout with skip_mask; bf16: the pack is pack_weights_bf16's.  Returns 0,
// or cudaErrorInvalidValue for a network or layout this code cannot run.
static inline int tc_dims_from_args(const int* ia, float scale,
                                    const float* pack, TcDims* d,
                                    bool bf16 = false) {
  const int L = ia[0];
  d->L = L;
  d->multires = ia[1];
  d->d_embed = ia[2];
  d->ld = ia[3];
  d->skip_mask = ia[4];
  d->n = ia[5];
  d->scale = scale;
  d->pack = pack;
  if (L < 1 || L > TC_MAXL || d->d_embed > TC_MAX_ENC ||
      d->d_embed != 3 * (1 + 2 * d->multires) || (d->skip_mask & 1) ||
      d->ld % 8 != 4)
    return (int)cudaErrorInvalidValue;
  d->eld = tc_round8(d->d_embed) + 4;
  return tc_layers_from_args(ia, TC_MAXW, d, bf16);
}

// Bytes of shared memory a kernel with fixed_floats of its own and the
// ring needs, or 0 when that is more than a block may use.
static inline size_t tc_smem_bytes(const TcDims& d, size_t fixed_floats) {
  const size_t bytes = (fixed_floats + d.ring) * sizeof(float);
  return bytes <= TC_SMEM_MAX ? bytes : 0;
}

// Runtime dispatch on the n8 column tiles each warp owns at most (NTW, from
// tc_ntw: RG 32-row groups over the block's warps; at most 6 for widths up
// to TC_MAXW).
#define TC_NTW_DISPATCH(NTW_VAL, CALL)             \
  switch (NTW_VAL) {                               \
    case 1: { constexpr int NTW = 1; CALL; } break; \
    case 2: { constexpr int NTW = 2; CALL; } break; \
    case 3: { constexpr int NTW = 3; CALL; } break; \
    case 4: { constexpr int NTW = 4; CALL; } break; \
    case 5: { constexpr int NTW = 5; CALL; } break; \
    default: { constexpr int NTW = 6; CALL; } break; \
  }

__device__ __forceinline__ int tc_ntw(int np, int rg) {
  const int cg = TC_WARPS / rg;
  return ((np >> 3) + cg - 1) / cg;
}

// big = x rounded to TF32 (to nearest, ties away), small = x - big.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats as a bf16x2 operand word, each rounded to nearest even; lo
// in the low half (the lower k index of the fragment's pair).
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma3(float c[4], const uint32_t ab[4],
                                     const uint32_t as[4], const uint32_t bb[2],
                                     const uint32_t bs[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Y[32 RG][np] = X[32 RG][kp] @ B[kp][np], B the pack's block at off (row
// stride S; its small half H floats further on; bf16: rows paired into
// words, tc_pack.bf16_pair_rows).  X and Y are shared memory (strides
// ldx, ldy); columns [kp, ...) of X are not read and columns [np, ...) of
// Y are not written.  Every thread of the block calls it; on return Y is
// written by each thread's own part, and other warps may still read the
// last slice: the caller syncs before it reads Y or uses the ring
// otherwise (another tc_mm syncs first).
template <int NTW, int RG, bool BF>
__device__ __forceinline__ void tc_mm(const TcDims& d, const float* X,
                                      int ldx, int kp, int off, int S,
                                      int np, float* Y, int ldy,
                                      float* ring) {
  constexpr int CG = TC_WARPS / RG;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / CG, wc = warp % CG;
  constexpr int ks = TC_KS;
  const int nt = np >> 3;
  const int nst = (kp + ks - 1) / ks;
  const float* src = d.pack + off;

  // bf16: a stage is ks / 2 word rows, all in the pack (its blocks are
  // padded to 16 rows); 3xTF32: up to ks rows of each half
  auto load = [&](int s) {
    float* dst = ring + (s & 1) * d.stage;
    const int k0 = s * ks;
    if (BF) {
      const int n4 = (ks / 2) * S / 4;
      const float* gb = src + (size_t)(k0 / 2) * S;
      for (int i = tid; i < n4; i += TC_THREADS)
        cp_async16(dst + 4 * i, gb + 4 * i);
    } else {
      const int rows = min(ks, kp - k0);
      const int n4 = rows * S / 4;               // 16-byte pieces per half
      const float* gb = src + (size_t)k0 * S;
      for (int i = tid; i < 2 * n4; i += TC_THREADS) {
        const int h = i >= n4, c = 4 * (i - h * n4);
        cp_async16(dst + h * ks * S + c, gb + h * d.H + c);
      }
    }
    cp_async_commit();
  };

  float acc[2][NTW][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NTW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][i][e] = 0.f;

  const float* xa = X + (32 * wr + g) * ldx + t;
  __syncthreads();                  // every warp is done with the ring
  load(0);
  for (int s = 0; s < nst; ++s) {
    // slice s has landed for every thread, and every warp is done with
    // slice s - 1, whose stage slice s + 1 then takes
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < nst) load(s + 1);
    const float* st = ring + (s & 1) * d.stage;
    const int k0 = s * ks, rows = min(ks, kp - k0);
    float part[2][NTW][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[m][i][e] = 0.f;
    if (BF) {
      // one k16 step: A pairs (t, t + 4), (t + 8, t + 12) of each row;
      // the upper eight k are zero where the stage holds only eight rows
      const bool full = rows > 8;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* xr = xa + 16 * m * ldx + k0;
        a[m][0] = bf16_pair(xr[0], xr[4]);
        a[m][1] = bf16_pair(xr[8 * ldx], xr[8 * ldx + 4]);
        a[m][2] = full ? bf16_pair(xr[8], xr[12]) : 0u;
        a[m][3] = full ? bf16_pair(xr[8 * ldx + 8], xr[8 * ldx + 12]) : 0u;
      }
      const uint32_t* br = (const uint32_t*)st + t * S + g;
#pragma unroll
      for (int i = 0; i < NTW; ++i) {
        const int j = wc + CG * i;
        if (j < nt) {
          const uint32_t b[2] = {br[8 * j], br[4 * S + 8 * j]};
          mma_bf16(part[0][i], a[0], b);
          mma_bf16(part[1][i], a[1], b);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (8 * q >= rows) break;
        uint32_t ab[2][4], as[2][4];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const float* xr = xa + 16 * m * ldx + k0 + 8 * q;
          tf32_split(xr[0], ab[m][0], as[m][0]);
          tf32_split(xr[8 * ldx], ab[m][1], as[m][1]);
          tf32_split(xr[4], ab[m][2], as[m][2]);
          tf32_split(xr[8 * ldx + 4], ab[m][3], as[m][3]);
        }
        const float* br = st + (8 * q + t) * S + g;
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
          const int j = wc + CG * i;
          if (j < nt) {
            const float* bj = br + 8 * j;
            const uint32_t bb[2] = {__float_as_uint(bj[0]),
                                    __float_as_uint(bj[4 * S])};
            const uint32_t bs[2] = {__float_as_uint(bj[ks * S]),
                                    __float_as_uint(bj[ks * S + 4 * S])};
            mma3(part[0][i], ab[0], as[0], bb, bs);
            mma3(part[1][i], ab[1], as[1], bb, bs);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int i = 0; i < NTW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][i][e] += part[m][i][e];
  }

#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float* yr = Y + (32 * wr + 16 * m + g) * ldy + 2 * t;
#pragma unroll
    for (int i = 0; i < NTW; ++i) {
      const int j = wc + CG * i;
      if (j < nt) {
        *(float2*)(yr + 8 * j) = make_float2(acc[m][i][0], acc[m][i][1]);
        *(float2*)(yr + 8 * ldy + 8 * j) =
            make_float2(acc[m][i][2], acc[m][i][3]);
      }
    }
  }
}

// Y = X @ B over RG 32-row groups, dispatched on the warp's column tiles;
// BF: on bf16 operands from a bf16 pack.
template <int RG, bool BF = false>
__device__ __forceinline__ void tc_product(const TcDims& d, const float* X,
                                           int ldx, int kp, int off, int S,
                                           int np, float* Y, int ldy,
                                           float* ring) {
  TC_NTW_DISPATCH(tc_ntw(np, RG), (tc_mm<NTW, RG, BF>(d, X, ldx, kp, off, S,
                                                      np, Y, ldy, ring)));
}

// fn(r, c, v0, v1) for every (r, c) of a rows x W block of a tile, with
// v0 = ld0(r, c) and v1 = ld1(r, c) loaded for U elements of a thread
// before any of them is used: the loads (from the pre-activation scratch
// in device memory) are in flight together instead of one at a time.
template <int U, class L0, class L1, class F>
__device__ __forceinline__ void tc_rows_for(int rows, int W, L0 ld0, L1 ld1,
                                            F fn) {
  const int n = rows * W;
  for (int i0 = threadIdx.x; i0 < n; i0 += U * TC_THREADS) {
    float v0[U], v1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * TC_THREADS;
      if (idx < n) {
        const int r = idx / W, c = idx - r * W;
        v0[u] = ld0(r, c);
        v1[u] = ld1(r, c);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = i0 + u * TC_THREADS;
      if (idx < n) {
        const int r = idx / W, c = idx - r * W;
        fn(r, c, v0[u], v1[u]);
      }
    }
  }
}
