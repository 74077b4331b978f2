// The f32 warpgroup engine (3xTF32 on wgmma) that five kernels share:
// K1-bwd (geometry_bwd_wg.cu), K1-fwd (geometry_fwd_wg.cu), K2
// (sdf_fwd_wg.cu), K3-fwd (radiance_fwd_wg.cu) and K3-bwd
// (radiance_bwd_wg.cu).
//
//   the sweep's pieces  a 64-row f32 A tile in shared memory, K-major and
//                 128-byte swizzled (at_byte), each layer's k permuted by
//                 tc_pack.tf32_slot (at_put, at_store); weights streamed as
//                 32-k slabs of TF32 big and small halves into a ring of
//                 FW_NS stages by one producer thread (fw_put); a layer's
//                 product, a consumer warpgroup's N columns, as 3xTF32
//                 k-steps into a fresh accumulator a slab, added to the
//                 running sum with rounded adds (fw_slab, fw_layer; a last
//                 k-step from registers, fw_slab_regs; an SDF network's
//                 257-wide last layer, fw_last_layer); the f32 tile images
//                 of X_l and R_l (img_at, img_store); the transposing
//                 shuffle that sums a warp's rows (fw_db_reduce)
//   the pass      dW_l = X_l^T R_l over the images, split over K
//                 (wgf_wgrad_body): units of (layer, 128-column X pair,
//                 R half) x chunks of tiles
//   the reduce    dW the sum of the chunks' slots, db of the warps' slots,
//                 each in a fixed order (wgf_reduce_body)
//   the plan      the host's units, ring and reduce arguments of the pass
//                 (wgf_plan_pass)
//
// The arithmetic.  wgmma reads an f32 operand by dropping its 13 low
// mantissa bits (tools/tf32_mma_probe.py): that truncation is big_x, read
// from the tile itself; small_x = x - big_x, exact in f32, is made in
// registers a slab at a time and given as the register A of small_x big_w.
// The weights come pre-split (tc_pack.pack_sweep_f32, pack_rev_f32,
// pack_rad_sweep_f32, pack_rad_rev_f32: big = W rounded to TF32, small =
// W - big).  A k-step is three products, small_x big_w + big_x small_w +
// big_x big_w.  The accumulator rounds toward zero, so each slab's
// products go to a fresh accumulator and are added to the running sum
// with rounded f32 adds (the pass: each 32-row stage the same way).
#pragma once

#include "wg_bwd.cuh"

#define FW_STAGE 65536     // bytes of a ring stage: a 256-column slab pair
#define FW_NS 2            // ring stages
#define FW_KB 8192         // bytes of a 32-k block of the 64-row A tile
#define FW_SN 136          // columns of a weight-gradient slot row
#define FW_MAXU 64         // most weight-gradient units

// softplus(beta=100) and sigma(100 a) from one exp: with z = 100 a and
// e = exp(-|z|), sp = (max(z, 0) + log1p(e)) / 100 (sdf_mlp.cuh's sp100)
// and sigma = 1 / (1 + e) for z >= 0, e / (1 + e) below
__device__ __forceinline__ void sp_sig100(float a, float& sp, float& s) {
  const float z = 100.f * a;
  const float e = expf(-fabsf(z));
  sp = (fmaxf(z, 0.f) + log1pf(e)) * 0.01f;
  const float r = 1.f / (1.f + e);
  s = z >= 0.f ? r : e * r;
}

// small = x - (x with its 13 low mantissa bits dropped): what 3xTF32 adds
// to the big half the tensor core reads of an f32 operand
__device__ __forceinline__ float tf32_small(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ uint32_t small_bits(float x) {
  return __float_as_uint(tf32_small(x));
}

// Byte of (row r, k slot k) in the A tile: 32-k blocks of 64 rows x 128
// bytes, 16-byte chunks swizzled by the row (wgmma.cuh).
__device__ __forceinline__ int at_byte(int r, int k) {
  return (k >> 5) * FW_KB + r * 128 + ((((k & 31) >> 2) ^ (r & 7)) << 4) +
         ((k & 3) << 2);
}

// Float offset of (row r, column c) in a tile image of C columns: per
// 32-row block, its columns one after another, a column's 32 rows one
// 128-byte row swizzled by the column.
__device__ __forceinline__ int img_at(int r, int c, int C) {
  return (r >> 5) * (C * 32) + c * 32 + ((((r & 31) >> 2) ^ (c & 7)) << 2) +
         (r & 3);
}

// -- the sweep ---------------------------------------------------------------

// slab it (bytes from src) into ring stage it % FW_NS (STAGE bytes each)
// once the consumers released it
template <int STAGE = FW_STAGE>
__device__ __forceinline__ void fw_put(unsigned char* ring, uint64_t* full,
                                       uint64_t* empty, int it,
                                       const unsigned char* src, int bytes) {
  const int st = it % FW_NS;
  mbar_wait(empty + st, ((it / FW_NS) & 1) ^ 1);
  mbar_expect_tx(full + st, bytes);
  bulk_g2s(ring + st * STAGE, src, bytes, full + st);
}

// A sweep product's k-step: m64n128 (a hidden layer's half), m64n24 (half
// of a 48-column product) or m64n8 (a last layer of at most 8 outputs)
template <int N>
__device__ __forceinline__ void tf32_mma(float (&acc)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int keep) {
  if constexpr (N == 128) wgmma_tf32_n128(acc, a, b, keep);
  else if constexpr (N == 24) wgmma_tf32_n24(acc, a, b, keep);
  else wgmma_tf32_n8(acc, a, b, keep);
}

template <int N>
__device__ __forceinline__ void tf32_mma_ss(float (&acc)[N / 2], uint64_t a,
                                            uint64_t b, int keep) {
  if constexpr (N == 128) wgmma_tf32_ss_n128(acc, a, b, keep);
  else if constexpr (N == 24) wgmma_tf32_ss_n24(acc, a, b, keep);
  else wgmma_tf32_ss_n8(acc, a, b, keep);
}

// One slab of a layer's product into the running sum run: its NK k-steps
// (A tile k-steps kk0 .. kk0 + NK - 1) against ring slab it (cols columns,
// big then small; this consumer's N from column n0), each k-step small_x
// big_w + big_x small_w + big_x big_w into a fresh accumulator, then,
// once the products have retired (the slab's stage released), added to
// run (FIRST: run = acc).
template <int N, int NK, bool FIRST, int STAGE = FW_STAGE>
__device__ __forceinline__ void fw_slab(int it, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty,
                                        uint32_t atile, int kk0, int cols,
                                        int n0, float (&acc)[N / 2],
                                        float (&run)[N / 2],
                                        const unsigned char* at, int w,
                                        int g, int t, int lead) {
  const int st = it % FW_NS;
  mbar_wait(full + st, (it / FW_NS) & 1);
  uint32_t sm[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int k = 8 * (kk0 + j) + t;
    const int r = 16 * w + g;
    sm[j][0] = small_bits(*(const float*)(at + at_byte(r, k)));
    sm[j][1] = small_bits(*(const float*)(at + at_byte(r + 8, k)));
    sm[j][2] = small_bits(*(const float*)(at + at_byte(r, k + 4)));
    sm[j][3] = small_bits(*(const float*)(at + at_byte(r + 8, k + 4)));
  }
  const uint32_t sb = smem_u32(ring + st * STAGE);
  const uint64_t bb = desc_sw128(sb + n0 * 128);
  const uint64_t bs = desc_sw128(sb + (cols + n0) * 128);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int kk = kk0 + j;
    const uint64_t da = desc_sw128(atile + (kk >> 2) * FW_KB) + 2 * (kk & 3);
    tf32_mma<N>(acc, sm[j], bb + 2 * j, j ? 1 : 0);
    tf32_mma_ss<N>(acc, da, bs + 2 * j, 1);
    tf32_mma_ss<N>(acc, da, bb + 2 * j, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive_if(empty + st, lead);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) run[i] = FIRST ? acc[i] : run[i] + acc[i];
}

// One k-step from registers (k slots 0 .. 7 of ring slab it, cols
// columns, this consumer's N from n0): A's raw f32 values xr, both halves
// made from them; added to run as a slab of its own (FIRST: run = acc).
template <int N, bool FIRST = false, int STAGE = FW_STAGE>
__device__ __forceinline__ void fw_slab_regs(int it, unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int cols, int n0,
                                             float (&acc)[N / 2],
                                             float (&run)[N / 2],
                                             const uint32_t (&xr)[4],
                                             int lead) {
  const int st = it % FW_NS;
  mbar_wait(full + st, (it / FW_NS) & 1);
  uint32_t xs[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xs[i] = small_bits(__uint_as_float(xr[i]));
  const uint32_t sb = smem_u32(ring + st * STAGE);
  const uint64_t bb = desc_sw128(sb + n0 * 128);
  const uint64_t bs = desc_sw128(sb + (cols + n0) * 128);
  wgmma_fence();
  tf32_mma<N>(acc, xs, bb, 0);
  tf32_mma<N>(acc, xr, bs, 1);
  tf32_mma<N>(acc, xr, bb, 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  mbar_arrive_if(empty + st, lead);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) run[i] = FIRST ? acc[i] : run[i] + acc[i];
}

// A whole layer's product from ring slab it on: NSLAB slabs of 4 k-steps
// (the last LASTK), with EXTRA one more k-step from registers (a last layer
// over 256 wide: its outputs 256 .. 263 at k slots 256 .. 263).
template <int N, int NSLAB, int LASTK, bool EXTRA, int STAGE = FW_STAGE>
__device__ __forceinline__ void fw_layer(int it, unsigned char* ring,
                                         uint64_t* full, uint64_t* empty,
                                         uint32_t atile, int cols, int n0,
                                         float (&acc)[N / 2],
                                         float (&run)[N / 2],
                                         const uint32_t (&xr)[4],
                                         const unsigned char* at, int w,
                                         int g, int t, int lead) {
  fw_slab<N, NSLAB == 1 ? LASTK : 4, true, STAGE>(it, ring, full, empty,
                                                  atile, 0, cols, n0, acc,
                                                  run, at, w, g, t, lead);
#pragma unroll
  for (int s = 1; s < NSLAB; ++s) {
    if (s + 1 < NSLAB)
      fw_slab<N, 4, false, STAGE>(it + s, ring, full, empty, atile, 4 * s,
                                  cols, n0, acc, run, at, w, g, t, lead);
    else
      fw_slab<N, LASTK, false, STAGE>(it + s, ring, full, empty, atile,
                                      4 * s, cols, n0, acc, run, at, w, g,
                                      t, lead);
  }
  if constexpr (EXTRA)
    fw_slab_regs<N, false, STAGE>(it + NSLAB, ring, full, empty, cols, n0,
                                  acc, run, xr, lead);
}

// One slab of an SDF network's full last layer (K1-fwd, K2): fw_slab's
// m64n128 k-steps at n0 and, with TAIL, an m64n8 k-step of columns
// 256 .. 263 beside each, into acc8 and then run8 (FIRST: run = acc, run8 =
// acc8).
template <int NK, bool FIRST, bool TAIL, int STAGE>
__device__ __forceinline__ void fw_last_slab(int it, unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             uint32_t atile, int kk0,
                                             int cols, int n0,
                                             float (&acc)[64],
                                             float (&run)[64],
                                             float (&acc8)[4],
                                             float (&run8)[4],
                                             const unsigned char* at, int w,
                                             int g, int t, int lead) {
  const int st = it % FW_NS;
  mbar_wait(full + st, (it / FW_NS) & 1);
  uint32_t sm[NK][4];
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int k = 8 * (kk0 + j) + t;
    const int r = 16 * w + g;
    sm[j][0] = small_bits(*(const float*)(at + at_byte(r, k)));
    sm[j][1] = small_bits(*(const float*)(at + at_byte(r + 8, k)));
    sm[j][2] = small_bits(*(const float*)(at + at_byte(r, k + 4)));
    sm[j][3] = small_bits(*(const float*)(at + at_byte(r + 8, k + 4)));
  }
  const uint32_t sb = smem_u32(ring + st * STAGE);
  const uint64_t bb = desc_sw128(sb + n0 * 128);
  const uint64_t bs = desc_sw128(sb + (cols + n0) * 128);
  const uint64_t tb = desc_sw128(sb + 256 * 128);
  const uint64_t ts = desc_sw128(sb + (cols + 256) * 128);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < NK; ++j) {
    const int kk = kk0 + j;
    const uint64_t da = desc_sw128(atile + (kk >> 2) * FW_KB) + 2 * (kk & 3);
    wgmma_tf32_n128(acc, sm[j], bb + 2 * j, j ? 1 : 0);
    wgmma_tf32_ss_n128(acc, da, bs + 2 * j, 1);
    wgmma_tf32_ss_n128(acc, da, bb + 2 * j, 1);
    if constexpr (TAIL) {
      wgmma_tf32_n8(acc8, sm[j], tb + 2 * j, j ? 1 : 0);
      wgmma_tf32_ss_n8(acc8, da, ts + 2 * j, 1);
      wgmma_tf32_ss_n8(acc8, da, tb + 2 * j, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (TAIL) fence_regs(acc8);
  mbar_arrive_if(empty + st, lead);
#pragma unroll
  for (int i = 0; i < 64; ++i) run[i] = FIRST ? acc[i] : run[i] + acc[i];
  if constexpr (TAIL)
#pragma unroll
    for (int i = 0; i < 4; ++i) run8[i] = FIRST ? acc8[i] : run8[i] + acc8[i];
}

// An SDF network's full last layer from ring slab it on: eight slabs of 4
// k-steps
template <bool TAIL, int STAGE>
__device__ __forceinline__ void fw_last_layer(int it, unsigned char* ring,
                                              uint64_t* full,
                                              uint64_t* empty,
                                              uint32_t atile, int cols,
                                              int n0, float (&acc)[64],
                                              float (&run)[64],
                                              float (&acc8)[4],
                                              float (&run8)[4],
                                              const unsigned char* at, int w,
                                              int g, int t, int lead) {
  fw_last_slab<4, true, TAIL, STAGE>(it, ring, full, empty, atile, 0, cols,
                                     n0, acc, run, acc8, run8, at, w, g, t,
                                     lead);
#pragma unroll
  for (int s = 1; s < 8; ++s)
    fw_last_slab<4, false, TAIL, STAGE>(it + s, ring, full, empty, atile,
                                        4 * s, cols, n0, acc, run, acc8,
                                        run8, at, w, g, t, lead);
}

// Writes value v of (row r, column c) into the A tile (c's k slot).
__device__ __forceinline__ void at_put(unsigned char* at, int r, int c,
                                       float v) {
  *(float*)(at + at_byte(r, (c & ~7) + ((c & 7) >> 1) + ((c & 1) << 2))) = v;
}

// A consumer's 128 columns of a layer result in run (row 16w + g:
// run[4q + e], row 16w + 8 + g: run[4q + 2 + e], at column n0 + 8q + 2t +
// e) into the A tile.
__device__ __forceinline__ void at_store(unsigned char* at,
                                         const float (&run)[64], int n0,
                                         int w, int g, int t) {
  const int r = 16 * w + g;
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + 8 * q + 2 * t + e;
      at_put(at, r, c, run[4 * q + e]);
      at_put(at, r + 8, c, run[4 * q + 2 + e]);
    }
}

// The same columns into a tile image of C columns.
__device__ __forceinline__ void img_store(float* im, const float (&run)[64],
                                          int n0, int C, int w, int g,
                                          int t) {
  const int r = 16 * w + g;
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + 8 * q + 2 * t + e;
      im[img_at(r, c, C)] = run[4 * q + e];
      im[img_at(r + 8, c, C)] = run[4 * q + 2 + e];
    }
}

// The sum over the warp's 8 lane groups of run[4q + e] (row 16w + g) by a
// transposing shuffle reduction (wg_bwd.cuh's gw_db_reduce on 16 column
// groups): after it, run[32 m + e] holds column 64 m + 8 g + 2 t + e of
// the consumer's 128 (m < 2).
__device__ __forceinline__ void fw_db_reduce(float (&acc)[64], int g) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const bool bit = (g >> s) & 1;
#pragma unroll
    for (int q = 0; q < 16; q += 2 << s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo = acc[4 * q + e], hi = acc[4 * (q + (1 << s)) + e];
        const float send = bit ? lo : hi;
        const float keep = bit ? hi : lo;
        acc[4 * q + e] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << s);
      }
  }
}

// -- the weight-gradient pass ------------------------------------------------
//
// dW_l = X_l^T R_l over every tile's 64 rows, split over K.  A block takes a
// unit (a layer, a pair of 64-column blocks of X_l, an R half: columns
// 0 .. 127, or 128 on) and a chunk of tiles; its producer streams each
// tile's half-images (32 rows a stage: R_l's half and X_l's pair) into a
// ring; three more warps of the producer warpgroup write each stage's R -
// trunc(R) beside it (the B operand's small half must be in shared memory
// too), fence it to the async proxy and mark the stage ready; its two
// consumers (one an X block) run wgmma with A = X^T from shared memory
// (big) and registers (small, made from the same tile) and B = R (big and
// small) from shared memory: m64n128k8, with m64n8k8 for an R half's
// columns 128 .. 135 (a last layer 257-264 wide), or m64n8k8 alone for an
// R of at most 8 columns.  Each stage sums into a fresh accumulator and is
// added to the consumer's running sum with rounded adds; the running sum
// is stored to the chunk's f32 slot.

struct FwgDims {
  int n_img, per, S, ns, stage_bytes;
  const float* img;
  float* part;
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // floats
  int cx[GW_MAXL], cr[GW_MAXL];
  int u_layer[FW_MAXU], u_pair[FW_MAXU], u_half[FW_MAXU];
};

// the columns of R half h of a tile image of cr columns: 128 (and 136 for
// a last layer 257-264 wide), or all of an R of at most 128
__host__ __device__ __forceinline__ int wgf_half_cols(int cr, int h) {
  return h ? cr - 128 : (cr < 128 ? cr : 128);
}

// a unit's stage: R_l's half (nh columns, then room for its small half)
// and X_l's pair (xc columns) of one 32-row block of one tile
__device__ __forceinline__ void fwg_producer(const FwgDims& d, int l, int pr,
                                             int h, int nh, int xc, int t0,
                                             int t1, unsigned char* ring,
                                             uint64_t* full,
                                             uint64_t* empty) {
  const int cr = d.cr[l], cx = d.cx[l];
  const int rbytes = nh * 128, xbytes = xc * 128;
  int it = 0;
  for (int tile = t0; tile < t1; ++tile)
    for (int kb = 0; kb < 2; ++kb, ++it) {
      const int st = it % d.ns;
      unsigned char* s = ring + (size_t)st * d.stage_bytes;
      mbar_wait(empty + st, ((it / d.ns) & 1) ^ 1);
      mbar_expect_tx(full + st, rbytes + xbytes);
      bulk_g2s(s,
               d.img + d.r_img[l] + (size_t)tile * 2 * cr * 32 +
                   kb * cr * 32 + h * 128 * 32,
               rbytes, full + st);
      bulk_g2s(s + 2 * rbytes,
               d.img + d.x_img[l] + (size_t)tile * 2 * cx * 32 +
                   kb * cx * 32 + pr * 128 * 32,
               xbytes, full + st);
    }
}

// The small half R - trunc(R) of each landed stage, written beside its R
// half by the producer warpgroup's three other warps (i: 0 .. 95), fenced
// to the async proxy; then one arrival a warp on the stage's ready barrier
__device__ __forceinline__ void fwg_smaller(const FwgDims& d, int nh, int n,
                                            int i, unsigned char* ring,
                                            uint64_t* full,
                                            uint64_t* ready) {
  const int n4 = nh * 128 / 16;
  for (int it = 0; it < n; ++it) {
    const int st = it % d.ns;
    mbar_wait(full + st, (it / d.ns) & 1);
    float4* r = (float4*)(ring + (size_t)st * d.stage_bytes);
    // four loads in flight before their stores
    for (int j0 = i; j0 < n4; j0 += 4 * 96) {
      float4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 96 * u < n4) v[u] = r[j0 + 96 * u];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + 96 * u < n4)
          r[n4 + j0 + 96 * u] =
              make_float4(tf32_small(v[u].x), tf32_small(v[u].y),
                          tf32_small(v[u].z), tf32_small(v[u].w));
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    mbar_arrive_if(ready + st, (i & 31) == 0);
  }
}

// The R half's products: its first 128 columns (m64n128), its columns 128
// on (m64n8: a last layer 257-264 wide), or only 8 columns
#define WGF_N128 0
#define WGF_N136 1
#define WGF_N8 2

// A consumer's chunk: X block w of the stage (A: big from shared memory,
// small from registers) against R's half (B: big and small, from shared
// memory, once the stage is ready), a fresh accumulator a stage, added to
// run; then run to the chunk's slot (the n8 part at slot column 128, or 0
// for WGF_N8).
template <int MODE>
__device__ __forceinline__ void fwg_consumer(const FwgDims& d, int nh, int w,
                                             int t0, int t1,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             uint64_t* ready, float* slot) {
  constexpr bool WIDE = MODE != WGF_N8, TAIL = MODE != WGF_N128;
  const int tid = threadIdx.x & 127, wp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, lead = lane == 0;
  float acc[64], run[64], acc8[4], run8[4];
#pragma unroll
  for (int i = 0; i < 64; ++i) run[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) run8[i] = 0.f;
  const int rbytes = nh * 128;
  const int n = 2 * (t1 - t0);
  for (int it = 0; it < n; ++it) {
    const int st = it % d.ns;
    mbar_wait(full + st, (it / d.ns) & 1);
    mbar_wait(ready + st, (it / d.ns) & 1);
    unsigned char* s = ring + (size_t)st * d.stage_bytes;
    const unsigned char* xs = s + 2 * rbytes + w * 64 * 128;
    uint32_t sm[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 16 * wp + g, k = 8 * j + t;
      sm[j][0] = small_bits(*(const float*)(xs + at_byte(m, k)));
      sm[j][1] = small_bits(*(const float*)(xs + at_byte(m + 8, k)));
      sm[j][2] = small_bits(*(const float*)(xs + at_byte(m, k + 4)));
      sm[j][3] = small_bits(*(const float*)(xs + at_byte(m + 8, k + 4)));
    }
    const uint32_t sb = smem_u32(s);
    const uint64_t rb = desc_sw128(sb), rs = desc_sw128(sb + rbytes);
    const uint64_t xa = desc_sw128(smem_u32(xs));
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (WIDE) {
        wgmma_tf32_n128(acc, sm[j], rb + 2 * j, j ? 1 : 0);
        wgmma_tf32_ss_n128(acc, xa + 2 * j, rs + 2 * j, 1);
        wgmma_tf32_ss_n128(acc, xa + 2 * j, rb + 2 * j, 1);
      }
      if constexpr (TAIL) {
        const int off = WIDE ? 128 * 128 >> 4 : 0;
        const uint64_t tb = rb + off, ts = rs + off;
        wgmma_tf32_n8(acc8, sm[j], tb + 2 * j, j ? 1 : 0);
        wgmma_tf32_ss_n8(acc8, xa + 2 * j, ts + 2 * j, 1);
        wgmma_tf32_ss_n8(acc8, xa + 2 * j, tb + 2 * j, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    if constexpr (WIDE) fence_regs(acc);
    if constexpr (TAIL) fence_regs(acc8);
    mbar_arrive_if(empty + st, lead);
    if constexpr (WIDE)
#pragma unroll
      for (int i = 0; i < 64; ++i) run[i] += acc[i];
    if constexpr (TAIL)
#pragma unroll
      for (int i = 0; i < 4; ++i) run8[i] += acc8[i];
  }
  const int m = 16 * wp + g;
  if constexpr (WIDE)
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      *(float2*)(slot + m * FW_SN + 8 * q + 2 * t) =
          make_float2(run[4 * q], run[4 * q + 1]);
      *(float2*)(slot + (m + 8) * FW_SN + 8 * q + 2 * t) =
          make_float2(run[4 * q + 2], run[4 * q + 3]);
    }
  if constexpr (TAIL) {
    const int c8 = WIDE ? 128 : 0;
    *(float2*)(slot + m * FW_SN + c8 + 2 * t) = make_float2(run8[0], run8[1]);
    *(float2*)(slot + (m + 8) * FW_SN + c8 + 2 * t) =
        make_float2(run8[2], run8[3]);
  }
}

// The body of a weight-gradient kernel (384 threads: two consumer
// warpgroups and a producer warpgroup; blockIdx.x = unit * S + chunk).
__device__ __forceinline__ void wgf_wgrad_body(const FwgDims& d,
                                               unsigned char* smem_raw) {
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  uint64_t* full = (uint64_t*)(ring + (size_t)d.ns * d.stage_bytes);
  uint64_t* empty = full + d.ns;
  uint64_t* ready = empty + d.ns;
  const int u = blockIdx.x / d.S, ch = blockIdx.x - u * d.S;
  const int l = d.u_layer[u], pr = d.u_pair[u], h = d.u_half[u];
  const int nh = wgf_half_cols(d.cr[l], h);
  const int xc = min(128, d.cx[l] - 128 * pr);
  const int nw = xc / 64;                       // active consumers
  const int t0 = ch * d.per, t1 = min(d.n_img, t0 + d.per);
  if (threadIdx.x == 0) {
    for (int s = 0; s < d.ns; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * nw);
      mbar_init(ready + s, 3);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (threadIdx.x >= 256) {
    regs_dec<40>();
    if (threadIdx.x == 256)
      fwg_producer(d, l, pr, h, nh, xc, t0, t1, ring, full, empty);
    else if (threadIdx.x >= 288)
      fwg_smaller(d, nh, 2 * (t1 - t0), threadIdx.x - 288, ring, full,
                  ready);
  } else {
    regs_inc<232>();
    if (wg >= nw) return;
    float* slot = d.part + ((size_t)blockIdx.x * 2 + wg) * 64 * FW_SN;
    if (nh > 128)
      fwg_consumer<WGF_N136>(d, nh, wg, t0, t1, ring, full, empty, ready,
                             slot);
    else if (nh < 128)
      fwg_consumer<WGF_N8>(d, nh, wg, t0, t1, ring, full, empty, ready,
                           slot);
    else
      fwg_consumer<WGF_N128>(d, nh, wg, t0, t1, ring, full, empty, ready,
                             slot);
  }
}

// -- the reduce --------------------------------------------------------------

struct FrDims {
  int L, S, n_wslots;
  long long P;
  const float *part, *dbp;
  float* grads;
  int ins[GW_MAXL], outs[GW_MAXL], u_first[GW_MAXL];
  int halves[GW_MAXL];       // R halves of each layer's units
  // where X_l's image holds W_l's input column i: its first xn[l] columns
  // from image column xn_at[l] on, the others from column 0 on
  int xn[GW_MAXL], xn_at[GW_MAXL];
};

// grads[j]: per layer dW [in][out] (the sum of its chunks' slots, in
// order), then db [out] (the sum of the warps' slots, in order)
__device__ __forceinline__ void wgf_reduce_body(const FrDims& r) {
  long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= r.P) return;
  int l = 0;
  for (; l < r.L; ++l) {
    const long long sz = (long long)r.ins[l] * r.outs[l] + r.outs[l];
    if (j < sz) break;
    j -= sz;
  }
  const int out = r.outs[l];
  float s = 0.f;
  if (j < (long long)r.ins[l] * out) {
    const int i0 = (int)(j / out), o = (int)(j - (long long)i0 * out);
    const int i = i0 < r.xn[l] ? r.xn_at[l] + i0 : i0 - r.xn[l];
    const int h = o >= 128, n = o - 128 * h;
    const int u = r.u_first[l] + r.halves[l] * (i >> 7) + h,
              w = (i >> 6) & 1;
    const float* p = r.part + ((size_t)u * r.S * 2 + w) * 64 * FW_SN +
                     (i & 63) * FW_SN + n;
    for (int c = 0; c < r.S; ++c) s += p[(size_t)c * 2 * 64 * FW_SN];
  } else {
    const int n = (int)(j - (long long)r.ins[l] * out);
    for (int ws = 0; ws < r.n_wslots; ++ws)
      s += r.dbp[((size_t)ws * r.L + l) * GW_BW + n];
  }
  r.grads[blockIdx.x * (long long)blockDim.x + threadIdx.x] = s;
}

// -- the host's plan of the pass ---------------------------------------------

// Fills w's units (layer l, a 128-column pair of its X_l image of w.cx[l]
// columns, an R half of its R_l image of w.cr[l] columns: 128 and the rest
// for 256 or 264, all of an R of 8), in that order, w's ring (stages of
// the widest unit's R half, its small half and X pair; at least 2) and r's
// unit starts and halves; the images' places (w.x_img, r_img, cx, cr),
// w.n_img, per, S, img and part are the caller's.  *smem: the pass's
// dynamic shared memory a block; *units: the number of units.  Returns a
// cudaError_t value.
static inline int wgf_plan_pass(int L, FwgDims* w, FrDims* r, size_t* smem,
                                int* units) {
  int nu = 0, widest = 0;
  for (int l = 0; l < L; ++l) {
    const int cr = w->cr[l];
    if (cr != 8 && cr != 256 && cr != 264) return (int)cudaErrorInvalidValue;
    r->u_first[l] = nu;
    r->halves[l] = cr > 128 ? 2 : 1;
    for (int pr = 0; 128 * pr < w->cx[l]; ++pr)
      for (int h = 0; h < r->halves[l]; ++h) {
        if (nu == FW_MAXU) return (int)cudaErrorInvalidValue;
        w->u_layer[nu] = l;
        w->u_pair[nu] = pr;
        w->u_half[nu] = h;
        const int nh = wgf_half_cols(cr, h);
        const int xc = w->cx[l] - 128 * pr < 128 ? w->cx[l] - 128 * pr : 128;
        const int sb = 2 * nh * 128 + xc * 128;
        widest = widest > sb ? widest : sb;
        ++nu;
      }
  }
  w->stage_bytes = (widest + 1023) / 1024 * 1024;
  const int wns = (int)((GW_SMEM_MAX - 1024) / ((size_t)w->stage_bytes + 24));
  w->ns = wns < GW_MAX_NS ? wns : GW_MAX_NS;
  if (w->ns < 2) return (int)cudaErrorInvalidValue;
  *smem = 1024 + (size_t)w->ns * (w->stage_bytes + 24);
  *units = nu;
  return 0;
}
