// The pieces that the two wgmma backwards share, K1-bwd-bf16
// (geometry_bwd_bf16_wg.cu) and K3-bwd-bf16 (radiance_bwd_bf16_wg.cu):
//
//   gw_put, gw_slab, gw_release   the sweep's slab ring: a producer thread
//                 lands a slab by one bulk copy, a consumer warpgroup runs
//                 a slab's k-steps on wgmma with A in registers (m64n256,
//                 m64n48 or m64n8) and releases each stage as its products
//                 retire; every depth fixed at compile time (the bf16
//                 forwards' too, sweep16.cuh: K2-bf16, K1-fwd-bf16,
//                 K3-fwd-bf16, whose stages may be wider)
//   gw_fwd_layer, gw_rev_layer   an SDF layer's X W and r W from the ring
//                 (K1-bwd-bf16 and the bf16 chains,
//                 geometry_bwd_chains_bf16_wg.cu)
//   gw_img, gw_perm, gw_img_chunk, gw_img256, gw_img256_skip   the writers
//                 of a layer's bf16 X_l and R_l tile images (MN-major,
//                 128-byte swizzle, wgmma.cuh), from a thread's A fragments
//   gw_db_reduce  the transposing shuffle that sums a warp's accumulator
//                 rows into per-column sums
//   wg_wgrad_body the split-K weight-gradient pass dW_l = X_l^T R_l over the
//                 images, A and B both MN-major in shared memory
//   wg_reduce_body  the fixed-order sums of the pass's chunk slots (dW) and
//                 of the sweep's per-warp slots (db, in order; or
//                 wg_db_tree's, a warp an entry)
//   wg_plan_pass  the host's plan of the pass: its units, ring and the
//                 reduce's arguments
//
// A tile image holds 64 rows (the product's depth in the pass).  The
// writers put a thread's two accumulator rows (g and g + 8 of its warp's
// 16) at image rows r0 and r0 + DR: K1-bwd-bf16 and K3-bwd-bf16 keep the
// sweep's m64 rows (r0 = 16 w + g, DR = 8: K1 stacks a point's primal and
// tangent rows there, K3 two points), the bf16 chains put one chain's rows
// of two points in K1-bwd-bf16's places (DR = 16).  r0 % 8 = g: the
// swizzle's row.  The images do not care which row is which.
#pragma once

#include "wgmma.cuh"

#define GW_MAXL 16        // most layers
#define GW_BW 264         // bias row and db slot row (floats) of a layer
#define GW_MAX_NS 8       // most ring stages
#define GW_SMEM_MAX 232448
#define GW_SLAB 32768     // bytes of a ring stage (a 256-column slab)
#define GW_PQ 40          // float4 rows of a weight-gradient slot (320 / 8)
#define GW_MAXU 32        // most weight-gradient units (layer, block pair)
#define GW_XB 8192        // bytes of a 64-column block of a tile image

// -- the sweep's slab ring ---------------------------------------------------

// slab it (bytes from src) into ring stage it % ns (stages of stage
// bytes) once the consumers released it
__device__ __forceinline__ void gw_put(int ns, unsigned char* ring,
                                       uint64_t* full, uint64_t* empty,
                                       int it, const unsigned char* src,
                                       int bytes, int stage = GW_SLAB) {
  const int st = it % ns;
  mbar_wait(empty + st, ((it / ns) & 1) ^ 1);
  mbar_expect_tx(full + st, bytes);
  bulk_g2s(ring + st * stage, src, bytes, full + st);
}

// One slab's NK k-steps from fragments f[K0 ..] into acc (N columns: 256,
// 48 or 8), once it has landed in ring slab s (stages of stage bytes);
// FIRST: the layer's first slab, whose first product overwrites acc.  One
// commit group, every index known at compile time.
template <int N, int NK, int K0, bool FIRST, int NA>
__device__ __forceinline__ void gw_slab(int ns, int s, unsigned char* ring,
                                        uint64_t* full, float (&acc)[N / 2],
                                        const uint32_t (&f)[NA][4],
                                        int stage = GW_SLAB) {
  const int st = s % ns;
  mbar_wait(full + st, (s / ns) & 1);
  wgmma_fence();
  const uint64_t desc = desc_sw128(smem_u32(ring + st * stage));
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int keep = FIRST && k == 0 ? 0 : 1;
    if constexpr (N == 256)
      wgmma_n256(acc, f[K0 + k], desc + 2 * k, keep);
    else if constexpr (N == 48)
      wgmma_n48(acc, f[K0 + k], desc + 2 * k, keep);
    else
      wgmma_n8(acc, f[K0 + k], desc + 2 * k, keep);
  }
  wgmma_commit();
}

// Waits for a layer's NS commit groups oldest first, releasing each slab's
// stage (from ring slab it on) as its products retire: one arrival a warp.
template <int NS, int S = 0>
__device__ __forceinline__ void gw_release(int ns, int it, uint64_t* empty,
                                           int lead) {
  if constexpr (S < NS) {
    wgmma_wait<NS - 1 - S>();
    mbar_arrive_if(empty + (it + S) % ns, lead);
    gw_release<NS, S + 1>(ns, it, empty, lead);
  }
}

// One SDF layer's X W from ring slab it on: with H, h's 16 k-steps from a
// in four slabs; with ENC (layer 0, a skip layer), the encoding's 3 from ef
// in one more.  Then the slabs released as their products retire.
template <bool H, bool ENC>
__device__ __forceinline__ void gw_fwd_layer(int ns, int it,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             float (&acc)[128],
                                             const uint32_t (&a)[16][4],
                                             const uint32_t (&ef)[3][4],
                                             int lead) {
  if constexpr (H) {
    gw_slab<256, 4, 0, true>(ns, it, ring, full, acc, a);
    gw_slab<256, 4, 4, false>(ns, it + 1, ring, full, acc, a);
    gw_slab<256, 4, 8, false>(ns, it + 2, ring, full, acc, a);
    gw_slab<256, 4, 12, false>(ns, it + 3, ring, full, acc, a);
  }
  if constexpr (ENC)
    gw_slab<256, 3, 0, !H>(ns, it + (H ? 4 : 0), ring, full, acc, ef);
  gw_release<(H ? 4 : 0) + (ENC ? 1 : 0)>(ns, it, empty, lead);
  fence_regs(acc);
}

// One SDF layer's r W (N columns: 256, or 48 for layer 0) from ring slab it
// on: r's 16 k-steps from a in four slabs and, with EXTRA (a last layer
// over 256 wide), its 17th from ex.
template <int N, bool EXTRA>
__device__ __forceinline__ void gw_rev_layer(int ns, int it,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             float (&acc)[N / 2],
                                             const uint32_t (&a)[16][4],
                                             const uint32_t (&ex)[1][4],
                                             int lead) {
  gw_slab<N, 4, 0, true>(ns, it, ring, full, acc, a);
  gw_slab<N, 4, 4, false>(ns, it + 1, ring, full, acc, a);
  gw_slab<N, 4, 8, false>(ns, it + 2, ring, full, acc, a);
  gw_slab<N, 4, 12, false>(ns, it + 3, ring, full, acc, a);
  if constexpr (EXTRA)
    gw_slab<N, 1, 0, false>(ns, it + 4, ring, full, acc, ex);
  gw_release<4 + (EXTRA ? 1 : 0)>(ns, it, empty, lead);
  fence_regs(acc);
}

// -- the tile images ---------------------------------------------------------

// The four bf16 pairs of k-step j (f: a fragment) into a tile image in
// its columns' own order: f[0], f[2] at row r0, f[1], f[3] at row r0 + DR,
// columns 16j + 2t (+ 8 for f[2], f[3]); MN-major, 128-byte swizzle
// (wgmma.cuh).
template <int DR>
__device__ __forceinline__ void gw_img(unsigned char* im, int j,
                                       const uint32_t (&f)[4], int r0, int g,
                                       int t) {
  unsigned char* o = im + (j >> 2) * GW_XB + r0 * 128 + 4 * t;
  const int c0 = ((2 * (j & 3)) ^ g) << 4, c1 = ((2 * (j & 3) + 1) ^ g) << 4;
  *(uint32_t*)(o + c0) = f[0];
  *(uint32_t*)(o + 128 * DR + c0) = f[1];
  *(uint32_t*)(o + c1) = f[2];
  *(uint32_t*)(o + 128 * DR + c1) = f[3];
}

// The position of column c (< 256) of a 256-column tile image: thread
// (g, t) holds columns 8q + 2t, 8q + 2t + 1 of its rows for q < 32; the
// image keeps its pairs of q = 4r .. 4r + 3 as one 16-byte chunk, chunk 4
// (r % 2) + t of block r / 2, so that a thread stores 16 bytes at once and
// a warp's store covers 64 contiguous bytes of each of its 8 rows.  dW's
// rows (X's columns) and columns (R's) come out in this order, which the
// reduce undoes; a product does not care in which order its columns are.
// Column c stays in block c / 64.
__device__ __forceinline__ int gw_perm(int c) {
  const int q = c >> 3, r = q >> 2;
  return ((r >> 1) << 6) + ((((r & 1) << 2) + ((c >> 1) & 3)) << 3) +
         ((q & 3) << 1) + (c & 1);
}

// Chunk r (pairs of q = 4r .. 4r + 3) of a thread's accumulator row g (p,
// at image row r0) and row g + 8 (t4, at r0 + DR) into a 256-column tile
// image, in gw_perm's order.
template <int DR>
__device__ __forceinline__ void gw_img_chunk(unsigned char* im, int r,
                                             const uint4& p, const uint4& t4,
                                             int r0, int g, int t) {
  unsigned char* o = im + (r >> 1) * GW_XB + r0 * 128 +
                     (((((r & 1) << 2) + t) ^ g) << 4);
  *(uint4*)o = p;
  *(uint4*)(o + 128 * DR) = t4;
}

// The fragments a (k-steps 0 .. 15) into a 256-column tile image.
template <int DR>
__device__ __forceinline__ void gw_img256(unsigned char* im,
                                          const uint32_t (&a)[16][4], int r0,
                                          int g, int t) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    gw_img_chunk<DR>(im, r,
                     make_uint4(a[2 * r][0], a[2 * r][2], a[2 * r + 1][0],
                                a[2 * r + 1][2]),
                     make_uint4(a[2 * r][1], a[2 * r][3], a[2 * r + 1][1],
                                a[2 * r + 1][3]),
                     r0, g, t);
}

__device__ __forceinline__ float bf_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}

__device__ __forceinline__ float bf_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// An SDF skip layer's X image: [h (w columns) | enc (d_embed)] / sqrt 2 in
// W's column order (gw_perm's positions), h from the fragments a (already
// / sqrt 2), enc from the encoding rows e0 (accumulator row g's) and e1
// (row g + 8's).
template <int DR>
__device__ __forceinline__ void gw_img256_skip(unsigned char* im,
                                               const uint32_t (&a)[16][4],
                                               const float* e0,
                                               const float* e1, int w,
                                               int d_embed, int r0, int g,
                                               int t) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    uint32_t f[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int ch = 0; ch < 2; ++ch) {
        // pair q = 4r + i of accumulator row g (ch 0) or g + 8 (ch 1)
        const int j = 2 * r + (i >> 1), ai = 2 * (i & 1) + ch;
        const int c = 8 * (4 * r + i) + 2 * t;
        const float* e = ch ? e1 : e0;
        float v[2] = {bf_lo(a[j][ai]), bf_hi(a[j][ai])};
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int ce = c + k - w;
          if (ce >= 0) v[k] = ce < d_embed ? e[ce] * inv_sqrt2 : 0.f;
        }
        f[ch][i] = pack_bf16(v[0], v[1]);
      }
    gw_img_chunk<DR>(im, r, make_uint4(f[0][0], f[0][1], f[0][2], f[0][3]),
                     make_uint4(f[1][0], f[1][1], f[1][2], f[1][3]), r0, g,
                     t);
  }
}

// Sums over the warp's 8 lane groups of the entries acc[4q + e] (e < 2:
// accumulator row 16 warp + g) by a transposing shuffle reduction: after
// it, acc[32 m + e] holds column 64 m + 8 g + 2 t + e's sum (m < 4).
__device__ __forceinline__ void gw_db_reduce(float (&acc)[128], int g) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const bool bit = (g >> s) & 1;
#pragma unroll
    for (int q = 0; q < 32; q += 2 << s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo = acc[4 * q + e], hi = acc[4 * (q + (1 << s)) + e];
        const float send = bit ? lo : hi;
        const float keep = bit ? hi : lo;
        acc[4 * q + e] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << s);
      }
  }
}

// R_l in acc (f32, stacked): its bf16 A fragments a, its tile image im,
// and its primal rows' column sums added to the warp's db slot row sl
// (set on the block's first pass).
__device__ __forceinline__ void gw_r_finish(float (&acc)[128],
                                            uint32_t (&a)[16][4],
                                            unsigned char* im, float* sl,
                                            bool first, int warp, int g,
                                            int t) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[j][i] = pack_bf16(acc[8 * j + 2 * i], acc[8 * j + 2 * i + 1]);
  gw_img256<8>(im, a, 16 * warp + g, g, t);
  gw_db_reduce(acc, g);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float2* o = (float2*)(sl + 64 * m + 8 * g + 2 * t);
    const float2 v = make_float2(acc[32 * m], acc[32 * m + 1]);
    *o = first ? v : make_float2(o->x + v.x, o->y + v.y);
  }
}

// The reverse step of layer l (l >= 1) from R_in = r W_l in acc: with SKIP
// (layer l reads [h | enc] / sqrt 2) R_in / sqrt 2 and its encoding
// columns (w on) added to the point's re rows; then h = sp(a), hd =
// sigma(100 a) ad: r = r_h s + rd_h ds ad, rd = rd_h s (s and ad of layer
// l - 1 from its scratch sc), zero from column w on.
template <bool SKIP>
__device__ __forceinline__ void gw_rev_step(float (&acc)[128],
                                            const float4* sc, int w,
                                            int d_embed, float* rp,
                                            float* rt, int t) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const float4 v = sc[q * 128];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * q + 2 * t + e;
      float rh = acc[4 * q + e], rdh = acc[4 * q + 2 + e];
      if (SKIP) {
        rh *= inv_sqrt2;
        rdh *= inv_sqrt2;
        if (c >= w && c < w + d_embed) {
          rp[c - w] += rh;
          rt[c - w] += rdh;
        }
      }
      const float s = e ? v.y : v.x, ad = e ? v.w : v.z;
      const float ds = 100.f * s * (1.f - s);
      const bool in = c < w;
      acc[4 * q + e] = in ? rh * s + rdh * ds * ad : 0.f;
      acc[4 * q + 2 + e] = in ? rdh * s : 0.f;
    }
  }
}

// K1's reverse sweep over a consumer's tile of 32 points (stacked: thread
// (warp, g, t) holds point 8 warp + g's primal row, accumulator row g, and
// its tangent row, g + 8), from the seeds ct_out (column 0 / scale) and e0
// / scale through every layer's r W, its step and its R_l image (image
// tile ``tile``, rows 16 warp + g and 16 warp + 8 + g) and db, to the
// encoding's cotangents rp, rt: K1-bwd-bf16's (geometry_bwd_bf16_wg.cu),
// which K1-bwd-split-bf16 and K1-bwd-stash-bf16 run too
// (geometry_bwd_chains_bf16_wg.cu).  scr: this thread's f32 scratch, its
// float4 of layer l and pair q at scr[(32 l + q) 128]: sigma(100 a) of the
// primal row, then ad of the tangent row; dbw: the warp's db slot, set on
// the block's first tile (first); P: the point, it: the ring's slab.
template <class D>
__device__ __forceinline__ void gw_reverse(const D& d, int& it,
                                           unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           float (&acc)[128],
                                           uint32_t (&a)[16][4], int tile,
                                           int P, const float4* scr,
                                           float* dbw, float* rp, float* rt,
                                           bool first, int tid, int lead) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const float inv_scale = 1.f / d.scale;
  const int lL = d.L - 1, N = d.outs[lL], de = d.d_embed;
  const bool valid = P < d.n;
  // the seeds: ct_out (column 0 / scale) on the primal rows, e0 / scale
  // on the tangent rows; a last layer over 256 wide has its columns 256
  // on in ex (k-step 16)
  uint32_t ex[1][4] = {{0u, 0u, 0u, 0u}};
  {
    const float* co = d.ct_out + (size_t)P * N;
#pragma unroll
    for (int q = 0; q < 32; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * q + 2 * t + e;
        acc[4 * q + e] =
            valid && c < N ? co[c] * (c == 0 ? inv_scale : 1.f) : 0.f;
        acc[4 * q + 2 + e] = valid && c == 0 ? inv_scale : 0.f;
      }
    if (N > 256) {
      float xv[2][2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 256 + 8 * h + 2 * t + e;
          xv[h][e] = valid && c < N ? co[c] : 0.f;
        }
      ex[0][0] = pack_bf16(xv[0][0], xv[0][1]);
      ex[0][2] = pack_bf16(xv[1][0], xv[1][1]);
      const uint32_t f[4] = {ex[0][0], 0u, ex[0][2], 0u};
      gw_img<8>(d.img + d.r_img[lL] + (size_t)tile * d.rb[lL], 16, f,
                16 * warp + g, g, t);
      // db's columns 256 + 2t + e: summed over the warp's points
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = xv[0][e];
#pragma unroll
        for (int s = 4; s < 32; s <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, s);
        float* o = dbw + lL * GW_BW + 256 + 2 * t + e;
        if (g == 0) *o = first ? v : *o + v;
      }
    }
    gw_r_finish(acc, a, d.img + d.r_img[lL] + (size_t)tile * d.rb[lL],
                dbw + lL * GW_BW, first, warp, g, t);
  }

  // the reverse sweep: r W of layer l, then layer l - 1's step (its
  // scratch on its way to L2 while the product runs)
  for (int l = lL; l >= 1; --l) {
    l2_prefetch_if(scr - tid + (l - 1) * 32 * 128, 32 * 128 * 16,
                   tid == 0);
    if (l == lL && N > 256)
      gw_rev_layer<256, true>(d.ns, it, ring, full, empty, acc, a, ex,
                              lead);
    else
      gw_rev_layer<256, false>(d.ns, it, ring, full, empty, acc, a, ex,
                               lead);
    it += d.r_nslab[l];
    const float4* sl = scr + (l - 1) * 32 * 128;
    if (d.enc[l]) {
      __syncwarp();
      gw_rev_step<true>(acc, sl, d.outs[l - 1], de, rp, rt, t);
    } else {
      gw_rev_step<false>(acc, sl, d.outs[l - 1], de, rp, rt, t);
    }
    gw_r_finish(acc, a,
                d.img + d.r_img[l - 1] + (size_t)tile * d.rb[l - 1],
                dbw + (l - 1) * GW_BW, first, warp, g, t);
  }
  {
    // layer 0: r W_0, the encoding's cotangents
    float acc48[24];
    gw_rev_layer<48, false>(d.ns, it, ring, full, empty, acc48, a, ex,
                            lead);
    it += d.r_nslab[0];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * q + 2 * t + e;
        if (c < de) {
          rp[c] += acc48[4 * q + e];
          rt[c] += acc48[4 * q + 2 + e];
        }
      }
  }
}

// -- the weight-gradient pass ------------------------------------------------
//
// dW_l = X_l^T R_l over every tile, split over K: a block takes a unit (a
// layer and a pair of 64-row blocks of dW) and a chunk of tiles; its
// producer streams each tile's R_l image and the unit's X_l blocks into a
// ring, its consumers (one a 64-row block) run wgmma with A and B both
// MN-major from shared memory: m64n256k16 over R's first four blocks and,
// where R has a fifth (a layer 257-264 wide) or only one (a layer of at
// most 64 columns), m64n64k16 over that block.  A consumer's accumulator
// sums its whole chunk and is then stored to its f32 slot in device memory,
// in its own register order (the n256 part at float4 rows 0 .. 31, the n64
// part at 32 .. 39).

struct WgDims {
  int n_img, per, S, ns, stage_bytes;
  const unsigned char* img;
  float* part;
  long long x_img[GW_MAXL], r_img[GW_MAXL];
  int xb[GW_MAXL], rb[GW_MAXL];
  int u_layer[GW_MAXU], u_mb[GW_MAXU], u_nmb[GW_MAXU];
};

// one tile's X_l blocks and R_l image a stage: R at the stage's start, X
// blocks mb, mb + 1 after it
__device__ __forceinline__ void wg_producer(const WgDims& d, int l, int mb,
                                            int nmb, int t0, int t1,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  const int rb = d.rb[l], xbytes = nmb * GW_XB;
  int it = 0;
  for (int tile = t0; tile < t1; ++tile, ++it) {
    const int st = it % d.ns;
    unsigned char* s = ring + (size_t)st * d.stage_bytes;
    mbar_wait(empty + st, ((it / d.ns) & 1) ^ 1);
    mbar_expect_tx(full + st, rb + xbytes);
    bulk_g2s(s, d.img + d.r_img[l] + (size_t)tile * rb, rb, full + st);
    bulk_g2s(s + rb, d.img + d.x_img[l] + (size_t)tile * d.xb[l] +
                         mb * GW_XB, xbytes, full + st);
  }
}

// The products of an R image of four blocks (WG_N256), five (WG_N320: the
// n64 part over the fifth) or one (WG_N64)
#define WG_N256 0
#define WG_N320 1
#define WG_N64 2

// One tile's 4 k-steps into acc and acc64 (as MODE has them); keep0 == 0:
// the first overwrites.  One commit group.
template <int MODE>
__device__ __forceinline__ void wg_tile(uint32_t s, int rb, int w,
                                        float (&acc)[128], float (&acc64)[32],
                                        int keep0) {
  const uint64_t da = desc_mn128(s + rb + w * GW_XB, GW_XB, 1024);
  const uint64_t db = desc_mn128(s, GW_XB, 1024);
  const int b64 = MODE == WG_N320 ? 4 : 0;   // R's block of the n64 part
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int keep = k == 0 ? keep0 : 1;
    if constexpr (MODE != WG_N64)
      wgmma_ss_n256(acc, da + 128 * k, db + 128 * k, keep);
    if constexpr (MODE != WG_N256)
      wgmma_ss_n64(acc64, da + 128 * k, db + b64 * (GW_XB >> 4) + 128 * k,
                   keep);
  }
  wgmma_commit();
}

template <int MODE>
__device__ __forceinline__ void wg_consumer(const WgDims& d, int l, int w,
                                            int t0, int t1,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            float4* slot) {
  const int tid = threadIdx.x & 127, lead = (tid & 31) == 0;
  const int rb = d.rb[l];
  float acc[128], acc64[32];
  int it = 0;
  for (int tile = t0; tile < t1; ++tile, ++it) {
    const int st = it % d.ns;
    mbar_wait(full + st, (it / d.ns) & 1);
    wg_tile<MODE>(smem_u32(ring + (size_t)st * d.stage_bytes), rb, w, acc,
                  acc64, tile != t0);
    // the previous tile's products have retired: release its stage
    wgmma_wait<1>();
    mbar_arrive_if(empty + (it + d.ns - 1) % d.ns, lead && tile != t0);
  }
  wgmma_wait<0>();
  if constexpr (MODE != WG_N64) {
    fence_regs(acc);
#pragma unroll
    for (int q = 0; q < 32; ++q)
      slot[q * 128 + tid] = make_float4(acc[4 * q], acc[4 * q + 1],
                                        acc[4 * q + 2], acc[4 * q + 3]);
  }
  if constexpr (MODE != WG_N256) {
    fence_regs(acc64);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      slot[(32 + q) * 128 + tid] =
          make_float4(acc64[4 * q], acc64[4 * q + 1], acc64[4 * q + 2],
                      acc64[4 * q + 3]);
  }
}

// The body of a weight-gradient kernel (384 threads: a producer warpgroup
// and two consumers; blockIdx.x = unit * S + chunk).
__device__ __forceinline__ void wg_wgrad_body(const WgDims& d,
                                              unsigned char* smem_raw) {
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  uint64_t* full = (uint64_t*)(ring + (size_t)d.ns * d.stage_bytes);
  uint64_t* empty = full + d.ns;
  const int u = blockIdx.x / d.S, c = blockIdx.x - u * d.S;
  const int l = d.u_layer[u], mb = d.u_mb[u], nmb = d.u_nmb[u];
  const int t0 = c * d.per, t1 = min(d.n_img, t0 + d.per);
  if (threadIdx.x == 0) {
    for (int s = 0; s < d.ns; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * nmb);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0)
      wg_producer(d, l, mb, nmb, t0, t1, ring, full, empty);
  } else if (wg - 1 < nmb) {
    regs_inc<240>();
    float4* slot = (float4*)d.part + ((size_t)blockIdx.x * 2 + wg - 1) *
                                         GW_PQ * 128;
    const int rblocks = d.rb[l] / GW_XB;
    if (rblocks == 5)
      wg_consumer<WG_N320>(d, l, wg - 1, t0, t1, ring, full, empty, slot);
    else if (rblocks == 1)
      wg_consumer<WG_N64>(d, l, wg - 1, t0, t1, ring, full, empty, slot);
    else
      wg_consumer<WG_N256>(d, l, wg - 1, t0, t1, ring, full, empty, slot);
  }
}

// -- the reduce --------------------------------------------------------------

struct RdDims {
  int L, S, n_wslots;
  long long P;
  const float *part, *dbp;
  float* grads;
  int ins[GW_MAXL], outs[GW_MAXL], u_first[GW_MAXL];
  // where the pass holds dW's rows and columns: X_l's first xn[l] columns
  // in their own order from image column xn_at[l], the others at gw_perm
  // of their index after them; R_l's first rn[l] columns at gw_perm, the
  // others in their own order from image column 256
  int xn[GW_MAXL], xn_at[GW_MAXL], rn[GW_MAXL];
  // nonzero: db is wg_db_tree's (this kernel leaves it), else the sum of
  // the warps' slots in order
  int db_tree;
};

// grads[j]: per layer dW [in][out] (the sum of its chunks' slots, in
// order), then db [out] (the sum of the warps' slots, in order)
__device__ __forceinline__ void wg_reduce_body(const RdDims& r) {
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
    const int m0 = (int)(j / out), n0 = (int)(j - (long long)m0 * out);
    const int xn = r.xn[l], rn = r.rn[l];
    const int m = m0 < xn ? r.xn_at[l] + m0 : gw_perm(m0 - xn);
    const int n = n0 < rn ? gw_perm(n0) : 256 + n0 - rn;
    const int mb = m >> 6, mm = m & 63;
    const int u = r.u_first[l] + (mb >> 1), w = mb & 1;
    const int tid = 32 * (mm >> 4) + 4 * (mm & 7) + ((n & 7) >> 1);
    const int q = n < 256 ? n >> 3 : 32 + ((n - 256) >> 3);
    const int comp = 2 * ((mm >> 3) & 1) + (n & 1);
    for (int c = 0; c < r.S; ++c)
      s += r.part[((((size_t)(u * r.S + c) * 2 + w) * GW_PQ + q) * 128 +
                   tid) * 4 + comp];
  } else {
    if (r.db_tree) return;
    const int n = (int)(j - (long long)r.ins[l] * out);
    for (int ws = 0; ws < r.n_wslots; ++ws)
      s += r.dbp[((size_t)ws * r.L + l) * GW_BW + n];
  }
  r.grads[blockIdx.x * (long long)blockDim.x + threadIdx.x] = s;
}

// db with a warp an entry (blockDim.x a multiple of 32): lane i sums the
// warps' slots i, i + 32, ... in order, then a butterfly of shuffles sums
// the lanes, each pair's sum the same in both lanes: a fixed order, the
// same bits in every launch, and the slots read 32 at a time rather than
// one after another
__device__ __forceinline__ void wg_db_tree(const RdDims& r) {
  const int lane = threadIdx.x & 31;
  int e = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  long long off = 0;
  int l = 0;
  for (; l < r.L; ++l) {
    off += (long long)r.ins[l] * r.outs[l];
    if (e < r.outs[l]) break;
    off += r.outs[l];
    e -= r.outs[l];
  }
  if (l == r.L) return;
  float s = 0.f;
  for (int ws = lane; ws < r.n_wslots; ws += 32)
    s += r.dbp[((size_t)ws * r.L + l) * GW_BW + e];
#pragma unroll
  for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) r.grads[off + e] = s;
}

// -- the host's plan of the pass ---------------------------------------------

// Fills w's units (a layer and a pair of its dW's 64-row blocks; layer l
// has nmb[l] of them, the unit after a pair takes the rest), its ring
// (stages of the widest unit's R image and X blocks) and r's unit starts;
// the images' places (w.x_img, r_img, xb, rb), w.n_img, per, S, img and
// part are the caller's.  *smem: the pass's dynamic shared memory a
// block; *units: the number of units.  Returns a cudaError_t value.
static inline int wg_plan_pass(int L, const int* nmb, WgDims* w, RdDims* r,
                               size_t* smem, int* units) {
  int nu = 0, widest = 0;
  for (int l = 0; l < L; ++l) {
    r->u_first[l] = nu;
    for (int mb = 0; mb < nmb[l]; mb += 2) {
      if (nu == GW_MAXU) return (int)cudaErrorInvalidValue;
      w->u_layer[nu] = l;
      w->u_mb[nu] = mb;
      w->u_nmb[nu] = nmb[l] - mb < 2 ? nmb[l] - mb : 2;
      const int sb = w->rb[l] + w->u_nmb[nu] * GW_XB;
      widest = widest > sb ? widest : sb;
      ++nu;
    }
  }
  w->stage_bytes = (widest + 1023) / 1024 * 1024;
  const int wns = (int)((GW_SMEM_MAX - 1024) / ((size_t)w->stage_bytes + 16));
  w->ns = wns < GW_MAX_NS ? wns : GW_MAX_NS;
  if (w->ns < 2) return (int)cudaErrorInvalidValue;
  *smem = 1024 + (size_t)w->ns * (w->stage_bytes + 16);
  *units = nu;
  return 0;
}
