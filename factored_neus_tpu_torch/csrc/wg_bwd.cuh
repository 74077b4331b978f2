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
//   gw_img, gw_perm, gw_img_chunk, gw_img256   the writers of a layer's bf16
//                 X_l and R_l tile images (MN-major, 128-byte swizzle,
//                 wgmma.cuh), from a thread's A fragments
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
// A tile image holds 64 rows (the product's depth in the pass); row i of a
// tile is accumulator row i of the sweep's m64 tile (16 w + g and 16 w + 8
// + g for warp w, lane group g).  K1 stacks a point's primal and tangent
// rows there, K3 two points: the images do not care.
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

// -- the tile images ---------------------------------------------------------

// The four bf16 pairs of k-step j (f: a fragment) into a tile image in
// its columns' own order: f[0], f[2] at row 16 warp + g, f[1], f[3] 8 rows
// on, columns 16j + 2t (+ 8 for f[2], f[3]); MN-major, 128-byte swizzle
// (wgmma.cuh).
__device__ __forceinline__ void gw_img(unsigned char* im, int j,
                                       const uint32_t (&f)[4], int warp,
                                       int g, int t) {
  unsigned char* o = im + (j >> 2) * GW_XB + (16 * warp + g) * 128 + 4 * t;
  const int c0 = ((2 * (j & 3)) ^ g) << 4, c1 = ((2 * (j & 3) + 1) ^ g) << 4;
  *(uint32_t*)(o + c0) = f[0];
  *(uint32_t*)(o + 1024 + c0) = f[1];
  *(uint32_t*)(o + c1) = f[2];
  *(uint32_t*)(o + 1024 + c1) = f[3];
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

// Chunk r (pairs of q = 4r .. 4r + 3) of a thread's row 16 warp + g (p)
// and row 16 warp + 8 + g (t4) into a 256-column tile image, in gw_perm's
// order.
__device__ __forceinline__ void gw_img_chunk(unsigned char* im, int r,
                                             const uint4& p, const uint4& t4,
                                             int warp, int g, int t) {
  unsigned char* o = im + (r >> 1) * GW_XB + (16 * warp + g) * 128 +
                     (((((r & 1) << 2) + t) ^ g) << 4);
  *(uint4*)o = p;
  *(uint4*)(o + 1024) = t4;
}

// The fragments a (k-steps 0 .. 15) into a 256-column tile image.
__device__ __forceinline__ void gw_img256(unsigned char* im,
                                          const uint32_t (&a)[16][4],
                                          int warp, int g, int t) {
#pragma unroll
  for (int r = 0; r < 8; ++r)
    gw_img_chunk(im, r,
                 make_uint4(a[2 * r][0], a[2 * r][2], a[2 * r + 1][0],
                            a[2 * r + 1][2]),
                 make_uint4(a[2 * r][1], a[2 * r][3], a[2 * r + 1][1],
                            a[2 * r + 1][3]),
                 warp, g, t);
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
