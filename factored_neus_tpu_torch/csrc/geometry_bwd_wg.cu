// K1-bwd: the backward of K1-fwd in f32, on Hopper's warpgroup tensor
// cores in 3xTF32 (wgmma.cuh).  Replaces the TPU kernel
// factored_neus_tpu/ops/pallas_geometry.py _make_geom.run_bwd (body
// _build_bwd_kernel_stacked, f32 products): the primal forward and a
// forward tangent along ct_grad recomputed as stacked rows (primal: bias
// and softplus(beta=100); tangent: sigma(100 a) ad), both chains swept in
// reverse from the seeds ct_out (column 0 / scale) and e0 / scale, dW =
// X^T R summed over every stacked row, db the sum of the primal R, ct_x
// through the encoding's backward (the eikonal Hessian-vector term
// included).  Every product runs in 3xTF32: small_a big_b + big_a small_b
// + big_a big_b, 8 k an instruction (tc_mma.cuh's scheme); everything
// elementwise stays f32.
//
// Bound: operations, 5,768,704 FLOP a point at full width, three TF32
// products' worth over 495 TFLOP/s (2.291 ms at 65,536 points).  Three
// kernels, launched one after another, as K1-bwd-bf16's
// (geometry_bwd_bf16_wg.cu), with what TF32 on wgmma imposes:
//
// 1. The sweep (geometry_bwd_wgf_sweep).  A block is two consumer
//    warpgroups (warps 0-7) and a producer warpgroup (8-11, one thread of
//    which issues the copies): setmaxnreg moves the producer's registers
//    to the consumers, 24 and 240 a thread (the pool setmaxnreg.inc draws
//    on is what the block's setmaxnreg.dec gave up: a lone producer warp
//    frees too few, and the consumers' increase waits forever), room for
//    an accumulator and a running sum of 64 each and a slab's small
//    fragments without spills, where the 168 of 384 threads made ptxas
//    serialize the products), persistent over tiles
//    blockIdx.x, + gridDim.x, ...; a tile is 32 points, 64 stacked rows
//    (warp w: the primal rows of points 8w .. 8w + 7 as rows 16w + g, their
//    tangent rows as 16w + 8 + g, so a thread holds a point's primal and
//    tangent values of the same columns).  Both consumers run the same 64
//    rows, consumer c the output columns 128c .. 128c + 127 of every
//    product (m64n128k8; layer 0's r W m64n24k8).
//    - Registers.  An m64n256 f32 accumulator is 128 registers and a tile's
//      f32 activations another 128, and a TF32 operand cannot be packed two
//      to a register as bf16 is: a thread cannot hold both.  So the layer
//      input X_l (and in the reverse R_l) lives in shared memory as f32, a
//      K-major 128-byte-swizzled A tile (64 KB, wgmma.cuh's tf32 tile), and
//      each consumer holds half the output: its accumulator (64) and its
//      running sum (64).
//    - 3xTF32 from one f32 copy.  wgmma reads an f32 operand by dropping
//      its 13 low mantissa bits (tools/tf32_mma_probe.py): that truncation
//      is big_x, read by the tensor core from the A tile itself; small_x =
//      x - big_x, exact in f32, is made in registers a slab at a time from
//      the same tile and given as the register A of small_x big_w.  The
//      weights come pre-split (tc_pack.pack_sweep_f32, pack_rev_f32: big =
//      W rounded to TF32, small = W - big, each a K-major slab of 32 f32
//      k).  A k-step is three products, in tc_mma.cuh's order.
//    - The accumulator rounds toward zero (tools/tf32_mma_probe.py).  One
//      accumulator over a 256-deep product (96 truncating adds) misses
//      check_vjp's bound by 2x in the CPU emulation
//      (tests/test_torch_bwd_wg_f32.py); a rounded add every slab (32 k) is
//      within 0.34 of it (0.43 on the card).  So each slab's products go
//      to a fresh accumulator, are waited for, and are added to the
//      running sum with rounded f32 adds: the other consumer's products
//      fill the wait.
//    - The k permutation (tc_pack.tf32_slot): within each group of 8, k
//      slot t holds column 2t and slot t + 4 column 2t + 1, in the A tile
//      and in every slab, so a thread writes its accumulator columns to
//      the very slots its own A fragments read back: no shuffle.
//    - Slabs stream by cp.async.bulk on mbarriers from a producer thread,
//      two stages of 64 KB (a 256-column slab, big then small); the A tile,
//      the ring and the encoding tiles fill shared memory.  Fixed depths:
//      every hidden layer's product is 8 slabs of 32 k, layer 0's forward
//      2 (the encoding, <= 48 k), a last layer over 256 wide one more slab
//      whose first k-step (outputs 256 .. 263) comes from registers.
//    - Between layers, two named barriers over the two consumers: every
//      product of the layer has read the A tile before it is overwritten,
//      and the new tile is written (and fenced to the async proxy) before
//      any product reads it.
//    - The f32 scratch holds sigma(100 a) and ad, a thread's own float4s:
//      written once in the forward, read once in the reverse.
//    - Each layer's X_l and R_l (f32) go to device memory as tile images,
//      K-major over the tile's rows (row-contiguous per column, 128-byte
//      swizzle, 32 rows a block): wgmma reads tf32 K-major only, and the
//      pass contracts over rows.
//    - db: each layer's f32 primal R summed over the warp's 8 points by a
//      transposing shuffle reduction, added to the warp's slot tile after
//      tile, in order.
//    - ct_x: the encoding's cotangents of the skip layer and layer 0 in
//      shared memory, then pe_backward per point.
// 2. The weight-gradient pass (geometry_bwd_wgf_wgrad): dW_l = X_l^T R_l
//    over all stacked rows, split over K.  A block takes a unit (a layer,
//    a pair of 64-column blocks of X_l, a 128-column half of R_l) and a
//    chunk of tiles; its producer streams each tile's half-images (32 rows
//    a stage: R_l's half and X_l's pair) into a ring; three more warps of
//    the producer warpgroup write each stage's R - trunc(R) beside it
//    (the B operand's small half must be in shared memory too), fence it
//    to the async proxy and mark the stage ready; its two consumers (one
//    an X block) run wgmma m64n128k8 (+ m64n8k8 for outputs 256 .. 263)
//    with A = X^T from shared memory (big) and registers (small, made from
//    the same tile) and B = R (big and small) from shared memory.  Each
//    stage sums into a fresh accumulator and is added to the consumer's
//    running sum with rounded adds (as the sweep); the running sum is
//    stored to the chunk's f32 slot.
// 3. The reduce (geometry_bwd_wgf_reduce): dW the sum of the chunks' slots
//    and db of the warps' slots, each in a fixed order.  No float atomics:
//    two launches are bitwise equal.
//
// Bytes at full width, 65,536 points (2,048 tiles): the scratch 512 KB a
// tile written and read (2.15 GB); the images 1.13 MB a tile written (X:
// 16 KB for layer 0, 64 KB for each of 8 others; R: 64 KB for each of 8
// layers, 66 KB the last: 2.32 GB) and read by the pass, X_l once for each
// R half and R_l once for each X pair (4.50 GB); slots and db slots ~20
// MB: ~9.0 GB, ~2.7 ms at 3.35 TB/s (chip_smoke.py counts it).
// From L2, every tile streams each layer's slabs twice (forward and
// reverse, 8.4 MB a tile, 17 GB a call).  The products need 2.29 ms.
#include "sdf_mlp.cuh"
#include "wg_bwd.cuh"

#define FW_PTS 32          // points of a tile (64 stacked rows)
#define FW_EW 48           // row (floats) of the encoding tiles
#define FW_STAGE 65536     // bytes of a ring stage: a 256-column slab pair
#define FW_NS 2            // ring stages
#define FW_KB 8192         // bytes of a 32-k block of the 64-row A tile
#define FW_SN 136          // columns of a weight-gradient slot row
#define FW_MAXU 64         // most weight-gradient units

struct FwDims {
  int L, multires, d_embed, n, n_tiles;
  float scale;
  const float *x, *ct_out, *ct_g;
  float *ct_x, *scratch, *dbp, *img;
  const unsigned char *fpack, *rpack;
  int ins[GW_MAXL], outs[GW_MAXL];
  int enc[GW_MAXL];        // layer l reads [h | enc] (a skip layer)
  int f_off[GW_MAXL];      // byte offset of forward layer l's first slab
  int r_off[GW_MAXL];      // byte offset of reverse layer l's first slab
  int r_bytes[GW_MAXL];    // bytes of one of its reverse slabs
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // floats: tile 0's images
  int cx[GW_MAXL], cr[GW_MAXL];               // their columns
  const float* b[GW_MAXL];
};

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

__device__ __forceinline__ void fw_put(unsigned char* ring, uint64_t* full,
                                       uint64_t* empty, int it,
                                       const unsigned char* src, int bytes) {
  const int st = it % FW_NS;
  mbar_wait(empty + st, ((it / FW_NS) & 1) ^ 1);
  mbar_expect_tx(full + st, bytes);
  bulk_g2s(ring + st * FW_STAGE, src, bytes, full + st);
}

__device__ __forceinline__ void fw_producer(const FwDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    for (int l = 0; l + 1 < d.L; ++l)
      for (int s = 0; s < (l ? 8 : 2); ++s, ++it)
        fw_put(ring, full, empty, it, d.fpack + d.f_off[l] + s * FW_STAGE,
               FW_STAGE);
    for (int l = d.L - 1; l >= 0; --l)
      for (int s = 0; s < 8 + (d.outs[l] > 256); ++s, ++it)
        fw_put(ring, full, empty, it, d.rpack + d.r_off[l] + s * d.r_bytes[l],
               d.r_bytes[l]);
  }
}

// A sweep product's k-step: m64n128 (a hidden or last layer's half) or
// m64n24 (layer 0's r W, half of the encoding's 48 columns)
template <int N>
__device__ __forceinline__ void tf32_mma(float (&acc)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int keep) {
  if constexpr (N == 128) wgmma_tf32_n128(acc, a, b, keep);
  else wgmma_tf32_n24(acc, a, b, keep);
}

template <int N>
__device__ __forceinline__ void tf32_mma_ss(float (&acc)[N / 2], uint64_t a,
                                            uint64_t b, int keep) {
  if constexpr (N == 128) wgmma_tf32_ss_n128(acc, a, b, keep);
  else wgmma_tf32_ss_n24(acc, a, b, keep);
}

// One slab of a layer's product into the running sum run: its NK k-steps
// (A tile k-steps kk0 .. kk0 + NK - 1) against ring slab it (cols columns,
// big then small; this consumer's N from column n0), each k-step small_x
// big_w + big_x small_w + big_x big_w into a fresh accumulator, then,
// once the products have retired (the slab's stage released), added to
// run (FIRST: run = acc).
template <int N, int NK, bool FIRST>
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
  const uint32_t sb = smem_u32(ring + st * FW_STAGE);
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

// The extra k-step of a last layer over 256 wide (its outputs 256 .. 263,
// k slots 256 .. 263 of ring slab it): A from registers, xr its raw f32
// values, both halves; added to run as a slab of its own.
template <int N>
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
  const uint32_t sb = smem_u32(ring + st * FW_STAGE);
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
  for (int i = 0; i < N / 2; ++i) run[i] += acc[i];
}

// A whole layer's product from ring slab it on: NSLAB slabs of 4 k-steps
// (the last LASTK), with EXTRA one more from registers.
template <int N, int NSLAB, int LASTK, bool EXTRA>
__device__ __forceinline__ void fw_layer(int it, unsigned char* ring,
                                         uint64_t* full, uint64_t* empty,
                                         uint32_t atile, int cols, int n0,
                                         float (&acc)[N / 2],
                                         float (&run)[N / 2],
                                         const uint32_t (&xr)[4],
                                         const unsigned char* at, int w,
                                         int g, int t, int lead) {
  fw_slab<N, NSLAB == 1 ? LASTK : 4, true>(it, ring, full, empty, atile, 0,
                                           cols, n0, acc, run, at, w, g, t,
                                           lead);
#pragma unroll
  for (int s = 1; s < NSLAB; ++s) {
    if (s + 1 < NSLAB)
      fw_slab<N, 4, false>(it + s, ring, full, empty, atile, 4 * s, cols, n0,
                           acc, run, at, w, g, t, lead);
    else
      fw_slab<N, LASTK, false>(it + s, ring, full, empty, atile, 4 * s, cols,
                               n0, acc, run, at, w, g, t, lead);
  }
  if constexpr (EXTRA)
    fw_slab_regs<N>(it + NSLAB, ring, full, empty, cols, n0, acc, run, xr,
                    lead);
}

// Writes value v of (row r, column c) into the A tile (c's k slot).
__device__ __forceinline__ void at_put(unsigned char* at, int r, int c,
                                       float v) {
  *(float*)(at + at_byte(r, (c & ~7) + ((c & 7) >> 1) + ((c & 1) << 2))) = v;
}

// A consumer's 128 columns of a layer result in run (primal row 16w + g,
// tangent row 16w + 8 + g: run[4q + e], run[4q + 2 + e] at column n0 + 8q
// + 2t + e) into the A tile.
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

// The sum over the warp's 8 lane groups of run[4q + e] (the primal rows)
// by a transposing shuffle reduction (wg_bwd.cuh's gw_db_reduce on 16
// column groups): after it, run[32 m + e] holds column 64 m + 8 g + 2 t + e
// of the consumer's 128 (m < 2).
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

// R_l in run: its A tile (after the barrier that frees it), its tile image,
// its primal rows' column sums added to the warp's db slot
// row sl (set on the block's first tile); then the barrier before the next
// products, the tile fenced to the async proxy.
__device__ __forceinline__ void fw_r_finish(float (&run)[64],
                                            unsigned char* at, float* im,
                                            int C, float* sl, bool first,
                                            int n0, int w, int g, int t) {
  bar_sync(1, 256);
  at_store(at, run, n0, w, g, t);
  img_store(im, run, n0, C, w, g, t);
  fw_db_reduce(run, g);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float2* o = (float2*)(sl + n0 + 64 * m + 8 * g + 2 * t);
    const float2 v = make_float2(run[32 * m], run[32 * m + 1]);
    *o = first ? v : make_float2(o->x + v.x, o->y + v.y);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(1, 256);
}

__device__ __forceinline__ void fw_consumer(const FwDims& d, int c,
                                            unsigned char* ring,
                                            unsigned char* at, float* E,
                                            float* RE, uint64_t* full,
                                            uint64_t* empty) {
  const int ctid = threadIdx.x, tid = ctid & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int pt = 8 * w + g;                     // this thread's point
  const int lead = lane == 0;
  const int n0 = 128 * c;                       // its output columns
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int L = d.L, lL = L - 1, N = d.outs[lL], de = d.d_embed;
  const uint32_t atile = smem_u32(at);
  float4* scr = (float4*)d.scratch + (size_t)blockIdx.x * lL * 16 * 256 + ctid;
  float* dbw = d.dbp + ((size_t)blockIdx.x * 4 + w) * L * GW_BW;
  float* ep = E + pt * 2 * FW_EW;
  float* et = ep + FW_EW;
  float* rp = RE + pt * 2 * FW_EW;
  float* rt = rp + FW_EW;
  float acc[64], run[64];
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  int it = 0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int P = tile * FW_PTS + pt;
    const bool valid = P < d.n;
    // the encoding and its tangent, and zero cotangents (both consumers
    // are done with the last tile's)
    bar_sync(1, 256);
    if (ctid < FW_PTS) {
      const int row = tile * FW_PTS + ctid;
      float u[3], v[3];
      for (int k = 0; k < 3; ++k) {
        u[k] = row < d.n ? d.x[(size_t)row * 3 + k] * d.scale : 0.f;
        v[k] = row < d.n ? d.ct_g[(size_t)row * 3 + k] * d.scale : 0.f;
      }
      float* e = E + ctid * 2 * FW_EW;
      encode_row(u, v, d.multires, e, e + FW_EW);
      for (int k = de; k < FW_EW; ++k) e[k] = e[FW_EW + k] = 0.f;
      for (int k = 0; k < 2 * FW_EW; ++k) RE[ctid * 2 * FW_EW + k] = 0.f;
    }
    bar_sync(1, 256);
    // X_0: the encoding's 64 columns (zero from d_embed on), consumer 0's
    {
      if (c == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * q + 2 * t + e;
            run[4 * q + e] = k < FW_EW ? ep[k] : 0.f;
            run[4 * q + 2 + e] = k < FW_EW ? et[k] : 0.f;
          }
#pragma unroll
        for (int i = 32; i < 64; ++i) run[i] = 0.f;
        float* x0 = d.img + d.x_img[0] + (size_t)tile * 2 * 64 * 32;
        const int r = 16 * w + g;
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * q + 2 * t + e;
            at_put(at, r, k, run[4 * q + e]);
            at_put(at, r + 8, k, run[4 * q + 2 + e]);
            x0[img_at(r, k, 64)] = run[4 * q + e];
            x0[img_at(r + 8, k, 64)] = run[4 * q + 2 + e];
          }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // the stacked forward, layers 0 .. L - 2
    for (int l = 0; l < lL; ++l) {
      if (l == 0) {
        fw_layer<128, 2, 2, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 2;
      } else {
        fw_layer<128, 8, 4, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 8;
      }
      // bias + softplus and sigma(100 a) ad (x 1/sqrt 2 before a skip, the
      // encoding after h there); sigma(100 a) and ad to the scratch
      const float* bl = d.b[l];
      const int W = d.outs[l];
      const bool skip = d.enc[l + 1];
      const float post = skip ? inv_sqrt2 : 1.f;
      float4* sl = scr + l * 16 * 256;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        float s2[2], ad2[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * q + 2 * t + e;
          const float a = run[4 * q + e] + (col < W ? __ldg(bl + col) : 0.f);
          const float ad = run[4 * q + 2 + e];
          float sp, s;
          sp_sig100(a, sp, s);
          s2[e] = s;
          ad2[e] = ad;
          float h = sp * post, hd = s * ad * post;
          if (col >= W) {
            const int k = col - W;
            h = skip && k < de ? ep[k] * inv_sqrt2 : 0.f;
            hd = skip && k < de ? et[k] * inv_sqrt2 : 0.f;
          }
          run[4 * q + e] = h;
          run[4 * q + 2 + e] = hd;
        }
        sl[q * 256] = make_float4(s2[0], s2[1], ad2[0], ad2[1]);
      }
      img_store(d.img + d.x_img[l + 1] + (size_t)tile * 2 * 256 * 32, run,
                n0, 256, w, g, t);
      bar_sync(1, 256);
      at_store(at, run, n0, w, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // the seeds: ct_out (column 0 / scale) on the primal rows, e0 / scale
    // on the tangent rows; a last layer over 256 wide has its columns 256
    // on in xr (the last k-step, from registers; consumer 1's image and db)
    uint32_t xr[4] = {0u, 0u, 0u, 0u};
    {
      const float* co = d.ct_out + (size_t)P * N;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * q + 2 * t + e;
          run[4 * q + e] =
              valid && col < N ? co[col] * (col == 0 ? inv_scale : 1.f) : 0.f;
          run[4 * q + 2 + e] = valid && col == 0 ? inv_scale : 0.f;
        }
      float* im = d.img + d.r_img[lL] + (size_t)tile * 2 * d.cr[lL] * 32;
      if (N > 256) {
        float xv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 256 + 2 * t + e;
          xv[e] = valid && col < N ? co[col] : 0.f;
        }
        xr[0] = __float_as_uint(xv[0]);
        xr[2] = __float_as_uint(xv[1]);
        if (c == 1) {
          const int r = 16 * w + g;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 256 + 2 * t + e;
            im[img_at(r, col, d.cr[lL])] = xv[e];
            im[img_at(r + 8, col, d.cr[lL])] = 0.f;
            // db's column 256 + 2t + e: summed over the warp's points
            float v = xv[e];
#pragma unroll
            for (int s = 4; s < 32; s <<= 1)
              v += __shfl_xor_sync(0xffffffffu, v, s);
            float* o = dbw + lL * GW_BW + col;
            if (g == 0) *o = first ? v : *o + v;
          }
        }
      }
      fw_r_finish(run, at, im, d.cr[lL], dbw + lL * GW_BW, first, n0, w, g,
                  t);
    }

    // the reverse sweep: r W of layer l, then layer l - 1's step (its
    // scratch on its way to L2 while the products run)
    for (int l = lL; l >= 1; --l) {
      l2_prefetch_if(scr - ctid + (l - 1) * 16 * 256, 16 * 256 * 16,
                     ctid == 0);
      if (l == lL && N > 256) {
        fw_layer<128, 8, 4, true>(it, ring, full, empty, atile, 256, n0, acc,
                                  run, xr, at, w, g, t, lead);
        it += 9;
      } else {
        fw_layer<128, 8, 4, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 8;
      }
      // with a skip (layer l reads [h | enc] / sqrt 2), R_in / sqrt 2 and
      // its encoding columns (W on) added to the point's RE rows; then h =
      // sp(a), hd = sigma(100 a) ad: r = r_h s + rd_h ds ad, rd = rd_h s,
      // zero from column W on
      const float4* sl = scr + (l - 1) * 16 * 256;
      const int W = d.outs[l - 1];
      const bool skip = d.enc[l];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float4 v = sl[q * 256];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * q + 2 * t + e;
          float rh = run[4 * q + e], rdh = run[4 * q + 2 + e];
          if (skip) {
            rh *= inv_sqrt2;
            rdh *= inv_sqrt2;
            if (col >= W && col < W + de) {
              rp[col - W] += rh;
              rt[col - W] += rdh;
            }
          }
          const float s = e ? v.y : v.x, ad = e ? v.w : v.z;
          const float ds = 100.f * s * (1.f - s);
          const bool in = col < W;
          run[4 * q + e] = in ? rh * s + rdh * ds * ad : 0.f;
          run[4 * q + 2 + e] = in ? rdh * s : 0.f;
        }
      }
      fw_r_finish(run, at,
                  d.img + d.r_img[l - 1] + (size_t)tile * 2 * 256 * 32, 256,
                  dbw + (l - 1) * GW_BW, first, n0, w, g, t);
    }
    {
      // layer 0: r W_0, the encoding's cotangents (consumer c its 24
      // columns)
      float acc24[12], run24[12];
      fw_layer<24, 8, 4, false>(it, ring, full, empty, atile, 48, 24 * c,
                                acc24, run24, none, at, w, g, t, lead);
      it += 8;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 24 * c + 8 * q + 2 * t + e;
          if (col < de) {
            rp[col] += run24[4 * q + e];
            rt[col] += run24[4 * q + 2 + e];
          }
        }
    }
    bar_sync(1, 256);
    if (ctid < FW_PTS) {
      const int row = tile * FW_PTS + ctid;
      if (row < d.n) {
        float u[3], v[3], ct[3];
        for (int k = 0; k < 3; ++k) {
          u[k] = d.x[(size_t)row * 3 + k] * d.scale;
          v[k] = d.ct_g[(size_t)row * 3 + k] * d.scale;
        }
        const float* r = RE + ctid * 2 * FW_EW;
        encode_backward_row(u, v, d.multires, r, r + FW_EW, ct);
        for (int k = 0; k < 3; ++k)
          d.ct_x[(size_t)row * 3 + k] = ct[k] * d.scale;
      }
    }
  }
}

__global__ void __launch_bounds__(384, 1)
geometry_bwd_wgf_sweep(const __grid_constant__ FwDims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* at = ring + FW_NS * FW_STAGE;
  float* E = (float*)(at + 64 * 256 * 4);
  float* RE = E + FW_PTS * 2 * FW_EW;
  uint64_t* full = (uint64_t*)(RE + FW_PTS * 2 * FW_EW);
  uint64_t* empty = full + FW_NS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  // the A tile's columns past a layer's width are read: finite from the
  // start
  for (int i = threadIdx.x; i < 64 * 256; i += blockDim.x)
    ((float*)at)[i] = 0.f;
  __syncthreads();
  if (threadIdx.x >= 256) {
    regs_dec<24>();
    if (threadIdx.x == 256) fw_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    fw_consumer(d, threadIdx.x >> 7, ring, at, E, RE, full, empty);
  }
}

// -- the weight-gradient pass ------------------------------------------------

struct FwgDims {
  int n_img, per, S, ns, stage_bytes;
  const float* img;
  float* part;
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // floats
  int cx[GW_MAXL], cr[GW_MAXL];
  int u_layer[FW_MAXU], u_pair[FW_MAXU], u_half[FW_MAXU];
};

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

// A consumer's chunk: X block w of the stage (A: big from shared memory,
// small from registers) against R's half (B: big and small, from shared
// memory, once the stage is ready; TAIL: its columns 128 on by m64n8), a
// fresh accumulator a stage, added to run; then run to the chunk's slot.
template <bool TAIL>
__device__ __forceinline__ void fwg_consumer(const FwgDims& d, int nh, int w,
                                             int t0, int t1,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             uint64_t* ready, float* slot) {
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
      wgmma_tf32_n128(acc, sm[j], rb + 2 * j, j ? 1 : 0);
      wgmma_tf32_ss_n128(acc, xa + 2 * j, rs + 2 * j, 1);
      wgmma_tf32_ss_n128(acc, xa + 2 * j, rb + 2 * j, 1);
      if constexpr (TAIL) {
        const uint64_t tb = rb + (128 * 128 >> 4), ts = rs + (128 * 128 >> 4);
        wgmma_tf32_n8(acc8, sm[j], tb + 2 * j, j ? 1 : 0);
        wgmma_tf32_ss_n8(acc8, xa + 2 * j, ts + 2 * j, 1);
        wgmma_tf32_ss_n8(acc8, xa + 2 * j, tb + 2 * j, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (TAIL) fence_regs(acc8);
    mbar_arrive_if(empty + st, lead);
#pragma unroll
    for (int i = 0; i < 64; ++i) run[i] += acc[i];
    if constexpr (TAIL)
#pragma unroll
      for (int i = 0; i < 4; ++i) run8[i] += acc8[i];
  }
  const int m = 16 * wp + g;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    *(float2*)(slot + m * FW_SN + 8 * q + 2 * t) =
        make_float2(run[4 * q], run[4 * q + 1]);
    *(float2*)(slot + (m + 8) * FW_SN + 8 * q + 2 * t) =
        make_float2(run[4 * q + 2], run[4 * q + 3]);
  }
  if constexpr (TAIL) {
    *(float2*)(slot + m * FW_SN + 128 + 2 * t) = make_float2(run8[0], run8[1]);
    *(float2*)(slot + (m + 8) * FW_SN + 128 + 2 * t) =
        make_float2(run8[2], run8[3]);
  }
}

__global__ void __launch_bounds__(384, 1)
geometry_bwd_wgf_wgrad(const __grid_constant__ FwgDims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  uint64_t* full = (uint64_t*)(ring + (size_t)d.ns * d.stage_bytes);
  uint64_t* empty = full + d.ns;
  uint64_t* ready = empty + d.ns;
  const int u = blockIdx.x / d.S, ch = blockIdx.x - u * d.S;
  const int l = d.u_layer[u], pr = d.u_pair[u], h = d.u_half[u];
  const int nh = h ? d.cr[l] - 128 : 128;
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
      fwg_consumer<true>(d, nh, wg, t0, t1, ring, full, empty, ready, slot);
    else
      fwg_consumer<false>(d, nh, wg, t0, t1, ring, full, empty, ready,
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
};

// grads[j]: per layer dW [in][out] (the sum of its chunks' slots, in
// order), then db [out] (the sum of the warps' slots, in order)
__global__ void geometry_bwd_wgf_reduce(const __grid_constant__ FrDims r) {
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
    const int i = (int)(j / out), o = (int)(j - (long long)i * out);
    const int h = o >= 128, n = o - 128 * h;
    const int u = r.u_first[l] + 2 * (i >> 7) + h, w = (i >> 6) & 1;
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

// Integer arguments: [L, multires, d_embed, n, grid, n_tiles, S, per, then
// per layer ins[L], outs[L], enc[L], f_off[L], r_off[L], r_cols[L]]
// (ops/geometry_kernel.bwd_wg_iargs: the two f32 slab packs' layouts,
// tc_pack.pack_sweep_f32 and pack_rev_f32; S chunks of per tiles for the
// weight-gradient pass).  Pointers: [x, ct_out, ct_grad, ct_x, scratch,
// images, db slots, dW slots, grads, forward pack, reverse pack, b[L]];
// grads receives, per layer, dW as [in][out] followed by db [out].
// Returns a cudaError_t value; 0 when the three launches were accepted.
extern "C" int geometry_bwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  FwDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_embed = ia[2];
  d.n = ia[3];
  const int grid = ia[4];
  d.n_tiles = ia[5];
  const int S = ia[6], per = ia[7];
  const int L = d.L, de = d.d_embed;
  if (L < 2 || L > GW_MAXL || de > FW_EW || de != 3 * (1 + 2 * d.multires) ||
      grid < 1 || d.n_tiles < 1 || S < 1 || per < 1 ||
      (long long)d.n_tiles * FW_PTS < d.n)
    return (int)cudaErrorInvalidValue;
  d.scale = scale;
  d.x = (const float*)p[0];
  d.ct_out = (const float*)p[1];
  d.ct_g = (const float*)p[2];
  d.ct_x = (float*)p[3];
  d.scratch = (float*)p[4];
  d.img = (float*)p[5];
  d.dbp = (float*)p[6];
  d.fpack = (const unsigned char*)p[9];
  d.rpack = (const unsigned char*)p[10];
  const int* q = ia + 8;
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    d.ins[l] = q[l];
    d.outs[l] = q[L + l];
    d.enc[l] = q[2 * L + l];
    d.f_off[l] = q[3 * L + l];
    d.r_off[l] = q[4 * L + l];
    const int r_cols = q[5 * L + l];
    d.r_bytes[l] = 2 * r_cols * 128;
    d.b[l] = (const float*)p[11 + l];
    const bool last = l == L - 1;
    // layer 0 reads the encoding alone, a skip layer [h | enc] in W's own
    // column order, the last layer h alone
    if (d.ins[l] > (l ? 256 : de) || d.outs[l] > (last ? 264 : 256) ||
        d.outs[l] < 1 || (d.enc[l] != 0 && d.enc[l] != 1) || !d.enc[0] ||
        d.ins[0] != de || (last && d.enc[l]) || r_cols != (l ? 256 : 48) ||
        d.f_off[l] % 1024 || d.r_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
    if (l && d.ins[l] != d.outs[l - 1] + (d.enc[l] ? de : 0))
      return (int)cudaErrorInvalidValue;
    // a tile's images: X_l (64 columns for layer 0, 256 for the others),
    // R_l (256 columns, 264 for a last layer over 256 wide)
    d.cx[l] = l ? 256 : 64;
    d.cr[l] = d.outs[l] > 256 ? 264 : 256;
    d.x_img[l] = off;
    off += (long long)d.n_tiles * 2 * d.cx[l] * 32;
    d.r_img[l] = off;
    off += (long long)d.n_tiles * 2 * d.cr[l] * 32;
  }
  const size_t smem = 1024 + (size_t)FW_NS * FW_STAGE + 64 * 256 * 4 +
                      2 * FW_PTS * 2 * FW_EW * 4 + 2 * FW_NS * 8;
  cudaError_t e = cudaFuncSetAttribute(
      geometry_bwd_wgf_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  geometry_bwd_wgf_sweep<<<grid, 384, smem, s>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // the weight-gradient pass over the tiles that hold a point: units
  // (layer, X pair, R half) in that order
  FwgDims w;
  FrDims r;
  r.L = L;
  w.n_img = (d.n + FW_PTS - 1) / FW_PTS;
  w.per = per;
  w.S = r.S = S;
  w.img = d.img;
  w.part = (float*)p[7];
  if ((long long)S * per < w.n_img || (long long)(S - 1) * per >= w.n_img)
    return (int)cudaErrorInvalidValue;
  int nu = 0, widest = 0;
  for (int l = 0; l < L; ++l) {
    w.x_img[l] = d.x_img[l];
    w.r_img[l] = d.r_img[l];
    w.cx[l] = d.cx[l];
    w.cr[l] = d.cr[l];
    r.ins[l] = d.ins[l];
    r.outs[l] = d.outs[l];
    r.u_first[l] = nu;
    for (int pr = 0; 128 * pr < d.cx[l]; ++pr)
      for (int h = 0; h < 2; ++h) {
        if (nu == FW_MAXU) return (int)cudaErrorInvalidValue;
        w.u_layer[nu] = l;
        w.u_pair[nu] = pr;
        w.u_half[nu] = h;
        const int nh = h ? d.cr[l] - 128 : 128;
        const int sb = 2 * nh * 128 + min(128, d.cx[l] - 128 * pr) * 128;
        widest = widest > sb ? widest : sb;
        ++nu;
      }
  }
  w.stage_bytes = (widest + 1023) / 1024 * 1024;
  const int wns = (int)((GW_SMEM_MAX - 1024) / ((size_t)w.stage_bytes + 24));
  w.ns = wns < GW_MAX_NS ? wns : GW_MAX_NS;
  if (w.ns < 2) return (int)cudaErrorInvalidValue;
  const size_t wsmem = 1024 + (size_t)w.ns * (w.stage_bytes + 24);
  e = cudaFuncSetAttribute(geometry_bwd_wgf_wgrad,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wsmem);
  if (e != cudaSuccess) return (int)e;
  geometry_bwd_wgf_wgrad<<<nu * S, 384, wsmem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  r.n_wslots = grid * 4;
  r.part = w.part;
  r.dbp = d.dbp;
  r.grads = (float*)p[8];
  r.P = 0;
  for (int l = 0; l < L; ++l)
    r.P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
  const int rb = 256;
  geometry_bwd_wgf_reduce<<<(int)((r.P + rb - 1) / rb), rb, 0, s>>>(r);
  return (int)cudaGetLastError();
}

// The sweep's and the weight-gradient pass's attributes as the device
// holds them, read after a launch: out[3 i .. 3 i + 2] = registers a
// thread, dynamic shared memory a block (as the launcher last set it),
// static shared memory, for i = 0 (sweep) and 1 (weight-gradient pass).
// Returns a cudaError_t value.
extern "C" int geometry_bwd_attrs(int* out) {
  const void* fns[2] = {(const void*)geometry_bwd_wgf_sweep,
                        (const void*)geometry_bwd_wgf_wgrad};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fns[i]);
    if (e != cudaSuccess) return (int)e;
    out[3 * i] = a.numRegs;
    out[3 * i + 1] = a.maxDynamicSharedSizeBytes;
    out[3 * i + 2] = (int)a.sharedSizeBytes;
  }
  return 0;
}
