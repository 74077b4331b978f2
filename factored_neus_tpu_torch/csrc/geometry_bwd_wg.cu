// K1-bwd: the backward of K1-fwd in f32, on Hopper's warpgroup tensor
// cores in 3xTF32 (wgmma.cuh; the f32 engine's pieces, the pass and the
// reduce in wgf.cuh, shared with K1-fwd and K3-bwd).  Replaces the TPU kernel
// factored_neus_tpu/ops/pallas_geometry.py _make_geom.run_bwd (body
// _build_bwd_kernel_stacked, f32 products): the primal forward and a
// forward tangent along ct_grad recomputed as stacked rows (primal: bias
// and softplus(beta=100); tangent: sigma(100 a) ad), both chains swept in
// reverse from the seeds ct_out (column 0 / scale) and e0 / scale, dW =
// X^T R summed over every stacked row, db the sum of the primal R, ct_x
// through the encoding's backward (the eikonal Hessian-vector term
// included).  Every product runs in 3xTF32: small_a big_b + big_a small_b
// + big_a big_b, 8 k an instruction (tc_pack.mm_3xtf32 emulates it);
// everything elementwise stays f32.
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
//      k).  A k-step is three products, in the order above.
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
// 2. The weight-gradient pass (geometry_bwd_wgf_wgrad, wgf.cuh's
//    wgf_wgrad_body): dW_l = X_l^T R_l over all stacked rows, split over K.  A
//    block takes a unit (a layer, a pair of 64-column blocks of X_l, a
//    128-column half of R_l) and a chunk of tiles; its producer streams each
//    tile's half-images (32 rows a stage: R_l's half and X_l's pair) into a
//    ring; three more warps of the producer warpgroup write each stage's R -
//    trunc(R) beside it (the B operand's small half must be in shared memory
//    too), fence it to the async proxy and mark the stage ready; its two
//    consumers (one an X block) run wgmma m64n128k8 (+ m64n8k8 for outputs 256
//    .. 263) with A = X^T from shared memory (big) and registers (small, made
//    from the same tile) and B = R (big and small) from shared memory.  Each
//    stage sums into a fresh accumulator and is added to the consumer's
//    running sum with rounded adds (as the sweep); the running sum is stored
//    to the chunk's f32 slot.
// 3. The reduce (geometry_bwd_wgf_reduce, wgf_reduce_body): dW the sum of the
//    chunks' slots and db of the warps' slots, each in a fixed order.  No
//    float atomics: two launches are bitwise equal.
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
#include "wgf.cuh"

#define FW_PTS 32          // points of a tile (64 stacked rows)
#define FW_EW 48           // row (floats) of the encoding tiles

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

// -- the sweep ---------------------------------------------------------------

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

// -- the weight-gradient pass and the reduce (wgf.cuh) -----------------------

__global__ void __launch_bounds__(384, 1)
geometry_bwd_wgf_wgrad(const __grid_constant__ FwgDims d) {
  extern __shared__ unsigned char smem_raw[];
  wgf_wgrad_body(d, smem_raw);
}

__global__ void geometry_bwd_wgf_reduce(const __grid_constant__ FrDims r) {
  wgf_reduce_body(r);
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
  for (int l = 0; l < L; ++l) {
    w.x_img[l] = d.x_img[l];
    w.r_img[l] = d.r_img[l];
    w.cx[l] = d.cx[l];
    w.cr[l] = d.cr[l];
    r.ins[l] = d.ins[l];
    r.outs[l] = d.outs[l];
    r.xn[l] = r.xn_at[l] = 0;
  }
  size_t wsmem;
  int nu;
  const int rc = wgf_plan_pass(L, &w, &r, &wsmem, &nu);
  if (rc) return rc;
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
