// K3-bwd: the backward of K3-fwd in f32, on Hopper's warpgroup tensor cores
// in 3xTF32 (wgmma.cuh; the f32 engine of wgf.cuh, which K1-bwd and K1-fwd
// share).  Replaces the TPU kernel factored_neus_tpu/ops/pallas_radiance.py
// _make_radiance(cfg, bf16=False).run_bwd (body _build_bwd_kernel, f32
// products): the forward recomputed (x0 = [pts | PE(dirs) | normals |
// feat], ReLU layers, the last layer's sigmoid), the seed r = ct_rgb y (1 -
// y), then for each layer from the last dW_l = X_l^T R_l, db_l the sum of
// r, r_in = r W_l and r = r_in where a_{l-1} > 0; x0's cotangent split into
// pts, normals, feat and, through the encoding's Jacobian, dirs.  Every
// product runs in 3xTF32 (small_x big_w + big_x small_w + big_x big_w, 8 k
// an instruction); everything elementwise stays f32.
//
// Bound: operations, 6 x 271,360 FLOP a row at full width, three TF32
// products' worth over 495 TFLOP/s (0.647 ms at 65,536 rows).  Three
// kernels, launched one after another, as K1-bwd's (geometry_bwd_wg.cu),
// with K3-bwd-bf16's plan (radiance_bwd_bf16_wg.cu) for what differs:
//
// 1. The sweep (radiance_bwd_wgf_sweep).  A block is two consumer
//    warpgroups (warps 0-7) and a producer warpgroup (8-11, one thread of
//    which issues the copies; setmaxnreg gives the consumers 240 registers
//    a thread), persistent over tiles blockIdx.x, + gridDim.x, ...; a tile
//    is 64 rows (warp w: rows 16w + g and 16w + 8 + g), and consumer c
//    takes the output columns 128c .. 128c + 127 of every product
//    (m64n128k8; the narrow columns' r W_0 m64n24k8; the last layer
//    m64n8k8, both consumers alike).
//    - The layer input lives in shared memory as an f32 K-major,
//      128-byte-swizzled A tile (wgf.cuh), 320 k wide: layer 0 reads the
//      feature's 256 k and, at k 256 on, the narrow columns [pts | PE(dirs)
//      | normals] (at most 48, from a small per-row tile), ten 32-k slabs
//      in all, the last two k-steps deep; the tensor core reads big_x
//      from it, small_x is made in registers a slab at a time.  The
//      weights stream as 32-k slabs of TF32 big and small halves
//      (tc_pack.pack_rad_sweep_f32 for X W, pack_rad_rev_f32 for r W, k
//      permuted by tc_pack.tf32_slot), two 64 KB stages, each slab's
//      products into a fresh accumulator added to the running sum with
//      rounded adds (the accumulator truncates).
//    - No scratch.  The ReLU mask a_l > 0 is taken in f32 in the forward
//      and kept as bits in registers: 64 accumulator values a thread a
//      layer, 2 words, at most RF_MAXH hidden layers; the reverse applies
//      it to the f32 r_in.  That is JAX's relu_mask exactly; nothing is
//      recomputed.
//    - The seed: the 3-wide last layer on m64n8 (its 8 k-steps' slabs 8
//      columns wide), y = sigmoid(a), r = ct_rgb y (1 - y) in registers;
//      its r W is one k-step from registers (fw_slab_regs).
//    - Layer 0's reverse: r W_0 for the feature's 256 columns (written out
//      as ct_feat from the accumulator) and, from 48-column slabs, the
//      narrow ones (m64n24 a consumer) into the narrow tile, then the
//      encoding's Jacobian per row into ct_dirs, and ct_pts, ct_normals.
//    - X_l (forward) and R_l (reverse) go to device memory as f32 tile
//      images, K-major over the tile's rows (wgf.cuh's img_at): X_0 320
//      columns (the feature's, then the narrow ones at 256), the others
//      256, R of the last layer 8.
//    - db: each layer's r, a thread's two rows added, summed over the
//      warp's lane groups by the transposing shuffle (fw_db_reduce), added
//      to the warp's own slot row, tile after tile.
//    - Between layers, two named barriers over the two consumers: every
//      product of the layer has read the A tile before it is overwritten,
//      and the new tile is written (and fenced to the async proxy) before
//      any product reads it.
// 2. The weight-gradient pass (radiance_bwd_wgf_wgrad, wgf.cuh's
//    wgf_wgrad_body, K1-bwd's): dW_l = X_l^T R_l over every row, split over
//    K, units of (layer, 128-column X pair, R half): layer 0 three X pairs
//    (the last the narrow columns' 64), the last layer one R "half" of 8
//    columns (m64n8k8 alone).
// 3. The reduce (radiance_bwd_wgf_reduce, wgf_reduce_body): dW the sum of
//    the chunks' slots (dW_0's narrow rows read from image column 256 on),
//    db of the warps' slots, each in a fixed order.  No float atomics: two
//    launches are bitwise equal.
//
// Bytes at full width, 65,536 rows (1,024 tiles): the images 512 KB a tile
// written (X 80 + 4 x 64 KB, R 4 x 64 + 2 KB: 0.61 GB) and read by the
// pass, X_l once for each R half and R_l once for each X pair (1.34 GB),
// the inputs (feat and 9 narrow columns f32, ct_rgb: 70 MB) and the
// outputs (ct_feat and 9 narrow columns: 70 MB), slots and db slots ~10
// MB: ~2.1 GB, ~0.63 ms at 3.35 TB/s (chip_smoke.py counts it).  From L2,
// every tile streams 83 slabs (5.3 MB; 5.4 GB a call).  The products need
// 0.65 ms.
#include "sdf_mlp.cuh"
#include "wgf.cuh"

#define RF_TILE 64         // rows of a tile
#define RF_EW 48           // row (floats) of the narrow-column tile
#define RF_AK 320          // k of the A tile: the feature's 256, the narrow 64
#define RF_MAXH 4          // most hidden layers (their masks in registers)
#define RF_NARROW 12288    // bytes of a reverse layer-0 narrow slab (48 cols)
#define RF_LAST 2048       // bytes of a forward last-layer slab (8 columns)

struct RfDims {
  int L, multires, d_view, nar, d_feat, d_out, n, n_tiles, squeeze;
  const float *pts, *nrm, *dirs, *feat, *ct_rgb;
  float *ct_pts, *ct_nrm, *ct_dirs, *ct_feat, *dbp, *img;
  uint32_t* masks;         // the ReLU masks' bits, or null
  const unsigned char *fpack, *rpack;
  int outs[GW_MAXL];
  int f_off[GW_MAXL], r_off[GW_MAXL];   // byte offsets of each layer's slabs
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // floats: tile 0's images
  int cx[GW_MAXL], cr[GW_MAXL];               // their columns
  const float* b[GW_MAXL];
};

// -- the sweep ---------------------------------------------------------------

// A tile's slabs: forward layer 0 (ten), each hidden layer (eight), the last
// layer (eight of 8 columns); reverse the last layer (one), each hidden
// layer (eight), layer 0 (eight of 256 columns, eight of 48)
__device__ __forceinline__ void rf_producer(const RfDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  const int lL = d.L - 1;
  int it = 0;
  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    for (int l = 0; l < lL; ++l)
      for (int s = 0; s < (l ? 8 : 10); ++s, ++it)
        fw_put(ring, full, empty, it, d.fpack + d.f_off[l] + s * FW_STAGE,
               FW_STAGE);
    for (int s = 0; s < 8; ++s, ++it)
      fw_put(ring, full, empty, it, d.fpack + d.f_off[lL] + s * RF_LAST,
             RF_LAST);
    fw_put(ring, full, empty, it++, d.rpack + d.r_off[lL], FW_STAGE);
    for (int l = lL - 1; l >= 0; --l)
      for (int s = 0; s < 8; ++s, ++it)
        fw_put(ring, full, empty, it, d.rpack + d.r_off[l] + s * FW_STAGE,
               FW_STAGE);
    for (int s = 0; s < 8; ++s, ++it)
      fw_put(ring, full, empty, it,
             d.rpack + d.r_off[0] + 8 * FW_STAGE + s * RF_NARROW, RF_NARROW);
  }
}

// R_{l} in run: its A tile (after the barrier that frees it), its tile image,
// the column sums of its two rows added to the warp's db slot row sl (set
// on the block's first tile); then the barrier before the next products,
// the tile fenced to the async proxy.
__device__ __forceinline__ void rf_r_finish(float (&run)[64],
                                            unsigned char* at, float* im,
                                            float* sl, bool first, int n0,
                                            int w, int g, int t) {
  bar_sync(1, 256);
  at_store(at, run, n0, w, g, t);
  img_store(im, run, n0, 256, w, g, t);
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    run[4 * q] += run[4 * q + 2];
    run[4 * q + 1] += run[4 * q + 3];
  }
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

__device__ __forceinline__ void rf_consumer(const RfDims& d, int c,
                                            unsigned char* ring,
                                            unsigned char* at, float* E,
                                            uint64_t* full, uint64_t* empty) {
  const int ctid = threadIdx.x, tid = ctid & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  const int n0 = 128 * c;                       // its output columns
  const int L = d.L, lL = L - 1;
  const int rg = 16 * w + g;                    // its rows rg, rg + 8
  const uint32_t atile = smem_u32(at);
  float* dbw = d.dbp + ((size_t)blockIdx.x * 4 + w) * L * GW_BW;
  float acc[64], run[64];
  uint32_t mk[RF_MAXH][2];                      // the masks, the latest first
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  int it = 0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int row0 = tile * RF_TILE;
    const int R0 = row0 + rg, R1 = R0 + 8;
    const bool v0 = R0 < d.n, v1 = R1 < d.n;
    // the narrow columns [pts | PE(dirs) | normals | 0] of each row (both
    // consumers are done with the last tile's)
    bar_sync(1, 256);
    if (ctid < RF_TILE) {
      const int row = row0 + ctid;
      const bool valid = row < d.n;
      float* e = E + ctid * RF_EW;
      float u[3];
      for (int k = 0; k < 3; ++k) {
        e[k] = valid ? d.pts[(size_t)row * 3 + k] : 0.f;
        e[3 + d.d_view + k] = valid ? d.nrm[(size_t)row * 3 + k] : 0.f;
        u[k] = valid ? d.dirs[(size_t)row * 3 + k] : 0.f;
      }
      encode_row(u, nullptr, d.multires, e + 3, nullptr);
      for (int k = d.nar; k < RF_EW; ++k) e[k] = 0.f;
    }
    bar_sync(1, 256);
    // X_0: the feature's columns (this consumer's 128) from device memory,
    // and k 256 on the narrow ones (consumer c its 32), into the A tile and
    // the image
    {
      float* x0 = d.img + d.x_img[0] + (size_t)tile * 2 * RF_AK * 32;
      const float* f0 = d.feat + (size_t)R0 * d.d_feat;
      const float* f1 = d.feat + (size_t)R1 * d.d_feat;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int col = n0 + 8 * q + 2 * t;
        const bool in = col < d.d_feat;
        const float2 a = v0 && in ? __ldg((const float2*)(f0 + col))
                                  : make_float2(0.f, 0.f);
        const float2 b = v1 && in ? __ldg((const float2*)(f1 + col))
                                  : make_float2(0.f, 0.f);
        run[4 * q] = a.x;
        run[4 * q + 1] = a.y;
        run[4 * q + 2] = b.x;
        run[4 * q + 3] = b.y;
      }
      at_store(at, run, n0, w, g, t);
      img_store(x0, run, n0, RF_AK, w, g, t);
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 32 * c + 8 * q + 2 * t + e;
          const float a = j < RF_EW ? E[rg * RF_EW + j] : 0.f;
          const float b = j < RF_EW ? E[(rg + 8) * RF_EW + j] : 0.f;
          at_put(at, rg, 256 + j, a);
          at_put(at, rg + 8, 256 + j, b);
          x0[img_at(rg, 256 + j, RF_AK)] = a;
          x0[img_at(rg + 8, 256 + j, RF_AK)] = b;
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // the forward, layers 0 .. L - 2: a = X W + b, its mask, relu(a)
    for (int l = 0; l < lL; ++l) {
      if (l == 0) {
        fw_layer<128, 10, 2, false>(it, ring, full, empty, atile, 256, n0,
                                    acc, run, none, at, w, g, t, lead);
        it += 10;
      } else {
        fw_layer<128, 8, 4, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 8;
      }
      const float* bl = d.b[l];
      const int W = d.outs[l];
      uint32_t m[2] = {0u, 0u};
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e, col = n0 + 8 * q + 2 * t + (e & 1);
          const float a = run[i] + (col < W ? __ldg(bl + col) : 0.f);
          m[i >> 5] |= (a > 0.f ? 1u : 0u) << (i & 31);
          run[i] = fmaxf(a, 0.f);
        }
#pragma unroll
      for (int s = RF_MAXH - 1; s > 0; --s) {
        mk[s][0] = mk[s - 1][0];
        mk[s][1] = mk[s - 1][1];
      }
      mk[0][0] = m[0];
      mk[0][1] = m[1];
      if (d.masks)
        *(uint2*)(d.masks + (((size_t)tile * 256 + ctid) * lL + l) * 2) =
            make_uint2(m[0], m[1]);
      img_store(d.img + d.x_img[l + 1] + (size_t)tile * 2 * 256 * 32, run,
                n0, 256, w, g, t);
      bar_sync(1, 256);
      at_store(at, run, n0, w, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // the last layer (m64n8, both consumers) and the seed r = ct_rgb y (1 -
    // y): column 2t + (e % 2) of row rg (e < 2) or rg + 8, as the k-step's
    // A fragment xr (k slot t holds column 2t, t + 4 column 2t + 1)
    uint32_t xr[4];
    {
      float acc8[4], run8[4];
      fw_layer<8, 8, 4, false>(it, ring, full, empty, atile, 8, 0, acc8,
                               run8, none, at, w, g, t, lead);
      it += 8;
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t + (e & 1);
        const int row = e < 2 ? R0 : R1;
        float v = 0.f;
        if ((e < 2 ? v0 : v1) && col < d.d_out) {
          v = d.ct_rgb[(size_t)row * d.d_out + col];
          if (d.squeeze) {
            const float y =
                1.f / (1.f + expf(-(run8[e] + __ldg(d.b[lL] + col))));
            v = v * y * (1.f - y);
          }
        }
        r[e] = v;
      }
      xr[0] = __float_as_uint(r[0]);
      xr[1] = __float_as_uint(r[2]);
      xr[2] = __float_as_uint(r[1]);
      xr[3] = __float_as_uint(r[3]);
      if (c == 0) {
        // R's image of the last layer (8 columns) and db's columns 2t + e,
        // summed over the thread's rows and the warp's
        float* im = d.img + d.r_img[lL] + (size_t)tile * 2 * 8 * 32;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          im[img_at(rg, 2 * t + e, 8)] = r[e];
          im[img_at(rg + 8, 2 * t + e, 8)] = r[2 + e];
          float v = r[e] + r[2 + e];
#pragma unroll
          for (int s = 4; s < 32; s <<= 1)
            v += __shfl_xor_sync(0xffffffffu, v, s);
          float* o = dbw + lL * GW_BW + 2 * t + e;
          if (g == 0) *o = first ? v : *o + v;
        }
      }
    }

    // the reverse sweep: r W of layer l (the last layer's one k-step from
    // registers), then through layer l - 1's ReLU
    fw_slab_regs<128, true>(it, ring, full, empty, 256, n0, acc, run, xr,
                            lead);
    it += 1;
    for (int l = lL; l >= 1; --l) {
      if (l < lL) {
        fw_layer<128, 8, 4, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 8;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i)
        run[i] = (mk[0][i >> 5] >> (i & 31)) & 1u ? run[i] : 0.f;
#pragma unroll
      for (int s = 0; s + 1 < RF_MAXH; ++s) {
        mk[s][0] = mk[s + 1][0];
        mk[s][1] = mk[s + 1][1];
      }
      rf_r_finish(run, at,
                  d.img + d.r_img[l - 1] + (size_t)tile * 2 * 256 * 32,
                  dbw + (l - 1) * GW_BW, first, n0, w, g, t);
    }

    // layer 0: x0's cotangent r W_0, the feature's columns (written out),
    // then the narrow ones (consumer c its 24) into the narrow tile
    fw_layer<128, 8, 4, false>(it, ring, full, empty, atile, 256, n0, acc,
                               run, none, at, w, g, t, lead);
    it += 8;
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int col = n0 + 8 * q + 2 * t;
      if (col < d.d_feat) {
        if (v0)
          *(float2*)(d.ct_feat + (size_t)R0 * d.d_feat + col) =
              make_float2(run[4 * q], run[4 * q + 1]);
        if (v1)
          *(float2*)(d.ct_feat + (size_t)R1 * d.d_feat + col) =
              make_float2(run[4 * q + 2], run[4 * q + 3]);
      }
    }
    {
      float acc24[12], run24[12];
      fw_layer<24, 8, 4, false>(it, ring, full, empty, atile, 48, 24 * c,
                                acc24, run24, none, at, w, g, t, lead);
      it += 8;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 24 * c + 8 * q + 2 * t + e;
          E[rg * RF_EW + col] = run24[4 * q + e];
          E[(rg + 8) * RF_EW + col] = run24[4 * q + 2 + e];
        }
    }
    bar_sync(1, 256);
    if (ctid < RF_TILE) {
      const int row = row0 + ctid;
      if (row < d.n) {
        const float* r = E + ctid * RF_EW;
        float u[3], cd[3];
        for (int k = 0; k < 3; ++k) u[k] = d.dirs[(size_t)row * 3 + k];
        encode_backward_row(u, nullptr, d.multires, r + 3, nullptr, cd);
        for (int k = 0; k < 3; ++k) {
          d.ct_pts[(size_t)row * 3 + k] = r[k];
          d.ct_dirs[(size_t)row * 3 + k] = cd[k];
          d.ct_nrm[(size_t)row * 3 + k] = r[3 + d.d_view + k];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(384, 1)
radiance_bwd_wgf_sweep(const __grid_constant__ RfDims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* at = ring + FW_NS * FW_STAGE;
  float* E = (float*)(at + 64 * RF_AK * 4);
  uint64_t* full = (uint64_t*)(E + RF_TILE * RF_EW);
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
  for (int i = threadIdx.x; i < 64 * RF_AK; i += blockDim.x)
    ((float*)at)[i] = 0.f;
  __syncthreads();
  if (threadIdx.x >= 256) {
    regs_dec<24>();
    if (threadIdx.x == 256) rf_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    rf_consumer(d, threadIdx.x >> 7, ring, at, E, full, empty);
  }
}

// -- the weight-gradient pass and the reduce (wgf.cuh) -----------------------

__global__ void __launch_bounds__(384, 1)
radiance_bwd_wgf_wgrad(const __grid_constant__ FwgDims d) {
  extern __shared__ unsigned char smem_raw[];
  wgf_wgrad_body(d, smem_raw);
}

__global__ void radiance_bwd_wgf_reduce(const __grid_constant__ FrDims r) {
  wgf_reduce_body(r);
}

// Integer arguments: [L, multires, d_view, n, grid, n_tiles, S, per,
// squeeze_out, masks, then per layer ins[L], outs[L], f_off[L], r_off[L]]
// (ops/radiance_kernel.bwd_wg_plan: the f32 slab packs' layer offsets,
// tc_pack.rad_sweep_layout_f32 and rad_rev_layout_f32, whose slab counts
// and widths are this design's; S chunks of per tiles for the
// weight-gradient pass; masks nonzero: the sweep writes its ReLU masks'
// bits).  Pointers: [pts, normals, dirs, feat, ct_rgb, ct_pts, ct_normals,
// ct_dirs, ct_feat, images, db slots, dW slots, grads, forward pack,
// reverse pack, mask bits (read where masks), b[L]]; grads receives, per
// layer, dW as [in][out] followed by db [out].  Returns a cudaError_t
// value; 0 when the three launches were accepted.
extern "C" int radiance_bwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  (void)scale;
  RfDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_view = ia[2];
  d.n = ia[3];
  const int grid = ia[4];
  d.n_tiles = ia[5];
  const int S = ia[6], per = ia[7];
  d.squeeze = ia[8];
  const int want_masks = ia[9];
  const int L = d.L, lL = L - 1;
  const int* q = ia + 10;
  if (L < 2 || lL > RF_MAXH || d.d_view != 3 * (1 + 2 * d.multires) ||
      grid < 1 || d.n_tiles < 1 || S < 1 || per < 1 ||
      (long long)d.n_tiles * RF_TILE < d.n)
    return (int)cudaErrorInvalidValue;
  d.nar = 6 + d.d_view;
  d.d_feat = q[0] - d.nar;
  d.d_out = q[L + lL];
  if (d.nar > RF_EW || d.d_feat < 2 || d.d_feat > 256 || d.d_feat % 2 ||
      d.d_out > 8)
    return (int)cudaErrorInvalidValue;
  d.pts = (const float*)p[0];
  d.nrm = (const float*)p[1];
  d.dirs = (const float*)p[2];
  d.feat = (const float*)p[3];
  d.ct_rgb = (const float*)p[4];
  d.ct_pts = (float*)p[5];
  d.ct_nrm = (float*)p[6];
  d.ct_dirs = (float*)p[7];
  d.ct_feat = (float*)p[8];
  d.img = (float*)p[9];
  d.dbp = (float*)p[10];
  d.fpack = (const unsigned char*)p[13];
  d.rpack = (const unsigned char*)p[14];
  d.masks = want_masks ? (uint32_t*)p[15] : nullptr;
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    const int in = q[l], out = q[L + l];
    d.outs[l] = out;
    d.f_off[l] = q[2 * L + l];
    d.r_off[l] = q[3 * L + l];
    d.b[l] = (const float*)p[16 + l];
    if ((l && in != q[L + l - 1]) || (l && in > 256) ||
        (l < lL && out > 256) || out < 1 || d.f_off[l] % 1024 ||
        d.r_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
    // a tile's images: X_0 320 columns, X_l 256; R_l 256, 8 for the last
    // layer
    d.cx[l] = l ? 256 : RF_AK;
    d.cr[l] = l < lL ? 256 : 8;
    d.x_img[l] = off;
    off += (long long)d.n_tiles * 2 * d.cx[l] * 32;
    d.r_img[l] = off;
    off += (long long)d.n_tiles * 2 * d.cr[l] * 32;
  }
  const size_t smem = 1024 + (size_t)FW_NS * FW_STAGE + 64 * RF_AK * 4 +
                      RF_TILE * RF_EW * 4 + 2 * FW_NS * 8;
  cudaError_t e = cudaFuncSetAttribute(
      radiance_bwd_wgf_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  radiance_bwd_wgf_sweep<<<grid, 384, smem, s>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // the weight-gradient pass over the tiles that hold a row: units (layer,
  // X pair, R half) in that order
  FwgDims w;
  FrDims r;
  r.L = L;
  w.n_img = (d.n + RF_TILE - 1) / RF_TILE;
  w.per = per;
  w.S = r.S = S;
  w.img = d.img;
  w.part = (float*)p[11];
  if ((long long)S * per < w.n_img || (long long)(S - 1) * per >= w.n_img)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    w.x_img[l] = d.x_img[l];
    w.r_img[l] = d.r_img[l];
    w.cx[l] = d.cx[l];
    w.cr[l] = d.cr[l];
    r.ins[l] = q[l];
    r.outs[l] = q[L + l];
    // W_0's input is [narrow | feature]; X_0's image holds the feature
    // from column 0, the narrow columns from 256
    r.xn[l] = l ? 0 : d.nar;
    r.xn_at[l] = l ? 0 : 256;
  }
  size_t wsmem;
  int nu;
  const int rc = wgf_plan_pass(L, &w, &r, &wsmem, &nu);
  if (rc) return rc;
  e = cudaFuncSetAttribute(radiance_bwd_wgf_wgrad,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wsmem);
  if (e != cudaSuccess) return (int)e;
  radiance_bwd_wgf_wgrad<<<nu * S, 384, wsmem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  r.n_wslots = grid * 4;
  r.part = w.part;
  r.dbp = d.dbp;
  r.grads = (float*)p[12];
  r.P = 0;
  for (int l = 0; l < L; ++l) r.P += (long long)q[l] * q[L + l] + q[L + l];
  const int rb = 256;
  radiance_bwd_wgf_reduce<<<(int)((r.P + rb - 1) / rb), rb, 0, s>>>(r);
  return (int)cudaGetLastError();
}

// The sweep's and the weight-gradient pass's attributes as the device
// holds them, read after a launch: out[3 i .. 3 i + 2] = registers a
// thread, dynamic shared memory a block (as the launcher last set it),
// static shared memory, for i = 0 (sweep) and 1 (weight-gradient pass).
// Returns a cudaError_t value.
extern "C" int radiance_bwd_attrs(int* out) {
  const void* fns[2] = {(const void*)radiance_bwd_wgf_sweep,
                        (const void*)radiance_bwd_wgf_wgrad};
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
