// K1-bwd-split-bf16 and K1-bwd-stash-bf16: the two bf16 K1 backwards that
// only a switch reaches, on Hopper's warpgroup tensor cores (wgmma.cuh), on
// K1-bwd-bf16's slab packs, weight-gradient pass and reduce (wg_bwd.cuh).
// Every product takes bf16 operands (nearest even) and sums in f32;
// everything elementwise stays f32 (pallas_geometry's _mm_fns(bf16=True)).
//
// K1-bwd-split-bf16 (entry point geometry_bwd_split_bf16) replaces the TPU
// kernel factored_neus_tpu/ops/pallas_geometry.py _make_geom.run_bwd with
// stacked=False, bf16=True (body _build_bwd_kernel): K1-bwd-bf16's function
// (ct_x, dW, db from the primal forward and a forward tangent along
// ct_grad, both chains swept in reverse), the primal and tangent chains as
// separate row sets, the bias added to the primal alone.
// K1-bwd-stash-bf16 (entry point geometry_bwd_stash_bf16) replaces
// _make_geom.run_bwd_stash with bf16=True (body
// _build_bwd_kernel_from_stash): the primal pre-activations a come from
// K1-fwd-stash-bf16's bf16 stash [n][sum of the hidden widths], X_l =
// softplus(a) and sigma(100 a) are rebuilt from it in f32, only the
// tangent forward is a product, and no bias is read.
//
// Bound: operations over 989 TFLOP/s: 5,768,704 FLOP a point for the split
// (K1-bwd-bf16's, 0.382 ms at 65,536 points), 4,851,200 for the stash (its
// primal forward gone, 0.321 ms; the stash read, 4,018 B a point, ~0.08 ms
// at 3.35 TB/s).  Three kernels, launched one after another:
//
// 1. The sweep (geometry_bwd_split_wg16_sweep, geometry_bwd_stash_wg16_sweep).
//    A producer warpgroup (setmaxnreg 24) and two consumer warpgroups (240),
//    persistent over tiles of 64 points; both consumers read the same ring
//    stages (K1-bwd-bf16's slab ring, a stage released when both have used
//    it), so the slabs stream once a tile, as for K1-bwd-bf16's two
//    consumers.
//    - The forward runs the chains as separate row sets: consumer 0 the
//      primal chain's 64 rows, consumer 1 the tangent's, each one
//      m64n256k16 product a layer with A in registers (warp w's thread
//      holds points 16 w + g and 16 w + 8 + g, accumulator rows g and
//      g + 8).  The tangent's epilogue needs sigma(100 a) of the primal:
//      the primal writes it to the f32 scratch before its softplus, a
//      bar.sync of both consumers, the tangent reads it (ld.global.cg).
//      The stash's forward: consumer 1 runs the tangent chain alone, sigma
//      (100 a) from the stash in its epilogue; consumer 0, beside the
//      products, X_l's primal rows (softplus of the stash, prefetched into
//      L2 a layer at a time), waiting for and releasing the forward's
//      stages.
//    - The reverse is K1-bwd-bf16's (wg_bwd.cuh's gw_reverse), stacked:
//      consumer c takes the tile's points 32 c .. 32 c + 31, a point's
//      primal and tangent rows in one thread, so r = r_h s + rd_h ds ad
//      needs nothing from the other consumer and the two consumers run
//      apart (one's products under the other's epilogue).  The forward
//      writes sigma(100 a) and ad straight into K1-bwd-bf16's scratch
//      layout, by point (the forward's rows are not the reverse's).  A
//      reverse by chain too (the tangent's r_h W passed to the primal
//      through the scratch) took 2% less for the split and 8% more for
//      the stash, one running ahead of the other more for both
//      (tools/k1_chains16_ab.py; PERF.md).
//    - The encoding and its tangent, then (the forward done) their
//      cotangents, share one 24 KB tile: the ring keeps six 32 KB stages,
//      two more than a 4-slab layer holds (a 64 KB exchange tile in shared
//      memory would leave four, one fewer than a 257-wide layer's slabs).
//    - The images keep K1-bwd-bf16's layout and row order: tile T's points
//      are K1-bwd-bf16's 32-point tiles 2 T and 2 T + 1 (a warp's 8
//      points' primal rows, then their tangent rows), so the pass is its.
//    Each row's products keep K1-bwd-bf16's instruction shapes and k order
//    and its elementwise expressions, and the reverse, its scratch and its
//    db slots (consumer c of block b is K1-bwd-bf16's consumer c of pass
//    b) are K1-bwd-bf16's, so the split's ct_x, images, dW (the pass reads
//    the images in K1-bwd-bf16's chunks) and db are K1-bwd-bf16's bit for
//    bit wherever K1-bwd-bf16 runs two consumers a block (more 32-point
//    tiles than SMs).
// 2. The weight-gradient pass (geometry_bwd_chains_wg16_wgrad, wg_bwd.cuh's
//    wg_wgrad_body) over K1-bwd-bf16's 32-point image tiles.
// 3. The reduce (geometry_bwd_chains_wg16_reduce, wg_reduce_body), in a
//    fixed order: two launches are bitwise equal.
//
// Bytes at full width, 65,536 points (1,024 tiles): K1-bwd-bf16's scratch
// (2.15 GB written and read), images (1.21 GB written, 1.69 GB read by the
// pass) and slots; the stash 263 MB.  tools/k1_bwd_phases.py --bf16
// --split --stash cuts their phases.
#include "sweep16.cuh"

#define GC_PTS 64         // points of a tile (one m64 product a chain)
#define GC_IMG_PTS 32     // points of an image tile (K1-bwd-bf16's tile)
#define GC_EW 48          // row (floats) of the encoding tiles

struct GcDims {
  int L, multires, d_embed, n, n_tiles, ns, stash_cols;
  float scale;
  const float *x, *ct_out, *ct_g;
  float *ct_x, *scratch, *dbp;
  unsigned char* img;
  const __nv_bfloat16* stash;   // K1-bwd-stash-bf16: [n][stash_cols]
  const unsigned char *fpack, *rpack;
  int ins[GW_MAXL], outs[GW_MAXL];
  int enc[GW_MAXL];        // layer l reads the encoding (layer 0, a skip)
  int f_nslab[GW_MAXL];    // forward slabs of layer l (l < L - 1)
  int f_off[GW_MAXL];      // byte offset of its first (pack_sweep_bf16)
  int r_nslab[GW_MAXL];    // reverse slabs of layer l
  int r_off[GW_MAXL];      // byte offset of its first (pack_rev_bf16)
  int r_copy[GW_MAXL];     // bytes of one of its reverse slabs
  int s_col[GW_MAXL];      // stash column of layer l's pre-activations
  int xb[GW_MAXL], rb[GW_MAXL];   // bytes of an image tile's X_l and R_l
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // image tile 0's of each
  const float* b[GW_MAXL];
};

// -- the sweep ---------------------------------------------------------------

// a tile's slabs: the forward's (layers 0 .. L - 2), then the reverse's
__device__ __forceinline__ void gc_producer(const GcDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    for (int l = 0; l + 1 < d.L; ++l)
      for (int s = 0; s < d.f_nslab[l]; ++s, ++it)
        gw_put(d.ns, ring, full, empty, it,
               d.fpack + d.f_off[l] + s * GW_SLAB, GW_SLAB);
    for (int l = d.L - 1; l >= 0; --l)
      for (int s = 0; s < d.r_nslab[l]; ++s, ++it)
        gw_put(d.ns, ring, full, empty, it,
               d.rpack + d.r_off[l] + s * d.r_copy[l], d.r_copy[l]);
  }
}

// a stash row's pre-activation at column c (zero past the row's W columns
// or for a point past n: st null)
__device__ __forceinline__ float gc_stash_at(const __nv_bfloat16* st, int c,
                                             int W) {
  return st && c < W ? __bfloat162float(st[c]) : 0.f;
}

// Consumer C's chain (0 primal, 1 tangent) of every tile of its block in
// the forward, then K1-bwd-bf16's stacked reverse (wg_bwd.cuh's gw_reverse)
// over the tile's points 32 C .. 32 C + 31.
template <bool STASH, int C>
__device__ __forceinline__ void gc_consumer(const GcDims& d,
                                            unsigned char* ring, float* E,
                                            const float* bias,
                                            uint64_t* full, uint64_t* empty) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ctid = threadIdx.x - 128;            // over both consumers
  const int pa = 16 * warp + g, pb = pa + 8;     // this thread's points
  // pa's row of this chain in its image tile (2 tile + warp / 2); pb's 16
  // rows on
  const int r0 = 32 * (warp & 1) + 8 * C + g;
  const int lead = lane == 0;
  const float inv_sqrt2 = 0.70710678118654752f;
  const int L = d.L, lL = L - 1, de = d.d_embed;
  // the scratch of the reverse's consumer c, as K1-bwd-bf16's consumer
  // keeps it: a float4 (sigma(100 a) of the primal row, ad of the tangent
  // row) a layer, pair q and thread; pa and pb are the reverse's points 16
  // (warp & 1) + g and + 8 of consumer warp / 2: its threads 64 (warp & 1)
  // + 4 g + t and + 32
  float4* const scr0 = (float4*)d.scratch +
                       (size_t)blockIdx.x * 2 * lL * 32 * 128;
  float4* const sfa = scr0 + (size_t)(warp >> 1) * lL * 32 * 128 +
                      64 * (warp & 1) + 4 * g + t;
  float4* const sfb = sfa + 32;
  // this chain's encoding rows of pa and pb (the tangent's: its tangent)
  const float* ea = E + pa * 2 * GC_EW + C * GC_EW;
  const float* eb = E + pb * 2 * GC_EW + C * GC_EW;
  // the reverse's point, db slot, scratch and encoding cotangent rows
  const int pr = 32 * C + 8 * warp + g;
  float* dbw = d.dbp + (((size_t)blockIdx.x * 2 + C) * 4 + warp) * L * GW_BW;
  const float4* scr = scr0 + (size_t)C * lL * 32 * 128 + tid;
  float* rp = E + pr * 2 * GC_EW;
  uint32_t a[16][4];
  float acc[128];
  int it = 0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int P0 = tile * GC_PTS;
    const bool va = P0 + pa < d.n, vb = P0 + pb < d.n;
    const size_t itile = (size_t)2 * tile + (warp >> 1);
    unsigned char* const img = d.img;
    auto ximg = [&](int l) { return img + d.x_img[l] + itile * d.xb[l]; };
    // the encoding and its tangent (both consumers are done with the last
    // tile's cotangents, which share the tile)
    bar_sync(1, 256);
    if (ctid < GC_PTS) {
      const int row = P0 + ctid;
      float u[3], v[3];
      for (int c = 0; c < 3; ++c) {
        u[c] = row < d.n ? d.x[(size_t)row * 3 + c] * d.scale : 0.f;
        v[c] = row < d.n ? d.ct_g[(size_t)row * 3 + c] * d.scale : 0.f;
      }
      float* e = E + ctid * 2 * GC_EW;
      encode_row(u, v, d.multires, e, e + GC_EW);
      for (int c = de; c < GC_EW; ++c) e[c] = e[GC_EW + c] = 0.f;
    }
    bar_sync(1, 256);

    // the forward, layers 0 .. L - 2
    for (int l = 0; l < lL; ++l) {
      const int W = d.outs[l];
      const float post = d.enc[l + 1] ? inv_sqrt2 : 1.f;
      // the layer's scratch float4s of pa and pb
      float4* const sa = sfa + l * 32 * 128;
      float4* const sb = sfb + l * 32 * 128;
      uint32_t ef[3][4];
      if (d.enc[l]) {
        const float sc = l == 0 ? 1.f : inv_sqrt2;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int c = 16 * j + 2 * t;
          ef[j][0] = pack_bf16(ea[c] * sc, ea[c + 1] * sc);
          ef[j][1] = pack_bf16(eb[c] * sc, eb[c + 1] * sc);
          ef[j][2] = pack_bf16(ea[c + 8] * sc, ea[c + 9] * sc);
          ef[j][3] = pack_bf16(eb[c + 8] * sc, eb[c + 9] * sc);
        }
      }
      if (l == 0) {
        const uint32_t zero[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 3; ++j) gw_img<16>(ximg(0), j, ef[j], r0, g, t);
        gw_img<16>(ximg(0), 3, zero, r0, g, t);
      }
      const __nv_bfloat16* sta =
          STASH && va ? d.stash + (size_t)(P0 + pa) * d.stash_cols +
                            d.s_col[l]
                      : nullptr;
      const __nv_bfloat16* stb =
          STASH && vb ? d.stash + (size_t)(P0 + pb) * d.stash_cols +
                            d.s_col[l]
                      : nullptr;
      if constexpr (STASH && C == 0) {
        // the layer's stash columns of the tile's points into L2 (5 lines
        // of 128 bytes a point cover its 2 W bytes), then the tangent's
        // products' stages passed on, then X_{l+1}'s primal rows
        {
          const int p = P0 + (tid >> 1);
          if (p < d.n) {
            const char* src = (const char*)(d.stash + (size_t)p *
                                                          d.stash_cols +
                                            d.s_col[l]);
            for (int j = tid & 1; j < 5; j += 2) {
              const char* at =
                  src + (128 * j < 2 * W ? 128 * j : 2 * W - 1);
              asm volatile("prefetch.global.L2 [%0];\n" ::"l"(at));
            }
          }
        }
        for (int s = 0; s < d.f_nslab[l]; ++s) {
          const int k = it + s;
          mbar_wait(full + k % d.ns, (k / d.ns) & 1);
          mbar_arrive_if(empty + k % d.ns, lead);
        }
        it += d.f_nslab[l];
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = 16 * j + 8 * h + 2 * t;
            a[j][2 * h] =
                pack_bf16(sp100_sfu(gc_stash_at(sta, c, W)) * post,
                          sp100_sfu(gc_stash_at(sta, c + 1, W)) * post);
            a[j][2 * h + 1] =
                pack_bf16(sp100_sfu(gc_stash_at(stb, c, W)) * post,
                          sp100_sfu(gc_stash_at(stb, c + 1, W)) * post);
          }
      } else {
        if (l == 0)
          gw_fwd_layer<false, true>(d.ns, it, ring, full, empty, acc, a, ef,
                                    lead);
        else if (d.enc[l])
          gw_fwd_layer<true, true>(d.ns, it, ring, full, empty, acc, a, ef,
                                   lead);
        else
          gw_fwd_layer<true, false>(d.ns, it, ring, full, empty, acc, a, ef,
                                    lead);
        it += d.f_nslab[l];
        if constexpr (!STASH && C == 0) {
          // a = acc + b: sigma(100 a) to the scratch (the tangent reads it
          // at the barrier), then softplus (K1-bwd-bf16's expressions)
          const float* bl = bias + l * GW_BW;
#pragma unroll
          for (int q = 0; q < 32; ++q) {
            const float2 bb = *(const float2*)(bl + 8 * q + 2 * t);
            *(float2*)(sa + q * 128) =
                make_float2(sig100_sfu(acc[4 * q] + bb.x),
                            sig100_sfu(acc[4 * q + 1] + bb.y));
            *(float2*)(sb + q * 128) =
                make_float2(sig100_sfu(acc[4 * q + 2] + bb.x),
                            sig100_sfu(acc[4 * q + 3] + bb.y));
          }
          bar_sync(2, 256);
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 2 * j + h;
              const float2 bb = *(const float2*)(bl + 8 * q + 2 * t);
              a[j][2 * h] = pack_bf16(sp100_sfu(acc[4 * q] + bb.x) * post,
                                      sp100_sfu(acc[4 * q + 1] + bb.y) *
                                          post);
              a[j][2 * h + 1] =
                  pack_bf16(sp100_sfu(acc[4 * q + 2] + bb.x) * post,
                            sp100_sfu(acc[4 * q + 3] + bb.y) * post);
            }
        } else {
          // the tangent: ad = acc to the scratch, hd = sigma(100 a) ad x
          // post, sigma the primal's (the split) or from the stash
          if constexpr (!STASH) bar_sync(2, 256);
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int q = 2 * j + h;
              float2 s_a, s_b;
              if constexpr (STASH) {
                const int c = 8 * q + 2 * t;
                s_a = make_float2(sig100_sfu(gc_stash_at(sta, c, W)),
                                  sig100_sfu(gc_stash_at(sta, c + 1, W)));
                s_b = make_float2(sig100_sfu(gc_stash_at(stb, c, W)),
                                  sig100_sfu(gc_stash_at(stb, c + 1, W)));
              } else {
                s_a = __ldcg((const float2*)(sa + q * 128));
                s_b = __ldcg((const float2*)(sb + q * 128));
              }
              const float ad0 = acc[4 * q], ad1 = acc[4 * q + 1];
              const float ad2 = acc[4 * q + 2], ad3 = acc[4 * q + 3];
              if constexpr (STASH) {
                sa[q * 128] = make_float4(s_a.x, s_a.y, ad0, ad1);
                sb[q * 128] = make_float4(s_b.x, s_b.y, ad2, ad3);
              } else {
                *((float2*)(sa + q * 128) + 1) = make_float2(ad0, ad1);
                *((float2*)(sb + q * 128) + 1) = make_float2(ad2, ad3);
              }
              a[j][2 * h] = pack_bf16(s_a.x * ad0 * post, s_a.y * ad1 * post);
              a[j][2 * h + 1] =
                  pack_bf16(s_b.x * ad2 * post, s_b.y * ad3 * post);
            }
        }
      }
      unsigned char* xn = ximg(l + 1);
      if (d.enc[l + 1])
        gw_img256_skip<16>(xn, a, ea, eb, W, de, r0, g, t);
      else
        gw_img256<16>(xn, a, r0, g, t);
    }

    // the encoding tile becomes the cotangents' (both consumers' forward
    // epilogues have read it, and the scratch is written)
    bar_sync(1, 256);
    for (int i = ctid; i < GC_PTS * 2 * GC_EW; i += 256) E[i] = 0.f;
    bar_sync(1, 256);

    // the reverse: K1-bwd-bf16's, this consumer on image tile 2 tile + C
    gw_reverse(d, it, ring, full, empty, acc, a, 2 * tile + C, P0 + pr, scr,
               dbw, rp, rp + GC_EW, first, tid, lead);
    bar_sync(1, 256);
    if (ctid < GC_PTS) {
      const int row = P0 + ctid;
      if (row < d.n) {
        float u[3], v[3], ct[3];
        for (int c = 0; c < 3; ++c) {
          u[c] = d.x[(size_t)row * 3 + c] * d.scale;
          v[c] = d.ct_g[(size_t)row * 3 + c] * d.scale;
        }
        const float* r = E + ctid * 2 * GC_EW;
        encode_backward_row(u, v, d.multires, r, r + GC_EW, ct);
        for (int c = 0; c < 3; ++c)
          d.ct_x[(size_t)row * 3 + c] = ct[c] * d.scale;
      }
    }
  }
}

template <bool STASH>
__device__ __forceinline__ void gc_sweep(const GcDims& d,
                                         unsigned char* smem_raw) {
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  float* E = (float*)(ring + (size_t)d.ns * GW_SLAB);
  float* bias = E + GC_PTS * 2 * GC_EW;
  uint64_t* full = (uint64_t*)(bias + d.L * GW_BW);
  uint64_t* empty = full + d.ns;
  if (threadIdx.x == 0) {
    for (int s = 0; s < d.ns; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);
    }
    mbar_fence_init();
  }
  if (!STASH)
    for (int i = threadIdx.x; i < d.L * GW_BW; i += blockDim.x) {
      const int l = i / GW_BW, c = i - l * GW_BW;
      bias[i] = c < d.outs[l] ? d.b[l][c] : 0.f;
    }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0) gc_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    if (wg == 1)
      gc_consumer<STASH, 0>(d, ring, E, bias, full, empty);
    else
      gc_consumer<STASH, 1>(d, ring, E, bias, full, empty);
  }
}

__global__ void __launch_bounds__(384, 1)
geometry_bwd_split_wg16_sweep(const __grid_constant__ GcDims d) {
  extern __shared__ unsigned char smem_raw[];
  gc_sweep<false>(d, smem_raw);
}

__global__ void __launch_bounds__(384, 1)
geometry_bwd_stash_wg16_sweep(const __grid_constant__ GcDims d) {
  extern __shared__ unsigned char smem_raw[];
  gc_sweep<true>(d, smem_raw);
}

// -- the weight-gradient pass and the reduce (wg_bwd.cuh), K1-bwd-bf16's ----

__global__ void __launch_bounds__(384, 1)
geometry_bwd_chains_wg16_wgrad(const __grid_constant__ WgDims d) {
  extern __shared__ unsigned char smem_raw[];
  wg_wgrad_body(d, smem_raw);
}

__global__ void geometry_bwd_chains_wg16_reduce(
    const __grid_constant__ RdDims r) {
  wg_reduce_body(r);
}

// a variant's sweep (i = 0) or weight-gradient pass (1)
template <bool STASH>
static const void* gc_kernel(int i) {
  if (i) return (const void*)geometry_bwd_chains_wg16_wgrad;
  if constexpr (STASH) return (const void*)geometry_bwd_stash_wg16_sweep;
  else return (const void*)geometry_bwd_split_wg16_sweep;
}

// Integer arguments: [L, multires, d_embed, n, grid, n_tiles, S, per,
// stash_cols, then per layer ins[L], outs[L], enc[L], f_nslab[L], f_off[L],
// r_nslab[L], r_off[L], r_cols[L]] (ops/geometry_kernel.chains_wg_plan:
// K1-bwd-bf16's slab packs' layouts, its bwd_wg_plan's layer arguments;
// n_tiles tiles of 64 points; S chunks of per 32-point image tiles for the
// weight-gradient pass, K1-bwd-bf16's; stash_cols 0 for the split).
// Pointers: [x, ct_out, ct_grad, ct_x, scratch, images, db slots, dW slots,
// grads, forward pack, reverse pack, then b[L] (the split) or the bf16
// stash [n][stash_cols] (the stash)]; grads receives, per layer, dW as
// [in][out] followed by db [out].  Returns a cudaError_t value; 0 when the
// three launches were accepted.
template <bool STASH>
static int launch_chains16(const int* ia, const unsigned long long* p,
                           float scale, unsigned long long stream) {
  GcDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_embed = ia[2];
  d.n = ia[3];
  const int grid = ia[4];
  d.n_tiles = ia[5];
  const int S = ia[6], per = ia[7];
  d.stash_cols = ia[8];
  const int L = d.L;
  if (L < 2 || L > GW_MAXL || d.d_embed > GC_EW ||
      d.d_embed != 3 * (1 + 2 * d.multires) || grid < 1 || d.n_tiles < 1 ||
      S < 1 || per < 1 || (long long)d.n_tiles * GC_PTS < d.n ||
      (long long)(d.n_tiles - 1) * GC_PTS >= d.n ||
      (STASH ? d.stash_cols < 1 : d.stash_cols != 0))
    return (int)cudaErrorInvalidValue;
  d.scale = scale;
  d.x = (const float*)p[0];
  d.ct_out = (const float*)p[1];
  d.ct_g = (const float*)p[2];
  d.ct_x = (float*)p[3];
  d.scratch = (float*)p[4];
  d.img = (unsigned char*)p[5];
  d.dbp = (float*)p[6];
  d.fpack = (const unsigned char*)p[9];
  d.rpack = (const unsigned char*)p[10];
  d.stash = STASH ? (const __nv_bfloat16*)p[11] : nullptr;
  const int n_img = 2 * d.n_tiles;
  const int* q = ia + 9;
  long long off = 0;
  int scol = 0;
  for (int l = 0; l < L; ++l) {
    d.ins[l] = q[l];
    d.outs[l] = q[L + l];
    d.enc[l] = q[2 * L + l];
    d.f_nslab[l] = q[3 * L + l];
    d.f_off[l] = q[4 * L + l];
    d.r_nslab[l] = q[5 * L + l];
    d.r_off[l] = q[6 * L + l];
    const int r_cols = q[7 * L + l];
    d.r_copy[l] = r_cols * 128;
    d.b[l] = STASH ? nullptr : (const float*)p[11 + l];
    d.s_col[l] = scol;
    const bool last = l == L - 1;
    if (!last) scol += d.outs[l];
    // layer 0 reads the encoding alone, a skip layer [h | enc], the last
    // layer h alone
    if (d.ins[l] > 256 || d.outs[l] > (last ? 264 : 256) || d.outs[l] < 1 ||
        (d.enc[l] != 0 && d.enc[l] != 1) || (l == 0 && !d.enc[0]) ||
        (l == 0 && d.ins[0] != d.d_embed) || (last && d.enc[l]) ||
        (!last && d.f_nslab[l] != (l ? 4 : 0) + d.enc[l]) ||
        d.r_nslab[l] != 4 + (d.outs[l] > 256) ||
        r_cols != (l ? 256 : 48) || d.f_off[l] % 1024 || d.r_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
    if (l && d.ins[l] != d.outs[l - 1] + (d.enc[l] ? d.d_embed : 0))
      return (int)cudaErrorInvalidValue;
    // an image tile's X_0 one 64-column block, X_l four; R_l four, five
    // for a last layer over 256 wide: two image tiles a tile
    d.xb[l] = (l ? 4 : 1) * GW_XB;
    d.rb[l] = (d.outs[l] > 256 ? 5 : 4) * GW_XB;
    d.x_img[l] = off;
    off += (long long)n_img * d.xb[l];
    d.r_img[l] = off;
    off += (long long)n_img * d.rb[l];
  }
  if (STASH && scol != d.stash_cols) return (int)cudaErrorInvalidValue;
  const size_t fixed = 1024 + (size_t)GC_PTS * 2 * GC_EW * 4 +
                       (size_t)L * GW_BW * 4;
  const int ns = (int)((GW_SMEM_MAX - fixed) / ((size_t)GW_SLAB + 16));
  d.ns = ns < GW_MAX_NS ? ns : GW_MAX_NS;
  // both consumers hold every slab of a layer (at most 5) until their
  // products retire (the full-width network's ring: 6 stages)
  if (d.ns < 5) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)d.ns * (GW_SLAB + 16);
  cudaError_t e = cudaFuncSetAttribute(
      gc_kernel<STASH>(0), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (STASH)
    geometry_bwd_stash_wg16_sweep<<<grid, 384, smem, s>>>(d);
  else
    geometry_bwd_split_wg16_sweep<<<grid, 384, smem, s>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // K1-bwd-bf16's weight-gradient pass over the image tiles that hold a
  // point, and its reduce
  WgDims w;
  RdDims r;
  r.L = L;
  w.n_img = (d.n + GC_IMG_PTS - 1) / GC_IMG_PTS;
  w.per = per;
  w.S = r.S = S;
  w.img = d.img;
  w.part = (float*)p[7];
  if ((long long)S * per < w.n_img || (long long)(S - 1) * per >= w.n_img)
    return (int)cudaErrorInvalidValue;
  int nmb[GW_MAXL];
  for (int l = 0; l < L; ++l) {
    w.x_img[l] = d.x_img[l];
    w.r_img[l] = d.r_img[l];
    w.xb[l] = d.xb[l];
    w.rb[l] = d.rb[l];
    r.ins[l] = d.ins[l];
    r.outs[l] = d.outs[l];
    // X_0's columns in their own order, every other X_l's and R_l's first
    // 256 at gw_perm
    r.xn[l] = l ? 0 : d.ins[0];
    r.xn_at[l] = 0;
    r.rn[l] = 256;
    nmb[l] = (d.ins[l] + 63) / 64;
  }
  size_t wsmem;
  int nu;
  const int rc = wg_plan_pass(L, nmb, &w, &r, &wsmem, &nu);
  if (rc) return rc;
  e = cudaFuncSetAttribute(gc_kernel<STASH>(1),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wsmem);
  if (e != cudaSuccess) return (int)e;
  geometry_bwd_chains_wg16_wgrad<<<nu * S, 384, wsmem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  r.n_wslots = grid * 2 * 4;
  r.db_tree = 0;
  r.part = w.part;
  r.dbp = d.dbp;
  r.grads = (float*)p[8];
  r.P = 0;
  for (int l = 0; l < L; ++l)
    r.P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
  const int rb = 256;
  geometry_bwd_chains_wg16_reduce<<<(int)((r.P + rb - 1) / rb), rb, 0, s>>>(
      r);
  return (int)cudaGetLastError();
}

extern "C" int geometry_bwd_split_bf16(const int* ia,
                                       const unsigned long long* p,
                                       float scale,
                                       unsigned long long stream) {
  return launch_chains16<false>(ia, p, scale, stream);
}

extern "C" int geometry_bwd_stash_bf16(const int* ia,
                                       const unsigned long long* p,
                                       float scale,
                                       unsigned long long stream) {
  return launch_chains16<true>(ia, p, scale, stream);
}

// A variant's sweep and weight-gradient pass as the device holds them,
// read after a launch: out[3 i .. 3 i + 2] = registers a thread, dynamic
// shared memory a block (as the launcher last set it), static shared
// memory, for i = 0 (sweep) and 1 (weight-gradient pass).  Returns a
// cudaError_t value.
template <bool STASH>
static int chains16_attrs(int* out) {
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, gc_kernel<STASH>(i));
    if (e != cudaSuccess) return (int)e;
    out[3 * i] = a.numRegs;
    out[3 * i + 1] = a.maxDynamicSharedSizeBytes;
    out[3 * i + 2] = (int)a.sharedSizeBytes;
  }
  return 0;
}

extern "C" int geometry_bwd_split_bf16_attrs(int* out) {
  return chains16_attrs<false>(out);
}

extern "C" int geometry_bwd_stash_bf16_attrs(int* out) {
  return chains16_attrs<true>(out);
}
