// K1-bwd-split and K1-bwd-stash: the two f32 K1 backwards that only a
// switch reaches, on Hopper's warpgroup tensor cores in 3xTF32 (wgmma.cuh;
// the f32 engine's sweep pieces, pass and reduce in wgf.cuh, K1-bwd's).
//
// K1-bwd-split (entry point geometry_bwd_split) replaces the TPU kernel
// factored_neus_tpu/ops/pallas_geometry.py _make_geom.run_bwd with
// stacked=False (body _build_bwd_kernel): K1-bwd's function (ct_x, dW, db
// from the primal forward and a forward tangent along ct_grad, both chains
// swept in reverse), the primal and tangent chains as separate row sets.
// K1-bwd-stash (entry point geometry_bwd_stash) replaces
// _make_geom.run_bwd_stash (body _build_bwd_kernel_from_stash): the primal
// pre-activations a come from K1-fwd-stash's bf16 stash [n][sum of the
// hidden widths], X_l = softplus(a) and sigma(100 a) are rebuilt from it,
// only the tangent forward is recomputed, and no bias is read.
//
// Bound: operations, three TF32 products' worth over 495 TFLOP/s:
// 5,768,704 FLOP a point for the split (K1-bwd's, 2.291 ms at 65,536
// points), 4,851,200 for the stash (its primal forward gone, 1.927 ms; the
// stash read, 4,018 B a point, ~0.08 ms at 3.35 TB/s).  Three kernels, as
// K1-bwd's (geometry_bwd_wg.cu, whose notes on 3xTF32 from one f32 copy,
// the k permutation, the rounded add every slab, the slab ring and the
// barriers hold here):
//
// 1. The sweep (geometry_bwd_split_wgf_sweep, geometry_bwd_stash_wgf_sweep).
//    Two consumer warpgroups and a producer warpgroup (setmaxnreg 240 /
//    24), persistent over tiles of 64 points.  Each chain's 64 rows are one
//    m64 product (point p is row p of both: warp w's thread holds points
//    16w + g and 16w + 8 + g of either chain), consumer c its output
//    columns 128c .. 128c + 127 (m64n128k8; layer 0's r W m64n24k8).  Only
//    one chain's accumulator and running sum are live at a time (64 + 64
//    registers), and the layer's slabs stream once a chain: K1-bwd's
//    products and L2 -> shared-memory slab bytes a point.
//    - One A tile.  Two chains' 64 KB A tiles do not fit beside the two 64
//      KB ring stages in 227 KB, so the tile holds one chain's input at a
//      time: the chain that ends a layer writes its result into the A tile
//      from registers and runs first in the next layer; the other chain's
//      input is read back from its f32 tile image, which the pass needs
//      anyway (64 KB a tile a layer, from L2), into acc (free between
//      products) as soon as the first product is done, so that the loads
//      run under the first chain's epilogue.  The forward alternates the
//      chain order by layer (the tangent's epilogue needs the primal's
//      sigma(100 a), the primal's can write both chains); the reverse runs
//      the primal first (the tangent's epilogue can write both chains:
//      rd = rd_h s and r = r_h s + rd_h ds ad).  The first chain's values
//      wait in the f32 scratch (the thread's own float4s): keeping them in
//      registers across the other product spills.
//    - The reverse's and the stash's epilogues load first and store last
//      (the outputs that are not the next A tile wait in acc): a load
//      issued behind a run of image stores waits for them.
//    - The stash's forward runs the tangent chain alone, straight from one
//      layer's result to the next (no read-back): sigma(100 a) and X_l's
//      primal rows come from the stash (bf16, prefetched into L2 under the
//      layer's product).
//    - The scratch holds sigma(100 a) and ad of each hidden layer (written
//      once in the forward, read once in the reverse, sent to L2 under the
//      product before it) and one layer's r W of the first chain.
//    - The encoding and its tangent, then (the forward done) their
//      cotangents, share one 24 KB tile: 64 points x 96 floats.
//    - The images keep K1-bwd's layout and row order: tile T's points are
//      K1-bwd's 32-point tiles 2T and 2T + 1 (a warp's 8 points' primal
//      rows, then their tangent rows), so the pass is K1-bwd's.
//    - db: each layer's primal R summed over the warp's 16 points, added
//      to the warp's slot tile after tile, in order.
//    Each row's chain is K1-bwd's sequence of slab products, rounded adds
//    and epilogues, so the split's ct_x and the images are K1-bwd's bit for
//    bit (and dW, whose pass reads them in K1-bwd's chunks); db is summed
//    in another order.
// 2. The weight-gradient pass (geometry_bwd_chains_wgf_wgrad, wgf.cuh's
//    wgf_wgrad_body) over K1-bwd's 32-point image tiles.
// 3. The reduce (geometry_bwd_chains_wgf_reduce, wgf_reduce_body), in a
//    fixed order: two launches are bitwise equal.
//
// Bytes at full width, 65,536 points (1,024 tiles): the scratch 1.06 MB a
// tile written and read (2.2 GB; the first chain's values another 0.8 MB a
// tile through L2), the images as K1-bwd's (2.32 GB written, 4.50 GB read
// by the pass), the read-backs ~1 MB a tile from L2, the stash 263 MB; the
// slabs 16.8 MB a tile from L2 (the split; the stash 12.6).  On an H100
// the split takes ~1.5x K1-bwd's time and the stash ~1.1x:
// tools/k1_bwd_phases.py --split --stash cuts their phases (the scratch
// exchange, the read-backs, the image stores and the epilogues, during
// which the tensor cores idle).
#include "sdf_mlp.cuh"
#include "wgf.cuh"

#define FC_PTS 64          // points of a tile (one m64 product a chain)
#define FC_IMG_PTS 32      // points of an image tile (K1-bwd's tile)
#define FC_EW 48           // row (floats) of the encoding tiles
#define FC_SQ 32           // scratch float4s a thread a layer (sigma, ad)

struct FcDims {
  int L, multires, d_embed, n, n_tiles, stash_cols;
  float scale;
  const float *x, *ct_out, *ct_g;
  float *ct_x, *scratch, *dbp, *img;
  const __nv_bfloat16* stash;     // K1-bwd-stash: [n][stash_cols]
  const unsigned char *fpack, *rpack;
  int ins[GW_MAXL], outs[GW_MAXL];
  int enc[GW_MAXL];        // layer l reads [h | enc] (a skip layer)
  int f_off[GW_MAXL];      // byte offset of forward layer l's first slab
  int r_off[GW_MAXL];      // byte offset of reverse layer l's first slab
  int r_bytes[GW_MAXL];    // bytes of one of its reverse slabs
  int s_col[GW_MAXL];      // stash column of layer l's pre-activations
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // floats: image tile 0's
  int cx[GW_MAXL], cr[GW_MAXL];               // their columns
  const float* b[GW_MAXL];
};

// -- the sweep ---------------------------------------------------------------

// a tile's slabs: the forward's once a chain (the stash: the tangent's
// alone), the reverse's once a chain
template <bool STASH>
__device__ __forceinline__ void fc_producer(const FcDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    for (int l = 0; l + 1 < d.L; ++l)
      for (int ch = STASH ? 1 : 0; ch < 2; ++ch)
        for (int s = 0; s < (l ? 8 : 2); ++s, ++it)
          fw_put(ring, full, empty, it, d.fpack + d.f_off[l] + s * FW_STAGE,
                 FW_STAGE);
    for (int l = d.L - 1; l >= 0; --l)
      for (int ch = 0; ch < 2; ++ch)
        for (int s = 0; s < 8 + (d.outs[l] > 256); ++s, ++it)
          fw_put(ring, full, empty, it,
                 d.rpack + d.r_off[l] + s * d.r_bytes[l], d.r_bytes[l]);
  }
}

// A chain's 128 columns (from n0) of its two rows (run[4q + e]: image row
// r0, run[4q + 2 + e]: r0 + 16) into an image tile of C columns
__device__ __forceinline__ void fc_img_store(float* im, const float (&v)[64],
                                             int n0, int C, int r0, int t) {
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * q + 2 * t + e;
      im[img_at(r0, col, C)] = v[4 * q + e];
      im[img_at(r0 + 16, col, C)] = v[4 * q + 2 + e];
    }
}

// ... and back (what this thread wrote there)
__device__ __forceinline__ void fc_img_load(float (&v)[64], const float* src,
                                            int n0, int C, int r0, int t) {
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * q + 2 * t + e;
      v[4 * q + e] = src[img_at(r0, col, C)];
      v[4 * q + 2 + e] = src[img_at(r0 + 16, col, C)];
    }
}

// a layer's scratch values of this thread (16 float4s from src, 256 apart)
// into v, in run's order: the reverse's epilogue loads them into acc, free
// between products
__device__ __forceinline__ void fc_scr_load(float (&v)[64],
                                            const float4* src) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 x = src[q * 256];
    v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z,
    v[4 * q + 3] = x.w;
  }
}

// v into the A tile once both consumers' products have read it, fenced to
// the async proxy before any product reads it
__device__ __forceinline__ void fc_to_at(unsigned char* at,
                                         const float (&v)[64], int n0, int w,
                                         int g, int t) {
  bar_sync(1, 256);
  at_store(at, v, n0, w, g, t);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(1, 256);
}

// v[2q + e] (q < 16) summed over the warp's 8 lane groups by fw_db_reduce's
// transposing shuffle reduction, then added to the warp's db slot row sl
// (set on the block's first tile): v[16 m + e] holds column 64 m + 8 g +
// 2 t + e of the consumer's 128 (m < 2); v is clobbered
__device__ __forceinline__ void fc_db(float (&v)[32], float* sl, bool first,
                                      int n0, int g, int t) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const bool bit = (g >> s) & 1;
#pragma unroll
    for (int q = 0; q < 16; q += 2 << s)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float lo = v[2 * q + e], hi = v[2 * (q + (1 << s)) + e];
        const float send = bit ? lo : hi;
        const float keep = bit ? hi : lo;
        v[2 * q + e] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << s);
      }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    float2* o = (float2*)(sl + n0 + 64 * m + 8 * g + 2 * t);
    const float2 x = make_float2(v[16 * m], v[16 * m + 1]);
    *o = first ? x : make_float2(o->x + x.x, o->y + x.y);
  }
}

// R in run: the A tile, its image rows (r0, r0 + 16), with sl its db; then
// the barrier before the next products
__device__ __forceinline__ void fc_finish(float (&run)[64], unsigned char* at,
                                          float* im, int C, int r0, float* sl,
                                          bool first, int n0, int w, int g,
                                          int t) {
  bar_sync(1, 256);
  at_store(at, run, n0, w, g, t);
  fc_img_store(im, run, n0, C, r0, t);
  if (sl) {
    // db: the primal R's two rows summed over the warp's 16 points
    float v[32];
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        v[2 * q + e] = run[4 * q + e] + run[4 * q + 2 + e];
    fc_db(v, sl, first, n0, g, t);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(1, 256);
}

// The primal rows' forward epilogue (K1-bwd's expressions): a = run + b,
// softplus and sigma(100 a) from one exp, sigma to ss; run = h (x 1/sqrt 2
// before a skip, the encoding after h there).  TAN: the tangent rows too,
// hd = sigma(100 a) ad x post from the ad in sa, straight to image rows
// r0 + 8 and r0 + 24 of im.
template <bool TAN>
__device__ __forceinline__ void fc_primal(float (&run)[64], const float* bl,
                                          int W, bool skip, float post,
                                          const float* ea, const float* eb,
                                          float4* ss, const float4* sa,
                                          float* im, int r0, int n0, int t,
                                          int de) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    float s4[4], ad4[4] = {0.f, 0.f, 0.f, 0.f};
    if (TAN) {
      const float4 v = sa[q * 256];
      ad4[0] = v.x, ad4[1] = v.y, ad4[2] = v.z, ad4[3] = v.w;
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * q + 2 * m + e, col = n0 + 8 * q + 2 * t + e;
        const float* ep = m ? eb : ea;
        const float a = run[i] + (col < W ? __ldg(bl + col) : 0.f);
        float sp, s;
        sp_sig100(a, sp, s);
        s4[2 * m + e] = s;
        const float ad = ad4[2 * m + e];
        float h = sp * post, hd = s * ad * post;
        if (col >= W) {
          const int k = col - W;
          h = skip && k < de ? ep[k] * inv_sqrt2 : 0.f;
          hd = skip && k < de ? ep[FC_EW + k] * inv_sqrt2 : 0.f;
        }
        run[i] = h;
        if (TAN) im[img_at(r0 + 8 + 16 * m, col, 256)] = hd;
      }
    ss[q * 256] = make_float4(s4[0], s4[1], s4[2], s4[3]);
  }
}

// The tangent rows' forward epilogue once the primal's ran: ad = run to
// sa, run = hd = sigma(100 a) ad x post (sigma from ss; the encoding's
// tangent after h at a skip)
__device__ __forceinline__ void fc_tangent(float (&run)[64], int W, bool skip,
                                           float post, const float* ea,
                                           const float* eb, const float4* ss,
                                           float4* sa, int n0, int t,
                                           int de) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float4 v = ss[q * 256];
    const float s4[4] = {v.x, v.y, v.z, v.w};
    sa[q * 256] = make_float4(run[4 * q], run[4 * q + 1], run[4 * q + 2],
                              run[4 * q + 3]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * q + 2 * m + e, col = n0 + 8 * q + 2 * t + e;
        const float s = s4[2 * m + e], ad = run[i];
        float hd = s * ad * post;
        if (col >= W) {
          const int k = col - W;
          hd = skip && k < de ? (m ? eb : ea)[FC_EW + k] * inv_sqrt2 : 0.f;
        }
        run[i] = hd;
      }
  }
}

// K1-bwd-stash's forward epilogue: ad = run to sa; a (bf16) from the stash
// rows sta, stb (the layer's columns; null for a point past n: a = 0),
// softplus and sigma(100 a) from one exp, sigma to ss; hv = h (the primal
// rows); run = hd
__device__ __forceinline__ void fc_stash_epi(
    float (&run)[64], float (&hv)[64], const __nv_bfloat16* sta,
    const __nv_bfloat16* stb, int W, bool skip, float post, const float* ea,
    const float* eb, float4* ss, float4* sa, int n0, int t, int de) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    float s4[4];
    sa[q * 256] = make_float4(run[4 * q], run[4 * q + 1], run[4 * q + 2],
                              run[4 * q + 3]);
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * q + 2 * m + e, col = n0 + 8 * q + 2 * t + e;
        const __nv_bfloat16* st = m ? stb : sta;
        const float* ep = m ? eb : ea;
        const float a = st && col < W ? __bfloat162float(st[col]) : 0.f;
        float sp, s;
        sp_sig100(a, sp, s);
        s4[2 * m + e] = s;
        float h = sp * post, hd = s * run[i] * post;
        if (col >= W) {
          const int k = col - W;
          h = skip && k < de ? ep[k] * inv_sqrt2 : 0.f;
          hd = skip && k < de ? ep[FC_EW + k] * inv_sqrt2 : 0.f;
        }
        hv[i] = h;
        run[i] = hd;
      }
    ss[q * 256] = make_float4(s4[0], s4[1], s4[2], s4[3]);
  }
}

// A skip layer's r W (layer l reads [h | enc] / sqrt 2): x 1/sqrt 2, its
// encoding columns (W on) added to the points' cotangent rows ra, rb
__device__ __forceinline__ void fc_skip(float (&run)[64], int W, int de,
                                        float* ra, float* rb, int n0,
                                        int t) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * q + 2 * m + e, col = n0 + 8 * q + 2 * t + e;
        run[i] *= inv_sqrt2;
        if (col >= W && col < W + de) (m ? rb : ra)[col - W] += run[i];
      }
}

template <bool STASH>
__device__ __forceinline__ void fc_consumer(const FcDims& d, int c,
                                            unsigned char* ring,
                                            unsigned char* at, float* E,
                                            uint64_t* full, uint64_t* empty) {
  const int ctid = threadIdx.x, tid = ctid & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int pa = 16 * w + g, pb = pa + 8;       // this thread's points
  const int lead = lane == 0;
  const int n0 = 128 * c;                       // its output columns
  // pa's primal row in its image tile (2 tile + w / 2); pb's 16 on, the
  // tangent rows 8 on
  const int rb = 32 * (w & 1) + g;
  const float inv_scale = 1.f / d.scale;
  const int L = d.L, lL = L - 1, N = d.outs[lL], de = d.d_embed;
  const uint32_t atile = smem_u32(at);
  float4* scr = (float4*)d.scratch +
                (size_t)blockIdx.x * (lL * FC_SQ + 16) * 256 + ctid;
  float4* held = scr + lL * FC_SQ * 256;
  float* dbw = d.dbp + ((size_t)blockIdx.x * 4 + w) * L * GW_BW;
  float* ea = E + pa * 2 * FC_EW;
  float* eb = E + pb * 2 * FC_EW;
  float acc[64], run[64];
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  uint32_t xr[4];      // the seeds' columns 256 on (a last layer over 256)
  int it = 0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int P0 = tile * FC_PTS;
    const bool va = P0 + pa < d.n, vb = P0 + pb < d.n;
    const size_t itile = (size_t)2 * tile + (w >> 1);
    auto ximg = [&](int l) {
      return d.img + d.x_img[l] + itile * 2 * d.cx[l] * 32;
    };
    auto rimg = [&](int l) {
      return d.img + d.r_img[l] + itile * 2 * d.cr[l] * 32;
    };
    auto fwd_product = [&](int l) {
      if (l == 0) {
        fw_layer<128, 2, 2, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 2;
      } else {
        fw_layer<128, 8, 4, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 8;
      }
    };
    auto rev_product = [&](int l, bool prim) {
      if (l == lL && N > 256) {
        // the primal's columns 256 on; zero for the tangent, whose rows
        // still take the k-step (K1-bwd's sums)
        uint32_t xs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xs[i] = prim ? xr[i] : 0u;
        fw_layer<128, 8, 4, true>(it, ring, full, empty, atile, 256, n0, acc,
                                  run, xs, at, w, g, t, lead);
        it += 9;
      } else {
        fw_layer<128, 8, 4, false>(it, ring, full, empty, atile, 256, n0,
                                   acc, run, none, at, w, g, t, lead);
        it += 8;
      }
    };
    // X_0's rows of one chain (the tangent's: tan) from the encoding tile
    // into the A tile, consumer 0's 64 columns
    auto x0_to_at = [&](bool tan) {
      if (c == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 8 * q + 2 * t + e, o = tan ? FC_EW : 0;
            at_put(at, pa, k, k < FC_EW ? ea[o + k] : 0.f);
            at_put(at, pb, k, k < FC_EW ? eb[o + k] : 0.f);
          }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    };

    // the encoding and its tangent (both consumers are done with the last
    // tile's cotangents, which share the tile)
    bar_sync(1, 256);
    if (ctid < FC_PTS) {
      const int row = P0 + ctid;
      float u[3], v[3];
      for (int k = 0; k < 3; ++k) {
        u[k] = row < d.n ? d.x[(size_t)row * 3 + k] * d.scale : 0.f;
        v[k] = row < d.n ? d.ct_g[(size_t)row * 3 + k] * d.scale : 0.f;
      }
      float* e = E + ctid * 2 * FC_EW;
      encode_row(u, v, d.multires, e, e + FC_EW);
      for (int k = de; k < FC_EW; ++k) e[k] = e[FC_EW + k] = 0.f;
    }
    bar_sync(1, 256);
    // X_0's images (both chains: the encoding's 64 columns, zero from
    // d_embed on), consumer 0's; the A tile takes the first chain's rows
    if (c == 0) {
      float* x0 = ximg(0);
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * q + 2 * t + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            x0[img_at(rb + 8 * h, k, 64)] =
                k < FC_EW ? ea[FC_EW * h + k] : 0.f;
            x0[img_at(rb + 16 + 8 * h, k, 64)] =
                k < FC_EW ? eb[FC_EW * h + k] : 0.f;
          }
        }
    }
    x0_to_at(STASH);

    // the forward, layers 0 .. L - 2: the split's both chains, the primal
    // first on even layers; the stash's tangent alone
    for (int l = 0; l < lL; ++l) {
      const int W = d.outs[l];
      const bool skip = d.enc[l + 1];
      const float post = skip ? 0.70710678118654752f : 1.f;
      float4* ss = scr + l * FC_SQ * 256;       // sigma(100 a)
      float4* sa = ss + 16 * 256;               // ad
      float* xo = ximg(l + 1);
      if constexpr (STASH) {
        // the layer's stash columns of the tile's points into L2 under the
        // product: 5 lines of 128 bytes a point
        {
          const int p = ctid >> 2;
          if (P0 + p < d.n) {
            const char* src = (const char*)(d.stash + (size_t)(P0 + p) *
                                                          d.stash_cols +
                                            d.s_col[l]);
            for (int j = ctid & 3; j < 5; j += 4)
              asm volatile("prefetch.global.L2 [%0];\n" ::"l"(src + 128 * j));
          }
        }
        fwd_product(l);
        const size_t so = d.s_col[l];
        fc_stash_epi(run, acc,
                     va ? d.stash + (size_t)(P0 + pa) * d.stash_cols + so
                        : nullptr,
                     vb ? d.stash + (size_t)(P0 + pb) * d.stash_cols + so
                        : nullptr,
                     W, skip, post, ea, eb, ss, sa, n0, t, de);
        fc_img_store(xo, acc, n0, 256, rb, t);
        fc_img_store(xo, run, n0, 256, rb + 8, t);
      } else if (!(l & 1)) {
        // the primal, then the tangent read back into acc (free until the
        // next product) under the primal's epilogue (layer 0: the
        // encoding's)
        fwd_product(l);
        if (l) fc_img_load(acc, ximg(l), n0, 256, rb + 8, t);
        fc_primal<false>(run, d.b[l], W, skip, post, ea, eb, ss, sa, xo, rb,
                         n0, t, de);
        fc_img_store(xo, run, n0, 256, rb, t);
        if (l == 0) {
          bar_sync(1, 256);
          x0_to_at(true);
        } else {
          fc_to_at(at, acc, n0, w, g, t);
        }
        fwd_product(l);
        fc_tangent(run, W, skip, post, ea, eb, ss, sa, n0, t, de);
        fc_img_store(xo, run, n0, 256, rb + 8, t);
      } else {
        // the tangent (its ad waits in the scratch), then the primal read
        // back, whose epilogue writes both chains
        fwd_product(l);
        fc_img_load(acc, ximg(l), n0, 256, rb, t);
#pragma unroll
        for (int q = 0; q < 16; ++q)
          sa[q * 256] = make_float4(run[4 * q], run[4 * q + 1],
                                    run[4 * q + 2], run[4 * q + 3]);
        fc_to_at(at, acc, n0, w, g, t);
        fwd_product(l);
        fc_primal<true>(run, d.b[l], W, skip, post, ea, eb, ss, sa, xo, rb,
                        n0, t, de);
        fc_img_store(xo, run, n0, 256, rb, t);
      }
      fc_to_at(at, run, n0, w, g, t);
    }

    // the encoding tile becomes the cotangents' (every forward epilogue
    // has read it: fc_to_at's barriers)
    for (int i = ctid; i < FC_PTS * 2 * FC_EW; i += 256) E[i] = 0.f;
    float* rpa = ea;
    float* rta = ea + FC_EW;
    float* rpb = eb;
    float* rtb = eb + FC_EW;

    // the seeds: ct_out (column 0 / scale) on the primal rows, e0 / scale
    // on the tangent rows; a last layer over 256 wide has its columns 256
    // on in xr (the last k-step of the primal chain, from registers;
    // consumer 1's image and db)
    {
      const float* coa = d.ct_out + (size_t)(P0 + pa) * N;
      const float* cob = d.ct_out + (size_t)(P0 + pb) * N;
      const int C = d.cr[lL];
      float* im = rimg(lL);
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = 0u;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + 8 * q + 2 * t + e;
          const float f = col == 0 ? inv_scale : 1.f;
          run[4 * q + e] = va && col < N ? coa[col] * f : 0.f;
          run[4 * q + 2 + e] = vb && col < N ? cob[col] * f : 0.f;
          im[img_at(rb + 8, col, C)] = va && col == 0 ? inv_scale : 0.f;
          im[img_at(rb + 24, col, C)] = vb && col == 0 ? inv_scale : 0.f;
        }
      if (N > 256) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 256 + 2 * t + e;
          const float xa = va && col < N ? coa[col] : 0.f;
          const float xb = vb && col < N ? cob[col] : 0.f;
          xr[2 * e] = __float_as_uint(xa);
          xr[2 * e + 1] = __float_as_uint(xb);
          if (c == 1) {
            im[img_at(rb, col, C)] = xa;
            im[img_at(rb + 16, col, C)] = xb;
            im[img_at(rb + 8, col, C)] = 0.f;
            im[img_at(rb + 24, col, C)] = 0.f;
            // db's column 256 + 2t + e: summed over the warp's points
            float v = xa + xb;
#pragma unroll
            for (int s = 4; s < 32; s <<= 1)
              v += __shfl_xor_sync(0xffffffffu, v, s);
            float* o = dbw + lL * GW_BW + col;
            if (g == 0) *o = first ? v : *o + v;
          }
        }
      }
      fc_finish(run, at, im, C, rb, dbw + lL * GW_BW, first, n0, w, g, t);
    }

    // the reverse sweep: layer l's r W, the primal's (in the A tile since
    // the last step), then the tangent's (read back), then layer l - 1's
    // step: the tangent's R_{l-1} straight to its image, the primal's into
    // the A tile
    for (int l = lL; l >= 1; --l) {
      const int W = d.outs[l - 1];
      const bool skip = d.enc[l];
      const float4* ss = scr + (l - 1) * FC_SQ * 256;
      const float4* sa = ss + 16 * 256;
      float* ro = rimg(l - 1);
      l2_prefetch_if(ss - ctid, FC_SQ * 256 * 16, ctid == 0);
      rev_product(l, true);
      fc_img_load(acc, rimg(l), n0, d.cr[l], rb + 8, t);
      if (skip) fc_skip(run, W, de, rpa, rpb, n0, t);
#pragma unroll
      for (int q = 0; q < 16; ++q)
        held[q * 256] = make_float4(run[4 * q], run[4 * q + 1],
                                    run[4 * q + 2], run[4 * q + 3]);
      fc_to_at(at, acc, n0, w, g, t);
      rev_product(l, false);
      if (skip) fc_skip(run, W, de, rta, rtb, n0, t);
      fc_scr_load(acc, ss);
      // h = sp(a): dh/da = s; hd = s ad: d(hd)/da = 100 s (1 - s) ad,
      // d(hd)/d(ad) = s: r = r_h s + rd_h ds ad, rd = rd_h s, zero from
      // column W on (K1-bwd's expressions); the tangent's R_{l-1} in acc
      // (sigma's place), then to its image
#pragma unroll
      for (int q = 0; q < 16; ++q) {
            const float4 a4 = sa[q * 256], h4 = held[q * 256];
        const float s4[4] = {acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                             acc[4 * q + 3]};
        const float ad4[4] = {a4.x, a4.y, a4.z, a4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * q + 2 * m + e, col = n0 + 8 * q + 2 * t + e;
            const float rh = hv[2 * m + e], rdh = run[i];
            const float s = s4[2 * m + e], ad = ad4[2 * m + e];
            const float ds = 100.f * s * (1.f - s);
            const bool in = col < W;
            acc[i] = in ? rdh * s : 0.f;
            run[i] = in ? rh * s + rdh * ds * ad : 0.f;
          }
      }
      fc_img_store(ro, acc, n0, 256, rb + 8, t);
      fc_finish(run, at, ro, 256, rb, dbw + (l - 1) * GW_BW, first, n0, w, g,
                t);
    }
    {
      // layer 0: r W_0 for both chains, the primal's first, the encoding's
      // cotangents (consumer c its 24 columns)
      float acc24[12], run24[12];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h) {
          fc_img_load(run, rimg(0), n0, 256, rb + 8, t);
          fc_to_at(at, run, n0, w, g, t);
        }
        fw_layer<24, 8, 4, false>(it, ring, full, empty, atile, 48, 24 * c,
                                  acc24, run24, none, at, w, g, t, lead);
        it += 8;
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 24 * c + 8 * q + 2 * t + e;
              if (col < de)
                (h ? (m ? rtb : rta) : (m ? rpb : rpa))[col] +=
                    run24[4 * q + 2 * m + e];
            }
      }
    }
    bar_sync(1, 256);
    if (ctid < FC_PTS) {
      const int row = P0 + ctid;
      if (row < d.n) {
        float u[3], v[3], ct[3];
        for (int k = 0; k < 3; ++k) {
          u[k] = d.x[(size_t)row * 3 + k] * d.scale;
          v[k] = d.ct_g[(size_t)row * 3 + k] * d.scale;
        }
        const float* r = E + ctid * 2 * FC_EW;
        encode_backward_row(u, v, d.multires, r, r + FC_EW, ct);
        for (int k = 0; k < 3; ++k)
          d.ct_x[(size_t)row * 3 + k] = ct[k] * d.scale;
      }
    }
  }
}

template <bool STASH>
__device__ __forceinline__ void fc_sweep(const FcDims& d,
                                         unsigned char* smem_raw) {
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* at = ring + FW_NS * FW_STAGE;
  float* E = (float*)(at + 64 * 256 * 4);
  uint64_t* full = (uint64_t*)(E + FC_PTS * 2 * FC_EW);
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
    if (threadIdx.x == 256) fc_producer<STASH>(d, ring, full, empty);
  } else {
    regs_inc<240>();
    fc_consumer<STASH>(d, threadIdx.x >> 7, ring, at, E, full, empty);
  }
}

__global__ void __launch_bounds__(384, 1)
geometry_bwd_split_wgf_sweep(const __grid_constant__ FcDims d) {
  extern __shared__ unsigned char smem_raw[];
  fc_sweep<false>(d, smem_raw);
}

__global__ void __launch_bounds__(384, 1)
geometry_bwd_stash_wgf_sweep(const __grid_constant__ FcDims d) {
  extern __shared__ unsigned char smem_raw[];
  fc_sweep<true>(d, smem_raw);
}

// -- the weight-gradient pass and the reduce (wgf.cuh), K1-bwd's -----------

__global__ void __launch_bounds__(384, 1)
geometry_bwd_chains_wgf_wgrad(const __grid_constant__ FwgDims d) {
  extern __shared__ unsigned char smem_raw[];
  wgf_wgrad_body(d, smem_raw);
}

__global__ void geometry_bwd_chains_wgf_reduce(
    const __grid_constant__ FrDims r) {
  wgf_reduce_body(r);
}

// a variant's sweep (i = 0) or weight-gradient pass (1)
template <bool STASH>
static const void* fc_kernel(int i) {
  if (i) return (const void*)geometry_bwd_chains_wgf_wgrad;
  if constexpr (STASH) return (const void*)geometry_bwd_stash_wgf_sweep;
  else return (const void*)geometry_bwd_split_wgf_sweep;
}

// Integer arguments: [L, multires, d_embed, n, grid, n_tiles, S, per,
// stash_cols, then per layer ins[L], outs[L], enc[L], f_off[L], r_off[L],
// r_cols[L]] (ops/geometry_kernel.chains_wg_plan: K1-bwd's slab packs'
// layouts; n_tiles tiles of 64 points; S chunks of per 32-point image tiles
// for the weight-gradient pass, K1-bwd's; stash_cols 0 for the split).
// Pointers: [x, ct_out, ct_grad, ct_x, scratch, images, db slots, dW
// slots, grads, forward pack, reverse pack, then b[L] (the split) or the
// bf16 stash [n][stash_cols] (the stash)]; grads receives, per layer, dW
// as [in][out] followed by db [out].  Returns a cudaError_t value; 0 when
// the three launches were accepted.
template <bool STASH>
static int launch_chains(const int* ia, const unsigned long long* p,
                         float scale, unsigned long long stream) {
  FcDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_embed = ia[2];
  d.n = ia[3];
  const int grid = ia[4];
  d.n_tiles = ia[5];
  const int S = ia[6], per = ia[7];
  d.stash_cols = ia[8];
  const int L = d.L, de = d.d_embed;
  if (L < 2 || L > GW_MAXL || de > FC_EW || de != 3 * (1 + 2 * d.multires) ||
      grid < 1 || d.n_tiles < 1 || S < 1 || per < 1 ||
      (long long)d.n_tiles * FC_PTS < d.n ||
      (long long)(d.n_tiles - 1) * FC_PTS >= d.n ||
      (STASH ? d.stash_cols < 1 : d.stash_cols != 0))
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
  d.stash = STASH ? (const __nv_bfloat16*)p[11] : nullptr;
  const int* q = ia + 9;
  long long off = 0;
  int scol = 0;
  for (int l = 0; l < L; ++l) {
    d.ins[l] = q[l];
    d.outs[l] = q[L + l];
    d.enc[l] = q[2 * L + l];
    d.f_off[l] = q[3 * L + l];
    d.r_off[l] = q[4 * L + l];
    const int r_cols = q[5 * L + l];
    d.r_bytes[l] = 2 * r_cols * 128;
    d.b[l] = STASH ? nullptr : (const float*)p[11 + l];
    d.s_col[l] = scol;
    const bool last = l == L - 1;
    if (!last) scol += d.outs[l];
    // layer 0 reads the encoding alone, a skip layer [h | enc] in W's own
    // column order, the last layer h alone
    if (d.ins[l] > (l ? 256 : de) || d.outs[l] > (last ? 264 : 256) ||
        d.outs[l] < 1 || (d.enc[l] != 0 && d.enc[l] != 1) || !d.enc[0] ||
        d.ins[0] != de || (last && d.enc[l]) || r_cols != (l ? 256 : 48) ||
        d.f_off[l] % 1024 || d.r_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
    if (l && d.ins[l] != d.outs[l - 1] + (d.enc[l] ? de : 0))
      return (int)cudaErrorInvalidValue;
    // an image tile's X_l (64 columns for layer 0, 256 for the others) and
    // R_l (256 columns, 264 for a last layer over 256 wide): two a tile
    d.cx[l] = l ? 256 : 64;
    d.cr[l] = d.outs[l] > 256 ? 264 : 256;
    d.x_img[l] = off;
    off += (long long)d.n_tiles * 2 * 2 * d.cx[l] * 32;
    d.r_img[l] = off;
    off += (long long)d.n_tiles * 2 * 2 * d.cr[l] * 32;
  }
  if (STASH && scol != d.stash_cols) return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)FW_NS * FW_STAGE + 64 * 256 * 4 +
                      FC_PTS * 2 * FC_EW * 4 + 2 * FW_NS * 8;
  cudaError_t e = cudaFuncSetAttribute(
      fc_kernel<STASH>(0), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  if constexpr (STASH)
    geometry_bwd_stash_wgf_sweep<<<grid, 384, smem, s>>>(d);
  else
    geometry_bwd_split_wgf_sweep<<<grid, 384, smem, s>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // K1-bwd's weight-gradient pass over the image tiles that hold a point:
  // units (layer, X pair, R half) in that order
  FwgDims w;
  FrDims r;
  r.L = L;
  w.n_img = (d.n + FC_IMG_PTS - 1) / FC_IMG_PTS;
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
  e = cudaFuncSetAttribute(fc_kernel<STASH>(1),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wsmem);
  if (e != cudaSuccess) return (int)e;
  geometry_bwd_chains_wgf_wgrad<<<nu * S, 384, wsmem, s>>>(w);
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
  geometry_bwd_chains_wgf_reduce<<<(int)((r.P + rb - 1) / rb), rb, 0, s>>>(
      r);
  return (int)cudaGetLastError();
}

extern "C" int geometry_bwd_split(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_chains<false>(ia, p, scale, stream);
}

extern "C" int geometry_bwd_stash(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return launch_chains<true>(ia, p, scale, stream);
}

// A variant's sweep and weight-gradient pass as the device holds them,
// read after a launch: out[3 i .. 3 i + 2] = registers a thread, dynamic
// shared memory a block (as the launcher last set it), static shared
// memory, for i = 0 (sweep) and 1 (weight-gradient pass).  Returns a
// cudaError_t value.
template <bool STASH>
static int chains_attrs(int* out) {
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, fc_kernel<STASH>(i));
    if (e != cudaSuccess) return (int)e;
    out[3 * i] = a.numRegs;
    out[3 * i + 1] = a.maxDynamicSharedSizeBytes;
    out[3 * i + 2] = (int)a.sharedSizeBytes;
  }
  return 0;
}

extern "C" int geometry_bwd_split_attrs(int* out) {
  return chains_attrs<false>(out);
}

extern "C" int geometry_bwd_stash_attrs(int* out) {
  return chains_attrs<true>(out);
}
