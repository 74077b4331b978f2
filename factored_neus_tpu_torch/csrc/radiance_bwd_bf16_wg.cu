// K3-bwd-bf16: the backward of K3-fwd in the bf16 operand mode, on Hopper's
// warpgroup tensor cores (wgmma.cuh).  Replaces the TPU kernel
// factored_neus_tpu/ops/pallas_radiance.py _make_radiance(cfg,
// bf16=True).run_bwd (body _build_bwd_kernel, products _mm_fns(True)):
// the forward recomputed (x0 = [pts | PE(dirs) | normals | feat], ReLU
// layers, the last layer's sigmoid), the seed r = ct_rgb y (1 - y), then
// for each layer from the last dW_l = X_l^T R_l with both operands rounded
// to bf16 and an f32 sum, db_l the f32 sum of r, r_in = r W_l and r = r_in
// where a_{l-1} > 0; x0's cotangent split into pts, normals, feat and,
// through the encoding's Jacobian, dirs.  Every product takes bf16 operands
// (nearest even) and sums in f32; everything elementwise stays f32.
//
// Bound: operations, 6 x 271,360 FLOP a row at full width over 989
// TFLOP/s (0.108 ms at 65,536 rows).  Four kernels, launched one after
// another:
//
// 1. The sweep (radiance_bwd_wg_sweep).  A block is one producer
//    warpgroup and nc = 1 or 2 consumer warpgroups, persistent over passes
//    blockIdx.x, + gridDim.x, ...; a consumer's tile is 64 rows, a thread's
//    rows 16 w + g and 16 w + 8 + g (warp w, g = lane / 4).
//    - Products on wgmma with A in registers: a layer's result, after its
//      bias, ReLU and rounding to bf16, is the next product's A
//      (wgmma.cuh).  The forward's pieces are sweep16.cuh's, which
//      K3-fwd-bf16 runs too (the same bits).  B streams as slabs by cp.async.bulk on mbarriers
//      (wg_bwd.cuh's ring): the forward X W from
//      tc_pack.pack_rad_sweep_bf16, the reverse r W from
//      pack_rad_rev_bf16.  Fixed depths: layer 0 reads the feature's 256
//      k (four slabs; its A loaded from device memory and rounded) and
//      the 33 narrow columns [pts | PE(dirs) | normals] at k = 256 (one
//      slab, three k-steps; built in a small shared tile); a hidden layer
//      four slabs; the 3-wide last layer four slabs of 8 columns
//      (m64n8).  Reverse: the last layer one k-step, a hidden layer four
//      slabs, layer 0 an n256 product for the feature's columns (written
//      out as ct_feat), then an n48 product for the narrow ones (m64n48;
//      the encoding's Jacobian applied from the shared tile).  No
//      block-wide barrier in the loop.
//    - No scratch.  The ReLU mask a_l > 0 is taken in f32 in the forward
//      and kept as bits in the thread's registers (128 accumulator values,
//      4 words a layer, at most RW_MAXH hidden layers); the reverse
//      applies it to the f32 r_in before rounding r to the next A.  That
//      is JAX's relu_mask exactly; nothing is recomputed.
//    - Each layer's bf16 X_l (in the forward, from the A fragments) and
//      R_l (in the reverse) go to device memory as tile images (wg_bwd.cuh:
//      16-byte stores, MN-major, 128-byte swizzle): the exact operands of
//      JAX's dot_at.  X_0: the feature's 256 columns in four blocks, the
//      narrow ones in a fifth; R of the last layer one block (8 columns
//      and zeros).
//    - db: each layer's f32 r, a thread's two rows added, then summed over
//      the warp's lane groups by the transposing shuffle (gw_db_reduce),
//      added to the warp's own slot in device memory, tile after tile.
// 2. The weight-gradient pass (radiance_bwd_wg_wgrad, wg_bwd.cuh's, as
//    K1-bwd-bf16's): dW_l = X_l^T R_l split over K, units of (layer, pair
//    of 64-row blocks of dW) x chunks of tiles, m64n256k16 with A and B
//    both MN-major in shared memory (the last layer m64n64k16 on its one
//    R block).  dW_0's rows are 256 + 48: the feature's, then the narrow
//    columns'.
// 3. The reduce: dW the sum of the chunks' slots (radiance_bwd_wg_reduce),
//    db of the warps' slots, a warp an entry (radiance_bwd_wg_reduce_db:
//    1,056 slots at 65,536 rows, which one thread an entry read one after
//    another), each in a fixed order.  No float atomics: two launches are
//    bitwise equal.
//
// Bytes at full width, 65,536 rows (1,024 tiles of 64): the images 304 KB
// a tile written (X 40 + 4 x 32 KB, R 4 x 32 + 8 KB: 311 MB) and read by
// the pass, X once and R once a unit (layer 0 three units, the others two:
// 483 MB), the inputs (feat and 9 narrow columns f32, ct_rgb: 70 MB) and
// the outputs (ct_feat and 9 narrow columns: 70 MB), the slots ~6 MB: ~0.94
// GB, ~0.28 ms at 3.35 TB/s -- against the mma.sync body's ~2.2 GB of
// per-tile partial-slice read-modify-writes and its 40.6 MB scratch
// written once and read twice.  The slab stream (~1.1 MB a pass of two
// tiles) comes from L2.
#include "sweep16.cuh"

struct RwDims {
  int L, multires, d_view, nar, d_feat, d_out, n, nc, ns, n_pass, squeeze;
  int n_slab, n_fwd_slab;  // slabs a pass: the forward's, then the reverse's
  const float *pts, *nrm, *dirs, *feat, *ct_rgb;
  float *ct_pts, *ct_nrm, *ct_dirs, *ct_feat, *dbp;
  uint32_t* masks;         // the ReLU masks' bits, or null
  unsigned char* img;
  const unsigned char *fpack, *rpack;
  int slab_off[RW_MAXS], slab_bytes[RW_MAXS];
  int outs[GW_MAXL], xb[GW_MAXL], rb[GW_MAXL];
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // tile 0's image of each
  const float* b[GW_MAXL];
};

__device__ __forceinline__ void rw_producer(const RwDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x)
    for (int s = 0; s < d.n_slab; ++s, ++it)
      gw_put(d.ns, ring, full, empty, it,
             (s < d.n_fwd_slab ? d.fpack : d.rpack) + d.slab_off[s],
             d.slab_bytes[s]);
}

// r = r_in where the mask m is set, else 0
__device__ __forceinline__ void rw_mask(float (&acc)[128],
                                        const uint32_t (&m)[4]) {
#pragma unroll
  for (int i = 0; i < 128; ++i)
    acc[i] = (m[i >> 5] >> (i & 31)) & 1u ? acc[i] : 0.f;
}

// r (f32) in acc: its bf16 A fragments a, its tile image im, and its
// column sums over the thread's two rows and the warp's lane groups added
// to the warp's db slot row sl (set on the block's first pass)
__device__ __forceinline__ void rw_r_finish(float (&acc)[128],
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
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    acc[4 * q] += acc[4 * q + 2];
    acc[4 * q + 1] += acc[4 * q + 3];
  }
  gw_db_reduce(acc, g);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    float2* o = (float2*)(sl + 64 * m + 8 * g + 2 * t);
    const float2 v = make_float2(acc[32 * m], acc[32 * m + 1]);
    *o = first ? v : make_float2(o->x + v.x, o->y + v.y);
  }
}

__device__ __forceinline__ void rw_consumer(const RwDims& d, int wg,
                                            unsigned char* ring, float* E,
                                            const float* bias,
                                            uint64_t* full, uint64_t* empty) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  const int L = d.L, lL = L - 1, ns = d.ns;
  const int cid = blockIdx.x * d.nc + wg;
  float* dbw = d.dbp + ((size_t)cid * 4 + warp) * L * GW_BW;
  const int rg = 16 * warp + g;      // the thread's rows rg, rg + 8
  float* e0 = E + rg * RW_EW;
  float* e1 = e0 + 8 * RW_EW;
  const uint32_t zero[4] = {0u, 0u, 0u, 0u};
  uint32_t a[16][4];
  float acc[128];
  // the hidden layers' masks, the latest first
  uint32_t mk[RW_MAXH][4];
  int it = 0;

  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
    const bool first = p == blockIdx.x;
    const int tile = p * d.nc + wg;
    const int row0 = tile * RW_TILE;
    const int R0 = row0 + rg, R1 = R0 + 8;
    const bool v0 = R0 < d.n, v1 = R1 < d.n;
    // the narrow columns [pts | PE(dirs) | normals | 0] of each row (every
    // thread is done with the last tile's)
    bar_sync(1 + wg, 128);
    if (tid < RW_TILE)
      rw_narrow_row(E, tid, row0, d.n, d.pts, d.nrm, d.dirs, d.d_view,
                    d.multires, d.nar);
    bar_sync(1 + wg, 128);

    // layer 0's A: the feature (k-steps 0 .. 15) rounded to bf16, and the
    // narrow columns (ef)
    rw_feat_frags(a, d.feat, d.d_feat, R0, R1, v0, v1, t);
    uint32_t ef[3][4];
    rw_narrow_frags(ef, e0, e1, t);
    {
      // X_0's image: the feature in blocks 0 - 3, the narrow columns in
      // block 4
      unsigned char* x0 = d.img + d.x_img[0] + (size_t)tile * d.xb[0];
      gw_img256<8>(x0, a, 16 * warp + g, g, t);
#pragma unroll
      for (int j = 0; j < 3; ++j)
        gw_img<8>(x0 + 4 * GW_XB, j, ef[j], 16 * warp + g, g, t);
      gw_img<8>(x0 + 4 * GW_XB, 3, zero, 16 * warp + g, g, t);
    }

    // the forward, layers 0 .. L - 2
    rw_layer0(ns, it, ring, full, empty, acc, a, ef, lead);
    it += 5;
    for (int l = 0; l < lL; ++l) {
      if (l) {
        rw_layer<256>(ns, it, ring, full, empty, acc, a, lead);
        it += 4;
      }
      uint32_t m[4];
      rw_activate(acc, bias + l * GW_BW, t, a, m);
#pragma unroll
      for (int s = RW_MAXH - 1; s > 0; --s)
#pragma unroll
        for (int w = 0; w < 4; ++w) mk[s][w] = mk[s - 1][w];
#pragma unroll
      for (int w = 0; w < 4; ++w) mk[0][w] = m[w];
      if (d.masks)
        *(uint4*)(d.masks + (((size_t)tile * 128 + tid) * lL + l) * 4) =
            make_uint4(m[0], m[1], m[2], m[3]);
      gw_img256<8>(d.img + d.x_img[l + 1] + (size_t)tile * d.xb[l + 1], a,
                   16 * warp + g, g, t);
    }

    // the last layer (m64n8) and the seed r = ct_rgb y (1 - y): column
    // 2t + (e % 2) of row rg (e < 2) or rg + 8, in ex's k-step 0
    uint32_t ex[1][4];
    {
      float acc8[4];
      rw_last_layer(ns, it, ring, full, empty, acc8, a, lead);
      it += 4;
      float r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 2 * t + (e & 1);
        const int row = e < 2 ? R0 : R1;
        float v = 0.f;
        if ((e < 2 ? v0 : v1) && c < d.d_out) {
          v = d.ct_rgb[(size_t)row * d.d_out + c];
          if (d.squeeze) {
            const float y =
                1.f / (1.f + expf(-(acc8[e] + bias[lL * GW_BW + c])));
            v = v * y * (1.f - y);
          }
        }
        r[e] = v;
      }
      ex[0][0] = pack_bf16(r[0], r[1]);
      ex[0][1] = pack_bf16(r[2], r[3]);
      ex[0][2] = ex[0][3] = 0u;
      // R's image of the last layer: one block, columns 0 .. 15 from ex,
      // the rest zero
      unsigned char* im = d.img + d.r_img[lL] + (size_t)tile * d.rb[lL];
      gw_img<8>(im, 0, ex[0], 16 * warp + g, g, t);
#pragma unroll
      for (int j = 1; j < 4; ++j)
        gw_img<8>(im, j, zero, 16 * warp + g, g, t);
      // db's columns 2t + e: summed over the thread's rows and the warp's
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = r[e] + r[2 + e];
#pragma unroll
        for (int s = 4; s < 32; s <<= 1)
          v += __shfl_xor_sync(0xffffffffu, v, s);
        float* o = dbw + lL * GW_BW + 2 * t + e;
        if (g == 0) *o = first ? v : *o + v;
      }
    }

    // the reverse sweep: r W of layer l (the last layer's one k-step),
    // then through layer l - 1's ReLU
    gw_slab<256, 1, 0, true>(ns, it, ring, full, acc, ex);
    gw_release<1>(ns, it, empty, lead);
    fence_regs(acc);
    it += 1;
    for (int l = lL; l >= 1; --l) {
      if (l < lL) {
        rw_layer<256>(ns, it, ring, full, empty, acc, a, lead);
        it += 4;
      }
      rw_mask(acc, mk[0]);
#pragma unroll
      for (int s = 0; s + 1 < RW_MAXH; ++s)
#pragma unroll
        for (int w = 0; w < 4; ++w) mk[s][w] = mk[s + 1][w];
      rw_r_finish(acc, a, d.img + d.r_img[l - 1] + (size_t)tile * d.rb[l - 1],
                  dbw + (l - 1) * GW_BW, first, warp, g, t);
    }

    // layer 0: x0's cotangent r W_0, the feature's columns (written out),
    // then the narrow ones
    rw_layer<256>(ns, it, ring, full, empty, acc, a, lead);
    it += 4;
#pragma unroll
    for (int q = 0; q < 32; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 8 * q + 2 * t;
        if ((h ? v1 : v0) && c < d.d_feat)
          *(float2*)(d.ct_feat + (size_t)(h ? R1 : R0) * d.d_feat + c) =
              make_float2(acc[4 * q + 2 * h], acc[4 * q + 2 * h + 1]);
      }
    float acc48[24];
    rw_layer<48>(ns, it, ring, full, empty, acc48, a, lead);
    it += 4;
    // the thread's own columns of the narrow tile (it read them last for
    // ef, in this tile's forward)
#pragma unroll
    for (int q = 0; q < 6; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        e0[8 * q + 2 * t + e] = acc48[4 * q + e];
        e1[8 * q + 2 * t + e] = acc48[4 * q + 2 + e];
      }
    bar_sync(1 + wg, 128);
    if (tid < RW_TILE) {
      const int row = row0 + tid;
      if (row < d.n) {
        const float* r = E + tid * RW_EW;
        float u[3], cd[3];
        for (int c = 0; c < 3; ++c) u[c] = d.dirs[(size_t)row * 3 + c];
        encode_backward_row(u, nullptr, d.multires, r + 3, nullptr, cd);
        for (int c = 0; c < 3; ++c) {
          d.ct_pts[(size_t)row * 3 + c] = r[c];
          d.ct_dirs[(size_t)row * 3 + c] = cd[c];
          d.ct_nrm[(size_t)row * 3 + c] = r[3 + d.d_view + c];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(384, 1)
radiance_bwd_wg_sweep(const __grid_constant__ RwDims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  float* E0 = (float*)(ring + (size_t)d.ns * GW_SLAB);
  float* bias = E0 + d.nc * RW_TILE * RW_EW;
  uint64_t* full = (uint64_t*)(bias + d.L * GW_BW);
  uint64_t* empty = full + d.ns;
  if (threadIdx.x == 0) {
    for (int s = 0; s < d.ns; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * d.nc);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < d.L * GW_BW; i += blockDim.x) {
    const int l = i / GW_BW, c = i - l * GW_BW;
    bias[i] = c < d.outs[l] ? d.b[l][c] : 0.f;
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0) rw_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    rw_consumer(d, wg - 1, ring, E0 + (wg - 1) * RW_TILE * RW_EW, bias, full,
                empty);
  }
}

__global__ void __launch_bounds__(384, 1)
radiance_bwd_wg_wgrad(const __grid_constant__ WgDims d) {
  extern __shared__ unsigned char smem_raw[];
  wg_wgrad_body(d, smem_raw);
}

__global__ void radiance_bwd_wg_reduce(const __grid_constant__ RdDims r) {
  wg_reduce_body(r);
}

__global__ void radiance_bwd_wg_reduce_db(const __grid_constant__ RdDims r) {
  wg_db_tree(r);
}

// Integer arguments: [L, multires, d_view, n, nc, grid, n_pass, S, per,
// squeeze_out, masks, then per layer ins[L], outs[L], f_off[L], r_off[L]]
// (ops/radiance_kernel.bwd_wg_plan: the slab packs' layer offsets,
// tc_pack.rad_sweep_layout and rad_rev_layout, whose slab counts and
// widths are this design's; S chunks of per tiles for the weight-gradient
// pass; masks nonzero: the sweep writes its ReLU masks' bits).  Pointers:
// [pts, normals, dirs, feat, ct_rgb, ct_pts, ct_normals, ct_dirs, ct_feat,
// images, db slots, dW slots, grads, forward pack, reverse pack, mask bits
// (read where masks), b[L]]; grads receives, per layer, dW as [in][out]
// followed by db [out].  Returns a cudaError_t value; 0 when the four
// launches were accepted.
extern "C" int radiance_bwd_bf16(const int* ia, const unsigned long long* p,
                                 float scale, unsigned long long stream) {
  (void)scale;
  RwDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_view = ia[2];
  d.n = ia[3];
  d.nc = ia[4];
  const int grid = ia[5];
  d.n_pass = ia[6];
  const int S = ia[7], per = ia[8];
  d.squeeze = ia[9];
  const int want_masks = ia[10];
  const int L = d.L, lL = L - 1;
  const int* q = ia + 11;
  if (L < 2 || L - 1 > RW_MAXH || d.d_view != 3 * (1 + 2 * d.multires) ||
      d.nc < 1 || d.nc > 2 || grid < 1 || d.n_pass < 1 || S < 1 || per < 1)
    return (int)cudaErrorInvalidValue;
  d.nar = 6 + d.d_view;
  d.d_feat = q[0] - d.nar;
  d.d_out = q[L + lL];
  if (d.nar > RW_NAR || d.d_feat < 2 || d.d_feat > 256 || d.d_feat % 2 ||
      d.d_out > RW_LAST)
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
  d.img = (unsigned char*)p[9];
  d.dbp = (float*)p[10];
  d.fpack = (const unsigned char*)p[13];
  d.rpack = (const unsigned char*)p[14];
  d.masks = want_masks ? (uint32_t*)p[15] : nullptr;
  const int n_img = d.n_pass * d.nc;
  int ns = 0;
  auto slab = [&](int off, int bytes) {
    if (ns < RW_MAXS) {
      d.slab_off[ns] = off;
      d.slab_bytes[ns] = bytes;
    }
    ++ns;
  };
  long long off = 0;
  for (int l = 0; l < L; ++l) {
    const int in = q[l], out = q[L + l], fo = q[2 * L + l],
              ro = q[3 * L + l];
    d.outs[l] = out;
    d.b[l] = (const float*)p[16 + l];
    if ((l && in != q[L + l - 1]) || (l && in > 256) ||
        (l < lL && out > 256) || fo % 1024 || ro % 1024)
      return (int)cudaErrorInvalidValue;
    // a tile's images: X_0 five 64-column blocks, X_l four; R_l four, one
    // for the last layer
    d.xb[l] = (l ? 4 : 5) * GW_XB;
    d.rb[l] = (l < lL ? 4 : 1) * GW_XB;
    d.x_img[l] = off;
    off += (long long)n_img * d.xb[l];
    d.r_img[l] = off;
    off += (long long)n_img * d.rb[l];
  }
  // the slabs of a pass: forward layer 0 (the feature's four, the narrow
  // one), each hidden layer's four, the last layer's four of 8 columns;
  // reverse the last layer's one, each hidden layer's four, layer 0's four
  // of 256 columns and four of 48
  ns = rw_fwd_slabs(L, q + 2 * L, d.slab_off, d.slab_bytes, ns);
  d.n_fwd_slab = ns;
  for (int l = lL; l >= 0; --l) {
    const int ro = q[3 * L + l];
    for (int s = 0; s < (l < lL ? 4 : 1); ++s)
      slab(ro + s * GW_SLAB, GW_SLAB);
    if (l == 0)
      for (int s = 0; s < 4; ++s)
        slab(ro + 4 * GW_SLAB + s * RW_NAR * 128, RW_NAR * 128);
  }
  if (ns > RW_MAXS) return (int)cudaErrorInvalidValue;
  d.n_slab = ns;
  const size_t fixed = 1024 + (size_t)d.nc * RW_TILE * RW_EW * 4 +
                       (size_t)L * GW_BW * 4;
  const int nst = (int)((GW_SMEM_MAX - fixed) / ((size_t)GW_SLAB + 16));
  d.ns = nst < GW_MAX_NS ? nst : GW_MAX_NS;
  // a consumer holds every slab of a layer (at most 5) until its products
  // retire
  if (d.ns < 5) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)d.ns * (GW_SLAB + 16);
  cudaError_t e = cudaFuncSetAttribute(
      radiance_bwd_wg_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  radiance_bwd_wg_sweep<<<grid, 128 * (1 + d.nc), smem, s>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // the weight-gradient pass over the tiles that hold a row
  WgDims w;
  RdDims r;
  r.L = L;
  w.n_img = (d.n + RW_TILE - 1) / RW_TILE;
  w.per = per;
  w.S = r.S = S;
  w.img = d.img;
  w.part = (float*)p[11];
  if ((long long)S * per < w.n_img || (long long)(S - 1) * per >= w.n_img)
    return (int)cudaErrorInvalidValue;
  int nmb[GW_MAXL];
  for (int l = 0; l < L; ++l) {
    w.x_img[l] = d.x_img[l];
    w.r_img[l] = d.r_img[l];
    w.xb[l] = d.xb[l];
    w.rb[l] = d.rb[l];
    r.ins[l] = q[l];
    r.outs[l] = q[L + l];
    // X_0's narrow columns in their own order at image column 256, its
    // feature columns and every other X_l's at gw_perm; R_l's at gw_perm,
    // the last layer's in their own order
    r.xn[l] = l ? 0 : d.nar;
    r.xn_at[l] = 256;
    r.rn[l] = l < lL ? 256 : 0;
    nmb[l] = l ? (q[l] + 63) / 64 : 5;
  }
  size_t wsmem;
  int nu;
  const int rc = wg_plan_pass(L, nmb, &w, &r, &wsmem, &nu);
  if (rc) return rc;
  e = cudaFuncSetAttribute(radiance_bwd_wg_wgrad,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wsmem);
  if (e != cudaSuccess) return (int)e;
  radiance_bwd_wg_wgrad<<<nu * S, 384, wsmem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  r.n_wslots = grid * d.nc * 4;
  r.db_tree = 1;
  r.part = w.part;
  r.dbp = d.dbp;
  r.grads = (float*)p[12];
  r.P = 0;
  int n_db = 0;
  for (int l = 0; l < L; ++l) {
    r.P += (long long)q[l] * q[L + l] + q[L + l];
    n_db += q[L + l];
  }
  const int rb = 256;
  radiance_bwd_wg_reduce<<<(int)((r.P + rb - 1) / rb), rb, 0, s>>>(r);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  radiance_bwd_wg_reduce_db<<<(n_db * 32 + rb - 1) / rb, rb, 0, s>>>(r);
  return (int)cudaGetLastError();
}

// The sweep's and the weight-gradient pass's attributes as the device
// holds them, read after a launch: out[3 i .. 3 i + 2] = registers a
// thread, dynamic shared memory a block (as the launcher last set it),
// static shared memory, for i = 0 (sweep) and 1 (weight-gradient pass).
// Returns a cudaError_t value.
extern "C" int radiance_bwd_bf16_attrs(int* out) {
  const void* fns[2] = {(const void*)radiance_bwd_wg_sweep,
                        (const void*)radiance_bwd_wg_wgrad};
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
