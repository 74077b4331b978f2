// K1-bwd-bf16: the backward of K1-fwd in the bf16 operand mode, on Hopper's
// warpgroup tensor cores (wgmma.cuh).  Replaces the TPU kernel
// factored_neus_tpu/ops/pallas_geometry.py _make_geom.run_bwd with
// bf16=True (body _build_bwd_kernel_stacked, products _mm_fns(bf16=True)):
// the primal forward and a forward tangent along ct_grad recomputed as
// stacked rows (primal: bias and softplus(beta=100); tangent: sigma(100 a)
// ad), their f32 pre-activations kept, both chains swept in reverse from
// the seeds ct_out (column 0 / scale) and e0 / scale, dW = X^T R with both
// operands rounded to bf16 and an f32 sum, db the f32 sum of the primal
// R, ct_x through the encoding's backward (the eikonal Hessian-vector
// term included).  Every product takes bf16 operands (nearest even) and
// sums in f32; everything elementwise stays f32.
//
// Bound: operations, 5,768,704 FLOP a point at full width over 989 TFLOP/s
// (0.382 ms at 65,536 points).  Three kernels, launched one after another:
//
// 1. The sweep (geometry_bwd_wg_sweep).  A block is one producer
//    warpgroup and nc = 1 or 2 consumer warpgroups, persistent over passes
//    blockIdx.x, + gridDim.x, ...; a consumer's tile is 32 points, 64
//    stacked rows.
//    - Stacked rows in one thread.  Warp w of a consumer holds the
//      primal rows of points 8w .. 8w + 7 as rows 16w + g and their
//      tangent rows as rows 16w + 8 + g of the m64 tile (g = lane / 4):
//      in wgmma's accumulator a thread then holds a point's primal and
//      tangent values of the same columns (registers 4q + 0, 1 and 4q +
//      2, 3), so sigma(100 a) ad and r_h s + rd_h ds ad need no exchange
//      between warps.  Any order of the rows is the same product.
//    - Products on wgmma m64n256k16 (layer 0's r W on m64n48k16) with A
//      in registers: a layer's result, after its elementwise step and
//      rounding to bf16, is the next product's A.  B streams as slabs by
//      cp.async.bulk on mbarriers, as in K2-bf16 (sdf_fwd_bf16.cu): the
//      forward X W from pack_sweep_bf16's slabs, the reverse r W from
//      pack_rev_bf16's (W itself: the B of r W is W with k its output).
//      Fixed depths: 256 rows a hidden layer, the encoding's 48 in one
//      more slab, a 257-wide last layer's output 256 in a fifth slab (one
//      k-step read).  No block-wide barrier in the loop.
//    - The f32 scratch holds sigma(100 a) and ad (what the reverse step
//      reads of a; JAX keeps a, from which both derive alike), a thread's
//      own values as float4s in its own order: written once in the
//      forward, read once in the reverse, layers read first written last.
//    - Each layer's bf16 X_l (in the forward, from the A fragments) and
//      R_l (in the reverse) go to device memory as tile images: the exact
//      operands of JAX's dot_at, MN-major with the 128-byte swizzle
//      (wgmma.cuh), one 4-byte pair a store.  MN-major because a thread
//      holds neighbouring columns of a row, which that layout keeps
//      together; the K-major one would need a transpose through shared
//      memory, which the ring leaves no room for.
//    - db: each layer's f32 primal R, summed over the warp's 8 points by
//      a transposing shuffle reduction (each lane ends with 8 column
//      sums), is added to the warp's own slot in device memory, tile
//      after tile in order.
//    - ct_x: the encoding's cotangents of the skip layer and layer 0 in
//      shared memory, then pe_backward per point.
// 2. The weight-gradient pass (geometry_bwd_wg_wgrad): dW_l = X_l^T R_l
//    over all stacked rows, split over K: a block takes a (layer, pair of
//    64-row blocks of dW, chunk of tiles); its producer streams each
//    tile's R_l image and the two X_l blocks into a ring, its two
//    consumers run wgmma m64n256k16 (+ m64n64k16 for a 257-wide layer)
//    with A and B both MN-major from shared memory.  A consumer's
//    accumulator sums its whole chunk (wgmma adds each k-step rounding
//    toward zero, tools/tf32_mma_probe.py: over ~1,200 k-steps a bias of
//    a few 1e-5 of an entry, far under the bf16 operands' rounding) and
//    is then stored to its f32 slot in device memory, in its own register
//    order.
// 3. The reduce (geometry_bwd_wg_reduce): dW the sum of the chunks' slots
//    and db of the warps' slots, each in a fixed order.  No float atomics:
//    two launches are bitwise equal.
// The slab ring, the image writers, the db reduction, the pass and the
// reduce are wg_bwd.cuh's, which K3-bwd-bf16 (radiance_bwd_bf16_wg.cu)
// shares; softplus and sigma(100 a) on the SFU sweep16.cuh's, which
// K2-bf16 and K1-fwd-bf16 share; their arithmetic is the same as before
// they moved there.
//
// Bytes at full width, 65,536 points (2,048 tiles): the scratch 524 KB a
// tile written and read (2.15 GB), the images 590 KB a tile written (X 8
// and 32 KB, R 32 KB, the last layer's 40 KB: 1.21 GB) and read by the
// weight-gradient pass, the R images twice where a layer's dW has four
// 64-row blocks (1.69 GB; the second read may come from L2), its slots
// ~19 MB, db's ~10 MB: ~5.05 GB, ~1.5 ms at 3.35 TB/s (chip_smoke.py
// counts it) -- against ~8.6 GB of partial-slice read-modify-writes and
// ~3.2 GB of scratch in the mma.sync body.  The products need 0.38 ms at
// the bf16 rate.
#include "sweep16.cuh"

#define GW_EW 48          // row (floats) of the encoding tiles
#define GW_PTS 32         // points of a consumer's tile (64 stacked rows)

struct GwDims {
  int L, multires, d_embed, n, nc, ns, n_pass, n_img;
  float scale;
  const float *x, *ct_out, *ct_g;
  float *ct_x, *scratch, *dbp;
  unsigned char* img;
  const unsigned char *fpack, *rpack;
  int ins[GW_MAXL], outs[GW_MAXL];
  int enc[GW_MAXL];        // layer l reads the encoding (layer 0, a skip)
  int f_nslab[GW_MAXL];    // forward slabs of layer l (l < L - 1)
  int f_off[GW_MAXL];      // byte offset of its first (pack_sweep_bf16)
  int r_nslab[GW_MAXL];    // reverse slabs of layer l
  int r_off[GW_MAXL];      // byte offset of its first (pack_rev_bf16)
  int r_copy[GW_MAXL];     // bytes of one of its reverse slabs
  int xb[GW_MAXL], rb[GW_MAXL];   // bytes of a tile's X_l and R_l images
  long long x_img[GW_MAXL], r_img[GW_MAXL];   // tile 0's image of each
  const float* b[GW_MAXL];
};

// -- the sweep ---------------------------------------------------------------

__device__ __forceinline__ void gw_producer(const GwDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
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

// Bias + softplus and sigma(100 a) ad (x 1/sqrt 2 before a skip, SKIP) of
// a forward layer's stacked result, rounded to bf16: the next layer's A
// fragments; sigma(100 a) and ad (f32) to the layer's scratch sc.
template <bool SKIP>
__device__ __forceinline__ void gw_activate(const float (&acc)[128],
                                            const float* bl, int t,
                                            uint32_t (&a)[16][4],
                                            float4* sc) {
  const float post = SKIP ? 0.70710678118654752f : 1.f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * j + h;
      const float2 bb = *(const float2*)(bl + 8 * q + 2 * t);
      const float a0 = acc[4 * q] + bb.x, a1 = acc[4 * q + 1] + bb.y;
      const float ad0 = acc[4 * q + 2], ad1 = acc[4 * q + 3];
      const float s0 = sig100_sfu(a0), s1 = sig100_sfu(a1);
      sc[q * 128] = make_float4(s0, s1, ad0, ad1);
      a[j][2 * h] = pack_bf16(sp100_sfu(a0) * post, sp100_sfu(a1) * post);
      a[j][2 * h + 1] = pack_bf16(s0 * ad0 * post, s1 * ad1 * post);
    }
}

__device__ __forceinline__ void gw_consumer(const GwDims& d, int wg,
                                            unsigned char* ring, float* E,
                                            float* RE, const float* bias,
                                            uint64_t* full, uint64_t* empty) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pt = 8 * warp + g;                  // this thread's point
  const int lead = lane == 0;
  const float inv_sqrt2 = 0.70710678118654752f;
  const int L = d.L, lL = L - 1, de = d.d_embed;
  const int cid = blockIdx.x * d.nc + wg;
  float4* scr = (float4*)d.scratch + (size_t)cid * lL * 32 * 128 + tid;
  float* dbw = d.dbp + ((size_t)cid * 4 + warp) * L * GW_BW;
  const float* ep = E + pt * 2 * GW_EW;
  const float* et = ep + GW_EW;
  float* rp = RE + pt * 2 * GW_EW;
  float* rt = rp + GW_EW;
  uint32_t a[16][4];
  float acc[128];
  int it = 0;

  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
    const bool first = p == blockIdx.x;
    const int tile = p * d.nc + wg;
    const int P = tile * GW_PTS + pt;
    // the encoding and its tangent, and zero cotangents (every thread is
    // done with the last tile's)
    bar_sync(1 + wg, 128);
    if (tid < GW_PTS) {
      const int row = tile * GW_PTS + tid;
      float u[3], v[3];
      for (int c = 0; c < 3; ++c) {
        u[c] = row < d.n ? d.x[(size_t)row * 3 + c] * d.scale : 0.f;
        v[c] = row < d.n ? d.ct_g[(size_t)row * 3 + c] * d.scale : 0.f;
      }
      float* e = E + tid * 2 * GW_EW;
      encode_row(u, v, d.multires, e, e + GW_EW);
      for (int c = de; c < GW_EW; ++c) e[c] = e[GW_EW + c] = 0.f;
      for (int c = 0; c < 2 * GW_EW; ++c) RE[tid * 2 * GW_EW + c] = 0.f;
    }
    bar_sync(1 + wg, 128);

    // the stacked forward, layers 0 .. L - 2
    for (int l = 0; l < lL; ++l) {
      uint32_t ef[3][4];
      if (d.enc[l]) {
        const float sc = l == 0 ? 1.f : inv_sqrt2;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int c = 16 * j + 2 * t;
          ef[j][0] = pack_bf16(ep[c] * sc, ep[c + 1] * sc);
          ef[j][1] = pack_bf16(et[c] * sc, et[c + 1] * sc);
          ef[j][2] = pack_bf16(ep[c + 8] * sc, ep[c + 9] * sc);
          ef[j][3] = pack_bf16(et[c + 8] * sc, et[c + 9] * sc);
        }
      }
      if (l == 0) {
        unsigned char* x0 = d.img + d.x_img[0] + (size_t)tile * d.xb[0];
        const uint32_t zero[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 3; ++j)
          gw_img<8>(x0, j, ef[j], 16 * warp + g, g, t);
        gw_img<8>(x0, 3, zero, 16 * warp + g, g, t);
        gw_fwd_layer<false, true>(d.ns, it, ring, full, empty, acc, a, ef,
                                  lead);
      } else if (d.enc[l]) {
        gw_fwd_layer<true, true>(d.ns, it, ring, full, empty, acc, a, ef,
                                 lead);
      } else {
        gw_fwd_layer<true, false>(d.ns, it, ring, full, empty, acc, a, ef,
                                  lead);
      }
      it += d.f_nslab[l];
      const float* bl = bias + l * GW_BW;
      float4* sl = scr + l * 32 * 128;
      unsigned char* xn =
          d.img + d.x_img[l + 1] + (size_t)tile * d.xb[l + 1];
      if (d.enc[l + 1]) {
        gw_activate<true>(acc, bl, t, a, sl);
        gw_img256_skip<8>(xn, a, ep, et, d.outs[l], de, 16 * warp + g, g,
                          t);
      } else {
        gw_activate<false>(acc, bl, t, a, sl);
        gw_img256<8>(xn, a, 16 * warp + g, g, t);
      }
    }

    // the reverse sweep (wg_bwd.cuh)
    gw_reverse(d, it, ring, full, empty, acc, a, tile, P, scr, dbw, rp, rt,
               first, tid, lead);
    bar_sync(1 + wg, 128);
    if (tid < GW_PTS) {
      const int row = tile * GW_PTS + tid;
      if (row < d.n) {
        float u[3], v[3], ct[3];
        for (int c = 0; c < 3; ++c) {
          u[c] = d.x[(size_t)row * 3 + c] * d.scale;
          v[c] = d.ct_g[(size_t)row * 3 + c] * d.scale;
        }
        const float* r = RE + tid * 2 * GW_EW;
        encode_backward_row(u, v, d.multires, r, r + GW_EW, ct);
        for (int c = 0; c < 3; ++c)
          d.ct_x[(size_t)row * 3 + c] = ct[c] * d.scale;
      }
    }
  }
}

__global__ void __launch_bounds__(384, 1)
geometry_bwd_wg_sweep(const __grid_constant__ GwDims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  float* E0 = (float*)(ring + (size_t)d.ns * GW_SLAB);
  float* RE0 = E0 + d.nc * GW_PTS * 2 * GW_EW;
  float* bias = RE0 + d.nc * GW_PTS * 2 * GW_EW;
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
    if (threadIdx.x == 0) gw_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    const size_t tile_f = (size_t)GW_PTS * 2 * GW_EW;
    gw_consumer(d, wg - 1, ring, E0 + (wg - 1) * tile_f,
                RE0 + (wg - 1) * tile_f, bias, full, empty);
  }
}

// -- the weight-gradient pass ------------------------------------------------

__global__ void __launch_bounds__(384, 1)
geometry_bwd_wg_wgrad(const __grid_constant__ WgDims d) {
  extern __shared__ unsigned char smem_raw[];
  wg_wgrad_body(d, smem_raw);
}

// -- the reduce --------------------------------------------------------------

__global__ void geometry_bwd_wg_reduce(const __grid_constant__ RdDims r) {
  wg_reduce_body(r);
}

// Integer arguments: [L, multires, d_embed, n, nc, grid, n_pass, S, per,
// then per layer ins[L], outs[L], enc[L], f_nslab[L], f_off[L],
// r_nslab[L], r_off[L], r_cols[L]] (ops/geometry_kernel.bwd_wg_iargs: the
// two slab packs' layouts, tc_pack.SweepLayout; S chunks of per tiles for
// the weight-gradient pass).  Pointers: [x, ct_out, ct_grad, ct_x, scratch,
// images, db slots, dW slots, grads, forward pack, reverse pack, b[L]];
// grads receives, per layer, dW as [in][out] followed by db [out].
// Returns a cudaError_t value; 0 when the three launches were accepted.
extern "C" int geometry_bwd_bf16(const int* ia, const unsigned long long* p,
                                 float scale, unsigned long long stream) {
  GwDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_embed = ia[2];
  d.n = ia[3];
  d.nc = ia[4];
  const int grid = ia[5];
  d.n_pass = ia[6];
  const int S = ia[7], per = ia[8];
  const int L = d.L;
  if (L < 2 || L > GW_MAXL || d.d_embed > GW_EW ||
      d.d_embed != 3 * (1 + 2 * d.multires) || d.nc < 1 || d.nc > 2 ||
      grid < 1 || d.n_pass < 1 || S < 1 || per < 1)
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
  d.n_img = d.n_pass * d.nc;
  const int* q = ia + 9;
  long long off = 0;
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
    d.b[l] = (const float*)p[11 + l];
    const bool last = l == L - 1;
    // layer 0 reads the encoding alone, a skip layer [h | enc], the last
    // layer h alone
    if (d.ins[l] > 256 || d.outs[l] > (last ? 264 : 256) ||
        (d.enc[l] != 0 && d.enc[l] != 1) || (l == 0 && !d.enc[0]) ||
        (l == 0 && d.ins[0] != d.d_embed) || (last && d.enc[l]) ||
        (!last && d.f_nslab[l] != (l ? 4 : 0) + d.enc[l]) ||
        d.r_nslab[l] != 4 + (d.outs[l] > 256) ||
        r_cols != (l ? 256 : 48) || d.f_off[l] % 1024 || d.r_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
    if (l && d.ins[l] != d.outs[l - 1] + (d.enc[l] ? d.d_embed : 0))
      return (int)cudaErrorInvalidValue;
    // a tile's images: X_0 one 64-column block, X_l four; R_l four, five
    // for a last layer over 256 wide
    d.xb[l] = (l ? 4 : 1) * GW_XB;
    d.rb[l] = (d.outs[l] > 256 ? 5 : 4) * GW_XB;
    d.x_img[l] = off;
    off += (long long)d.n_img * d.xb[l];
    d.r_img[l] = off;
    off += (long long)d.n_img * d.rb[l];
  }
  const size_t fixed = 1024 + (size_t)d.nc * 2 * GW_PTS * 2 * GW_EW * 4 +
                       (size_t)L * GW_BW * 4;
  const int ns = (int)((GW_SMEM_MAX - fixed) / ((size_t)GW_SLAB + 16));
  d.ns = ns < GW_MAX_NS ? ns : GW_MAX_NS;
  // a consumer holds every slab of a layer (at most 5) until its products
  // retire
  if (d.ns < 5) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)d.ns * (GW_SLAB + 16);
  cudaError_t e = cudaFuncSetAttribute(
      geometry_bwd_wg_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  geometry_bwd_wg_sweep<<<grid, 128 * (1 + d.nc), smem, s>>>(d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  // the weight-gradient pass over the tiles that hold a point
  WgDims w;
  RdDims r;
  r.L = L;
  w.n_img = (d.n + GW_PTS - 1) / GW_PTS;
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
  e = cudaFuncSetAttribute(geometry_bwd_wg_wgrad,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)wsmem);
  if (e != cudaSuccess) return (int)e;
  geometry_bwd_wg_wgrad<<<nu * S, 384, wsmem, s>>>(w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  r.n_wslots = grid * d.nc * 4;
  r.db_tree = 0;
  r.part = w.part;
  r.dbp = d.dbp;
  r.grads = (float*)p[8];
  r.P = 0;
  for (int l = 0; l < L; ++l)
    r.P += (long long)d.ins[l] * d.outs[l] + d.outs[l];
  const int rb = 256;
  geometry_bwd_wg_reduce<<<(int)((r.P + rb - 1) / rb), rb, 0, s>>>(r);
  return (int)cudaGetLastError();
}

// The sweep's and the weight-gradient pass's attributes as the device
// holds them, read after a launch: out[3 i .. 3 i + 2] = registers a
// thread, dynamic shared memory a block (as the launcher last set it),
// static shared memory, for i = 0 (sweep) and 1 (weight-gradient pass).
// Returns a cudaError_t value.
extern "C" int geometry_bwd_bf16_attrs(int* out) {
  const void* fns[2] = {(const void*)geometry_bwd_wg_sweep,
                        (const void*)geometry_bwd_wg_wgrad};
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
