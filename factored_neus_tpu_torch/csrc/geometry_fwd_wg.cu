// K1-fwd: fused positional encoding -> SDF MLP -> [sdf/scale | feature] and
// the input gradient dsdf/dx from an in-kernel reverse sweep, in f32 on
// Hopper's warpgroup tensor cores in 3xTF32 (wgmma.cuh; the f32 engine of
// wgf.cuh, which K1-bwd and K3-bwd share).  Replaces the TPU kernel
// factored_neus_tpu/ops/pallas_geometry.py _make_geom.run_fwd (body
// _build_fwd_kernel, f32 products).  Every product runs in 3xTF32
// (small_x big_w + big_x small_w + big_x big_w, 8 k an instruction);
// everything elementwise stays f32.
//
// Bound: operations, 2S + 2(S - s) FLOP a point (S = 524,544 multiply-adds
// at full width, s = 256 x 257 those of the last layer, which the reverse
// sweep skips), three TF32 products' worth over 495 TFLOP/s (0.781 ms at
// 65,536 points).  One kernel, K1-bwd's sweep (geometry_bwd_wg.cu) without
// the tangent rows, the images or the weight-gradient pass:
// - A block is two consumer warpgroups (warps 0-7) and a producer
//   warpgroup (8-11, one thread of which issues the copies; setmaxnreg
//   gives the consumers 240 registers a thread), persistent over tiles
//   blockIdx.x, + gridDim.x, ...; a tile is 64 points (warp w: points
//   16w + g and 16w + 8 + g), consumer c the output columns 128c .. 128c
//   + 127 of every product (m64n128k8; layer 0's r W m64n24k8).
// - The layer input lives in shared memory as an f32 K-major,
//   128-byte-swizzled A tile (64 KB): the tensor core reads big_x from it,
//   small_x is made in registers a slab at a time.  The weights stream as
//   32-k slabs of TF32 big and small halves, two stages of 66 KB:
//   tc_pack.pack_sweep_f32 for X W (K1-bwd's layers, then the last layer's
//   eight slabs, 264 columns wide), pack_rev_f32 for r W (K1-bwd's), k
//   permuted by tc_pack.tf32_slot; each slab's products into a fresh
//   accumulator added to the running sum with rounded adds (the
//   accumulator truncates).
// - The forward through all nine layers: bias, softplus(beta=100) and
//   sigma(100 a) from one exp (sp_sig100), x 1/sqrt 2 and the encoding
//   after h before the skip layer; the last layer's 257 outputs, consumer
//   1's columns 256 .. 263 by an m64n8 k-step beside its m64n128, written
//   out as [sdf / scale | feature] from the accumulators.
// - The reverse from e0 / scale: its first step needs no product, the
//   cotangent of the last layer's input is row 0 of W_last rebuilt
//   exactly as big + small from the reverse pack, / scale; then through
//   sigma(100 a_l), with products r W_l, the skip layer's encoding columns
//   and layer 0's r W_0 (48 columns) into the encoding's cotangent, and
//   the encoding's backward per point to dsdf/dx.
// - sigma(100 a_l) goes to an f32 scratch of thread-owned float4s, written
//   once in the forward and read once in the reverse (prefetched to L2
//   under the products): 8 hidden layers x 256 floats, 8 KB a point each
//   way, 1.07 GB a call at 65,536 points (0.32 ms at 3.35 TB/s); with the
//   inputs (12 B) and outputs (1,040 B) a point, ~1.14 GB, 0.34 ms.
// - From L2 every tile streams 130 slabs, ~8.2 MB (the forward's 66, the
//   reverse's 64): ~8.4 GB a call at 65,536 points.
// - K1-fwd-stash (entry point geometry_fwd_stash, kernel
//   geometry_fwd_stash_wgf_sweep) replaces _make_geom.run_fwd_stash (body
//   _build_fwd_kernel_stashing): the same sweep, which also stores each
//   hidden layer's pre-activation a (the f32 value whose sigma(100 a)
//   goes to the scratch) rounded to bf16 (nearest even) into a side
//   output for K1-bwd-stash: bf16 [n][sum of outs[0 .. L - 2]], layer l
//   from column sum(outs[0 .. l - 1]); the stash never feeds (out, grad),
//   which are K1-fwd's bit for bit.  A row is 2,009 columns at full
//   width, so an odd row starts on a 2-byte boundary: each element is a
//   2-byte store straight from the thread's accumulator entry (the shared
//   memory is full).  4,018 B a point, 263 MB a call at 65,536 points
//   (0.08 ms at 3.35 TB/s); on an H100 the stores cost ~0.4 ms, and
//   neither 4-byte stores nor rows staged for 64-byte stores changed that
//   (PERF.md).
// - Between layers, two named barriers over the two consumers: every
//   product of the layer has read the A tile before it is overwritten, and
//   the new tile is written (and fenced to the async proxy) before any
//   product reads it.
#include "sdf_mlp.cuh"
#include "wgf.cuh"

#define GF_TILE 64         // points of a tile
#define GF_EW 48           // row (floats) of the encoding tiles
#define GF_LASTC 264       // columns of the last layer's forward slabs
#define GF_STAGE (2 * GF_LASTC * 128)   // bytes of a ring stage (67,584)

struct GfDims {
  int L, multires, d_embed, n, n_tiles, d_out, last_cols;
  float scale;
  const float* x;
  float *out, *grad, *scratch;
  const unsigned char *fpack, *rpack;
  int outs[GW_MAXL];
  int enc[GW_MAXL];        // layer l reads [h | enc] (a skip layer)
  int f_off[GW_MAXL];      // byte offset of forward layer l's first slab
  int r_off[GW_MAXL];      // byte offset of reverse layer l's first slab
  int r_bytes[GW_MAXL];    // bytes of one of its reverse slabs
  const float* b[GW_MAXL];
  // K1-fwd-stash: the bf16 stash [n][stash_cols], hidden layer l from
  // column s_off[l]
  __nv_bfloat16* stash;
  int stash_cols;
  int s_off[GW_MAXL];
};

// A tile's slabs: forward layer 0 (two), each hidden layer (eight), the
// last layer (eight, last_cols wide); reverse each hidden layer from the
// last (eight), layer 0 (eight of 48 columns)
__device__ __forceinline__ void gf_producer(const GfDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  const int lL = d.L - 1, last = 2 * d.last_cols * 128;
  int it = 0;
  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    for (int l = 0; l < lL; ++l)
      for (int s = 0; s < (l ? 8 : 2); ++s, ++it)
        fw_put<GF_STAGE>(ring, full, empty, it,
                         d.fpack + d.f_off[l] + s * FW_STAGE, FW_STAGE);
    for (int s = 0; s < 8; ++s, ++it)
      fw_put<GF_STAGE>(ring, full, empty, it, d.fpack + d.f_off[lL] + s * last,
                       last);
    for (int l = lL - 1; l >= 0; --l)
      for (int s = 0; s < 8; ++s, ++it)
        fw_put<GF_STAGE>(ring, full, empty, it,
                         d.rpack + d.r_off[l] + s * d.r_bytes[l],
                         d.r_bytes[l]);
  }
}

template <bool STASH>
__device__ __forceinline__ void gf_consumer(const GfDims& d, int c,
                                            unsigned char* ring,
                                            unsigned char* at, float* E,
                                            float* RE, uint64_t* full,
                                            uint64_t* empty) {
  const int ctid = threadIdx.x, tid = ctid & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  const int n0 = 128 * c;                       // its output columns
  const int rg = 16 * w + g;                    // its points rg, rg + 8
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int L = d.L, lL = L - 1, de = d.d_embed;
  const uint32_t atile = smem_u32(at);
  float4* scr = (float4*)d.scratch + (size_t)blockIdx.x * lL * 16 * 256 + ctid;
  // row 0 of W_last (k slot 0 of its first reverse slab), big and small
  const float* w0 = (const float*)(d.rpack + d.r_off[lL]);
  float acc[64], run[64];
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  int it = 0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const int row0 = tile * GF_TILE;
    const int P0 = row0 + rg, P1 = P0 + 8;
    const bool v0 = P0 < d.n, v1 = P1 < d.n;
    // the encoding, and zero cotangents (both consumers are done with the
    // last tile's)
    bar_sync(1, 256);
    if (ctid < GF_TILE) {
      const int row = row0 + ctid;
      float u[3];
      for (int k = 0; k < 3; ++k)
        u[k] = row < d.n ? d.x[(size_t)row * 3 + k] * d.scale : 0.f;
      float* e = E + ctid * GF_EW;
      encode_row(u, nullptr, d.multires, e, nullptr);
      for (int k = de; k < GF_EW; ++k) e[k] = 0.f;
      for (int k = 0; k < GF_EW; ++k) RE[ctid * GF_EW + k] = 0.f;
    }
    bar_sync(1, 256);
    // X_0: the encoding's 64 columns (zero from d_embed on), consumer 0's
    if (c == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * q + 2 * t + e;
          at_put(at, rg, k, k < GF_EW ? E[rg * GF_EW + k] : 0.f);
          at_put(at, rg + 8, k, k < GF_EW ? E[(rg + 8) * GF_EW + k] : 0.f);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1, 256);

    // the forward, layers 0 .. L - 2: bias + softplus (x 1/sqrt 2 before
    // a skip, the encoding after h there); sigma(100 a) to the scratch
    for (int l = 0; l < lL; ++l) {
      if (l == 0) {
        fw_layer<128, 2, 2, false, GF_STAGE>(it, ring, full, empty, atile,
                                             256, n0, acc, run, none, at, w,
                                             g, t, lead);
        it += 2;
      } else {
        fw_layer<128, 8, 4, false, GF_STAGE>(it, ring, full, empty, atile,
                                             256, n0, acc, run, none, at, w,
                                             g, t, lead);
        it += 8;
      }
      const float* bl = d.b[l];
      const int W = d.outs[l];
      const bool skip = d.enc[l + 1];
      const float post = skip ? inv_sqrt2 : 1.f;
      float4* sl = scr + l * 16 * 256;
      // K1-fwd-stash: the stash rows of points P0 and P1 (none past n)
      __nv_bfloat16 *st0 = nullptr, *st1 = nullptr;
      if (STASH) {
        __nv_bfloat16* st = d.stash + d.s_off[l];
        if (v0) st0 = st + (size_t)P0 * d.stash_cols;
        if (v1) st1 = st + (size_t)P1 * d.stash_cols;
      }
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        float s4[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e, col = n0 + 8 * q + 2 * t + (e & 1);
          const int r = e < 2 ? rg : rg + 8;
          const float a = run[i] + (col < W ? __ldg(bl + col) : 0.f);
          if (STASH && col < W) {
            __nv_bfloat16* st = e < 2 ? st0 : st1;
            if (st) st[col] = __float2bfloat16_rn(a);
          }
          float sp;
          sp_sig100(a, sp, s4[e]);
          float h = sp * post;
          if (col >= W) {
            const int k = col - W;
            h = skip && k < de ? E[r * GF_EW + k] * inv_sqrt2 : 0.f;
          }
          run[i] = h;
        }
        sl[q * 256] = make_float4(s4[0], s4[1], s4[2], s4[3]);
      }
      bar_sync(1, 256);
      at_store(at, run, n0, w, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // the last layer -> [sdf / scale | feature]; consumer 1 also columns
    // 256 .. 263
    {
      const float* bl = d.b[lL];
      const int N = d.d_out;
      float acc8[4], run8[4];
      if (c == 1 && d.last_cols > 256)
        fw_last_layer<true, GF_STAGE>(it, ring, full, empty, atile,
                                      d.last_cols, n0, acc, run, acc8, run8,
                                      at, w, g, t, lead);
      else
        fw_last_layer<false, GF_STAGE>(it, ring, full, empty, atile,
                                       d.last_cols, n0, acc, run, acc8, run8,
                                       at, w, g, t, lead);
      it += 8;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = n0 + 8 * q + 2 * t + (e & 1);
          const bool v = e < 2 ? v0 : v1;
          if (v && col < N)
            d.out[(size_t)(e < 2 ? P0 : P1) * N + col] =
                (run[4 * q + e] + __ldg(bl + col)) *
                (col == 0 ? inv_scale : 1.f);
        }
      if (c == 1 && d.last_cols > 256)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 256 + 2 * t + (e & 1);
          const bool v = e < 2 ? v0 : v1;
          if (v && col < N)
            d.out[(size_t)(e < 2 ? P0 : P1) * N + col] =
                run8[e] + __ldg(bl + col);
        }
    }

    // the reverse from e0 / scale: the last layer's input cotangent is row
    // 0 of W_last / scale, then layer l's r W and layer l - 1's sigma(100 a)
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + 8 * q + 2 * t + e;
        const int o = (col * 32) ^ (((col * 32) >> 5 & 7) << 2);
        const float v = (__ldg(w0 + o) + __ldg(w0 + 256 * 32 + o)) * inv_scale;
        run[4 * q + e] = v;
        run[4 * q + 2 + e] = v;
      }
    for (int l = lL; l >= 1; --l) {
      l2_prefetch_if(scr - ctid + (l - 1) * 16 * 256, 16 * 256 * 16,
                     ctid == 0);
      if (l < lL) {
        fw_layer<128, 8, 4, false, GF_STAGE>(it, ring, full, empty, atile,
                                             256, n0, acc, run, none, at, w,
                                             g, t, lead);
        it += 8;
      }
      // with a skip (layer l reads [h | enc] / sqrt 2), r / sqrt 2 and its
      // encoding columns (W on) added to the point's RE row; then h =
      // sp(a): r = r_h sigma(100 a), zero from column W on
      const float4* sl = scr + (l - 1) * 16 * 256;
      const int W = d.outs[l - 1];
      const bool skip = d.enc[l];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const float4 v = sl[q * 256];
        const float s4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e, col = n0 + 8 * q + 2 * t + (e & 1);
          const int r = e < 2 ? rg : rg + 8;
          float rh = run[i];
          if (skip) {
            rh *= inv_sqrt2;
            if (col >= W && col < W + de) RE[r * GF_EW + col - W] += rh;
          }
          run[i] = col < W ? rh * s4[e] : 0.f;
        }
      }
      bar_sync(1, 256);
      at_store(at, run, n0, w, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }
    {
      // layer 0: r W_0, the encoding's cotangents (consumer c its 24
      // columns)
      float acc24[12], run24[12];
      fw_layer<24, 8, 4, false, GF_STAGE>(it, ring, full, empty, atile, 48,
                                          24 * c, acc24, run24, none, at, w,
                                          g, t, lead);
      it += 8;
#pragma unroll
      for (int q = 0; q < 3; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 24 * c + 8 * q + 2 * t + e;
          if (col < de) {
            RE[rg * GF_EW + col] += run24[4 * q + e];
            RE[(rg + 8) * GF_EW + col] += run24[4 * q + 2 + e];
          }
        }
    }
    bar_sync(1, 256);
    if (ctid < GF_TILE) {
      const int row = row0 + ctid;
      if (row < d.n) {
        float u[3], ct[3];
        for (int k = 0; k < 3; ++k) u[k] = d.x[(size_t)row * 3 + k] * d.scale;
        encode_backward_row(u, nullptr, d.multires, RE + ctid * GF_EW,
                            nullptr, ct);
        for (int k = 0; k < 3; ++k)
          d.grad[(size_t)row * 3 + k] = ct[k] * d.scale;
      }
    }
  }
}

template <bool STASH>
__device__ __forceinline__ void gf_sweep(const GfDims& d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* at = ring + FW_NS * GF_STAGE;
  float* E = (float*)(at + 64 * 256 * 4);
  float* RE = E + GF_TILE * GF_EW;
  uint64_t* full = (uint64_t*)(RE + GF_TILE * GF_EW);
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
    if (threadIdx.x == 256) gf_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    gf_consumer<STASH>(d, threadIdx.x >> 7, ring, at, E, RE, full, empty);
  }
}

__global__ void __launch_bounds__(384, 1)
geometry_fwd_wgf_sweep(const __grid_constant__ GfDims d) {
  gf_sweep<false>(d);
}

__global__ void __launch_bounds__(384, 1)
geometry_fwd_stash_wgf_sweep(const __grid_constant__ GfDims d) {
  gf_sweep<true>(d);
}

// Integer arguments: [L, multires, d_embed, n, grid, n_tiles, then per
// layer ins[L], outs[L], enc[L], f_off[L], r_off[L], r_cols[L], then the
// last layer's forward slab columns, and for K1-fwd-stash the stash's
// columns] (ops/geometry_kernel.fwd_wg_plan: the two f32 slab packs'
// layouts, tc_pack.pack_sweep_f32 and pack_rev_f32).  Pointers: [x, out,
// grad, scratch, (K1-fwd-stash: the bf16 stash,) forward pack, reverse
// pack, b[L]].  Returns a cudaError_t value; 0 when the launch was
// accepted.
static int gf_launch(const int* ia, const unsigned long long* p,
                     float scale, unsigned long long stream, bool stash) {
  GfDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_embed = ia[2];
  d.n = ia[3];
  const int grid = ia[4];
  d.n_tiles = ia[5];
  const int L = d.L, lL = L - 1, de = d.d_embed;
  const int* q = ia + 6;
  d.last_cols = q[6 * L];
  if (L < 2 || L > GW_MAXL || de > GF_EW || de != 3 * (1 + 2 * d.multires) ||
      grid < 1 || d.n_tiles < 1 || (long long)d.n_tiles * GF_TILE < d.n ||
      (d.last_cols != 256 && d.last_cols != GF_LASTC))
    return (int)cudaErrorInvalidValue;
  d.scale = scale;
  d.x = (const float*)p[0];
  d.out = (float*)p[1];
  d.grad = (float*)p[2];
  d.scratch = (float*)p[3];
  const int pk = stash ? 5 : 4;     // the packs' pointers
  d.stash = stash ? (__nv_bfloat16*)p[4] : nullptr;
  d.fpack = (const unsigned char*)p[pk];
  d.rpack = (const unsigned char*)p[pk + 1];
  int cols = 0;
  for (int l = 0; l < L; ++l) {
    const int in = q[l];
    d.outs[l] = q[L + l];
    d.enc[l] = q[2 * L + l];
    d.f_off[l] = q[3 * L + l];
    d.r_off[l] = q[4 * L + l];
    const int r_cols = q[5 * L + l];
    d.r_bytes[l] = 2 * r_cols * 128;
    d.b[l] = (const float*)p[pk + 2 + l];
    d.s_off[l] = cols;
    const bool last = l == lL;
    if (!last) cols += d.outs[l];
    // layer 0 reads the encoding alone, a skip layer [h | enc] in W's own
    // column order, the last layer h alone
    if (in > (l ? 256 : de) || d.outs[l] > (last ? d.last_cols : 256) ||
        d.outs[l] < 1 || (d.enc[l] != 0 && d.enc[l] != 1) || !d.enc[0] ||
        in != (l ? in : de) || (last && d.enc[l]) ||
        r_cols != (l ? 256 : 48) || d.f_off[l] % 1024 || d.r_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
    if (l && in != d.outs[l - 1] + (d.enc[l] ? de : 0))
      return (int)cudaErrorInvalidValue;
  }
  // the stash's rows hold every hidden layer's columns, no more
  d.stash_cols = stash ? q[6 * L + 1] : 0;
  if (stash && d.stash_cols != cols) return (int)cudaErrorInvalidValue;
  d.d_out = d.outs[lL];
  const size_t smem = 1024 + (size_t)FW_NS * GF_STAGE + 64 * 256 * 4 +
                      2 * GF_TILE * GF_EW * 4 + 2 * FW_NS * 8;
  const void* fn = stash ? (const void*)geometry_fwd_stash_wgf_sweep
                         : (const void*)geometry_fwd_wgf_sweep;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (stash)
    geometry_fwd_stash_wgf_sweep<<<grid, 384, smem, (cudaStream_t)stream>>>(
        d);
  else
    geometry_fwd_wgf_sweep<<<grid, 384, smem, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

// K1-fwd.
extern "C" int geometry_fwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  return gf_launch(ia, p, scale, stream, false);
}

// K1-fwd-stash: K1-fwd's arguments and the stash (gf_launch).
extern "C" int geometry_fwd_stash(const int* ia, const unsigned long long* p,
                                  float scale, unsigned long long stream) {
  return gf_launch(ia, p, scale, stream, true);
}

// A sweep's attributes as the device holds them, read after a launch:
// out[0 .. 2] = registers a thread, dynamic shared memory a block (as the
// launcher last set it), static shared memory.  Returns a cudaError_t
// value.
static int sweep_attrs(const void* kernel, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}

extern "C" int geometry_fwd_attrs(int* out) {
  return sweep_attrs((const void*)geometry_fwd_wgf_sweep, out);
}

extern "C" int geometry_fwd_stash_attrs(int* out) {
  return sweep_attrs((const void*)geometry_fwd_stash_wgf_sweep, out);
}
