// K1-fwd-bf16: fused positional encoding -> SDF MLP -> [sdf/scale | feature]
// and the input gradient dsdf/dx from an in-kernel reverse sweep, in the bf16
// operand mode on Hopper's warpgroup tensor cores (wgmma.cuh).  Replaces the
// TPU kernel factored_neus_tpu/ops/pallas_geometry.py _make_geom.run_fwd
// with bf16=True (body _build_fwd_kernel, products _mm_fns(bf16=True), the
// JAX step's default): every product takes both operands rounded to bf16
// (nearest even) and sums in f32; the encoding, biases, softplus(beta=100),
// the skip's 1/sqrt 2 and the reverse sweep's sigma(100 a) stay f32.
//
// Bound: operations, 2S + 2(S - s) FLOP a point (S = 524,544 multiply-adds
// at full width, s = 256 x 257 those of the last layer, which the reverse
// skips) over 989 TFLOP/s: 0.130 ms at 65,536 points.  One kernel, K1-bwd-
// bf16's sweep (geometry_bwd_bf16_wg.cu) without the tangent rows, the
// images, the db slots or the weight-gradient pass:
// - A block is one producer warpgroup and nc = 1 or 2 consumer warpgroups,
//   each owning a 64-point tile (a pass: 64 nc points), persistent over
//   passes blockIdx.x, + gridDim.x, ...; setmaxnreg gives the producer 24
//   registers a thread and the consumers 240.
// - The forward is K2-bf16's, the same code (sweep16.cuh's sw_forward over
//   tc_pack.pack_sweep_bf16's slabs, sweep16): m64n256k16 with A in
//   registers, a layer's accumulator after bias and softplus (x 1/sqrt 2
//   before the skip) rounded to bf16 being the next A; the last layer's
//   257 outputs on m64n256 + m64n8 from its 264-wide slabs (33 KB ring
//   stages), written out as [sdf / scale | feature].  So out is K2-bf16's
//   full output, bit for bit.
// - The reverse from e0 / scale.  Its first step needs no product: JAX's
//   dot rounds e0 / scale and W_last's column 0 to bf16, and their one
//   product is exact in f32, so the last layer's input cotangent is
//   bf16(1 / scale) x bf16(W_last[0, c]), read from row 0 of the reverse
//   pack's first last-layer slab (tc_pack.pack_rev_bf16, rev16).  Then
//   through sigma(100 a_l) in f32 (r = r_in sigma), rounded to bf16 as the
//   next A; the products r W_l from rev16's slabs (m64n256k16), the skip
//   layer's r W / sqrt 2 split into h's columns and the encoding's, layer
//   0's r W_0 (m64n48k16) into the encoding's cotangent, and the
//   encoding's backward per point to dsdf/dx.
// - sigma(100 a_l) is what the reverse reads of a; 8 hidden layers x 128
//   values a thread do not fit in registers beside the sweep's 192, and
//   recomputing them would repeat the forward's products.  So they go to
//   an f32 scratch (not rounded: JAX's sigmoid reads the f32 a) of
//   thread-owned float4s, written once in the forward and read once in
//   the reverse, the last written first (sw_activate's order: each store
//   and load of a warpgroup 2 KB contiguous).  softplus and sigma share
//   one exp (sp_sig100_sfu).  The stores go out while the next layer's
//   products run; each layer's scratch is sent on to L2
//   (cp.async.bulk.prefetch) while the reverse product before it runs.
// - No block-wide barrier in the loop: the ring's mbarriers, and two named
//   barriers of a consumer's 128 threads around its encoding tiles.
//
// Bytes at full width, 65,536 points (1,024 tiles): the scratch 512 KB a
// tile written and read, 1.07 GB (0.32 ms at 3.35 TB/s: more than the
// bound; the live set of 264 consumers, 135 MB, does not fit the 50 MB
// L2); the points read (12 B) and out and grad written (1,040 B), 69 MB.
// From L2 every tile streams 63 slabs of the forward (~2.1 MB) and 32 of
// the reverse (~0.9 MB).
//
// K1-fwd-stash-bf16 (entry point geometry_fwd_stash_bf16, kernel
// geometry_fwd_stash_bf16_sweep) replaces _make_geom.run_fwd_stash with
// bf16=True (body _build_fwd_kernel_stashing): the same sweep, whose
// forward (sw_forward with its STASH flag) also stores each hidden layer's
// pre-activation bf16(acc + bias) (the f32 sum of the bf16 products plus
// the f32 bias, rounded once to nearest even, as JAX's
// ``row.astype(jnp.bfloat16)``) into a side output for K1-bwd-stash-bf16:
// bf16 [n][sum of outs[0 .. L - 2]], layer l from column sum(outs[0 .. l -
// 1]); 2-byte stores straight from the accumulator (an odd row of the
// 2,009-column stash starts on a 2-byte boundary), 4,018 B a point, 263 MB
// a call at 65,536 points (0.08 ms at 3.35 TB/s).  On an H100 they cost
// ~0.7 ms, as much again as the sweep; neither 4-byte stores nor rows staged
// for 128-byte stores changed that (PERF.md).  Its out and grad are
// K1-fwd-bf16's bit for bit.
#include "sweep16.cuh"

#define GB_ENC_RE 48      // row (floats) of a consumer's encoding cotangents

struct GbDims {
  SwDims f;               // the forward: K2-bf16's, with the full output
  float *grad, *scratch;
  const unsigned char* rpack;
  int r_off[SW_MAXL];     // byte offset of reverse layer l's first slab
  int r_copy[SW_MAXL];    // bytes of one of its reverse slabs
  SwStash stash;          // K1-fwd-stash-bf16's
};

// A pass's slabs: the forward's (sw_put_fwd), then the reverse's, layers
// L - 2 .. 0, four each (the last layer's are not streamed: the reverse's
// first step reads its row 0 from device memory)
__device__ __forceinline__ void gb_producer(const GbDims& g,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  const SwDims& d = g.f;
  int it = 0;
  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
    it = sw_put_fwd(d, it, ring, full, empty);
    for (int l = d.L - 2; l >= 0; --l)
      for (int s = 0; s < 4; ++s, ++it)
        gw_put(d.ns, ring, full, empty, it,
               g.rpack + g.r_off[l] + s * g.r_copy[l], g.r_copy[l],
               d.stage_bytes);
  }
}

// The reverse step into layer l - 1: with SKIP (layer l reads [h | enc] /
// sqrt 2), R_in / sqrt 2 and its encoding columns (W on) added to the
// rows' cotangents RE; then r = r_in sigma(100 a_{l-1}) (sc: its float4s),
// zero from column W on; r rounded to bf16 as the next product's A.
template <bool SKIP>
__device__ __forceinline__ void gb_rev_step(float (&acc)[128],
                                            const float4* sc, int W,
                                            int d_embed, float* RE, int r0,
                                            int t, uint32_t (&a)[16][4]) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const float4 v = sc[128 * q];
    const float s[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * q + 2 * t + (e & 1);
      float rh = acc[4 * q + e];
      if (SKIP) {
        rh *= inv_sqrt2;
        if (c >= W && c < W + d_embed)
          RE[(r0 + 8 * (e >> 1)) * GB_ENC_RE + c - W] += rh;
      }
      acc[4 * q + e] = c < W ? rh * s[e] : 0.f;
    }
    a[q >> 1][2 * (q & 1)] = pack_bf16(acc[4 * q], acc[4 * q + 1]);
    a[q >> 1][2 * (q & 1) + 1] = pack_bf16(acc[4 * q + 2], acc[4 * q + 3]);
  }
}

template <bool STASH>
__device__ __forceinline__ void gb_consumer(const GbDims& g, int w,
                                            unsigned char* ring, float* E,
                                            float* RE, const float* bias,
                                            uint64_t* full, uint64_t* empty) {
  const SwDims& d = g.f;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + gr;                 // rows r0 and r0 + 8
  const int lead = lane == 0;
  const int L = d.L, lL = L - 1, de = d.d_embed, ns = d.ns;
  const int stage = d.stage_bytes;
  const int cid = blockIdx.x * d.nc + w;
  float4* scr = (float4*)g.scratch + (size_t)cid * lL * 32 * 128 + tid;
  // the reverse's seed: bf16(1 / scale) and row 0 of W_last's first
  // reverse slab (k 0 of input column c at bf16 element swizzle(64 c))
  const float seed =
      __bfloat162float(__float2bfloat16_rn(1.f / d.scale));
  const unsigned short* w0 = (const unsigned short*)(g.rpack + g.r_off[lL]);
  const uint32_t none[3][4] = {};
  uint32_t a[16][4];
  float acc[128], acc8[4];
  int it = 0;

  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
    const int row0 = (p * d.nc + w) * 64;
    // the encoding tile and zero cotangents (every thread is done with the
    // last tile's)
    bar_sync(1 + w, 128);
    if (tid < 64) {
      sw_encode_row(d, E, tid, row0);
      for (int c = 0; c < GB_ENC_RE; ++c) RE[tid * GB_ENC_RE + c] = 0.f;
    }
    bar_sync(1 + w, 128);

    // the forward (K2-bf16's), sigma(100 a_l) to the scratch
    it = sw_forward<true, STASH>(d, it, row0, ring, E, bias, full, empty,
                                 scr, a, acc, acc8,
                                 STASH ? &g.stash : nullptr);

    // the last layer's input cotangent, then layer l's r W and layer
    // l - 1's step (its scratch on its way to L2 while the product runs)
#pragma unroll
    for (int q = 0; q < 32; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * q + 2 * t + e;
        const int k0 = (64 * c) ^ ((c & 7) << 3);
        const float v = seed * __uint_as_float((uint32_t)__ldg(w0 + k0) << 16);
        acc[4 * q + e] = v;
        acc[4 * q + 2 + e] = v;
      }
    for (int l = lL; l >= 1; --l) {
      if (l < lL) {
        l2_prefetch_if(scr - tid + (l - 1) * 32 * 128, 32 * 128 * 16,
                       tid == 0);
        sw_layer<0, true, false>(ns, stage, it, ring, full, empty, acc, acc8,
                                 a, none, lead);
        it += 4;
      }
      const float4* sl = scr + (l - 1) * 32 * 128;
      if (d.enc[l]) {
        __syncwarp();
        gb_rev_step<true>(acc, sl, d.outs[l - 1], de, RE, r0, t, a);
      } else {
        gb_rev_step<false>(acc, sl, d.outs[l - 1], de, RE, r0, t, a);
      }
    }
    {
      // layer 0: r W_0, the encoding's cotangents
      float acc48[24];
      gw_slab<48, 4, 0, true>(ns, it, ring, full, acc48, a, stage);
      gw_slab<48, 4, 4, false>(ns, it + 1, ring, full, acc48, a, stage);
      gw_slab<48, 4, 8, false>(ns, it + 2, ring, full, acc48, a, stage);
      gw_slab<48, 4, 12, false>(ns, it + 3, ring, full, acc48, a, stage);
      gw_release<4>(ns, it, empty, lead);
      fence_regs(acc48);
      it += 4;
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 6; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * q + 2 * t + e;
          if (c < de) {
            RE[r0 * GB_ENC_RE + c] += acc48[4 * q + e];
            RE[(r0 + 8) * GB_ENC_RE + c] += acc48[4 * q + 2 + e];
          }
        }
    }
    bar_sync(1 + w, 128);
    if (tid < 64) {
      const int row = row0 + tid;
      if (row < d.n) {
        float u[3], ct[3];
        for (int c = 0; c < 3; ++c) u[c] = d.x[(size_t)row * 3 + c] * d.scale;
        encode_backward_row(u, nullptr, d.multires, RE + tid * GB_ENC_RE,
                            nullptr, ct);
        for (int c = 0; c < 3; ++c)
          g.grad[(size_t)row * 3 + c] = ct[c] * d.scale;
      }
    }
  }
}

template <bool STASH>
__device__ __forceinline__ void gb_sweep(const GbDims& g) {
  extern __shared__ unsigned char smem_raw[];
  const SwDims& d = g.f;
  // 1024-byte aligned for the swizzle
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  float* E0 = (float*)(ring + (size_t)d.ns * d.stage_bytes);
  float* RE0 = E0 + d.nc * 64 * SW_EW;
  float* bias = RE0 + d.nc * 64 * GB_ENC_RE;
  uint64_t* full = (uint64_t*)(bias + d.L * SW_BW);
  uint64_t* empty = full + d.ns;
  if (threadIdx.x == 0) {
    for (int s = 0; s < d.ns; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * d.nc);
    }
    mbar_fence_init();
  }
  for (int i = threadIdx.x; i < d.L * SW_BW; i += blockDim.x) {
    const int l = i / SW_BW, c = i - l * SW_BW;
    bias[i] = c < d.outs[l] ? d.b[l][c] : 0.f;
  }
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    regs_dec<24>();
    if (threadIdx.x == 0) gb_producer(g, ring, full, empty);
  } else {
    regs_inc<240>();
    gb_consumer<STASH>(g, wg - 1, ring, E0 + (wg - 1) * 64 * SW_EW,
                       RE0 + (wg - 1) * 64 * GB_ENC_RE, bias, full, empty);
  }
}

__global__ void __launch_bounds__(384, 1)
geometry_fwd_bf16_sweep(const __grid_constant__ GbDims g) {
  gb_sweep<false>(g);
}

__global__ void __launch_bounds__(384, 1)
geometry_fwd_stash_bf16_sweep(const __grid_constant__ GbDims g) {
  gb_sweep<true>(g);
}

// Integer arguments: [L, multires, d_embed, n, nc, grid, n_pass, then per
// layer enc[L], slab_stride[L], off[L], outs[L], r_off[L], r_cols[L]]
// (ops/geometry_kernel.fwd_wg16_plan: sdf_kernel.sweep_iargs' for the
// forward pack, tc_pack.sweep_layout, then the reverse pack's layer
// offsets and slab widths, tc_pack.rev_layout; for K1-fwd-stash-bf16 then
// the stash's columns).  Pointers: [x, out, grad, scratch, (K1-fwd-stash-
// bf16: the bf16 stash,) forward pack, reverse pack, b[L]].  Returns a
// cudaError_t value; 0 when the launch was accepted.
static int gb_launch(const int* ia, const unsigned long long* p, float scale,
                     unsigned long long stream, bool stash) {
  GbDims g;
  SwDims& d = g.f;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_embed = ia[2];
  d.n = ia[3];
  d.nc = ia[4];
  const int grid = ia[5];
  d.n_pass = ia[6];
  d.scale = scale;
  d.x = (const float*)p[0];
  d.out = (float*)p[1];
  g.grad = (float*)p[2];
  g.scratch = (float*)p[3];
  const int pk = stash ? 5 : 4;     // the packs' pointers
  g.stash.p = stash ? (__nv_bfloat16*)p[4] : nullptr;
  d.pack = (const unsigned char*)p[pk];
  g.rpack = (const unsigned char*)p[pk + 1];
  const int L = d.L, lL = L - 1;
  if (L < 2 || L > SW_MAXL || d.d_embed > SW_EW ||
      d.d_embed != 3 * (1 + 2 * d.multires) || d.nc < 1 || d.nc > 2 ||
      grid < 1 || d.n_pass < 1 ||
      (long long)d.n_pass * d.nc * 64 < d.n)
    return (int)cudaErrorInvalidValue;
  int widest = 0, cols = 0;
  for (int l = 0; l < L; ++l) {
    const int* q = ia + 7 + l;
    d.enc[l] = q[0];
    d.slab_stride[l] = q[L];
    d.off[l] = q[2 * L];
    d.outs[l] = q[3 * L];
    g.r_off[l] = q[4 * L];
    const int r_cols = q[5 * L];
    g.r_copy[l] = r_cols * 128;
    d.b[l] = (const float*)p[pk + 2 + l];
    const bool last = l == lL;
    g.stash.off[l] = cols;
    if (!last) cols += d.outs[l];
    d.nslab[l] = (l ? 4 : 0) + (d.enc[l] ? 1 : 0);
    d.skip_next[l] = last ? 0 : q[1];
    // a copy is the slab's first 8 (narrowed last layer), 256 (hidden) or
    // 264 (full last layer) columns
    d.copy_bytes[l] = (last ? (d.outs[l] <= 8 ? 8 : 264) : 256) * 128;
    // layer 0 reads the encoding alone, a skip layer [h | enc], the last
    // layer h alone; the reverse's slabs are 48 columns wide for layer 0
    // (the encoding) and 256 for the others
    if ((l == 0 && !d.enc[l]) || (last && d.enc[l]) ||
        d.slab_stride[l] < d.copy_bytes[l] || d.off[l] % 1024 ||
        d.slab_stride[l] % 1024 || d.outs[l] < 1 ||
        d.outs[l] > (last ? 264 : 256) || g.r_off[l] % 1024 ||
        r_cols != (l ? 256 : 48))
      return (int)cudaErrorInvalidValue;
    widest = widest > d.copy_bytes[l] ? widest : d.copy_bytes[l];
  }
  // the stash's rows hold every hidden layer's columns, no more
  g.stash.cols = stash ? ia[7 + 6 * L] : 0;
  if (stash && g.stash.cols != cols) return (int)cudaErrorInvalidValue;
  d.stage_bytes = (widest + 1023) / 1024 * 1024;
  const size_t fixed = 1024 + (size_t)d.nc * 64 * (SW_EW + GB_ENC_RE) * 4 +
                       (size_t)L * SW_BW * 4;
  const int ns = (int)((SW_SMEM_MAX - fixed) /
                       ((size_t)d.stage_bytes + 16));
  d.ns = ns < SW_MAX_NS ? ns : SW_MAX_NS;
  // a consumer holds every slab of a layer (at most 5) until its products
  // retire
  if (d.ns < 5) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)d.ns * (d.stage_bytes + 16);
  const void* fn = stash ? (const void*)geometry_fwd_stash_bf16_sweep
                         : (const void*)geometry_fwd_bf16_sweep;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (stash)
    geometry_fwd_stash_bf16_sweep<<<grid, 128 * (1 + d.nc), smem,
                                    (cudaStream_t)stream>>>(g);
  else
    geometry_fwd_bf16_sweep<<<grid, 128 * (1 + d.nc), smem,
                              (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// K1-fwd-bf16.
extern "C" int geometry_fwd_bf16(const int* ia, const unsigned long long* p,
                                 float scale, unsigned long long stream) {
  return gb_launch(ia, p, scale, stream, false);
}

// K1-fwd-stash-bf16: K1-fwd-bf16's arguments and the stash (gb_launch).
extern "C" int geometry_fwd_stash_bf16(const int* ia,
                                       const unsigned long long* p,
                                       float scale,
                                       unsigned long long stream) {
  return gb_launch(ia, p, scale, stream, true);
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

extern "C" int geometry_fwd_bf16_attrs(int* out) {
  return sweep_attrs((const void*)geometry_fwd_bf16_sweep, out);
}

extern "C" int geometry_fwd_stash_bf16_attrs(int* out) {
  return sweep_attrs((const void*)geometry_fwd_stash_bf16_sweep, out);
}
