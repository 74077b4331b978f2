// K2: fused positional encoding -> SDF MLP -> [sdf / scale | feature],
// without gradient, in f32 on Hopper's warpgroup tensor cores in 3xTF32
// (wgmma.cuh; the f32 engine of wgf.cuh).  Serves the no-grad SDF sweeps of
// the up-sampling ladder, stages 2-3's localisation sweep, stage 2's coarse
// sweep with sweep_act_bf16 off and the mesh grid fill (the last layer
// narrowed to the sdf column by the caller), and full [sdf | feature]
// evaluations.  Replaces the TPU kernel
// factored_neus_tpu/ops/pallas_sdf.py sdf_forward_pallas (body
// _build_kernel, f32 products).  Every product runs in 3xTF32 (small_x
// big_w + big_x small_w + big_x big_w, 8 k an instruction); everything
// elementwise stays f32.
//
// Bound: operations, 2S FLOP a row (S = 459,008 multiply-adds for the
// narrowed full-width network, 524,544 with the full last layer), three
// TF32 products' worth over 495 TFLOP/s (0.182 ms at 32,768 rows, narrowed),
// against 12 bytes in and 4 out a row.  The design is K1-fwd's forward
// (geometry_fwd_wg.cu) and nothing else: no sigma, no scratch, no reverse.
// - A block is two consumer warpgroups (warps 0-7) and a producer
//   warpgroup (8-11, one thread of which issues the copies; setmaxnreg
//   gives the consumers 240 registers a thread), persistent over tiles
//   blockIdx.x, + gridDim.x, ...; a tile is 64 rows (warp w: rows 16w + g
//   and 16w + 8 + g), consumer c the output columns 128c .. 128c + 127 of
//   every hidden product (m64n128k8).
// - The layer input lives in shared memory as an f32 K-major,
//   128-byte-swizzled A tile (64 KB): the tensor core reads big_x from it,
//   small_x is made in registers a slab at a time.  The weights stream as
//   32-k slabs of TF32 big and small halves, two stages of 66 KB, from
//   tc_pack.pack_sweep_f32 (the pack that K1-fwd and K1-bwd read, sweep32),
//   k permuted by tc_pack.tf32_slot; each slab's products into a fresh
//   accumulator added to the running sum with rounded adds (the
//   accumulator truncates).
// - The forward through the hidden layers: bias and softplus(beta=100),
//   x 1/sqrt 2 and the encoding after h before the skip layer.
// - The last layer, narrowed (at most 8 outputs): the first 8 columns of
//   each of its eight slabs, a 1 KB prefix of the slab's big half and one
//   of its small half (a column's 32 k are one 128-byte run, so the first
//   8 columns of a 256- or 264-wide slab are its first 1,024 bytes), two
//   bulk copies into a 2 KB stage, m64n8k8 on both consumers, consumer 0
//   writing.  Reading K1-fwd's full pack or a pack of the narrowed
//   network gives the same bits.  Full (257 outputs): consumer c its 128
//   columns by m64n128 and consumer 1 also columns 256 .. 263 by an m64n8
//   k-step beside it (wgf.cuh's fw_last_layer, as K1-fwd).
// - From L2 every tile streams 66 slabs (~4.2 MB; 8,192 rows, 128 tiles:
//   0.54 GB; the HBM traffic is the points and the outputs).
// - Between layers, two named barriers over the two consumers: every
//   product of the layer has read the A tile before it is overwritten, and
//   the new tile is written (and fenced to the async proxy) before any
//   product reads it.
#include "sdf_mlp.cuh"
#include "wgf.cuh"

#define SW_TILE 64         // rows of a tile
#define SW_EW 48           // row (floats) of the encoding tile
#define SW_LASTC 264       // columns of a full last layer's slabs
#define SW_STAGE (2 * SW_LASTC * 128)   // bytes of a ring stage (67,584)
#define SW_NARROW 8        // outputs of a narrowed last layer (m64n8)

struct SwDims {
  int L, multires, d_embed, n, n_tiles, d_out, last_cols;
  float scale;
  const float* x;
  float* out;
  const unsigned char* fpack;
  int outs[GW_MAXL];
  int enc[GW_MAXL];        // layer l reads [h | enc] (a skip layer)
  int f_off[GW_MAXL];      // byte offset of layer l's first slab
  const float* b[GW_MAXL];
};

// A tile's slabs: layer 0 (two), each hidden layer (eight), the last layer
// (eight: last_cols wide, or their first SW_NARROW columns)
__device__ __forceinline__ void sw_producer(const SwDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  const int lL = d.L - 1, last = 2 * d.last_cols * 128;
  const bool narrow = d.d_out <= SW_NARROW;
  int it = 0;
  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    for (int l = 0; l < lL; ++l)
      for (int s = 0; s < (l ? 8 : 2); ++s, ++it)
        fw_put<SW_STAGE>(ring, full, empty, it,
                         d.fpack + d.f_off[l] + s * FW_STAGE, FW_STAGE);
    for (int s = 0; s < 8; ++s, ++it) {
      const unsigned char* src = d.fpack + d.f_off[lL] + s * last;
      if (!narrow) {
        fw_put<SW_STAGE>(ring, full, empty, it, src, last);
        continue;
      }
      // the big half's first 8 columns, then the small half's
      const int st = it % FW_NS, half = SW_NARROW * 128;
      mbar_wait(empty + st, ((it / FW_NS) & 1) ^ 1);
      mbar_expect_tx(full + st, 2 * half);
      bulk_g2s(ring + st * SW_STAGE, src, half, full + st);
      bulk_g2s(ring + st * SW_STAGE + half, src + d.last_cols * 128, half,
               full + st);
    }
  }
}

__device__ __forceinline__ void sw_consumer(const SwDims& d, int c,
                                            unsigned char* ring,
                                            unsigned char* at, float* E,
                                            uint64_t* full, uint64_t* empty) {
  const int ctid = threadIdx.x, tid = ctid & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  const int n0 = 128 * c;                       // its output columns
  const int rg = 16 * w + g;                    // its rows rg, rg + 8
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int lL = d.L - 1, de = d.d_embed, N = d.d_out;
  const bool narrow = N <= SW_NARROW;
  const uint32_t atile = smem_u32(at);
  float acc[64], run[64];
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  int it = 0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const int row0 = tile * SW_TILE;
    const int P0 = row0 + rg, P1 = P0 + 8;
    const bool v0 = P0 < d.n, v1 = P1 < d.n;
    // the encoding (both consumers are done with the last tile's)
    bar_sync(1, 256);
    if (ctid < SW_TILE) {
      const int row = row0 + ctid;
      float u[3];
      for (int k = 0; k < 3; ++k)
        u[k] = row < d.n ? d.x[(size_t)row * 3 + k] * d.scale : 0.f;
      float* e = E + ctid * SW_EW;
      encode_row(u, nullptr, d.multires, e, nullptr);
      for (int k = de; k < SW_EW; ++k) e[k] = 0.f;
    }
    bar_sync(1, 256);
    // X_0: the encoding's 64 columns (zero from d_embed on), consumer 0's
    if (c == 0) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 8 * q + 2 * t + e;
          at_put(at, rg, k, k < SW_EW ? E[rg * SW_EW + k] : 0.f);
          at_put(at, rg + 8, k, k < SW_EW ? E[(rg + 8) * SW_EW + k] : 0.f);
        }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1, 256);

    // layers 0 .. L - 2: bias + softplus (x 1/sqrt 2 before a skip, the
    // encoding after h there)
    for (int l = 0; l < lL; ++l) {
      if (l == 0) {
        fw_layer<128, 2, 2, false, SW_STAGE>(it, ring, full, empty, atile,
                                             256, n0, acc, run, none, at, w,
                                             g, t, lead);
        it += 2;
      } else {
        fw_layer<128, 8, 4, false, SW_STAGE>(it, ring, full, empty, atile,
                                             256, n0, acc, run, none, at, w,
                                             g, t, lead);
        it += 8;
      }
      const float* bl = d.b[l];
      const int W = d.outs[l];
      const bool skip = d.enc[l + 1];
      const float post = skip ? inv_sqrt2 : 1.f;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e, col = n0 + 8 * q + 2 * t + (e & 1);
          const int r = e < 2 ? rg : rg + 8;
          float h = sp100(run[i] + (col < W ? __ldg(bl + col) : 0.f)) * post;
          if (col >= W) {
            const int k = col - W;
            h = skip && k < de ? E[r * SW_EW + k] * inv_sqrt2 : 0.f;
          }
          run[i] = h;
        }
      bar_sync(1, 256);
      at_store(at, run, n0, w, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // the last layer -> [sdf / scale | feature]
    const float* bl = d.b[lL];
    if (narrow) {
      // columns 2t + (e % 2) of rows rg (e < 2) and rg + 8, both consumers
      float acc8[4], run8[4];
      fw_layer<8, 8, 4, false, SW_STAGE>(it, ring, full, empty, atile,
                                         SW_NARROW, 0, acc8, run8, none, at,
                                         w, g, t, lead);
      it += 8;
      if (c == 0)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 2 * t + (e & 1);
          if ((e < 2 ? v0 : v1) && col < N)
            d.out[(size_t)(e < 2 ? P0 : P1) * N + col] =
                (run8[e] + __ldg(bl + col)) * (col == 0 ? inv_scale : 1.f);
        }
      continue;
    }
    float acc8[4], run8[4];
    const bool tail = c == 1 && d.last_cols > 256;
    if (tail)
      fw_last_layer<true, SW_STAGE>(it, ring, full, empty, atile,
                                    d.last_cols, n0, acc, run, acc8, run8,
                                    at, w, g, t, lead);
    else
      fw_last_layer<false, SW_STAGE>(it, ring, full, empty, atile,
                                     d.last_cols, n0, acc, run, acc8, run8,
                                     at, w, g, t, lead);
    it += 8;
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + 8 * q + 2 * t + (e & 1);
        if ((e < 2 ? v0 : v1) && col < N)
          d.out[(size_t)(e < 2 ? P0 : P1) * N + col] =
              (run[4 * q + e] + __ldg(bl + col)) *
              (col == 0 ? inv_scale : 1.f);
      }
    if (tail)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 256 + 2 * t + (e & 1);
        if ((e < 2 ? v0 : v1) && col < N)
          d.out[(size_t)(e < 2 ? P0 : P1) * N + col] =
              run8[e] + __ldg(bl + col);
      }
  }
}

__global__ void __launch_bounds__(384, 1)
sdf_fwd_wgf_sweep(const __grid_constant__ SwDims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* at = ring + FW_NS * SW_STAGE;
  float* E = (float*)(at + 64 * 256 * 4);
  uint64_t* full = (uint64_t*)(E + SW_TILE * SW_EW);
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
    if (threadIdx.x == 256) sw_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    sw_consumer(d, threadIdx.x >> 7, ring, at, E, full, empty);
  }
}

// Integer arguments: [L, multires, d_embed, n, grid, n_tiles, last_cols,
// then per layer ins[L], outs[L], enc[L], f_off[L]] (ops/sdf_kernel.
// sweep_wg_plan: tc_pack.pack_sweep_f32's layout, whose last layer may be
// wider than the network's: K1-fwd's full pack, read narrowed).
// Pointers: [x, out, pack, b[L]].  Returns a cudaError_t value; 0 when the
// launch was accepted.
extern "C" int sdf_fwd(const int* ia, const unsigned long long* p,
                       float scale, unsigned long long stream) {
  SwDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_embed = ia[2];
  d.n = ia[3];
  const int grid = ia[4];
  d.n_tiles = ia[5];
  d.last_cols = ia[6];
  const int L = d.L, lL = L - 1, de = d.d_embed;
  const int* q = ia + 7;
  if (L < 2 || L > GW_MAXL || de > SW_EW || de != 3 * (1 + 2 * d.multires) ||
      grid < 1 || d.n_tiles < 1 || (long long)d.n_tiles * SW_TILE < d.n ||
      (d.last_cols != 256 && d.last_cols != SW_LASTC))
    return (int)cudaErrorInvalidValue;
  d.scale = scale;
  d.x = (const float*)p[0];
  d.out = (float*)p[1];
  d.fpack = (const unsigned char*)p[2];
  for (int l = 0; l < L; ++l) {
    const int in = q[l];
    d.outs[l] = q[L + l];
    d.enc[l] = q[2 * L + l];
    d.f_off[l] = q[3 * L + l];
    d.b[l] = (const float*)p[3 + l];
    const bool last = l == lL;
    // layer 0 reads the encoding alone, a skip layer [h | enc] in W's own
    // column order, the last layer h alone
    if (in > (l ? 256 : de) || d.outs[l] > (last ? d.last_cols : 256) ||
        d.outs[l] < 1 || (d.enc[l] != 0 && d.enc[l] != 1) || !d.enc[0] ||
        in != (l ? in : de) || (last && d.enc[l]) || d.f_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
    if (l && in != d.outs[l - 1] + (d.enc[l] ? de : 0))
      return (int)cudaErrorInvalidValue;
  }
  d.d_out = d.outs[lL];
  const size_t smem = 1024 + (size_t)FW_NS * SW_STAGE + 64 * 256 * 4 +
                      SW_TILE * SW_EW * 4 + 2 * FW_NS * 8;
  cudaError_t e = cudaFuncSetAttribute(
      sdf_fwd_wgf_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sdf_fwd_wgf_sweep<<<grid, 384, smem, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

// The sweep's attributes as the device holds them, read after a launch:
// out[0 .. 2] = registers a thread, dynamic shared memory a block (as the
// launcher last set it), static shared memory.  Returns a cudaError_t
// value.
extern "C" int sdf_fwd_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, (const void*)sdf_fwd_wgf_sweep);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}
