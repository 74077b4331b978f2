// K2-bf16: the fused positional encoding + SDF MLP forward with every
// product on bf16 operands and an f32 sum, no gradient, on Hopper's
// warpgroup tensor cores (wgmma.cuh).  Replaces the bf16 body of
// factored_neus_tpu/ops/pallas_sdf.py (sdf_forward_pallas(bf16_matmul=
// True), _build_kernel): the encoding, biases and softplus(beta=100) stay
// f32; each product's operands are rounded to bf16 (nearest even); the
// skip input [h | enc] / sqrt 2 is formed in f32 and rounded once; the
// output is [sdf / scale | feature], or sdf / scale with the last layer
// narrowed to the sdf column (out <= 8 columns).
//
// Bound: operations, 2 x 459,008 bf16 FLOP a row at full width over 989
// TFLOP/s; beside it ~2,009 softplus a row, two special-function ops each
// (ex2, lg2), about as long again on the SMs' SFUs.  The design keeps the
// tensor cores fed and the epilogue under them:
//
// - A block is one producer warpgroup and nc = 1 or 2 consumer warpgroups,
//   each owning a 64-row tile (64 nc rows a pass), persistent over passes
//   blockIdx.x, + gridDim.x, ...  The producer keeps 24 registers a
//   thread and the consumers 240 (setmaxnreg).
// - Activations never leave registers: layer l's accumulator (m64n256,
//   128 f32 a thread), after bias + softplus (x 1/sqrt 2 before a skip)
//   and rounding to bf16, is layer l + 1's A fragment (wgmma.cuh).  The
//   encoding is computed once a tile into a small f32 tile in shared
//   memory, from which layer 0's and the skip layer's fragments load.
//   Hidden layers are 256 columns wide (the pack's zero columns beyond a
//   layer's width give softplus(0) there, which meets zero weight rows).
// - Weights stream as slabs (64 k x all columns, the exact shared-memory
//   image wgmma's B descriptor reads: tc_pack.pack_sweep_bf16) through a
//   ring of ns stages: one thread of the producer copies each slab with
//   one cp.async.bulk completing on the stage's full barrier; consumers
//   release a stage by arriving on its empty barrier (one arrival a warp)
//   as soon as their wgmma on it has retired.  No block-wide barrier runs
//   in the loop.
// - The two consumers run free of each other: the tensor cores share their
//   time between the products both have queued, and one warpgroup's
//   products alone leave them half idle, so turns on the tensor cores
//   (FlashAttention-3's ping-pong) bought nothing (tools/k2_bf16_phases.py;
//   PERF.md).
// - Softplus runs on the SFU (ex2.approx, lg2.approx): its result is
//   rounded to bf16 at once (2^-9 relative), far above their error.
// - Each layer's product sums over its full depth in one f32 accumulator
//   (tools/tf32_mma_probe.py reads how wgmma adds).
#include "sdf_mlp.cuh"
#include "wgmma.cuh"

#define SW_MAXL 16        // most layers
#define SW_EW 48          // row stride (floats) of the encoding tile
#define SW_BW 264         // bias row (floats) of a layer
#define SW_MAX_NS 8       // most ring stages
#define SW_SMEM_MAX 232448

struct SwDims {
  int L, multires, d_embed;
  int n, nc, ns, n_pass, stage_bytes;
  float scale;
  const float* x;
  float* out;
  const unsigned char* pack;
  int enc[SW_MAXL];       // layer l reads the encoding (after h)
  int nslab[SW_MAXL];     // slabs of layer l
  int copy_bytes[SW_MAXL];   // bytes a slab of layer l copies
  int slab_stride[SW_MAXL];  // bytes between layer l's slabs in the pack
  int off[SW_MAXL];          // byte offset of layer l's first slab
  int outs[SW_MAXL];
  int skip_next[SW_MAXL];    // layer l + 1 reads [h | enc] / sqrt 2
  const float* b[SW_MAXL];
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float lg2_approx(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// softplus(beta=100) = max(a, 0) + log(1 + exp(-100 |a|)) / 100
__device__ __forceinline__ float sp100_sfu(float a) {
  const float e = ex2_approx(fabsf(a) * -144.26950408889634f);
  return fmaxf(a, 0.f) + lg2_approx(1.f + e) * 0.006931471805599453f;
}

__device__ __forceinline__ void sw_producer(const SwDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x)
    for (int l = 0; l < d.L; ++l)
      for (int s = 0; s < d.nslab[l]; ++s, ++it) {
        const int st = it % d.ns;
        mbar_wait(empty + st, ((it / d.ns) & 1) ^ 1);
        mbar_expect_tx(full + st, d.copy_bytes[l]);
        bulk_g2s(ring + st * d.stage_bytes,
                 d.pack + d.off[l] + (size_t)s * d.slab_stride[l],
                 d.copy_bytes[l], full + st);
      }
}

// One slab's NK k-steps from fragments f[K0 ..], once the slab has landed
// in ring slab s: MODE 0 multiplies into acc (256 columns), 1 into acc8
// (8: the narrowed last layer), 2 into both (the full last layer, acc8 at
// column 256).  FIRST: the layer's first slab, whose first product
// overwrites the accumulators.  One commit group.  Every index is known
// at compile time and nothing branches between the products, so the
// compiler keeps them in flight together.
template <int MODE, int NK, int K0, bool FIRST, int NA>
__device__ __forceinline__ void sw_slab(const SwDims& d, int s,
                                        unsigned char* ring, uint64_t* full,
                                        float (&acc)[128], float (&acc8)[4],
                                        const uint32_t (&f)[NA][4]) {
  const int st = s % d.ns;
  mbar_wait(full + st, (s / d.ns) & 1);
  wgmma_fence();
  const uint64_t desc = desc_sw128(smem_u32(ring + st * d.stage_bytes));
#pragma unroll
  for (int k = 0; k < NK; ++k) {
    const int keep = FIRST && k == 0 ? 0 : 1;
    if (MODE != 1) wgmma_n256(acc, f[K0 + k], desc + 2 * k, keep);
    if (MODE != 0)  // the full last layer's 8 at column 256: 32 KB on
      wgmma_n8(acc8, f[K0 + k], desc + 2 * k + (MODE == 2 ? 2048 : 0),
               keep);
  }
  wgmma_commit();
}

// Waits for the layer's NS commit groups oldest first, releasing each
// slab's stage (from ring slab it on) as its products retire: one arrival
// a warp (lead, lane 0).
template <int NS, int S = 0>
__device__ __forceinline__ void sw_release(const SwDims& d, int it,
                                           uint64_t* empty, int lead) {
  if constexpr (S < NS) {
    wgmma_wait<NS - 1 - S>();
    mbar_arrive_if(empty + (it + S) % d.ns, lead);
    sw_release<NS, S + 1>(d, it, empty, lead);
  }
}

// One layer's products from ring slab it on: with H, h's 16 k-steps from
// a in four slabs; with ENC (layer 0, a skip layer), the encoding's 3 from
// ef in one more.  Then the slabs released as their products retire.
template <int MODE, bool H, bool ENC>
__device__ __forceinline__ void sw_layer(const SwDims& d, int it,
                                         unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, float (&acc)[128],
                                         float (&acc8)[4],
                                         const uint32_t (&a)[16][4],
                                         const uint32_t (&ef)[3][4],
                                         int lead) {
  if constexpr (H) {
    sw_slab<MODE, 4, 0, true>(d, it, ring, full, acc, acc8, a);
    sw_slab<MODE, 4, 4, false>(d, it + 1, ring, full, acc, acc8, a);
    sw_slab<MODE, 4, 8, false>(d, it + 2, ring, full, acc, acc8, a);
    sw_slab<MODE, 4, 12, false>(d, it + 3, ring, full, acc, acc8, a);
  }
  if constexpr (ENC)
    sw_slab<MODE, 3, 0, !H>(d, it + (H ? 4 : 0), ring, full, acc, acc8, ef);
  sw_release<(H ? 4 : 0) + (ENC ? 1 : 0)>(d, it, empty, lead);
  fence_regs(acc);
  fence_regs(acc8);
}

// Bias + softplus (x 1/sqrt 2 before a skip, SKIP) of a layer's result,
// rounded to bf16: the next layer's A fragments (wgmma.cuh).
template <bool SKIP>
__device__ __forceinline__ void sw_activate(const float (&acc)[128],
                                            const float* bl, int t,
                                            uint32_t (&a)[16][4]) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float* bj = bl + 16 * j + 2 * t;
    const float2 b0 = *(const float2*)bj, b1 = *(const float2*)(bj + 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 bi = i < 2 ? b0 : b1;
      float v0 = sp100_sfu(acc[8 * j + 2 * i] + bi.x);
      float v1 = sp100_sfu(acc[8 * j + 2 * i + 1] + bi.y);
      if (SKIP) {
        v0 *= inv_sqrt2;
        v1 *= inv_sqrt2;
      }
      a[j][i] = pack_bf16(v0, v1);
    }
  }
}

__device__ __forceinline__ void sw_consumer(const SwDims& d, int w,
                                            unsigned char* ring, float* E,
                                            const float* bias, uint64_t* full,
                                            uint64_t* empty) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;                 // rows r0 and r0 + 8
  const int lead = lane == 0;
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int lL = d.L - 1;
  const bool narrow = d.outs[lL] <= 8;
  uint32_t a[16][4];
  float acc[128], acc8[4];
  int it = 0;

  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
    const int row0 = (p * d.nc + w) * 64;
    // the encoding tile (every thread is done with the last tile's)
    bar_sync(1 + w, 128);
    if (tid < 64) {
      const int row = row0 + tid;
      float u[3];
      for (int c = 0; c < 3; ++c)
        u[c] = row < d.n ? d.x[(size_t)row * 3 + c] * d.scale : 0.f;
      float* e = E + tid * SW_EW;
      encode_row(u, nullptr, d.multires, e, nullptr);
      for (int c = d.d_embed; c < 48; ++c) e[c] = 0.f;
    }
    bar_sync(1 + w, 128);

    for (int l = 0; l < d.L; ++l) {
      // layer 0 and a skip layer also read the encoding (/ sqrt 2 at a
      // skip), rounded once
      uint32_t ef[3][4];
      if (d.enc[l]) {
        const float sc = l == 0 ? 1.f : inv_sqrt2;
        const float* e0 = E + r0 * SW_EW + 2 * t;
        const float* e1 = e0 + 8 * SW_EW;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          ef[j][0] = pack_bf16(e0[16 * j] * sc, e0[16 * j + 1] * sc);
          ef[j][1] = pack_bf16(e1[16 * j] * sc, e1[16 * j + 1] * sc);
          ef[j][2] = pack_bf16(e0[16 * j + 8] * sc, e0[16 * j + 9] * sc);
          ef[j][3] = pack_bf16(e1[16 * j + 8] * sc, e1[16 * j + 9] * sc);
        }
      }
      if (l == 0)
        sw_layer<0, false, true>(d, it, ring, full, empty, acc, acc8, a, ef,
                                 lead);
      else if (l == lL && narrow)
        sw_layer<1, true, false>(d, it, ring, full, empty, acc, acc8, a, ef,
                                 lead);
      else if (l == lL)
        sw_layer<2, true, false>(d, it, ring, full, empty, acc, acc8, a, ef,
                                 lead);
      else if (d.enc[l])
        sw_layer<0, true, true>(d, it, ring, full, empty, acc, acc8, a, ef,
                                lead);
      else
        sw_layer<0, true, false>(d, it, ring, full, empty, acc, acc8, a, ef,
                                 lead);
      it += d.nslab[l];

      const float* bl = bias + l * SW_BW;
      if (l < lL) {
        // the next layer's A fragments
        if (d.skip_next[l])
          sw_activate<true>(acc, bl, t, a);
        else
          sw_activate<false>(acc, bl, t, a);
      } else {
        // [sdf / scale | feature]: column c of rows r0, r0 + 8 (acc8:
        // columns 0 .. 7 of a narrowed layer, 256 .. 263 of a full one)
        const int N = d.outs[lL], c8 = narrow ? 0 : 256;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + r0 + 8 * h;
          if (row >= d.n) continue;
          float* o = d.out + (size_t)row * N;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = c8 + 2 * t + e;
            if (c < N)
              o[c] = (acc8[2 * h + e] + bl[c]) * (c == 0 ? inv_scale : 1.f);
          }
          if (!narrow) {
#pragma unroll
            for (int q = 0; q < 32; ++q)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = 8 * q + 2 * t + e;
                if (c < N)
                  o[c] = (acc[4 * q + 2 * h + e] + bl[c]) *
                         (c == 0 ? inv_scale : 1.f);
              }
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(384, 1)
sdf_fwd_bf16_kernel(const __grid_constant__ SwDims d) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned for the swizzle, by pointer arithmetic on the
  // shared array, so that the compiler keeps reading it as shared memory
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  float* E0 = (float*)(ring + (size_t)d.ns * d.stage_bytes);
  float* bias = E0 + d.nc * 64 * SW_EW;
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
    if (threadIdx.x == 0) sw_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    sw_consumer(d, wg - 1, ring, E0 + (wg - 1) * 64 * SW_EW, bias, full,
                empty);
  }
}

// Integer arguments: [L, multires, d_embed, n, nc, grid, n_pass, then per
// layer enc[L], slab_stride[L], off[L], outs[L]] (ops/sdf_kernel.
// sweep_iargs, from the pack's layout, tc_pack.SweepLayout: layer l reads
// h in 16 k-steps (but layer 0), then where enc[l] the encoding in 3;
// its slabs are slab_stride[l] bytes apart from byte off[l] of the pack).
// Pointers: [x, out, pack, b[L]].  Returns a cudaError_t value; 0 when
// the launch was accepted.
extern "C" int sdf_fwd_bf16(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  SwDims d;
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
  d.pack = (const unsigned char*)p[2];
  const int L = d.L;
  if (L < 2 || L > SW_MAXL || d.d_embed > 48 ||
      d.d_embed != 3 * (1 + 2 * d.multires) || d.nc < 1 || d.nc > 2 ||
      grid < 1 || d.n_pass < 1)
    return (int)cudaErrorInvalidValue;
  int widest = 0;
  for (int l = 0; l < L; ++l) {
    const int* q = ia + 7 + l;
    d.enc[l] = q[0];
    d.slab_stride[l] = q[L];
    d.off[l] = q[2 * L];
    d.outs[l] = q[3 * L];
    d.b[l] = (const float*)p[3 + l];
    const bool last = l == L - 1;
    d.nslab[l] = (l ? 4 : 0) + (d.enc[l] ? 1 : 0);
    d.skip_next[l] = last ? 0 : q[1];
    // a copy is the slab's first 8 (narrowed last layer), 256 (hidden) or
    // 264 (full last layer) columns
    d.copy_bytes[l] = (last ? (d.outs[l] <= 8 ? 8 : 264) : 256) * 128;
    if ((l == 0 && !d.enc[l]) || (last && d.enc[l]) ||
        d.slab_stride[l] < d.copy_bytes[l] || d.off[l] % 1024 ||
        d.slab_stride[l] % 1024 || d.outs[l] < 1 ||
        d.outs[l] > (last ? 264 : 256))
      return (int)cudaErrorInvalidValue;
    widest = widest > d.copy_bytes[l] ? widest : d.copy_bytes[l];
  }
  d.stage_bytes = (widest + 1023) / 1024 * 1024;
  const size_t fixed = 1024 + (size_t)d.nc * 64 * SW_EW * 4 +
                       (size_t)L * SW_BW * 4;
  const int ns = (int)((SW_SMEM_MAX - fixed) /
                       ((size_t)d.stage_bytes + 16));
  d.ns = ns < SW_MAX_NS ? ns : SW_MAX_NS;
  // a consumer holds every slab of a layer (at most 5) until its products
  // retire
  if (d.ns < 5) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)d.ns * (d.stage_bytes + 16);
  cudaError_t e = cudaFuncSetAttribute(
      sdf_fwd_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  sdf_fwd_bf16_kernel<<<grid, 128 * (1 + d.nc), smem,
                        (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}
