// The forward pieces of the bf16 wgmma sweeps, which the kernels of the
// bf16 operand mode share (every product on bf16 operands with an f32 sum
// on wgmma, A in registers, B streamed as slabs through wg_bwd.cuh's ring):
//
//   ex2_approx, lg2_approx, sp100_sfu, sp_sig100_sfu, sig100_sfu
//                 softplus(beta=100) and sigma(100 a) on the SFU (K2-bf16,
//                 K1-fwd-bf16, K1-bwd-bf16)
//   SwDims, SwStash, sw_put_fwd, sw_encode_row, sw_slab, sw_layer,
//   sw_enc_frags, sw_activate, sw_forward
//                 the SDF network's forward over a consumer's 64-row tile
//                 from tc_pack.pack_sweep_bf16's slabs, its output [sdf /
//                 scale | feature] written: K2-bf16 (sdf_fwd_bf16.cu) and
//                 K1-fwd-bf16 (geometry_fwd_bf16_wg.cu), which also keeps
//                 sigma(100 a) of each hidden layer, and K1-fwd-stash-bf16
//                 (the same file), which also stashes each pre-activation
//                 in bf16 (SwStash); the same code, so they give the same
//                 bits
//   rw_narrow_row, rw_feat_frags, rw_narrow_frags, rw_layer0, rw_layer,
//   rw_activate, rw_last_layer, rw_fwd_slabs
//                 the radiance MLP's forward over a 64-row tile from
//                 tc_pack.pack_rad_sweep_bf16's slabs: K3-bwd-bf16
//                 (radiance_bwd_bf16_wg.cu) and K3-fwd-bf16
//                 (radiance_fwd_bf16_wg.cu), the same code, so the
//                 forward of a step and the one K3-bwd-bf16 recomputes
//                 give the same bits
//
// A consumer warpgroup's thread (warp w, g = lane / 4, t = lane % 4) holds
// rows r0 = 16 w + g and r0 + 8 of its tile, columns 8 q + 2 t + e (q <
// 32, e < 2) of an m64n256 accumulator at index 4 q + 2 h + e (row r0 + 8
// h): wgmma.cuh's layout.
#pragma once

#include "sdf_mlp.cuh"
#include "wg_bwd.cuh"

#define SW_MAXL 16        // most layers
#define SW_EW 48          // row stride (floats) of the encoding tile
#define SW_BW 264         // bias row (floats) of a layer
#define SW_MAX_NS 8       // most ring stages
#define SW_SMEM_MAX 232448

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

// softplus(beta=100) = max(a, 0) + log(1 + exp(-100 |a|)) / 100.  Its
// result is rounded to bf16 at once (2^-9 relative), far above the
// approximations' error.
__device__ __forceinline__ float sp100_sfu(float a) {
  const float e = ex2_approx(fabsf(a) * -144.26950408889634f);
  return fmaxf(a, 0.f) + lg2_approx(1.f + e) * 0.006931471805599453f;
}

// sigma(100 a) on the SFU (ex2.approx, rcp.approx: a few ulp in f32)
__device__ __forceinline__ float sig100_sfu(float a) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n"
      : "=f"(r)
      : "f"(1.f + ex2_approx(a * -144.26950408889634f)));
  return r;
}

// sp100_sfu(a) (the same instructions, the same bits) and sigma(100 a)
// from the same exp(-100 |a|): 1 / (1 + e) for a >= 0, e / (1 + e) below
// (a few ulp in f32)
__device__ __forceinline__ void sp_sig100_sfu(float a, float& sp,
                                              float& sig) {
  const float e = ex2_approx(fabsf(a) * -144.26950408889634f);
  sp = fmaxf(a, 0.f) + lg2_approx(1.f + e) * 0.006931471805599453f;
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(1.f + e));
  sig = a >= 0.f ? r : e * r;
}

// -- the SDF network's forward -----------------------------------------------

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

// K1-fwd-stash-bf16's side output: bf16 [n][cols], hidden layer l's
// pre-activations from column off[l]
struct SwStash {
  __nv_bfloat16* p;
  int cols;
  int off[SW_MAXL];
};

// The forward's slabs of one tile into the ring from slab it on; returns
// the slab after them.
__device__ __forceinline__ int sw_put_fwd(const SwDims& d, int it,
                                          unsigned char* ring,
                                          uint64_t* full, uint64_t* empty) {
  for (int l = 0; l < d.L; ++l)
    for (int s = 0; s < d.nslab[l]; ++s, ++it)
      gw_put(d.ns, ring, full, empty, it,
             d.pack + d.off[l] + (size_t)s * d.slab_stride[l],
             d.copy_bytes[l], d.stage_bytes);
  return it;
}

// Row tid (< 64) of a tile's encoding tile E (rows from row0; the points
// scaled, zero past n and from column d_embed on)
__device__ __forceinline__ void sw_encode_row(const SwDims& d, float* E,
                                              int tid, int row0) {
  const int row = row0 + tid;
  float u[3];
  for (int c = 0; c < 3; ++c)
    u[c] = row < d.n ? d.x[(size_t)row * 3 + c] * d.scale : 0.f;
  float* e = E + tid * SW_EW;
  encode_row(u, nullptr, d.multires, e, nullptr);
  for (int c = d.d_embed; c < SW_EW; ++c) e[c] = 0.f;
}

// One slab's NK k-steps from fragments f[K0 ..], once the slab has landed
// in ring slab s (stages of stage bytes): MODE 0 multiplies into acc (256
// columns), 1 into acc8 (8: the narrowed last layer), 2 into both (the
// full last layer, acc8 at column 256).  FIRST: the layer's first slab,
// whose first product overwrites the accumulators.  One commit group.
// Every index is known at compile time and nothing branches between the
// products, so the compiler keeps them in flight together.
template <int MODE, int NK, int K0, bool FIRST, int NA>
__device__ __forceinline__ void sw_slab(int ns, int stage, int s,
                                        unsigned char* ring, uint64_t* full,
                                        float (&acc)[128], float (&acc8)[4],
                                        const uint32_t (&f)[NA][4]) {
  const int st = s % ns;
  mbar_wait(full + st, (s / ns) & 1);
  wgmma_fence();
  const uint64_t desc = desc_sw128(smem_u32(ring + st * stage));
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

// One layer's products from ring slab it on: with H, h's 16 k-steps from
// a in four slabs; with ENC (layer 0, a skip layer), the encoding's 3 from
// ef in one more.  Then the slabs released as their products retire.
template <int MODE, bool H, bool ENC>
__device__ __forceinline__ void sw_layer(int ns, int stage, int it,
                                         unsigned char* ring, uint64_t* full,
                                         uint64_t* empty, float (&acc)[128],
                                         float (&acc8)[4],
                                         const uint32_t (&a)[16][4],
                                         const uint32_t (&ef)[3][4],
                                         int lead) {
  if constexpr (H) {
    sw_slab<MODE, 4, 0, true>(ns, stage, it, ring, full, acc, acc8, a);
    sw_slab<MODE, 4, 4, false>(ns, stage, it + 1, ring, full, acc, acc8, a);
    sw_slab<MODE, 4, 8, false>(ns, stage, it + 2, ring, full, acc, acc8, a);
    sw_slab<MODE, 4, 12, false>(ns, stage, it + 3, ring, full, acc, acc8,
                                a);
  }
  if constexpr (ENC)
    sw_slab<MODE, 3, 0, !H>(ns, stage, it + (H ? 4 : 0), ring, full, acc,
                            acc8, ef);
  gw_release<(H ? 4 : 0) + (ENC ? 1 : 0)>(ns, it, empty, lead);
  fence_regs(acc);
  fence_regs(acc8);
}

// The encoding's A fragments (three k-steps) of rows r0, r0 + 8 from the
// encoding tile E, x sc (1, or 1/sqrt 2 at a skip), rounded once
__device__ __forceinline__ void sw_enc_frags(const float* E, int r0, int t,
                                             float sc, uint32_t (&ef)[3][4]) {
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

// Bias + softplus (x 1/sqrt 2 before a skip, SKIP) of a layer's result,
// rounded to bf16: the next layer's A fragments (wgmma.cuh).  SIG: also
// sigma(100 a) of the f32 pre-activation a, accumulator entries 4q .. 4q
// + 3 as the float4 sc[128 q] (the thread's own, coalesced over the
// warpgroup).  STASH (K1-fwd-stash-bf16): also a rounded to bf16 (nearest
// even) at column c < W of the thread's rows' stash rows s0 and s1
// (nullptr: a row past n), two bytes a store.
template <bool SKIP, bool SIG, bool STASH = false>
__device__ __forceinline__ void sw_activate(const float (&acc)[128],
                                            const float* bl, int t,
                                            uint32_t (&a)[16][4],
                                            float4* sc,
                                            __nv_bfloat16* s0 = nullptr,
                                            __nv_bfloat16* s1 = nullptr,
                                            int W = 0) {
  const float inv_sqrt2 = 0.70710678118654752f;
#pragma unroll
  for (int q = 0; q < 32; ++q) {
    const float2 bq = *(const float2*)(bl + 8 * q + 2 * t);
    float v[4], s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pre = acc[4 * q + e] + (e & 1 ? bq.y : bq.x);
      if (STASH) {
        const int c = 8 * q + 2 * t + (e & 1);
        __nv_bfloat16* st = e < 2 ? s0 : s1;
        if (st && c < W) st[c] = __float2bfloat16_rn(pre);
      }
      if (SIG)
        sp_sig100_sfu(pre, v[e], s[e]);
      else
        v[e] = sp100_sfu(pre);
      if (SKIP) v[e] *= inv_sqrt2;
    }
    a[q >> 1][2 * (q & 1)] = pack_bf16(v[0], v[1]);
    a[q >> 1][2 * (q & 1) + 1] = pack_bf16(v[2], v[3]);
    if (SIG) sc[128 * q] = make_float4(s[0], s[1], s[2], s[3]);
  }
}

// The forward of a consumer's tile (rows row0 .., its encoding tile E
// built) from ring slab it on, through all L layers, and its output [sdf /
// scale | feature] written (columns 0 .. 7 from acc8 where the last layer
// is narrowed to at most 8, else columns 256 .. 263).  With SIG
// (K1-fwd-bf16), sigma(100 a) of hidden layer l goes to scr + 32 * 128 l
// (sw_activate's order, the thread's own float4s), and the last hidden
// layer's is sent on to L2 (scr - tid: the warpgroup's) while the last
// layer's products run, for the reverse sweep that reads it first.
// With STASH (K1-fwd-stash-bf16), each hidden layer's pre-activations
// also go to the stash ``st`` (sw_activate).  Returns the ring slab after
// the tile's.
template <bool SIG, bool STASH = false>
__device__ __forceinline__ int sw_forward(const SwDims& d, int it, int row0,
                                          unsigned char* ring, const float* E,
                                          const float* bias, uint64_t* full,
                                          uint64_t* empty, float4* scr,
                                          uint32_t (&a)[16][4],
                                          float (&acc)[128],
                                          float (&acc8)[4],
                                          const SwStash* st = nullptr) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * warp + g;                 // rows r0 and r0 + 8
  const int lead = lane == 0;
  const float inv_sqrt2 = 0.70710678118654752f;
  const float inv_scale = 1.f / d.scale;
  const int lL = d.L - 1, ns = d.ns, stage = d.stage_bytes;
  const bool narrow = d.outs[lL] <= 8;
  for (int l = 0; l < d.L; ++l) {
    // layer 0 and a skip layer also read the encoding (/ sqrt 2 at a
    // skip), rounded once
    uint32_t ef[3][4];
    if (d.enc[l]) sw_enc_frags(E, r0, t, l == 0 ? 1.f : inv_sqrt2, ef);
    if (SIG && l == lL)
      l2_prefetch_if(scr - tid + (lL - 1) * 32 * 128, 32 * 128 * 16,
                     tid == 0);
    if (l == 0)
      sw_layer<0, false, true>(ns, stage, it, ring, full, empty, acc, acc8,
                               a, ef, lead);
    else if (l == lL && narrow)
      sw_layer<1, true, false>(ns, stage, it, ring, full, empty, acc, acc8,
                               a, ef, lead);
    else if (l == lL)
      sw_layer<2, true, false>(ns, stage, it, ring, full, empty, acc, acc8,
                               a, ef, lead);
    else if (d.enc[l])
      sw_layer<0, true, true>(ns, stage, it, ring, full, empty, acc, acc8,
                              a, ef, lead);
    else
      sw_layer<0, true, false>(ns, stage, it, ring, full, empty, acc, acc8,
                               a, ef, lead);
    it += d.nslab[l];

    const float* bl = bias + l * SW_BW;
    if (l < lL) {
      // the next layer's A fragments
      float4* sl = SIG ? scr + l * 32 * 128 : nullptr;
      __nv_bfloat16 *s0 = nullptr, *s1 = nullptr;
      if (STASH) {
        const int row = row0 + r0;
        __nv_bfloat16* sb = st->p + st->off[l];
        if (row < d.n) s0 = sb + (size_t)row * st->cols;
        if (row + 8 < d.n) s1 = sb + (size_t)(row + 8) * st->cols;
      }
      if (d.skip_next[l])
        sw_activate<true, SIG, STASH>(acc, bl, t, a, sl, s0, s1, d.outs[l]);
      else
        sw_activate<false, SIG, STASH>(acc, bl, t, a, sl, s0, s1, d.outs[l]);
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
  return it;
}

// -- the radiance MLP's forward ----------------------------------------------

#define RW_TILE 64        // rows of a consumer's tile
#define RW_EW 52          // row (floats) of a consumer's narrow-column tile
#define RW_NAR 48         // narrow columns a product covers (3 k-steps)
#define RW_MAXH 4         // most hidden layers (K3-bwd-bf16: masks in regs)
#define RW_MAXS 48        // most slabs a pass
#define RW_LAST 8         // widest last layer (m64n8)

// Row tid (< RW_TILE) of a tile's narrow columns [pts | PE(dirs) | normals
// | 0] into E (rows from row0; zero past n).
__device__ __forceinline__ void rw_narrow_row(float* E, int tid, int row0,
                                              int n, const float* pts,
                                              const float* nrm,
                                              const float* dirs, int d_view,
                                              int multires, int nar) {
  const int row = row0 + tid;
  const bool valid = row < n;
  float* e = E + tid * RW_EW;
  float u[3];
  for (int c = 0; c < 3; ++c) {
    e[c] = valid ? pts[(size_t)row * 3 + c] : 0.f;
    e[3 + d_view + c] = valid ? nrm[(size_t)row * 3 + c] : 0.f;
    u[c] = valid ? dirs[(size_t)row * 3 + c] : 0.f;
  }
  encode_row(u, nullptr, multires, e + 3, nullptr);
  for (int c = nar; c < RW_NAR; ++c) e[c] = 0.f;
}

// Layer 0's A from the feature (k-steps 0 .. 15) of rows R0 (v0: it
// exists) and R1, rounded to bf16
__device__ __forceinline__ void rw_feat_frags(uint32_t (&a)[16][4],
                                              const float* feat, int d_feat,
                                              int R0, int R1, bool v0,
                                              bool v1, int t) {
  const float* f0 = feat + (size_t)R0 * d_feat;
  const float* f1 = feat + (size_t)R1 * d_feat;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * j + 8 * h + 2 * t;
      const bool in = c < d_feat;
      const float2 x = v0 && in ? __ldg((const float2*)(f0 + c))
                                : make_float2(0.f, 0.f);
      const float2 y = v1 && in ? __ldg((const float2*)(f1 + c))
                                : make_float2(0.f, 0.f);
      a[j][2 * h] = pack_bf16(x.x, x.y);
      a[j][2 * h + 1] = pack_bf16(y.x, y.y);
    }
}

// The narrow columns' A fragments (three k-steps) of the thread's rows, e0
// and e1 (= e0 + 8 rows) of the narrow tile
__device__ __forceinline__ void rw_narrow_frags(uint32_t (&ef)[3][4],
                                                const float* e0,
                                                const float* e1, int t) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const int c = 16 * j + 2 * t;
    ef[j][0] = pack_bf16(e0[c], e0[c + 1]);
    ef[j][1] = pack_bf16(e1[c], e1[c + 1]);
    ef[j][2] = pack_bf16(e0[c + 8], e0[c + 9]);
    ef[j][3] = pack_bf16(e1[c + 8], e1[c + 9]);
  }
}

// 256 columns of r W or X W from ring slab it on: the fragments a's 16
// k-steps in four slabs
template <int N>
__device__ __forceinline__ void rw_layer(int ns, int it, unsigned char* ring,
                                         uint64_t* full, uint64_t* empty,
                                         float (&acc)[N / 2],
                                         const uint32_t (&a)[16][4],
                                         int lead) {
  gw_slab<N, 4, 0, true>(ns, it, ring, full, acc, a);
  gw_slab<N, 4, 4, false>(ns, it + 1, ring, full, acc, a);
  gw_slab<N, 4, 8, false>(ns, it + 2, ring, full, acc, a);
  gw_slab<N, 4, 12, false>(ns, it + 3, ring, full, acc, a);
  gw_release<4>(ns, it, empty, lead);
  fence_regs(acc);
}

// Layer 0's X W from ring slab it on: the feature's 16 k-steps (a) in four
// slabs, the narrow columns' 3 (ef) in a fifth
__device__ __forceinline__ void rw_layer0(int ns, int it, unsigned char* ring,
                                          uint64_t* full, uint64_t* empty,
                                          float (&acc)[128],
                                          const uint32_t (&a)[16][4],
                                          const uint32_t (&ef)[3][4],
                                          int lead) {
  gw_slab<256, 4, 0, true>(ns, it, ring, full, acc, a);
  gw_slab<256, 4, 4, false>(ns, it + 1, ring, full, acc, a);
  gw_slab<256, 4, 8, false>(ns, it + 2, ring, full, acc, a);
  gw_slab<256, 4, 12, false>(ns, it + 3, ring, full, acc, a);
  gw_slab<256, 3, 0, false>(ns, it + 4, ring, full, acc, ef);
  gw_release<5>(ns, it, empty, lead);
  fence_regs(acc);
}

// The last layer's X W (m64n8, four slabs of 8 columns) from ring slab it
// on
__device__ __forceinline__ void rw_last_layer(int ns, int it,
                                              unsigned char* ring,
                                              uint64_t* full, uint64_t* empty,
                                              float (&acc8)[4],
                                              const uint32_t (&a)[16][4],
                                              int lead) {
  gw_slab<8, 4, 0, true>(ns, it, ring, full, acc8, a);
  gw_slab<8, 4, 4, false>(ns, it + 1, ring, full, acc8, a);
  gw_slab<8, 4, 8, false>(ns, it + 2, ring, full, acc8, a);
  gw_slab<8, 4, 12, false>(ns, it + 3, ring, full, acc8, a);
  gw_release<4>(ns, it, empty, lead);
  fence_regs(acc8);
}

// a = acc + bias (f32): its ReLU mask m (bit i % 32 of word i / 32: a > 0
// at accumulator index i) and relu(a) rounded to bf16, the next layer's A
// fragments
__device__ __forceinline__ void rw_activate(const float (&acc)[128],
                                            const float* bl, int t,
                                            uint32_t (&a)[16][4],
                                            uint32_t (&m)[4]) {
#pragma unroll
  for (int w = 0; w < 4; ++w) m[w] = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = 2 * j + h;
      const float2 bb = *(const float2*)(bl + 8 * q + 2 * t);
      float v[4] = {acc[4 * q] + bb.x, acc[4 * q + 1] + bb.y,
                    acc[4 * q + 2] + bb.x, acc[4 * q + 3] + bb.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m[q >> 3] |= (v[e] > 0.f ? 1u : 0u) << ((4 * q + e) & 31);
        v[e] = fmaxf(v[e], 0.f);
      }
      a[j][2 * h] = pack_bf16(v[0], v[1]);
      a[j][2 * h + 1] = pack_bf16(v[2], v[3]);
    }
}

// The forward's slabs of a pass (host): layer 0 the feature's four and the
// narrow one, each hidden layer four, the last layer four of 8 columns,
// from f_off[l] of the forward pack (tc_pack.rad_sweep_layout); their
// offsets and bytes from entry ns on.  Returns the count after them.
static inline int rw_fwd_slabs(int L, const int* f_off, int* off, int* bytes,
                               int ns) {
  for (int l = 0; l < L; ++l) {
    const int n = l ? 4 : 5, b = l < L - 1 ? GW_SLAB : RW_LAST * 128;
    for (int s = 0; s < n; ++s, ++ns)
      if (ns < RW_MAXS) {
        off[ns] = f_off[l] + s * b;
        bytes[ns] = b;
      }
  }
  return ns;
}
