// K3-fwd: the fused IDR radiance MLP in f32 on Hopper's warpgroup tensor
// cores in 3xTF32 (wgmma.cuh; the f32 engine of wgf.cuh).  Positional
// encoding of the view directions, x0 = [pts | PE(dirs) | normals |
// feature], the ReLU hidden layers, the 3-wide last layer and, with
// squeeze_out, the sigmoid -> rgb.  Replaces the TPU kernel
// factored_neus_tpu/ops/pallas_radiance.py _make_radiance(cfg,
// bf16=False).run_fwd (body _build_fwd_kernel, f32 products).  Every
// product runs in 3xTF32 (small_x big_w + big_x small_w + big_x big_w, 8 k
// an instruction); everything elementwise stays f32.
//
// Bound: operations, 2 x 271,360 FLOP a row at full width (layers 289 ->
// 256, 3 x 256 -> 256, 256 -> 3), three TF32 products' worth over 495
// TFLOP/s (0.216 ms at 65,536 rows), against 1,036 bytes in (the 256-d
// feature) and 12 out a row (0.020 ms).  The design is the forward half of
// K3-bwd's sweep (radiance_bwd_wg.cu): no masks, no images, no reverse.
// - A block is two consumer warpgroups (warps 0-7) and a producer
//   warpgroup (8-11, one thread of which issues the copies; setmaxnreg
//   gives the consumers 240 registers a thread), persistent over tiles
//   blockIdx.x, + gridDim.x, ...; a tile is 64 rows (warp w: rows 16w + g
//   and 16w + 8 + g), consumer c the output columns 128c .. 128c + 127 of
//   every hidden product (m64n128k8).
// - The layer input lives in shared memory as an f32 K-major,
//   128-byte-swizzled A tile, 320 k wide: layer 0 reads the feature's 256 k
//   and, at k 256 on, the narrow columns [pts | PE(dirs) | normals] (at
//   most 48, from a small per-row tile), ten 32-k slabs in all, the last
//   two k-steps deep; the tensor core reads big_x from it, small_x is made
//   in registers a slab at a time.  The weights stream as 32-k slabs of
//   TF32 big and small halves (tc_pack.pack_rad_sweep_f32, the forward pack
//   K3-bwd reads, sweep32, k permuted by tc_pack.tf32_slot), two 64 KB
//   stages, each slab's products into a fresh accumulator added to the
//   running sum with rounded adds (the accumulator truncates).  Its forward
//   sums in K3-bwd's order, so the forward of a step and the one K3-bwd
//   recomputes give the same bits.
// - Bias and ReLU in f32 between layers; the last layer on m64n8 (its
//   eight slabs 8 columns wide), both consumers alike, consumer 0 writing
//   sigmoid(a) (or a without squeeze_out).
// - From L2 every tile streams 42 slabs (2.2 MB); from device memory the
//   feature, the narrow inputs and rgb, ~68 MB at 65,536 rows.
// - Between layers, two named barriers over the two consumers: every
//   product of the layer has read the A tile before it is overwritten, and
//   the new tile is written (and fenced to the async proxy) before any
//   product reads it.
#include "sdf_mlp.cuh"
#include "wgf.cuh"

#define RG_TILE 64         // rows of a tile
#define RG_EW 48           // row (floats) of the narrow-column tile
#define RG_AK 320          // k of the A tile: the feature's 256, the narrow 64
#define RG_LAST 2048       // bytes of a last-layer slab (8 columns)

struct RgDims {
  int L, multires, d_view, nar, d_feat, d_out, n, n_tiles, squeeze;
  const float *pts, *nrm, *dirs, *feat;
  float* out;
  const unsigned char* fpack;
  int outs[GW_MAXL];
  int f_off[GW_MAXL];      // byte offset of layer l's first slab
  const float* b[GW_MAXL];
};

// A tile's slabs: layer 0 (ten), each hidden layer (eight), the last layer
// (eight of 8 columns)
__device__ __forceinline__ void rg_producer(const RgDims& d,
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
      fw_put(ring, full, empty, it, d.fpack + d.f_off[lL] + s * RG_LAST,
             RG_LAST);
  }
}

__device__ __forceinline__ void rg_consumer(const RgDims& d, int c,
                                            unsigned char* ring,
                                            unsigned char* at, float* E,
                                            uint64_t* full, uint64_t* empty) {
  const int ctid = threadIdx.x, tid = ctid & 127;
  const int w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  const int n0 = 128 * c;                       // its output columns
  const int lL = d.L - 1;
  const int rg = 16 * w + g;                    // its rows rg, rg + 8
  const uint32_t atile = smem_u32(at);
  float acc[64], run[64];
  const uint32_t none[4] = {0u, 0u, 0u, 0u};
  int it = 0;

  for (int tile = blockIdx.x; tile < d.n_tiles; tile += gridDim.x) {
    const int row0 = tile * RG_TILE;
    const int R0 = row0 + rg, R1 = R0 + 8;
    const bool v0 = R0 < d.n, v1 = R1 < d.n;
    // the narrow columns [pts | PE(dirs) | normals | 0] of each row (both
    // consumers are done with the last tile's)
    bar_sync(1, 256);
    if (ctid < RG_TILE) {
      const int row = row0 + ctid;
      const bool valid = row < d.n;
      float* e = E + ctid * RG_EW;
      float u[3];
      for (int k = 0; k < 3; ++k) {
        e[k] = valid ? d.pts[(size_t)row * 3 + k] : 0.f;
        e[3 + d.d_view + k] = valid ? d.nrm[(size_t)row * 3 + k] : 0.f;
        u[k] = valid ? d.dirs[(size_t)row * 3 + k] : 0.f;
      }
      encode_row(u, nullptr, d.multires, e + 3, nullptr);
      for (int k = d.nar; k < RG_EW; ++k) e[k] = 0.f;
    }
    bar_sync(1, 256);
    // X_0: the feature's columns (this consumer's 128) from device memory,
    // and k 256 on the narrow ones (consumer c its 32), into the A tile
    {
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
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 32 * c + 8 * q + 2 * t + e;
          at_put(at, rg, 256 + j, j < RG_EW ? E[rg * RG_EW + j] : 0.f);
          at_put(at, rg + 8, 256 + j,
                 j < RG_EW ? E[(rg + 8) * RG_EW + j] : 0.f);
        }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // layers 0 .. L - 2: relu(X W + b)
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
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * q + e, col = n0 + 8 * q + 2 * t + (e & 1);
          run[i] = fmaxf(run[i] + (col < W ? __ldg(bl + col) : 0.f), 0.f);
        }
      bar_sync(1, 256);
      at_store(at, run, n0, w, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      bar_sync(1, 256);
    }

    // the last layer (m64n8, both consumers) -> rgb: column 2t + (e % 2) of
    // row R0 (e < 2) or R1
    float acc8[4], run8[4];
    fw_layer<8, 8, 4, false>(it, ring, full, empty, atile, 8, 0, acc8, run8,
                             none, at, w, g, t, lead);
    it += 8;
    if (c == 0)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 2 * t + (e & 1);
        if ((e < 2 ? v0 : v1) && col < d.d_out) {
          const float a = run8[e] + __ldg(d.b[lL] + col);
          d.out[(size_t)(e < 2 ? R0 : R1) * d.d_out + col] =
              d.squeeze ? 1.f / (1.f + expf(-a)) : a;
        }
      }
  }
}

__global__ void __launch_bounds__(384, 1)
radiance_fwd_wgf_sweep(const __grid_constant__ RgDims d) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) &
                                    1023);
  unsigned char* at = ring + FW_NS * FW_STAGE;
  float* E = (float*)(at + 64 * RG_AK * 4);
  uint64_t* full = (uint64_t*)(E + RG_TILE * RG_EW);
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
  for (int i = threadIdx.x; i < 64 * RG_AK; i += blockDim.x)
    ((float*)at)[i] = 0.f;
  __syncthreads();
  if (threadIdx.x >= 256) {
    regs_dec<24>();
    if (threadIdx.x == 256) rg_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    rg_consumer(d, threadIdx.x >> 7, ring, at, E, full, empty);
  }
}

// Integer arguments: [L, multires, d_view, n, grid, n_tiles, squeeze_out,
// then per layer ins[L], outs[L], f_off[L]] (ops/radiance_kernel.
// fwd_wg_plan: tc_pack.rad_sweep_layout_f32's layer offsets, whose slab
// counts and widths are this design's).  Pointers: [pts, normals, dirs,
// feat, rgb, pack, b[L]].  Returns a cudaError_t value; 0 when the launch
// was accepted.
extern "C" int radiance_fwd(const int* ia, const unsigned long long* p,
                            float scale, unsigned long long stream) {
  (void)scale;
  RgDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_view = ia[2];
  d.n = ia[3];
  const int grid = ia[4];
  d.n_tiles = ia[5];
  d.squeeze = ia[6];
  const int L = d.L, lL = L - 1;
  const int* q = ia + 7;
  if (L < 2 || L > GW_MAXL || d.d_view != 3 * (1 + 2 * d.multires) ||
      grid < 1 || d.n_tiles < 1 || (long long)d.n_tiles * RG_TILE < d.n)
    return (int)cudaErrorInvalidValue;
  d.nar = 6 + d.d_view;
  d.d_feat = q[0] - d.nar;
  d.d_out = q[L + lL];
  if (d.nar > RG_EW || d.d_feat < 2 || d.d_feat > 256 || d.d_feat % 2 ||
      d.d_out > 8)
    return (int)cudaErrorInvalidValue;
  d.pts = (const float*)p[0];
  d.nrm = (const float*)p[1];
  d.dirs = (const float*)p[2];
  d.feat = (const float*)p[3];
  d.out = (float*)p[4];
  d.fpack = (const unsigned char*)p[5];
  for (int l = 0; l < L; ++l) {
    const int in = q[l], out = q[L + l];
    d.outs[l] = out;
    d.f_off[l] = q[2 * L + l];
    d.b[l] = (const float*)p[6 + l];
    if ((l && in != q[L + l - 1]) || (l && in > 256) ||
        (l < lL && out > 256) || out < 1 || d.f_off[l] % 1024)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = 1024 + (size_t)FW_NS * FW_STAGE + 64 * RG_AK * 4 +
                      RG_TILE * RG_EW * 4 + 2 * FW_NS * 8;
  cudaError_t e = cudaFuncSetAttribute(
      radiance_fwd_wgf_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  radiance_fwd_wgf_sweep<<<grid, 384, smem, (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

// The sweep's attributes as the device holds them, read after a launch:
// out[0 .. 2] = registers a thread, dynamic shared memory a block (as the
// launcher last set it), static shared memory.  Returns a cudaError_t
// value.
extern "C" int radiance_fwd_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, (const void*)radiance_fwd_wgf_sweep);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}
