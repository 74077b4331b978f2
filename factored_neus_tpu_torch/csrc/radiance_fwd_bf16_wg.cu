// K3-fwd-bf16: the fused IDR radiance MLP in the bf16 operand mode, on
// Hopper's warpgroup tensor cores (wgmma.cuh).  Positional encoding of the
// view directions, x0 = [pts | PE(dirs) | normals | feature], the ReLU
// hidden layers, the 3-wide last layer and, with squeeze_out, the sigmoid
// -> rgb.  Replaces the TPU kernel factored_neus_tpu/ops/pallas_radiance.py
// _make_radiance(cfg, bf16=True).run_fwd (body _build_fwd_kernel with
// _mm_fns(True), rendering_apply_pallas' default): every product on bf16
// operands (to nearest even) with an f32 sum; the encoding, biases, ReLU
// and sigmoid stay f32.
//
// Bound: operations, 2 x 271,360 FLOP a row at full width (layers 289 ->
// 256, 3 x 256 -> 256, 256 -> 3) over 989 TFLOP/s (0.036 ms at 65,536
// rows), against 1,036 bytes in (the 256-d feature) and 12 out a row (0.021
// ms).  The design is the forward half of K3-bwd-bf16's sweep
// (radiance_bwd_bf16_wg.cu), the same code (sweep16.cuh's rw_* pieces):
// no masks, images, reverse or weight-gradient pass.
// - A block is one producer warpgroup and nc = 1 or 2 consumer warpgroups,
//   each owning a 64-row tile, persistent over passes blockIdx.x, +
//   gridDim.x, ...; setmaxnreg gives the producer 24 registers a thread and
//   the consumers 240.
// - Products on wgmma m64n256k16 with A in registers: layer 0 reads the
//   feature's 256 k (four slabs; its A loaded from device memory and
//   rounded) and the 33 narrow columns [pts | PE(dirs) | normals] at k =
//   256 (one slab, three k-steps, from a small shared tile); a hidden layer
//   four slabs, its A the last layer's result after bias and ReLU, rounded
//   to bf16 in registers; the 3-wide last layer four slabs of 8 columns
//   (m64n8).  B streams as slabs of tc_pack.pack_rad_sweep_bf16 (sweep16,
//   K3-bwd-bf16's forward pack) by cp.async.bulk on mbarriers (wg_bwd.cuh's
//   ring), in K3-bwd-bf16's order, so the forward of a step and the one
//   K3-bwd-bf16 recomputes give the same bits.
// - No scratch and no block-wide barrier in the loop.  From device memory
//   the feature, the narrow inputs and rgb, ~68 MB at 65,536 rows; from L2
//   every tile streams 21 slabs (~0.6 MB).
#include "sweep16.cuh"

struct RfDims {
  int L, multires, d_view, nar, d_feat, d_out, n, nc, ns, n_pass, squeeze;
  int n_slab;
  const float *pts, *nrm, *dirs, *feat;
  float* out;
  const unsigned char* fpack;
  int slab_off[RW_MAXS], slab_bytes[RW_MAXS];
  int outs[GW_MAXL];
  const float* b[GW_MAXL];
};

__device__ __forceinline__ void rf_producer(const RfDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x)
    for (int s = 0; s < d.n_slab; ++s, ++it)
      gw_put(d.ns, ring, full, empty, it, d.fpack + d.slab_off[s],
             d.slab_bytes[s]);
}

__device__ __forceinline__ void rf_consumer(const RfDims& d, int wg,
                                            unsigned char* ring, float* E,
                                            const float* bias,
                                            uint64_t* full, uint64_t* empty) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lead = lane == 0;
  const int lL = d.L - 1, ns = d.ns;
  const int rg = 16 * warp + g;      // the thread's rows rg, rg + 8
  const float* e0 = E + rg * RW_EW;
  const float* e1 = e0 + 8 * RW_EW;
  uint32_t a[16][4];
  float acc[128];
  int it = 0;

  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
    const int row0 = (p * d.nc + wg) * RW_TILE;
    const int R0 = row0 + rg, R1 = R0 + 8;
    const bool v0 = R0 < d.n, v1 = R1 < d.n;
    // the narrow columns of each row (every thread is done with the last
    // tile's)
    bar_sync(1 + wg, 128);
    if (tid < RW_TILE)
      rw_narrow_row(E, tid, row0, d.n, d.pts, d.nrm, d.dirs, d.d_view,
                    d.multires, d.nar);
    bar_sync(1 + wg, 128);

    // layer 0 from the feature and the narrow columns, then the hidden
    // layers: relu(X W + b), rounded to bf16 as the next A
    rw_feat_frags(a, d.feat, d.d_feat, R0, R1, v0, v1, t);
    uint32_t ef[3][4];
    rw_narrow_frags(ef, e0, e1, t);
    rw_layer0(ns, it, ring, full, empty, acc, a, ef, lead);
    it += 5;
    for (int l = 0; l < lL; ++l) {
      if (l) {
        rw_layer<256>(ns, it, ring, full, empty, acc, a, lead);
        it += 4;
      }
      uint32_t m[4];   // the ReLU mask, which only the backward keeps
      rw_activate(acc, bias + l * GW_BW, t, a, m);
    }

    // the last layer (m64n8) -> rgb: column 2t + (e % 2) of row R0 (e < 2)
    // or R1
    float acc8[4];
    rw_last_layer(ns, it, ring, full, empty, acc8, a, lead);
    it += 4;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 2 * t + (e & 1);
      if ((e < 2 ? v0 : v1) && c < d.d_out) {
        const float y = acc8[e] + bias[lL * GW_BW + c];
        d.out[(size_t)(e < 2 ? R0 : R1) * d.d_out + c] =
            d.squeeze ? 1.f / (1.f + expf(-y)) : y;
      }
    }
  }
}

__global__ void __launch_bounds__(384, 1)
radiance_fwd_bf16_sweep(const __grid_constant__ RfDims d) {
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
    if (threadIdx.x == 0) rf_producer(d, ring, full, empty);
  } else {
    regs_inc<240>();
    rf_consumer(d, wg - 1, ring, E0 + (wg - 1) * RW_TILE * RW_EW, bias, full,
                empty);
  }
}

// Integer arguments: [L, multires, d_view, n, nc, grid, n_pass,
// squeeze_out, then per layer ins[L], outs[L], f_off[L]]
// (ops/radiance_kernel.fwd_wg16_plan: tc_pack.rad_sweep_layout's layer
// offsets, whose slab counts and widths are this design's).  Pointers:
// [pts, normals, dirs, feat, rgb, forward pack, b[L]].  Returns a
// cudaError_t value; 0 when the launch was accepted.
extern "C" int radiance_fwd_bf16(const int* ia, const unsigned long long* p,
                                 float scale, unsigned long long stream) {
  (void)scale;
  RfDims d;
  d.L = ia[0];
  d.multires = ia[1];
  d.d_view = ia[2];
  d.n = ia[3];
  d.nc = ia[4];
  const int grid = ia[5];
  d.n_pass = ia[6];
  d.squeeze = ia[7];
  const int L = d.L, lL = L - 1;
  const int* q = ia + 8;
  if (L < 2 || L > GW_MAXL || d.d_view != 3 * (1 + 2 * d.multires) ||
      d.nc < 1 || d.nc > 2 || grid < 1 || d.n_pass < 1 ||
      (long long)d.n_pass * d.nc * RW_TILE < d.n)
    return (int)cudaErrorInvalidValue;
  d.nar = 6 + d.d_view;
  d.d_feat = q[0] - d.nar;
  d.d_out = q[L + lL];
  if (d.nar > RW_NAR || d.d_feat < 2 || d.d_feat > 256 || d.d_feat % 2 ||
      d.d_out < 1 || d.d_out > RW_LAST)
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
    d.b[l] = (const float*)p[6 + l];
    if ((l && in != q[L + l - 1]) || (l && in > 256) || out < 1 ||
        (l < lL && out > 256) || q[2 * L + l] % 1024)
      return (int)cudaErrorInvalidValue;
  }
  d.n_slab = rw_fwd_slabs(L, q + 2 * L, d.slab_off, d.slab_bytes, 0);
  if (d.n_slab > RW_MAXS) return (int)cudaErrorInvalidValue;
  const size_t fixed = 1024 + (size_t)d.nc * RW_TILE * RW_EW * 4 +
                       (size_t)L * GW_BW * 4;
  const int nst = (int)((GW_SMEM_MAX - fixed) / ((size_t)GW_SLAB + 16));
  d.ns = nst < GW_MAX_NS ? nst : GW_MAX_NS;
  // a consumer holds every slab of a layer (at most 5) until its products
  // retire
  if (d.ns < 5) return (int)cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)d.ns * (GW_SLAB + 16);
  cudaError_t e = cudaFuncSetAttribute(
      radiance_fwd_bf16_sweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  radiance_fwd_bf16_sweep<<<grid, 128 * (1 + d.nc), smem,
                            (cudaStream_t)stream>>>(d);
  return (int)cudaGetLastError();
}

// The sweep's attributes as the device holds them, read after a launch:
// out[0 .. 2] = registers a thread, dynamic shared memory a block (as the
// launcher last set it), static shared memory.  Returns a cudaError_t
// value.
extern "C" int radiance_fwd_bf16_attrs(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e =
      cudaFuncGetAttributes(&a, (const void*)radiance_fwd_bf16_sweep);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = a.maxDynamicSharedSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  return 0;
}
