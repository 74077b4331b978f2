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
// - The forward is sweep16.cuh's (sw_forward), which K1-fwd-bf16 runs too:
//   the two give the same bits of [sdf / scale | feature].
#include "sweep16.cuh"

__device__ __forceinline__ void sw_producer(const SwDims& d,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty) {
  int it = 0;
  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x)
    it = sw_put_fwd(d, it, ring, full, empty);
}

__device__ __forceinline__ void sw_consumer(const SwDims& d, int w,
                                            unsigned char* ring, float* E,
                                            const float* bias, uint64_t* full,
                                            uint64_t* empty) {
  const int tid = threadIdx.x & 127;
  uint32_t a[16][4];
  float acc[128], acc8[4];
  int it = 0;

  for (int p = blockIdx.x; p < d.n_pass; p += gridDim.x) {
    const int row0 = (p * d.nc + w) * 64;
    // the encoding tile (every thread is done with the last tile's)
    bar_sync(1 + w, 128);
    if (tid < 64) sw_encode_row(d, E, tid, row0);
    bar_sync(1 + w, 128);
    it = sw_forward<false>(d, it, row0, ring, E, bias, full, empty, nullptr,
                           a, acc, acc8);
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
