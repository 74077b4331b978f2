#!/usr/bin/env python3
"""How the card's TF32 and bf16 tensor-core products round, on a GPU.

    python3 tools/tf32_mma_probe.py

Builds one warp-wide ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``
and one ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` (nvcc,
sm_90a, into build/probe/) and runs them on inputs whose exact result is
known, to read how the tensor cores' products round (the mma.sync
products are the probe's alone: every kernel of csrc/ multiplies on
wgmma, read below):
- whether an f32 operand's bits below TF32's 10-bit mantissa are dropped
  (truncated) or rounded (TF32; the bf16 operands are rounded to nearest
  even by the kernels themselves, as here);
- whether adding a product to the f32 accumulator rounds to nearest or
  toward zero (both);
- whether the k products of one instruction (8 TF32, 16 bf16) are summed
  exactly before they meet the accumulator (both).
It also builds Hopper's warpgroup ``wgmma.mma_async.m64n8k16`` and
``m64n256k16`` (bf16, A from registers, B from a 128-byte swizzled slab
in shared memory, through csrc/wgmma.cuh as csrc/sdf_fwd_bf16.cu uses
them) and reads the same for wgmma, and how its f32 accumulator carries a
sum across the k-steps of one commit group and across commit groups (a
k-slab each, waited on between them), and holds one m64n256 product of
random bf16 values against the float64 product (the fragment and slab
layouts), one m64n48 product, and the product X^T R with A and B both
MN-major tile images in shared memory, as K1-bwd-bf16's weight-gradient
pass (csrc/geometry_bwd_bf16_wg.cu) runs it.  And the TF32 ``wgmma``
(``m64nNk8.f32.tf32.tf32``) of K1-bwd (csrc/geometry_bwd_wg.cu), through
csrc/wgmma.cuh's wrappers: with A from registers (the fragment {(g, t),
(g + 8, t), (g, t + 4), (g + 8, t + 4)}) and from a K-major 128-byte
swizzled tile in shared memory, B a K-major slab of 32 f32 k a row:
whether it drops an f32 operand's 13 low bits as mma.sync does, how its
accumulator rounds across k-steps and across commit groups, one m64n256
product of random TF32 values against float64 from each A source, the
weight-gradient pass's product X^T R with both operands laid out as the
sweep writes its tile images, and one m64n128 product in 3xTF32 by the
sweep's scheme (big_x read by the tensor core from the f32 tile, small_x
= x - big_x from registers, W pre-split) against float64, beside one
TF32 product of the same values.
Prints one line per case and a JSON summary with the card's name and power
limit.
"""
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(HERE, "build", "probe")

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include "wgmma.cuh"
// D[16][8] = A[16][8] B[8][8] + C[16][8], all row-major, one warp
__global__ void probe_kernel(const float* A, const float* B, const float* C,
                             float* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t a[4] = {__float_as_uint(A[g * 8 + t]),
                   __float_as_uint(A[(g + 8) * 8 + t]),
                   __float_as_uint(A[g * 8 + t + 4]),
                   __float_as_uint(A[(g + 8) * 8 + t + 4])};
  uint32_t b[2] = {__float_as_uint(B[t * 8 + g]),
                   __float_as_uint(B[(t + 4) * 8 + g])};
  float c[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  D[g * 8 + 2 * t] = c[0];
  D[g * 8 + 2 * t + 1] = c[1];
  D[(g + 8) * 8 + 2 * t] = c[2];
  D[(g + 8) * 8 + 2 * t + 1] = c[3];
}
// the same with A[16][16] B[16][8] on bf16 operands (each f32 input
// rounded to nearest even, as csrc/wgmma.cuh's pack_bf16 does)
__device__ uint32_t pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__global__ void probe_bf16_kernel(const float* A, const float* B,
                                  const float* C, float* D) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  uint32_t a[4] = {pair(A[g * 16 + 2 * t], A[g * 16 + 2 * t + 1]),
                   pair(A[(g + 8) * 16 + 2 * t], A[(g + 8) * 16 + 2 * t + 1]),
                   pair(A[g * 16 + 2 * t + 8], A[g * 16 + 2 * t + 9]),
                   pair(A[(g + 8) * 16 + 2 * t + 8],
                        A[(g + 8) * 16 + 2 * t + 9])};
  uint32_t b[2] = {pair(B[2 * t * 8 + g], B[(2 * t + 1) * 8 + g]),
                   pair(B[(2 * t + 8) * 8 + g], B[(2 * t + 9) * 8 + g])};
  float c[4] = {C[g * 8 + 2 * t], C[g * 8 + 2 * t + 1],
                C[(g + 8) * 8 + 2 * t], C[(g + 8) * 8 + 2 * t + 1]};
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  D[g * 8 + 2 * t] = c[0];
  D[g * 8 + 2 * t + 1] = c[1];
  D[(g + 8) * 8 + 2 * t] = c[2];
  D[(g + 8) * 8 + 2 * t + 1] = c[3];
}
// D[64][N] = A[64][16 ks] B[16 ks][N] + C[64][N] (row-major) on one
// warpgroup: k-step j one wgmma on the slab's descriptor + 2 j (ks <= 4);
// split: each k-step its own commit group, waited on before the next
template <int N>
__global__ void probe_wgmma_kernel(const float* A, const float* B,
                                   const float* C, float* D, int ks,
                                   int split) {
  __shared__ __align__(1024) __nv_bfloat16 Bs[N * 64];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, K = 16 * ks, r0 = 16 * warp + g;
  for (int i = tid; i < N * 64; i += 128) {
    const int n = i / 64, k = i % 64;
    Bs[i ^ (((i >> 6) & 7) << 3)] =
        __float2bfloat16_rn(k < K ? B[k * N + n] : 0.f);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* x0 = A + r0 * K + 16 * j + 2 * t;
    const float* x1 = x0 + 8 * K;
    const bool in = j < ks;
    a[j][0] = in ? pack_bf16(x0[0], x0[1]) : 0u;
    a[j][1] = in ? pack_bf16(x1[0], x1[1]) : 0u;
    a[j][2] = in ? pack_bf16(x0[8], x0[9]) : 0u;
    a[j][3] = in ? pack_bf16(x1[8], x1[9]) : 0u;
  }
  float acc[N / 2];
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * q + e] = C[(r0 + 8 * (e >> 1)) * N + 8 * q + 2 * t + (e & 1)];
  const uint64_t desc = desc_sw128(smem_u32(Bs));
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= ks) break;
    if constexpr (N == 8) wgmma_n8(acc, a[j], desc + 2 * j, 1);
    else if constexpr (N == 48) wgmma_n48(acc, a[j], desc + 2 * j, 1);
    else wgmma_n256(acc, a[j], desc + 2 * j, 1);
    if (split) {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      wgmma_fence();
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      D[(r0 + 8 * (e >> 1)) * N + 8 * q + 2 * t + (e & 1)] = acc[4 * q + e];
}
extern "C" int probe_wgmma(const float* A, const float* B, const float* C,
                           float* D, int n, int ks, int split) {
  if (n == 8)
    probe_wgmma_kernel<8><<<1, 128>>>(A, B, C, D, ks, split);
  else if (n == 48)
    probe_wgmma_kernel<48><<<1, 128>>>(A, B, C, D, ks, split);
  else
    probe_wgmma_kernel<256><<<1, 128>>>(A, B, C, D, ks, split);
  return (int)cudaDeviceSynchronize();
}
// D[64][320] = X^T R for X [64 k][64 m] and R [64 k][320 n] (row-major),
// both laid out as MN-major tile images (wgmma.cuh) in shared memory, on
// wgmma_ss_n256 (columns 0 .. 255) and wgmma_ss_n64 (256 .. 319) over
// four k-steps: geometry_bwd_bf16_wg.cu's weight-gradient product
__global__ void probe_wgmma_ss_kernel(const float* X, const float* R,
                                      float* D) {
  __shared__ __align__(1024) unsigned char sm[6 * 8192];
  unsigned char* rs = sm;               // R: five 64-column blocks
  unsigned char* xs = sm + 5 * 8192;    // X: one
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int i = tid; i < 64 * 384; i += 128) {
    const int k = i / 384, c = i % 384;
    const float v = c < 320 ? R[k * 320 + c] : X[k * 64 + c - 320];
    unsigned char* base = c < 320 ? rs : xs;
    const int cc = c < 320 ? c : c - 320;
    *(__nv_bfloat16*)(base + (cc >> 6) * 8192 + k * 128 +
                      ((((cc & 63) >> 3) ^ (k & 7)) << 4) + (cc & 7) * 2) =
        __float2bfloat16_rn(v);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  float acc[128], acc64[32];
  const uint64_t da = desc_mn128(smem_u32(xs), 8192, 1024);
  const uint64_t db = desc_mn128(smem_u32(rs), 8192, 1024);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    wgmma_ss_n256(acc, da + 128 * k, db + 128 * k, k);
    wgmma_ss_n64(acc64, da + 128 * k, db + 4 * 512 + 128 * k, k);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(acc64);
  const int r0 = 16 * warp + g;
  for (int q = 0; q < 40; ++q)
    for (int e = 0; e < 4; ++e)
      D[(r0 + 8 * (e >> 1)) * 320 + 8 * q + 2 * t + (e & 1)] =
          q < 32 ? acc[4 * q + e] : acc64[4 * (q - 32) + e];
}
extern "C" int probe_wgmma_ss(const float* X, const float* R, float* D) {
  probe_wgmma_ss_kernel<<<1, 128>>>(X, R, D);
  return (int)cudaDeviceSynchronize();
}
// TF32 wgmma: D[64][N] = A[64][8 ks] B[8 ks][N] + C[64][N] (row-major), ks
// <= 4 k-steps of one 32-k slab (B: (k, n) at n * 32 + swizzled k, as
// tc_pack.pack_rev_f32 lays a slab out); amode 0: A from registers, 1:
// from a K-major swizzled tile ((r, k) at r * 32 + swizzled k, as
// geometry_bwd_wg.cu's A tile and, for X^T, its X images); split: each
// k-step its own commit group, waited on before the next
__device__ __forceinline__ int sw32(int r, int k) {
  return r * 32 + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}
template <int N>
__global__ void probe_tf32_kernel(const float* A, const float* B,
                                  const float* C, float* D, int ks, int amode,
                                  int split) {
  __shared__ __align__(1024) float Bs[N * 32];
  __shared__ __align__(1024) float As[64 * 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, K = 8 * ks, r0 = 16 * warp + g;
  for (int i = tid; i < N * 32; i += 128) {
    const int n = i / 32, k = i % 32;
    Bs[sw32(n, k)] = k < K ? B[k * N + n] : 0.f;
  }
  for (int i = tid; i < 64 * 32; i += 128) {
    const int r = i / 32, k = i % 32;
    As[sw32(r, k)] = k < K ? A[r * K + k] : 0.f;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool in = j < ks;
    a[j][0] = in ? __float_as_uint(A[r0 * K + 8 * j + t]) : 0u;
    a[j][1] = in ? __float_as_uint(A[(r0 + 8) * K + 8 * j + t]) : 0u;
    a[j][2] = in ? __float_as_uint(A[r0 * K + 8 * j + t + 4]) : 0u;
    a[j][3] = in ? __float_as_uint(A[(r0 + 8) * K + 8 * j + t + 4]) : 0u;
  }
  float acc[N / 2];
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[4 * q + e] = C[(r0 + 8 * (e >> 1)) * N + 8 * q + 2 * t + (e & 1)];
  const uint64_t db = desc_sw128(smem_u32(Bs));
  const uint64_t da = desc_sw128(smem_u32(As));
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j >= ks) break;
    if constexpr (N == 8) {
      if (amode) wgmma_tf32_ss_n8(acc, da + 2 * j, db + 2 * j, 1);
      else wgmma_tf32_n8(acc, a[j], db + 2 * j, 1);
    } else {
      if (amode) wgmma_tf32_ss_n256(acc, da + 2 * j, db + 2 * j, 1);
      else wgmma_tf32_n256(acc, a[j], db + 2 * j, 1);
    }
    if (split) {
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      wgmma_fence();
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int q = 0; q < N / 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      D[(r0 + 8 * (e >> 1)) * N + 8 * q + 2 * t + (e & 1)] = acc[4 * q + e];
}
extern "C" int probe_tf32(const float* A, const float* B, const float* C,
                          float* D, int n, int ks, int amode, int split) {
  if (n == 8)
    probe_tf32_kernel<8><<<1, 128>>>(A, B, C, D, ks, amode, split);
  else
    probe_tf32_kernel<256><<<1, 128>>>(A, B, C, D, ks, amode, split);
  return (int)cudaDeviceSynchronize();
}
// D[64][128] = A[64][32] B[32][128] in 3xTF32 by the sweep's scheme: A
// raw f32 in a K-major tile (big: the tensor core's truncation), small_A =
// A - big from registers, B given pre-split (Bb, Bs); per k-step small_A
// Bb + A Bs + A Bb, one commit group
__global__ void probe_3x_kernel(const float* A, const float* Bb,
                                const float* Bsm, float* D) {
  __shared__ __align__(1024) float Bs[2 * 128 * 32];
  __shared__ __align__(1024) float As[64 * 32];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp + g;
  for (int i = tid; i < 128 * 32; i += 128) {
    const int n = i / 32, k = i % 32;
    Bs[sw32(n, k)] = Bb[k * 128 + n];
    Bs[128 * 32 + sw32(n, k)] = Bsm[k * 128 + n];
  }
  for (int i = tid; i < 64 * 32; i += 128) As[sw32(i / 32, i % 32)] = A[i];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  uint32_t sm[4][4];
  auto small = [&](int r, int k) {
    const float x = As[sw32(r, k)];
    return __float_as_uint(x - __uint_as_float(__float_as_uint(x) &
                                               0xffffe000u));
  };
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sm[j][0] = small(r0, 8 * j + t);
    sm[j][1] = small(r0 + 8, 8 * j + t);
    sm[j][2] = small(r0, 8 * j + t + 4);
    sm[j][3] = small(r0 + 8, 8 * j + t + 4);
  }
  float acc[64];
  const uint64_t bb = desc_sw128(smem_u32(Bs));
  const uint64_t bs = desc_sw128(smem_u32(Bs + 128 * 32));
  const uint64_t da = desc_sw128(smem_u32(As));
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wgmma_tf32_n128(acc, sm[j], bb + 2 * j, j ? 1 : 0);
    wgmma_tf32_ss_n128(acc, da + 2 * j, bs + 2 * j, 1);
    wgmma_tf32_ss_n128(acc, da + 2 * j, bb + 2 * j, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int q = 0; q < 16; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      D[(r0 + 8 * (e >> 1)) * 128 + 8 * q + 2 * t + (e & 1)] = acc[4 * q + e];
}
extern "C" int probe_3x(const float* A, const float* Bb, const float* Bsm,
                        float* D) {
  probe_3x_kernel<<<1, 128>>>(A, Bb, Bsm, D);
  return (int)cudaDeviceSynchronize();
}
extern "C" int probe(const float* A, const float* B, const float* C,
                     float* D) {
  probe_kernel<<<1, 32>>>(A, B, C, D);
  return (int)cudaDeviceSynchronize();
}
extern "C" int probe_bf16(const float* A, const float* B, const float* C,
                          float* D) {
  probe_bf16_kernel<<<1, 32>>>(A, B, C, D);
  return (int)cudaDeviceSynchronize();
}
"""


def probe_wgmma(so, accum, u):
    """The wgmma cases: the accumulation cases of mma.sync on m64n8k16,
    0.75 ulp added to 1 in each of four k-steps of one commit group and
    of four groups waited on one by one, and one m64n256k16 product over
    four k-steps of random bf16 values against float64."""
    import numpy as np
    import torch
    fn = so.probe_wgmma
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int

    def run(A, B, C, n, ks, split=0):
        t = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).cuda()
             for v in (A, B, C)]
        D = torch.zeros(64, n, device="cuda")
        rc = fn(*[v.data_ptr() for v in t], D.data_ptr(), n, ks, split)
        if rc:
            raise RuntimeError(f"wgmma probe failed: cudaError_t {rc}")
        return D.cpu().numpy().astype(np.float64)

    four = {1 + 4 * u: "each k-step rounds to nearest",
            1.0: "each k-step rounds toward zero",
            1 + 3 * u: "the k-steps summed before one rounding"}
    cases = [(name, 1, 0, arow, c00, meaning, np.eye(16, 8))
             for name, identity, arow, c00, meaning in accum[:2]]
    cases.append(("sixteen products of 0.125 ulp into 1", 1, 0,
                  [0.125 * u] * 16, 1.0,
                  {1 + 2 * u: "products summed before the accumulator",
                   1.0: "products added one by one, or their sum lost"},
                  np.ones((16, 8))))
    b4 = np.zeros((64, 8))
    b4[[0, 16, 32, 48], 0] = 1.0
    a4 = np.zeros(64)
    a4[[0, 16, 32, 48]] = 0.75 * u
    cases.append(("0.75 ulp into 1 in each of 4 k-steps, one group", 4, 0,
                  a4, 1.0, four, b4))
    cases.append(("0.75 ulp into 1 in each of 4 k-slabs, a group each", 4,
                  1, a4, 1.0, four, b4))
    rows = []
    for name, ks, split, arow, c00, meaning, B in cases:
        A = np.zeros((64, 16 * ks))
        A[0, :len(arow)] = arow
        C = np.zeros((64, 8))
        C[0, 0] = c00
        d = float(run(A, B, C, 8, ks, split)[0, 0])
        got = next((m for v, m in meaning.items()
                    if d == float(np.float32(v))),
                   "none of the expected results")
        print(f"wgmma {name}: {d!r} -> {got}")
        rows.append({"mma": "wgmma", "case": name, "result": d,
                     "reads_as": got})
    rng = np.random.RandomState(0)
    bf = lambda v: torch.from_numpy(v.astype(np.float32)).to(
        torch.bfloat16).float().numpy().astype(np.float64)
    A, B = bf(rng.randn(64, 64)), bf(rng.randn(64, 256))
    D = run(A, B, np.zeros((64, 256)), 256, 4)
    err = float(np.abs(D - A @ B).max() / np.abs(A @ B).max())
    ok = err < 1e-6
    print(f"wgmma m64n256k16 x 4 k-steps, random bf16: max error "
          f"{err:.2e} of max|AB| -> {'layouts agree' if ok else 'WRONG'}")
    rows.append({"mma": "wgmma", "case": "m64n256 random", "result": err,
                 "reads_as": "layouts agree" if ok else "wrong"})
    if not ok:
        raise AssertionError("wgmma m64n256: fragment or slab layout wrong")
    # m64n48 (layer 0's r W in K1-bwd-bf16) on the same slab layout
    B48 = bf(rng.randn(64, 48))
    D = run(A, B48, np.zeros((64, 48)), 48, 4)
    err = float(np.abs(D - A @ B48).max() / np.abs(A @ B48).max())
    ok48 = err < 1e-6
    print(f"wgmma m64n48k16 x 4 k-steps, random bf16: max error {err:.2e} "
          f"of max|AB| -> {'layouts agree' if ok48 else 'WRONG'}")
    rows.append({"mma": "wgmma", "case": "m64n48 random", "result": err,
                 "reads_as": "layouts agree" if ok48 else "wrong"})
    # A and B both MN-major tile images in shared memory (the transpose
    # bits): K1-bwd-bf16's weight-gradient product X^T R
    fn_ss = so.probe_wgmma_ss
    fn_ss.argtypes = [ctypes.c_void_p] * 3
    fn_ss.restype = ctypes.c_int
    X, R = bf(rng.randn(64, 64)), bf(rng.randn(64, 320))
    t = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).cuda()
         for v in (X, R)]
    D = torch.zeros(64, 320, device="cuda")
    rc = fn_ss(t[0].data_ptr(), t[1].data_ptr(), D.data_ptr())
    if rc:
        raise RuntimeError(f"wgmma ss probe failed: cudaError_t {rc}")
    want = X.T @ R
    err = float(np.abs(D.cpu().numpy() - want).max() / np.abs(want).max())
    okss = err < 1e-6
    print(f"wgmma m64n256k16 + m64n64k16, A and B MN-major from shared "
          f"memory, x 4 k-steps, random bf16: max error {err:.2e} of "
          f"max|X^T R| -> {'layouts agree' if okss else 'WRONG'}")
    rows.append({"mma": "wgmma", "case": "MN-major ss random",
                 "result": err,
                 "reads_as": "layouts agree" if okss else "wrong"})
    if not (ok48 and okss):
        raise AssertionError("wgmma m64n48 or the MN-major images: layout "
                             "wrong")
    return rows


def probe_wgmma_tf32(so, u):
    """The TF32 wgmma cases (K1-bwd's products): operand reading and
    accumulation on m64n8k8 from both A sources, random m64n256k8 x 4
    products of TF32 values from both against float64, the pass's X^T R
    from the image layout, and a 3xTF32 m64n128 product by the sweep's
    scheme against float64."""
    import numpy as np
    import torch
    fn = so.probe_tf32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    fn.restype = ctypes.c_int

    def run(A, B, C, n, ks, amode, split=0):
        t = [torch.from_numpy(np.ascontiguousarray(v, np.float32)).cuda()
             for v in (A, B, C)]
        D = torch.zeros(64, n, device="cuda")
        rc = fn(*[v.data_ptr() for v in t], D.data_ptr(), n, ks, amode,
                split)
        if rc:
            raise RuntimeError(f"tf32 wgmma probe failed: cudaError_t {rc}")
        return D.cpu().numpy().astype(np.float64)

    rows = []
    src = {0: "A from registers", 1: "A from shared memory"}
    eye = np.eye(8, 8)
    b4 = np.zeros((32, 8))
    b4[[0, 8, 16, 24], 0] = 1.0
    a4 = np.zeros(32)
    a4[[0, 8, 16, 24]] = 0.75 * u
    four = {1 + 4 * u: "each k-step rounds to nearest",
            1.0: "each k-step rounds toward zero",
            1 + 3 * u: "the k-steps summed before one rounding"}
    cases = [
        ("operand 1 + 0.75 * 2^-10 (below tf32's mantissa)", 1, 0,
         [1 + 0.75 * 2.0 ** -10], 0.0, eye,
         {1 + 2.0 ** -10: "operand rounded", 1.0: "operand truncated",
          1 + 0.75 * 2.0 ** -10: "operand kept in f32"}),
        ("accumulate +: 1 + 0.75 ulp", 1, 0, [0.75 * u], 1.0, eye,
         {1 + u: "rounds to nearest", 1.0: "rounds toward zero"}),
        ("accumulate -: -1 - 0.75 ulp", 1, 0, [-0.75 * u], -1.0, eye,
         {-1 - u: "rounds to nearest", -1.0: "rounds toward zero"}),
        ("eight products of 0.25 ulp into 1", 1, 0, [0.25 * u] * 8, 1.0,
         np.ones((8, 8)),
         {1 + 2 * u: "products summed before the accumulator",
          1.0: "products added one by one, or their sum lost"}),
        ("0.75 ulp into 1 in each of 4 k-steps, one group", 4, 0, a4, 1.0,
         b4, four),
        ("0.75 ulp into 1 in each of 4 k-steps, a group each", 4, 1, a4,
         1.0, b4, four)]
    for amode in (0, 1):
        for name, ks, split, arow, c00, B, meaning in cases:
            A = np.zeros((64, 8 * ks))
            A[0, :len(arow)] = arow
            C = np.zeros((64, 8))
            C[0, 0] = c00
            d = float(run(A, B, C, 8, ks, amode, split)[0, 0])
            got = next((m for v, m in meaning.items()
                        if d == float(np.float32(v))),
                       "none of the expected results")
            print(f"wgmma tf32 ({src[amode]}) {name}: {d!r} -> {got}")
            rows.append({"mma": "wgmma-tf32", "a": src[amode], "case": name,
                         "result": d, "reads_as": got})
    rng = np.random.RandomState(1)
    tf = TP_round
    ok_all = True
    for amode in (0, 1):
        A, B = tf(rng.randn(64, 32)), tf(rng.randn(32, 256))
        D = run(A, B, np.zeros((64, 256)), 256, 4, amode)
        err = float(np.abs(D - A @ B).max() / np.abs(A @ B).max())
        ok = err < 1e-6
        ok_all &= ok
        print(f"wgmma tf32 m64n256k8 x 4 k-steps ({src[amode]}), random "
              f"tf32: max error {err:.2e} of max|AB| -> "
              f"{'layouts agree' if ok else 'WRONG'}")
        rows.append({"mma": "wgmma-tf32", "a": src[amode],
                     "case": "m64n256 random", "result": err,
                     "reads_as": "layouts agree" if ok else "wrong"})
    # the pass: X [32 rows][64 columns], R [32][256], A = X^T (the X image
    # of 64 columns is the K-major tile of X^T), B = R (the R image)
    X, R = tf(rng.randn(32, 64)), tf(rng.randn(32, 256))
    D = run(X.T.copy(), R, np.zeros((64, 256)), 256, 4, 1)
    err = float(np.abs(D - X.T @ R).max() / np.abs(X.T @ R).max())
    okp = err < 1e-6
    print(f"wgmma tf32 X^T R from the tile images (32 rows): max error "
          f"{err:.2e} of max|X^T R| -> {'layouts agree' if okp else 'WRONG'}")
    rows.append({"mma": "wgmma-tf32", "case": "pass X^T R", "result": err,
                 "reads_as": "layouts agree" if okp else "wrong"})
    # 3xTF32 by the sweep's scheme against one TF32 product
    fn3 = so.probe_3x
    fn3.argtypes = [ctypes.c_void_p] * 4
    fn3.restype = ctypes.c_int
    A = rng.randn(64, 32).astype(np.float32)
    W = rng.randn(32, 128).astype(np.float32)
    Wb = TP_round(W).astype(np.float32)
    Ws = (W - Wb).astype(np.float32)
    t = [torch.from_numpy(np.ascontiguousarray(v)).cuda() for v in (A, Wb, Ws)]
    D = torch.zeros(64, 128, device="cuda")
    rc = fn3(*[v.data_ptr() for v in t], D.data_ptr())
    if rc:
        raise RuntimeError(f"3xTF32 probe failed: cudaError_t {rc}")
    want = A.astype(np.float64) @ W.astype(np.float64)
    e3 = float(np.abs(D.cpu().numpy() - want).max() / np.abs(want).max())
    D1 = run(A, np.pad(W, ((0, 0), (0, 128))), np.zeros((64, 256)), 256, 4,
             1)
    e1 = float(np.abs(D1[:, :128] - want).max() / np.abs(want).max())
    ok3 = e3 < 1e-5 and e3 < e1 / 100
    print(f"wgmma 3xTF32 m64n128k8 x 4 (the sweep's scheme), random f32: "
          f"max error {e3:.2e} of max|AW|, one TF32 product {e1:.2e} -> "
          f"{'f32 accuracy' if ok3 else 'WRONG'}")
    rows.append({"mma": "wgmma-tf32", "case": "3xTF32 sweep scheme",
                 "result": e3, "tf32_result": e1,
                 "reads_as": "f32 accuracy" if ok3 else "wrong"})
    if not (ok_all and okp and ok3):
        raise AssertionError("tf32 wgmma: fragment, tile or slab layout "
                             "wrong")
    return rows


def TP_round(v):
    """float32 values rounded to TF32 (to nearest, ties away), as
    tc_pack.tf32_round."""
    import numpy as np
    b = np.asarray(v, np.float32).view(np.int32)
    return ((b + 0x1000) & -8192).view(np.float32).astype(np.float64)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from factored_neus_tpu_torch.ops import _cuda
    os.makedirs(OUT, exist_ok=True)
    src, lib = os.path.join(OUT, "probe.cu"), os.path.join(OUT, "libprobe.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC,
                    "-o", lib, src], check=True)
    so = ctypes.CDLL(lib)
    u = 2.0 ** -23                                  # one f32 ulp at 1
    # (instruction, k, name, B is the identity, A row 0, C[0][0],
    # {result: what it shows}); every A and C value is exact in bf16
    accum = [
        ("accumulate +: 1 + 0.75 ulp", True, [0.75 * u], 1.0,
         {1 + u: "rounds to nearest", 1.0: "rounds toward zero"}),
        ("accumulate -: -1 - 0.75 ulp", True, [-0.75 * u], -1.0,
         {-1 - u: "rounds to nearest", -1.0: "rounds toward zero"}),
        ("four products of 0.25 ulp into 1", False, [0.25 * u] * 4, 1.0,
         {1 + u: "products summed before the accumulator",
          1.0: "products added one by one, or their sum lost"})]
    cases = [("tf32", 8, *accum[0]), ("tf32", 8, *accum[1]),
             ("tf32", 8, "operand 1 + 0.75 * 2^-10 (below tf32's mantissa)",
              True, [1 + 0.75 * 2.0 ** -10], 0.0,
              {1 + 2.0 ** -10: "operand rounded", 1.0: "operand truncated",
               1 + 0.75 * 2.0 ** -10: "operand kept in f32"}),
             ("tf32", 8, *accum[2]),
             *[("bf16", 16, *c) for c in accum],
             ("bf16", 16, "sixteen products of 0.125 ulp into 1", False,
              [0.125 * u] * 16, 1.0,
              {1 + 2 * u: "products summed before the accumulator",
               1.0: "products added one by one, or their sum lost"})]
    rows = []
    for kind, k, name, identity, arow, c00, meaning in cases:
        fn = getattr(so, "probe" if kind == "tf32" else "probe_bf16")
        fn.argtypes = [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        B = np.eye(k, 8, dtype=np.float32) if identity else \
            np.ones((k, 8), np.float32)
        A = np.zeros((16, k), np.float32)
        A[0, :len(arow)] = arow
        C = np.zeros((16, 8), np.float32)
        C[0, 0] = c00
        t = [torch.from_numpy(np.ascontiguousarray(v)).cuda()
             for v in (A, B, C)]
        D = torch.zeros(16, 8, device="cuda")
        rc = fn(*[v.data_ptr() for v in t], D.data_ptr())
        if rc:
            raise RuntimeError(f"probe launch failed: cudaError_t {rc}")
        d = float(D[0, 0])
        got = next((m for v, m in meaning.items() if d == float(np.float32(v))),
                   "none of the expected results")
        print(f"{kind} {name}: {d!r} -> {got}")
        rows.append({"mma": kind, "case": name, "result": d, "reads_as": got})
    rows += probe_wgmma(so, accum, u)
    rows += probe_wgmma_tf32(so, u)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
