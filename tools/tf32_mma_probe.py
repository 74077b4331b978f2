#!/usr/bin/env python3
"""How the card's TF32 and bf16 tensor-core products round, on a GPU.

    python3 tools/tf32_mma_probe.py

Builds one warp-wide ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``
and one ``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` (nvcc,
sm_90a, into build/probe/) and runs them on inputs whose exact result is
known, to read what the products of csrc/tc_mma.cuh depend on:
- whether an f32 operand's bits below TF32's 10-bit mantissa are dropped
  (truncated) or rounded (TF32; the bf16 operands are rounded to nearest
  even by the kernels themselves, as here);
- whether adding a product to the f32 accumulator rounds to nearest or
  toward zero (both);
- whether the k products of one instruction (8 TF32, 16 bf16) are summed
  exactly before they meet the accumulator (both).
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
// rounded to nearest even as csrc/tc_mma.cuh's bf16_pair does)
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
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", lib, src],
                   check=True)
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    print(json.dumps({"card": card, "cases": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
