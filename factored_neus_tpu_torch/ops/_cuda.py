"""Build and call the hand-written CUDA kernels of csrc/.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds).  All sources are compiled at
once, one ``nvcc`` process each, at the first launch or when
``build_all()`` is called, into ``build/kernels/`` beside the package; a
library is rebuilt when it is older than its source or the shared header.

Every exported C function has the signature
``int fn(const int* iargs, const unsigned long long* ptrs, float scale,
unsigned long long stream)`` and returns a ``cudaError_t`` value: the
wrapper raises on anything but 0, so a refused launch never passes
silently.  Integer arguments are
``[L, multires, d_embed, ld, skip_mask, n, grid, ins[L], outs[L]]``; the
pointer list is documented beside each C function.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "kernels")
SOURCES = ("geometry_fwd.cu", "geometry_bwd.cu", "sdf_fwd.cu")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cands.append(shutil.which("nvcc") or "")
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _lib_path(src: str) -> str:
    return os.path.join(BUILD_DIR, "lib" + os.path.splitext(src)[0] + ".so")


def _stale(src: str) -> bool:
    lib = _lib_path(src)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, f))
                 for f in (src, "sdf_mlp.cuh"))
    return os.path.getmtime(lib) < newest


def build_all(sources: Sequence[str] = SOURCES) -> float:
    """Compile every stale source, all nvcc processes started together.
    Returns the wall seconds spent; raises with nvcc's output on failure."""
    t0 = time.time()
    with _LOCK:
        todo = [s for s in sources if _stale(s)]
        if not todo:
            return 0.0
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for src in todo:
            out = _lib_path(src) + ".tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-o", out, os.path.join(CSRC, src)]
            procs.append((src, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, out, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[src] = log
            if proc.returncode != 0:
                failed.append(f"--- {src} ---\n{log}")
            else:
                os.replace(out, _lib_path(src))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.time() - t0


def _load(src: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(src)
    if lib is not None:
        return lib
    build_all((src,))
    lib = ctypes.CDLL(_lib_path(src))
    with _LOCK:
        _LIBS[src] = lib
    return lib


class CudaKernel:
    """One exported C function of one source, with its launch count.

    ``launches`` grows by one for every call that the C function accepted,
    and nowhere else."""

    def __init__(self, name: str, source: str, symbol: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.launches = 0
        self._fn = None

    def _function(self):
        if self._fn is None:
            fn = getattr(_load(self.source), self.symbol)
            fn.argtypes = [ctypes.POINTER(ctypes.c_int),
                           ctypes.POINTER(ctypes.c_ulonglong),
                           ctypes.c_float, ctypes.c_ulonglong]
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, iargs: List[int], tensors: List[torch.Tensor],
               scale: float, device: torch.device) -> None:
        fn = self._function()
        ia = (ctypes.c_int * len(iargs))(*iargs)
        ptrs = (ctypes.c_ulonglong * len(tensors))(
            *[t.data_ptr() for t in tensors])
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            rc = fn(ia, ptrs, float(scale), stream)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} was not launched: "
                               f"cudaError_t {rc}")
        self.launches += 1


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_cuda_tensors(name: str, tensors: Sequence[torch.Tensor]) -> None:
    """Every tensor a kernel reads: float32, contiguous, on the first
    tensor's CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: expects CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(
                f"{name}: expects contiguous float32 tensors on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")
