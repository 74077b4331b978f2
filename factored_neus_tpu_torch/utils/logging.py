"""TensorBoard scalars, the rays/s meter of the training loop, and the
CLIs' hooks: log format, profiler trace and NaN stop.  Counterpart of
factored_neus_tpu/utils/logging.py (setup_logging, MetricsWriter,
ThroughputMeter, profiler_trace, debug_nans).  The writer is
tensorboardX's, or else torch.utils.tensorboard's, and does nothing where
neither imports."""
from __future__ import annotations

import contextlib
import logging as _pylogging
import os
import time
from typing import Dict, Iterable, Optional, Tuple

import torch

log = _pylogging.getLogger("factored_neus_tpu_torch")

# on inside ``debug_nans(True)``: check_finite then raises
_DEBUG_NANS = False


def setup_logging(level=_pylogging.INFO) -> None:
    """The CLIs' log format."""
    _pylogging.basicConfig(level=level,
                           format="%(asctime)s %(levelname)s %(message)s")


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the enclosed run (CPU activity, and CUDA
    kernels where a card is present), written to
    ``log_dir/trace_<pid>.json`` (Chrome trace format) when the scope
    ends; a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        log.info("profiler trace written to %s", path)


@contextlib.contextmanager
def debug_nans(enabled: bool):
    """Within the scope, a training step stops at its first non-finite
    loss or gradient (check_finite raises FloatingPointError naming the
    step and the tensor); a no-op when not enabled."""
    global _DEBUG_NANS
    if not enabled:
        yield
        return
    prev, _DEBUG_NANS = _DEBUG_NANS, True
    try:
        yield
    finally:
        _DEBUG_NANS = prev


def check_finite(step: int, loss: torch.Tensor,
                 grads: Iterable[Tuple[str, torch.Tensor]]) -> None:
    """Inside ``debug_nans(True)``: raises FloatingPointError at the first
    non-finite value among the loss and the named gradients (one host
    sync for all of them); does nothing otherwise."""
    if not _DEBUG_NANS:
        return
    named = [("loss", loss.detach())] + [(n, g) for n, g in grads
                                         if g is not None]
    ok = torch.stack([torch.isfinite(t).all() for _, t in named]).cpu()
    if not bool(ok.all()):
        name = named[int((~ok).nonzero()[0])][0]
        what = name if name == "loss" else f"gradient of {name}"
        raise FloatingPointError(f"debug_nans: non-finite {what} at step "
                                 f"{step}")


def _summary_writer_class():
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return None
    return SummaryWriter


class MetricsWriter:
    """TensorBoard scalar writer into ``log_dir`` (a no-op without a
    TensorBoard writer)."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        cls = _summary_writer_class()
        self._w = cls(log_dir) if cls is not None else None

    def scalar(self, tag: str, value, step: int) -> None:
        if self._w is not None:
            self._w.add_scalar(tag, float(value), step)

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()


class ThroughputMeter:
    """Rays/s over windows of ``window`` steps, on the host clock."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t0 = None
        self._count = 0
        self.rays_per_sec = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()
        self._count = 0

    def step(self, n_rays: int) -> None:
        if self._t0 is None:
            self.start()
            return
        self._count += n_rays
        if self._count >= self.window * n_rays:
            dt = time.perf_counter() - self._t0
            self.rays_per_sec = self._count / max(dt, 1e-9)
            self.start()
