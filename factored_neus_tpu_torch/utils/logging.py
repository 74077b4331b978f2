"""TensorBoard scalars and the rays/s meter of the training loop.
Counterpart of factored_neus_tpu/utils/logging.py (MetricsWriter,
ThroughputMeter).  The writer is tensorboardX's, or else
torch.utils.tensorboard's, and does nothing where neither imports."""
from __future__ import annotations

import os
import time
from typing import Dict


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
