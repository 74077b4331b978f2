"""Row-chunked evaluation of the CPU twins' large SDF sweeps.  Counterpart
of factored_neus_tpu/ops/chunk.py (chunked_apply, chunked_apply_tree) as a
plain loop: rows are independent, so the result equals one call over all
rows while the working set stays that of one chunk.  On the card a sweep
is one kernel launch over all its rows and does not come here."""
from __future__ import annotations

from typing import Callable

import torch


def chunked_apply_tree(fn: Callable, x: torch.Tensor, chunk_size: int):
    """``fn`` over the rows of ``x`` in chunks of ``chunk_size`` rows, the
    last one shorter; fn returns a tensor or a tuple of tensors that share
    the leading row axis (the (sdf, feature, grad) of a geometry sweep)."""
    n = x.shape[0]
    if n <= chunk_size:
        return fn(x)
    parts = [fn(x[i:i + chunk_size]) for i in range(0, n, chunk_size)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def chunked_apply(fn: Callable[[torch.Tensor], torch.Tensor],
                  x: torch.Tensor, chunk_size: int) -> torch.Tensor:
    """``fn`` ([n, d] -> [n, ...]) over the rows of ``x`` in chunks."""
    return chunked_apply_tree(fn, x, chunk_size)
