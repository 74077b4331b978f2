"""Surface-crossing helper of the stage-1 surface branch.  Counterpart of
factored_neus_tpu/models/secondary.py (first_crossing); the secondary-ray
tracing of stage 2 is a later slice."""
from __future__ import annotations

from typing import Tuple

import torch


def first_crossing(sdf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of the first +-to- sign change along the sample axis, as the
    reference's ``min(sign(sdf) * arange(T, 0, -1))``: (min_val [B],
    min_idx [B]); ties resolve to the first index like jnp.argmin."""
    T = sdf.shape[1]
    ramp = torch.arange(T, 0, -1, dtype=sdf.dtype, device=sdf.device)[None]
    tmp = torch.sign(sdf) * ramp
    min_val, min_idx = torch.min(tmp, dim=-1)
    return min_val, torch.argmin(tmp, dim=-1)
