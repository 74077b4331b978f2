"""The weight-gradient sums of K1's wgmma backward at one of its shapes
(224 -> 256, the layer before the skip), in emulated 3xTF32 on the CPU:
the cases of test_torch_tf32.py's test_3xtf32_weight_gradient_within_
k1_bwd_tolerance at K, N = 224, 256, in a file of their own so that the
test runner, which keeps a file on one worker, can run them beside the
other cases."""
import numpy as np
import pytest
import torch

from util_threads import one_thread  # noqa: F401 (autouse)

from factored_neus_tpu_torch.ops import tc_pack as TP


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("K,N", [(224, 256)])
def test_3xtf32_weight_gradient_within_k1_bwd_tolerance(rows, K, N):
    """Weight-gradient sums at K1's shapes: each tile's X^T R over 32 or 64
    rows in one truncating accumulator, tile sums added in float32, 64
    tiles; against float64 within K1-bwd's per-tensor card tolerance
    1e-4 + 1e-5 max|ref|, at most a few times the float32 sum's error."""
    rng = np.random.RandomState(K + N + rows)
    X = torch.from_numpy(rng.uniform(0, 1, (64, rows, K)).astype(np.float32))
    R = torch.from_numpy(rng.randn(64, rows, N).astype(np.float32))
    ref = torch.einsum("trk,trn->kn", X.double(), R.double())
    tc = torch.zeros(K, N)
    f32 = torch.zeros(K, N)
    for t in range(X.shape[0]):
        tc = tc + TP.mm_3xtf32(X[t].t(), R[t], stage=rows)
        f32 = f32 + X[t].t() @ R[t]
    tol = 1e-4 + 1e-5 * float(ref.abs().max())
    e_tc = float((tc.double() - ref).abs().max())
    e_f32 = float((f32.double() - ref).abs().max())
    assert e_tc <= tol
    assert e_tc <= 4 * e_f32 + 1e-6
