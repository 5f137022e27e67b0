"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips with the reason "needs a CUDA
device" on a machine without one.  The file imports neither jax nor the JAX
package, so it runs on the GPU machine as it is::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6 against ``sum_i |s_i U_id|`` — the kernel
and the plain version sum the clients in different orders, and float32
summation error scales with the terms' magnitudes.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import masked_aggregate as ma
from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(c, d, seed, dtype, device):
    r = np.random.default_rng(seed)
    u = torch.from_numpy(r.normal(size=(c, d)).astype(np.float32)).to(device, dtype)
    s = (r.uniform(0, 2, size=c) * (r.uniform(size=c) < 0.6)).astype(np.float32)
    return u, torch.from_numpy(s).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (1, 7, 4097, 58430))
@pytest.mark.parametrize("c", (1, 3, 32, 33, 200))
def test_masked_scale_aggregate_kernel_matches_plain(cuda, c, d, dtype):
    u, s = _inputs(c, d, c * 7919 + d, dtype, cuda)
    before = ma.masked_scale_aggregate_cuda.launches
    got = ops.masked_scale_aggregate(u, s)
    again = ops.masked_scale_aggregate(u, s)
    want = ma.masked_scale_aggregate_ref(u, s)
    torch.cuda.synchronize()
    assert ma.masked_scale_aggregate_cuda.launches == before + 2
    assert got.shape == (d,) and got.dtype == torch.float32
    mag = (s.abs()[:, None] * u.float().abs()).sum(0)
    assert bool(((got - want).abs() <= 1e-6 + 1e-5 * mag).all())
    assert torch.equal(got, again)          # fixed summation order


@pytest.mark.cuda
def test_masked_scale_aggregate_wrapper_rejects(cuda):
    s = torch.zeros((4,), device=cuda)
    for bad in (
        torch.zeros((512, 4), device=cuda).t(),                   # not contiguous
        torch.zeros((4, 7), device=cuda),                         # D not a multiple of 4
        torch.zeros((4, 512), device=cuda, dtype=torch.float16),  # dtype
        torch.zeros((4 * 512 + 1,), device=cuda)[1:].view(4, 512),  # misaligned rows
    ):
        with pytest.raises((ValueError, TypeError)):
            ma.masked_scale_aggregate_cuda(bad, s)
    with pytest.raises(ValueError):
        ma.masked_scale_aggregate_cuda(torch.zeros((4, 512), device=cuda), s.cpu())
