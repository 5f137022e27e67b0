"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips with the reason "needs a CUDA
device" on a machine without one.  The file imports neither jax nor the JAX
package, so it runs on the GPU machine as it is::

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: rtol 1e-5 / atol 1e-6 against ``sum_i |s_i U_id|`` — the kernel
and the plain version sum the clients in different orders, and float32
summation error scales with the terms' magnitudes; squared norms (sums of
positive terms) rtol 1e-5.  The bitwise contracts between the kernels hold
exactly: the fused norm+aggregate's norms are ``client_sqnorms``' and its
aggregate is ``masked_scale_aggregate``'s, the compress kernel with
``kind='none'`` is the fused norm+aggregate, and the compress kernel equals
eager compression on the card followed by the fused norm+aggregate.  The
mesh round's kernels: at ``k <= BLOCK_CLIENTS`` the sharded aggregate is
``masked_scale_aggregate``'s and the sharded compress aggregate is the
compress kernel's; the sharded compress kernel's norms are the compress
kernel's at every ``k``; ``kind='none'`` is the sharded aggregate.
"""

import numpy as np
import pytest
import torch

from repro_torch import rng
from repro_torch.core.compression import apply_compression_flat, client_material
from repro_torch.kernels import masked_aggregate as ma
from repro_torch.kernels import norm_aggregate as na
from repro_torch.kernels import ops
from repro_torch.kernels import sharded_aggregate as sa

COMPRESSORS = (("randk", 0.1), ("qsgd", 8.0), ("qsgd", 5.0), ("natural", 0.0))


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


def _sq_close(got, want):
    return bool(((got - want).abs() <= 1e-5 * want.abs()).all())


def _agg_close(got, want, u, s):
    mag = (s.abs()[:, None] * u.float().abs()).sum(0)
    return bool(((got - want).abs() <= 1e-6 + 1e-5 * mag).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (1, 7, 4097, 58430))
@pytest.mark.parametrize("c", (1, 3, 4, 32, 33, 200))
def test_norm_kernels_match_plain_and_each_other(cuda, c, d, dtype):
    u, s = _inputs(c, d, c * 104729 + d, dtype, cuda)
    before = (na.client_sqnorms_cuda.launches, na.norm_scale_aggregate_cuda.launches)
    sq2, sq2b = ops.client_sqnorms(u), ops.client_sqnorms(u)
    (sq3, agg3), (sq3b, agg3b) = ops.norm_scale_aggregate(u, s), ops.norm_scale_aggregate(u, s)
    sq4, agg4 = ops.compress_norm_scale_aggregate(u, s, (), "none", 0.0)
    agg1 = ops.masked_scale_aggregate(u, s)
    torch.cuda.synchronize()
    assert (na.client_sqnorms_cuda.launches, na.norm_scale_aggregate_cuda.launches) == (
        before[0] + 2, before[1] + 2)
    assert sq3.shape == (c,) and agg3.shape == (d,) and agg3.dtype == torch.float32
    assert _sq_close(sq2, na.client_sqnorms_ref(u))
    assert _agg_close(agg3, ma.masked_scale_aggregate_ref(u, s), u, s)
    assert torch.equal(sq2, sq2b) and torch.equal(sq3, sq3b) and torch.equal(agg3, agg3b)
    assert torch.equal(sq3, sq2)             # norm half == client_sqnorms
    assert torch.equal(agg3, agg1)           # aggregate half == masked_scale_aggregate
    assert torch.equal(sq4, sq3) and torch.equal(agg4, agg3)   # kind='none'


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("c,d", ((1, 7), (4, 58430), (33, 4097), (200, 1000)))
@pytest.mark.parametrize("kind,param", COMPRESSORS)
def test_compress_kernel_matches_plain_and_eager(cuda, kind, param, c, d, dtype):
    u, s = _inputs(c, d, c * 31 + d, dtype, cuda)
    u[0, :4] = torch.tensor([2.0 ** -126, 1e-40, 0.5, -0.25], device=cuda).to(dtype)
    keys = rng.split(rng.PRNGKey(c + d, device=cuda), c)
    mats = tuple(m["u"] for m in client_material({"u": u}, keys, kind, param))
    sq, agg = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
    sq_b, agg_b = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
    xc = apply_compression_flat(u, kind, param, *mats).to(dtype)
    sq_m, agg_m = ops.norm_scale_aggregate(xc, s)
    want_sq, want_agg = na.compress_norm_scale_aggregate_ref(u, s, mats, kind, param)
    torch.cuda.synchronize()
    assert _sq_close(sq, want_sq) and _agg_close(agg, want_agg, xc, s)
    assert torch.equal(sq, sq_b) and torch.equal(agg, agg_b)
    assert torch.equal(sq, sq_m) and torch.equal(agg, agg_m)   # fused == eager C(U) + fused


@pytest.mark.cuda
def test_norm_kernel_wrappers_reject(cuda):
    s = torch.zeros((4,), device=cuda)
    good = torch.zeros((4, 512), device=cuda)
    for bad in (
        torch.zeros((512, 4), device=cuda).t(),                   # not contiguous
        torch.zeros((4, 7), device=cuda),                         # D not a multiple of 4
        torch.zeros((4, 512), device=cuda, dtype=torch.float16),  # dtype
        torch.zeros((4 * 512 + 1,), device=cuda)[1:].view(4, 512),  # misaligned rows
    ):
        for call in (lambda: na.client_sqnorms_cuda(bad),
                     lambda: na.norm_scale_aggregate_cuda(bad, s),
                     lambda: na.compress_norm_scale_aggregate_cuda(bad, s, (good,), "randk", 0.1),
                     lambda: na.compress_norm_scale_aggregate_cuda(good, s, (bad,), "randk", 0.1)):
            with pytest.raises((ValueError, TypeError)):
                call()
    with pytest.raises(ValueError):
        na.norm_scale_aggregate_cuda(good, s.cpu())
    with pytest.raises(TypeError):
        na.norm_scale_aggregate_cuda(good, s.double())
    with pytest.raises(ValueError):
        na.compress_norm_scale_aggregate_cuda(good, s, (good,), "qsgd", 8.0)   # arity


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (1, 7, 4097, 58430))
@pytest.mark.parametrize("c", (1, 3, 8, 32, 33, 128, 129, 200))
def test_sharded_aggregate_kernel_matches_plain_and_contracts(cuda, c, d, dtype):
    u, s = _inputs(c, d, c * 65537 + d, dtype, cuda)
    before = (sa.sharded_masked_aggregate_cuda.launches,
              sa.sharded_compress_aggregate_cuda.launches)
    got, again = ops.shard_masked_aggregate(u, s), ops.shard_masked_aggregate(u, s)
    sq_none, agg_none = ops.shard_compress_aggregate(u, s, (), "none", 0.0)
    want = sa.sharded_masked_aggregate_ref(u, s)
    torch.cuda.synchronize()
    assert (sa.sharded_masked_aggregate_cuda.launches,
            sa.sharded_compress_aggregate_cuda.launches) == (before[0] + 2, before[1] + 1)
    assert got.shape == (d,) and got.dtype == torch.float32
    assert _agg_close(got, want, u, s)
    assert torch.equal(got, again)                       # fixed summation order
    assert torch.equal(agg_none, got)                    # kind='none' == the sharded aggregate
    assert torch.equal(sq_none, ops.client_sqnorms(u))   # its norms == client_sqnorms
    if c <= sa.BLOCK_CLIENTS:
        assert torch.equal(got, ops.masked_scale_aggregate(u, s))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("c,d", ((1, 7), (8, 58430), (32, 58430), (200, 1000)))
@pytest.mark.parametrize("kind,param", COMPRESSORS)
def test_sharded_compress_kernel_matches_plain_and_compress_kernel(cuda, kind, param, c, d,
                                                                   dtype):
    u, s = _inputs(c, d, c * 17 + d, dtype, cuda)
    u[0, :4] = torch.tensor([2.0 ** -126, 1e-40, 0.5, -0.25], device=cuda).to(dtype)
    keys = rng.split(rng.PRNGKey(c * d, device=cuda), c)
    mats = tuple(m["u"] for m in client_material({"u": u}, keys, kind, param))
    sq, agg = ops.shard_compress_aggregate(u, s, mats, kind, param)
    sq_b, agg_b = ops.shard_compress_aggregate(u, s, mats, kind, param)
    sq4, agg4 = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
    xc = apply_compression_flat(u, kind, param, *mats).to(dtype)
    want_sq, want_agg = sa.sharded_compress_aggregate_ref(u, s, mats, kind, param)
    torch.cuda.synchronize()
    assert _sq_close(sq, want_sq) and _agg_close(agg, want_agg, xc, s)
    assert torch.equal(sq, sq_b) and torch.equal(agg, agg_b)
    assert torch.equal(sq, sq4)                  # norms == the compress kernel's, every k
    if c <= sa.BLOCK_CLIENTS:
        assert torch.equal(agg, agg4)


@pytest.mark.cuda
def test_sharded_kernel_wrappers_reject(cuda):
    s = torch.zeros((4,), device=cuda)
    good = torch.zeros((4, 512), device=cuda)
    for bad in (
        torch.zeros((512, 4), device=cuda).t(),                   # not contiguous
        torch.zeros((4, 7), device=cuda),                         # D not a multiple of 4
        torch.zeros((4, 512), device=cuda, dtype=torch.float16),  # dtype
        torch.zeros((4 * 512 + 1,), device=cuda)[1:].view(4, 512),  # misaligned rows
    ):
        for call in (lambda: sa.sharded_masked_aggregate_cuda(bad, s),
                     lambda: sa.sharded_compress_aggregate_cuda(bad, s, (good,), "randk", 0.1),
                     lambda: sa.sharded_compress_aggregate_cuda(good, s, (bad,), "randk", 0.1)):
            with pytest.raises((ValueError, TypeError)):
                call()
    with pytest.raises(ValueError):
        sa.sharded_masked_aggregate_cuda(good, s.cpu())
    with pytest.raises(ValueError):
        sa.sharded_compress_aggregate_cuda(good, s, (good,), "qsgd", 8.0)   # arity
