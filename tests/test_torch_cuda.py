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

Flash attention (kernel 7) against its plain version, elementwise
``|err| <= atol + rtol |want|``: f32 inputs N(0, 1) at atol 3e-5 (the
reference's bound); bf16 inputs N(0, 1/4) at atol 1e-5 + rtol 1e-2 (both
accumulate in f32 and round the output once to bf16, so they differ by at
most one bf16 unit in the last place, <= 2^-7 |want|), on contiguous rows
and on strided (B, S, H, d) views, which are bitwise the copied rows.  The
SSD scan (kernel 8) against the sequential recurrence: atol 1e-4 + rtol
1e-4 (the two reassociate sums of up to Q * N f32 products).  The models'
kernel routes (``chunked_attention``, ``ssd_chunked``) against their eager
forms on the card, and the reduced hybrid's prefill on the card against the
CPU's (f32, TF32 off) at atol 1e-4.
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
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss

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


def _attn_close(got, want, dtype) -> bool:
    atol, rtol = (3e-5, 0.0) if dtype == torch.float32 else (1e-5, 1e-2)
    want = want.float()
    return bool(((got.float() - want).abs() <= atol + rtol * want.abs()).all())


def _qkv(shape, seed, dtype, device):
    r = np.random.default_rng(seed)
    scale = 1.0 if dtype == torch.float32 else 0.5
    return [torch.from_numpy((r.normal(size=shape) * scale).astype(np.float32)).to(device, dtype)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("window,prefix", ((None, 0), (48, 0), (None, 40), (30, 100)))
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", (1, 7, 128, 257, 1000))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_flash_attention_kernel_matches_plain(cuda, dtype, s, d, window, prefix):
    q, k, v = _qkv((3, s, d), s * 1000 + d, dtype, cuda)
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, window=window, prefix=prefix)
    again = ops.flash_attention(q, k, v, window=window, prefix=prefix)
    want = fa.flash_attention_ref(q, k, v, window=window, prefix=prefix)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 2
    assert got.shape == q.shape and got.dtype == dtype
    assert _attn_close(got, want, dtype)
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_flash_attention_wrapper_rejects(cuda):
    good = torch.zeros((2, 16, 64), device=cuda)
    for bad in (
        torch.zeros((2, 64, 16), device=cuda).transpose(1, 2),    # not contiguous
        torch.zeros((2, 16, 48), device=cuda),                    # head dim not instantiated
        torch.zeros((2, 16, 64), device=cuda, dtype=torch.float16),
        torch.zeros((2, 17, 64), device=cuda),                    # shapes disagree
        torch.zeros((2, 16, 128), device=cuda)[..., ::2],         # head-dim stride 2
        torch.zeros((2, 16, 66), device=cuda)[..., :64],          # sequence stride 66
        torch.zeros((2 * 16 * 64 + 1,), device=cuda)[1:].view(2, 16, 64),   # misaligned
    ):
        with pytest.raises((ValueError, TypeError)):
            fa.flash_attention_cuda(bad, good, good)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(good, good, good, window=0)
    with pytest.raises(ValueError):
        fa.flash_attention_cuda(good, good.cpu(), good)


def _strided_qkv(b, s, h, d, seed, dtype, device):
    """q, k, v as non-contiguous (B, S, H, d) views of one (B, S, 3, H, d)
    buffer, as a fused projection would give them."""
    r = np.random.default_rng(seed)
    scale = 1.0 if dtype == torch.float32 else 0.5
    buf = torch.from_numpy((r.normal(size=(b, s, 3, h, d)) * scale).astype(np.float32))
    buf = buf.to(device, dtype)
    return buf[:, :, 0], buf[:, :, 1], buf[:, :, 2]


def _rows(t):
    b, s, h, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b * h, s, d)


@pytest.mark.cuda
@pytest.mark.parametrize("window,prefix", ((None, 0), (48, 0), (None, 40), (30, 100)))
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("s", (7, 257, 1000))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_flash_attention_strided_views_match_plain_and_copied_rows(cuda, dtype, s, d, window,
                                                                   prefix):
    q, k, v = _strided_qkv(2, s, 3, d, s + d, dtype, cuda)
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(q, k, v, window=window, prefix=prefix)
    rows = ops.flash_attention(_rows(q), _rows(k), _rows(v), window=window, prefix=prefix)
    want = fa.flash_attention_ref(_rows(q), _rows(k), _rows(v), window=window, prefix=prefix)
    torch.cuda.synchronize()
    assert fa.flash_attention_cuda.launches == before + 2
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    assert _attn_close(_rows(got), want, dtype)
    assert torch.equal(_rows(got), rows)      # the strides change no bit


@pytest.mark.cuda
def test_flash_attention_heads_on_views_is_bitwise_the_copied_rows(cuda):
    from repro_torch.models import layers

    q, k, v = _strided_qkv(2, 2048, 8, 80, 5, torch.bfloat16, cuda)
    got = layers.flash_attention_heads(q, k, v)
    want = ops.flash_attention(_rows(q).contiguous(), _rows(k).contiguous(),
                               _rows(v).contiguous())
    torch.cuda.synchronize()
    assert torch.equal(_rows(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (4097, 58430))
@pytest.mark.parametrize("c", (33, 200, 1000))     # beyond one client block of 32
def test_masked_scale_aggregate_beyond_a_client_block_is_kernel_3s(cuda, c, d, dtype):
    u, s = _inputs(c, d, c + d, dtype, cuda)
    agg1 = ops.masked_scale_aggregate(u, s)
    _, agg3 = ops.norm_scale_aggregate(u, s)
    torch.cuda.synchronize()
    assert _agg_close(agg1, ma.masked_scale_aggregate_ref(u, s), u, s)
    assert torch.equal(agg1, agg3)


def _ssd(bh, s, p, n, seed, dtype, device):
    r = np.random.default_rng(seed)
    x = torch.from_numpy((r.normal(size=(bh, s, p)) * 0.5).astype(np.float32)).to(device, dtype)
    b = torch.from_numpy((r.normal(size=(bh, s, n)) * 0.5).astype(np.float32)).to(device, dtype)
    c = torch.from_numpy((r.normal(size=(bh, s, n)) * 0.5).astype(np.float32)).to(device, dtype)
    dt = torch.from_numpy((np.logaddexp(r.normal(size=(bh, s)), 0) * 0.2).astype(np.float32))
    da = -dt * torch.exp(torch.from_numpy(r.normal(size=(bh, s)).astype(np.float32)) * 0.1)
    return x, b, c, dt.to(device), da.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("p,n", ((16, 8), (64, 64), (64, 128)))
@pytest.mark.parametrize("chunk", (16, 64, 128))
@pytest.mark.parametrize("s", (32, 100, 300))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_ssd_scan_kernel_matches_plain(cuda, dtype, s, chunk, p, n):
    x, b, c, dt, da = _ssd(3, s, p, n, s + chunk + p + n, dtype, cuda)
    before = ss.ssd_scan_cuda.launches
    y, st = ops.ssd_scan(x, b, c, dt, da, chunk=chunk)
    y2, st2 = ops.ssd_scan(x, b, c, dt, da, chunk=chunk)
    y_r, st_r = ss.ssd_scan_ref(x, b, c, dt, da)
    torch.cuda.synchronize()
    assert ss.ssd_scan_cuda.launches == before + 2
    for got, want in ((y, y_r), (st, st_r)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    assert torch.equal(y, y2) and torch.equal(st, st2)


@pytest.mark.cuda
def test_ssd_scan_wrapper_rejects(cuda):
    x, b, c, dt, da = _ssd(2, 32, 16, 8, 0, torch.float32, cuda)
    for args in (
        (x, b, c, dt, da, 12),                        # S not a chunk multiple
        (x, b, c, dt.to(torch.bfloat16), da, 16),     # dt dtype
        (x.to(torch.bfloat16), b, c, dt, da, 16),     # x, b, c dtypes differ
        (x[:, :, :14].contiguous(), b, c, dt, da, 16),   # P not a multiple of 4
        (x.transpose(0, 1).contiguous().transpose(0, 1), b, c, dt, da, 16),   # strides
        (x, b.cpu(), c, dt, da, 16),
    ):
        with pytest.raises((ValueError, TypeError)):
            ss.ssd_scan_cuda(*args[:5], chunk=args[5])
    big = torch.zeros((1, 128, 128), device=cuda)
    big_bc = torch.zeros((1, 128, 128), device=cuda)
    z = torch.zeros((1, 128), device=cuda)
    with pytest.raises(ValueError):                   # shared memory beyond 227 KB
        ss.ssd_scan_cuda(big, big_bc, big_bc, z, z, chunk=128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_model_kernel_routes_match_their_eager_forms(cuda, dtype):
    from repro_torch.models import layers, ssm

    q, k, v = _qkv((2, 600, 4, 80), 1, dtype, cuda)
    got = layers.chunked_attention(q, k, v, window=200)
    want = layers.chunked_attention_eager(q, k, v, window=200)
    assert got.dtype == dtype and _attn_close(got, want, dtype)
    r = np.random.default_rng(2)
    bsz, seq, h, p, n = 2, 384, 6, 64, 64
    xs = torch.from_numpy((r.normal(size=(bsz, seq, h, p)) * 0.5).astype(np.float32))
    bm, cm = (torch.from_numpy((r.normal(size=(bsz, seq, n)) * 0.5).astype(np.float32))
              for _ in range(2))
    dt = torch.from_numpy((np.logaddexp(r.normal(size=(bsz, seq, h)), 0) * 0.2
                           ).astype(np.float32)).to(cuda)
    xs, bm, cm = (t.to(cuda, dtype) for t in (xs, bm, cm))
    y, st = ssm.ssd_chunked(xs, bm, cm, dt, -dt, 128)
    y_e, st_e = ssm.ssd_chunked_eager(xs, bm, cm, dt, -dt, 128)
    for got, want in ((y, y_e), (st, st_e)):
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())


@pytest.mark.cuda
def test_reduced_hybrid_prefill_on_the_card_equals_the_cpu(cuda):
    from repro_torch.configs import get
    from repro_torch.kernels.ops import tree_map
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get("zamba2-2.7b-reduced")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 2100)))
    with torch.inference_mode():
        want, _ = model.prefill(params, {"tokens": toks}, 2108)
        before = (fa.flash_attention_cuda.launches, ss.ssd_scan_cuda.launches)
        got, _ = model.prefill(tree_map(lambda t: t.to(cuda), params),
                               {"tokens": toks.to(cuda)}, 2108)
    assert (fa.flash_attention_cuda.launches - before[0],
            ss.ssd_scan_cuda.launches - before[1]) == (1, 5)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
