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
fused pair, ``client_sqnorms`` and the sharded compress kernel take the
unpadded matrix at any D and start address, in one device launch per call,
bitwise what they give on the zero-padded matrix, and their ticket counters
are back at 0 after each launch (ten calls in a row, and a call on a second
stream, give the first call's result).  The
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
1e-4 (the two reassociate sums of up to Q * N f32 products); on the
model's strided (B, S, H, P) and (B, S, G, N) views at G = 1 and G = H
against the eager chunked core, bitwise the per-row route on materialized
per-head copies and bitwise run to run; its bf16 passes carry tensor-core
instructions (HMMA) in their SASS.  The models'
kernel routes (``chunked_attention``, ``ssd_chunked``) against their eager
forms on the card, and the reduced hybrid's prefill on the card against the
CPU's (f32, TF32 off) at atol 1e-4.  The gradient of ``Model.loss`` of both
reduced families on the card (``loss.backward()`` and ``torch.func.grad``)
against the CPU's within atol 1e-4 of its largest entry, with no kernel
launched while autograd records (the kernels have no backward).  The
``--arch`` loop (``launch/train.py``) on the card: round 0's masks bitwise
across vmap + jnp, vmap + pallas (kernel 1) and scan + pallas (kernel 3),
its norms bitwise across the vmap runs (the scan engine's within 1e-5) and
every round run to run; the reduced decoder rounds equal to the CPU's with no kernel
launched in the gradient passes; the decoder family's and whisper's
prefill (kernel 7 once a decoder layer, with a prefix or a window) equal to
the CPU's within 1e-4 in f32, and its greedy tokens.
"""

import json
import subprocess
import sys
from pathlib import Path

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
        torch.zeros((4, 512), device=cuda, dtype=torch.float16),  # dtype
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
def test_norm_and_shard_kernels_take_what_they_rejected(cuda, dtype):
    """D % 4 != 0 and rows one element off an aligned start, which kernels 2
    and 6 rejected while their ops wrappers padded: both now take them and
    give bitwise what they give on the zero-padded aligned matrix (kernel 6
    also its aggregate); kernel 5 still rejects both."""
    u7, s = _inputs(4, 7, 11, dtype, cuda)
    u512, _ = _inputs(4, 512, 12, dtype, cuda)
    for u in (u7, _at_offset(u512, 1)):
        d = u.shape[1]
        padded = torch.nn.functional.pad(u, (0, (-d) % ma.TILE)).contiguous()
        mats = (torch.rand(u.shape, device=cuda),)
        mats_p = tuple(torch.nn.functional.pad(m, (0, (-d) % ma.TILE)) for m in mats)
        assert torch.equal(na.client_sqnorms_cuda(u), na.client_sqnorms_cuda(padded))
        sq6, agg6 = sa.sharded_compress_aggregate_cuda(u, s, mats, "randk", 0.1)
        sq6p, agg6p = sa.sharded_compress_aggregate_cuda(padded, s, mats_p, "randk", 0.1)
        assert torch.equal(sq6, sq6p) and torch.equal(agg6, agg6p[:d])
        for call in (lambda: sa.sharded_masked_aggregate_cuda(u, s),
                     lambda: ma.masked_scale_aggregate_cuda(u, s)):
            with pytest.raises(ValueError):
                call()


def _at_offset(x, offset):
    """``x`` copied into a contiguous buffer that starts ``offset`` elements
    past an allocation's (aligned) start."""
    buf = torch.empty((x.numel() + offset,), dtype=x.dtype, device=x.device)
    out = buf[offset:].view(x.shape)
    out.copy_(x)
    return out


@pytest.fixture(scope="module")
def norm_profile():
    """chip_smoke.py's profiler pass of the fused norm kernels, in a process
    of its own: a profiler window late in a process (as in this one, after
    many tests) can lose device events on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, str(root / "chip_smoke.py"), "--profile", "norm"],
                         capture_output=True, text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("fused", "client_sqnorms", "shard_compress_aggregate"))
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (4096, 4097, 4098, 4099, 58430, 513, 3))
@pytest.mark.parametrize("c", (4, 32))
def test_fused_norm_kernels_take_any_width(cuda, c, d, dtype, offset, kernel):
    """The one-launch kernels on the unpadded matrix, D mod 4 in {0, 1, 2,
    3}, at a start address one element past an aligned one.  Kernels 3 and
    4 ("fused"): bitwise kernel 2's norms and kernel 1's aggregate (kernel 1
    on the padded matrix), kernel 6's norms and aggregate (k <= 128), and
    eager C(U) then kernel 3.  Kernel 2: bitwise itself on the zero-padded
    aligned matrix and kernel 3's norms.  Kernel 6: bitwise itself on the
    zero-padded aligned matrices, kernel 4's norms and aggregate, and kernel
    5's aggregate (padded) for kind 'none'."""
    u, s = _inputs(c, d, c * 1009 + d + offset, dtype, cuda)
    u[0, :4] = torch.tensor([2.0 ** -126, 1e-40, 0.5, -0.25], device=cuda)[:d].to(dtype)
    ua = u                       # aligned, for the kernels that pad or need it
    u = _at_offset(u, offset)
    pad = (-d) % ma.TILE
    sq3, agg3 = ops.norm_scale_aggregate(u, s)
    torch.cuda.synchronize()
    if kernel == "client_sqnorms":
        sq2 = ops.client_sqnorms(u)
        sq2p = na.client_sqnorms_cuda(torch.nn.functional.pad(ua, (0, pad)).contiguous())
        torch.cuda.synchronize()
        assert _sq_close(sq2, na.client_sqnorms_ref(u))
        assert torch.equal(sq2, sq2p) and torch.equal(sq2, sq3)
        return
    if kernel == "shard_compress_aggregate":
        sq6n, agg6n = ops.shard_compress_aggregate(u, s, (), "none", 0.0)
        assert torch.equal(sq6n, sq3) and torch.equal(agg6n, agg3)
        assert torch.equal(agg6n, ops.shard_masked_aggregate(ua, s))
        for kind, param in COMPRESSORS:
            keys = rng.split(rng.PRNGKey(c * 3 + d, device=cuda), c)
            mats_a = tuple(m["u"].contiguous()
                           for m in client_material({"u": ua}, keys, kind, param))
            mats = tuple(_at_offset(m, offset) for m in mats_a)
            sq6, agg6 = ops.shard_compress_aggregate(u, s, mats, kind, param)
            sq6p, agg6p = sa.sharded_compress_aggregate_cuda(
                torch.nn.functional.pad(ua, (0, pad)).contiguous(), s,
                tuple(torch.nn.functional.pad(m, (0, pad)) for m in mats_a), kind, param)
            sq4, agg4 = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
            want_sq, want_agg = sa.sharded_compress_aggregate_ref(u, s, mats, kind, param)
            xc = apply_compression_flat(u, kind, param, *mats).to(dtype)
            torch.cuda.synchronize()
            assert _sq_close(sq6, want_sq) and _agg_close(agg6, want_agg, xc, s)
            assert torch.equal(sq6, sq6p) and torch.equal(agg6, agg6p[:d])
            assert torch.equal(sq6, sq4) and torch.equal(agg6, agg4)
        return
    sq4n, agg4n = ops.compress_norm_scale_aggregate(u, s, (), "none", 0.0)
    torch.cuda.synchronize()
    assert _sq_close(sq3, na.client_sqnorms_ref(u))
    assert _agg_close(agg3, ma.masked_scale_aggregate_ref(u, s), u, s)
    assert torch.equal(sq3, ops.client_sqnorms(ua))
    assert torch.equal(agg3, ops.masked_scale_aggregate(ua, s))
    assert torch.equal(sq4n, sq3) and torch.equal(agg4n, agg3)
    for kind, param in COMPRESSORS:
        keys = rng.split(rng.PRNGKey(c * 3 + d, device=cuda), c)
        mats_a = tuple(m["u"].contiguous()
                       for m in client_material({"u": ua}, keys, kind, param))
        mats = tuple(_at_offset(m, offset) for m in mats_a)
        sq4, agg4 = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
        xc = apply_compression_flat(u, kind, param, *mats).to(dtype)
        sq_m, agg_m = ops.norm_scale_aggregate(xc, s)
        sq6, agg6 = ops.shard_compress_aggregate(ua, s, mats_a, kind, param)
        want_sq, want_agg = na.compress_norm_scale_aggregate_ref(u, s, mats, kind, param)
        torch.cuda.synchronize()
        assert _sq_close(sq4, want_sq) and _agg_close(agg4, want_agg, xc, s)
        assert torch.equal(sq4, sq_m) and torch.equal(agg4, agg_m)
        assert torch.equal(sq4, sq6) and torch.equal(agg4, agg6)
        assert torch.equal(sq_m, ops.client_sqnorms(xc))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("none", "randk", "qsgd", "natural"))
def test_fused_norm_kernels_launch_once_per_call(norm_profile, kind, dtype):
    """One device kernel in a profiler window around one ops call, and one
    count on the wrapper's launch counter: kernels 3 and 4, kernel 2, and
    kernel 6 (rand-k also beyond one client block, at 129 and 1,024)."""
    names = {f"ops.compress_norm_scale_aggregate {kind} {dtype} (32, 58430)": "fused_kernel",
             f"ops.shard_compress_aggregate {kind} {dtype} (32, 58430)": "shard_compress_kernel"}
    if kind == "none":
        names[f"ops.norm_scale_aggregate {kind} {dtype} (32, 58430)"] = "fused_kernel"
        names[f"ops.client_sqnorms {dtype} (32, 58430)"] = "sqnorms_kernel"
    if kind == "randk" and dtype == "float32":
        for k in (129, 1024):
            names[f"ops.shard_compress_aggregate {kind} {dtype} ({k}, 58430)"] = (
                "shard_compress_kernel")
    for name, kernel in names.items():
        assert len(norm_profile["launches"][name]) == 1, norm_profile["launches"][name]
        assert kernel in norm_profile["launches"][name][0]
        assert norm_profile["counted"][name] == 1


def _all_zero(dev, stream) -> bool:
    return not bool(na._counters(dev, stream).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("fused", "client_sqnorms", "shard_compress_aggregate"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_fused_norm_kernels_reset_their_ticket(cuda, dtype, kernel):
    """Ten calls in a row, no sync between them: each equals the first, so
    each launch finds its counters at 0 and leaves them there (kernel 6 at
    one client block and at several)."""
    u, s = _inputs(32, 58430, 6, dtype, cuda)
    keys = rng.split(rng.PRNGKey(6, device=cuda), 32)
    mats = tuple(m["u"] for m in client_material({"u": u}, keys, "randk", 0.1))
    if kernel == "fused":
        series = [[ops.norm_scale_aggregate(u, s) for _ in range(10)],
                  [ops.compress_norm_scale_aggregate(u, s, mats, "randk", 0.1)
                   for _ in range(10)]]
    elif kernel == "client_sqnorms":
        series = [[(ops.client_sqnorms(u), s) for _ in range(10)]]
    else:
        ub, sb = _inputs(300, 4099, 8, dtype, cuda)
        mb = (torch.rand(ub.shape, device=cuda),)
        series = [[ops.shard_compress_aggregate(u, s, mats, "randk", 0.1) for _ in range(10)],
                  [ops.shard_compress_aggregate(ub, sb, mb, "randk", 0.1) for _ in range(10)]]
    torch.cuda.synchronize()
    for runs in series:
        for sq, agg in runs[1:]:
            assert torch.equal(sq, runs[0][0]) and torch.equal(agg, runs[0][1])
    assert _all_zero(u.device, torch.cuda.current_stream(cuda).cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("fused", "client_sqnorms", "shard_compress_aggregate"))
def test_fused_norm_kernels_on_a_second_stream(cuda, kernel):
    """A call on another stream takes counters of its own (the docstring's
    contract) and gives the same result as on the current stream."""
    u, s = _inputs(4, 58430, 7, torch.float32, cuda)
    keys = rng.split(rng.PRNGKey(7, device=cuda), 4)
    mats = tuple(m["u"] for m in client_material({"u": u}, keys, "qsgd", 8.0))
    ub, sb = _inputs(200, 4097, 9, torch.float32, cuda)
    calls = {
        "fused": (lambda: ops.norm_scale_aggregate(u, s),
                  lambda: ops.compress_norm_scale_aggregate(u, s, mats, "qsgd", 8.0)),
        "client_sqnorms": (lambda: (ops.client_sqnorms(u), s),
                           lambda: (ops.client_sqnorms(ub), sb)),
        "shard_compress_aggregate": (
            lambda: ops.shard_compress_aggregate(u, s, mats, "qsgd", 8.0),
            lambda: ops.shard_compress_aggregate(ub, sb, (), "none", 0.0)),
    }[kernel]
    want = [call() for call in calls]
    side = torch.cuda.Stream(device=u.device)
    side.wait_stream(torch.cuda.current_stream(u.device))
    with torch.cuda.stream(side):
        got = [call() for call in calls]
    torch.cuda.synchronize()
    main = torch.cuda.current_stream(u.device).cuda_stream
    assert na._counters(u.device, side.cuda_stream) is not na._counters(u.device, main)
    assert _all_zero(u.device, side.cuda_stream) and _all_zero(u.device, main)
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (4099, 58430))
@pytest.mark.parametrize("k", (129, 200, 1024))
def test_shard_compress_beyond_one_client_block(cuda, k, d, dtype):
    """Kernel 6 at k > 128 (several client blocks, the blocks' partials
    added in the launch): one launch per call; for kind 'none' the aggregate
    is bitwise kernel 5's; the norms are bitwise kernel 4's at every kind;
    ten calls in a row equal the first, and the counters are back at 0."""
    u, s = _inputs(k, d, k * 7 + d, dtype, cuda)
    before = sa.sharded_compress_aggregate_cuda.launches
    sq6n, agg6n = ops.shard_compress_aggregate(u, s, (), "none", 0.0)
    assert sa.sharded_compress_aggregate_cuda.launches == before + 1
    assert torch.equal(agg6n, ops.shard_masked_aggregate(u, s))
    assert torch.equal(sq6n, ops.norm_scale_aggregate(u, s)[0])
    for kind, param in COMPRESSORS:
        keys = rng.split(rng.PRNGKey(k + d, device=cuda), k)
        mats = tuple(m["u"].contiguous() for m in client_material({"u": u}, keys, kind, param))
        runs = [ops.shard_compress_aggregate(u, s, mats, kind, param) for _ in range(10)]
        sq4, _ = ops.compress_norm_scale_aggregate(u, s, mats, kind, param)
        want_sq, want_agg = sa.sharded_compress_aggregate_ref(u, s, mats, kind, param)
        xc = apply_compression_flat(u, kind, param, *mats).to(dtype)
        torch.cuda.synchronize()
        sq6, agg6 = runs[0]
        assert _sq_close(sq6, want_sq) and _agg_close(agg6, want_agg, xc, s)
        assert torch.equal(sq6, sq4)
        for sq, agg in runs[1:]:
            assert torch.equal(sq, sq6) and torch.equal(agg, agg6)
    assert _all_zero(u.device, torch.cuda.current_stream(cuda).cuda_stream)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("d", (1, 7, 4097, 58430))
@pytest.mark.parametrize("c", (1, 3, 4, 8, 32, 33, 128, 129, 200))
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
        torch.zeros((4, 512), device=cuda, dtype=torch.float16),  # dtype
    ):
        for call in (lambda: sa.sharded_masked_aggregate_cuda(bad, s),
                     lambda: sa.sharded_compress_aggregate_cuda(bad, s, (good,), "randk", 0.1),
                     lambda: sa.sharded_compress_aggregate_cuda(good, s, (bad,), "randk", 0.1)):
            with pytest.raises((ValueError, TypeError)):
                call()
    # kernel 5 keeps its padded contract; kernel 6 takes these
    # (test_norm_and_shard_kernels_take_what_they_rejected)
    for bad in (
        torch.zeros((4, 7), device=cuda),                         # D not a multiple of 4
        torch.zeros((4 * 512 + 1,), device=cuda)[1:].view(4, 512),  # misaligned rows
    ):
        with pytest.raises(ValueError):
            sa.sharded_masked_aggregate_cuda(bad, s)
    for call in (lambda: sa.sharded_masked_aggregate_cuda(good, s.cpu()),
                 lambda: sa.sharded_compress_aggregate_cuda(good, s.cpu(), (good,), "randk", 0.1),
                 lambda: sa.sharded_compress_aggregate_cuda(good, s, (good,), "qsgd", 8.0)):
        with pytest.raises(ValueError):                                      # CPU scale, arity
            call()


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


def _ssd_views(bsz, s, h, p, n, g, seed, dtype, device):
    """x (B,S,H,P) and B, C (B,S,G,N) as strided views of one projection
    buffer, as apply_mamba2 cuts them; dt, da (B,S,H) f32."""
    r = np.random.default_rng(seed)
    buf = torch.from_numpy((r.normal(size=(bsz, s, h * p + 2 * g * n)) * 0.5).astype(np.float32))
    buf = buf.to(device, dtype)
    xs = buf[..., :h * p].reshape(bsz, s, h, p)
    bm = buf[..., h * p:h * p + g * n].reshape(bsz, s, g, n)
    cm = buf[..., h * p + g * n:].reshape(bsz, s, g, n)
    dt = torch.from_numpy((np.logaddexp(r.normal(size=(bsz, s, h)), 0) * 0.2).astype(np.float32))
    da = -dt * torch.from_numpy(np.exp(r.normal(size=(bsz, s, h)) * 0.1).astype(np.float32))
    return xs, bm, cm, dt.to(device), da.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ((2, 384, 6, 64, 64, 128), (2, 256, 10, 64, 128, 128),
                                   (3, 96, 5, 32, 16, 16), (1, 300, 2, 16, 8, 64)))
@pytest.mark.parametrize("g", ("one", "heads"))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
def test_ssd_scan_heads_on_views_matches_eager_and_rows(cuda, dtype, g, shape):
    bsz, s, h, p, n, chunk = shape
    s -= s % chunk
    groups = 1 if g == "one" else h
    xs, bm, cm, dt, da = _ssd_views(bsz, s, h, p, n, groups, s + h + groups, dtype, cuda)
    before = ss.ssd_scan_cuda.launches
    y, st = ops.ssd_scan_heads(xs, bm, cm, dt, da, chunk=chunk)
    y2, st2 = ops.ssd_scan_heads(xs, bm, cm, dt, da, chunk=chunk)
    if groups == 1:
        from repro_torch.models import ssm

        y_e, st_e = ssm.ssd_chunked_eager(xs, bm[:, :, 0], cm[:, :, 0], dt, da, chunk)
    else:
        y_e, st_e = ss.ssd_scan_heads_ref(xs, bm, cm, dt, da)

    def rows(t):          # materialized per-head copies (the per-row entry's contract)
        return t.expand(bsz, s, h, t.shape[-1]).permute(0, 2, 1, 3).reshape(bsz * h, s, -1
                                                                             ).contiguous()

    def per_head(t):
        return t.permute(0, 2, 1).reshape(bsz * h, s).contiguous()

    y_r, st_r = ss.ssd_scan_cuda(rows(xs), rows(bm), rows(cm), per_head(dt), per_head(da),
                                 chunk=chunk)
    torch.cuda.synchronize()
    assert ss.ssd_scan_cuda.launches == before + 3
    assert y.shape == (bsz, s, h, p) and st.shape == (bsz, h, p, n)
    for got, want in ((y, y_e), (st, st_e)):
        assert got.dtype == torch.float32
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    assert torch.equal(y, y2) and torch.equal(st, st2)                  # run to run
    assert torch.equal(rows(y), y_r) and torch.equal(st.reshape(bsz * h, p, n), st_r)


@pytest.mark.cuda
def test_ssd_scan_heads_wrapper_rejects_before_a_launch(cuda):
    xs, bm, cm, dt, da = _ssd_views(2, 64, 4, 16, 8, 1, 0, torch.bfloat16, cuda)
    before = ss.ssd_scan_cuda.launches
    for args, chunk in (
        ((xs, bm, cm, dt, da), 48),                                   # S not a chunk multiple
        ((xs, bm[..., ::2].expand(2, 64, 1, 4), cm[..., :4], dt, da), 16),   # N, last stride
        ((xs, bm, cm.cpu(), dt, da), 16),                             # devices
        ((xs.float(), bm, cm, dt, da), 16),                           # dtypes
        ((torch.zeros((2, 64, 4, 128), device=cuda, dtype=torch.bfloat16), bm, cm, dt, da),
         16),                                                         # bf16 P > 64
    ):
        with pytest.raises((ValueError, TypeError)):
            ss.ssd_scan_heads_cuda(*args, chunk=chunk)
    assert ss.ssd_scan_cuda.launches == before


@pytest.mark.cuda
def test_ssd_scan_bf16_passes_run_on_the_tensor_cores(cuda):
    import re
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import _build

    _build.load("ssd_scan")
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path("ssd_scan"))],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts = {}
    for fn in sass.split("Function : ")[1:]:
        found = re.search(r"(ssd_chunk_\w+?_bf16)", fn.split("\n", 1)[0])
        if found:
            counts[found.group(1)] = fn.count("HMMA") + fn.count("HGMMA")
    assert sorted(counts) == ["ssd_chunk_out_bf16", "ssd_chunk_state_bf16"]
    assert all(counts.values()), counts


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


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("femnist1-fedavg-aocs", "charlm-fedavg-aocs"))
def test_prefetch_gather_on_the_card_is_the_host_batch(cuda, name):
    # the pool's side-stream gather of a plan, claimed on the current
    # stream, bitwise the numpy batch of the same generator state; ten
    # rounds through the two pinned staging slots, the last through the
    # sharded pool of a world-size-1 NCCL mesh (gather + reduce-scatter)
    from repro_torch.fl.mesh import local_client_mesh
    from repro_torch.sim import pool
    from repro_torch.sim.scenarios import get_scenario

    ds = get_scenario(name).build_dataset()
    cpool = pool.ClientPool(ds, device=cuda)
    mesh = local_client_mesh(cuda)
    try:
        spool = pool.ClientPool(ds, mesh=mesh)
        r_host, r_pool = np.random.default_rng(5), np.random.default_rng(5)
        pending = []
        for k in range(10):
            clients = r_pool.choice(ds.n_clients, size=32, replace=False)
            host_clients = r_host.choice(ds.n_clients, size=32, replace=False)
            use = spool if k == 9 else cpool
            pending.append((use.gather(use.plan(r_pool, clients, 6, 8)),
                            ds.sample_round_batches(r_host, host_clients, 6, 8)))
        for (batch, ready), host in pending:
            got = pool.claim_batch(batch, ready)
            for k in host:
                assert got[k].device.type == "cuda"
                np.testing.assert_array_equal(got[k].cpu().numpy(), host[k])
        assert r_host.integers(1 << 30) == r_pool.integers(1 << 30)
        assert spool.nbytes == cpool.nbytes
    finally:
        mesh.close()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ("femnist1-fedavg-aocs-scan", "charlm-fedavg-aocs"))
def test_scan_mode_on_the_card_is_bitwise_host(cuda, name):
    # the scan mode's rounds are CUDA-graph replays after an eager first
    # round: masks, ledger series and parameters bitwise the host loop's,
    # with a remainder block, and bitwise a second scan run
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.sim.driver import run_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    host = run_scenario(name, reduced=True, rounds=5, mode="host")
    scans = [run_scenario(name, reduced=True, rounds=5, mode="scan", rounds_per_scan=2)
             for _ in range(2)]
    for p, led in scans:
        assert led.workload["rounds_per_scan"] == 2 and led.workload["backend_platform"] == "cuda"
        for series in ("loss", "alpha", "gamma", "sent", "uplink_bits"):
            assert getattr(led, series) == getattr(host[1], series), series
        assert all(bool((a == b).all()) for a, b in zip(led.masks, host[1].masks))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(host[0])))


@pytest.mark.cuda
def test_charlm_on_the_card_is_bitwise_across_runs_and_modes(cuda):
    from repro_torch.kernels.ops import tree_leaves
    from repro_torch.sim.driver import run_scenario

    torch.backends.cuda.matmul.allow_tf32 = False
    runs = [run_scenario("charlm-fedavg-aocs", rounds=3, mode=mode)
            for mode in ("prefetch", "prefetch", "host")]
    (p0, l0) = runs[0]
    assert l0.workload["model_dim"] == 60630
    for p, led in runs[1:]:
        assert led.loss == l0.loss and led.sent == l0.sent
        assert all(bool((a == b).all()) for a, b in zip(led.masks, l0.masks))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p), tree_leaves(p0)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,bsz,seq", (("mamba2-130m-reduced", 2, 256),
                                          ("zamba2-2.7b-reduced", 1, 2100),
                                          ("whisper-small-reduced", 1, 2100)))
def test_model_loss_gradient_on_the_card_equals_the_cpu(cuda, arch, bsz, seq):
    # the kernels have no backward: a gradient on the card takes the eager
    # forms (no kernel launch) and equals the CPU's within the forward
    # tolerance, atol 1e-4, relative to the gradient's largest entry; with
    # no gradient recorded the same forward launches the kernels again
    # (whisper's layers are rematerialised in both gradients: kernel 7 in
    # neither the forward nor the backward's recompute)
    from repro_torch.configs import get
    from repro_torch.kernels.ops import tree_leaves, tree_map
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab_size, (bsz, seq + 1)))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.encoder_seq:
        batch["frames"] = torch.from_numpy((np.random.default_rng(1).normal(
            size=(bsz, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32))
    want = tree_leaves(torch.func.grad(lambda p: model.loss(p, batch)[0])(params))
    scale = max(float(w.abs().max()) for w in want)
    g_params = tree_map(lambda t: t.to(cuda), params)
    g_batch = {k: v.to(cuda) for k, v in batch.items()}
    before = (fa.flash_attention_cuda.launches, ss.ssd_scan_cuda.launches)
    leaves = tree_map(lambda t: t.clone().requires_grad_(), g_params)
    model.loss(leaves, g_batch)[0].backward()
    grads = {"backward": [t.grad for t in tree_leaves(leaves)],
             "torch.func.grad": tree_leaves(torch.func.grad(
                 lambda p: model.loss(p, g_batch)[0])(g_params))}
    assert (fa.flash_attention_cuda.launches, ss.ssd_scan_cuda.launches) == before
    for route, got in grads.items():
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        assert err <= 1e-4 * scale, (route, err, scale)
    kernel = fa.flash_attention_cuda if cfg.encoder_layers else ss.ssd_scan_cuda
    with torch.no_grad():
        model.loss(g_params, g_batch)
    assert kernel.launches > before[kernel is ss.ssd_scan_cuda]


def _arch_rows(argv, init_fn=None):
    from repro_torch.launch import train

    return train.main(argv, init_fn=init_fn)[1]


@pytest.mark.cuda
def test_arch_rounds_on_the_card_agree_across_engines_and_backends(cuda):
    # chip_smoke.py's arch_phase at the reduced size: --arch on vmap + jnp,
    # vmap + pallas (kernel 1 once a round), scan + pallas (kernel 3 once a
    # group); masks bitwise across the three, norms bitwise across the vmap
    # runs and run to run; the scan engine's groups of 2 run the products at
    # other shapes, which the card rounds otherwise: its norms within 1e-5
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = ["--arch", "mamba2-130m-reduced", "--rounds", "2", "--seq", "16"]
    runs = {}
    for label, flags, kernel, per_round in (
            ("vmap+jnp", [], None, 0),
            ("vmap+pallas", ["--agg-backend", "pallas"], ma.masked_scale_aggregate_cuda, 1),
            ("scan+pallas", ["--engine", "scan", "--agg-backend", "pallas"],
             na.norm_scale_aggregate_cuda, 4),
            ("vmap+pallas again", ["--agg-backend", "pallas"], None, 0)):
        before = None if kernel is None else kernel.launches
        runs[label] = _arch_rows(base + flags)
        if kernel is not None:
            assert kernel.launches - before == 2 * per_round, label
    for label, rows in runs.items():
        r, w = rows[0], runs["vmap+jnp"][0]
        assert np.array_equal(r["mask"], w["mask"]), label
        if label == "scan+pallas":
            np.testing.assert_allclose(r["norms"], w["norms"], rtol=1e-5)
        else:
            assert np.array_equal(r["norms"], w["norms"]), label
    for r, w in zip(runs["vmap+pallas again"], runs["vmap+pallas"]):
        assert np.array_equal(r["mask"], w["mask"]) and np.array_equal(r["norms"], w["norms"])
        assert r["loss"] == w["loss"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("llama3-8b-reduced", "mixtral-8x7b-reduced"))
def test_reduced_arch_rounds_on_the_card_equal_the_cpu(cuda, arch):
    # chip_smoke.py's arch_reduced_phase: f32, TF32 off, the same parameters;
    # masks bitwise, norms and losses within the forward tolerance, and no
    # kernel launched while autograd records
    from repro_torch.configs import get
    from repro_torch.kernels.ops import tree_map
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = build_model(get(arch)).init(torch.Generator().manual_seed(0), "cpu")
    argv = ["--arch", arch, "--rounds", "2", "--clients", "2", "--expected", "1",
            "--batch", "1", "--seq", "2100"]
    want = _arch_rows(argv + ["--device", "cpu"], init_fn=lambda dev: params)
    before = fa.flash_attention_cuda.launches
    got = _arch_rows(argv, init_fn=lambda dev: tree_map(lambda t: t.to(dev), params))
    assert fa.flash_attention_cuda.launches == before
    for g, w in zip(got, want):
        assert np.array_equal(g["mask"], w["mask"])
        assert np.abs(g["norms"] - w["norms"]).max() <= 1e-4 * np.abs(w["norms"]).max()
        assert abs(g["loss"] - w["loss"]) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ("llama3-8b-reduced", "paligemma-3b-reduced",
                                  "mixtral-8x7b-reduced", "whisper-small-reduced"))
def test_decoder_prefill_on_the_card_equals_the_cpu(cuda, arch):
    # chip_smoke.py's decoder_phase (and whisper's encdec_phase) at the
    # reduced size in f32: kernel 7 once a decoder layer (with the VLM's
    # prefix, or mixtral's window of 64 at 2,100 tokens; whisper's encoder
    # and cross-attention stay dense), the prefill's logits within 1e-4 of
    # the CPU's, greedy decode tokens equal
    from repro_torch.configs import get
    from repro_torch.kernels.ops import tree_map
    from repro_torch.launch.serve import serve

    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    r = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(r.integers(0, cfg.vocab_size, (1, 2100)))}
    if cfg.encoder_seq:
        batch["frames"] = torch.from_numpy(
            (r.normal(size=(1, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(np.float32))
    if cfg.prefix_tokens:
        batch["patches"] = torch.from_numpy(
            (r.normal(size=(1, cfg.prefix_tokens, cfg.d_model)) * 0.02).astype(np.float32))
    g_params = tree_map(lambda t: t.to(cuda), params)
    with torch.inference_mode():
        want, _ = model.prefill(params, batch, 2108)
        before = fa.flash_attention_cuda.launches
        got, _ = model.prefill(g_params, {k: v.to(cuda) for k, v in batch.items()}, 2108)
    assert fa.flash_attention_cuda.launches - before == cfg.num_layers
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    toks_cpu, _ = serve(cfg, 1, 2100, 4, device="cpu", params=params)
    toks_card, _ = serve(cfg, 1, 2100, 4, device=cuda, params=g_params)
    assert (toks_cpu == toks_card).all()
