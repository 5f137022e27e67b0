"""The summation order of the port's norm kernels, emulated in float32 on
the CPU, and the unpadded fused wrappers against the reference.

The CUDA kernels of ``src/repro_torch/kernels/csrc/norm_aggregate.cu`` take
each client's squared norm in stages (``csrc/ocs_tile.cuh``): a thread
squares its 4 columns (``col_sqnorm``: one multiply, three fmaf), a warp
sums its 32 threads by an xor shuffle tree (``warp_sum``), lane 0 writes one
partial per (client, CTA, warp), i.e. per 128 columns, and the partials are
summed in one fixed order. Kernel 2 and kernel 6 sum them in a second launch
(``finish_sqnorms``: thread t adds partials t, t + 128, ... in turn, then a
shared-memory tree over 128 threads), as they did before their one-launch
rebuild; kernels 2, 3, 4 and 6 now sum them inside their one launch, in the
CTA that finishes last, one warp per client (``warp_finish_sqnorms``). This
file emulates every stage with numpy float32 arithmetic (fmaf with one
rounding) and shows:

* the two finishes give bitwise the same norms, for any partials;
* a matrix whose columns past D are 0.0 after compression (the unpadded
  kernel's tail) gives bitwise the partials of the zero-padded matrix, for
  every compressor, through the port's own ``apply_compression_flat``;

so the one-launch kernels on the unpadded matrix (kernels 2, 3, 4 and 6)
keep the norms that the padded two-launch kernels gave.  Then the CPU route
of the unpadded wrappers is held against the reference's Pallas kernels in
interpret mode (rtol 1e-5, atol 1e-6: the two sum in different orders), and
the ``ops`` wrappers are shown to hand the kernels the caller's matrices
unpadded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels import norm_aggregate as j_na
from repro.kernels import ops as j_ops
from repro_torch import rng
from repro_torch.core import compression as tc
from repro_torch.kernels import ops

THREADS, COLS, LANES = 128, 4, 32
TILE = THREADS * COLS                # columns per CTA
FINISH_ROWS = 4                      # kFinishRows in the kernel


def _fmaf(a, b, c):
    """float32 ``a * b + c`` with one rounding (CUDA's fmaf), elementwise."""
    a, b, c = (np.asarray(t, np.float32).astype(np.float64) for t in (a, b, c))
    prod = a * b                                   # exact: 48 significant bits
    s = prod + c
    t = s - prod
    err = (prod - (s - t)) + (c - t)               # s + err is the exact sum
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    # rounding s to float32 rounds the exact sum correctly unless s lies
    # exactly halfway between two float32 values and err is not 0
    toward = np.nextafter(r, np.where(s > r64, np.float32(np.inf), np.float32(-np.inf)))
    tie = (err != 0) & (s != r64) & (s == (r64 + toward.astype(np.float64)) / 2)
    up = np.sign(err) == np.sign(toward.astype(np.float64) - r64)
    return np.where(tie & up, toward, r).astype(np.float32)


def _col_sqnorm(x):
    """(..., 4) -> (...): x0 * x0, then fmaf of x1, x2, x3."""
    p = x[..., 0] * x[..., 0]
    for k in (1, 2, 3):
        p = _fmaf(x[..., k], x[..., k], p)
    return p


def _warp_sum(v):
    """The xor shuffle tree over the last axis (32 lanes); every lane's sum."""
    lane = np.arange(LANES)
    for off in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ off]
    return v


def _partials(x):
    """(C, n * 512) float32 -> (C, n * 4) partials: CTA b, warp w at b * 4 + w."""
    c, dp = x.shape
    assert dp % TILE == 0
    v = _col_sqnorm(x.reshape(c, dp // TILE, THREADS // LANES, LANES, COLS))
    return _warp_sum(v)[..., 0].reshape(c, -1)


def _finish_sqnorms(p):
    """finish_sqnorms: thread t sums partials t, t + 128, ... from 0, then a
    shared-memory tree (s[t] += s[t + w] for w = 64, 32, ..., 1)."""
    c, parts = p.shape
    v = np.zeros((c, THREADS), np.float32)
    for j0 in range(0, parts, THREADS):
        j = j0 + np.arange(THREADS)
        ok = j < parts
        v = np.where(ok, v + p[:, np.minimum(j, parts - 1)], v)
    w = THREADS // 2
    while w:
        v[:, :w] = v[:, :w] + v[:, w:2 * w]
        w //= 2
    return v[:, 0]


def _warp_finish_sqnorms(p):
    """warp_finish_sqnorms as the fused kernels order it: lane l sums
    partials l + 32 q + 128 j (j in turn, FINISH_ROWS rows a round) for q =
    0..3, then (q0 + q2) + (q1 + q3), then the warp's xor tree; lane 0."""
    c, parts = p.shape
    v = np.zeros((c, 4, LANES), np.float32)
    lane = np.arange(LANES)
    for j0 in range(0, parts, FINISH_ROWS * THREADS):
        for r in range(FINISH_ROWS):
            for q in range(4):
                j = j0 + r * THREADS + q * LANES + lane
                ok = j < parts
                v[:, q] = np.where(ok, v[:, q] + p[:, np.minimum(j, parts - 1)], v[:, q])
    out = (v[:, 0] + v[:, 2]) + (v[:, 1] + v[:, 3])
    return _warp_sum(out)[:, 0]


def _padded(x, dp):
    return np.pad(x, ((0, 0), (0, dp - x.shape[1])))


def _width(d):
    return -(-d // TILE) * TILE


@pytest.mark.parametrize("d", (1, 7, 511, 513, 4097, 58430))
@pytest.mark.parametrize("c", (1, 4, 32, 200))
def test_in_launch_finish_is_finish_sqnorms_bitwise(c, d):
    r = np.random.default_rng(c * 7 + d)
    # magnitudes over six decades, so that another order changes the bits
    x = (r.normal(size=(c, d)) * 10.0 ** r.uniform(-3, 3, size=(c, d))).astype(np.float32)
    p = _partials(_padded(x, _width(d)))
    assert p.shape == (c, _width(d) // THREADS)      # one per 128 columns
    want = _finish_sqnorms(p)
    got = _warp_finish_sqnorms(p)
    assert got.dtype == np.float32 and np.array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(got, np.sum(x.astype(np.float64) ** 2, axis=1), rtol=1e-5)
    if c >= 4 and d >= 4097:
        # the order matters: a plain left-to-right sum of the partials differs
        plain = np.zeros(c, np.float32)
        for j in range(p.shape[1]):
            plain = plain + p[:, j]
        assert not np.array_equal(plain, want)


def test_fmaf_rounds_once():
    # 1 + 2^-24 is halfway between 1 and the next float32; fmaf keeps the
    # 2^-48 of the product, a multiply then an add does not
    a = np.float32(1.0 + 2.0 ** -23)
    c = np.float32(-(1.0 + 2.0 ** -22))
    assert _fmaf(a, a, c) == np.float32(2.0 ** -46)
    assert a * a + c == np.float32(0.0)
    # x * x = 1 + 2^-11 + 2^-24 lies halfway between two float32 values;
    # +-2^-80 vanishes in the double sum but decides the float32 rounding
    x = np.float32(1.0 + 2.0 ** -12)
    assert _fmaf(x, x, np.float32(2.0 ** -80)) == np.float32(1.0 + 2.0 ** -11 + 2.0 ** -23)
    assert _fmaf(x, x, np.float32(-(2.0 ** -80))) == np.float32(1.0 + 2.0 ** -11)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=("f32", "bf16"))
@pytest.mark.parametrize("kind,param", (("none", 0.0), ("randk", 0.1), ("qsgd", 8.0),
                                        ("qsgd", 5.0), ("natural", 0.0)))
@pytest.mark.parametrize("d", (7, 513, 58430))
def test_masked_tail_gives_the_zero_padded_partials(d, kind, param, dtype):
    c, dp = 4, _width(d)
    r = np.random.default_rng(d + len(kind))
    u = torch.from_numpy((r.normal(size=(c, d)) * 1e-2).astype(np.float32)).to(dtype)
    u[0, :4] = torch.tensor([2.0 ** -126, 1e-40, 0.5, -0.25])[:d].to(dtype)
    keys = rng.split(rng.PRNGKey(d), c)
    mats = tuple(m["u"] for m in tc.client_material({"u": u}, keys, kind, param))

    def compressed(x, ms):
        xc = tc.apply_compression_flat(x, kind, param, *[m.to(torch.float32) for m in ms])
        return xc.to(dtype).to(torch.float32).numpy()

    # the unpadded kernel: the D columns compressed, the tail 0.0
    masked = _padded(compressed(u, mats), dp)
    # the padded launch: values and material zero-padded, then compressed
    pad = torch.nn.functional.pad
    padded = compressed(pad(u, (0, dp - d)), tuple(pad(m, (0, dp - d)) for m in mats))
    assert np.array_equal(padded[:, d:].view(np.int32), np.zeros((c, dp - d), np.int32))
    pm, pp = _partials(masked), _partials(padded)
    assert np.array_equal(pm.view(np.int32), pp.view(np.int32))
    assert np.array_equal(_warp_finish_sqnorms(pm).view(np.int32),
                          _finish_sqnorms(pp).view(np.int32))


def _reference(u, s, mats, kind, param, chunk=4096):
    """The reference's Pallas kernels in interpret mode, on its own padding."""
    d = u.shape[1]
    pad = ((0, 0), (0, (-d) % chunk))
    uj, sj = jnp.pad(jnp.asarray(u), pad), jnp.asarray(s)
    if kind == "none":
        sq, agg = j_na.norm_scale_aggregate_pallas(uj, sj, chunk=chunk, interpret=True)
    else:
        sq, agg = j_na.compress_norm_scale_aggregate_pallas(
            uj, sj, tuple(jnp.pad(m, pad) for m in mats), kind, param, chunk=chunk,
            interpret=True)
    return np.asarray(sq), np.asarray(agg)[:d]


@pytest.mark.parametrize("kind,param", (("none", 0.0), ("randk", 0.1), ("qsgd", 8.0)))
@pytest.mark.parametrize("c", (4, 32))
def test_unpadded_wrappers_match_reference_at_full_width(c, kind, param):
    d = 58430
    r = np.random.default_rng(c)
    u = (r.normal(size=(c, d)) * 1e-2).astype(np.float32)
    s = (r.uniform(0, 2, size=c) * (r.uniform(size=c) < 0.6)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(c), c)
    mats = () if kind == "none" else tuple(
        jax.vmap(lambda x, k: jc.compression_material(x, k, kind, param))(jnp.asarray(u), keys))
    want = _reference(u, s, mats, kind, param)
    ut, st = torch.from_numpy(u), torch.from_numpy(s)
    mats_t = tuple(torch.from_numpy(np.array(m)) for m in mats)
    got = ops.compress_norm_scale_aggregate(ut, st, mats_t, kind, param)
    if kind == "none":
        got3 = ops.norm_scale_aggregate(ut, st)
        assert torch.equal(got3[0], got[0]) and torch.equal(got3[1], got[1])
    assert got[0].shape == (c,) and got[1].shape == (d,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6)


def _reference_norms_and_shard(u, s, mats, kind, param):
    """The reference's ``ops`` in interpret mode: ``client_sqnorms`` on its
    zero padding of D, and ``shard_compress_aggregate`` padded on both axes
    (D to the chunk, the clients to the block of 128) as it pads them."""
    uj = jnp.asarray(u)
    sq2 = j_ops.client_sqnorms(uj, interpret=True)
    sq6, agg6 = j_ops.shard_compress_aggregate(
        uj, jnp.asarray(s), tuple(jnp.asarray(m) for m in mats), kind, param,
        interpret=True)
    return np.asarray(sq2), np.asarray(sq6), np.asarray(agg6)


@pytest.mark.parametrize("kind,param", (("none", 0.0), ("randk", 0.1), ("qsgd", 8.0)))
@pytest.mark.parametrize("d", (7, 513, 58430))
@pytest.mark.parametrize("c", (4, 32, 200))
def test_unpadded_norm_and_shard_wrappers_match_reference(c, d, kind, param):
    """``ops.client_sqnorms`` and ``ops.shard_compress_aggregate`` (kernels 2
    and 6, which take the unpadded matrices) on the CPU against the
    reference's padded Pallas kernels, beyond one client block at c = 200."""
    r = np.random.default_rng(c * 3 + d)
    u = (r.normal(size=(c, d)) * 1e-2).astype(np.float32)
    s = (r.uniform(0, 2, size=c) * (r.uniform(size=c) < 0.6)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(c + d), c)
    mats = () if kind == "none" else tuple(
        np.array(m) for m in
        jax.vmap(lambda x, k: jc.compression_material(x, k, kind, param))(jnp.asarray(u), keys))
    want_sq2, want_sq6, want_agg6 = _reference_norms_and_shard(u, s, mats, kind, param)
    ut, st = torch.from_numpy(u), torch.from_numpy(s)
    sq2 = ops.client_sqnorms(ut)
    sq6, agg6 = ops.shard_compress_aggregate(ut, st, tuple(torch.from_numpy(m) for m in mats),
                                             kind, param)
    assert sq2.shape == (c,) and sq6.shape == (c,) and agg6.shape == (d,)
    np.testing.assert_allclose(sq2.numpy(), want_sq2, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sq6.numpy(), want_sq6, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(agg6.numpy(), want_agg6, rtol=1e-5, atol=1e-6)


def test_ops_hand_the_kernels_unpadded_matrices(monkeypatch):
    """The ``ops`` wrappers of kernels 2 and 6 pass the caller's ``(C, D)``
    matrices to the kernel wrappers as they are: no padding, no copy of a
    contiguous matrix (a recording stub stands in for each wrapper)."""
    from repro_torch.kernels import norm_aggregate as na
    from repro_torch.kernels import sharded_aggregate as sa

    seen = []

    def sqnorms(u):
        seen.append(("client_sqnorms", u))
        return na.client_sqnorms_ref(u)

    def shard(u, s, mats, kind, param):
        seen.append(("sharded_compress_aggregate", u, *mats))
        return sa.sharded_compress_aggregate_ref(u, s, mats, kind, param)

    monkeypatch.setattr(ops, "client_sqnorms_cuda", sqnorms)
    monkeypatch.setattr(ops, "sharded_compress_aggregate_cuda", shard)
    c, d = 5, 58430
    r = np.random.default_rng(0)
    u = torch.from_numpy(r.normal(size=(c, d)).astype(np.float32))
    s = torch.from_numpy(r.uniform(size=c).astype(np.float32))
    mats = (torch.from_numpy(r.uniform(size=(c, d)).astype(np.float32)),
            torch.from_numpy(r.uniform(size=(c, d)).astype(np.float32)))
    ops.client_sqnorms(u)
    ops.shard_compress_aggregate(u, s, mats, "qsgd", 8.0)
    tree = {"a": u[:, :430].reshape(c, 43, 10).clone(), "b": u[:, 430:].clone()}
    ops.tree_client_norms(tree, s)
    ops.tree_shard_compress_aggregate(tree, s, ({"a": tree["a"], "b": tree["b"]},
                                                {"a": tree["a"], "b": tree["b"]}),
                                      "qsgd", 8.0)
    assert [name for name, *_ in seen] == ["client_sqnorms", "sharded_compress_aggregate"] * 2
    for _, *mats_seen in seen:
        assert all(tuple(m.shape) == (c, d) and m.is_contiguous() for m in mats_seen)
    assert seen[0][1] is u
    assert seen[1][1] is u and seen[1][2] is mats[0] and seen[1][3] is mats[1]
    assert torch.equal(seen[2][1], u) and torch.equal(seen[3][1], u)
