"""The port's norm and fused norm+aggregate wrappers, and its update cache,
against the reference's.

On the CPU each wrapper runs its kernel's plain version; it is held against
the reference's Pallas kernels in interpret mode (``repro.kernels.ops``) at
rtol 1e-5 / atol 1e-6 in f32 — the two sum in different orders — and in bf16
at rtol 1e-5 / atol 1e-5 (the inputs are the same bf16 values; only the f32
sums differ).  Compressed inputs use the same material on both sides; natural
compression is left out of the kernel comparison (its values differ in the
last bits on the CPU, see ``tests/test_torch_compression.py``) and held to the
port's own eager compressor instead.  The update cache's accounting is equal
to the reference's.  The CUDA kernels themselves are held against these
plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jc
from repro.kernels import ops as j_ops
from repro.kernels import update_cache as j_cache
from repro_torch import rng
from repro_torch.core import compression as tc
from repro_torch.kernels import norm_aggregate as na
from repro_torch.kernels import ops, ref, update_cache

TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-5, atol=1e-5)}


def _inputs(c, d, seed):
    r = np.random.default_rng(seed)
    u = (r.normal(size=(c, d)) * 1e-2).astype(np.float32)
    s = (r.uniform(0, 2, size=c) * (r.uniform(size=c) < 0.6)).astype(np.float32)
    return u, s


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL[dtype])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", (1, 7, 4097, 58430))
@pytest.mark.parametrize("c", (1, 4, 33))
def test_norm_wrappers_match_reference(c, d, dtype):
    u, s = _inputs(c, d, seed=c * 100003 + d)
    uj, sj = jnp.asarray(u).astype(dtype), jnp.asarray(s)
    ut, st = torch.from_numpy(u).to(getattr(torch, dtype)), torch.from_numpy(s)
    want_sq = j_ops.client_sqnorms(uj, interpret=True)
    got_sq = ops.client_sqnorms(ut)
    assert got_sq.shape == (c,) and got_sq.dtype == torch.float32
    _close(got_sq, want_sq, dtype)
    want = j_ops.norm_scale_aggregate(uj, sj, interpret=True)
    got = ops.norm_scale_aggregate(ut, st)
    assert got[1].shape == (d,) and got[1].dtype == torch.float32
    for a, b in zip(got, want):
        _close(a, b, dtype)
    for a, b in zip(ref.norm_scale_aggregate_ref(ut, st), want):
        _close(a, b, dtype)


@pytest.mark.parametrize("kind,param", [("none", 0.0), ("randk", 0.1), ("qsgd", 8.0)])
@pytest.mark.parametrize("c,d", [(1, 7), (4, 4097), (33, 1000)])
def test_compress_wrapper_matches_reference(c, d, kind, param):
    u, s = _inputs(c, d, seed=c * 7 + d)
    keys = jax.random.split(jax.random.PRNGKey(c + d), c)
    mats = jax.vmap(lambda x, k: jc.compression_material(x, k, kind, param))(
        jnp.asarray(u), keys)
    want = j_ops.compress_norm_scale_aggregate(jnp.asarray(u), jnp.asarray(s), tuple(mats),
                                               kind, param, interpret=True)
    mats_t = tuple(torch.from_numpy(np.array(m)) for m in mats)
    got = ops.compress_norm_scale_aggregate(torch.from_numpy(u), torch.from_numpy(s), mats_t,
                                            kind, param)
    assert got[0].shape == (c,) and got[1].shape == (d,)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.parametrize("kind,param", [("none", 0.0), ("randk", 0.5), ("qsgd", 8.0),
                                        ("natural", 0.0)])
def test_compress_wrapper_equals_eager_compress_then_norm_aggregate(kind, param):
    """The fused form is, on the CPU too, compress eagerly (cast through the
    transport dtype), then norm+aggregate: bitwise."""
    for dtype in (torch.float32, torch.bfloat16):
        u, s = _inputs(5, 513, seed=3)
        ut, st = torch.from_numpy(u).to(dtype), torch.from_numpy(s)
        keys = rng.split(rng.PRNGKey(11), 5)
        mats = tuple(m["u"] for m in tc.client_material({"u": ut}, keys, kind, param))
        sq_f, agg_f = ops.compress_norm_scale_aggregate(ut, st, mats, kind, param)
        xc = tc.apply_compression_flat(ut, kind, param, *mats).to(dtype)
        sq_m, agg_m = ops.norm_scale_aggregate(xc, st)
        assert torch.equal(sq_f, sq_m) and torch.equal(agg_f, agg_m)


def test_tree_client_norms_matches_reference():
    r = np.random.default_rng(1)
    shapes = {"w1": (12, 5), "b1": (5,), "w2": (5, 5), "b2": (5,), "w3": (5, 4), "b3": (4,)}
    tree = {k: r.normal(size=(6,) + v).astype(np.float32) for k, v in shapes.items()}
    w = r.uniform(size=6).astype(np.float32)
    want = j_ops.tree_client_norms({k: jnp.asarray(v) for k, v in tree.items()},
                                   jnp.asarray(w), interpret=True)
    got = ops.tree_client_norms({k: torch.from_numpy(v) for k, v in tree.items()},
                                torch.from_numpy(w))
    _close(got, want)


def test_group_contractions_match_reference():
    """``update_cache.group_norm_aggregate`` and its compress twin, on both
    backends, against the reference's on the same material."""
    u, s = _inputs(6, 123, seed=4)
    keys = jax.random.split(jax.random.PRNGKey(4), 6)
    for kind, param in (("none", 0.0), ("randk", 0.5), ("qsgd", 8.0)):
        mats = tuple(jax.vmap(lambda x, k: jc.compression_material(x, k, kind, param))(
            jnp.asarray(u), keys))
        mats_t = tuple(torch.from_numpy(np.array(m)) for m in mats)
        for backend in ("jnp", "pallas"):
            want = j_cache.group_compress_norm_aggregate(
                jnp.asarray(u), jnp.asarray(s), mats, kind, param, backend, interpret=True)
            got = update_cache.group_compress_norm_aggregate(
                torch.from_numpy(u), torch.from_numpy(s), mats_t, kind, param, backend)
            for a, b in zip(got, want):
                _close(a, b)
        if kind == "none":
            for backend in ("jnp", "pallas"):
                got = update_cache.group_norm_aggregate(torch.from_numpy(u),
                                                        torch.from_numpy(s), backend)
                want = j_cache.group_norm_aggregate(jnp.asarray(u), jnp.asarray(s), backend,
                                                    interpret=True)
                for a, b in zip(got, want):
                    _close(a, b)


@pytest.mark.parametrize("n,g", [(8, 2), (8, 4), (32, 4), (12, 3)])
def test_update_cache_accounting_matches_reference(n, g):
    for cg in (0, 1, 2, 3, 4, 99):
        assert update_cache.num_slots(cg, n // g) == j_cache.num_slots(cg, n // g)
        assert update_cache.local_update_evals(n, g, cg) == j_cache.local_update_evals(n, g, cg)
        for dim, itemsize in ((100, 4), (58430, 2)):
            assert update_cache.cache_bytes(cg, g, dim, itemsize) == \
                j_cache.cache_bytes(cg, g, dim, itemsize)
            assert update_cache.cache_bytes(cg, g, dim, itemsize, n // g) == \
                j_cache.cache_bytes(cg, g, dim, itemsize, n // g)


def test_wrappers_raise_off_cuda_instead_of_falling_back():
    u = torch.zeros((2, 8), device="meta")
    s = torch.zeros((2,), device="meta")
    before = (na.client_sqnorms_cuda.launches, na.norm_scale_aggregate_cuda.launches,
              na.compress_norm_scale_aggregate_cuda.launches)
    for call in (lambda: na.client_sqnorms_cuda(u),
                 lambda: na.norm_scale_aggregate_cuda(u, s),
                 lambda: na.compress_norm_scale_aggregate_cuda(u, s, (u,), "randk", 0.5)):
        with pytest.raises(ValueError, match="CUDA device"):
            call()
    with pytest.raises(ValueError, match="material"):
        na.compress_norm_scale_aggregate_cuda(u, s, (), "randk", 0.5)
    with pytest.raises(ValueError, match="compressor"):
        na.compress_norm_scale_aggregate_cuda(u, s, (), "topk", 0.5)
    assert (na.client_sqnorms_cuda.launches, na.norm_scale_aggregate_cuda.launches,
            na.compress_norm_scale_aggregate_cuda.launches) == before


def test_kernel_kinds_are_the_compressors():
    assert tuple(na.KINDS) == tc.COMPRESSORS == jc.COMPRESSORS
    assert tc.MATERIAL_ARITY == jc.MATERIAL_ARITY
