"""The port's mesh-round aggregates against the reference's.

``ops.shard_masked_aggregate`` / ``shard_compress_aggregate`` and their tree
forms, on the CPU (where each runs its kernel's plain version), against the
reference's ``ops.shard_masked_aggregate`` / ``shard_compress_aggregate``
with the Pallas kernels in interpret mode, on the reference's uneven shapes
(the client count not a multiple of the reference's client block, D not a
multiple of its chunk), f32 and bf16, every compressor.  The inputs and the
compression material are made with numpy and handed to both.  Tolerance as
the reference's own test of the kernel: rtol = atol = 1e-5 in f32, 3e-2 in
bf16.  ``mesh=None`` skips the cross-rank sum on both sides; the sum itself
is held by ``tests/test_torch_shard_round.py``.  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import ops, ref

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
SHAPES_C = [(1, 4), (5, 2), (12, 8), (16, 16)]       # (clients, reference's client block)
SHAPES_D = [(64, 16), (1000, 128), (130, 512)]       # (D, reference's chunk)
COMPRESSORS = [("none", 0.0), ("randk", 0.1), ("qsgd", 8.0), ("natural", 0.0)]


def _workload(c, d, seed, dtype):
    """Updates (exact in ``dtype``) and a scale with about 40% zeros."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(c, d)) * 3).astype(np.float32)
    x = torch.from_numpy(x).to(getattr(torch, dtype)).float().numpy()
    s = np.where(r.uniform(size=c) < 0.6, r.uniform(size=c) * 4, 0.0).astype(np.float32)
    return x, s


def _material(x, kind, param, seed):
    """The compressor's material matrices, drawn with numpy: rand-k gains,
    QSGD's uniforms and per-client norms, natural's uniforms."""
    r = np.random.default_rng(seed)
    c, d = x.shape
    if kind == "none":
        return ()
    u = r.uniform(size=(c, d)).astype(np.float32)
    if kind == "randk":
        return ((u < param).astype(np.float32) / np.float32(param),)
    if kind == "qsgd":
        nrm = np.sqrt((x.astype(np.float64) ** 2).sum(1, keepdims=True)).astype(np.float32)
        return (u, np.broadcast_to(nrm, (c, d)).copy())
    return (u,)


def _both(x, s, dtype):
    return ((jnp.asarray(x).astype(dtype), jnp.asarray(s)),
            (torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(s)))


def _close(got, want, dtype):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d,chunk", SHAPES_D)
@pytest.mark.parametrize("clients,block", SHAPES_C)
def test_shard_masked_aggregate_matches_reference(clients, block, d, chunk, dtype):
    x, s = _workload(clients, d, clients * d, dtype)
    (xj, sj), (xt, st) = _both(x, s, dtype)
    want = j_ops.shard_masked_aggregate(xj, sj, chunk=chunk, block_clients=block,
                                        interpret=True)
    got = ops.shard_masked_aggregate(xt, st)
    assert got.shape == (d,) and got.dtype == torch.float32
    _close(got, want, dtype)
    _close(ref.sharded_masked_aggregate_ref(xt, st), want, dtype)


@pytest.mark.parametrize("kind,param", COMPRESSORS)
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d,chunk", SHAPES_D)
@pytest.mark.parametrize("clients,block", SHAPES_C)
def test_shard_compress_aggregate_matches_reference(clients, block, d, chunk, dtype,
                                                    kind, param):
    x, s = _workload(clients, d, clients * d + 1, dtype)
    mats = _material(x, kind, param, seed=clients + d)
    (xj, sj), (xt, st) = _both(x, s, dtype)
    want_sq, want = j_ops.shard_compress_aggregate(
        xj, sj, tuple(jnp.asarray(m) for m in mats), kind, param, chunk=chunk,
        block_clients=block, interpret=True)
    mats_t = tuple(torch.from_numpy(m) for m in mats)
    got_sq, got = ops.shard_compress_aggregate(xt, st, mats_t, kind, param)
    assert got_sq.shape == (clients,) and got.shape == (d,)
    _close(got, want, dtype)
    np.testing.assert_allclose(got_sq.numpy(), np.asarray(want_sq), rtol=TOL[dtype])
    ref_sq, ref_agg = ref.sharded_compress_aggregate_ref(xt, st, mats_t, kind, param)
    _close(ref_agg, want, dtype)
    np.testing.assert_allclose(ref_sq.numpy(), np.asarray(want_sq), rtol=TOL[dtype])


def _tree(c, seed):
    """A client block as a tree of uneven leaves (D = 3*5 + 17 = 32)."""
    r = np.random.default_rng(seed)
    return {"a": r.normal(size=(c, 3, 5)).astype(np.float32),
            "b": r.normal(size=(c, 17)).astype(np.float32)}


@pytest.mark.parametrize("kind,param", COMPRESSORS)
def test_tree_forms_match_reference(kind, param):
    c = 6
    upd = _tree(c, seed=5)
    _, s = _workload(c, 1, 7, "float32")
    flat = np.concatenate([upd["a"].reshape(c, -1), upd["b"]], axis=1)
    mats = _material(flat, kind, param, seed=11)
    mat_trees = tuple({"a": m[:, :15].reshape(c, 3, 5), "b": m[:, 15:]} for m in mats)
    to_j = lambda t: {k: jnp.asarray(v) for k, v in t.items()}
    to_t = lambda t: {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in t.items()}
    if kind == "none":
        want = j_ops.tree_shard_masked_aggregate(to_j(upd), jnp.asarray(s), chunk=16,
                                                 block_clients=4, interpret=True)
        got = ops.tree_shard_masked_aggregate(to_t(upd), torch.from_numpy(s))
    else:
        want = j_ops.tree_shard_compress_aggregate(
            to_j(upd), jnp.asarray(s), tuple(to_j(m) for m in mat_trees), kind, param,
            chunk=16, block_clients=4, interpret=True)
        got = ops.tree_shard_compress_aggregate(
            to_t(upd), torch.from_numpy(s), tuple(to_t(m) for m in mat_trees), kind, param)
    assert sorted(got) == ["a", "b"]
    for k in got:
        assert got[k].shape == tuple(want[k].shape) and got[k].dtype == torch.float32
        _close(got[k], want[k], "float32")


def test_plain_versions_are_the_single_device_ones():
    from repro_torch.kernels import masked_aggregate as ma
    from repro_torch.kernels import norm_aggregate as na

    assert ref.sharded_masked_aggregate_ref is ma.masked_scale_aggregate_ref
    assert ref.sharded_compress_aggregate_ref is na.compress_norm_scale_aggregate_ref


def test_wrappers_take_cpu_tensors_without_counting():
    from repro_torch.kernels import sharded_aggregate as sa

    before = (sa.sharded_masked_aggregate_cuda.launches,
              sa.sharded_compress_aggregate_cuda.launches)
    x, s = _workload(3, 10, 0, "float32")
    ops.shard_masked_aggregate(torch.from_numpy(x), torch.from_numpy(s))
    ops.shard_compress_aggregate(torch.from_numpy(x), torch.from_numpy(s), (), "none", 0.0)
    assert (sa.sharded_masked_aggregate_cuda.launches,
            sa.sharded_compress_aggregate_cuda.launches) == before
    with pytest.raises(ValueError, match="takes 1 material"):
        ops.shard_compress_aggregate(torch.from_numpy(x), torch.from_numpy(s), (), "randk", 0.1)
    with pytest.raises(ValueError, match="unknown compressor"):
        ops.shard_compress_aggregate(torch.from_numpy(x), torch.from_numpy(s), (), "gzip", 0.1)
