"""The port's Eq. 2 masked aggregate against the reference's.

On the CPU the wrapper runs the kernel's plain version; it is held against
the reference's Pallas kernel in interpret mode over C in {1, 3, 32, 33} and
D in {1, 7, 4097, 58430} (the main path's width), f32 and bf16, to
rtol 1e-5 / atol 1e-6 (the two sum the clients in different orders).  The
client-major layout matches the reference's column for column.  The CUDA
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as j_ops
from repro_torch.kernels import masked_aggregate as ma
from repro_torch.kernels import ops, ref


def _inputs(c, d, seed):
    r = np.random.default_rng(seed)
    u = (r.normal(size=(c, d)) * 1e-2).astype(np.float32)
    s = (r.uniform(0, 2, size=c) * (r.uniform(size=c) < 0.6)).astype(np.float32)
    return u, s


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("d", (1, 7, 4097, 58430))
@pytest.mark.parametrize("c", (1, 3, 32, 33))
def test_masked_scale_aggregate_matches_reference(c, d, dtype):
    u, s = _inputs(c, d, seed=c * 100003 + d)
    uj = jnp.asarray(u).astype(dtype)
    want = np.asarray(j_ops.masked_scale_aggregate(uj, jnp.asarray(s), interpret=True))
    ut = torch.from_numpy(u).to(getattr(torch, dtype))
    got = ops.masked_scale_aggregate(ut, torch.from_numpy(s))
    assert got.shape == (d,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ref.masked_scale_aggregate_ref(ut, torch.from_numpy(s)).numpy(),
                               want, rtol=1e-5, atol=1e-6)


def _mlp_tree(n, seed):
    r = np.random.default_rng(seed)
    shapes = {"w1": (12, 5), "b1": (5,), "w2": (5, 5), "b2": (5,), "w3": (5, 4), "b3": (4,)}
    return {k: r.normal(size=(n,) + v).astype(np.float32) for k, v in shapes.items()}


def test_client_matrix_layout_matches_reference():
    tree = _mlp_tree(3, seed=0)
    want = np.asarray(j_ops.tree_to_client_matrix({k: jnp.asarray(v) for k, v in tree.items()}))
    got = ops.tree_to_client_matrix({k: torch.from_numpy(v) for k, v in tree.items()})
    np.testing.assert_array_equal(got.numpy(), want)
    assert [leaf.shape[1:] for leaf in ops.tree_leaves(tree)] == [
        (5,), (5,), (4,), (12, 5), (5, 5), (5, 4)]   # b1, b2, b3, w1, w2, w3
    tree_t = {k: torch.from_numpy(v) for k, v in tree.items()}
    for row in range(3):
        back = ops.client_matrix_to_tree(got[row], tree_t, strip_client_axis=True)
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), tree[k][row])


def test_tree_masked_aggregate_matches_reference():
    tree = _mlp_tree(6, seed=1)
    s = np.random.default_rng(2).uniform(size=6).astype(np.float32)
    want = j_ops.tree_masked_aggregate({k: jnp.asarray(v) for k, v in tree.items()},
                                       jnp.asarray(s), interpret=True)
    got = ops.tree_masked_aggregate({k: torch.from_numpy(v) for k, v in tree.items()},
                                    torch.from_numpy(s))
    assert sorted(got) == sorted(want)
    for k in tree:
        assert got[k].shape == tuple(want[k].shape)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-6)


def test_wrapper_raises_off_cuda_instead_of_falling_back():
    u = torch.zeros((2, 8), device="meta")
    s = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ma.masked_scale_aggregate_cuda(u, s)
    assert ma.masked_scale_aggregate_cuda.launches == 0
