"""The port's threefry keys against jax.random, bit for bit.

``repro_torch.rng`` reproduces jax's threefry2x32 with
``jax_threefry_partitionable=True`` (the jax 0.9 default), so the same seed
gives the same keys, bits, uniforms and Bernoulli draws in both packages.
``normal`` goes through erfinv, held to rtol = atol = 1e-6 (float32
rounding of log1p and the polynomial).
"""

import jax
import numpy as np
import pytest

from repro_torch import rng

SEEDS = (0, 1, 7, 12345, 2**31 - 1)
SHAPES = ((), (1,), (7,), (3, 5), (33,))


def _np(x):
    return np.asarray(x).astype(np.int64)


def test_partitionable_threefry_is_on():
    # the bit layout the port reproduces
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_fold_in_bitwise(seed):
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_np(jax.random.split(kj, num)),
                                      rng.split(kt, num).numpy())
    for data in (1, 2, 1000, 1007, 2**32 - 1):
        np.testing.assert_array_equal(_np(jax.random.fold_in(kj, data)),
                                      rng.fold_in(kt, data).numpy())
    # the driver's chain: round key -> (k_sample, k_comp)
    kk_j = jax.random.split(jax.random.fold_in(kj, 1003))
    kk_t = rng.split(rng.fold_in(kt, 1003))
    np.testing.assert_array_equal(_np(kk_j), kk_t.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_bernoulli_bitwise(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1000)
    kt = rng.fold_in(rng.PRNGKey(seed), 1000)
    np.testing.assert_array_equal(_np(jax.random.bits(kj, shape)),
                                  rng.bits(kt, shape).numpy())
    uj = np.asarray(jax.random.uniform(kj, shape), np.float32)
    ut = rng.uniform(kt, shape).numpy()
    np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
    p = np.random.default_rng(seed % 1000).uniform(size=shape).astype(np.float32)
    bj = np.asarray(jax.random.bernoulli(kj, p, shape))
    import torch

    bt = rng.bernoulli(kt, torch.from_numpy(p), shape).numpy()
    np.testing.assert_array_equal(bj, bt)
    np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(kj, 0.7, shape)),
                                  rng.bernoulli(kt, 0.7, shape).numpy())


@pytest.mark.parametrize("shape", SHAPES + ((784, 64),))
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_close(seed, shape):
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    kt = rng.fold_in(rng.PRNGKey(seed), 1)
    np.testing.assert_allclose(rng.normal(kt, shape).numpy(),
                               np.asarray(jax.random.normal(kj, shape)),
                               rtol=1e-6, atol=1e-6)
