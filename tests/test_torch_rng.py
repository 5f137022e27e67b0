"""The port's threefry keys against jax.random, bit for bit.

``repro_torch.rng`` reproduces jax's threefry2x32 with
``jax_threefry_partitionable=True`` (the jax 0.9 default), so the same seed
gives the same keys, bits, uniforms and Bernoulli draws in both packages.
``normal`` goes through erfinv, held to rtol = atol = 1e-6 (float32
rounding of log1p and the polynomial).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_many_is_a_stack_of_fold_ins(seed):
    # the scan mode's block of round keys, drawn in one cipher call
    kj, kt = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    data = [1000, 1001, 1007, 2**31 + 5, 2**32 - 1]
    got = rng.fold_in_many(kt, data)
    assert got.shape == (5, 2) and got.dtype == torch.int64
    np.testing.assert_array_equal(_np(jnp.stack([jax.random.fold_in(kj, d) for d in data])),
                                  got.numpy())
    for d, row in zip(data, got):
        assert torch.equal(row, rng.fold_in(kt, d))


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


@pytest.mark.parametrize("seed", SEEDS)
def test_copy_free_helpers_bitwise(seed):
    # fold_in, uniform and bernoulli with a scalar p build no tensor from
    # host memory (no stream sync on a card); still bitwise jax's
    import torch

    kj = jax.random.fold_in(jax.random.PRNGKey(seed), 2**31 + 5)
    kt = rng.fold_in(rng.PRNGKey(seed), 2**31 + 5)
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    # the bounds the port draws with (uniform, and normal's (-1, 1)): jax's bits
    for lo, hi in ((0.0, 1.0), (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0)):
        uj = np.asarray(jax.random.uniform(kj, (257,), minval=lo, maxval=hi), np.float32)
        ut = rng.uniform(kt, (257,), lo, hi).numpy()
        np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
    # any bounds: the earlier form on float32 device tensors, bit for bit (XLA
    # may fuse jax's product and sum into one rounding; neither torch form does)
    for lo, hi in ((-0.5, 2.0), (0.1, 0.3)):
        b = rng.bits(kt, (257,))
        floats = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        t_lo, t_hi = torch.tensor(lo, dtype=torch.float32), torch.tensor(hi, dtype=torch.float32)
        want = torch.maximum(t_lo, floats * (t_hi - t_lo) + t_lo)
        assert torch.equal(rng.uniform(kt, (257,), lo, hi), want)
    for p in (0.7, 0.3, 1 / 3):
        np.testing.assert_array_equal(np.asarray(jax.random.bernoulli(kj, p, (257,))),
                                      rng.bernoulli(kt, p, (257,)).numpy())
    assert rng.bernoulli(kt, 0.7, (3,)).dtype == torch.bool


def test_data_size_weights_bitwise():
    import jax.numpy as jnp

    from repro.configs.base import FLConfig as JFLConfig
    from repro.fl.round import client_weights as j_client_weights
    from repro_torch.configs.base import FLConfig
    from repro_torch.fl.round import client_weights

    sizes = np.array([12, 110, 37, 400, 8, 91, 12, 55])
    want = j_client_weights(JFLConfig(n_clients=8, weights="data_size"), jnp.asarray(sizes))
    got = client_weights(FLConfig(n_clients=8, weights="data_size"), sizes, device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want, np.float32).view(np.int32))
