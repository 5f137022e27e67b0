"""The port's unbiased compressors against the reference's.

Inputs are made with numpy from fixed seeds and go through both packages on
the CPU.  Tolerances:

* batched keys, bits and uniforms: bitwise ``jax.vmap`` of the single-key
  functions;
* compression material: rand-k gains and the uniforms bitwise; qsgd's
  per-leaf norm (a float reduction summed in another order) rtol 1e-6;
* ``apply_compression_flat`` given the same material, on normal inputs
  (zeros, powers of two and their neighbours included): randk and qsgd
  bitwise; natural rtol 2e-6, because XLA:CPU's ``exp2`` is inexact at
  integer arguments (up to 1.01e-6 relative) where torch's is exact.  On
  subnormal inputs, which XLA:CPU reads as zero, the reference gives 0 and
  the port the value of its own arithmetic (within 4 * 2**-126);
* uplink billing: equal.

The reference's own compressor properties (``tests/test_compression_fused.py``)
are restated on the port with the same assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bits as j_bits
from repro.core import compression as jc
from repro_torch import rng
from repro_torch.core import bits
from repro_torch.core import compression as tc

KINDS = [("randk", 0.5), ("qsgd", 8.0), ("natural", 0.0)]
TINY = np.float32(2.0 ** -126)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _tree(n, seed):
    r = np.random.default_rng(seed)
    shapes = {"w1": (12, 5), "b1": (5,), "w2": (5, 5), "b2": (5,), "w3": (5, 4), "b3": (4,)}
    return {k: r.normal(size=(n,) + v).astype(np.float32) for k, v in shapes.items()}


def _keys(n, seed):
    return jax.random.split(jax.random.PRNGKey(seed), n), rng.split(rng.PRNGKey(seed), n)


def _special_values():
    pows = np.float32(2.0) ** np.arange(-30, 12, dtype=np.float32)
    vals = np.concatenate([
        pows, np.nextafter(pows, np.float32(0)), np.nextafter(pows, np.float32(np.inf)),
        np.float32([0.0, 1e-40, 5e-39, 1e-45]),
    ]).astype(np.float32)
    return np.concatenate([vals, -vals])


# --- batched keys ----------------------------------------------------------

@pytest.mark.parametrize("n", (1, 5, 32))
def test_batched_split_bits_uniform_bitwise(n):
    kj, kt = _keys(n, 11)
    np.testing.assert_array_equal(_np(kj), kt.numpy())
    for num in (2, 6):
        np.testing.assert_array_equal(_np(jax.vmap(lambda k: jax.random.split(k, num))(kj)),
                                      rng.split(kt, num).numpy())
    for shape in ((), (7,), (3, 5)):
        np.testing.assert_array_equal(
            _np(jax.vmap(lambda k: jax.random.bits(k, shape))(kj)), rng.bits(kt, shape).numpy())
        uj = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(kj), np.float32)
        ut = rng.uniform(kt, shape).numpy()
        np.testing.assert_array_equal(uj.view(np.int32), ut.view(np.int32))
    # a batch of keys draws what each key draws alone
    for i in range(n):
        np.testing.assert_array_equal(rng.bits(kt[i], (7,)).numpy(),
                                      rng.bits(kt, (7,))[i].numpy())


# --- material ----------------------------------------------------------------

@pytest.mark.parametrize("kind,param", KINDS + [("randk", 0.1), ("randk", 1e-9)])
def test_client_material_matches_vmapped_reference(kind, param):
    tree = _tree(6, seed=1)
    kj, kt = _keys(6, 3)
    mj = jax.vmap(lambda u, k: jc.compression_material(u, k, kind, param))(
        {k: jnp.asarray(v) for k, v in tree.items()}, kj)
    mt = tc.client_material({k: torch.from_numpy(v) for k, v in tree.items()}, kt, kind, param)
    assert len(mt) == len(mj) == tc.MATERIAL_ARITY[kind]
    for j, (a, b) in enumerate(zip(mj, mt)):
        for name in tree:
            want, got = np.asarray(a[name]), b[name].numpy()
            assert got.shape == want.shape and got.dtype == np.float32
            if kind == "qsgd" and j == 1:           # the per-leaf norm
                np.testing.assert_allclose(got, want, rtol=1e-6)
            else:
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,param", KINDS)
def test_single_client_material_matches_reference(kind, param):
    tree = {k: v[0] for k, v in _tree(1, seed=2).items()}
    mj = jc.compression_material({k: jnp.asarray(v) for k, v in tree.items()},
                                 jax.random.PRNGKey(9), kind, param)
    mt = tc.compression_material({k: torch.from_numpy(v) for k, v in tree.items()},
                                 rng.PRNGKey(9), kind, param)
    for a, b in zip(mj, mt):
        for name in tree:
            np.testing.assert_allclose(b[name].numpy(), np.asarray(a[name]), rtol=1e-6, atol=0)


@pytest.mark.parametrize("d,frac", [(1, 0.5), (97, 0.1), (1000, 0.25), (58430, 0.1)])
def test_rand_k_gain_bitwise(d, frac):
    want = np.asarray(jc._rand_k_gain(jax.random.PRNGKey(d), d, frac))
    got = tc._rand_k_gain(rng.PRNGKey(d), d, frac).numpy()
    np.testing.assert_array_equal(got, want)


# --- apply_compression_flat ---------------------------------------------------

def _flat_inputs(kind, param, seed):
    r = np.random.default_rng(seed)
    x = np.concatenate([r.normal(size=400).astype(np.float32) * 1e-2, _special_values()])
    x = x.reshape(1, -1)
    kj = jax.random.split(jax.random.PRNGKey(seed), 1)
    mats = jax.vmap(lambda u, k: jc.compression_material(u, k, kind, param))(
        jnp.asarray(x), kj)
    return x, [np.array(m) for m in mats]


@pytest.mark.parametrize("kind,param", KINDS + [("qsgd", 1.0), ("qsgd", 5.0)])
def test_apply_compression_flat_matches_reference(kind, param):
    x, mats = _flat_inputs(kind, param, seed=4)
    want = np.asarray(jc.apply_compression_flat(jnp.asarray(x), kind, param,
                                                *map(jnp.asarray, mats)))
    got = tc.apply_compression_flat(torch.from_numpy(x), kind, param,
                                    *map(torch.from_numpy, mats)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    normal = (np.abs(x) >= TINY) | (x == 0)
    if kind == "natural":
        np.testing.assert_allclose(got[normal], want[normal], rtol=2e-6, atol=0)
    else:
        np.testing.assert_array_equal(got[normal], want[normal])
    # subnormal inputs: XLA:CPU reads them as zero, so the reference
    # compresses them to 0; the port computes on their values
    sub = ~normal
    assert sub.sum() >= 6 and np.all(want[sub] == 0)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=TINY * 4)
    if kind == "randk":
        np.testing.assert_array_equal(got[sub], x[sub] * mats[0][sub])
    elif kind == "natural":
        assert set(np.abs(got[sub])) <= {np.float32(0), TINY}
    else:
        assert np.all(got[sub] == 0)


def test_exp2_quirk_is_within_the_natural_tolerance():
    """Why natural is compared at rtol 2e-6: at the integers [-40, 10) torch's
    ``exp2`` is exact while XLA:CPU's misses 2**k at 27 of them, by at most
    1.01e-6 relative; ``floor(log2(x))`` agrees between the two."""
    k = np.arange(-40, 10).astype(np.float32)
    exact = np.float32(2.0) ** k
    np.testing.assert_array_equal(torch.exp2(torch.from_numpy(k)).numpy(), exact)
    rel = np.abs(np.asarray(jnp.exp2(jnp.asarray(k))) / exact - 1)
    assert 0 < rel.max() < 2e-6
    x = (2.0 ** np.random.default_rng(0).uniform(-20, 2, 10**5)).astype(np.float32)
    np.testing.assert_array_equal(torch.floor(torch.log2(torch.from_numpy(x))).numpy(),
                                  np.asarray(jnp.floor(jnp.log2(jnp.asarray(x)))))


def test_apply_compression_tree_matches_reference():
    tree = _tree(4, seed=5)
    kj, kt = _keys(4, 6)
    for kind, param in KINDS:
        mj = jax.vmap(lambda u, k: jc.compression_material(u, k, kind, param))(
            {k: jnp.asarray(v) for k, v in tree.items()}, kj)
        want = jc.apply_compression({k: jnp.asarray(v) for k, v in tree.items()}, mj, kind,
                                    param)
        mt = tuple({k: torch.from_numpy(np.array(m[k])) for k in tree} for m in mj)
        got = tc.apply_compression({k: torch.from_numpy(v) for k, v in tree.items()}, mt,
                                   kind, param)
        for name in tree:
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       rtol=2e-6, atol=0)


# --- the reference's properties, on the port --------------------------------

def test_randk_frac_extremes():
    """frac=1 keeps everything bitwise; a vanishing frac keeps exactly one
    coordinate, scaled by d."""
    d = 97
    x = torch.from_numpy(np.random.default_rng(0).normal(size=d).astype("f4"))
    key = rng.PRNGKey(2)
    assert torch.equal(tc.rand_k_leaf(x, 1.0, key), x)
    tiny = tc.rand_k_leaf(x, 1e-9, key).numpy()
    nz = np.flatnonzero(tiny)
    assert nz.size == 1
    np.testing.assert_allclose(tiny[nz], x.numpy()[nz] * d, rtol=1e-6)


@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5])
def test_randk_exact_k(frac):
    d = 1000
    out = tc.rand_k_leaf(torch.ones(d), frac, rng.PRNGKey(9)).numpy()
    assert np.count_nonzero(out) == int(d * frac)


def test_qsgd_single_level():
    """levels=1: every coordinate quantizes to 0 or +-||x||, unbiased over
    the uniform draws."""
    x = torch.from_numpy(np.random.default_rng(4).normal(size=256).astype("f4"))
    out = tc.qsgd_leaf(x, 1, rng.PRNGKey(3)).numpy()
    nrm = float(torch.linalg.norm(x))
    mags = np.abs(out)
    assert np.all((mags < 1e-6) | np.isclose(mags, nrm, rtol=1e-5))
    means = np.mean([tc.qsgd_leaf(x, 1, rng.PRNGKey(i)).numpy() for i in range(400)], axis=0)
    np.testing.assert_allclose(means, x.numpy(), atol=0.25 * nrm)


def test_natural_fixed_points_and_denormals():
    """Powers of two are fixed points; subnormals round to {0, +-2**-126}."""
    pows = torch.tensor([1.0, -2.0, 0.25, -0.125, 4096.0])
    assert torch.equal(tc.natural_leaf(pows, rng.PRNGKey(0)), pows)
    den = torch.tensor([1e-40, -1e-40, 5e-39])
    out = np.abs(tc.natural_leaf(den, rng.PRNGKey(1)).numpy())
    assert set(out) <= {np.float32(0.0), TINY}


@pytest.mark.parametrize("kind,param", KINDS)
def test_zero_padding_is_exact_zero(kind, param):
    z = torch.zeros((3, 64))
    zmats = tuple(torch.zeros((3, 64)) for _ in range(tc.MATERIAL_ARITY[kind]))
    out = tc.apply_compression_flat(z, kind, param, *zmats)
    assert torch.equal(out, torch.zeros((3, 64))) and not bool(torch.signbit(out).any())


@pytest.mark.parametrize("kind,param", KINDS)
def test_material_apply_equals_leaf_fns(kind, param):
    """material + apply == compress_update == the one-shot leaf functions,
    bitwise."""
    r5, r6 = np.random.default_rng(5), np.random.default_rng(6)
    tree = {"a": torch.from_numpy(r5.normal(size=(7, 5)).astype("f4")),
            "b": torch.from_numpy(r6.normal(size=11).astype("f4"))}
    key = rng.PRNGKey(13)
    whole = tc.compress_update(tree, key, kind, param)
    leaf_fn = {"randk": lambda k, x: tc.rand_k_leaf(x, param, k),
               "qsgd": lambda k, x: tc.qsgd_leaf(x, param, k),
               "natural": lambda k, x: tc.natural_leaf(x, k)}[kind]
    keys = rng.split(key, 2)
    manual = {"a": leaf_fn(keys[0], tree["a"]), "b": leaf_fn(keys[1], tree["b"])}
    for name in tree:
        assert torch.equal(whole[name], manual[name])


@pytest.mark.parametrize("kind,param", KINDS)
def test_compress_update_matches_reference(kind, param):
    tree = {k: v[0] for k, v in _tree(1, seed=7).items()}
    want = jc.compress_update({k: jnp.asarray(v) for k, v in tree.items()},
                              jax.random.PRNGKey(21), kind, param)
    got = tc.compress_update({k: torch.from_numpy(v) for k, v in tree.items()},
                             rng.PRNGKey(21), kind, param)
    for name in tree:
        if kind == "randk":
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        else:       # the qsgd norm is a float reduction; natural's exp2
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                       rtol=2e-6, atol=0)


# --- billing ------------------------------------------------------------------

@pytest.mark.parametrize("kind,param", [("none", 0.0)] + KINDS + [("randk", 0.1), ("qsgd", 3)])
def test_compressed_billing_matches_reference(kind, param):
    for dim in (1, 2, 97, 58430):
        assert tc.compressed_bits_per_update(dim, kind, param) == \
            jc.compressed_bits_per_update(dim, kind, param)
    mask = np.array([1, 0, 1, 1, 0, 0, 0, 1], bool)
    for sampler in ("full", "uniform", "optimal", "aocs"):
        assert bits.BitsLedger(58430).round_bits(mask, sampler, 8, 4, kind, param) == \
            j_bits.BitsLedger(58430).round_bits(mask, sampler, 8, 4, kind, param)
