"""The char-LM slice against the reference: the ``charlm`` dataset factory
and the ``gru_lm`` model.

* ``charlm`` datasets are bitwise the reference's (the registry's reduced
  pool, and full-size clients at the factory's defaults);
* ``gru_lm``'s ``init`` draws the reference's weights from the same key,
  leaf for leaf in the same nested layout (rtol 1e-6: ``normal`` agrees to
  float32 rounding);
* on converted parameters, loss, gradients and accuracy agree to rtol 1e-5
  (atol 1e-6 for the gradients; torch's and XLA's CPU products sum in
  different orders);
* the one-hot embedding is exactly ``table[tokens]`` in the forward pass.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as j_synth
from repro.models.simple import gru_lm as j_gru_lm
from repro.sim import scenarios as j_scenarios
from repro_torch import rng
from repro_torch.convert import params_from_jax
from repro_torch.data import synthetic
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models.simple import embed_tokens, gru_lm
from repro_torch.sim import scenarios


def _same_dataset(dj, dt):
    assert (dj.n_clients, dj.num_classes, dj.input_dim) == (dt.n_clients, dt.num_classes,
                                                            dt.input_dim)
    for a, b in zip(dj.client_data, dt.client_data):
        assert set(a) == set(b) == {"tokens", "targets"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_charlm_reduced_pool_bitwise():
    assert synthetic.CHARLM_VOCAB == j_synth.CHARLM_VOCAB == 86
    _same_dataset(j_scenarios.get_scenario("charlm-fedavg-aocs").build_dataset(reduced=True),
                  scenarios.get_scenario("charlm-fedavg-aocs").build_dataset(reduced=True))


def test_charlm_full_size_clients_bitwise():
    # the full pool's first clients at the factory's defaults (800 chars a client)
    _same_dataset(j_synth.charlm(n_clients=3, seed=3), synthetic.charlm(n_clients=3, seed=3))


def _batch(gen, b=4, t=5, vocab=86):
    return {"tokens": gen.integers(0, vocab, (b, t)).astype(np.int32),
            "targets": gen.integers(0, vocab, (b, t)).astype(np.int32)}


@pytest.mark.parametrize("layers", (1, 2))
def test_gru_lm_init_matches_reference(layers):
    ji, _, _ = j_gru_lm(86, hidden=16, layers=layers, embed=8)
    ti, _, _ = gru_lm(86, hidden=16, layers=layers, embed=8)
    pj = ji(jax.random.fold_in(jax.random.PRNGKey(1), 1))
    pt = ti(rng.fold_in(rng.PRNGKey(1), 1))
    assert set(pt) == set(pj) == {"embed", "out", "out_b"} | {f"gru{i}" for i in range(layers)}
    for i in range(layers):
        assert set(pt[f"gru{i}"]) == {"wx", "wh", "b"}
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("layers", (2,))
def test_gru_lm_loss_grads_accuracy_match_reference(layers):
    ji, jl, ja = j_gru_lm(86, hidden=16, layers=layers, embed=8)
    _, tl, ta = gru_lm(86, hidden=16, layers=layers, embed=8)
    pj = ji(jax.random.PRNGKey(4))
    pt = params_from_jax(jax.device_get(pj))
    gen = np.random.default_rng(7)
    for _ in range(2):
        b = _batch(gen)
        bj = {k: jnp.asarray(v) for k, v in b.items()}
        bt = {k: torch.as_tensor(v) for k, v in b.items()}
        (lj, _), gj = jax.value_and_grad(jl, has_aux=True)(pj, bj)
        gt, (lt, _) = torch.func.grad_and_value(tl, has_aux=True)(pt, bt)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
        for a, c in zip(tree_leaves(gt), jax.tree_util.tree_leaves(gj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(ta(pt, bt)), float(ja(pj, bj)), rtol=1e-5)


def test_one_hot_embedding_is_exact():
    gen = np.random.default_rng(2)
    table = torch.as_tensor(gen.normal(size=(86, 8)).astype(np.float32))
    tokens = torch.as_tensor(gen.integers(0, 86, (3, 4, 5)).astype(np.int32))
    assert torch.equal(embed_tokens(table, tokens), table[tokens.long()])
