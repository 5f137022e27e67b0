"""One round of the port's vmap engine against the reference's.

From identical parameters (``convert.params_from_jax``), batch and round key,
for fedavg (R masked local SGD steps) and dsgd, backends ``jnp`` and
``pallas`` (on the CPU the port's kernel wrapper runs its plain version, the
reference's Pallas kernel runs in interpret mode), with and without partial
availability:

* per-client updates and losses agree to rtol 1e-5 / atol 1e-6 (torch's and
  XLA's CPU matmuls sum in different orders);
* norms and probabilities to the same tolerance;
* the participation mask bitwise;
* the aggregate and the new parameters to rtol 1e-5 / atol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from repro.configs.base import FLConfig as JFLConfig
from repro.core import ocs as j_ocs
from repro.data.synthetic import femnist_like
from repro.fl import engine as j_engine
from repro.models.simple import mlp_classifier as j_mlp
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core import ocs
from repro_torch.fl import engine
from repro_torch.fl.round import client_weights
from repro_torch.models.simple import mlp_classifier

TOL = dict(rtol=1e-5, atol=1e-6)


def _setup(algorithm, seed=3):
    ds = femnist_like(1, n_clients=24, dim=48, num_classes=10, base_examples=24, seed=0)
    kw = dict(n_clients=8, expected_clients=3, local_steps=3 if algorithm == "fedavg" else 1,
              algorithm=algorithm, lr_local=0.125, lr_global=0.5)
    r = np.random.default_rng(seed)
    clients = r.choice(ds.n_clients, size=8, replace=False)
    batch = ds.sample_round_batches(r, clients, kw["local_steps"], 4)
    init, jloss, _ = j_mlp(48, 10, hidden=16)
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(seed), 1)))
    _, tloss, _ = mlp_classifier(48, 10, hidden=16)
    return kw, batch, p0, jloss, tloss


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("algorithm", ("fedavg", "dsgd"))
def test_local_updates_match_reference(algorithm):
    kw, batch, p0, jloss, tloss = _setup(algorithm)
    jlu = j_engine.make_local_update(jloss, JFLConfig(**kw))
    tlu = engine.make_local_update(tloss, FLConfig(**kw))
    uj, lj = jax.vmap(jlu, in_axes=(None, 0))(p0, {k: jnp.asarray(v) for k, v in batch.items()})
    ut, lt = vmap(tlu, in_dims=(None, 0))(params_from_jax(p0),
                                          {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(lt, lj)
    for k in p0:
        assert ut[k].shape == tuple(uj[k].shape)
        _close(ut[k], uj[k])
    w = np.full((8,), 1 / 8, np.float32)
    _close(ocs.client_norms(ut, torch.from_numpy(w)),
           j_ocs.client_norms(uj, jnp.asarray(w)))


@pytest.mark.parametrize("availability", (1.0, 0.7))
@pytest.mark.parametrize("backend", ("jnp", "pallas"))
@pytest.mark.parametrize("algorithm", ("fedavg", "dsgd"))
def test_one_round_matches_reference(algorithm, backend, availability):
    kw, batch, p0, jloss, tloss = _setup(algorithm)
    jfl = JFLConfig(**kw, agg_backend=backend, availability=availability)
    tfl = FLConfig(**kw, agg_backend=backend, availability=availability)
    assert dataclasses.asdict(jfl) == dataclasses.asdict(tfl)
    jstep = j_engine.RoundEngine(jloss, jfl, interpret=True).make_step()
    tstep = engine.make_engine(tloss, tfl, device="cpu")
    wj = jnp.full((8,), 1 / 8, jnp.float32)
    wt = client_weights(tfl, device="cpu")
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    for k in range(1):
        kj = jax.random.fold_in(jax.random.PRNGKey(5), 1000 + k)
        kt = rng.fold_in(rng.PRNGKey(5), 1000 + k)
        pj, _, mj = jstep(p0, (), {bk: jnp.asarray(v) for bk, v in batch.items()}, wj, kj)
        pt, _, mt = tstep(params_from_jax(p0), (), {bk: torch.as_tensor(v) for bk, v in batch.items()},
                          wt, kt)
        np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
        assert int(mt.sent_clients) == int(mj.sent_clients)
        _close(mt.norms, mj.norms)
        _close(mt.probs, mj.probs)
        _close(mt.loss, mj.loss)
        _close(mt.alpha, mj.alpha)
        _close(mt.expected_clients, mj.expected_clients)
        for name in p0:
            # new params = params - lr_global * aggregate: both the aggregate
            # (difference / lr) and the params themselves agree
            _close(pt[name], pj[name])
            _close((params_from_jax(p0)[name] - pt[name]) / tfl.lr_global,
                   (p0[name] - np.asarray(pj[name])) / jfl.lr_global)


def test_unported_axes_raise():
    kw, _, _, _, tloss = _setup("fedavg")
    for bad in (dict(round_engine="scan"), dict(compression="randk")):
        with pytest.raises(NotImplementedError, match="not ported"):
            engine.RoundEngine(tloss, FLConfig(**kw, **bad), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        engine.RoundEngine(tloss, FLConfig(**kw), server_opt=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        engine.make_engine(tloss, FLConfig(**kw), mesh=object(), device="cpu")


def test_mlp_module_matches_reference_logits():
    from repro_torch.models.simple import MLPClassifier, mlp_init

    key = rng.fold_in(rng.PRNGKey(2), 1)
    module = MLPClassifier(48, 10, hidden=16, key=key)
    params = mlp_init(key, 48, 10, 16)
    assert sorted(dict(module.named_parameters())) == ["b1", "b2", "b3", "w1", "w2", "w3"]
    for name, p in module.named_parameters():
        torch.testing.assert_close(p.detach(), params[name], rtol=0, atol=0)
    assert module.w1.shape == (48, 16)       # jax layout: x @ w1 + b1
    x = np.random.default_rng(0).normal(size=(5, 48)).astype(np.float32)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    h = jax.nn.relu(jnp.asarray(x) @ jp["w1"] + jp["b1"])
    h = jax.nn.relu(h @ jp["w2"] + jp["b2"])
    want = h @ jp["w3"] + jp["b3"]
    _close(module(torch.from_numpy(x)).detach(), want)
