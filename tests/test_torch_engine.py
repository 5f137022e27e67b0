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
    # the scan engine and compression are ported (tests/test_torch_scan_engine.py),
    # the mesh round (tests/test_torch_shard_round.py), which rejects a
    # server optimizer for good, as the reference does, and the server
    # optimizer (below); the diag step is ported (below).  The sampler zoo and
    # the availability trace, once refused here, are ported: a zoo sampler's
    # round draws the reference's mask and, when stateful, returns the
    # advanced SamplerState; an availability that is neither a number nor a
    # trace raises the reference's TypeError
    kw, batch, p0, jloss, tloss = _setup("fedavg")
    w = np.full((8,), 1 / 8, np.float32)
    for sampler in ("clustered", "cyclic", "threshold"):
        _, _, mt = engine.RoundEngine(tloss, FLConfig(**kw, sampler=sampler), device="cpu"
                                      ).make_step()(
            params_from_jax(p0), (), {k: torch.as_tensor(v) for k, v in batch.items()},
            torch.from_numpy(w), rng.PRNGKey(11))
        _, _, mj = j_engine.RoundEngine(jloss, JFLConfig(**kw, sampler=sampler)).make_step()(
            p0, (), {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(w),
            jax.random.PRNGKey(11))
        np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
        if sampler == "clustered":
            assert mt.sampler_state is None and mj.sampler_state is None
        else:
            assert int(mt.sampler_state.step) == int(mj.sampler_state.step) == 1
    with pytest.raises(ValueError, match="server_opt is not supported on the shard_map path"):
        engine.make_engine(tloss, FLConfig(**kw), server_opt=object(), mesh=object())
    for memory in ("vmap", "scan"):
        # the diag step, once refused, returns the round's Eq. 2 gap beside
        # the plain step's round (tests/test_torch_obs.py holds it against
        # the reference's)
        eng = engine.RoundEngine(tloss, FLConfig(**kw, round_engine=memory, scan_group=4),
                                 device="cpu")
        args = (params_from_jax(p0), (), {k: torch.as_tensor(v) for k, v in batch.items()},
                torch.from_numpy(w), rng.PRNGKey(11))
        _, _, md = eng.make_step(diag=True)(*args)
        _, _, mp = eng.make_step()(*args)
        assert mp.gap is None and torch.equal(md.mask, mp.mask)
        assert float(md.gap.full_sq) > 0.0 and bool(torch.isfinite(md.gap.gap_sq))
    u = torch.ones((8,))
    with pytest.raises(TypeError):
        ocs.sampling_plan(u, u / 8, 3, rng.PRNGKey(0), availability=object())
    with pytest.raises(TypeError):
        j_ocs.sampling_plan(jnp.ones((8,)), jnp.ones((8,)) / 8, 3, jax.random.PRNGKey(0),
                            availability=object())


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


def _parity_workload():
    # the reference's tests/conftest.py::parity_workload (n=8, din=12, 3 classes)
    init, jloss, _ = j_mlp(12, 3, hidden=8)
    _, tloss, _ = mlp_classifier(12, 3, hidden=8)
    r = np.random.default_rng(1)
    batch = {"x": r.normal(size=(8, 2, 4, 12)).astype("float32"),
             "y": r.integers(0, 3, (8, 2, 4)).astype("int32")}
    return init, jloss, tloss, batch


@pytest.mark.parametrize("memory,backend,cache_groups,opt", (
    ("vmap", "jnp", None, "sgd-momentum"), ("scan", "pallas", 1, "sgd-momentum"),
    ("vmap", "pallas", None, "adam"), ("scan", "jnp", 0, "adam")))
def test_server_optimizer_matches_reference(memory, backend, cache_groups, opt):
    # the reference's test_engine_matrix_parity_server_opt, port against reference:
    # three rounds of a stateful server optimizer on each engine, the same masks
    # and final parameters within its atol 1e-5
    from repro.optim import adam as j_adam
    from repro.optim import sgd as j_sgd
    from repro_torch.optim import adam, sgd

    init, jloss, tloss, batch = _parity_workload()
    kw = dict(n_clients=8, expected_clients=3, sampler="optimal", local_steps=2, lr_local=0.1)
    make = {"sgd-momentum": (lambda: j_sgd(0.5, momentum=0.9), lambda: sgd(0.5, momentum=0.9)),
            "adam": (lambda: j_adam(0.01), lambda: adam(0.01))}[opt]
    oj, ot = make[0](), make[1]()
    ekw = dict(memory=memory, backend=backend, scan_group=2, cache_groups=cache_groups)
    jstep = j_engine.RoundEngine(jloss, JFLConfig(**kw), oj, interpret=True, **ekw).make_step()
    tstep = engine.RoundEngine(tloss, FLConfig(**kw), ot, device="cpu", **ekw).make_step()
    pj = init(jax.random.PRNGKey(0))
    pt = params_from_jax(jax.device_get(pj))
    sj, st = oj.init(pj), ot.init(pt)
    bj = {k: jnp.asarray(v) for k, v in batch.items()}
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    wj, wt = jnp.full((8,), 1 / 8, jnp.float32), client_weights(FLConfig(**kw), device="cpu")
    key_j, key_t = jax.random.PRNGKey(11), rng.PRNGKey(11)
    for k in range(3):
        pj, sj, mj = jstep(pj, sj, bj, wj, jax.random.fold_in(key_j, k))
        pt, st, mt = tstep(pt, st, bt, wt, rng.fold_in(key_t, k))
        np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    for name in pj:
        np.testing.assert_allclose(pt[name].numpy(), np.asarray(pj[name]), atol=1e-5)
    if opt == "adam":
        assert int(st["t"]) == int(sj["t"]) == 3


@pytest.mark.parametrize("algorithm", ("fedavg",))
def test_local_update_of_a_nested_tree_matches_reference(algorithm):
    # gru_lm's parameters nest (gru0: {wx, wh, b}): the local update maps
    # leaf by leaf and keeps the nesting
    from repro.models.simple import gru_lm as j_gru_lm
    from repro_torch.models.simple import gru_lm

    kw = dict(n_clients=4, expected_clients=2, local_steps=3 if algorithm == "fedavg" else 1,
              algorithm=algorithm, lr_local=0.5)
    init, jloss, _ = j_gru_lm(86, hidden=8, layers=2, embed=4)
    _, tloss, _ = gru_lm(86, hidden=8, layers=2, embed=4)
    r = np.random.default_rng(6)
    steps = kw["local_steps"]
    batch = {"tokens": r.integers(0, 86, (4, steps, 2, 5)).astype(np.int32),
             "targets": r.integers(0, 86, (4, steps, 2, 5)).astype(np.int32),
             "_step_mask": np.array([[1, 1, 0][:steps]] * 4, np.float32)}
    p0 = jax.device_get(init(jax.random.PRNGKey(2)))
    jlu = j_engine.make_local_update(jloss, JFLConfig(**kw))
    tlu = engine.make_local_update(tloss, FLConfig(**kw))
    uj, lj = jax.vmap(jlu, in_axes=(None, 0))(p0, {k: jnp.asarray(v) for k, v in batch.items()})
    ut, lt = vmap(tlu, in_dims=(None, 0))(params_from_jax(p0),
                                          {k: torch.as_tensor(v) for k, v in batch.items()})
    _close(lt, lj)
    assert set(ut["gru1"]) == {"wx", "wh", "b"}
    leaves_j = jax.tree_util.tree_leaves(uj)
    from repro_torch.kernels.ops import tree_leaves

    assert len(tree_leaves(ut)) == len(leaves_j) == 9
    for a, b in zip(tree_leaves(ut), leaves_j):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b)


def test_make_round_is_the_engine_step():
    # the reference's stable entry point: make_round(loss, fl, server_opt,
    # mode, scan_group, backend) overrides the config's engine axes
    from repro_torch.fl import make_round

    kw, batch, p0, _, tloss = _setup("fedavg")
    fl = FLConfig(**kw)
    bt = {k: torch.as_tensor(v) for k, v in batch.items()}
    wt = client_weights(fl, device="cpu")
    key = rng.fold_in(rng.PRNGKey(5), 1000)
    pa, _, ma = make_round(tloss, fl, mode="scan", scan_group=4, backend="pallas",
                           device="cpu")(params_from_jax(p0), (), bt, wt, key)
    pb, _, mb = engine.RoundEngine(tloss, fl, memory="scan", scan_group=4, backend="pallas",
                                   device="cpu").make_step()(params_from_jax(p0), (), bt, wt, key)
    assert torch.equal(ma.mask, mb.mask)
    for name in pa:
        assert torch.equal(pa[name], pb[name])
