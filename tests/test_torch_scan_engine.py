"""The port's scan engine and compression axis against the reference's.

The single-device subset of the reference's engine-parity matrix
(``tests/conftest.py``): engines ``vmap`` and ``scan`` (``scan_group=4``,
``cache_groups`` None, 0 and 1), backends ``jnp`` and ``pallas`` (on the CPU
the port's kernel wrappers run their plain versions), variants ``plain``,
``randk``, ``qsgd``, ``natural``, ``avail`` and ``randk+avail``.  Every port
combo runs one round from the reference's parameters, batch and key, and is
held against the reference's oracle round (vmap + jnp):

* the participation mask bitwise, and ``round_bits_duplex`` equal;
* norms and probabilities to atol 1e-6 (torch's and XLA's CPU sums differ in
  order; natural compression also in ``exp2``'s last bits);
* the new parameters to atol 1e-5.

The reduced cells ``femnist1-fedavg-aocs-scan`` and
``femnist1-fedavg-aocs-randk`` run end to end in both packages: masks and
``sent`` equal, losses to rtol 1e-4, and the port's ledger passes the
reference's ``validate_ledger``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import PARITY_ORACLE, parity_fl, parity_workload, run_parity_combo

from repro.fl import engine as j_engine
from repro.fl.round import round_bits_duplex as j_round_bits_duplex
from repro.sim import driver as j_driver
from repro.sim import scenarios as j_scenarios
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.fl import engine
from repro_torch.fl.round import round_bits_duplex
from repro_torch.models.simple import mlp_classifier
from repro_torch.sim import driver

VARIANTS = ("plain", "randk", "qsgd", "natural", "avail", "randk+avail")
ENGINES = ([("vmap", be, None) for be in ("jnp", "pallas")]
           + [("scan", be, cg) for be in ("jnp", "pallas") for cg in (None, 0, 1)])


@functools.lru_cache(maxsize=None)
def _oracle(variant):
    """The reference's oracle round for one variant, as numpy."""
    init, loss, batch = parity_workload()
    fl = parity_fl(variant)
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    w = jnp.full((fl.n_clients,), 1.0 / fl.n_clients, jnp.float32)
    p, _, m = run_parity_combo(*PARITY_ORACLE, loss, fl, params, batch, w,
                               jax.random.PRNGKey(7))
    batch = {k: np.array(v) for k, v in batch.items()}
    return fl, params, batch, jax.device_get(p), jax.device_get(m)


@pytest.mark.parametrize("combo", ENGINES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("variant", VARIANTS)
def test_engine_matrix_parity(variant, combo):
    jfl, p0, batch, p_ref, m_ref = _oracle(variant)
    fl = FLConfig(**dataclasses.asdict(jfl))
    memory, backend, cache_groups = combo
    _, tloss, _ = mlp_classifier(12, 3, hidden=8)
    step = engine.RoundEngine(tloss, fl, memory=memory, backend=backend, scan_group=4,
                              cache_groups=cache_groups, device="cpu").make_step()
    w = torch.full((fl.n_clients,), 1.0 / fl.n_clients)
    pt, _, mt = step(params_from_jax(p0), (), {k: torch.from_numpy(v) for k, v in batch.items()},
                     w, rng.PRNGKey(7))
    assert int(np.sum(m_ref.mask)) > 0
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(m_ref.mask))
    dim = sum(v.size for v in p0.values())
    assert round_bits_duplex(fl, dim, mt.mask.numpy()) == \
        j_round_bits_duplex(jfl, dim, m_ref.mask)
    np.testing.assert_allclose(mt.norms.numpy(), m_ref.norms, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mt.probs.numpy(), m_ref.probs, rtol=0, atol=1e-6)
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), p_ref[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,g,cg", [(8, 4, None), (8, 4, 0), (8, 4, 1), (8, 2, 3),
                                    (32, 4, 4), (32, 4, 99)])
def test_local_update_evals_match_reference(n, g, cg):
    _, jloss, _ = parity_workload()
    _, tloss, _ = mlp_classifier(12, 3, hidden=8)
    kw = dict(n_clients=n, expected_clients=3)
    for memory in ("vmap", "scan"):
        want = j_engine.RoundEngine(jloss, parity_fl("plain", **kw), memory=memory,
                                    scan_group=g, cache_groups=cg).local_update_evals
        got = engine.RoundEngine(tloss, FLConfig(**dataclasses.asdict(parity_fl("plain", **kw))),
                                 memory=memory, scan_group=g, cache_groups=cg,
                                 device="cpu").local_update_evals
        assert got == want


def test_engine_validates_like_the_reference():
    _, tloss, _ = mlp_classifier(12, 3, hidden=8)
    fl = FLConfig(n_clients=8, expected_clients=3)
    for kw, match in ((dict(memory="stream"), "memory policy"),
                      (dict(backend="triton"), "aggregation backend"),
                      (dict(memory="scan", scan_group=3), "not divisible"),
                      (dict(cache_groups=-1), "cache_groups")):
        with pytest.raises(ValueError, match=match):
            engine.RoundEngine(tloss, fl, device="cpu", **kw)
    with pytest.raises(ValueError, match="compressor"):
        engine.RoundEngine(tloss, dataclasses.replace(fl, compression="topk"), device="cpu")


@pytest.mark.parametrize("name", ("femnist1-fedavg-aocs-scan", "femnist1-fedavg-aocs-randk"))
def test_reduced_cell_matches_reference(name):
    sc = j_scenarios.get_scenario(name).reduced()
    ds = sc.build_dataset(reduced=True)
    init, _, _ = sc.build_model(ds)
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(sc.seed), 1)))
    pj, lj = j_driver.run_scenario(name, reduced=True, mode="host", rounds=3)
    pt, lt = driver.run_scenario(name, reduced=True, mode="host", rounds=3, device="cpu",
                                 init_fn=lambda key: params_from_jax(p0, key.device))
    assert lt.sent == lj.sent and len(lt.masks) == 3
    for a, b in zip(lt.masks, lj.masks):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(lt.loss, lj.loss, rtol=1e-4)
    assert lt.uplink_bits == lj.uplink_bits and lt.downlink_bits == lj.downlink_bits
    assert lt.fl == lj.fl
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-4, atol=1e-6)
    doc = lt.to_json(include_masks=True)
    j_driver.validate_ledger(doc)
    driver.validate_ledger(doc)
