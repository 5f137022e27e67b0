"""The port's slice as a whole against the reference: reduced scenario runs.

``run_scenario(name, reduced=True, mode="host", rounds=3)`` on both packages,
the port on the CPU from the reference's initial parameters
(``convert.params_from_jax`` through ``init_fn``):

* the ``sent`` series and the per-round masks are equal;
* the ``loss`` series agrees to rtol 1e-4 (three rounds compound float32
  sum-order differences between torch's and XLA's CPU kernels);
* the port's ledger passes both packages' ``validate_ledger``;
* the port's registry cells equal the reference's field for field;
* with ``device=None`` the port raises when there is no CUDA device.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.sim import driver as j_driver
from repro.sim import scenarios as j_scenarios
from repro_torch.convert import params_from_jax
from repro_torch.sim import driver, scenarios

CELLS = ("femnist1-fedavg-aocs-pallas", "femnist1-dsgd-optimal")


@pytest.mark.parametrize("name", CELLS)
def test_reduced_scenario_matches_reference(name):
    sc = j_scenarios.get_scenario(name).reduced()
    ds = sc.build_dataset(reduced=True)
    init, _, _ = sc.build_model(ds)
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(sc.seed), 1)))
    pj, lj = j_driver.run_scenario(name, reduced=True, mode="host", rounds=3)
    pt, lt = driver.run_scenario(name, reduced=True, mode="host", rounds=3, device="cpu",
                                 init_fn=lambda key: params_from_jax(p0, key.device))
    assert lt.sent == lj.sent
    assert len(lt.masks) == len(lj.masks) == 3
    for a, b in zip(lt.masks, lj.masks):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(lt.loss, lj.loss, rtol=1e-4)
    assert lt.uplink_bits == lj.uplink_bits and lt.downlink_bits == lj.downlink_bits
    assert lt.fl == lj.fl
    assert lt.workload["model_dim"] == lj.workload["model_dim"]
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-4, atol=1e-6)
    doc = lt.to_json(include_masks=True)
    j_driver.validate_ledger(doc)
    driver.validate_ledger(doc)


def test_port_init_matches_reference_init():
    # without init_fn the port draws its own weights from the same key
    sc = j_scenarios.get_scenario("femnist1-fedavg-aocs").reduced()
    ds = sc.build_dataset(reduced=True)
    init, _, _ = sc.build_model(ds)
    pj = init(jax.random.fold_in(jax.random.PRNGKey(sc.seed), 1))
    t_sc = scenarios.get_scenario("femnist1-fedavg-aocs").reduced()
    t_init, _, _ = t_sc.build_model(t_sc.build_dataset(reduced=True))
    from repro_torch import rng

    pt = t_init(rng.fold_in(rng.PRNGKey(sc.seed), 1))
    for k in pj:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-6)


def test_registry_cells_equal_reference():
    assert scenarios.list_scenarios() == sorted([
        *(f"femnist{d}-fedavg-{s}" for d in (1, 2, 3) for s in ("full", "aocs", "uniform")),
        "femnist1-dsgd-optimal", "femnist1-dsgd-uniform", "cifar-fedavg-aocs",
        "femnist1-fedavg-aocs-q0.7", "femnist1-fedavg-aocs-pallas",
    ])
    for name in scenarios.list_scenarios():
        assert dataclasses.asdict(scenarios.get_scenario(name)) == dataclasses.asdict(
            j_scenarios.get_scenario(name))
        assert dataclasses.asdict(scenarios.get_scenario(name).reduced()) == dataclasses.asdict(
            j_scenarios.get_scenario(name).reduced())
    with pytest.raises(KeyError, match="not ported yet"):
        scenarios.get_scenario("femnist1-fedavg-aocs-scan")


@pytest.mark.parametrize("dataset", ("femnist2", "cifar"))
def test_datasets_and_batches_bitwise(dataset):
    name = {"femnist2": "femnist2-fedavg-aocs", "cifar": "cifar-fedavg-aocs"}[dataset]
    dj = j_scenarios.get_scenario(name).build_dataset(reduced=True)
    dt = scenarios.get_scenario(name).build_dataset(reduced=True)
    assert dj.n_clients == dt.n_clients and dj.num_classes == dt.num_classes
    for a, b in zip(dj.client_data, dt.client_data):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    bj = dj.sample_round_batches(np.random.default_rng(4), [0, 3, 5], 2, 4)
    bt = dt.sample_round_batches(np.random.default_rng(4), [0, 3, 5], 2, 4)
    for k in bj:
        np.testing.assert_array_equal(bj[k], bt[k])


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        driver.run_scenario("femnist1-fedavg-aocs-pallas", reduced=True, rounds=1)


def test_unported_modes_and_options_raise():
    for kw in (dict(mode="prefetch"), dict(mode="scan"), dict(obs=object()),
               dict(checkpoint="x"), dict(resume="x"), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="not ported"):
            driver.run_scenario("femnist1-fedavg-aocs", reduced=True, rounds=1,
                                device="cpu", **kw)
