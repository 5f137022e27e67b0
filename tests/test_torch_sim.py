"""The port's slice as a whole against the reference: reduced scenario runs.

``run_scenario(name, reduced=True, mode="host", rounds=3)`` on both packages
(the femnist and charlm cells), the port on the CPU from the reference's
initial parameters (``convert.params_from_jax`` through ``init_fn``):

* the ``sent`` series and the per-round masks are equal;
* the ``loss`` series agrees to rtol 1e-4 (three rounds compound float32
  sum-order differences between torch's and XLA's CPU kernels);
* the port's ledger passes both packages' ``validate_ledger``;
* the port's registry cells equal the reference's field for field;
* with ``device=None`` the port raises when there is no CUDA device;
* a sharded cell (the mesh round, at one rank here) draws the masks and
  bills the uplink bits of the same cell unsharded and of the reference's
  run, and its parameters equal the unsharded run's bitwise;
* every registered cell runs under the default ``mode="prefetch"``, its
  ledger minus ``wall_ms`` and its parameters bitwise ``mode="host"``'s
  (a sharded cell on a world-size-1 mesh, from the sharded pool), and the
  ledger carries the pool's bytes;
* every registered cell that needs no mesh runs under ``mode="scan"`` at
  ``rounds=5, rounds_per_scan=2`` (a remainder block), its ledger minus the
  timing fields and its parameters bitwise host's and prefetch's; its masks
  equal the reference's scan mode's and its parameters agree with the
  reference's at the parity tolerance above; at ``rounds_per_scan=3`` the
  eval grid's ``acc_rounds`` are prefetch's and the reference's;
* a 4-rank gloo mesh (``spawn_mesh``) runs prefetch from the sharded pool,
  its ledger minus timing and its parameters bitwise the same ranks' host run.
"""

import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.sim import driver as j_driver
from repro.sim import scenarios as j_scenarios
from repro_torch.convert import params_from_jax
from repro_torch.kernels.ops import tree_leaves
from repro_torch.sim import driver, scenarios

CELLS = ("femnist1-fedavg-aocs-pallas", "femnist1-dsgd-optimal", "charlm-fedavg-aocs",
         "charlm-fedavg-uniform")


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
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
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
        "charlm-fedavg-aocs", "charlm-fedavg-uniform",
        "femnist1-fedavg-aocs-q0.7", "femnist1-fedavg-aocs-pallas",
        "femnist1-fedavg-aocs-randk", "femnist1-fedavg-aocs-scan",
        "femnist1-fedavg-aocs-shard", "femnist1-fedavg-aocs-shard-randk",
        "femnist1-fedavg-aocs-shard-q0.7-natural",
    ])
    for name in scenarios.list_scenarios():
        assert dataclasses.asdict(scenarios.get_scenario(name)) == dataclasses.asdict(
            j_scenarios.get_scenario(name))
        assert dataclasses.asdict(scenarios.get_scenario(name).reduced()) == dataclasses.asdict(
            j_scenarios.get_scenario(name).reduced())
    for name in ("femnist1-fedavg-aocs-straggler-scan", "femnist1-fedavg-aocs-straggler-shard",
                 "femnist1-fedavg-threshold-shard", "femnist1-fedavg-cyclic-shard"):
        with pytest.raises(KeyError, match="not ported yet"):
            scenarios.get_scenario(name)


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


@pytest.mark.parametrize("kw", (dict(obs=object()), dict(checkpoint="x"), dict(resume="x")),
                         ids=("obs", "checkpoint", "resume"))
def test_unported_modes_and_options_raise(kw):
    # the mesh (tests/test_torch_shard_round.py and below) and the prefetch
    # and scan modes (below) are ported
    with pytest.raises(NotImplementedError, match="not ported"):
        driver.run_scenario("femnist1-fedavg-aocs", reduced=True, rounds=1,
                            device="cpu", **kw)


def test_rounds_per_scan_is_checked_as_the_reference_does():
    with pytest.raises(ValueError, match="rounds_per_scan"):
        driver.run_scenario("femnist1-fedavg-aocs", reduced=True, rounds=1, device="cpu",
                            mode="scan", rounds_per_scan=0)
    with pytest.raises(ValueError, match="unknown sim mode"):
        driver.run_scenario("femnist1-fedavg-aocs", reduced=True, rounds=1, device="cpu",
                            mode="pipelined")


def _timing_free(ledger):
    doc = copy.deepcopy(ledger.to_json(include_masks=True))
    doc["metrics"].pop("wall_ms")
    for key in ("mode", "wall_s", "rounds_per_sec"):
        doc.pop(key)
    doc["workload"].pop("pool_bytes", None)
    doc["workload"].pop("rounds_per_scan", None)
    return doc


@pytest.mark.parametrize("name", scenarios.list_scenarios())
def test_prefetch_matches_host(name):
    # the default mode: the pool on the device, round k+1's gather
    # dispatched before round k's step; bitwise the host loop's run
    ph, lh = driver.run_scenario(name, reduced=True, rounds=3, device="cpu", mode="host")
    pp, lp = driver.run_scenario(name, reduced=True, rounds=3, device="cpu")
    assert lp.mode == "prefetch" and lh.mode == "host"
    assert _timing_free(lp) == _timing_free(lh)
    assert len(lp.wall_ms) == 3 and "pool_bytes" not in lh.workload
    sc = scenarios.get_scenario(name).reduced()
    ds = sc.build_dataset(reduced=True)
    assert lp.workload["pool_bytes"] == sum(
        len(ds.client_data) * int(ds.sizes().max()) * v[0].nbytes
        for v in ds.client_data[0].values())
    for a, b in zip(tree_leaves(pp), tree_leaves(ph)):
        assert torch.equal(a, b)
    assert lp.workload.get("mesh_axis_size") == (1 if sc.sharded else None)
    driver.validate_ledger(lp.to_json())
    j_driver.validate_ledger(lp.to_json())


SHARD_CELL = "femnist1-fedavg-aocs-shard-randk"


def test_sharded_cell_matches_unsharded_cell_and_reference():
    sc = j_scenarios.get_scenario(SHARD_CELL).reduced()
    ds = sc.build_dataset(reduced=True)
    init, _, _ = sc.build_model(ds)
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(sc.seed), 1)))
    init_t = lambda key: params_from_jax(p0, key.device)
    _, lj = j_driver.run_scenario(SHARD_CELL, reduced=True, mode="host", rounds=2)
    pt, lt = driver.run_scenario(SHARD_CELL, reduced=True, rounds=2, device="cpu",
                                 init_fn=init_t)
    unsharded = scenarios.get_scenario(SHARD_CELL).with_(sharded=False)
    pu, lu = driver.run_scenario(unsharded, reduced=True, rounds=2, device="cpu",
                                 init_fn=init_t)
    assert not torch.distributed.is_initialized()      # the run closed its mesh
    doc = lt.to_json(include_masks=True)
    driver.validate_ledger(doc)
    j_driver.validate_ledger(doc)
    assert lt.workload["mesh_axis_size"] == lj.workload["mesh_axis_size"] == 1
    assert "mesh_axis_size" not in lu.workload
    for other in (lu, lj):
        assert len(other.masks) == len(lt.masks) == 2
        for a, b in zip(lt.masks, other.masks):
            np.testing.assert_array_equal(a, np.asarray(b))
        assert lt.uplink_bits == other.uplink_bits and lt.sent == other.sent
    np.testing.assert_allclose(lt.loss, lj.loss, rtol=1e-4)
    # one rank: the mesh round is the vmap engine's round, bitwise
    assert lt.loss == lu.loss
    for k in pt:
        assert torch.equal(pt[k], pu[k])


def test_sharded_cell_rejects_scan_mode():
    with pytest.raises(ValueError, match="mesh"):
        driver.run_scenario(SHARD_CELL, reduced=True, rounds=1, mode="scan", device="cpu")
    sc = scenarios.get_scenario(SHARD_CELL).reduced()
    ds = sc.build_dataset(reduced=True)
    init, loss, _ = sc.build_model(ds)
    mesh = driver.build_client_mesh(sc.fl, device="cpu")
    try:
        with pytest.raises(ValueError, match="mesh"):
            driver.run_simulation(ds, init, loss, sc.fl, 1, mode="scan", mesh=mesh)
    finally:
        mesh.close()


UNSHARDED = [n for n in scenarios.list_scenarios() if not scenarios.get_scenario(n).sharded]
SCAN_CELLS = ("femnist1-fedavg-aocs-scan", "femnist1-fedavg-aocs-randk", "charlm-fedavg-aocs")


@pytest.mark.parametrize("name", UNSHARDED)
def test_scan_matches_host_and_prefetch(name):
    # blocks of 2, 2 and 1 rounds: the remainder block runs
    ph, lh = driver.run_scenario(name, reduced=True, rounds=5, device="cpu", mode="host")
    pp, lp = driver.run_scenario(name, reduced=True, rounds=5, device="cpu", mode="prefetch")
    ps, ls = driver.run_scenario(name, reduced=True, rounds=5, device="cpu", mode="scan",
                                 rounds_per_scan=2)
    assert ls.mode == "scan"
    assert _timing_free(ls) == _timing_free(lh) == _timing_free(lp)
    for a, b, c in zip(tree_leaves(ps), tree_leaves(ph), tree_leaves(pp)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert ls.workload["rounds_per_scan"] == 2
    assert ls.workload["pool_bytes"] == lp.workload["pool_bytes"]
    assert list(ls.workload).index("rounds_per_scan") < list(ls.workload).index("pool_bytes")
    # each round's wall_ms is its block's time over its span
    assert ls.wall_ms[0] == ls.wall_ms[1] and ls.wall_ms[2] == ls.wall_ms[3]
    assert ls.rounds_per_sec > 0
    driver.validate_ledger(ls.to_json())
    j_driver.validate_ledger(ls.to_json())


@pytest.mark.parametrize("name", SCAN_CELLS)
def test_scan_masks_match_reference_scan(name):
    sc = j_scenarios.get_scenario(name).reduced()
    ds = sc.build_dataset(reduced=True)
    init, _, _ = sc.build_model(ds)
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(sc.seed), 1)))
    pj, lj = j_driver.run_scenario(name, reduced=True, mode="scan", rounds=5, rounds_per_scan=2)
    pt, lt = driver.run_scenario(name, reduced=True, mode="scan", rounds=5, rounds_per_scan=2,
                                 device="cpu",
                                 init_fn=lambda key: params_from_jax(p0, key.device))
    assert len(lt.masks) == len(lj.masks) == 5
    for a, b in zip(lt.masks, lj.masks):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert lt.sent == lj.sent and lt.uplink_bits == lj.uplink_bits
    assert lt.workload == {**lj.workload, "backend_platform": "cpu"}
    np.testing.assert_allclose(lt.loss, lj.loss, rtol=1e-4)
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_scan_blocks_keep_the_eval_grid():
    # the reference's test_sim property: blocks of up to 3 rounds end on
    # the eval_every grid, so acc_rounds are prefetch's and the reference's
    name = "femnist1-fedavg-aocs"
    sc = j_scenarios.get_scenario(name).reduced()
    dj = sc.build_dataset(reduced=True)
    j_init, j_loss, j_acc = sc.build_model(dj)
    p0 = jax.device_get(j_init(jax.random.fold_in(jax.random.PRNGKey(sc.seed), 1)))
    ev = {k: v[:64] for k, v in dj.client_data[0].items()}
    kw = dict(batch_size=sc.batch_size, eval_every=4, seed=sc.seed)
    _, lj = j_driver.run_simulation(dj, j_init, j_loss, sc.fl, 10, mode="scan",
                                    rounds_per_scan=3, eval_fn=jax.jit(j_acc),
                                    eval_batch={k: jax.numpy.asarray(v) for k, v in ev.items()},
                                    **kw)
    t_sc = scenarios.get_scenario(name).reduced()
    dt = t_sc.build_dataset(reduced=True)
    _, t_loss, t_acc = t_sc.build_model(dt)
    t_init = lambda key: params_from_jax(p0, key.device)
    runs = {mode: driver.run_simulation(dt, t_init, t_loss, t_sc.fl, 10, mode=mode,
                                        rounds_per_scan=3, eval_fn=t_acc, eval_batch=ev,
                                        device="cpu", **kw)[1]
            for mode in ("scan", "prefetch")}
    assert runs["scan"].acc_rounds == runs["prefetch"].acc_rounds == lj.acc_rounds == [0, 4, 8, 9]
    assert runs["scan"].acc == runs["prefetch"].acc
    np.testing.assert_allclose(runs["scan"].acc, lj.acc, rtol=1e-4)
    # spans 1 | 3 | 1 | 3 | 1 | 1: block times repeat within a block only
    w = runs["scan"].wall_ms
    assert w[1] == w[2] == w[3] and w[5] == w[6] == w[7]


def test_scan_with_a_system_config_raises():
    sc = scenarios.get_scenario("femnist1-fedavg-aocs").reduced()
    ds = sc.build_dataset(reduced=True)
    init, loss, _ = sc.build_model(ds)
    with pytest.raises(NotImplementedError, match="system"):
        driver.run_simulation(ds, init, loss, sc.fl, 2, mode="scan", system=object(),
                              device="cpu")


def _prefetch_and_host_rank(mesh, rounds):
    legs = {}
    for mode in ("host", "prefetch"):
        params, ledger = driver.run_scenario(SHARD_CELL, reduced=True, rounds=rounds, mesh=mesh,
                                             mode=mode, device="cpu")
        legs[mode] = ({k: v.clone() for k, v in params.items()}, _timing_free(ledger))
    return legs


def test_prefetch_on_four_ranks_matches_host():
    from repro_torch.fl.mesh import spawn_mesh

    ranks = spawn_mesh(_prefetch_and_host_rank, 4, "gloo", 240, device="cpu", args=(2,))
    for legs in ranks:
        (ph, dh), (pp, dp) = legs["host"], legs["prefetch"]
        assert dp == dh == ranks[0]["host"][1]
        assert dh["workload"]["mesh_axis_size"] == 4
        for k in ph:
            assert torch.equal(pp[k], ph[k]) and torch.equal(ph[k], ranks[0]["host"][0][k])
