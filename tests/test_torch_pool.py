"""The port's device-resident client pool against the reference's and the
host path (on the CPU).

* ``plan_cohort`` is bitwise the reference's and leaves the host generator
  in lockstep with it (the port's twin of the reference's
  ``test_pool_gather_matches_host_batches``);
* ``ClientPool.gather`` of a plan is bitwise ``sample_round_batches`` of the
  same generator state, for the femnist and charlm pools;
* the sharded pool on 4 gloo ranks (``spawn_mesh``, a pool of 22 clients
  padded to 24 rows): each rank holds its 6 rows, and its gather is bitwise
  its block of the replicated pool's gather and of the reference's
  ``gather_batch``; ``nbytes`` counts the reference's padded rows;
* ``nbytes`` equals the reference's pool's, and ``stack_plans`` its stacks;
* ``device=None`` means CUDA and raises without one.
"""

import numpy as np
import pytest
import torch

from repro.sim import pool as j_pool
from repro.sim import scenarios as j_scenarios
from repro_torch.sim import pool, scenarios

CELLS = ("femnist1-fedavg-aocs", "charlm-fedavg-aocs")


def _dataset(name):
    return scenarios.get_scenario(name).build_dataset(reduced=True)


@pytest.mark.parametrize("local_epoch", (True, False))
def test_plan_cohort_bitwise_and_rng_in_lockstep(local_epoch):
    ds = _dataset("femnist1-fedavg-aocs")
    clients = np.array([3, 0, 7, 11, 20])
    rj, rt = np.random.default_rng(5), np.random.default_rng(5)
    pj = j_pool.plan_cohort(rj, ds.sizes(), clients, 3, 4, local_epoch)
    pt = pool.plan_cohort(rt, ds.sizes(), clients, 3, 4, local_epoch)
    for a, b in zip(pt, pj):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert rt.integers(1 << 30) == rj.integers(1 << 30)


@pytest.mark.parametrize("name", CELLS)
def test_pool_gather_matches_host_batches(name):
    ds = _dataset(name)
    cpool = pool.ClientPool(ds, device="cpu")
    clients = np.array([3, 0, 7, 11])
    r_host, r_pool = np.random.default_rng(5), np.random.default_rng(5)
    host = ds.sample_round_batches(r_host, clients, 3, 4)
    batch, ready = cpool.gather(cpool.plan(r_pool, clients, 3, 4))
    assert ready is None
    batch = pool.claim_batch(batch, ready)
    assert set(host) == set(batch)
    for k in host:
        got = batch[k].numpy()
        assert got.dtype == host[k].dtype and got.shape == host[k].shape, k
        np.testing.assert_array_equal(got, host[k])
    assert r_host.integers(1 << 30) == r_pool.integers(1 << 30)


def _sharded_dataset():
    from repro_torch.data import femnist_like

    return femnist_like(1, n_clients=22, dim=48, num_classes=10, base_examples=24, seed=0)


def _sharded_rank(mesh, clients):
    ds = _sharded_dataset()
    spool = pool.ClientPool(ds, mesh=mesh, device="cpu")
    batch, ready = spool.gather(spool.plan(np.random.default_rng(2), clients, 2, 4))
    return {"batch": pool.claim_batch(batch, ready), "nbytes": spool.nbytes,
            "rows": {k: tuple(b.shape) for k, b in spool.buffers.items()},
            "local_bytes": sum(b.numel() * b.element_size() for b in spool.buffers.values())}


def test_pool_gathers_a_cohort_block():
    from repro_torch.fl.mesh import spawn_mesh

    ds = _sharded_dataset()
    clients = np.array([21, 3, 0, 7, 11, 20, 6, 14])     # every rank owns some
    ranks = spawn_mesh(_sharded_rank, 4, "gloo", 120, device="cpu", args=(clients,))
    cpool = pool.ClientPool(ds, device="cpu")
    plan = cpool.plan(np.random.default_rng(2), clients, 2, 4)
    whole, _ = cpool.gather(plan)
    dj = _sharded_dataset()
    want = j_pool.gather_batch(j_pool.ClientPool(dj).buffers, plan.clients, plan.take,
                               plan.step_mask)
    row_bytes = cpool.nbytes // ds.n_clients
    for r, out in enumerate(ranks):
        assert out["nbytes"] == 24 * row_bytes == 4 * out["local_bytes"]
        assert all(shape[0] == 6 for shape in out["rows"].values())
        assert set(out["batch"]) == set(whole)
        for k in whole:
            assert torch.equal(out["batch"][k], whole[k][2 * r:2 * r + 2]), k
            np.testing.assert_array_equal(out["batch"][k].numpy(),
                                          np.asarray(want[k])[2 * r:2 * r + 2])


@pytest.mark.parametrize("name", CELLS)
def test_pool_nbytes_and_buffers_match_reference(name):
    dj = j_scenarios.get_scenario(name).build_dataset(reduced=True)
    jp, tp = j_pool.ClientPool(dj), pool.ClientPool(_dataset(name), device="cpu")
    assert tp.nbytes == jp.nbytes
    assert tp.max_examples == jp.max_examples
    for k, buf in jp.buffers.items():
        np.testing.assert_array_equal(tp.buffers[k].numpy(), np.asarray(buf))


def test_stack_plans_and_gather_batch_match_reference():
    ds = _dataset("femnist1-fedavg-aocs")
    r = np.random.default_rng(9)
    plans = [pool.plan_cohort(r, ds.sizes(), r.choice(24, 4, replace=False), 2, 3)
             for _ in range(3)]
    for a, b in zip(pool.stack_plans(plans), j_pool.stack_plans(plans)):
        np.testing.assert_array_equal(a, b)
    cpool = pool.ClientPool(ds, device="cpu")
    p = plans[0]
    got = pool.gather_batch(cpool.buffers, torch.from_numpy(p.clients),
                            torch.from_numpy(p.take), torch.from_numpy(p.step_mask))
    want = j_pool.gather_batch(j_pool.ClientPool(ds).buffers, p.clients, p.take, p.step_mask)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert pool.STATE_FOLD == j_pool.STATE_FOLD


def test_pool_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pool.ClientPool(_dataset("femnist1-fedavg-aocs"))
