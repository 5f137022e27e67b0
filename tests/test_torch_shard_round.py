"""The port's mesh round against the reference's shard_map round.

* ``validate_shard_config`` raises the reference's messages, before any key
  is split, any number drawn from the run's numpy generator or any process
  group opened; a ``server_opt`` with a mesh raises ``ValueError``.
* World size 1 (gloo, in this process): the port's round against the
  reference's ``make_shard_map_round`` on a one-device mesh, from the same
  weights (``convert.params_from_jax``), batch and key, for the variants
  plain, randk, qsgd, natural, avail and randk+avail on both backends —
  masks bitwise, norms atol 1e-6, params atol 1e-5 (the reference's own
  tolerances, ``tests/test_shard_round.py``); and against the port's own
  vmap engine, bitwise (every collective of one rank is the identity).
* World size 4: the reference on four emulated devices in a subprocess
  (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), the port on
  four gloo ranks (``spawn_mesh``), plain and randk on the pallas backend, at
  the same tolerances; every rank returns the same round.  Both runs have
  time limits.
* ``spawn_mesh``: ``device=None`` means CUDA and raises without a card;
  a rank that fails makes the call raise and kills the rank left waiting in
  a collective.

Every process group a test opens is closed in a fixture or a ``finally``.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from conftest import parity_fl, parity_workload, run_parity_combo

from repro.configs.base import FLConfig as JFLConfig
from repro.fl.shard_round import validate_shard_config as j_validate
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.fl.engine import make_engine
from repro_torch.fl.mesh import local_client_mesh, spawn_mesh
from repro_torch.fl.shard_round import make_shard_map_round, validate_shard_config
from repro_torch.kernels import ops
from repro_torch.models.simple import mlp_classifier
from repro_torch.sim import driver
from repro_torch.sim.scenarios import get_scenario

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
VARIANTS = ("plain", "randk", "qsgd", "natural", "avail", "randk+avail")
WORLD4_COMBOS = ("plain", "randk")          # on the pallas backend
WORLD4_TIMEOUT_S = 300


@pytest.fixture
def mesh1():
    mesh = local_client_mesh("cpu")
    try:
        yield mesh
    finally:
        mesh.close()


def _workload():
    """The reference's parity workload as numpy: (jax loss, params, batch)."""
    init, jloss, batch = parity_workload()
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    return jloss, params, {k: np.array(v) for k, v in batch.items()}


def _port_fl(jfl) -> FLConfig:
    return FLConfig(**dataclasses.asdict(jfl))


@pytest.mark.parametrize("kw,axis_size", [
    (dict(compression="gzip"), 1),
    (dict(agg_backend="cuda"), 1),
    (dict(n_clients=9), 2),
])
def test_validate_messages_match_reference(kw, axis_size):
    base = {"n_clients": 8, "expected_clients": 3, **kw}
    with pytest.raises(ValueError) as want:
        j_validate(JFLConfig(**base), axis_size)
    with pytest.raises(ValueError) as got:
        validate_shard_config(FLConfig(**base), axis_size)
    assert str(got.value) == str(want.value)


def test_rejected_config_draws_nothing_and_opens_no_group(monkeypatch):
    sc = get_scenario("femnist1-fedavg-aocs-shard").reduced()
    bad = dataclasses.replace(sc.fl, compression="gzip")
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="gzip"):
        driver.run_scenario(sc.with_(fl=bad), device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        driver.build_client_mesh(dataclasses.replace(sc.fl, agg_backend="cuda"), device="cpu")
    with pytest.raises(ValueError, match="spawn_mesh"):
        driver.build_client_mesh(sc.fl, world_size=2, device="cpu")
    assert not dist.is_initialized()

    ds = sc.build_dataset(reduced=True)
    init, loss, _ = sc.build_model(ds)
    calls = []
    for name in ("split", "fold_in", "PRNGKey"):
        orig = getattr(rng, name)
        monkeypatch.setattr(rng, name, lambda *a, _o=orig, _n=name, **k: (
            calls.append(_n), _o(*a, **k))[1])
    orig_rng = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **k: (calls.append("default_rng"), orig_rng(*a, **k))[1])
    mesh = local_client_mesh("cpu")
    try:
        with pytest.raises(ValueError, match="gzip"):
            driver.run_simulation(ds, init, loss, bad, 1, mesh=mesh)
        # a valid factory splits no key either: keys are consumed per round
        make_shard_map_round(loss, sc.fl, mesh)
    finally:
        mesh.close()
    assert not calls, calls


def test_server_opt_with_mesh_raises(mesh1):
    _, loss, _ = mlp_classifier(12, 3, hidden=8)
    with pytest.raises(ValueError, match="server_opt is not supported on the shard_map path"):
        make_engine(loss, FLConfig(n_clients=8, expected_clients=3), server_opt=object(),
                    mesh=mesh1)


def test_mesh_axis_must_be_the_client_axis(mesh1):
    _, loss, _ = mlp_classifier(12, 3, hidden=8)
    fl = FLConfig(n_clients=8, expected_clients=3, client_axis="clients")
    with pytest.raises(ValueError, match="fl.client_axis='clients'"):
        make_shard_map_round(loss, fl, mesh1)
    mesh = driver.build_client_mesh(fl, device="cpu")   # wraps mesh1's group
    assert mesh.axis_name == "clients"
    make_shard_map_round(loss, fl, mesh)


def test_spawn_mesh_default_device_is_cuda(monkeypatch):
    # device=None means CUDA on every backend: without a card it raises
    # before any rank starts, rather than running the ranks on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("gloo", "nccl"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            spawn_mesh(_rank_sum, 2, backend, 60)
    with pytest.raises(ValueError, match="nccl backend needs a CUDA device"):
        spawn_mesh(_rank_sum, 2, "nccl", 60, device="cpu")


def _rank_sum(mesh):
    return float(mesh.all_reduce(torch.tensor([float(mesh.rank)])))


def _rank_fails(mesh):
    if mesh.rank == 1:
        raise OSError("rank 1 gives up")
    return _rank_sum(mesh)      # rank 0 waits in the collective


def test_spawn_mesh_runs_ranks_and_kills_them_when_one_fails():
    assert spawn_mesh(_rank_sum, 2, "gloo", 120, device="cpu") == [1.0, 1.0]
    with pytest.raises(RuntimeError, match="rank 1 failed:(.|\n)*rank 1 gives up"):
        spawn_mesh(_rank_fails, 2, "gloo", 120, device="cpu")


def test_build_client_mesh_wraps_an_existing_group(mesh1):
    sc = get_scenario("femnist1-fedavg-aocs-shard").reduced()
    mesh = driver.build_client_mesh(sc.fl, device="cpu")
    assert (mesh.rank, mesh.world_size, mesh.backend, mesh.axis_name) == (0, 1, "gloo", "data")
    r = np.random.default_rng(2)
    u = torch.from_numpy(r.normal(size=(8, 130)).astype(np.float32))
    s = torch.from_numpy(r.uniform(size=8).astype(np.float32))
    assert torch.equal(ops.sharded_masked_aggregate(u, s, mesh), ops.shard_masked_aggregate(u, s))
    mesh.close()                             # not its group: it stays open
    assert dist.is_initialized()


@pytest.mark.parametrize("backend", ("jnp", "pallas"))
@pytest.mark.parametrize("variant", VARIANTS)
def test_world1_round_matches_reference_and_vmap_engine(mesh1, variant, backend):
    jloss, params, batch = _workload()
    jfl = parity_fl(variant, agg_backend=backend)
    w = np.full((jfl.n_clients,), 1.0 / jfl.n_clients, np.float32)
    pj, _, mj = run_parity_combo("shard", backend, None, jloss, jfl, params,
                                 {k: jnp.asarray(v) for k, v in batch.items()},
                                 jnp.asarray(w), jax.random.PRNGKey(7))
    fl = _port_fl(jfl)
    _, loss, _ = mlp_classifier(12, 3, hidden=8)
    bt = {k: torch.from_numpy(v) for k, v in batch.items()}
    pt, _, mt = make_engine(loss, fl, mesh=mesh1)(
        params_from_jax(params), (), bt, torch.from_numpy(w), rng.PRNGKey(7))
    assert int(np.sum(np.asarray(mj.mask))) > 0
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    np.testing.assert_allclose(mt.norms.numpy(), np.asarray(mj.norms), atol=1e-6)
    np.testing.assert_allclose(float(mt.loss), float(mj.loss), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), atol=1e-5)
    # one rank: every collective is the identity, so the vmap engine's round
    pv, _, mv = make_engine(loss, fl, device="cpu")(
        params_from_jax(params), (), bt, torch.from_numpy(w), rng.PRNGKey(7))
    for field in ("mask", "norms", "probs", "loss", "alpha", "gamma", "sent_clients"):
        assert torch.equal(getattr(mt, field), getattr(mv, field)), field
    for k in params:
        assert torch.equal(pt[k], pv[k]), k


REF_WORLD4 = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp, numpy as np
from repro.configs.base import FLConfig
from repro.fl.shard_round import make_shard_map_round
from repro.models.simple import mlp_classifier

inp = np.load(sys.argv[1])
mesh = jax.make_mesh((4,), ("data",))
_, loss, _ = mlp_classifier(12, 3, hidden=8)
params = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("p_")}
batch = {k[2:]: jnp.asarray(inp[k]) for k in inp.files if k.startswith("b_")}
out = {}
for name, fl_kw in json.loads(sys.argv[3]).items():
    with mesh:
        step = jax.jit(make_shard_map_round(loss, FLConfig(**fl_kw), mesh))
        p, _, m = step(params, (), batch, jnp.asarray(inp["w"]), jax.random.PRNGKey(7))
    for k, v in p.items():
        out[f"{name}/p_{k}"] = np.asarray(v)
    out[f"{name}/mask"] = np.asarray(m.mask)
    out[f"{name}/norms"] = np.asarray(m.norms)
    out[f"{name}/loss"] = np.asarray(m.loss)
np.savez(sys.argv[2], **out)
print("REF-WORLD4-OK")
"""


def _port_world4_rank(mesh, fl_kw, params, batch, w, u, s):
    """One rank of the port's four-rank round (its block of the cohort), and
    the mesh-level ``ops.sharded_masked_aggregate`` of ``u``, ``s``."""
    fl = FLConfig(**fl_kw)
    _, loss, _ = mlp_classifier(12, 3, hidden=8)
    k = fl.n_clients // mesh.world_size
    lo = mesh.rank * k
    p, _, m = make_engine(loss, fl, mesh=mesh)(
        params_from_jax(params), (), {n: torch.from_numpy(v[lo:lo + k]) for n, v in batch.items()},
        torch.from_numpy(w[lo:lo + k]), rng.PRNGKey(7))
    agg = ops.sharded_masked_aggregate(torch.from_numpy(u), torch.from_numpy(s), mesh)
    return ({n: v.numpy() for n, v in p.items()}, m.mask.numpy(), m.norms.numpy(),
            float(m.loss), agg.numpy())


def test_world4_round_matches_reference(tmp_path):
    _, params, batch = _workload()
    w = np.full((8,), 1.0 / 8, np.float32)
    combos = {v: dataclasses.asdict(parity_fl(v, agg_backend="pallas")) for v in WORLD4_COMBOS}
    inp = tmp_path / "inputs.npz"
    np.savez(inp, w=w, **{f"p_{k}": v for k, v in params.items()},
             **{f"b_{k}": v for k, v in batch.items()})
    out = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_WORLD4, str(inp), str(out),
                           json.dumps(combos)], env=env, capture_output=True, text=True,
                          timeout=WORLD4_TIMEOUT_S)
    assert "REF-WORLD4-OK" in proc.stdout, proc.stdout + proc.stderr[-3000:]
    want = np.load(out)
    r = np.random.default_rng(3)
    u = r.normal(size=(8, 1000)).astype(np.float32)
    s = r.uniform(size=8).astype(np.float32)
    for name, fl_kw in combos.items():
        ranks = spawn_mesh(_port_world4_rank, 4, "gloo", WORLD4_TIMEOUT_S, device="cpu",
                           args=(fl_kw, params, batch, w, u, s))
        p0, mask0, norms0, loss0, agg0 = ranks[0]
        for p, mask, norms, loss, agg in ranks[1:]:
            np.testing.assert_array_equal(mask, mask0)
            np.testing.assert_array_equal(norms, norms0)
            np.testing.assert_array_equal(agg, agg0)
            assert loss == loss0
            for k in p0:
                np.testing.assert_array_equal(p[k], p0[k])
        # the mesh-level entry point: each rank's block, one all_reduce
        np.testing.assert_allclose(agg0, (s[:, None] * u).sum(0), rtol=1e-5, atol=1e-5)
        assert int(want[f"{name}/mask"].sum()) > 0
        np.testing.assert_array_equal(mask0, want[f"{name}/mask"])
        np.testing.assert_allclose(norms0, want[f"{name}/norms"], atol=1e-6)
        np.testing.assert_allclose(loss0, float(want[f"{name}/loss"]), rtol=1e-5)
        for k in p0:
            np.testing.assert_allclose(p0[k], want[f"{name}/p_{k}"], atol=1e-5)
