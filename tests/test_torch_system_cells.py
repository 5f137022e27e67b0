"""The new scenario cells end to end against the reference: the client-state
layer and the sampler zoo through ``run_scenario``.

* One reduced cell of each kind, 3 rounds in host mode, the port on the CPU
  from the reference's initial parameters: ``-markov-iid``, ``-deadline``,
  ``-straggler-scan``, ``-clustered-markov``, ``-cyclic-deadline``,
  ``-threshold-randk`` and ``charlm-fedavg-aocs-dropout``.  Masks and the
  ``sent``, ``over_selected``, ``deadline_misses``, ``dropouts`` and uplink
  series are bitwise the reference's, the workload (with its ``system``)
  equal, losses and parameters within rtol 1e-4 (as
  tests/test_torch_sim.py: three rounds of float32 sum-order differences).
* The sharded cells ``-straggler-shard`` and ``-threshold-shard`` (and
  ``-cyclic-shard``) at world size 1 (gloo, in this process) and 4 (four
  gloo ranks, ``spawn_mesh``; the reference on four emulated devices in a
  subprocess): the reference's masks and system counters bitwise, every
  rank's ledger the same, losses within rtol 1e-4.

The three driver modes on every new cell (bitwise each other) and a round
of every one of the 46 cells are tests/test_torch_sim.py's
``test_prefetch_matches_host`` and ``test_scan_matches_host_and_prefetch``,
parametrized over the whole registry.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.sim import driver as j_driver
from repro.sim import scenarios as j_scenarios
from repro_torch.convert import params_from_jax
from repro_torch.fl.mesh import spawn_mesh
from repro_torch.kernels.ops import tree_leaves
from repro_torch.sim import driver

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
CELLS = ("femnist1-fedavg-aocs-markov-iid", "femnist1-fedavg-aocs-deadline",
         "femnist1-fedavg-aocs-straggler-scan", "femnist1-fedavg-clustered-markov",
         "femnist1-fedavg-cyclic-deadline", "femnist1-fedavg-threshold-randk",
         "charlm-fedavg-aocs-dropout")
SHARD_CELLS = ("femnist1-fedavg-aocs-straggler-shard", "femnist1-fedavg-threshold-shard",
               "femnist1-fedavg-cyclic-shard")
ROUNDS = 3
SERIES = ("sent", "over_selected", "deadline_misses", "dropouts", "uplink_bits",
          "downlink_bits")
WORLD4_TIMEOUT_S = 300


def _reference(name):
    """The reference's reduced host run of ``name`` and its initial parameters."""
    sc = j_scenarios.get_scenario(name).reduced()
    init, _, _ = sc.build_model(sc.build_dataset(reduced=True))
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(sc.seed), 1)))
    params, ledger = j_driver.run_scenario(name, reduced=True, mode="host", rounds=ROUNDS)
    return p0, jax.device_get(params), ledger


@pytest.fixture(scope="module")
def references():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _reference(name)
        return cache[name]

    return get


def _same_as_reference(lt, lj, label):
    assert len(lt.masks) == len(lj.masks) == ROUNDS
    for a, b in zip(lt.masks, lj.masks):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=label)
    for series in SERIES:
        assert getattr(lt, series) == getattr(lj, series), (label, series)
    np.testing.assert_allclose(lt.loss, lj.loss, rtol=1e-4, err_msg=label)


@pytest.mark.parametrize("name", CELLS)
def test_cell_matches_reference(name, references):
    p0, pj, lj = references(name)
    pt, lt = driver.run_scenario(name, reduced=True, mode="host", rounds=ROUNDS, device="cpu",
                                 init_fn=lambda key: params_from_jax(p0, key.device))
    _same_as_reference(lt, lj, name)
    assert lt.workload == {**lj.workload, "backend_platform": "cpu"}
    assert lt.fl == lj.fl
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)
    j_driver.validate_ledger(lt.to_json(include_masks=True))
    driver.validate_ledger(lt.to_json(include_masks=True))


@pytest.mark.parametrize("name", SHARD_CELLS)
def test_shard_cell_at_world_size_1_matches_reference(name, references):
    p0, _, lj = references(name)
    _, lt = driver.run_scenario(name, reduced=True, mode="host", rounds=ROUNDS, device="cpu",
                                init_fn=lambda key: params_from_jax(p0, key.device))
    assert lt.workload["mesh_axis_size"] == lj.workload["mesh_axis_size"] == 1
    _same_as_reference(lt, lj, name)


REF_WORLD4 = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
from repro.sim.driver import run_scenario
out = {}
for name in json.loads(sys.argv[2]):
    _, led = run_scenario(name, reduced=True, mode="host", rounds=int(sys.argv[3]))
    doc = led.to_json(include_masks=True)
    out[name] = {"masks": doc["masks"], "mesh": led.workload["mesh_axis_size"],
                 **{k: doc["metrics"][k] for k in ("loss",) + tuple(json.loads(sys.argv[4]))}}
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
print("REF-WORLD4-OK")
"""


def _world4_rank(mesh, names, rounds):
    out = {}
    for name in names:
        _, led = driver.run_scenario(name, reduced=True, mode="host", rounds=rounds, mesh=mesh,
                                     device="cpu")
        doc = led.to_json(include_masks=True)
        out[name] = {"masks": doc["masks"], "mesh": led.workload["mesh_axis_size"],
                     **{k: doc["metrics"][k] for k in ("loss",) + SERIES}}
    return out


def test_shard_cells_on_four_ranks_match_reference(tmp_path):
    names = list(SHARD_CELLS[:2])
    path = tmp_path / "reference.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", REF_WORLD4, str(path), json.dumps(names),
                           str(ROUNDS), json.dumps(SERIES)], env=env, capture_output=True,
                          text=True, timeout=WORLD4_TIMEOUT_S)
    assert "REF-WORLD4-OK" in proc.stdout, proc.stdout + proc.stderr[-3000:]
    want = json.loads(path.read_text())
    ranks = spawn_mesh(_world4_rank, 4, "gloo", WORLD4_TIMEOUT_S, device="cpu",
                       args=(names, ROUNDS))
    for name in names:
        assert want[name]["mesh"] == 4
        # every rank steps the same client state from the same round key
        for rank in ranks:
            assert rank[name] == ranks[0][name]
        got = ranks[0][name]
        assert got["mesh"] == 4 and got["masks"] == want[name]["masks"]
        assert any(any(m) for m in got["masks"])
        for series in SERIES:
            assert got[series] == want[name][series], (name, series)
        np.testing.assert_allclose(got["loss"], want[name]["loss"], rtol=1e-4)
