"""The port's round checkpoints through its driver, the reference's
``tests/test_resume.py`` at its sizes (24 clients, dim 48, hidden 16, 8 per
round; 7 rounds, ``every=4`` off the ``rounds_per_scan=3`` grid,
``eval_every=3``):

* in host, prefetch and scan mode, for each of {threshold sampler + Markov
  client state, rand-k, server momentum}: checkpointing changes nothing but
  wall clock and leaves steps [4, 7]; a run resumed from the pinned
  ``step-00000004`` ends with parameters bitwise the uninterrupted run's and
  a ledger byte-identical minus timing;
* the same on a gloo mesh at world sizes 1 (in this process) and 2 (spawned
  ranks sharing one directory; rank 0 writes), and after a SIGKILL of a
  checkpointing child process;
* fingerprint drift, a run that asks for no more rounds than the checkpoint
  holds, and a params-only checkpoint raise the reference's ``ValueError``s.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointConfig, available_steps, latest_step, load_round
from repro_torch.checkpoint import save as ck_save
from repro_torch.configs.base import FLConfig
from repro_torch.data import femnist_like
from repro_torch.fl.mesh import local_client_mesh, spawn_mesh
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models.simple import mlp_classifier
from repro_torch.optim import sgd
from repro_torch.sim.driver import build_client_mesh, run_simulation
from repro_torch.sim.pool import SystemConfig

MODES = ("host", "prefetch", "scan")
DS_KW = dict(dataset_id=1, n_clients=24, dim=48, num_classes=10, base_examples=24, seed=0)


def _ds():
    return femnist_like(**DS_KW)


def _strip_timing(doc):
    doc = json.loads(json.dumps(doc))
    doc.pop("wall_s")
    doc.pop("rounds_per_sec")
    doc["metrics"].pop("wall_ms")
    return json.dumps(doc, sort_keys=True)


def _same_params(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


VARIANTS = {
    "threshold+markov": ({"sampler": "threshold"}, SystemConfig(p_up=0.5, p_down=0.2), None),
    "randk": ({"compression": "randk", "compression_param": 0.5}, None, None),
    "momentum": ({}, None, "momentum"),
}


def _run(ds, rounds, mode, fl_kw, system, opt_name, **kw):
    init, loss, acc = mlp_classifier(ds.input_dim, ds.num_classes, hidden=16)
    fl = FLConfig(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.1,
                  scan_group=2, cache_groups=2, **fl_kw)
    ev = {"x": np.zeros((4, ds.input_dim), np.float32), "y": np.zeros((4,), np.int32)}
    opt = sgd(0.5, momentum=0.9) if opt_name == "momentum" else None
    return run_simulation(ds, init, loss, fl, rounds, batch_size=4, mode=mode,
                          rounds_per_scan=3, seed=3, system=system, server_opt=opt,
                          eval_fn=acc, eval_batch=ev, eval_every=3, device="cpu", **kw)


@pytest.fixture(scope="module")
def small_ds():
    return _ds()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_resume_parity(small_ds, tmp_path, mode, variant):
    fl_kw, system, opt = VARIANTS[variant]
    p_ref, led_ref = _run(small_ds, 7, mode, fl_kw, system, opt)
    ref = _strip_timing(led_ref.to_json(include_masks=True))
    d = str(tmp_path / "ck")
    _, led_ck = _run(small_ds, 7, mode, fl_kw, system, opt,
                     checkpoint=CheckpointConfig(d, every=4))
    assert _strip_timing(led_ck.to_json(include_masks=True)) == ref
    assert available_steps(d) == [4, 7]
    p_res, led_res = _run(small_ds, 7, mode, fl_kw, system, opt,
                          resume=os.path.join(d, "step-00000004"))
    assert _strip_timing(led_res.to_json(include_masks=True)) == ref
    assert _same_params(p_res, p_ref)
    assert [n.tolist() for n in led_res.norms] == [n.tolist() for n in led_ref.norms]


def _mesh_run(mesh, ds, rounds, **kw):
    init, loss, _ = mlp_classifier(ds.input_dim, ds.num_classes, hidden=16)
    fl = FLConfig(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.1,
                  sampler="threshold")
    return run_simulation(ds, init, loss, fl, rounds, batch_size=4, seed=3, mesh=mesh,
                          system=SystemConfig(p_up=0.5, p_down=0.2), **kw)


def _mesh_resume(mesh, d, mode):
    """Straight 6 rounds; 4 rounds with a checkpoint every 2; resumed to 6:
    the stripped ledgers, whether the parameters are bitwise, the steps."""
    ds = _ds()
    p_ref, led_ref = _mesh_run(mesh, ds, 6, mode=mode)
    _mesh_run(mesh, ds, 4, mode=mode, checkpoint=CheckpointConfig(d, every=2))
    steps = available_steps(d)
    p_res, led_res = _mesh_run(mesh, ds, 6, mode=mode, resume=d)
    return (_strip_timing(led_ref.to_json(include_masks=True)),
            _strip_timing(led_res.to_json(include_masks=True)),
            _same_params(p_ref, p_res), steps)


@pytest.mark.parametrize("mode", ("host", "prefetch"))
def test_resume_under_a_mesh_of_one(tmp_path, mode):
    mesh = local_client_mesh("cpu", axis_name="data")
    try:
        ref, res, same, steps = _mesh_resume(mesh, str(tmp_path / "ck"), mode)
    finally:
        mesh.close()
    assert res == ref and same and steps == [2, 4]


def test_resume_under_a_mesh_of_two(tmp_path):
    """Two gloo ranks resume from one directory that rank 0 alone wrote."""
    out = spawn_mesh(_mesh_resume, 2, "gloo", 120, device="cpu",
                     args=(str(tmp_path / "ck"), "prefetch"))
    assert len(out) == 2
    for ref, res, same, steps in out:
        assert res == ref and same and steps == [2, 4]
    assert out[0][0] == out[1][0]
    assert sorted(os.listdir(tmp_path / "ck")) == ["step-00000002", "step-00000004"]


def test_fingerprint_mismatch_rejected(small_ds, tmp_path):
    fl_kw, system, opt = VARIANTS["threshold+markov"]
    d = str(tmp_path / "ck")
    _run(small_ds, 4, "host", fl_kw, system, opt, checkpoint=CheckpointConfig(d, every=2))
    init, loss, acc = mlp_classifier(small_ds.input_dim, small_ds.num_classes, hidden=16)
    fl = FLConfig(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.1,
                  scan_group=2, cache_groups=2, **fl_kw)
    with pytest.raises(ValueError, match="fingerprint.*seed: checkpoint=3 run=4"):
        run_simulation(small_ds, init, loss, fl, 8, batch_size=4, mode="host", seed=4,
                       system=system, eval_fn=acc,
                       eval_batch={"x": np.zeros((4, 48), np.float32),
                                   "y": np.zeros((4,), np.int32)},
                       eval_every=3, resume=d, device="cpu")


def test_resume_at_or_past_rounds_rejected(small_ds, tmp_path):
    fl_kw, system, opt = VARIANTS["randk"]
    d = str(tmp_path / "ck")
    _run(small_ds, 4, "host", fl_kw, system, opt, checkpoint=CheckpointConfig(d, every=4))
    with pytest.raises(ValueError, match="raise rounds"):
        _run(small_ds, 4, "host", fl_kw, system, opt, resume=d)


def test_params_only_checkpoint_cannot_resume(small_ds, tmp_path):
    d = str(tmp_path / "ck")
    tree = {"w": torch.zeros(3)}
    ck_save(d, tree, step=3)
    with pytest.raises(ValueError, match="not a RoundCheckpoint"):
        load_round(d, params=tree, opt_state=())
    fl_kw, system, opt = VARIANTS["randk"]
    with pytest.raises(ValueError, match="not a RoundCheckpoint"):
        _run(small_ds, 6, "host", fl_kw, system, opt, resume=d)


_CRASH_CHILD = """
import sys
from repro_torch.checkpoint import CheckpointConfig
from repro_torch.configs.base import FLConfig
from repro_torch.data import femnist_like
from repro_torch.models.simple import mlp_classifier
from repro_torch.sim.driver import run_simulation

ds = femnist_like(dataset_id=1, n_clients=24, dim=48, num_classes=10,
                  base_examples=24, seed=0)
init, loss, _ = mlp_classifier(ds.input_dim, ds.num_classes, hidden=16)
fl = FLConfig(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.1,
              sampler="threshold")
run_simulation(ds, init, loss, fl, 100000, batch_size=4, mode="host", seed=3,
               checkpoint=CheckpointConfig(sys.argv[1], every=2), device="cpu")
"""


def test_crash_injection_sigkill(small_ds, tmp_path):
    """SIGKILL a checkpointing child mid-run, resume from the newest
    complete checkpoint, and finish: the run equals a straight one."""
    d = str(tmp_path / "ck")
    script = tmp_path / "child.py"
    script.write_text(_CRASH_CHILD)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(sys.path))
    proc = subprocess.Popen([sys.executable, str(script), d], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            if (latest_step(d) or 0) >= 4:
                break
            if proc.poll() is not None:
                pytest.fail(f"child exited early: rc={proc.returncode}")
            time.sleep(0.05)
        else:
            pytest.fail("child never reached a round-4 checkpoint")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    k0 = latest_step(d)
    assert k0 is not None and k0 >= 4
    init, loss, _ = mlp_classifier(small_ds.input_dim, small_ds.num_classes, hidden=16)
    fl = FLConfig(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.1,
                  sampler="threshold")
    kw = dict(batch_size=4, mode="host", seed=3, device="cpu")
    p_ref, led_ref = run_simulation(small_ds, init, loss, fl, k0 + 3, **kw)
    p_res, led_res = run_simulation(small_ds, init, loss, fl, k0 + 3, resume=d, **kw)
    assert _strip_timing(led_res.to_json()) == _strip_timing(led_ref.to_json())
    assert _same_params(p_res, p_ref)


def test_build_client_mesh_checkpoints_on_rank_zero(tmp_path):
    """``build_client_mesh`` (a world of one) runs the checkpointing mesh
    path of ``run_scenario``'s sharded cells."""
    fl = FLConfig(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.1)
    mesh = build_client_mesh(fl, device="cpu")
    try:
        ds = _ds()
        init, loss, _ = mlp_classifier(ds.input_dim, ds.num_classes, hidden=16)
        run_simulation(ds, init, loss, fl, 3, batch_size=4, seed=3, mesh=mesh, mode="host",
                       checkpoint=str(tmp_path / "ck"))
    finally:
        mesh.close()
    assert available_steps(str(tmp_path / "ck")) == [3]
