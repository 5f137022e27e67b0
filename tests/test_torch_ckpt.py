"""The port's checkpoint layer (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the reference's layer tests on torch and
numpy trees (the versioned layout, the latest complete step, errors that
name the key, ``keep``, the flat layout, ``restore_subtree``), the key paths
printed as ``jax.tree_util.keystr`` prints them, bf16 leaves bit for bit in
both directions, and round checkpoints crossing the packages:

* a reference ``RoundCheckpoint`` (threshold sampler, ``SystemConfig()``,
  server momentum, ``every=4`` over 7 rounds) restores in the port leaf for
  leaf bitwise, with the port's fingerprint of the same run equal to the
  saved one; the port resumed from it draws the uninterrupted reference
  run's masks and system counters bitwise for rounds 4-6, its losses and
  parameters within rtol 1e-4 (the parity tests' tolerance);
* the reference's ``load_round`` accepts a port checkpoint, and the
  reference resumed from it draws the port's masks.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ck
from repro.configs.base import FLConfig as JFLConfig
from repro.core.sampling import SamplerState as JSamplerState
from repro.data import femnist_like as j_femnist_like
from repro.models.simple import mlp_classifier as j_mlp
from repro.optim import sgd as j_sgd
from repro.sim import run_simulation as j_run_simulation
from repro.sim.pool import ClientState as JClientState
from repro.sim.pool import SystemConfig as JSystemConfig
from repro_torch import checkpoint as ck
from repro_torch.checkpoint import ckpt as ck_mod
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.core.sampling import SamplerState
from repro_torch.data import femnist_like
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models.simple import mlp_classifier
from repro_torch.optim import sgd
from repro_torch.sim.driver import run_simulation
from repro_torch.sim.pool import ClientState, SystemConfig


def _tree():
    return {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "b": {"inner": np.ones(4, dtype=np.int32)},
    }


def test_versioned_layout_and_latest_complete(tmp_path):
    root = str(tmp_path / "ck")
    ck.save(root, _tree(), step=3)
    ck.save(root, _tree(), step=7)
    assert ck.available_steps(root) == [3, 7]
    with open(os.path.join(root, "step-00000007", "leaves.npz"), "wb") as f:
        f.write(b"PK\x03\x04garbage")
    assert ck.available_steps(root) == [3] and ck.latest_step(root) == 3
    tree, step = ck.restore(root, _tree())
    assert step == 3 and torch.equal(tree["w"], _tree()["w"])
    assert isinstance(tree["b"]["inner"], np.ndarray)
    os.makedirs(os.path.join(root, ".tmp-step-00000009-123"))
    assert ck.available_steps(root) == [3]
    assert ck.restore(os.path.join(root, "step-00000003"), _tree())[1] == 3
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(root, _tree(), step=5)


def test_restore_errors_name_the_key(tmp_path):
    root = str(tmp_path / "ck")
    ck.save(root, _tree(), step=0)
    bad = _tree()
    bad["b"]["inner"] = torch.ones(4, dtype=torch.float32)
    with pytest.raises(ValueError, match=r"dtype.*\['b'\]\['inner'\]"):
        ck.restore(root, bad)
    bad = _tree()
    bad["w"] = torch.zeros((3, 3))
    with pytest.raises(ValueError, match=r"shape.*\['w'\]"):
        ck.restore(root, bad)
    bad = _tree()
    bad["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="structure mismatch"):
        ck.restore(root, bad)


def test_keep_prunes_and_the_flat_layout_restores(tmp_path):
    root = str(tmp_path / "ck")
    for s in range(1, 6):
        ck.save(root, _tree(), step=s, keep=2)
    assert ck.available_steps(root) == [4, 5]
    flat = str(tmp_path / "flat")
    shutil.copytree(os.path.join(root, "step-00000005"), flat)
    tree, step = ck.restore(flat, _tree())
    assert step == 5 and torch.equal(tree["w"], _tree()["w"])


def test_restore_subtree_pulls_params_only(tmp_path):
    root = str(tmp_path / "ck")
    ck.save(root, {"params": _tree(), "opt_state": {"m": torch.zeros(3)}}, step=2,
            meta={"round": 2})
    sub, step = ck.restore_subtree(root, _tree(), "['params']")
    assert step == 2 and np.array_equal(sub["b"]["inner"], _tree()["b"]["inner"])
    assert ck.read_meta(root) == ({"round": 2}, 2)
    bad = _tree()
    bad["w"] = bad["w"].to(torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        ck.restore_subtree(root, bad, "['params']")
    with pytest.raises(ValueError, match="no leaves under prefix"):
        ck.restore_subtree(root, _tree(), "['nope']")


def test_keys_are_jax_keystr_paths():
    """Dict keys sorted, NamedTuple fields, list entries, nothing for ()."""
    tree = {
        "params": {"w2": np.zeros(2, np.float32), "b1": np.zeros(1, np.float32)},
        "opt_state": (),
        "client_state": ClientState(up=torch.zeros(3, dtype=torch.bool),
                                    lat_scale=torch.ones(3)),
        "sampler_state": SamplerState(step=torch.zeros((), dtype=torch.int32),
                                      threshold=torch.zeros(())),
        "stack": [np.zeros(1), {"a": np.zeros(1)}],
    }
    j_tree = {
        "params": tree["params"], "opt_state": (),
        "client_state": JClientState(up=np.zeros(3, bool), lat_scale=np.ones(3, np.float32)),
        "sampler_state": JSamplerState(step=np.zeros((), np.int32),
                                       threshold=np.zeros((), np.float32)),
        "stack": tree["stack"],
    }
    keys = [k for k, _ in ck_mod._flatten(tree)]
    j_flat, _ = jax.tree_util.tree_flatten_with_path(j_tree)
    assert keys == [jax.tree_util.keystr(p) for p, _ in j_flat]
    assert "['client_state'].up" in keys and "['sampler_state'].step" in keys
    back = ck_mod._unflatten(tree, iter(v for _, v in ck_mod._flatten(tree)))
    assert list(back) == list(tree) and isinstance(back["client_state"], ClientState)


def test_bf16_leaves_cross_bit_for_bit(tmp_path):
    """A reference bf16 leaf (ml_dtypes, stored as raw <V2) restores into a
    torch bf16 template bitwise; the port writes the same <V2 member and
    index entry, which restores in the port bitwise."""
    bits = np.array([0x3F80, 0xC2F7, 0x0001, 0x7F7F, 0x8000], np.uint16).view(np.int16)
    j_leaf = bits.view(ml_dtypes.bfloat16)
    j_ck.save(str(tmp_path / "j"), {"w": j_leaf, "s": np.float32(2.0)}, step=1)
    like = {"w": torch.zeros(5, dtype=torch.bfloat16), "s": torch.zeros(())}
    got, _ = ck.restore(str(tmp_path / "j"), like)
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy(), bits)
    ck.save(str(tmp_path / "t"), got, step=1)
    for d in ("j", "t"):
        step_dir = tmp_path / d / "step-00000001"
        idx = json.loads((step_dir / "index.json").read_text())
        assert idx["dtypes"][idx["keys"].index("['w']")] == "bfloat16"
        with np.load(step_dir / "leaves.npz") as data:
            assert data["a1"].dtype.str == "|V2"
        with open(step_dir / "leaves.npz", "rb") as f:
            assert b"'descr': '<V2'" in f.read()
    again, _ = ck.restore(str(tmp_path / "t"), like)
    assert torch.equal(again["w"].view(torch.int16), got["w"].view(torch.int16))
    with pytest.raises(ValueError, match="saved bfloat16, template wants float32"):
        ck.restore(str(tmp_path / "t"), {"w": torch.zeros(5), "s": torch.zeros(())})


# ------------------------------------------------ round checkpoints across packages

DS_KW = dict(dataset_id=1, n_clients=24, dim=48, num_classes=10, base_examples=24, seed=0)
FL_KW = dict(n_clients=8, expected_clients=3, local_steps=2, lr_local=0.1, scan_group=2,
             cache_groups=2, sampler="threshold")
RUN_KW = dict(batch_size=4, mode="host", rounds_per_scan=3, seed=3, eval_every=3)
ROUNDS = 7


def _j_run(**kw):
    ds = j_femnist_like(**DS_KW)
    init, loss, acc = j_mlp(ds.input_dim, ds.num_classes, hidden=16)
    ev = {"x": jnp.zeros((4, ds.input_dim)), "y": jnp.zeros((4,), jnp.int32)}
    return j_run_simulation(ds, init, loss, JFLConfig(**FL_KW), ROUNDS, system=JSystemConfig(),
                            server_opt=j_sgd(0.5, momentum=0.9), eval_fn=jax.jit(acc),
                            eval_batch=ev, **RUN_KW, **kw)


def _t_run(p0, **kw):
    ds = femnist_like(**DS_KW)
    _, loss, acc = mlp_classifier(ds.input_dim, ds.num_classes, hidden=16)
    ev = {"x": np.zeros((4, ds.input_dim), np.float32), "y": np.zeros((4,), np.int32)}
    return run_simulation(ds, lambda key: params_from_jax(p0, key.device), loss,
                          FLConfig(**FL_KW), ROUNDS, system=SystemConfig(),
                          server_opt=sgd(0.5, momentum=0.9), eval_fn=acc, eval_batch=ev,
                          device="cpu", **RUN_KW, **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's uninterrupted run and its checkpointed twin, and the
    port's, from the reference's initial parameters."""
    d = tmp_path_factory.mktemp("cross")
    ds = j_femnist_like(**DS_KW)
    init, _, _ = j_mlp(ds.input_dim, ds.num_classes, hidden=16)
    p0 = jax.device_get(init(jax.random.fold_in(jax.random.PRNGKey(RUN_KW["seed"]), 1)))
    j_ref = _j_run()
    _j_run(checkpoint=j_ck.CheckpointConfig(str(d / "j"), every=4))
    t_ref = _t_run(p0)
    _t_run(p0, checkpoint=ck.CheckpointConfig(str(d / "t"), every=4))
    return dict(p0=p0, j_ref=j_ref, t_ref=t_ref, j_dir=str(d / "j"), t_dir=str(d / "t"))


def _cfg_doc(module, fl, p0):
    dim = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(p0))
    return module.run_config_doc(fl, seed=3, batch_size=4, local_epoch=True, pool_clients=24,
                                 model_dim=dim,
                                 system=(JSystemConfig() if module is j_ck else SystemConfig()),
                                 eval_every=3, scenario=None)


def test_reference_checkpoint_restores_in_the_port(runs):
    step = os.path.join(runs["j_dir"], "step-00000004")
    meta, _ = j_ck.read_meta(step)
    doc = _cfg_doc(ck, FLConfig(**FL_KW), runs["p0"])
    assert doc == _cfg_doc(j_ck, JFLConfig(**FL_KW), runs["p0"])
    assert ck.resume.fingerprint(doc) == meta["fingerprint"]
    params = params_from_jax(runs["p0"], "cpu")
    rc = ck.load_round(step, params=params, opt_state={k: torch.zeros_like(v)
                                                       for k, v in params.items()},
                       client_state=ClientState(up=torch.zeros(24, dtype=torch.bool),
                                                lat_scale=torch.zeros(24)),
                       sampler_state=SamplerState(step=torch.zeros((), dtype=torch.int32),
                                                  threshold=torch.zeros(())),
                       config=doc)
    assert rc.round == 4 and rc.rng_state == meta["rng_state"]
    with np.load(os.path.join(step, "leaves.npz")) as data:
        idx = json.loads(open(os.path.join(step, "index.json")).read())
        tree = ck.resume._tree(rc)
        flat = dict(ck_mod._flatten(tree))
        assert list(flat) == idx["keys"]
        for i, key in enumerate(idx["keys"]):
            got = flat[key]
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert got.dtype == data[f"a{i}"].dtype
            np.testing.assert_array_equal(got, data[f"a{i}"], err_msg=key)


def test_port_resumes_a_reference_checkpoint(runs):
    _, j_led = runs["j_ref"]
    pt, t_led = _t_run(runs["p0"], resume=os.path.join(runs["j_dir"], "step-00000004"))
    pj, _ = runs["j_ref"]
    for a, b in zip(t_led.masks[4:], j_led.masks[4:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    for name in ("over_selected", "deadline_misses", "dropouts", "sent", "uplink_bits"):
        assert getattr(t_led, name) == getattr(j_led, name), name
    assert t_led.loss[:4] == j_led.loss[:4]
    np.testing.assert_allclose(t_led.loss, j_led.loss, rtol=1e-4)
    for a, b in zip(tree_leaves(pt), jax.tree_util.tree_leaves(pj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-6)


def test_reference_resumes_a_port_checkpoint(runs):
    step = os.path.join(runs["t_dir"], "step-00000004")
    p0 = runs["p0"]
    rc = j_ck.load_round(step, params=p0, opt_state=jax.tree_util.tree_map(jnp.zeros_like, p0),
                         client_state=JClientState(up=jnp.zeros(24, bool),
                                                   lat_scale=jnp.zeros(24)),
                         sampler_state=JSamplerState(step=jnp.zeros((), jnp.int32),
                                                     threshold=jnp.zeros(())),
                         config=_cfg_doc(j_ck, JFLConfig(**FL_KW), p0))
    _, t_led = runs["t_ref"]
    assert rc.round == 4 and rc.series["loss"] == t_led.loss[:4]
    np.testing.assert_array_equal(np.asarray(rc.masks), np.stack(t_led.masks[:4]))
    _, j_led = _j_run(resume=step)
    for a, b in zip(j_led.masks, t_led.masks):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert j_led.over_selected == t_led.over_selected and j_led.sent == t_led.sent
