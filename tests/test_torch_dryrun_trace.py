"""The port's dry-run pass (``repro_torch/launch/dryrun.py``) on a fake
process group, in subprocesses (a process group would outlive a test in
this worker), at the reference test's size: llama3-8b reduced, vocab 256,
seq 64, batch 8, 4 clients, ``--device cpu``.

* on a (4, 2) mesh the round counts FLOPs and bytes per chip and moves
  collective traffic; prefill and decode in every ``kv_mode`` trace;
* on a (1, 1) mesh the per-chip FLOPs equal ``FlopCounterMode``'s count of
  the same round run on real CPU tensors, and on (2, 2) the per-chip FLOPs
  times 4 lie between that count and twice it (the sharded program repeats
  some work on every chip, never less than all of it);
* the same bound at sequence 1,024 on a (2, 4) mesh, where the attention's
  products are most of the step: under ``vmap`` they batch the client shard
  with the head shard, and each chip must keep its clients and its heads
  (``launch/dryrun.py::sharded_einsum``) rather than compute every head;
* on a pod-shaped (2, 4, 2) mesh (16 chips, the test's 4 clients on
  'data'), the per-chip FLOPs times 16 lie between the plain step's count
  and twice it: 'pod' splits each client's batch, as on pod2, where 32
  clients lie on 'data' and 'pod' splits each client's 8 sequences
  (``sharding.batch_shardings(fit_dims=...)``); a prefill of 4 sequences
  leaves 'pod' replicated and counts what the (4, 2) mesh counts;
* pod1 llama3-8b x prefill_32k and mamba2-130m x train_4k (the vmap and
  scan engines) at full width give the ``flops_per_chip`` and
  ``hbm_bytes_per_chip`` that ``chip_smoke.py`` holds the card's torch to
  (``DRYRUN_PREFILL_FLOPS``, ``DRYRUN_PREFILL_BYTES``, ``DRYRUN_TRAIN``).

``test_torch_dryrun_options.py`` covers the round's options, the depth
extrapolation and the CLI.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import dataclasses, json, sys
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode
from repro_torch import rng
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.fl.round import make_round
from repro_torch.launch import dryrun as D, specs as SP
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models import build_model

cfg = ARCHS["llama3-8b"].reduced().with_(vocab_size=256)
small = {n: dataclasses.replace(s, seq_len=64, global_batch=8) for n, s in SHAPES.items()}
fl = SP.fl_config_for(cfg, small["train_4k"], n_clients=4)
fl_config_for, SP.fl_config_for = SP.fl_config_for, lambda *a, **k: fl
out = {}

def counts(mesh, shape="train_4k", shapes=small, **kw):
    c = D.trace(D.build_lowered(cfg, shapes[shape], mesh, **kw))
    return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak_bytes,
            "traffic": sum(r[1] for r in c.comm_records), "n_comms": len(c.comm_records)}

mesh = make_debug_mesh(4, 2, device="cpu")
out["backend"], out["world"] = dist.get_backend(), dist.get_world_size()
out["train_4x2"] = counts(mesh)
out["prefill_4x2"] = counts(mesh, "prefill_32k")
for mode in ("hd", "batch", "seq", "proj", "factored"):
    out["decode_4x2_" + mode] = counts(mesh, "decode_32k", kv_mode=mode)
out["train_1x1"] = counts(make_debug_mesh(1, 1, device="cpu"))
out["train_2x2"] = counts(make_debug_mesh(2, 2, device="cpu"))
long = {"train_4k": dataclasses.replace(small["train_4k"], seq_len=1024)}
out["train_2x4_long"] = counts(make_debug_mesh(2, 4, device="cpu"), shapes=long)
out["train_pod"] = counts(make_debug_mesh(4, 2, device="cpu", n_pod=2))
four = {"prefill_32k": dataclasses.replace(small["prefill_32k"], global_batch=4)}
out["prefill_pod_b4"] = counts(make_debug_mesh(4, 2, device="cpu", n_pod=2), "prefill_32k", four)
out["prefill_pod_b4"]["notes"] = D.run_pair(
    "llama3-8b", four["prefill_32k"], make_debug_mesh(4, 2, device="cpu", n_pod=2), "pod",
    sys.argv[1])["notes"]
out["prefill_4x2_b4"] = counts(make_debug_mesh(4, 2, device="cpu"), "prefill_32k", four)
SP.fl_config_for = fl_config_for
for arch, shape, kw in (("llama3-8b", "prefill_32k", {}),
                        ("mamba2-130m", "train_4k", {"fl_mode": "vmap", "tag": "_vmap"}),
                        ("mamba2-130m", "train_4k", {"fl_mode": "scan", "tag": "_scan"})):
    rec = D.run_pair(arch, shape, make_production_mesh(device="cpu"), "pod1", sys.argv[1], **kw)
    out[f"pod1 {arch} {shape}{kw.get('tag', '')}"] = [rec["flops_per_chip"],
                                                      rec["hbm_bytes_per_chip"]]

dist.destroy_process_group()

model = build_model(cfg)
params = model.init(torch.Generator().manual_seed(0), "cpu")
step = make_round(model.loss, fl, mode="vmap", scan_group=2, device="cpu")
for name, seq in (("plain_flops", 64), ("plain_flops_long", 1024)):
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, 256, (4, 1, 2, seq), generator=g, dtype=torch.int32)
             for k in ("tokens", "targets")}
    with FlopCounterMode(display=False) as fc:
        step(params, (), batch, torch.full((4,), 0.25), rng.PRNGKey(0))
    out[name] = fc.get_total_flops()
print("DRYRUN-RESULT " + json.dumps(out))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(tmp_path_factory.mktemp("pod1"))],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("DRYRUN-RESULT ")]
    assert line, out.stdout[-3000:] + out.stderr[-6000:]
    return json.loads(line[0].split(" ", 1)[1])


def test_the_fake_group_exists(result):
    assert result["backend"] == "fake" and result["world"] == 8


def test_sharded_round_counts_work_and_collectives(result):
    r = result["train_4x2"]
    assert r["flops"] > 0 and r["bytes"] > 0 and r["peak"] > 0
    assert r["n_comms"] > 0 and r["traffic"] > 0


@pytest.mark.parametrize("name", ["prefill_4x2"] + [
    "decode_4x2_" + m for m in ("hd", "batch", "seq", "proj", "factored")])
def test_serving_steps_trace(result, name):
    assert result[name]["flops"] > 0 and result[name]["bytes"] > 0


def test_one_chip_flops_equal_the_plain_steps(result):
    assert result["train_1x1"]["flops"] == result["plain_flops"] > 0
    assert result["train_1x1"]["traffic"] == 0


def test_four_chips_share_the_plain_steps_flops(result):
    total = 4 * result["train_2x2"]["flops"]
    assert result["plain_flops"] <= total <= 2 * result["plain_flops"]


def test_heads_and_clients_stay_sharded_in_the_batched_products(result):
    """At sequence 1,024 the attention's products are most of the step: a
    chip that computed every head of its clients would count ~3x the plain
    step's FLOPs over the (2, 4) mesh's 8 chips."""
    total = 8 * result["train_2x4_long"]["flops"]
    assert result["plain_flops_long"] <= total <= 2 * result["plain_flops_long"]


def test_pod_mesh_splits_each_clients_batch(result):
    """4 clients over the (2, 4, 2) mesh's 8 client-axis chips: on 'data',
    with 'pod' on each client's 2 sequences.  Replicated over all 8 (the
    reference's rule where the axes' product does not divide the clients)
    the count is ~8x the plain step's."""
    total = 16 * result["train_pod"]["flops"]
    assert result["plain_flops"] <= total <= 2 * result["plain_flops"]
    assert result["train_pod"]["traffic"] > 0


def test_pod_mesh_prefill_leaves_pod_replicated(result):
    """A prefill of 4 sequences on the (2, 4, 2) mesh: 'data' holds them,
    'pod' is replicated (the record's notes say so) and every chip counts
    what a chip of the (4, 2) mesh counts."""
    pod, flat = result["prefill_pod_b4"], result["prefill_4x2_b4"]
    assert pod["flops"] == flat["flops"] > 0
    assert pod["bytes"] == flat["bytes"]
    assert "pod replicated ×2" in pod["notes"]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def test_pod1_prefill_flops_equal_the_card_scripts_constant(result):
    """``chip_smoke.py`` holds the card's torch to this CPU value (within
    0.01%): the record must not depend on the torch version that traced it."""
    flops, nbytes = result["pod1 llama3-8b prefill_32k"]
    cs = _chip_smoke()
    assert flops == pytest.approx(cs.DRYRUN_PREFILL_FLOPS, rel=1e-9)
    assert nbytes == pytest.approx(cs.DRYRUN_PREFILL_BYTES, rel=1e-9)


@pytest.mark.parametrize("engine", ["vmap", "scan"])
def test_pod1_train_records_equal_the_card_scripts_constants(result, engine):
    """The two train records ``chip_smoke.py`` traces on the card (torch
    2.11) equal this CPU's (torch 2.13): the card is held to them within
    0.01% (FLOPs) and 0.1% (bytes)."""
    flops, nbytes = result[f"pod1 mamba2-130m train_4k_{engine}"]
    want = _chip_smoke().DRYRUN_TRAIN[engine]
    assert flops == pytest.approx(want["flops_per_chip"], rel=1e-9)
    assert nbytes == pytest.approx(want["hbm_bytes_per_chip"], rel=1e-9)
