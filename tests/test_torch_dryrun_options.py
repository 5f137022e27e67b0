"""The port's dry-run (``repro_torch/launch/dryrun.py``) beyond its main
pass, in subprocesses on a fake process group (``--device cpu``), at the
size of ``test_torch_dryrun_trace.py`` (llama3-8b reduced, vocab 256, seq
64, batch 8, 4 clients, a (4, 2) mesh):

* a second trace of the round counts what the first, cold one did;
* the round's options trace and move collective traffic: the scan engine,
  and ``out_shard`` (the updated parameters back to their storage layout);
* the scan engine's group loops, one group of each counted n times (as the
  dry-run samples them, ``models/layers.py::BlockLoop``), count what every
  group run in full counts: 4 groups of one client, 2 cached and 2 spilled;
* a model five layers deep counts what steps two and three layers deep on
  its arguments extrapolate to (``count_step``);
* the CLI writes the reference's record keys for a pair.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))

SCRIPT = r"""
import dataclasses, json
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun as D, specs as SP
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.fl import engine as E
from repro_torch.models import layers as L

cfg = ARCHS["llama3-8b"].reduced().with_(vocab_size=256)
small = {n: dataclasses.replace(s, seq_len=64, global_batch=8) for n, s in SHAPES.items()}
fl = SP.fl_config_for(cfg, small["train_4k"], n_clients=4)
SP.fl_config_for = lambda *a, **k: fl
mesh = make_debug_mesh(4, 2, device="cpu")
out = {}
# a second trace of a step (every plan cached) counts what the first did
runs = [D.trace(D.build_lowered(cfg, small["train_4k"], mesh)) for _ in range(2)]
out["twice"] = [[c.flops, c.bytes, c.peak_bytes, c.coll.traffic_bytes] for c in runs]
for name, kw in (("scan", {"fl_mode": "scan"}), ("out_shard", {"out_shard": True})):
    c = D.trace(D.build_lowered(cfg, small["train_4k"], mesh, **kw))
    out[name] = {"flops": c.flops, "traffic": c.coll.total_traffic()}
# the scan engine's group loops sampled, and every group run
fl_scan = dataclasses.replace(fl, cache_groups=2)
SP.fl_config_for = lambda *a, **k: fl_scan


class FullLoop(L.BlockLoop):
    def __init__(self, n, *tensors):
        super().__init__(n)
        self.repeat = None


loops = []
for loop in (L.BlockLoop, FullLoop):
    E.BlockLoop = loop
    c = D.trace(D.build_lowered(cfg, small["train_4k"], mesh, fl_mode="scan", scan_group=1))
    loops.append([c.flops, c.bytes, c.coll.traffic_bytes, c.coll.counts, c.sampled_iterations])
E.BlockLoop = L.BlockLoop
SP.fl_config_for = lambda *a, **k: fl
out["scan_loops"] = loops
deep = cfg.with_(num_layers=5)
for shape in ("train_4k", "decode_32k"):
    full = D.trace(D.build_lowered(deep, small[shape], mesh))
    ext, depths = D.count_step(deep, small[shape], mesh)
    out["deep_" + shape] = {
        "depths": depths, "flops": [full.flops, ext.flops], "bytes": [full.bytes, ext.bytes],
        "traffic": [full.coll.traffic_bytes, ext.coll.traffic_bytes],
        "counts": [full.coll.counts, ext.coll.counts], "peak": [full.peak_bytes, ext.peak_bytes]}
print("DRYRUN-RESULT " + json.dumps(out))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def result():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    line = [x for x in out.stdout.splitlines() if x.startswith("DRYRUN-RESULT ")]
    assert line, out.stdout[-3000:] + out.stderr[-6000:]
    return json.loads(line[0].split(" ", 1)[1])


def test_a_second_trace_counts_the_same(result):
    """DTensor plans an op once and caches the plan: the fake ops of its
    planning are not counted, so a cold and a warm trace agree."""
    first, second = result["twice"]
    assert first == second and first[0] > 0


@pytest.mark.parametrize("option", ["scan", "out_shard"])
def test_round_options_trace(result, option):
    assert result[option]["flops"] > 0 and result[option]["traffic"] > 0


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_depth_extrapolation_counts_every_layer(result, shape):
    """Counts at five layers, from steps two and three layers deep on the
    five-layer arguments, equal the step run through all five: FLOPs,
    collectives and peak exactly, bytes within 0.1% (the round's bytes
    outside the layers shift by a few elementwise ops with the depth run)."""
    r = result["deep_" + shape]
    assert r["depths"] == [{"num_layers": 2}, {"num_layers": 3}]
    assert r["flops"][0] == r["flops"][1] > 0
    assert r["traffic"][0] == r["traffic"][1] and r["counts"][0] == r["counts"][1]
    assert r["peak"][0] == r["peak"][1]
    assert abs(r["bytes"][0] - r["bytes"][1]) <= 1e-3 * r["bytes"][0]


def test_cli_writes_records_and_skips(tmp_path):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu",
           "--out", str(tmp_path)]
    out = subprocess.run(cmd + ["--arch", "mamba2-130m", "--shape", "decode_32k"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = json.loads((tmp_path / "mamba2-130m__decode_32k.json").read_text())
    assert rec["mesh"] == "pod1" and rec["chips"] == 256
    assert rec["flops_per_chip"] > 0 and rec["memory_s"] > 0
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    for key in ("compute_model_s", "collective_s", "useful_flops_ratio", "peak_memory_bytes",
                "trace_s", "replicated_ops", "traced_depths", "params", "active_params"):
        assert key in rec


def test_scan_group_loops_sampled_count_the_full_loops(result):
    """FLOPs and collectives exactly; bytes within 0.5%: the first spilled
    group's sum turns the replicated accumulator into a partial sum (a
    division), which the later groups' do not repeat."""
    (sampled, full) = result["scan_loops"]
    assert sampled[4] > 0 and full[4] == 0
    assert sampled[0] == full[0] > 0
    assert sampled[2:4] == full[2:4]
    assert abs(sampled[1] - full[1]) <= 5e-3 * full[1]
