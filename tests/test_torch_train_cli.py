"""The port's ``launch/train.py --scenario`` entry point against the reference's.

* ``--scenario list`` prints the 21 registered cells with the reference's
  ``[sharded]`` marks and lines;
* a reduced ``--sim-rounds-per-scan 2 --device cpu`` run (and the
  ``--prefetch on|off`` runs) write their ledgers under
  ``benchmarks/artifacts/sim_torch/`` of the working directory, equal minus
  timing to ``run_scenario``'s in the same mode;
* scan with ``--shard on`` (or on a sharded cell) exits with the reference's
  message; ``--arch``, the client-state, observability and checkpoint flags,
  and an unported sampler raise ``NotImplementedError``.
"""

import copy
import json

import pytest

from repro.launch import train as j_train
from repro_torch.launch import train
from repro_torch.sim import driver, scenarios


def test_scenario_list_prints_the_registry(capsys):
    train.main(["--scenario", "list"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(scenarios.list_scenarios()) == 21
    j_train.main(["--scenario", "list"])
    j_lines = set(capsys.readouterr().out.splitlines())
    assert set(lines) <= j_lines
    assert sum(line.endswith("[sharded]") for line in lines) == 3


def _timing_free(doc):
    doc = copy.deepcopy(doc)
    doc["metrics"].pop("wall_ms")
    for key in ("wall_s", "rounds_per_sec"):
        doc.pop(key)
    return doc


@pytest.mark.parametrize("flags,mode", (
    (["--sim-rounds-per-scan", "2"], "scan"),
    (["--prefetch", "on"], "prefetch"),
    (["--prefetch", "off"], "host"),
), ids=("scan", "prefetch", "host"))
def test_reduced_run_writes_its_ledger(tmp_path, monkeypatch, capsys, flags, mode):
    monkeypatch.chdir(tmp_path)
    name = "femnist1-fedavg-aocs"
    ledger = train.main(["--scenario", name, "--reduced", "--rounds", "3",
                         "--device", "cpu", *flags])
    path = tmp_path / "benchmarks" / "artifacts" / "sim_torch" / f"{name}-reduced-{mode}.json"
    doc = json.loads(path.read_text())
    driver.validate_ledger(doc)
    assert doc["mode"] == mode and len(doc["metrics"]["loss"]) == 3
    assert doc["workload"].get("rounds_per_scan") == (2 if mode == "scan" else None)
    _, want = driver.run_scenario(name, reduced=True, rounds=3, mode=mode, rounds_per_scan=2,
                                  device="cpu")
    assert _timing_free(doc) == _timing_free(want.to_json()) == _timing_free(ledger.to_json())
    out = capsys.readouterr().out
    assert f"mode={mode} rounds=3" in out and "[round   2] loss" in out
    assert "rounds/s (steady-state)" in out


def test_sharded_cell_runs_on_its_mesh(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    name = "femnist1-fedavg-aocs-shard-randk"
    ledger = train.main(["--scenario", name, "--reduced", "--rounds", "2", "--device", "cpu"])
    assert ledger.workload["mesh_axis_size"] == 1 and ledger.mode == "prefetch"
    assert "mode=prefetch mesh=1" in capsys.readouterr().out
    off = train.main(["--scenario", name, "--reduced", "--rounds", "2", "--device", "cpu",
                      "--shard", "off", "--sim-rounds-per-scan", "2"])
    assert "mesh_axis_size" not in off.workload and off.masks[0].tolist() == \
        ledger.masks[0].tolist()


@pytest.mark.parametrize("name", ("femnist1-fedavg-aocs", "femnist1-fedavg-aocs-shard"))
def test_scan_with_a_mesh_exits_with_the_reference_message(name):
    argv = ["--scenario", name, "--reduced", "--sim-rounds-per-scan", "2", "--shard", "on"]
    with pytest.raises(SystemExit) as j_exit:
        j_train.main(argv)
    with pytest.raises(SystemExit) as t_exit:
        train.main(argv + ["--device", "cpu"])
    assert str(t_exit.value) == str(j_exit.value)
    assert "--sim-rounds-per-scan and a mesh conflict" in str(t_exit.value)


@pytest.mark.parametrize("flag", ("--stragglers", "--deadline", "--metrics-port",
                                  "--diag-every", "--obs-jsonl", "--trace-dir", "--checkpoint",
                                  "--ckpt-every", "--resume"))
def test_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match=f"{flag} is not ported yet"):
        train.main(["--scenario", "femnist1-fedavg-aocs", "--reduced", "--device", "cpu",
                    flag, "1"])


def test_arch_and_unported_sampler_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="item 5"):
        train.main(["--arch", "llama3-8b-reduced"])
    with pytest.raises(NotImplementedError, match="not ported"):
        train.main(["--scenario", "femnist1-fedavg-aocs", "--reduced", "--rounds", "1",
                    "--sampler", "cyclic", "--device", "cpu"])
    with pytest.raises(SystemExit):
        train.main([])
