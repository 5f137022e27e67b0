"""The port's ``launch/train.py --scenario`` entry point against the reference's.

* ``--scenario list`` prints the 46 registered cells with the reference's
  ``[sharded]`` marks and lines;
* a reduced ``--sim-rounds-per-scan 2 --device cpu`` run (and the
  ``--prefetch on|off`` runs) write their ledgers under
  ``benchmarks/artifacts/sim_torch/`` of the working directory, equal minus
  timing to ``run_scenario``'s in the same mode;
* ``--stragglers``/``--deadline`` parse as the reference's
  ``parse_stragglers`` does and run the cell under the client-state layer,
  the ledger equal minus timing to ``run_scenario``'s of the same cell with
  that ``system``; ``--sampler`` takes every zoo entry;
* the observability flags run the cell with the ``ObsConfig`` the
  reference's ``obs_from_args`` makes of them, and the checkpoint flags
  write round checkpoints that ``--resume`` continues from, the resumed
  ledger equal minus timing to the straight run's (a changed ``--sampler``
  refused by the fingerprint);
* scan with ``--shard on`` (or on a sharded cell) exits with the reference's
  message; ``--arch`` runs one round (its parity is
  ``tests/test_torch_arch_cli.py``).
"""

import argparse
import copy
import dataclasses
import json
import os

import pytest

from repro.launch import train as j_train
from repro_torch.launch import train
from repro_torch.sim import driver, scenarios


def test_scenario_list_prints_the_registry(capsys):
    train.main(["--scenario", "list"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == len(scenarios.list_scenarios()) == 46
    j_train.main(["--scenario", "list"])
    j_lines = capsys.readouterr().out.splitlines()
    assert lines == j_lines
    assert sum(line.endswith("[sharded]") for line in lines) == 6


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


STRAGGLER_FLAGS = {
    "--stragglers": ["--stragglers", "p_up=0.35,p_down=0.15,drop=0.1,over=2"],
    "--deadline": ["--deadline", "2.0"],
}


OBS_FLAGS = {
    "--metrics-port": ["--metrics-port", "0"],
    "--diag-every": ["--diag-every", "1"],
    "--obs-jsonl": ["--obs-jsonl", "ev.jsonl"],
    "--trace-dir": ["--trace-dir", "trace", "--trace-rounds", "1"],
}


def _obs_args(argv):
    """The namespace the reference's ``obs_from_args`` reads, from ``argv``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--metrics-port", type=int, default=None)
    ap.add_argument("--diag-every", type=int, default=0)
    ap.add_argument("--obs-jsonl", default=None)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--trace-rounds", type=int, default=3)
    ap.add_argument("--obs-phases", default="auto")
    return ap.parse_args(argv)


@pytest.mark.parametrize("flag", ("--stragglers", "--deadline", "--metrics-port",
                                  "--diag-every", "--obs-jsonl", "--trace-dir", "--checkpoint",
                                  "--ckpt-every", "--resume"))
def test_unported_flags_raise(flag, tmp_path, monkeypatch, capsys):
    # every flag here, once refused, now runs: the client-state flags, the
    # observability flags and the checkpoint flags
    monkeypatch.chdir(tmp_path)
    name = "femnist1-fedavg-aocs"
    base = ["--scenario", name, "--reduced", "--rounds", "3", "--device", "cpu"]
    _, straight = driver.run_scenario(name, reduced=True, rounds=3, device="cpu")
    if flag in OBS_FLAGS:
        argv = OBS_FLAGS[flag]
        obs = train.obs_from_args(_obs_args(argv), mode="prefetch")
        assert dataclasses.asdict(obs) == dataclasses.asdict(
            j_train.obs_from_args(_obs_args(argv), mode="prefetch"))
        ledger = train.main(base + argv)
        assert _timing_free(_gap_free(ledger.to_json())) == _timing_free(
            _gap_free(straight.to_json()))
        out = capsys.readouterr().out
        if flag == "--diag-every":
            assert ledger.gap_rounds == [0, 1, 2] and "Eq. 2 gap ratio" in out
        elif flag == "--obs-jsonl":
            kinds = [json.loads(line)["kind"] for line in open("ev.jsonl")]
            assert kinds.count("round") == 3 and kinds[-1] == "run_end"
        elif flag == "--trace-dir":
            assert os.listdir("trace") == ["repro-obs-rounds-0-1.pt.trace.json"]
        return
    if flag in ("--checkpoint", "--ckpt-every", "--resume"):
        every = ["--ckpt-every", "2"] if flag != "--checkpoint" else []
        first = train.main(base[:4] + ["2"] + base[5:] + ["--checkpoint", "ck", *every])
        assert sorted(os.listdir("ck")) == ["step-00000002"]
        assert first.loss == straight.loss[:2]
        if flag == "--resume":
            resumed = train.main(base + ["--resume", "ck"])
            assert _timing_free(resumed.to_json()) == _timing_free(straight.to_json())
            with pytest.raises(ValueError, match="fingerprint.*sampler"):
                train.main(base + ["--resume", "ck", "--sampler", "uniform"])
        elif flag == "--ckpt-every":
            train.main(base + ["--checkpoint", "ck1", "--ckpt-every", "1"])
            assert sorted(os.listdir("ck1")) == [f"step-0000000{k}" for k in (1, 2, 3)]
        assert "[sim] round checkpoints under ck" in capsys.readouterr().out
        return
    # the client-state flags, once refused, run the cell under the system the
    # reference's parse_stragglers makes of them
    argv = STRAGGLER_FLAGS[flag]
    system, over = train.parse_stragglers(*_straggler_args(argv))
    j_system, j_over = j_train.parse_stragglers(*_straggler_args(argv))
    assert dataclasses.asdict(system) == dataclasses.asdict(j_system) and over == j_over
    ledger = train.main(["--scenario", name, "--reduced", "--rounds", "3", "--device", "cpu",
                         "--prefetch", "off", *argv])
    sc = scenarios.get_scenario(name)
    fl = sc.fl if over is None else dataclasses.replace(sc.fl, over_select=over)
    _, want = driver.run_scenario(sc.with_(system=system, fl=fl), reduced=True, rounds=3,
                                  mode="host", device="cpu")
    assert ledger.workload["system"] == dataclasses.asdict(system)
    assert _timing_free(ledger.to_json()) == _timing_free(want.to_json())
    assert "sel " in capsys.readouterr().out


def _gap_free(doc):
    doc = copy.deepcopy(doc)
    for key in driver.GAP_SERIES:
        doc["metrics"].pop(key)
    return doc


def _straggler_args(argv):
    """``(spec, deadline)`` of one flag's argv, as ``parse_stragglers`` takes them."""
    if argv[0] == "--stragglers":
        return argv[1], None
    return None, float(argv[1])


def test_parse_stragglers_rejects_as_the_reference_does():
    for spec in ("p_up", "p_up=x", "bogus=1", "p_up=1.5"):
        with pytest.raises(SystemExit) as j_exit:
            j_train.parse_stragglers(spec, None)
        with pytest.raises(SystemExit) as t_exit:
            train.parse_stragglers(spec, None)
        assert str(t_exit.value) == str(j_exit.value)
    assert train.parse_stragglers(None, None) == (None, None)


def test_arch_and_unported_sampler_raise(tmp_path, monkeypatch):
    # --arch, once refused, now runs the arch loop (its parity with the
    # reference is tests/test_torch_arch_cli.py); the zoo samplers, once
    # refused, run through --sampler (their ledger equal minus timing to
    # run_scenario's)
    monkeypatch.chdir(tmp_path)
    _, rows = train.main(["--arch", "llama3-8b-reduced", "--rounds", "1", "--seq", "8",
                          "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["mask"].shape == (8,) and rows[0]["loss"] > 0
    ledger = train.main(["--scenario", "femnist1-fedavg-aocs", "--reduced", "--rounds", "2",
                         "--sampler", "cyclic", "--device", "cpu"])
    assert ledger.fl["sampler"] == "cyclic"
    sc = scenarios.get_scenario("femnist1-fedavg-cyclic")
    _, want = driver.run_scenario(sc.with_(name="femnist1-fedavg-aocs"), reduced=True,
                                  rounds=2, device="cpu")
    assert ledger.masks[0].tolist() == want.masks[0].tolist()
    with pytest.raises(SystemExit):
        train.main([])
