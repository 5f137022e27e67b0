"""The port's observability layer (``repro_torch.obs``) against the
reference's (``repro.obs``), its ``tests/test_obs.py`` at its sizes:

* spans, the phase names, the JSONL event stream, the gap statistics, the
  config checks and the logger; the metrics endpoint, whose
  ``render_prometheus`` gives the reference's string for one snapshot;
* the Eq. 2 gap is exactly 0.0 at full participation in all three driver
  modes on both backends (plain torch, and the kernels' plain versions
  here); at partial participation it is finite and bitwise across the
  modes; the diagnostic step's gap equals the reference's ``make_step(
  diag=True)``'s on the same inputs within rtol 1e-5 (vmap, and the scan
  engine with cached and spilled groups under rand-k), and the driver's
  gap series on ``femnist1-fedavg-aocs`` (reduced, ``diag_every=2``) has
  the reference's ``gap_rounds`` and its ``gap_ratio`` within rtol 1e-4;
* a mesh with ``diag_every`` raises; telemetry on leaves the ledger
  byte-identical minus wall clock and the gap series; the phased step's
  masks and parameters equal the fused step's bitwise; the live endpoint
  and the ``trace_dir`` profile during a run.
"""

import dataclasses
import gzip
import json
import os
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.fl.engine import RoundEngine as JRoundEngine
from repro.obs import ObsConfig as JObsConfig
from repro.obs import render_prometheus as j_render_prometheus
from repro.sim import run_scenario as j_run_scenario
from repro_torch import rng
from repro_torch.configs.base import FLConfig
from repro_torch.convert import params_from_jax
from repro_torch.data import femnist_like
from repro_torch.fl.engine import RoundEngine
from repro_torch.fl.round import client_weights
from repro_torch.kernels.ops import tree_leaves
from repro_torch.models.simple import mlp_classifier
from repro_torch.obs import (
    OBS_SCHEMA,
    PHASES,
    EventLog,
    MetricsServer,
    ObsConfig,
    Telemetry,
    flat_gap_stats,
    gap_ratio,
    get_logger,
    render_prometheus,
    span,
    tree_gap_stats,
)
from repro_torch.obs.events import read_events
from repro_torch.obs.phased import make_phased_step
from repro_torch.sim.driver import run_scenario, validate_ledger
from repro_torch.sim.scenarios import get_scenario


def _strip_obs(doc):
    doc = json.loads(json.dumps(doc))
    doc.pop("wall_s", None)
    doc.pop("rounds_per_sec", None)
    for k in ("wall_ms", "gap_rounds", "gap_sq", "gap_full_sq", "gap_ratio"):
        doc["metrics"].pop(k, None)
    return doc


def test_span_times_and_records():
    class Sink:
        def __init__(self):
            self.got = []

        def record_span(self, name, seconds):
            self.got.append((name, seconds))

    sink = Sink()
    with span("aggregate", sink) as sp:
        time.sleep(0.01)
        sp.block({"a": torch.zeros(3), "b": (torch.ones(1),)})
    assert sp.seconds >= 0.01 and sink.got == [("aggregate", sp.seconds)]
    with span("sample") as sp2:
        pass
    assert sp2.seconds >= 0.0
    assert PHASES == ("sample", "local_update", "compress", "aggregate", "server_opt")


def test_eventlog_gap_stats_config_and_logger(tmp_path, capsys):
    path = str(tmp_path / "events.jsonl")
    log = EventLog(path)
    for kind, kw in (("run_start", {"scenario": "x"}), ("round", {"round": 0}),
                     ("gap", {"gap_ratio": 0.25}), ("run_end", {"rounds": 2})):
        log.emit(kind, **kw)
    log.close()
    events = read_events(path)
    assert [e["kind"] for e in events] == ["run_start", "round", "gap", "run_end"]
    assert all(e["schema"] == OBS_SCHEMA == 1 and isinstance(e["ts"], float) for e in events)
    s_hat, s = torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 0.0, 3.0])
    gs = flat_gap_stats(s_hat, s)
    assert float(gs.gap_sq) == 4.0 and float(gs.full_sq) == 10.0
    tree = tree_gap_stats({"a": s_hat, "b": s}, {"a": s, "b": s})
    assert float(tree.gap_sq) == 4.0 and float(tree.full_sq) == 20.0
    assert gap_ratio(4.0, 10.0) == pytest.approx(0.4) and gap_ratio(1.0, 0.0) == 0.0
    assert not ObsConfig().enabled and ObsConfig(diag_every=2).enabled
    assert ObsConfig(metrics_port=0).enabled and ObsConfig(phases=True).enabled
    for kw, msg in ((dict(diag_every=-1), "diag_every"), (dict(trace_rounds=0), "trace_rounds"),
                    (dict(metrics_port=70000), "metrics_port")):
        with pytest.raises(ValueError, match=msg):
            ObsConfig(**kw)
    a = get_logger("obs-test")
    assert a is get_logger("obs-test") and len(a.handlers) == 1
    a.info("hello %d", 7)
    assert "[obs-test] hello 7" in capsys.readouterr().out


def test_metrics_server_scrape_renders_the_references_text():
    snap = {
        "run": {"scenario": "demo", "mode": "host"},
        "round": 3, "rounds_total": 4, "loss": 0.5, "rounds_per_sec": 2.5,
        "uplink_bits_total": 1000, "dropouts_total": 2,
        "phase_seconds": {p: 0.01 for p in PHASES},
        "gap": {"round": 2, "gap_sq": 1.0, "full_sq": 4.0, "gap_ratio": 0.25},
    }
    assert render_prometheus(snap) == j_render_prometheus(snap)
    server = MetricsServer(port=0).start()
    try:
        server.update(snap)
        with urllib.request.urlopen(f"{server.url}/") as r:
            assert json.loads(r.read())["gap"]["gap_ratio"] == 0.25
        with urllib.request.urlopen(f"{server.url}/metrics") as r:
            body = r.read().decode()
        assert body == render_prometheus(snap)
        assert "repro_rounds_total 4" in body and "repro_gap_ratio 0.25" in body
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{server.url}/nope")
    finally:
        server.stop()


def _with_backend(name, backend):
    sc = get_scenario(name)
    return sc.with_(fl=dataclasses.replace(sc.fl, agg_backend=backend))


@pytest.mark.parametrize("backend", ("jnp", "pallas"))
@pytest.mark.parametrize("mode", ("host", "prefetch", "scan"))
def test_gap_zero_at_full_participation(mode, backend):
    _, led = run_scenario(_with_backend("femnist1-fedavg-full", backend), reduced=True,
                          mode=mode, rounds=4, rounds_per_scan=2, device="cpu",
                          obs=ObsConfig(diag_every=1))
    validate_ledger(led.to_json())
    assert led.gap_rounds == [0, 1, 2, 3]
    assert led.gap_sq == [0.0] * 4 and led.gap_ratio == [0.0] * 4
    assert all(fs > 0.0 for fs in led.gap_full_sq)


@pytest.fixture(scope="module")
def reference_gaps():
    _, led = j_run_scenario("femnist1-fedavg-aocs", reduced=True, mode="host", rounds=5,
                            obs=JObsConfig(diag_every=2))
    return led


def test_gap_finite_for_partial_sampling(reference_gaps):
    by_mode = {}
    for mode in ("host", "prefetch", "scan"):
        _, led = run_scenario("femnist1-fedavg-aocs", reduced=True, mode=mode, rounds=5,
                              rounds_per_scan=1, device="cpu", obs=ObsConfig(diag_every=2))
        validate_ledger(led.to_json())
        assert led.gap_rounds == [0, 2, 4]
        assert all(np.isfinite(g) and g > 0.0 for g in led.gap_sq)
        assert all(fs > 0.0 for fs in led.gap_full_sq)
        by_mode[mode] = led
    for mode in ("prefetch", "scan"):
        assert by_mode[mode].gap_ratio == by_mode["host"].gap_ratio, mode
        assert by_mode[mode].gap_sq == by_mode["host"].gap_sq, mode
    # the reference's series on the same cell: same rounds and cohorts
    assert by_mode["host"].gap_rounds == reference_gaps.gap_rounds
    for a, b in zip(by_mode["host"].masks, reference_gaps.masks):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(by_mode["host"].gap_ratio, reference_gaps.gap_ratio, rtol=1e-4)


@pytest.mark.parametrize("memory", ("vmap", "scan"))
def test_diag_step_gap_matches_the_reference(memory):
    """The diagnostic step's gap against the reference's on the same
    parameters, batch and key; the scan engine with one cached and three
    spilled groups under rand-k (both post-plan loops)."""
    ds = femnist_like(1, n_clients=16, dim=32, num_classes=10, base_examples=16, seed=0)
    init, loss, _ = mlp_classifier(ds.input_dim, ds.num_classes, hidden=8)
    from repro.models.simple import mlp_classifier as j_mlp

    j_init, j_loss, _ = j_mlp(ds.input_dim, ds.num_classes, hidden=8)
    kw = dict(n_clients=8, expected_clients=3, local_steps=1, lr_local=0.1,
              compression="randk", compression_param=0.5, round_engine=memory,
              scan_group=2, cache_groups=1)
    p0 = jax.device_get(j_init(jax.random.PRNGKey(1)))
    batch = ds.sample_round_batches(np.random.default_rng(0), np.arange(8), 1, 4)
    w = client_weights(FLConfig(**kw), device="cpu")
    _, _, mt = RoundEngine(loss, FLConfig(**kw), device="cpu").make_step(diag=True)(
        params_from_jax(p0, "cpu"), (), {k: torch.as_tensor(v) for k, v in batch.items()},
        w, rng.PRNGKey(100))
    _, _, mj = jax.jit(JRoundEngine(j_loss, JFLConfig(**kw)).make_step(diag=True))(
        p0, (), {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(w.numpy()),
        jax.random.PRNGKey(100))
    np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    assert float(mt.gap.gap_sq) > 0.0
    np.testing.assert_allclose(float(mt.gap.gap_sq), float(mj.gap.gap_sq), rtol=1e-5)
    np.testing.assert_allclose(float(mt.gap.full_sq), float(mj.gap.full_sq), rtol=1e-5)
    # the default step is the diag step minus the gap, bitwise
    pt, _, mp = RoundEngine(loss, FLConfig(**kw), device="cpu").make_step()(
        params_from_jax(p0, "cpu"), (), {k: torch.as_tensor(v) for k, v in batch.items()},
        w, rng.PRNGKey(100))
    assert mp.gap is None and torch.equal(mp.mask, mt.mask) and torch.equal(mp.loss, mt.loss)


def test_gap_rejected_on_mesh():
    with pytest.raises(ValueError, match="gap estimator"):
        run_scenario("femnist1-fedavg-aocs-shard-randk", reduced=True, mode="prefetch",
                     rounds=2, obs=ObsConfig(diag_every=1), device="cpu")
    with pytest.raises(TypeError, match="ObsConfig or Telemetry"):
        run_scenario("femnist1-fedavg-aocs", reduced=True, rounds=1, obs=object(),
                     device="cpu")


def test_telemetry_off_ledger_identity(tmp_path):
    name = "femnist1-fedavg-aocs-straggler"
    docs = {}
    for tag, obs in (("off", None), ("inert", ObsConfig()),
                     ("on", ObsConfig(diag_every=2, metrics_port=0,
                                      jsonl=str(tmp_path / "ev.jsonl")))):
        _, led = run_scenario(name, reduced=True, mode="prefetch", rounds=4, seed=11,
                              obs=obs, device="cpu")
        docs[tag] = json.dumps(_strip_obs(led.to_json(include_masks=True)), sort_keys=True)
    assert docs["inert"] == docs["off"] and docs["on"] == docs["off"]
    kinds = [e["kind"] for e in read_events(str(tmp_path / "ev.jsonl"))]
    assert kinds.count("round") == 4 and kinds.count("gap") == 2
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"


def test_phased_step_equals_the_fused_step():
    """The port's phases run the fused step's ops in its order: masks AND
    parameters bitwise (the reference's jitted phases agree only to float
    tolerance), with and without the gap."""
    ds = femnist_like(1, n_clients=16, dim=32, num_classes=10, base_examples=16, seed=0)
    init, loss, _ = mlp_classifier(ds.input_dim, ds.num_classes, hidden=8)
    fl = FLConfig(n_clients=8, expected_clients=3, local_steps=1, lr_local=0.1,
                  compression="randk", compression_param=0.5, agg_backend="pallas")
    engine = RoundEngine(loss, fl, device="cpu")
    key = rng.PRNGKey(0)
    params = init(rng.fold_in(key, 1))
    w = client_weights(fl, device="cpu")
    batch = ds.sample_round_batches(np.random.default_rng(0), np.arange(8), 1, 4)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    k_round = rng.fold_in(key, 100)

    class Sink:
        def __init__(self):
            self.names = []

        def record_span(self, name, seconds):
            self.names.append(name)

    sink = Sink()
    phased = make_phased_step(engine, sink)
    for diag in (False, True):
        p_f, _, m_f = engine.make_step(diag=diag)(params, (), batch, w, k_round)
        p_p, _, m_p = phased(params, (), batch, w, k_round, diag=diag)
        assert torch.equal(m_f.mask, m_p.mask) and torch.equal(m_f.loss, m_p.loss)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_f), tree_leaves(p_p)))
        if diag:
            assert torch.equal(m_f.gap.gap_sq, m_p.gap.gap_sq)
    assert sorted(set(sink.names)) == sorted(PHASES)
    with pytest.raises(ValueError, match="vmap-memory"):
        make_phased_step(RoundEngine(loss, dataclasses.replace(fl, round_engine="scan"),
                                     device="cpu"))


def test_validate_ledger_gap_rejections():
    _, led = run_scenario("femnist1-fedavg-aocs", reduced=True, mode="prefetch", rounds=3,
                          obs=ObsConfig(diag_every=2), device="cpu")
    doc = led.to_json()
    validate_ledger(doc)
    for edit, msg in (
        (lambda m: m.__setitem__("gap_sq", m["gap_sq"][:-1]), "ragged gap"),
        (lambda m: m.__setitem__("gap_ratio", [-1.0] * len(m["gap_ratio"])),
         "negative values in gap"),
        (lambda m: m.pop("wall_ms"), "wall_ms"),
    ):
        bad = json.loads(json.dumps(doc))
        edit(bad["metrics"])
        with pytest.raises(ValueError, match=msg):
            validate_ledger(bad)


def test_live_endpoint_and_trace_during_a_run(tmp_path):
    """A caller-owned Telemetry: a phased host-mode run with the gap
    estimator on and a profiler window; the endpoint stays live after it,
    and the Chrome trace holds the phases' slices."""
    tel = Telemetry(ObsConfig(metrics_port=0, diag_every=2, phases=True,
                              jsonl=str(tmp_path / "ev.jsonl"),
                              trace_dir=str(tmp_path / "trace"), trace_rounds=2))
    try:
        _, led = run_scenario("femnist1-fedavg-aocs", reduced=True, mode="host", rounds=4,
                              obs=tel, device="cpu")
        with urllib.request.urlopen(f"{tel.url}/metrics") as r:
            body = r.read().decode()
        assert "repro_rounds_total 4" in body and "repro_gap_ratio" in body
        for p in PHASES:
            assert f'repro_phase_seconds{{phase="{p}"}}' in body
        with urllib.request.urlopen(f"{tel.url}/") as r:
            snap = json.loads(r.read())
        assert snap["rounds_total"] == 4 and set(PHASES) <= set(snap["phase_seconds"])
        assert led.gap_rounds == [0, 2]
    finally:
        tel.close()
    (trace,) = os.listdir(tmp_path / "trace")
    assert trace == "repro-obs-rounds-0-2.pt.trace.json"
    path = tmp_path / "trace" / trace
    text = (gzip.open if trace.endswith(".gz") else open)(path, "rt").read()
    names = {e.get("name") for e in json.loads(text)["traceEvents"]}
    assert {f"repro.obs/{p}" for p in PHASES} <= names
