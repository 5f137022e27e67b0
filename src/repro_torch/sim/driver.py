"""Multi-round simulation driver: the paper's Sec. 4 evaluation loop, with a
structured metrics ledger and versioned JSON artifacts.

Ported from ``repro/sim/driver.py`` for the ``'host'`` mode: numpy batch
assembly and upload every round, synchronous with the round step.  The loop
consumes the host RNG (cohort draw without replacement, per-client example
permutations) and the round keys (``fold_in(PRNGKey(seed), 1000 + k)``) in
the reference's exact order, and :mod:`repro_torch.rng` reproduces jax's
keys, so a run draws the reference's cohorts, batches and — whenever the
norms agree — its participation masks.

Every run fills a :class:`SimLedger` (schema 3, the reference's artifact
contract: ``validate_ledger`` accepts the same documents as the reference's).

Not ported yet: the ``'prefetch'`` and ``'scan'`` modes, telemetry
(``obs``), checkpoint/resume, the client-state layer (``system``) and the
mesh; each raises ``NotImplementedError``.  Until prefetch lands,
``run_simulation`` and ``run_scenario`` default to ``mode='host'`` (the
reference defaults to ``'prefetch'``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import rng as trng
from repro_torch._device import resolve_device
from repro_torch.fl.engine import RoundEngine
from repro_torch.fl.round import client_weights, round_bits_duplex
from repro_torch.kernels.ops import tree_leaves
from repro_torch.sim.scenarios import get_scenario

SIM_SCHEMA = 3
MODES = ("host", "prefetch", "scan")

# per-round series every schema-3 ledger must carry, all the same length
LEDGER_SERIES = (
    "loss", "alpha", "gamma", "sent", "expected_clients",
    "over_selected", "deadline_misses", "dropouts",
    "uplink_bits", "downlink_bits", "wall_ms",
)

# sparse per-diagnostic-round series (empty: no gap estimator in the port yet)
GAP_SERIES = ("gap_rounds", "gap_sq", "gap_full_sq", "gap_ratio")


@dataclass
class SimLedger:
    """Structured metrics ledger of one simulation run (artifact schema 3).

    Per-round series (``LEDGER_SERIES``; the system-layer counters are zeros
    in this slice, and ``wall_ms`` is each round's time on the monotonic
    clock, ending in a device sync), the sparse gap series and the eval curve
    (empty in this slice) and the run's throughput.  ``masks``/``norms`` are
    kept in memory for parity checks and written to JSON only on request.
    """

    mode: str
    scenario: str | None = None
    fl: dict = field(default_factory=dict)
    workload: dict = field(default_factory=dict)
    loss: list = field(default_factory=list)
    alpha: list = field(default_factory=list)
    gamma: list = field(default_factory=list)
    sent: list = field(default_factory=list)
    expected_clients: list = field(default_factory=list)
    over_selected: list = field(default_factory=list)
    deadline_misses: list = field(default_factory=list)
    dropouts: list = field(default_factory=list)
    uplink_bits: list = field(default_factory=list)      # cumulative
    downlink_bits: list = field(default_factory=list)    # cumulative
    wall_ms: list = field(default_factory=list)
    gap_rounds: list = field(default_factory=list)
    gap_sq: list = field(default_factory=list)
    gap_full_sq: list = field(default_factory=list)
    gap_ratio: list = field(default_factory=list)
    acc_rounds: list = field(default_factory=list)
    acc: list = field(default_factory=list)
    masks: list = field(default_factory=list)            # (n,) bool per round
    norms: list = field(default_factory=list)            # (n,) f32 per round
    wall_s: float = 0.0
    rounds_per_sec: float = 0.0                          # after the first round

    def to_json(self, include_masks: bool = False) -> dict:
        """The schema-3 artifact document (see :func:`validate_ledger`)."""
        doc = {
            "schema": SIM_SCHEMA,
            "scenario": self.scenario,
            "mode": self.mode,
            "fl": self.fl,
            "workload": self.workload,
            "metrics": {
                name: getattr(self, name)
                for name in LEDGER_SERIES + GAP_SERIES + ("acc_rounds", "acc")
            },
            "wall_s": self.wall_s,
            "rounds_per_sec": self.rounds_per_sec,
        }
        if include_masks:
            doc["masks"] = [np.asarray(m).astype(int).tolist() for m in self.masks]
        return doc

    def write(self, path: str, include_masks: bool = False) -> str:
        """Serialise the ledger as a JSON artifact; returns the path."""
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(include_masks=include_masks), f, indent=1)
        return path


def validate_ledger(doc: dict) -> None:
    """Assert the schema-3 ledger contract; raises ``ValueError`` on breach.

    The same contract as the reference's ``validate_ledger``: every
    ``LEDGER_SERIES`` list present and of one non-zero length, finite
    loss/alpha/gamma/wall_ms, non-negative wall_ms and counters, the
    ``GAP_SERIES`` rectangular, finite and non-negative, cumulative bit
    series non-decreasing, and the throughput fields present.
    """
    if doc.get("schema") != SIM_SCHEMA:
        raise ValueError(f"ledger schema {doc.get('schema')!r} != {SIM_SCHEMA}")
    if doc.get("mode") not in MODES:
        raise ValueError(f"ledger mode {doc.get('mode')!r} not in {MODES}")
    for block in ("fl", "workload", "metrics"):
        if not isinstance(doc.get(block), dict):
            raise ValueError(f"ledger is missing the {block!r} block")
    metrics = doc["metrics"]
    n = None
    for series in LEDGER_SERIES:
        vals = metrics.get(series)
        if not isinstance(vals, list):
            raise ValueError(f"ledger metrics lack the {series!r} series")
        if n is None:
            n = len(vals)
        if len(vals) != n:
            raise ValueError(
                f"ragged ledger: {series!r} has {len(vals)} entries, want {n}"
            )
    if not n:
        raise ValueError("ledger records zero rounds")
    for series in ("loss", "alpha", "gamma", "wall_ms"):
        if not np.all(np.isfinite(np.asarray(metrics[series], np.float64))):
            raise ValueError(f"non-finite values in ledger series {series!r}")
    if np.any(np.asarray(metrics["wall_ms"], np.float64) < 0):
        raise ValueError("negative wall_ms in ledger")
    for series in ("acc_rounds", "acc"):
        if not isinstance(metrics.get(series), list):
            raise ValueError(f"ledger metrics lack the {series!r} series")
    if len(metrics["acc_rounds"]) != len(metrics["acc"]):
        raise ValueError("acc_rounds and acc series lengths differ")
    m_gap = None
    for series in GAP_SERIES:
        vals = metrics.get(series)
        if not isinstance(vals, list):
            raise ValueError(f"ledger metrics lack the {series!r} series")
        if m_gap is None:
            m_gap = len(vals)
        if len(vals) != m_gap:
            raise ValueError(
                f"ragged gap series: {series!r} has {len(vals)}, want {m_gap}"
            )
        arr = np.asarray(vals, np.float64)
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"non-finite values in gap series {series!r}")
        if np.any(arr < 0):
            raise ValueError(f"negative values in gap series {series!r}")
    for series in ("over_selected", "deadline_misses", "dropouts"):
        if np.any(np.asarray(metrics[series], np.int64) < 0):
            raise ValueError(f"negative counts in ledger series {series!r}")
    for series in ("uplink_bits", "downlink_bits"):
        if np.any(np.diff(np.asarray(metrics[series], np.int64)) < 0):
            raise ValueError(f"cumulative series {series!r} decreases")
    if "rounds_per_sec" not in doc or "wall_s" not in doc:
        raise ValueError("ledger lacks throughput fields")


def _reject_unported(mode, **given):
    if mode not in MODES:
        raise ValueError(f"unknown sim mode {mode!r}; want one of {MODES}")
    if mode != "host":
        raise NotImplementedError(
            f"sim mode {mode!r} is not ported yet: it lands with the driver-modes "
            f"slice of the port (use mode='host')"
        )
    for name, value in given.items():
        if value is not None:
            raise NotImplementedError(f"run_simulation({name}=...) is not ported yet")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_simulation(
    dataset,
    init_fn,
    loss_fn,
    fl,
    rounds: int,
    *,
    batch_size: int = 20,
    mode: str = "host",
    seed: int = 0,
    local_epoch: bool = True,
    server_opt=None,
    mesh=None,
    system=None,
    scenario_name: str | None = None,
    artifact: str | None = None,
    obs=None,
    checkpoint=None,
    resume=None,
    device=None,
) -> tuple:
    """Run ``rounds`` communication rounds; returns ``(params, SimLedger)``.

    Each round draws the cohort (``rng.choice`` without replacement), the
    per-client example permutations and the round key
    (``fold_in(key, 1000 + k)``) in the reference's order, runs one vmap
    round step on ``device`` (``None`` means CUDA and raises without one;
    pass ``device='cpu'``), and waits for it.  ``init_fn(key)`` gets
    ``fold_in(PRNGKey(seed), 1)``.  ``fl.weights == 'data_size'`` takes each
    cohort's slice of ``dataset.sizes()``, normalised per round.
    ``artifact`` (a path) serialises the ledger on completion.
    """
    _reject_unported(mode, server_opt=server_opt, mesh=mesh, system=system,
                     obs=obs, checkpoint=checkpoint, resume=resume)
    if fl.n_clients > dataset.n_clients:
        raise ValueError(
            f"FLConfig.n_clients={fl.n_clients} exceeds the dataset's client "
            f"pool of {dataset.n_clients} clients: each round draws the cohort "
            f"without replacement, so n_clients must be <= the pool size"
        )
    dev = resolve_device(device)
    round_step = RoundEngine(loss_fn, fl, device=dev).make_step()

    rng = np.random.default_rng(seed)
    key = trng.PRNGKey(seed, device=dev)
    params = init_fn(trng.fold_in(key, 1))
    dim = sum(leaf.numel() for leaf in tree_leaves(params))
    opt_state = ()
    sizes = np.asarray(dataset.sizes())
    uniform_w = client_weights(fl, device=dev)

    def cohort_weights(clients):
        if fl.weights == "data_size":
            return client_weights(fl, sizes[np.asarray(clients)], device=dev)
        return uniform_w

    dev_metrics, wall_ms = [], []
    t_start = time.perf_counter()
    t_first = None
    for k in range(rounds):
        t_round = time.perf_counter()
        clients = rng.choice(dataset.n_clients, size=fl.n_clients, replace=False)
        w = cohort_weights(clients)
        batch = dataset.sample_round_batches(
            rng, clients, fl.local_steps, batch_size, local_epoch
        )
        batch = {bk: torch.as_tensor(v, device=dev) for bk, v in batch.items()}
        kk = trng.fold_in(key, 1000 + k)
        params, opt_state, metrics = round_step(params, opt_state, batch, w, kk)
        dev_metrics.append(metrics)
        # the host loop is synchronous: it waits for the round before
        # assembling the next round's batch
        _sync(dev)
        if t_first is None:
            t_first = time.perf_counter()
        wall_ms.append((time.perf_counter() - t_round) * 1e3)
    _sync(dev)
    t_end = time.perf_counter()

    ledger = SimLedger(
        mode=mode,
        scenario=scenario_name,
        fl=dataclasses.asdict(fl),
        workload={
            "rounds": rounds,
            "batch_size": batch_size,
            "pool_clients": int(dataset.n_clients),
            "model_dim": dim,
            "seed": seed,
            "local_epoch": bool(local_epoch),
            "backend_platform": dev.type,
        },
    )

    def rows(name):
        return torch.stack([getattr(m, name) for m in dev_metrics]).cpu().numpy()

    masks = rows("mask").astype(bool)
    up_total = down_total = 0
    for i, (loss, alpha, gamma, sent, expected, selected) in enumerate(zip(
        rows("loss"), rows("alpha"), rows("gamma"), rows("sent_clients"),
        rows("expected_clients"), rows("selected_clients"),
    )):
        up, down = round_bits_duplex(fl, dim, masks[i])
        up_total += int(up)
        down_total += int(down)
        ledger.loss.append(float(loss))
        ledger.alpha.append(float(alpha))
        ledger.gamma.append(float(gamma))
        ledger.sent.append(int(sent))
        ledger.expected_clients.append(float(expected))
        ledger.over_selected.append(int(selected))
        ledger.deadline_misses.append(0)
        ledger.dropouts.append(0)
        ledger.uplink_bits.append(up_total)
        ledger.downlink_bits.append(down_total)
        ledger.wall_ms.append(float(wall_ms[i]))
    ledger.masks = list(masks)
    ledger.norms = list(rows("norms").astype(np.float32))
    ledger.wall_s = t_end - t_start
    steady = rounds - 1
    if t_first is not None and steady > 0 and t_end > t_first:
        ledger.rounds_per_sec = steady / (t_end - t_first)
    else:
        ledger.rounds_per_sec = rounds / max(t_end - t_start, 1e-9)
    if artifact:
        ledger.write(artifact)
    return params, ledger


def run_scenario(
    scenario,
    *,
    reduced: bool = False,
    mode: str = "host",
    rounds: int | None = None,
    seed: int | None = None,
    init_fn=None,
    mesh=None,
    artifact: str | None = None,
    obs=None,
    checkpoint=None,
    resume=None,
    device=None,
) -> tuple:
    """Run a registered scenario (by name or instance) end to end.

    Builds the scenario's dataset and model (``reduced=True`` shrinks both),
    then delegates to :func:`run_simulation`.  ``init_fn`` replaces the
    model's own initialiser (the parity tests pass the reference's weights
    through it).  Returns ``(params, SimLedger)``.
    """
    device = resolve_device(device)
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if reduced:
        sc = sc.reduced()
    ds = sc.build_dataset(reduced=reduced)
    model_init, loss_fn, _ = sc.build_model(ds)
    return run_simulation(
        ds, init_fn or model_init, loss_fn, sc.fl,
        rounds if rounds is not None else sc.rounds,
        batch_size=sc.batch_size, mode=mode,
        seed=sc.seed if seed is None else seed, mesh=mesh, system=sc.system,
        scenario_name=sc.name, artifact=artifact, obs=obs,
        checkpoint=checkpoint, resume=resume, device=device,
    )
