"""Multi-round simulation driver: the paper's Sec. 4 evaluation loop, with a
structured metrics ledger and versioned JSON artifacts.

Ported from ``repro/sim/driver.py`` with its three modes:

* ``'prefetch'`` (the default, as in the reference) — the
  :class:`~repro_torch.sim.pool.ClientPool` pipeline: the dataset is padded
  onto the device once; each round uploads only a small index plan, and one
  device gather makes the batch.  Round k+1's plan is drawn and its gather
  dispatched (on the pool's side stream) before round k's step is
  dispatched, and the loop waits for the device only after the first round
  and at the end, so ``wall_ms`` after the first round is the dispatch
  cadence, as in the reference;
* ``'host'`` — numpy batch assembly and upload every round, synchronous with
  the round step (each ``wall_ms`` ends in a device sync);
* ``'scan'`` — scan-over-rounds: blocks of ``rounds_per_scan`` rounds.  A
  block's cohorts, plans and round keys are drawn on the host in round
  order and go up in ONE pinned upload; each round's body gathers its batch
  from the device-resident pool and runs the round step (the reference's
  ``lax.scan`` body).  On a card the body is captured once into a CUDA graph
  and each round is one replay (:class:`_ScanRounds`), with no host sync
  inside a block or between blocks; on the CPU the same body runs eagerly.
  Block spans shrink to end on the eval grid, so ``acc_rounds`` are the
  other modes'; ``wall_ms`` is each round's share of its block's time.

All three consume the host RNG (cohort draw without replacement, per-client
example permutations) and the round keys (``fold_in(PRNGKey(seed), 1000 +
k)``) in the reference's exact order, and :mod:`repro_torch.rng` reproduces
jax's keys, so a run draws the reference's cohorts, batches and — whenever
the norms agree — its participation masks, in any mode; the modes' ledgers
(minus timing) and parameters are bitwise equal.  ``eval_fn``
evaluates on the reference's ``eval_every`` grid (and after the last round),
filling the ledger's ``acc_rounds`` / ``acc``; ``server_opt`` applies the
aggregate with a :mod:`repro_torch.optim` optimizer.

Every run fills a :class:`SimLedger` (schema 3, the reference's artifact
contract: ``validate_ledger`` accepts the same documents as the reference's);
its uplink series bills compressed updates at the compressor's size.

With a ``mesh`` (a :class:`~repro_torch.fl.mesh.ClientMesh`,
:func:`build_client_mesh`) the loop runs the mesh round of
``fl/shard_round.py`` on every rank: each rank replays the same numpy
generator, so every rank draws the reference's cohorts and batches, and
uploads (host) or gathers (prefetch, from the sharded
:class:`~repro_torch.sim.pool.ClientPool`: each rank holds its block of the
pool's rows) only its block of the cohort.  The ledger is the same on every
rank.  ``'scan'`` with a mesh raises ``ValueError``, as in the reference:
the mesh round cannot run inside a block of rounds.

A ``system`` (:class:`~repro_torch.sim.pool.SystemConfig`) switches on the
client-state layer: Markov availability chains over the whole pool,
initialised from ``fold_in(key, 2)`` and stepped each round from the round
key (``sim/pool.py::step_client_state``), whose
:class:`~repro_torch.core.ocs.AvailabilityTrace` replaces the scalar
``fl.availability`` in the round step; the ledger then counts the
selected-before-attrition clients, deadline misses and dropouts.  A stateful
sampler's ``SamplerState`` rides from round to round too.  Both stay on the
device in every mode (in scan mode as in-place buffers of the captured
round), and on a mesh every rank steps the same state.

An ``obs`` argument (:class:`~repro_torch.obs.ObsConfig`, or a live
:class:`~repro_torch.obs.Telemetry` whose endpoint outlives the run)
switches on the observability layer: ``data`` and ``round`` spans (and,
in host mode with ``ObsConfig.phases`` on a vmap engine, the five phases of
:func:`~repro_torch.obs.phased.make_phased_step`), the online Eq. 2 gap
estimator (``make_step(diag=True)`` every ``diag_every`` rounds, which fills
the ledger's ``GAP_SERIES``), the JSONL event stream, the live metrics
endpoint and a ``torch.profiler`` window.  Telemetry changes no round
mathematics (masks, norms and parameters are bitwise those of ``obs=None``)
but it syncs the device once per round (the observer effect).  The gap
estimator needs a single device (``diag_every`` with a mesh raises
``ValueError``); on a mesh the other sinks run on rank 0.  In scan mode
with ``diag_every > 0`` the captured round is the diagnostic one for the
whole run, and the gaps are recorded on the ``diag_every`` grid.

A ``checkpoint`` argument (:class:`~repro_torch.checkpoint.CheckpointConfig`,
or a directory) writes a full-fidelity
:class:`~repro_torch.checkpoint.RoundCheckpoint` after every ``every``-th
round and after the last: parameters, server-optimizer state, the numpy
generator's bit state, the client and sampler states, the round and the
ledger so far, and the config fingerprint, in the reference's layout (so a
checkpoint crosses between the packages).  Scan mode aligns its blocks to
the checkpoint grid as it does to the eval grid.  ``resume=`` restores one
and continues at its round: the finished run's parameters are bitwise, and
its ledger byte for byte minus the wall-clock fields, the uninterrupted
run's, in every mode.  On a mesh every rank resumes from the same
directory, and rank 0 alone writes, then every rank waits for it.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import rng as trng
from repro_torch._device import resolve_device, upload
from repro_torch.checkpoint.resume import (
    CheckpointConfig,
    RoundCheckpoint,
    load_round,
    run_config_doc,
    save_round,
)
from repro_torch.core.sampling import init_sampler_state, is_stateful
from repro_torch.fl.engine import RoundEngine, make_engine
from repro_torch.fl.mesh import ClientMesh, local_client_mesh
from repro_torch.fl.round import client_weights, round_bits_duplex
from repro_torch.fl.shard_round import validate_shard_config
from repro_torch.kernels.ops import tree_leaves, tree_map
from repro_torch.obs.gap import GapStats
from repro_torch.obs.gap import gap_ratio as _obs_gap_ratio
from repro_torch.obs.telemetry import ObsConfig, Telemetry, as_telemetry
from repro_torch.obs.trace import span as obs_span
from repro_torch.sim.pool import ClientPool, claim_batch, init_client_state, step_client_state
from repro_torch.sim.scenarios import get_scenario

SIM_SCHEMA = 3
MODES = ("host", "prefetch", "scan")

# per-round series every schema-3 ledger must carry, all the same length
LEDGER_SERIES = (
    "loss", "alpha", "gamma", "sent", "expected_clients",
    "over_selected", "deadline_misses", "dropouts",
    "uplink_bits", "downlink_bits", "wall_ms",
)

# sparse per-diagnostic-round series (the obs gap estimator's; empty without
# it), all four the same length, indexed by gap_rounds
GAP_SERIES = ("gap_rounds", "gap_sq", "gap_full_sq", "gap_ratio")


@dataclass
class SimLedger:
    """Structured metrics ledger of one simulation run (artifact schema 3).

    Per-round series (``LEDGER_SERIES``; the system-layer counters are zeros
    without a ``system``, and ``wall_ms`` is each round's time on the monotonic
    clock: ending in a device sync in host mode, the dispatch cadence after
    the first round under prefetch), the sparse gap series (the obs gap
    estimator's ``diag_every`` grid; empty without it), the eval curve and
    the run's throughput.
    ``masks``/``norms`` are kept in memory for parity checks and written to
    JSON only on request.
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


def build_client_mesh(fl, world_size: int | None = None, device=None) -> ClientMesh:
    """The 1-D client mesh (axis ``fl.client_axis``) over this process's
    ranks: the reference's ``build_client_mesh``.

    With a process group already initialised (a rank of
    :func:`~repro_torch.fl.mesh.spawn_mesh`, or of a launcher), a mesh over
    it on ``device``.  With none, a world of one rank in this process (a
    ``FileStore`` in a temporary directory, NCCL on CUDA, gloo on the CPU),
    so one card runs the mesh code path — the reference's mesh always spans
    at least one device.  The config is checked first
    (:func:`~repro_torch.fl.shard_round.validate_shard_config`: ``ValueError``
    when the world's size does not divide ``fl.n_clients``, among others),
    so a rejected config opens no process group.  The caller closes the mesh
    (:meth:`~repro_torch.fl.mesh.ClientMesh.close`).
    """
    size = dist.get_world_size() if dist.is_initialized() else 1
    if world_size is not None and world_size != size:
        raise ValueError(
            f"this process's world has {size} ranks, not world_size={world_size}: "
            f"start one process per rank (repro_torch.fl.mesh.spawn_mesh)"
        )
    validate_shard_config(fl, size)
    if dist.is_initialized():
        return ClientMesh(dist.group.WORLD, device, fl.client_axis)
    return local_client_mesh(device, axis_name=fl.client_axis)


def _check_mode(mode, on_mesh: bool, rounds_per_scan: int = 8) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown sim mode {mode!r}; want one of {MODES}")
    if mode == "scan" and rounds_per_scan < 1:
        raise ValueError(f"rounds_per_scan must be >= 1, got {rounds_per_scan}")
    if mode == "scan" and on_mesh:
        raise ValueError(
            "sim mode 'scan' does not support a mesh: the shard_map round cannot run "
            "inside the scan-over-rounds block — use mode='host' or mode='prefetch' "
            "with the mesh, or drop the mesh to keep scan-over-rounds"
        )


class _NullSpan:
    """No-op stand-in for :class:`~repro_torch.obs.trace.Span` when
    telemetry is off."""

    def block(self, tensors) -> None:
        pass


_NULL_SPAN = _NullSpan()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# the RoundMetrics fields the ledger reads; the scan mode keeps them per round,
# and on a diagnostic run the gap scalars (GAP_FIELDS, from RoundMetrics.gap)
LEDGER_FIELDS = ("loss", "alpha", "gamma", "sent_clients", "expected_clients",
                 "selected_clients", "deadline_misses", "dropouts", "mask", "norms")
GAP_FIELDS = ("gap_sq", "gap_full_sq")


def _tensors(tree) -> list:
    """The tensors of a parameter or optimizer-state tree (``()``: none)."""
    return [] if isinstance(tree, tuple) else tree_leaves(tree)


def _pack_block(pool, plans, keys: torch.Tensor) -> tuple:
    """A block's plans and round keys as ``(span, width)`` int32 rows (each
    round's :meth:`~repro_torch.sim.pool.ClientPool.pack` words, then its
    key's two words), and the plans' layout."""
    packed = [pool.pack(p) for p in plans]
    words = np.stack([w for w, _ in packed])
    return np.concatenate([words, keys.numpy().astype(np.uint32).view(np.int32)],
                          axis=1), packed[0][1]


class _ScanRounds:
    """The round body of ``mode='scan'`` over static buffers.

    ``block`` holds a block's packed rows (:func:`_pack_block`, one row per
    round), written by one upload per block (:meth:`load`); the device
    counters ``slot`` (the next round's row) and ``index`` (its ledger slot)
    advance in the body, so a round takes no host value.  The body gathers
    the round's batch from the pool (``ClientPool.gather_packed``), takes
    the weights from the cohort (``weights_of``) and the key from the row,
    steps the client state (with a ``system``; the reference's scan carry)
    from that key to the round's trace, runs ``round_step``, copies the new
    parameters, optimizer state, client state and sampler state into
    ``params`` / ``opt_state`` / ``client_state`` / ``sampler_state``
    (clones of the run's initial ones) and writes the round's metrics into
    ``out[name][index]`` (``LEDGER_FIELDS``, and ``GAP_FIELDS`` when the
    step returns a ``RoundMetrics.gap``).

    On the CPU each :meth:`step` runs the body eagerly.  On a card the first
    runs it eagerly on a side stream (the capture's warm-up: lazy set-up,
    and the kernels' ticket counters of that stream), the body is then
    captured into one ``torch.cuda.CUDAGraph`` on that stream
    (:meth:`_capture`), and every later step is one replay (``replays``
    counts them).  A failed capture or replay raises.
    """

    def __init__(self, pool, round_step, weights_of, params, opt_state, rounds: int,
                 rows: int, system=None, client_state=None, sampler_state=None):
        dev = pool.device
        self.pool, self.round_step, self.weights_of = pool, round_step, weights_of
        self.params = tree_map(torch.clone, params)
        self.opt_state = opt_state if opt_state == () else tree_map(torch.clone, opt_state)
        self.system = system
        self.client_state, self.sampler_state = (
            None if st is None else type(st)(*map(torch.clone, st))
            for st in (client_state, sampler_state))
        self.rounds, self.rows = rounds, rows
        self.block = self.layout = None
        self.slot = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.index = torch.zeros((1,), dtype=torch.int64, device=dev)
        self.out = None
        self.graph = None
        self.replays = 0
        self.stream = None
        if dev.type == "cuda":
            self.stream = torch.cuda.Stream(dev)
            # the pool's buffers went up on the pool's stream
            torch.cuda.current_stream(dev).wait_stream(pool.stream)

    def load(self, packed: np.ndarray, layout) -> None:
        """Write a block's rows (one pinned ``non_blocking`` upload on a
        card) and point ``slot`` at its first."""
        if self.block is None:
            # made once: the graph reads the block at this address
            self.block = torch.zeros((self.rows, packed.shape[1]), dtype=torch.int32,
                                     device=self.slot.device)
            self.layout = layout
        host = torch.from_numpy(packed)
        if self.stream is None:
            self.block[:len(packed)].copy_(host)
        else:
            self.block[:len(packed)].copy_(host.pin_memory(), non_blocking=True)
        self.slot.zero_()

    def step(self) -> None:
        """Run the next round: eagerly, or as one replay of the graph."""
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
        elif self.stream is None:
            self._body()
        else:
            cur = torch.cuda.current_stream(self.block.device)
            self.stream.wait_stream(cur)
            with torch.cuda.stream(self.stream):
                self._body()
            if self.rounds > 1:
                self.graph = self._capture()
            cur.wait_stream(self.stream)

    def _capture(self):
        """One ``torch.cuda.CUDAGraph`` of the round body, captured on the
        side stream."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=self.stream):
            self._body()
        return graph

    def _body(self) -> None:
        row = self.block.index_select(0, self.slot).view(-1)
        plan, key = row[:-2], row[-2:].to(torch.int64) & 0xFFFFFFFF
        clients = self.layout.rows(plan)
        batch = self.pool.gather_packed(plan, self.layout)
        trace = client_state = None
        if self.client_state is not None:
            client_state, trace = step_client_state(self.client_state, key, clients,
                                                    self.system)
        params, opt_state, metrics = self.round_step(
            self.params, self.opt_state, batch, self.weights_of(clients), key, trace,
            self.sampler_state)
        dst = _tensors(self.params) + _tensors(self.opt_state)
        src = _tensors(params) + _tensors(opt_state)
        if client_state is not None:
            dst, src = dst + list(self.client_state), src + list(client_state)
        if self.sampler_state is not None:
            dst, src = dst + list(self.sampler_state), src + list(metrics.sampler_state)
        for d, s in zip(dst, src):
            d.copy_(s)
        vals = {name: getattr(metrics, name) for name in LEDGER_FIELDS}
        if metrics.gap is not None:
            vals.update(zip(GAP_FIELDS, metrics.gap))
        if self.out is None:
            self.out = {name: torch.empty((self.rounds,) + tuple(v.shape), dtype=v.dtype,
                                          device=self.block.device)
                        for name, v in vals.items()}
        for name, v in vals.items():
            self.out[name].index_copy_(0, self.index, v.unsqueeze(0))
        self.slot.add_(1)
        self.index.add_(1)


def run_simulation(
    dataset,
    init_fn,
    loss_fn,
    fl,
    rounds: int,
    *,
    batch_size: int = 20,
    mode: str = "prefetch",
    rounds_per_scan: int = 8,
    eval_fn=None,
    eval_batch=None,
    eval_every: int = 5,
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
    (``fold_in(key, 1000 + k)``) in the reference's order and runs one round
    step of the configured engine (``fl.round_engine``) on ``device``
    (``None`` means CUDA and raises without one; pass ``device='cpu'``):
    under ``mode='prefetch'`` from the device-resident pool, with the next
    round's gather dispatched first; under ``'host'`` from a numpy batch,
    waiting for each round; under ``'scan'`` in blocks of
    ``rounds_per_scan`` rounds, each round one CUDA-graph replay on a card
    (module docstring).  ``init_fn(key)`` gets
    ``fold_in(PRNGKey(seed), 1)``.  ``fl.weights == 'data_size'`` takes each
    cohort's slice of ``dataset.sizes()``, normalised per round.
    ``eval_fn(params, eval_batch)`` (``eval_batch`` a dict of arrays or
    tensors, moved to the device once) runs after round k whenever
    ``k % eval_every == 0`` or k is the last round.  ``server_opt`` (an
    :class:`~repro_torch.optim.Optimizer`) replaces the plain ``lr_global``
    server step; it needs ``mesh=None``, as in the reference.

    With a ``mesh`` (call it on every rank) the round is the mesh round, on
    the mesh's device: every rank draws the whole cohort and uploads (host)
    or gathers (prefetch, from the sharded pool) its block of the batch and
    the weights.  The ledger is the same on every rank (``wall_ms`` is the
    slowest rank's) and records ``workload["mesh_axis_size"]``; ``'scan'``
    with a mesh raises ``ValueError``.  ``artifact`` (a path) serialises the
    ledger on completion (rank 0 only).

    ``system`` (a :class:`~repro_torch.sim.pool.SystemConfig`) runs the
    client-state layer (module docstring); it and a scalar
    ``fl.availability < 1`` are mutually exclusive (``ValueError``, as in
    the reference), and the ledger's workload records it.

    ``obs`` (an :class:`~repro_torch.obs.ObsConfig`, or a live
    :class:`~repro_torch.obs.Telemetry` whose lifecycle the caller keeps)
    switches on the observability layer; ``diag_every`` with a mesh raises
    ``ValueError``.  ``checkpoint`` (a
    :class:`~repro_torch.checkpoint.CheckpointConfig` or a directory)
    writes a round checkpoint after every ``every``-th round and after the
    last; ``resume`` (a checkpoint root or a ``step-XXXXXXXX`` directory)
    restores one — a ``ValueError`` when its config fingerprint differs from
    this run's, when it is not a round checkpoint, or when it already covers
    ``rounds`` — and continues at its round (module docstring).
    """
    _check_mode(mode, mesh is not None, rounds_per_scan)
    if obs is not None and not isinstance(obs, (ObsConfig, Telemetry)):
        raise TypeError(f"obs must be ObsConfig or Telemetry, got {type(obs)!r}")
    obs_cfg = obs.cfg if isinstance(obs, Telemetry) else obs
    diag_on = obs_cfg is not None and obs_cfg.diag_every > 0
    if diag_on and mesh is not None:
        raise ValueError(
            "the obs gap estimator (ObsConfig.diag_every > 0) does not "
            "support a mesh: the shard_map round has no diag variant — run "
            "single-device, or drop diag_every"
        )
    if system is not None and fl.availability < 1.0:
        raise ValueError(
            "system config and scalar fl.availability < 1 are mutually "
            "exclusive: the availability trace generalizes Appendix E's "
            "Bernoulli(q) — encode q as SystemConfig(p_up=q, p_down=1-q)"
        )
    if fl.n_clients > dataset.n_clients:
        raise ValueError(
            f"FLConfig.n_clients={fl.n_clients} exceeds the dataset's client "
            f"pool of {dataset.n_clients} clients: each round draws the cohort "
            f"without replacement, so n_clients must be <= the pool size"
        )
    if mesh is None:
        dev = resolve_device(device)
        lo, k_local = 0, fl.n_clients
    else:
        dev = mesh.device
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"device={device!r}, but the mesh's rank lies on {dev}")
        k_local = fl.n_clients // mesh.world_size
        lo = mesh.rank * k_local
    # the round step (and its config check) before any draw
    engine = diag_step = None
    if mesh is None:
        engine = RoundEngine(loss_fn, fl, server_opt, device=dev)
        round_step = engine.make_step()
        if diag_on:
            diag_step = engine.make_step(diag=True)
    else:
        round_step = make_engine(loss_fn, fl, server_opt, mesh=mesh, device=dev)
    ck = None
    if checkpoint is not None:
        ck = (checkpoint if isinstance(checkpoint, CheckpointConfig)
              else CheckpointConfig(str(checkpoint)))
    # on a mesh the sinks run on rank 0 only
    tel, tel_owned = as_telemetry(obs if mesh is None or mesh.rank == 0 else None)
    try:
        # phased execution (real per-phase spans) applies to host-mode vmap
        # engines only; elsewhere rounds are timed whole
        use_phased = (tel is not None and tel.cfg.phases and mode == "host"
                      and engine is not None and engine.memory == "vmap")

        def sp(name):
            # a span when telemetry is on, else an inert context: the obs=None
            # path runs no span code
            if tel is not None:
                return obs_span(name, tel)
            return contextlib.nullcontext(_NULL_SPAN)

        rng = np.random.default_rng(seed)
        key = trng.PRNGKey(seed, device=dev)
        params = init_fn(trng.fold_in(key, 1))
        dim = sum(leaf.numel() for leaf in tree_leaves(params))
        opt_state = server_opt.init(params) if server_opt is not None else ()
        # the client-state chains over the whole pool, from their own fold (the
        # parameters take fold 1, the rounds 1000 + k)
        state = None
        if system is not None:
            state = init_client_state(dataset.n_clients, system, trng.fold_in(key, 2))
        samp = init_sampler_state(dev) if is_stateful(fl.sampler) else None
        sizes = np.asarray(dataset.sizes())
        uniform_w = client_weights(fl, device=dev)
        if eval_batch is not None:
            eval_batch = {k: upload(v, dev) for k, v in eval_batch.items()}

        def cohort_weights(clients):
            # this rank's block of the cohort's weights (all of them without a mesh)
            if fl.weights == "data_size":
                return client_weights(fl, sizes[np.asarray(clients)], device=dev)[lo:lo + k_local]
            return uniform_w[lo:lo + k_local]

        def draw_cohort():
            return rng.choice(dataset.n_clients, size=fl.n_clients, replace=False)

        def want_eval(k):
            return eval_fn is not None and (k % eval_every == 0 or k == rounds - 1)

        dev_metrics, dev_evals, wall_ms = [], [], []
        gap_records = []          # (round, gap_sq, full_sq) on the diag_every grid
        tel_up = tel_down = tel_miss = tel_drop = 0

        # ---- checkpoint / resume: full-fidelity round checkpoints ----
        cfg_doc = None
        if ck is not None or resume is not None:
            cfg_doc = run_config_doc(
                fl, seed=seed, batch_size=batch_size, local_epoch=local_epoch,
                pool_clients=int(dataset.n_clients), model_dim=dim, system=system,
                eval_every=int(eval_every) if eval_fn is not None else None,
                scenario=scenario_name,
            )
        k0 = 0
        tail = {name: [] for name in LEDGER_SERIES}
        tail_masks = tail_norms = None
        if resume is not None:
            rc = load_round(resume, params=params, opt_state=opt_state, client_state=state,
                            sampler_state=samp, config=cfg_doc)
            if rc.round >= rounds:
                raise ValueError(
                    f"checkpoint at {resume!r} already covers round {rc.round} "
                    f"but the run asks for rounds={rounds} — raise rounds to "
                    f"extend the run"
                )
            k0 = rc.round
            params, opt_state = rc.params, rc.opt_state
            if state is not None:
                state = rc.client_state
            if samp is not None:
                samp = rc.sampler_state
            # the generator continues mid-stream: every later cohort draw and
            # permutation is the one the uninterrupted run made
            rng.bit_generator.state = rc.rng_state
            tail = rc.series
            tail_masks = np.asarray(rc.masks, bool)
            tail_norms = np.asarray(rc.norms, np.float32)
            gap_records.extend(rc.gap_records)
            dev_evals.extend(rc.evals)
        scan = None
        done = k0

        def need_ckpt(k):
            # after round k: on the every-grid, and always after the last round
            return ck is not None and ((k + 1) % ck.every == 0 or k + 1 == rounds)

        def rows(name):
            # this process's rounds so far, on the host
            if mode == "scan":
                return scan.out[name][:done - k0].cpu().numpy()
            return torch.stack([getattr(m, name) for m in dev_metrics]).cpu().numpy()

        def splice_series():
            """The run's per-round series and its ``(rounds, n)`` masks and
            norms: the resumed tail's entries, then this process's rounds,
            converted with the same ``float()``/``int()`` calls, so a spliced
            ledger is byte for byte the uninterrupted run's."""
            masks_l = rows("mask").astype(bool)
            norms_l = rows("norms").astype(np.float32)
            ser = {name: list(tail[name]) for name in LEDGER_SERIES}
            up_total = ser["uplink_bits"][-1] if ser["uplink_bits"] else 0
            down_total = ser["downlink_bits"][-1] if ser["downlink_bits"] else 0
            for i, (loss, alpha, gamma, sent, expected, selected, misses, drops) in enumerate(zip(
                rows("loss"), rows("alpha"), rows("gamma"), rows("sent_clients"),
                rows("expected_clients"), rows("selected_clients"), rows("deadline_misses"),
                rows("dropouts"),
            )):
                up, down = round_bits_duplex(fl, dim, masks_l[i])
                up_total += int(up)
                down_total += int(down)
                ser["loss"].append(float(loss))
                ser["alpha"].append(float(alpha))
                ser["gamma"].append(float(gamma))
                ser["sent"].append(int(sent))
                ser["expected_clients"].append(float(expected))
                ser["over_selected"].append(int(selected))
                ser["deadline_misses"].append(int(misses))
                ser["dropouts"].append(int(drops))
                ser["uplink_bits"].append(up_total)
                ser["downlink_bits"].append(down_total)
                ser["wall_ms"].append(float(wall_ms[i]))
            if tail_masks is not None:
                return (ser, np.concatenate([tail_masks, masks_l], 0),
                        np.concatenate([tail_norms, norms_l], 0))
            return ser, masks_l, norms_l

        def write_ckpt(k_done, rng_st, cl_state, s_state, p, o):
            # k_done is the last completed round; save() syncs the device and
            # copies every leaf to the host before it returns, so later rounds
            # (or a scan run's replays, which write p and o in place) cannot
            # touch what it writes.  On a mesh rank 0 alone writes, and every
            # rank waits for the publish.
            if mesh is None or mesh.rank == 0:
                ser, m_all, n_all = splice_series()
                save_round(ck, RoundCheckpoint(
                    round=k_done + 1, params=p, opt_state=o, client_state=cl_state,
                    sampler_state=s_state, rng_state=rng_st, series=ser,
                    gap_records=list(gap_records),
                    evals=[(int(k), float(v)) for k, v in dev_evals],
                    masks=m_all, norms=n_all, config=cfg_doc,
                ))
            if mesh is not None:
                mesh.barrier()

        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        def tel_round(k, metrics, ms_val):
            # the endpoint's and the event stream's round record (telemetry on
            # only); reading the mask syncs the device: the observer effect
            nonlocal tel_up, tel_down, tel_miss, tel_drop
            up, down = round_bits_duplex(fl, dim, host(metrics.mask))
            tel_up += int(up)
            tel_down += int(down)
            tel_miss += int(metrics.deadline_misses)
            tel_drop += int(metrics.dropouts)
            tel.record_round(
                k, loss=float(metrics.loss), sent_clients=int(metrics.sent_clients),
                wall_ms=ms_val, uplink_bits_total=tel_up, downlink_bits_total=tel_down,
                deadline_misses_total=tel_miss, dropouts_total=tel_drop,
            )

        def tel_gap(k, gap):
            gs, fs = float(gap.gap_sq), float(gap.full_sq)
            gap_records.append((k, gs, fs))
            if tel is not None:
                tel.record_gap(k, gs, fs)

        if tel is not None:
            tel.run_start(scenario=scenario_name, mode=mode, sampler=fl.sampler,
                          n_clients=fl.n_clients, rounds=rounds, backend=dev.type)
        pool = None
        t_start = time.perf_counter()
        t_first, first_units = None, 1
        if mode == "host":
            if use_phased:
                from repro_torch.obs.phased import make_phased_step

                phased_step = make_phased_step(engine, tel)
            for k in range(k0, rounds):
                t_round = time.perf_counter()
                diag = diag_on and tel.want_gap(k)
                if tel is not None:
                    tel.round_start(k)
                with sp("data") as s:
                    clients = draw_cohort()
                    w = cohort_weights(clients)
                    batch = dataset.sample_round_batches(
                        rng, clients, fl.local_steps, batch_size, local_epoch
                    )
                    # this rank's block of the cohort (the whole cohort without a mesh)
                    batch = {bk: torch.as_tensor(v[lo:lo + k_local], device=dev)
                             for bk, v in batch.items()}
                    s.block(batch)
                kk = trng.fold_in(key, 1000 + k)
                trace = None
                if state is not None:
                    state, trace = step_client_state(state, kk, upload(clients, dev), system)
                if use_phased:
                    params, opt_state, metrics = phased_step(params, opt_state, batch, w, kk,
                                                             trace, samp, diag=diag)
                else:
                    with sp("round") as s:
                        params, opt_state, metrics = (diag_step if diag else round_step)(
                            params, opt_state, batch, w, kk, trace, samp)
                        s.block(metrics.loss)
                if samp is not None:
                    samp = metrics.sampler_state
                dev_metrics.append(metrics)
                if want_eval(k):
                    dev_evals.append((k, eval_fn(params, eval_batch)))
                # the host loop is synchronous: it waits for the round before
                # assembling the next round's batch
                _sync(dev)
                if t_first is None:
                    t_first = time.perf_counter()
                wall_ms.append((time.perf_counter() - t_round) * 1e3)
                if diag:
                    tel_gap(k, metrics.gap)
                if tel is not None:
                    tel_round(k, metrics, wall_ms[-1])
                if need_ckpt(k):
                    # the host loop draws round k's randomness inside iteration
                    # k, so the live generator and chains are the post-round-k ones
                    write_ckpt(k, copy.deepcopy(rng.bit_generator.state), state, samp,
                               params, opt_state)
        elif mode == "prefetch":
            pool = ClientPool(dataset, mesh=mesh, device=dev)

            def draw_round(k):
                # called strictly in round order: the host RNG, the keys and the
                # client-state chain advance as in the host loop, only earlier
                nonlocal state
                clients = draw_cohort()
                plan = pool.plan(rng, clients, fl.local_steps, batch_size, local_epoch)
                kk = trng.fold_in(key, 1000 + k)
                trace = None
                if state is not None:
                    state, trace = step_client_state(state, kk, upload(plan.clients, dev), system)
                return pool.gather(plan), cohort_weights(clients), kk, trace

            nxt = draw_round(k0)
            for k in range(k0, rounds):
                t_round = time.perf_counter()
                diag = diag_on and tel.want_gap(k)
                if tel is not None:
                    tel.round_start(k)
                (batch, ready), w, kk, trace = nxt
                snap = None
                if need_ckpt(k) and k + 1 < rounds:
                    # round k+1's draw below advances the generator and the
                    # client-state chains before round k's checkpoint is
                    # written: keep both as they are now, so the resumed run
                    # makes round k+1's draw itself
                    snap = (copy.deepcopy(rng.bit_generator.state), state)
                if k + 1 < rounds:
                    # double buffering: round k+1's plan is drawn and its gather
                    # dispatched before round k's step is
                    with sp("data"):
                        nxt = draw_round(k + 1)
                with sp("round") as s:
                    params, opt_state, metrics = (diag_step if diag else round_step)(
                        params, opt_state, claim_batch(batch, ready), w, kk, trace, samp)
                    s.block(metrics.loss)
                if samp is not None:
                    samp = metrics.sampler_state
                dev_metrics.append(metrics)
                if want_eval(k):
                    dev_evals.append((k, eval_fn(params, eval_batch)))
                if tel is not None:
                    # the observer effect: telemetry syncs every round, so
                    # wall_ms bounds the device work
                    _sync(dev)
                if t_first is None:
                    # the only mid-run sync without telemetry: it ends the
                    # set-up round
                    _sync(dev)
                    t_first = time.perf_counter()
                wall_ms.append((time.perf_counter() - t_round) * 1e3)
                if diag:
                    tel_gap(k, metrics.gap)
                if tel is not None:
                    tel_round(k, metrics, wall_ms[-1])
                if need_ckpt(k):
                    # the sampler state is read after the step, so the live one
                    # is right; the generator and chains come from the snapshot
                    # (after the last round nothing was prefetched: the live ones)
                    rng_st, cl_st = snap if snap is not None else (
                        copy.deepcopy(rng.bit_generator.state), state)
                    write_ckpt(k, rng_st, cl_st, samp, params, opt_state)
        else:  # scan-over-rounds
            pool = ClientPool(dataset, device=dev)
            if fl.weights == "data_size":
                # the cohort's weights from its ids, inside the body: the same
                # ops on the same device as cohort_weights'
                sizes_dev = torch.from_numpy(sizes).to(dev)

                def weights_of(clients):
                    return client_weights(fl, sizes_dev.index_select(0, clients.long()))
            else:
                def weights_of(clients):
                    return uniform_w
            # with the gap estimator on, the captured round is the diagnostic
            # one for the whole run; the gaps are recorded on the diag grid
            scan = _ScanRounds(pool, diag_step if diag_on else round_step, weights_of, params,
                               opt_state, rounds - k0, min(rounds_per_scan, rounds - k0), system,
                               state, samp)
            host_key = trng.PRNGKey(seed, device="cpu")
            while done < rounds:
                t_blk = time.perf_counter()
                if tel is not None:
                    tel.round_start(done)
                span = min(rounds_per_scan, rounds - done)
                if ck is not None:
                    # blocks end on the checkpoint grid, composed with the eval
                    # grid below, so every every-th round ends a block
                    span = min(span, ck.every - done % ck.every)
                if eval_fn is not None:
                    # the next eval round ends a block, so acc_rounds are the
                    # other modes' round for round
                    nxt = done
                    while not want_eval(nxt):
                        nxt += 1
                    span = min(span, nxt - done + 1)
                with sp("data"):
                    plans = [pool.plan(rng, draw_cohort(), fl.local_steps, batch_size,
                                       local_epoch) for _ in range(span)]
                    keys = trng.fold_in_many(host_key, range(1000 + done, 1000 + done + span))
                    scan.load(*_pack_block(pool, plans, keys))
                with sp("round") as s:
                    for _ in range(span):
                        scan.step()
                    s.block(scan.out["loss"])
                done += span
                if want_eval(done - 1):
                    dev_evals.append((done - 1, eval_fn(scan.params, eval_batch)))
                if t_first is None:
                    # the only mid-run sync without telemetry: it ends the first
                    # block (the warm-up round and the capture)
                    _sync(dev)
                    t_first, first_units = time.perf_counter(), span
                blk_ms = (time.perf_counter() - t_blk) * 1e3 / span
                wall_ms.extend([blk_ms] * span)
                if tel is not None or diag_on:
                    blk = {name: v[done - span - k0:done - k0].cpu().numpy()
                           for name, v in scan.out.items()}
                    for i in range(span):
                        kg = done - span + i
                        row = SimpleNamespace(**{name: v[i] for name, v in blk.items()})
                        if diag_on and tel.want_gap(kg):
                            tel_gap(kg, GapStats(row.gap_sq, row.gap_full_sq))
                        if tel is not None:
                            tel_round(kg, row, blk_ms)
                if ck is not None and (done % ck.every == 0 or done == rounds):
                    # every draw of the block is made, so the live generator is
                    # the post-round-(done - 1) one; the graph's in-place buffers
                    # hold the state after the block
                    write_ckpt(done - 1, copy.deepcopy(rng.bit_generator.state),
                               scan.client_state, scan.sampler_state, scan.params,
                               scan.opt_state)
            params = scan.params
        _sync(dev)
        t_end = time.perf_counter()
        wall_s = t_end - t_start
        steady_s = t_end - t_first if t_first is not None else 0.0
        if mesh is not None:
            # a mesh round ends when its slowest rank does; every rank records that
            n = len(wall_ms)
            times = mesh.all_max(torch.tensor(wall_ms + [wall_s, steady_s],
                                              dtype=torch.float64, device=dev)).tolist()
            wall_ms[:], wall_s, steady_s = times[:n], times[n], times[n + 1]

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
                **({"rounds_per_scan": rounds_per_scan} if mode == "scan" else {}),
                **({"pool_bytes": pool.nbytes} if pool is not None else {}),
                **({"mesh_axis_size": mesh.world_size} if mesh is not None else {}),
                **({"system": dataclasses.asdict(system)} if system is not None else {}),
            },
        )
        # the resumed tail (if any) goes ahead of this process's rounds with the
        # same scalar conversions: the same document either way
        ser, masks_all, norms_all = splice_series()
        for name in LEDGER_SERIES:
            setattr(ledger, name, ser[name])
        ledger.masks = list(masks_all)
        ledger.norms = list(norms_all)
        for k, gs, fs in gap_records:
            ledger.gap_rounds.append(int(k))
            ledger.gap_sq.append(gs)
            ledger.gap_full_sq.append(fs)
            ledger.gap_ratio.append(_obs_gap_ratio(gs, fs))
        for k, v in dev_evals:
            ledger.acc_rounds.append(int(k))
            ledger.acc.append(float(v))
        ledger.wall_s = wall_s
        # throughput counts the rounds this process ran, not the resumed tail
        steady = (rounds - k0) - first_units
        if steady > 0 and steady_s > 0:
            ledger.rounds_per_sec = steady / steady_s
        else:
            ledger.rounds_per_sec = (rounds - k0) / max(wall_s, 1e-9)
        if tel is not None:
            tel.finish(rounds=rounds, wall_s=ledger.wall_s, rounds_per_sec=ledger.rounds_per_sec)
        if artifact and (mesh is None or mesh.rank == 0):
            ledger.write(artifact)
        return params, ledger
    finally:
        if tel_owned:
            tel.close()


def run_scenario(
    scenario,
    *,
    reduced: bool = False,
    mode: str = "prefetch",
    rounds: int | None = None,
    rounds_per_scan: int = 8,
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
    through it).  ``Scenario.sharded`` cells (and an explicit ``mesh``) run
    the mesh round; a sharded cell without a ``mesh`` builds one with
    :func:`build_client_mesh` and closes it after the run.  Returns
    ``(params, SimLedger)``.
    """
    sc = get_scenario(scenario) if isinstance(scenario, str) else scenario
    if reduced:
        sc = sc.reduced()
    if mode == "scan" and (mesh is not None or sc.sharded):
        raise ValueError(
            f"scenario {sc.name!r} runs on a mesh, which sim mode 'scan' does not "
            "support — use mode 'host' or 'prefetch'"
        )
    _check_mode(mode, mesh is not None, rounds_per_scan)
    if mesh is None:
        device = resolve_device(device)
    ds = sc.build_dataset(reduced=reduced)
    model_init, loss_fn, _ = sc.build_model(ds)
    own_mesh = mesh is None and sc.sharded
    if own_mesh:
        mesh = build_client_mesh(sc.fl, device=device)
    try:
        return run_simulation(
            ds, init_fn or model_init, loss_fn, sc.fl,
            rounds if rounds is not None else sc.rounds,
            batch_size=sc.batch_size, mode=mode, rounds_per_scan=rounds_per_scan,
            seed=sc.seed if seed is None else seed, mesh=mesh, system=sc.system,
            scenario_name=sc.name, artifact=artifact, obs=obs,
            checkpoint=checkpoint, resume=resume, device=device,
        )
    finally:
        if own_mesh:
            mesh.close()
