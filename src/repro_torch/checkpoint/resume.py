"""Full-fidelity round checkpoints: everything a resumed run needs to be
bitwise indistinguishable from an uninterrupted one — the port of
``repro/checkpoint/resume.py``, whose documents it writes and reads
unchanged (the same meta block, the same config document, hence the same
fingerprint for the same run in both packages).

A params-only checkpoint silently changes the trajectory on restart: the
server-optimizer state resets, the pool's ``np.random.Generator`` restarts
its stream, a stateful sampler's EMA threshold re-cold-starts and the Markov
:class:`~repro_torch.sim.pool.ClientState` chains re-randomise — so the "resumed"
run quietly diverges from its own continuation.  :class:`RoundCheckpoint`
is the complete state inventory (schema-versioned):

* ``params`` and ``opt_state`` — the model and server-optimizer pytrees;
* ``rng_state`` — the pool generator's exact bit-generator state, so every
  later cohort/permutation draw continues the stream mid-word;
* ``client_state`` / ``sampler_state`` — the Markov availability chains and
  the stateful sampler's ``(step, threshold)`` carry;
* ``round`` — rounds completed (the next round to run);
* the ledger tail — every JSON-visible per-round series recorded so far,
  plus the in-memory ``masks``/``norms`` parity arrays — so the resumed
  run's artifact splices into a byte-identical document (minus ``wall_ms``);
* ``config`` + its ``fingerprint`` — the run-defining knobs (FLConfig,
  SystemConfig, seed, batch size, pool size, model dim, scenario), rejected
  on mismatch with a ``ValueError`` naming every differing key, so a
  checkpoint can never be resumed into a different experiment unnoticed.

Writes go through :func:`repro_torch.checkpoint.ckpt.save` and inherit its
atomicity (stage + one ``os.replace``) and latest-complete-step selection;
arrays live in the npz payload, scalar series and the RNG state ride the
index's ``meta`` block (JSON round-trips python floats exactly, so the
spliced ledger is byte-identical, not merely close).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from repro_torch.checkpoint import ckpt

# RoundCheckpoint meta schema. Version 1: the full state inventory above.
RESUME_SCHEMA = 1


@dataclass(frozen=True)
class CheckpointConfig:
    """Periodic-checkpoint policy for :func:`repro_torch.sim.driver.run_simulation`.

    ``dir`` is the checkpoint root (one ``step-XXXXXXXX`` directory per
    saved round); a :class:`RoundCheckpoint` is written after every
    ``every``-th round and after the final round, and the newest ``keep``
    steps are retained (older ones pruned after each successful atomic
    publish; ``keep=0`` keeps everything).  In scan mode, block boundaries
    are aligned so every checkpoint round ends a block.
    """

    dir: str
    every: int = 10
    keep: int = 3

    def __post_init__(self):
        if self.every < 1:
            raise ValueError(f"ckpt every must be >= 1, got {self.every}")
        if self.keep < 0:
            raise ValueError(f"ckpt keep must be >= 0, got {self.keep}")


@dataclass
class RoundCheckpoint:
    """One complete resume point (module docstring has the state inventory).

    ``round`` counts completed rounds — the resumed run starts there.
    ``series`` maps every ledger scalar series name to its list so far;
    ``masks``/``norms`` are ``(round, n_clients)`` arrays; ``gap_records``
    and ``evals`` are ``(round, value...)`` tuples on their sparse grids;
    ``config`` is the fingerprinted run-defining document.
    """

    round: int
    params: Any
    opt_state: Any
    client_state: Any
    sampler_state: Any
    rng_state: dict
    series: dict = field(default_factory=dict)
    gap_records: list = field(default_factory=list)
    evals: list = field(default_factory=list)
    masks: Any = None
    norms: Any = None
    config: dict = field(default_factory=dict)


def fingerprint(config: dict) -> str:
    """sha256 over the canonical (sorted-keys) JSON of the config document."""
    return hashlib.sha256(
        json.dumps(config, sort_keys=True).encode()
    ).hexdigest()


def _flatten_doc(doc, prefix=""):
    out = {}
    if isinstance(doc, dict):
        for k in sorted(doc):
            out.update(_flatten_doc(doc[k], f"{prefix}{k}."))
    else:
        out[prefix.rstrip(".")] = doc
    return out


def config_diff(saved: dict, current: dict) -> list:
    """Human-readable list of keys where two config documents differ."""
    a, b = _flatten_doc(saved), _flatten_doc(current)
    diffs = []
    for k in sorted(set(a) | set(b)):
        va, vb = a.get(k, "<absent>"), b.get(k, "<absent>")
        if va != vb:
            diffs.append(f"{k}: checkpoint={va!r} run={vb!r}")
    return diffs


def _tree(rc: RoundCheckpoint) -> dict:
    return {
        "params": rc.params,
        "opt_state": rc.opt_state if rc.opt_state is not None else (),
        "client_state": rc.client_state if rc.client_state is not None else (),
        "sampler_state": rc.sampler_state if rc.sampler_state is not None else (),
        "masks": np.asarray(rc.masks, bool),
        "norms": np.asarray(rc.norms, np.float32),
    }


def save_round(cfg: CheckpointConfig, rc: RoundCheckpoint) -> str:
    """Atomically write ``rc`` under ``cfg.dir`` (one step per round).

    Arrays go to the npz payload; the scalar ledger tail, the RNG
    bit-generator state, the config document and its fingerprint ride the
    index ``meta``.  Returns the published step directory.
    """
    n, k = np.asarray(rc.masks).shape[1], int(rc.round)
    meta = {
        "resume_schema": RESUME_SCHEMA,
        "round": k,
        "n_clients": n,
        "rng_state": rc.rng_state,
        "series": rc.series,
        "gap_records": [list(g) for g in rc.gap_records],
        "evals": [list(e) for e in rc.evals],
        "has_client_state": rc.client_state is not None,
        "has_sampler_state": rc.sampler_state is not None,
        "config": rc.config,
        "fingerprint": fingerprint(rc.config),
    }
    return ckpt.save(cfg.dir, _tree(rc), step=k, meta=meta, keep=cfg.keep)


def load_round(
    path: str,
    *,
    params,
    opt_state,
    client_state=None,
    sampler_state=None,
    config: dict | None = None,
    step=None,
) -> RoundCheckpoint:
    """Restore a :class:`RoundCheckpoint` (latest complete step by default).

    The caller passes freshly-initialised ``params``/``opt_state``/
    ``client_state``/``sampler_state`` as structural templates — dtype,
    shape and tree structure are validated leaf by leaf (``ValueError``
    naming the offending key, via :func:`repro_torch.checkpoint.ckpt.restore`).
    ``config`` is the resuming run's config document: its fingerprint must
    equal the checkpoint's or a ``ValueError`` lists every differing key —
    a checkpoint never resumes into a different experiment silently.
    ``path`` may be the checkpoint root or a specific ``step-XXXXXXXX``
    directory.
    """
    meta, k = ckpt.read_meta(path, step=step)
    if meta.get("resume_schema") != RESUME_SCHEMA:
        raise ValueError(
            f"checkpoint at {path!r} is not a RoundCheckpoint "
            f"(resume_schema={meta.get('resume_schema')!r}, want "
            f"{RESUME_SCHEMA}) — params-only checkpoints cannot resume a "
            f"simulation; re-run with checkpointing enabled"
        )
    if config is not None:
        fp = fingerprint(config)
        if fp != meta.get("fingerprint"):
            diffs = config_diff(meta.get("config", {}), config)
            raise ValueError(
                "checkpoint/run config fingerprint mismatch — resuming "
                "would silently change the trajectory. Differing keys: "
                + ("; ".join(diffs) if diffs else "<fingerprint only>")
            )
    if meta["has_client_state"] and client_state is None:
        raise ValueError(
            "checkpoint carries a ClientState but the resuming run has no "
            "SystemConfig — pass the same system= the checkpointing run used"
        )
    if meta["has_sampler_state"] and sampler_state is None:
        raise ValueError(
            "checkpoint carries a SamplerState but the resuming run's "
            "sampler is stateless — resume with the same fl.sampler"
        )
    n = int(meta["n_clients"])
    template = {
        "params": params,
        "opt_state": opt_state if opt_state is not None else (),
        "client_state": client_state if meta["has_client_state"] else (),
        "sampler_state": sampler_state if meta["has_sampler_state"] else (),
        "masks": np.zeros((k, n), bool),
        "norms": np.zeros((k, n), np.float32),
    }
    tree, k_ = ckpt.restore(path, template, step=step)
    return RoundCheckpoint(
        round=k_,
        params=tree["params"],
        opt_state=tree["opt_state"],
        client_state=tree["client_state"] if meta["has_client_state"] else None,
        sampler_state=tree["sampler_state"] if meta["has_sampler_state"] else None,
        rng_state=meta["rng_state"],
        series={name: list(vals) for name, vals in meta["series"].items()},
        gap_records=[tuple(g) for g in meta["gap_records"]],
        evals=[tuple(e) for e in meta["evals"]],
        masks=tree["masks"],
        norms=tree["norms"],
        config=meta.get("config", {}),
    )


def run_config_doc(
    fl,
    *,
    seed: int,
    batch_size: int,
    local_epoch: bool,
    pool_clients: int,
    model_dim: int,
    system=None,
    eval_every=None,
    scenario=None,
) -> dict:
    """The run-defining config document the resume fingerprint covers.

    Everything that shapes the trajectory or the ledger's non-timing bytes:
    the full FLConfig, the SystemConfig (or None), the seed, the batch
    size/local-epoch policy, the dataset pool size, the model dimension (a
    cheap proxy for the architecture), the eval grid (None when the run has
    no eval_fn) and the scenario name.  Deliberately NOT covered: the total
    round count (resuming may extend a run), the execution mode and
    ``rounds_per_scan`` (all modes and block partitions are byte-identical
    — the modes' ledgers are equal), and anything wall-clock.
    """
    return {
        "resume_schema": RESUME_SCHEMA,
        "fl": dataclasses.asdict(fl),
        "system": None if system is None else dataclasses.asdict(system),
        "seed": int(seed),
        "batch_size": int(batch_size),
        "local_epoch": bool(local_epoch),
        "pool_clients": int(pool_clients),
        "model_dim": int(model_dim),
        "eval_every": eval_every,
        "scenario": scenario,
    }
