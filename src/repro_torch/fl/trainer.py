"""Federated training entry point: ``run_training`` and its ``History``,
ported from ``repro/fl/trainer.py``.

``run_training`` keeps the reference's signature (its examples, benchmarks
and integration tests call it) and delegates every round to
:func:`repro_torch.sim.driver.run_simulation`: by default the
double-buffered ``'prefetch'`` pipeline of the device-resident client pool,
with ``'host'`` and ``'scan'`` (blocks of ``rounds_per_scan`` rounds, each
round one CUDA-graph replay on a card) selectable through ``mode``.  All
three draw the reference's per-round participation masks for a fixed seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.configs.base import FLConfig


@dataclass
class History:
    """Per-round training curves; every field is a flat scalar series.

    The eval curve is split into ``acc_rounds`` (the round indices
    evaluated) and ``acc`` (the values).
    """

    loss: list = field(default_factory=list)
    acc_rounds: list = field(default_factory=list)  # rounds at which acc was taken
    acc: list = field(default_factory=list)
    bits: list = field(default_factory=list)       # cumulative uplink bits
    alpha: list = field(default_factory=list)
    gamma: list = field(default_factory=list)
    sent: list = field(default_factory=list)

    def as_arrays(self):
        return {k: np.asarray(v) for k, v in self.__dict__.items()}


def run_training(
    dataset,
    init_fn,
    loss_fn,
    fl: FLConfig,
    rounds: int,
    batch_size: int = 20,
    eval_fn=None,
    eval_batch=None,
    eval_every: int = 5,
    seed: int = 0,
    local_epoch: bool = True,
    server_opt=None,
    mode: str = "prefetch",
    rounds_per_scan: int = 8,
    obs=None,
    checkpoint=None,
    resume=None,
    device=None,
):
    """Train for ``rounds`` communication rounds; returns ``(params, History)``.

    ``local_epoch``: the paper's setting — each client runs one epoch over
    its local data per round, so the number of local steps varies with the
    client's size (capped at ``fl.local_steps`` batches of ``batch_size``).
    ``mode`` selects the driver's path (``'prefetch'``, ``'host'`` or
    ``'scan'`` with ``rounds_per_scan``; same masks and parameters);
    ``eval_fn(params, eval_batch)`` runs on the ``eval_every`` grid.  ``device`` is the run's (``None`` means CUDA and
    raises without one; pass ``device='cpu'``).  ``obs``, ``checkpoint`` and
    ``resume`` are not ported yet and raise ``NotImplementedError``.
    """
    from repro_torch.sim.driver import run_simulation

    params, ledger = run_simulation(
        dataset, init_fn, loss_fn, fl, rounds,
        batch_size=batch_size, mode=mode, rounds_per_scan=rounds_per_scan,
        eval_fn=eval_fn, eval_batch=eval_batch, eval_every=eval_every,
        seed=seed, local_epoch=local_epoch, server_opt=server_opt, obs=obs,
        checkpoint=checkpoint, resume=resume, device=device,
    )
    hist = History(
        loss=list(ledger.loss),
        acc_rounds=list(ledger.acc_rounds),
        acc=list(ledger.acc),
        bits=list(ledger.uplink_bits),
        alpha=list(ledger.alpha),
        gamma=list(ledger.gamma),
        sent=list(ledger.sent),
    )
    return params, hist
