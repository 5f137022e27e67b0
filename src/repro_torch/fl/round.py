"""Stable round entry points: client weights and the per-round bit bill
(``repro/fl/round.py``)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.bits import BitsLedger
from repro_torch.fl.engine import (  # noqa: F401  (re-exported stable API)
    RoundEngine,
    RoundMetrics,
    make_engine,
    make_local_update,
)


def client_weights(fl: FLConfig, sizes=None, device=None) -> torch.Tensor:
    """``(n,)`` f32 client weights ``w_i``: uniform, or ``sizes`` normalised
    when ``fl.weights == 'data_size'``."""
    if fl.weights == "data_size" and sizes is not None:
        w = torch.as_tensor(sizes, device=device).to(torch.float32)
        return w / torch.sum(w)
    return torch.full((fl.n_clients,), 1.0 / fl.n_clients, dtype=torch.float32,
                      device=device)


def round_bits(fl: FLConfig, model_dim: int, mask) -> int:
    """Uplink bits for one round under the config's sampler (the paper's
    metric)."""
    return BitsLedger(model_dim).round_bits(
        mask, fl.sampler, fl.n_clients, fl.j_max,
        fl.compression, fl.compression_param,
    )


def round_bits_duplex(fl: FLConfig, model_dim: int, mask) -> tuple:
    """``(uplink, downlink)`` bits for one round: downlink is the model
    broadcast to the ``fl.n_clients`` cohort, which the paper excludes
    (footnote 5) and the ledger carries as its own series."""
    up = round_bits(fl, model_dim, mask)
    down = BitsLedger(model_dim).broadcast_bits(fl.n_clients)
    return up, down
