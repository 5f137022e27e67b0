"""Federated runtime: the round engine, its stable entry points and the
training entry point ``run_training``."""

from repro_torch.fl.engine import RoundEngine, RoundMetrics, make_engine  # noqa: F401
from repro_torch.fl.round import (  # noqa: F401
    client_weights,
    make_local_update,
    make_round,
    round_bits,
    round_bits_duplex,
)
from repro_torch.fl.trainer import History, run_training  # noqa: F401
