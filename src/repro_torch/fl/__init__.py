"""Federated runtime: the round engine and its stable entry points."""

from repro_torch.fl.engine import RoundEngine, RoundMetrics, make_engine  # noqa: F401
from repro_torch.fl.round import (  # noqa: F401
    client_weights,
    make_local_update,
    round_bits,
    round_bits_duplex,
)
