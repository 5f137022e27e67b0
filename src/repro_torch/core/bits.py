"""Client->master uplink accounting (the paper's x-axis metric).

A copy of ``repro/core/bits.py`` for ``compression='none'``: the paper plots
loss against bits sent from clients to the master, including Algorithm 2's
overhead (Remark 3: O(j_max) extra floats per client), and excludes the
master->client broadcast (footnote 5), which the ledger reports apart:

  full participation : n   * d * bits_per_param
  uniform sampling   : |S| * d * bits_per_param            (|S| ~ Binomial)
  OCS (Alg. 1)       : |S| * d * bits + n * f              (norm upload)
  AOCS (Alg. 2)      : |S| * d * bits + n * f * (1 + 2*j_used)

with f = 32 (one float).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FLOAT_BITS = 32

_OVERHEAD_FLOATS = {
    "full": lambda j: 0,
    "uniform": lambda j: 0,
    "optimal": lambda j: 1,
    "aocs": lambda j: 1 + 2 * j,
}


@dataclass(frozen=True)
class BitsLedger:
    """Per-round bit bill of a model with ``model_dim`` parameters."""

    model_dim: int                 # d, number of communicated parameters
    bits_per_param: int = FLOAT_BITS

    def update_bits(self) -> int:
        return self.model_dim * self.bits_per_param

    def broadcast_bits(self, n_receivers: int) -> int:
        """Master->client downlink for one round: the model broadcast to the
        ``n_receivers`` cohort clients (excluded from the paper's metric,
        footnote 5)."""
        return n_receivers * self.update_bits()

    def round_bits(self, mask, sampler: str, n: int, j_used: int = 4,
                   compression: str = "none", compression_param: float = 0.0):
        """Uplink bits for one communication round given the realized mask."""
        if compression != "none":
            raise NotImplementedError(
                "compressed uplink billing is not ported yet: it lands with "
                "the compression slice of the port"
            )
        if sampler not in _OVERHEAD_FLOATS:
            raise ValueError(f"unknown or not yet ported sampler {sampler!r}")
        sent = int(np.sum(np.asarray(mask))) * self.update_bits()
        return sent + n * FLOAT_BITS * _OVERHEAD_FLOATS[sampler](j_used)
