"""Paper core: samplers (OCS/AOCS and baselines), improvement factors, bits.

  sampling.optimal_probabilities   — exact Eq. (7)
  sampling.aocs_probabilities      — Algorithm 2
  sampling.SAMPLERS                — the zoo: also clustered, cyclic, threshold
  ocs.sampling_plan                — norms -> probabilities -> mask -> scale
  ocs.sample_and_aggregate         — one round of sampling + Eq. 2 aggregate
  improvement.improvement_factors  — alpha^k, gamma^k (Defs. 11/12)
  bits.BitsLedger                  — client->master uplink accounting
  compression                      — unbiased compressors (material + apply)
"""

from repro_torch.core import bits, compression, improvement, ocs, sampling  # noqa: F401
from repro_torch.core.ocs import OCSResult, sample_and_aggregate  # noqa: F401
from repro_torch.core.sampling import (  # noqa: F401
    SAMPLERS,
    STATEFUL_SAMPLERS,
    SamplerState,
    aocs_probabilities,
    clustered_probabilities,
    cyclic_probabilities,
    init_sampler_state,
    optimal_probabilities,
    resolve_sampler,
    threshold_probabilities,
)
