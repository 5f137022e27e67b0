"""Federated-round configuration: a copy of the reference's ``FLConfig``
(``repro/configs/base.py``) with the same fields, defaults, validation and
``cohort_target``, so one scenario means the same run in both packages.

The axes the port does not run yet (the sampler zoo beyond
optimal/aocs/uniform/full, the client-state layer, the mesh) keep their
fields here and are rejected by the modules that would use them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class FLConfig:
    """Federated-round configuration (the paper's knobs)."""
    n_clients: int = 32            # n
    expected_clients: int = 6      # m
    # sampler zoo (core/sampling.py::SAMPLERS):
    # optimal | aocs | uniform | full | clustered | cyclic | threshold
    sampler: str = "aocs"
    j_max: int = 4                 # AOCS iterations
    local_steps: int = 1           # R (R=1 ~ DSGD on the local batch)
    algorithm: str = "fedavg"      # fedavg | dsgd
    lr_local: float = 0.125        # eta_l (paper: 2^-3 for OCS/full)
    lr_global: float = 1.0         # eta_g (paper: 1.0)
    weights: str = "uniform"       # w_i scheme: uniform | data_size
    # beyond-paper (paper Sec. 6 future work): compress transmitted updates
    compression: str = "none"      # none | randk | qsgd | natural
    compression_param: float = 0.1 # randk fraction / qsgd levels (natural: unused)
    # paper Appendix E: per-client availability probability q (1.0 = always)
    availability: float = 1.0
    # system-realism over-selection (sim/pool.py client-state layer): sample
    # round(m * over_select) clients so the post-deadline/dropout survivor
    # count still approaches m.  1.0 = the paper's plain m-target plan.
    over_select: float = 1.0
    # round-engine execution policy (fl/engine.py) — orthogonal axes:
    round_engine: str = "vmap"     # memory policy: vmap | scan (single-pass OCS)
    agg_backend: str = "jnp"       # masked-aggregate backend: jnp | pallas
    scan_group: int = 2            # clients per scan group (round_engine='scan')
    # bounded HBM update cache of the scan engine (kernels/update_cache.py):
    # pass 1 parks the first cache_groups groups' update matrices
    # (cache_groups * scan_group * d elements); post-plan those aggregate
    # without recomputing local_update, groups beyond capacity spill to
    # recompute.  0 = no cache (the original two-pass scan, 2n evals/round);
    # >= n_clients/scan_group = every update computed exactly once.
    cache_groups: int = 8
    # mesh execution (fl/shard_round.py, selected by fl.engine.make_engine
    # when a mesh is active): the mesh axis the client dimension shards over.
    # agg_backend applies on this path too — 'pallas' runs the per-shard
    # fused kernel (kernels/sharded_aggregate.py) + one cross-shard psum.
    client_axis: str = "data"

    def __post_init__(self):
        if self.cache_groups < 0:
            raise ValueError(
                f"cache_groups must be >= 0 (0 disables the update cache), "
                f"got {self.cache_groups}"
            )
        if self.scan_group < 1:
            raise ValueError(f"scan_group must be >= 1, got {self.scan_group}")
        if not 1.0 <= self.over_select <= float(max(self.n_clients, 1)):
            raise ValueError(
                f"over_select must be in [1, n_clients], got {self.over_select}"
            )

    def cohort_target(self) -> int:
        """The sampling plan's m after over-selection: ``round(m * over_select)``
        clamped to ``[1, n_clients]`` (== ``expected_clients`` when
        ``over_select`` is 1, preserving the paper's plan bit-for-bit)."""
        m = int(round(self.expected_clients * self.over_select))
        return max(1, min(m, self.n_clients))
