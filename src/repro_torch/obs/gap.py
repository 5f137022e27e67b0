"""Online Eq. 2 gap estimator: ``‖ŝ − s‖²`` between the sampled aggregate
and the full-participation aggregate, observed per round — the port of
``repro/obs/gap.py``.

The paper's objective (Eq. 2) is to pick inclusion probabilities that
minimise the expected squared distance between the limited aggregate
``ŝ = sum_i mask_i (w_i / p_i) U_i`` and the full-participation update
``s = sum_i w_i U_i``.  Every ``diag_every`` rounds the engine computes
``s`` beside ``ŝ`` through the SAME backend code path (the plain torch
contraction, the masked-aggregate kernel, or the scan engine's cache/spill
stream through the fused kernels), with ``scale = w`` instead of the plan's
``scale``, and records :class:`GapStats`.  Both sides run one code path, so
at ``sampler='full'`` (where ``scale == w`` bitwise) the gap is exactly
zero.  With compression the reference ``s`` is the full-participation
aggregate of the transmitted updates ``sum_i w_i C(U_i)``, so the gap
isolates the sampling error from the compression error.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.ops import tree_leaves

_EPS = 1e-30


class GapStats(NamedTuple):
    """One diagnostic round's Eq. 2 observables (device f32 scalars):
    ``gap_sq = ‖ŝ − s‖²`` and ``full_sq = ‖s‖²``; their ratio
    (:func:`gap_ratio`, on the host) is the endpoint's ``repro_gap_ratio``."""

    gap_sq: torch.Tensor
    full_sq: torch.Tensor


def flat_gap_stats(sampled: torch.Tensor, full: torch.Tensor) -> GapStats:
    """:class:`GapStats` from two flat ``(D,)`` aggregates (f32 math)."""
    a = sampled.to(torch.float32)
    b = full.to(torch.float32)
    d = a - b
    return GapStats(gap_sq=torch.sum(d * d), full_sq=torch.sum(b * b))


def tree_gap_stats(sampled, full) -> GapStats:
    """:class:`GapStats` from two aggregate trees of one structure: per-leaf
    f32 sums accumulated leaf by leaf in ``tree_leaves`` order, as the
    reference does (no flattened copy)."""
    leaves = tree_leaves(sampled)
    gap_sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    full_sq = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for a, b in zip(leaves, tree_leaves(full)):
        a32 = a.to(torch.float32)
        b32 = b.to(torch.float32)
        d = a32 - b32
        gap_sq = gap_sq + torch.sum(d * d)
        full_sq = full_sq + torch.sum(b32 * b32)
    return GapStats(gap_sq=gap_sq, full_sq=full_sq)


def gap_ratio(gap_sq: float, full_sq: float) -> float:
    """Host-side dimensionless gap ``‖ŝ−s‖² / ‖s‖²`` (0 when ``s`` is 0), so
    the ledger and the endpoint carry a finite ratio on a degenerate round."""
    return float(gap_sq) / max(float(full_sq), _EPS) if float(full_sq) > 0.0 \
        else 0.0
