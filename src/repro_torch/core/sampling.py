"""The sampler zoo: client inclusion-probability rules under one contract.

Each rule maps the vector of weighted update norms ``u_i = ||w_i U_i||``
(shape ``(n,)``, float32) to inclusion probabilities ``p``;
:func:`repro_torch.core.ocs.sampling_plan` turns them into Bernoulli masks
and unbiased estimator coefficients.  Ported from ``repro/core/sampling.py``
op for op in float32, so the probabilities agree with the reference to
float32 rounding:

* ``optimal``   — exact optimal probabilities, Eq. (7);
* ``aocs``      — the aggregation-only approximation, Algorithm 2;
* ``uniform`` and ``full`` — the baselines;
* ``clustered`` — one expected representative per cluster of a strided rank
  partition (arXiv 2105.05883);
* ``cyclic``    — deterministic participation windows (arXiv 2302.03662);
* ``threshold`` — adaptive norm threshold (arXiv 2007.15197).

Norm-driven samplers give clients with ``u_i == 0`` probability 0.  The
stateful samplers (``cyclic``, ``threshold``) take and return a
:class:`SamplerState`, which the driver carries from round to round on the
device.  Every reduction that feeds ``p`` has a fixed order (no atomics),
so two runs on a card draw the same masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-12

# EMA rate of the threshold sampler's running norm-quantile estimate:
# tau <- (1 - beta) tau + beta target
THRESHOLD_BETA = 0.2
# its two coefficients as float32 scalars, as jax rounds the weak Python floats
_KEEP = float(np.float32(1.0 - THRESHOLD_BETA))
_BETA = float(np.float32(THRESHOLD_BETA))


class SamplerState(NamedTuple):
    """Cross-round state of the stateful samplers: ``step`` (() int32, the
    rounds the sampler has seen; the cyclic window derives from it) and
    ``threshold`` (() f32, the threshold sampler's running estimate tau)."""

    step: torch.Tensor
    threshold: torch.Tensor


def init_sampler_state(device=None) -> SamplerState:
    """A fresh :class:`SamplerState` on ``device``: round 0, threshold 0
    (``threshold`` lets every client send on its first round)."""
    return SamplerState(step=torch.zeros((), dtype=torch.int32, device=device),
                        threshold=torch.zeros((), dtype=torch.float32, device=device))


def optimal_probabilities(u: torch.Tensor, m: int) -> torch.Tensor:
    """Exact optimal inclusion probabilities, Eq. (7) of the paper.

    Sort norms ascending: s_(1) <= ... <= s_(n).  Let ``l`` be the largest
    integer such that ``0 < m + l - n <= sum_{j<=l} s_(j) / s_(l)``.  The
    ``n - l`` largest-norm clients get ``p = 1``; client ``i`` among the rest
    gets ``p_i = (m + l - n) * u_i / sum_{j<=l} s_(j)``.
    """
    n = u.shape[0]
    s, order = torch.sort(u, stable=True)
    csum = torch.cumsum(s, 0)
    ls = torch.arange(1, n + 1, device=u.device)
    budget = m + ls - n
    ratio = torch.where(s > _EPS, csum / torch.clamp(s, min=_EPS),
                        torch.full_like(s, float("inf")))
    ok = (budget > 0) & (budget <= ratio)
    l = torch.max(torch.where(ok, ls, torch.zeros_like(ls)))  # noqa: E741
    # torch.take, not csum[l - 1]: indexing with a 0-d tensor reads it back
    # to the host (a stream sync every round)
    denom = torch.take(csum, l - 1)
    scale = (m + l - n) / torch.clamp(denom, min=_EPS)
    p_small = u * scale
    # the n - l largest norms get 1; ranks break ties exactly like the sort
    ranks = torch.empty_like(order).scatter(0, order, torch.arange(n, device=u.device))
    in_a = ranks >= l
    p = torch.where(in_a, torch.ones_like(p_small), p_small)
    p = torch.clamp(p, 0.0, 1.0)
    return torch.where((u <= _EPS) & ~in_a, torch.zeros_like(p), p)


def aocs_probabilities(u: torch.Tensor, m: int, j_max: int = 4) -> torch.Tensor:
    """Approximate optimal client sampling (Algorithm 2), aggregation-only.

    Start from ``p_i = min(m * u_i / sum(u), 1)`` and run at most ``j_max``
    rescaling rounds: with ``I = #{i : p_i < 1}`` and ``P = sum_{p_i < 1} p_i``,
    set ``C = (m - n + I)/P`` and ``p_i <- min(C p_i, 1)`` for the
    non-saturated clients, stopping once ``C <= 1``.  All ``j_max`` rounds
    run and ``p`` freezes once ``C <= 1`` (the round that sees it still
    applies its rescale, as the reference's while loop does), so the card
    needs no host sync per round.
    """
    n = u.shape[0]
    total = torch.sum(u)
    p = torch.clamp(m * u / torch.clamp(total, min=_EPS), max=1.0)
    p = torch.where(u <= _EPS, torch.zeros_like(p), p)
    done = torch.zeros((), dtype=torch.bool, device=u.device)
    for _ in range(j_max):
        not_sat = p < 1.0
        count = torch.sum(not_sat)
        mass = torch.sum(torch.where(not_sat, p, torch.zeros_like(p)))
        c = (m - n + count) / torch.clamp(mass, min=_EPS)
        p_new = torch.where(not_sat, torch.clamp(c * p, max=1.0), p)
        p = torch.where(done, p, p_new)
        done = done | (c <= 1.0)
    return p


def uniform_probabilities(u: torch.Tensor, m: int) -> torch.Tensor:
    """Baseline: independent uniform sampling with p_i = m/n."""
    n = u.shape[0]
    return torch.full((n,), m / n, dtype=torch.float32, device=u.device)


def full_probabilities(u: torch.Tensor, m: int) -> torch.Tensor:
    """Full participation: everyone transmits."""
    return torch.ones((u.shape[0],), dtype=torch.float32, device=u.device)


def clustered_probabilities(u: torch.Tensor, m: int) -> torch.Tensor:
    """Clustered sampling (arXiv 2105.05883): one representative per cluster.

    Rank the norms descending (a stable sort, as ``jnp.argsort``: ties keep
    client order) and put rank ``r`` into cluster ``r mod m``; each cluster
    nominates one expected representative, ``p_i = u_i / sum_{j in
    cluster(i)} u_j``.  With at least ``m`` non-zero norms every cluster has
    mass, so ``sum(p) == m``.  The cluster sums are a fixed-order reduction:
    the descending norms, zero-padded to a multiple of ``m`` and viewed as
    ``(ceil(n/m), m)`` rows, summed over the rows (the reference's
    ``segment_sum``, whose CUDA counterpart ``index_add_`` would add with
    atomics).  ``m`` is a Python int.
    """
    n = u.shape[0]
    order = torch.argsort(-u, stable=True)
    ranks = torch.empty_like(order).scatter(0, order, torch.arange(n, device=u.device))
    ordered = torch.nn.functional.pad(u[order], (0, (-n) % m))
    sums = ordered.view(-1, m).sum(dim=0)
    denom = sums[ranks % m]
    p = torch.where(u > _EPS, u / torch.clamp(denom, min=_EPS), torch.zeros_like(u))
    return torch.clamp(p, 0.0, 1.0)


def cyclic_probabilities(u: torch.Tensor, m: int, state: SamplerState) -> tuple:
    """Cyclic client participation (arXiv 2302.03662): deterministic windows.

    Round ``k`` selects the ``m`` clients from offset ``(k mod ceil(n/m)) *
    m`` (wrapping modulo ``n``): every client takes part once per cycle of
    ``ceil(n/m)`` rounds, norm-obliviously, with ``p`` exactly 0 or 1.  The
    window position comes from ``state.step`` on the device.  Returns ``(p,
    state advanced one round)``.
    """
    n = u.shape[0]
    n_windows = -(-n // m)
    pos = state.step % n_windows
    offsets = (torch.arange(n, dtype=torch.int32, device=u.device) - pos * m) % n
    p = (offsets < m).to(torch.float32)
    return p, state._replace(step=state.step + 1)


def threshold_probabilities(u: torch.Tensor, m: int, state: SamplerState) -> tuple:
    """Adaptive norm-threshold selection (Ribero-Vikalo, arXiv 2007.15197).

    Only clients whose norm reaches the running threshold ``tau`` send
    (``p_i = 1``, zero norms never); ``tau`` is an EMA estimate of the m-th
    largest norm, ``tau <- (1 - beta) tau + beta * sort(u)[n - m]`` in
    float32 (beta = :data:`THRESHOLD_BETA`).  From the cold start ``tau =
    0`` every client sends in round 1, then the sender count anneals toward
    ``m``.  Returns ``(p, advanced state)``.
    """
    n = u.shape[0]
    p = ((u > _EPS) & (u >= state.threshold)).to(torch.float32)
    target = torch.sort(u).values[n - m]
    new_tau = _KEEP * state.threshold + _BETA * target
    return p, SamplerState(step=state.step + 1, threshold=new_tau)


SAMPLERS = {
    "optimal": optimal_probabilities,
    "aocs": aocs_probabilities,
    "uniform": uniform_probabilities,
    "full": full_probabilities,
    "clustered": clustered_probabilities,
    "cyclic": cyclic_probabilities,
    "threshold": threshold_probabilities,
}

# samplers whose probability rule takes and returns a SamplerState
STATEFUL_SAMPLERS = ("cyclic", "threshold")
_STATEFUL_FNS = (cyclic_probabilities, threshold_probabilities)


def resolve_sampler(sampler):
    """Resolve a sampler name (or callable) to its probability function.

    Callables pass through; an unknown name raises ``ValueError`` listing
    ``SAMPLERS``, before any key is consumed.
    """
    if callable(sampler):
        return sampler
    fn = SAMPLERS.get(sampler)
    if fn is None:
        raise ValueError(
            f"unknown sampler {sampler!r}; want one of "
            f"{sorted(SAMPLERS)} or a callable"
        )
    return fn


def is_stateful(sampler) -> bool:
    """True iff ``sampler`` (a name or one of this module's callables)
    carries a :class:`SamplerState`."""
    if callable(sampler):
        return sampler in _STATEFUL_FNS
    return sampler in STATEFUL_SAMPLERS
