"""Client inclusion-probability rules: the paper's own samplers.

Each rule maps the vector of weighted update norms ``u_i = ||w_i U_i||``
(shape ``(n,)``, float32) to inclusion probabilities ``p``;
:func:`repro_torch.core.ocs.sampling_plan` turns them into Bernoulli masks
and unbiased estimator coefficients.  Ported from ``repro/core/sampling.py``
op for op in float32, so the probabilities agree with the reference to
float32 rounding:

* ``optimal`` — exact optimal probabilities, Eq. (7);
* ``aocs``    — the aggregation-only approximation, Algorithm 2;
* ``uniform`` and ``full`` — the baselines.

Norm-driven samplers give clients with ``u_i == 0`` probability 0.  The
reference's zoo baselines (``clustered``, ``cyclic``, ``threshold``) come
with the system-realism slice of the port and raise ``NotImplementedError``
here.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


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
    ranks = torch.empty(n, dtype=torch.int64, device=u.device)
    ranks[order] = torch.arange(n, device=u.device)
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


SAMPLERS = {
    "optimal": optimal_probabilities,
    "aocs": aocs_probabilities,
    "uniform": uniform_probabilities,
    "full": full_probabilities,
}

# the reference's zoo baselines; cyclic and threshold carry a SamplerState
NOT_PORTED = ("clustered", "cyclic", "threshold")
STATEFUL_SAMPLERS = ("cyclic", "threshold")


def resolve_sampler(sampler):
    """Resolve a sampler name (or callable) to its probability function.

    A name of the reference's zoo that this slice does not run raises
    ``NotImplementedError``; any other unknown name raises ``ValueError``
    listing ``SAMPLERS``.  Both happen before any key is consumed.
    """
    if callable(sampler):
        return sampler
    if sampler in NOT_PORTED:
        raise NotImplementedError(
            f"sampler {sampler!r} is not ported yet: it lands with the "
            f"system-realism and sampler-zoo slice of the port"
        )
    fn = SAMPLERS.get(sampler)
    if fn is None:
        raise ValueError(
            f"unknown sampler {sampler!r}; want one of "
            f"{sorted(SAMPLERS)} or a callable"
        )
    return fn


def is_stateful(sampler) -> bool:
    """True iff ``sampler`` names a sampler that carries a sampler state."""
    return not callable(sampler) and sampler in STATEFUL_SAMPLERS
