"""Improvement factors alpha^k and gamma^k (paper Definitions 11 & 12).

For independent sampling the variance of the unbiased aggregate has the
closed form (Eq. 6)

    Var(p) = sum_i (1 - p_i)/p_i * u_i^2 ,   u_i = ||w_i U_i||,

and ``alpha^k = Var(p_opt) / Var(p_unif)``, ``gamma^k = m/(alpha(n-m)+m)``.
Ported from ``repro/core/improvement.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core import sampling

_EPS = 1e-12


def sampling_variance(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Closed-form variance of the unbiased aggregate under independent
    sampling with inclusion probabilities p (Eq. 6)."""
    u = u.to(torch.float32)
    active = (p > _EPS) & (u > _EPS)
    terms = (1.0 - p) / torch.clamp(p, min=_EPS) * u * u
    return torch.sum(torch.where(active, terms, torch.zeros_like(terms)))


def improvement_factors(u: torch.Tensor, m: int):
    """Return (alpha^k, gamma^k) for norm vector u and expected batch m."""
    n = u.shape[0]
    p_opt = sampling.optimal_probabilities(u, m)
    var_opt = sampling_variance(u, p_opt)
    var_unif = (n - m) / m * torch.sum(torch.square(u.to(torch.float32)))
    alpha = torch.where(var_unif > _EPS, var_opt / torch.clamp(var_unif, min=_EPS),
                        torch.zeros_like(var_opt))
    alpha = torch.clamp(alpha, 0.0, 1.0)
    gamma = m / (alpha * (n - m) + m)
    return alpha, gamma
